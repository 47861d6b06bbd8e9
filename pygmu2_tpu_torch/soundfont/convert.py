"""Host arrays -> the port's tensors on a device.

The offline render's host pass (``Synthesizer.build_schedule``) produces
numpy arrays; so does the JAX package, whose outputs (``np.asarray`` of
its device arrays) the tests feed to the port. This module moves such
arrays to a device unchanged in value and dtype:

- schedule stacks: :func:`schedule_to_torch` (via :func:`_pack_schedule_np`);
- control rows, the kernel's (4, P) state ``[y1; y2; x[-2]; x[-1]]`` and the
  streaming control carry: :func:`to_torch` on the dict or array.

Uploads to a CUDA device go through pinned memory without blocking the
host, so a render can simulate the next segment on the host while the
card works on the previous one.
"""

from __future__ import annotations

import numpy as np
import torch

from pygmu2_tpu_torch.soundfont.model import LoopMode

# Schedule planes by dtype (order as ``pygmu2_tpu.soundfont.offline``).
_PAR_F32 = (
    "key", "note_gain", "cutoff", "resonance", "vib2pitch", "mod2pitch",
    "modenv2pitch", "modlfo2cut", "modenv2cut", "modlfo2vol", "inst_pan",
    "v_att_start", "v_hold_start", "v_dec_start", "v_att_slope",
    "v_dec_slope", "v_rel_slope", "v_sustain", "m_att_start",
    "m_hold_start", "m_dec_start", "m_att_slope", "m_dec_slope",
    "m_dec_end", "m_rel_dur", "m_sustain", "vib_delay", "vib_period",
    "mod_delay", "mod_period", "root_key", "tune", "pitch_scale",
)
_PAR_I32 = ("epoch", "channel", "loop_mode", "release_req", "lv_off")
_PAR_F64 = ("smp_start", "smp_end", "loop_start", "loop_end", "srate_ratio")
_CH_F32 = ("ch_mod", "ch_vol_exp", "ch_pan", "ch_pitch")


def _pack_schedule_np(par_np, ch_np):
    """Stack the schedule by dtype (host arrays); derive static flags.

    Returns (pf32 (33, S, P), pi32 (5, S, P), pf64 (5, S, P) float64,
    cf32 (4, S, 16), chold (S, 16) bool, (mode3_any, dynamic_any)). The
    flags pick the control pass's branches: any LOOP_UNTIL_NOTE_OFF
    voice, any voice whose cutoff is modulated.
    """
    pf32 = np.stack([par_np[k] for k in _PAR_F32])
    pi32 = np.stack([par_np[k] for k in _PAR_I32])
    pf64 = np.stack([par_np[k] for k in _PAR_F64])
    cf32 = np.stack([ch_np[k] for k in _CH_F32])
    chold = ch_np["ch_hold"]
    mode3_any = bool((par_np["loop_mode"] == int(LoopMode.LOOP_UNTIL_NOTE_OFF)).any())
    dynamic_any = bool(
        ((par_np["modlfo2cut"] != 0.0) | (par_np["modenv2cut"] != 0.0)).any()
    )
    return pf32, pi32, pf64, cf32, chold, (mode3_any, dynamic_any)


def to_torch(tree, device):
    """numpy arrays (alone or in dicts, tuples, lists) -> tensors of the
    same dtype on ``device``; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    if not isinstance(tree, np.ndarray):
        return tree
    t = torch.tensor(tree)  # a copy: the caller may reuse its array
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def schedule_to_torch(par_np, ch_np, snap_idx, device):
    """``build_schedule`` output -> ((pf32, pi32, pf64, cf32, chold,
    snap_idx) tensors on ``device``, (mode3_any, dynamic_any))."""
    *planes, flags = _pack_schedule_np(par_np, ch_np)
    planes = to_torch((*planes, np.asarray(snap_idx, np.int64)), device)
    return planes, flags
