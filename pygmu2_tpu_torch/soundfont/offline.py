"""Fully parallel offline MIDI rendering on a PyTorch device.

Counterpart of ``pygmu2_tpu.soundfont.offline``. A render runs in three
stages:

1. **Host event simulation** (numpy): ``Synthesizer.build_schedule`` /
   ``build_schedule_segments`` turn the score into parameter snapshots.
2. **Control pass** (:func:`_control_device`, plain PyTorch): closed-form
   envelopes, LFOs, pitch ratios, oscillator base positions (float64),
   biquad coefficients and gains for every (block, voice). The sequential
   chains of the reference's block loop become cumulative sums/maxima
   along the block axis, with note epochs as segment boundaries.
3. **Audio pass** (:func:`_audio_pass`): the fused oscillator + biquad +
   gain ramps + stereo mix of
   :func:`pygmu2_tpu_torch.soundfont.filter_kernels.osc_filter_gain_mix`
   (a hand-written CUDA kernel on the card). Where the JAX package's
   windowed kernel has no window wide enough (a wavetable of more than
   ``OSC_KERNEL_MAX_WAVE`` samples played above ``WINDOW_RATIO_BUCKET``
   times its rate), the audio pass is unfused as there: the oscillator in
   plain tensor ops, then
   :func:`~pygmu2_tpu_torch.soundfont.filter_kernels.filter_gain_mix`.

Entry points: :func:`render_midi_offline` (one pass over the whole piece),
:func:`render_midi_offline_streamed` (segments, with the host simulation
of segment k+1 overlapping the device work of segment k) and
:func:`render_midi_offline_hostctl` (the control pass on the host in numpy,
:func:`compute_control`, a copy of the JAX package's, then the same audio
pass).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch.ops.xla_math import mod as _mod
from pygmu2_tpu_torch.soundfont import filter_kernels
from pygmu2_tpu_torch.soundfont.convert import (
    _CH_F32,
    _PAR_F32,
    _PAR_F64,
    _PAR_I32,
    schedule_to_torch,
    to_torch,
)
from pygmu2_tpu_torch.soundfont.model import LoopMode
from pygmu2_tpu_torch.soundfont.params import NON_AUDIBLE

LOG_NON_AUDIBLE = math.log(NON_AUDIBLE)

# Blocks per segment of the streamed render (~5.9 s at block 1024).
STREAM_SEG_BLOCKS = 256

# The JAX package's routing bounds (filter_pallas.OSC_KERNEL_MAX_WAVE,
# offline.WINDOW_RATIO_BUCKET): its resident kernel holds wavetables of up
# to OSC_KERNEL_MAX_WAVE samples, its windowed kernel pitch ratios of up to
# WINDOW_RATIO_BUCKET; beyond both the audio pass is unfused.
OSC_KERNEL_MAX_WAVE = 16384
WINDOW_RATIO_BUCKET = 8

# float32 constants of the JAX control pass, as Python floats (a Python
# scalar meets a float32 tensor in float32, as a numpy float32 scalar
# meets a float32 array)
_F32 = lambda x: float(np.float32(x))  # noqa: E731
_RPO = _F32(1.0 - 1.0 / math.sqrt(2.0))
_TWO_PI = _F32(2.0 * np.pi)
_PAN_SCALE = _F32(np.pi / 200.0)
_HALF_PI = _F32(np.pi / 2)
_CENT = _F32(0.01)


# ---- closed-form control functions ---------------------------------------


def _exp_cutoff(x):
    return torch.where(x < LOG_NON_AUDIBLE, 0.0, torch.exp(torch.clamp_max(x, 0.0)))


def _vol_env_held(t, p):
    return torch.where(
        t < p["v_att_start"],
        0.0,
        torch.where(
            t < p["v_hold_start"],
            p["v_att_slope"] * (t - p["v_att_start"]),
            torch.where(
                t < p["v_dec_start"],
                1.0,
                torch.maximum(
                    _exp_cutoff(p["v_dec_slope"] * (t - p["v_dec_start"])),
                    p["v_sustain"],
                ),
            ),
        ),
    )


def _vol_env(t, p, released, rel_t, rel_level):
    rel = rel_level * _exp_cutoff(p["v_rel_slope"] * (t - rel_t))
    return torch.where(released, rel, _vol_env_held(t, p))


def _mod_env_held(t, p):
    return torch.where(
        t < p["m_att_start"],
        0.0,
        torch.where(
            t < p["m_hold_start"],
            p["m_att_slope"] * (t - p["m_att_start"]),
            torch.where(
                t < p["m_dec_start"],
                1.0,
                torch.maximum(
                    p["m_dec_slope"] * (p["m_dec_end"] - t), p["m_sustain"]
                ),
            ),
        ),
    )


def _mod_env(t, p, released, rel_t, rel_level):
    rel = torch.clamp_min(
        rel_level * (1.0 - (t - rel_t) / torch.clamp_min(p["m_rel_dur"], 1e-9)),
        0.0,
    )
    return torch.where(released, rel, _mod_env_held(t, p))


def _lfo(t, delay, period):
    safe = torch.clamp_min(period, 1e-9)
    phase = _mod(t - delay, safe) / safe
    tri = torch.where(
        phase < 0.25,
        4.0 * phase,
        torch.where(phase < 0.75, 4.0 * (0.5 - phase), 4.0 * (phase - 1.0)),
    )
    return torch.where((period > 0.0) & (t >= delay), tri, 0.0)


# ---- host control pass (numpy; the JAX package's, copied) ---------------


def _exp_cutoff_np(x, xp=np):
    return xp.where(x < LOG_NON_AUDIBLE, 0.0, xp.exp(xp.minimum(x, 0.0)))


def _vol_env_np(t, p, released, rel_t, rel_level, xp=np):
    held = xp.where(
        t < p["v_att_start"],
        0.0,
        xp.where(
            t < p["v_hold_start"],
            p["v_att_slope"] * (t - p["v_att_start"]),
            xp.where(
                t < p["v_dec_start"],
                1.0,
                xp.maximum(
                    _exp_cutoff_np(p["v_dec_slope"] * (t - p["v_dec_start"]), xp),
                    p["v_sustain"],
                ),
            ),
        ),
    )
    rel = rel_level * _exp_cutoff_np(p["v_rel_slope"] * (t - rel_t), xp)
    return xp.where(released, rel, held)


def _mod_env_np(t, p, released, rel_t, rel_level, xp=np):
    held = xp.where(
        t < p["m_att_start"],
        0.0,
        xp.where(
            t < p["m_hold_start"],
            p["m_att_slope"] * (t - p["m_att_start"]),
            xp.where(
                t < p["m_dec_start"],
                1.0,
                xp.maximum(
                    p["m_dec_slope"] * (p["m_dec_end"] - t), p["m_sustain"]
                ),
            ),
        ),
    )
    rel = xp.maximum(
        rel_level * (1.0 - (t - rel_t) / xp.maximum(p["m_rel_dur"], 1e-9)), 0.0
    )
    return xp.where(released, rel, held)


def _lfo_np(t, delay, period, xp=np):
    active = period > 0.0
    safe = xp.maximum(period, 1e-9)
    phase = xp.mod(t - delay, safe) / safe
    tri = xp.where(
        phase < 0.25,
        4.0 * phase,
        xp.where(phase < 0.75, 4.0 * (0.5 - phase), 4.0 * (phase - 1.0)),
    )
    return xp.where(active & (t >= delay), tri, 0.0)


def compute_control(synth, par_np, ch_np, snap_idx):
    """Host control pass → dict of (B, P) float32/bool arrays.

    Fully vectorized over blocks: the sequential chains of the block
    kernel (voice time, release latch, position accumulation, liveness)
    become segment-wise cummax/cumsum along the block axis, with epochs
    (voice restarts) as segment boundaries. Matches
    ``Synthesizer._block_kernel``'s control section bit-for-bit in its
    float32 arithmetic.
    """
    return _compute_control_vectorized(synth, par_np, ch_np, snap_idx)


def _compute_control_loop(synth, par_np, ch_np, snap_idx):
    """Reference implementation (per-block Python loop)."""
    N = synth.block_size
    sr = float(synth.sample_rate)
    min_dur = synth._minimum_voice_duration
    B = len(snap_idx)
    P = synth.maximum_polyphony

    # Expand snapshots to per-block views (cheap fancy indexing).
    par = {k: v[snap_idx].astype(np.float32) if v.dtype == np.float64 else v[snap_idx] for k, v in par_np.items()}
    par_f64 = {k: par_np[k][snap_idx] for k in ("smp_start", "smp_end", "loop_start", "loop_end", "srate_ratio")}
    ch = {k: v[snap_idx] for k, v in ch_np.items()}

    out = {
        k: np.zeros((B, P), np.float32)
        for k in (
            "ratio",
            "b0",
            "b1",
            "b2",
            "a1",
            "a2",
            "gl",
            "gr",
            "pgl",
            "pgr",
        )
    }
    out["base_pos"] = np.zeros((B, P), np.float64)
    out["looping"] = np.zeros((B, P), bool)
    out["alive"] = np.zeros((B, P), bool)
    out["fresh"] = np.zeros((B, P), bool)
    out["flt_on"] = np.zeros((B, P), bool)

    # dynamic state mirrors ((P,) numpy)
    d_epoch = np.full(P, -1, np.int32)
    d_vt = np.zeros(P, np.int64)
    d_released = np.zeros(P, bool)
    d_rel_t = np.zeros(P, np.float32)
    d_rel_vol = np.zeros(P, np.float32)
    d_rel_mod = np.zeros(P, np.float32)
    d_pos = np.zeros(P, np.float64)
    d_smc = np.zeros(P, np.float32)
    d_pgl = np.zeros(P, np.float32)
    d_pgr = np.zeros(P, np.float32)
    d_active = np.zeros(P, bool)

    rpo = np.float32(1.0 - 1.0 / math.sqrt(2.0))

    for b in range(B):
        p = {k: v[b] for k, v in par.items()}
        p64 = {k: v[b] for k, v in par_f64.items()}
        chb = {k: v[b] for k, v in ch.items()}
        chan = par["channel"][b]

        fresh = p["epoch"] != d_epoch
        vt = np.where(fresh, 0, d_vt)
        released = np.where(fresh, False, d_released)
        rel_t = np.where(fresh, 0.0, d_rel_t).astype(np.float32)
        rel_vol = np.where(fresh, 0.0, d_rel_vol).astype(np.float32)
        rel_mod = np.where(fresh, 0.0, d_rel_mod).astype(np.float32)
        pos = np.where(fresh, p64["smp_start"], d_pos)
        smc = np.where(fresh, p["cutoff"], d_smc).astype(np.float32)
        pgl = np.where(fresh, 0.0, d_pgl).astype(np.float32)
        pgr = np.where(fresh, 0.0, d_pgr).astype(np.float32)
        active = np.where(fresh, p["note_gain"] >= NON_AUDIBLE, d_active)

        hold = chb["ch_hold"][chan]
        t_now = (vt / sr).astype(np.float32)
        want = (
            active
            & ~released
            & (p["release_req"] <= vt)
            & (vt >= min_dur)
            & ~hold
        )
        rel_t = np.where(want, t_now, rel_t)
        rel_vol = np.where(
            want, _vol_env_np(t_now, p, False, rel_t, rel_vol), rel_vol
        ).astype(np.float32)
        rel_mod = np.where(
            want, _mod_env_np(t_now, p, False, rel_t, rel_mod), rel_mod
        ).astype(np.float32)
        released = released | want

        t_end = ((vt + N) / sr).astype(np.float32)
        vol_env = _vol_env_np(t_end, p, released, rel_t, rel_vol)
        mod_env = _mod_env_np(t_end, p, released, rel_t, rel_mod)
        vib = _lfo_np(t_end, p["vib_delay"], p["vib_period"])
        mlf = _lfo_np(t_end, p["mod_delay"], p["mod_period"])

        dead_vol = (vol_env <= NON_AUDIBLE) & (
            released | (t_end >= p["v_dec_start"])
        )

        pitch = (
            p["key"]
            + (np.float32(0.01) * chb["ch_mod"][chan] + p["vib2pitch"]) * vib
            + p["mod2pitch"] * mlf
            + p["modenv2pitch"] * mod_env
            + chb["ch_pitch"][chan]
        )
        pitch_change = p["pitch_scale"] * (pitch - p["root_key"]) + p["tune"]
        ratio = p64["srate_ratio"] * 2.0 ** (pitch_change.astype(np.float64) / 12.0)

        looping = (p["loop_mode"] == int(LoopMode.CONTINUOUS)) | (
            (p["loop_mode"] == int(LoopMode.LOOP_UNTIL_NOTE_OFF)) & ~released
        )
        loop_len = np.maximum(p64["loop_end"] - p64["loop_start"], 1.0)
        pos_wrapped = np.where(
            looping,
            np.mod(pos - p64["loop_start"], loop_len) + p64["loop_start"],
            pos,
        )
        dead_osc = ~looping & (pos >= p64["smp_end"])
        new_pos = pos_wrapped + N * ratio
        new_pos = np.where(
            looping & (new_pos >= p64["loop_end"]),
            np.mod(new_pos - p64["loop_start"], loop_len) + p64["loop_start"],
            new_pos,
        )

        # filter coefficients (f32 math like the kernel)
        res = p["resonance"]
        cents = p["modlfo2cut"] * mlf + p["modenv2cut"] * mod_env
        dynamic = (p["modlfo2cut"] != 0.0) | (p["modenv2cut"] != 0.0)
        new_cut = (2.0 ** (cents / 1200.0)).astype(np.float32) * p["cutoff"]
        smc = np.where(
            dynamic, np.clip(new_cut, 0.5 * smc, 2.0 * smc), smc
        ).astype(np.float32)
        cutoff = np.where(dynamic, smc, p["cutoff"])
        flt_on = cutoff < 0.499 * sr
        q = res - rpo / (1.0 + 6.0 * (res - 1.0))
        w = np.float32(2.0 * np.pi) * cutoff / np.float32(sr)
        cosw = np.cos(w)
        alpha = np.sin(w) / (2.0 * np.maximum(q, 1e-6))
        a0 = 1.0 + alpha
        b0 = ((1.0 - cosw) / 2.0) / a0
        b1 = (1.0 - cosw) / a0
        b2 = b0
        a1 = (-2.0 * cosw) / a0
        a2 = (1.0 - alpha) / a0
        # Inactive filter = identity passthrough: the y-chain then carries
        # the raw samples, matching the reference's state update.
        b0 = np.where(flt_on, b0, 1.0).astype(np.float32)
        b1 = np.where(flt_on, b1, 0.0).astype(np.float32)
        b2 = np.where(flt_on, b2, 0.0).astype(np.float32)
        a1 = np.where(flt_on, a1, 0.0).astype(np.float32)
        a2 = np.where(flt_on, a2, 0.0).astype(np.float32)

        ve = chb["ch_vol_exp"][chan]
        mix_gain = p["note_gain"] * ve * ve * vol_env.astype(np.float32)
        dyn_vol = p["modlfo2vol"] > 0.05
        mix_gain = mix_gain * np.where(
            dyn_vol, (10.0 ** (0.05 * p["modlfo2vol"] * mlf)).astype(np.float32), 1.0
        )
        angle = np.float32(np.pi / 200.0) * (
            chb["ch_pan"][chan] + p["inst_pan"] + np.float32(50.0)
        )
        gl = np.where(
            angle <= 0.0,
            mix_gain,
            np.where(angle >= np.float32(np.pi / 2), 0.0, mix_gain * np.cos(angle)),
        ).astype(np.float32)
        gr = np.where(
            angle <= 0.0,
            0.0,
            np.where(angle >= np.float32(np.pi / 2), mix_gain, mix_gain * np.sin(angle)),
        ).astype(np.float32)
        first_block = vt == 0
        pgl = np.where(first_block, gl, pgl)
        pgr = np.where(first_block, gr, pgr)

        alive = active & ~dead_vol & ~dead_osc

        out["ratio"][b] = ratio.astype(np.float32)
        out["base_pos"][b] = pos_wrapped
        out["looping"][b] = looping
        out["alive"][b] = alive
        out["fresh"][b] = fresh
        out["flt_on"][b] = flt_on
        for k, v in (("b0", b0), ("b1", b1), ("b2", b2), ("a1", a1), ("a2", a2)):
            out[k][b] = v
        out["gl"][b] = gl
        out["gr"][b] = gr
        out["pgl"][b] = pgl
        out["pgr"][b] = pgr

        d_epoch = par["epoch"][b].copy()
        d_vt = vt + N
        d_released = released
        d_rel_t = rel_t
        d_rel_vol = rel_vol
        d_rel_mod = rel_mod
        d_pos = new_pos
        d_smc = smc
        d_pgl = gl
        d_pgr = gr
        d_active = alive

    # Static per-voice-per-block sample geometry for the device pass.
    out["loop_start"] = par_f64["loop_start"].astype(np.float64)
    out["loop_len"] = np.maximum(
        par_f64["loop_end"] - par_f64["loop_start"], 1.0
    )
    out["smp_end"] = par_f64["smp_end"]
    out["lv_off"] = par["lv_off"]
    return out


def _compute_control_vectorized(synth, par_np, ch_np, snap_idx):
    N = synth.block_size
    sr = float(synth.sample_rate)
    min_dur = synth._minimum_voice_duration
    B = len(snap_idx)
    P = synth.maximum_polyphony
    rpo = np.float32(1.0 - 1.0 / math.sqrt(2.0))

    par = {
        k: (v[snap_idx].astype(np.float32) if v.dtype == np.float64 else v[snap_idx])
        for k, v in par_np.items()
    }
    par64 = {
        k: par_np[k][snap_idx]
        for k in ("smp_start", "smp_end", "loop_start", "loop_end", "srate_ratio")
    }
    ch = {k: v[snap_idx] for k, v in ch_np.items()}
    chan = par["channel"]  # (B, P)
    b_idx = np.arange(B)[:, None]

    def chv(name):  # per-voice view of a channel field
        return np.take_along_axis(ch[name], chan, axis=1)

    # --- segments (epochs) ---
    epoch = par["epoch"]
    fresh = np.ones((B, P), bool)
    fresh[1:] = epoch[1:] != epoch[:-1]
    seg_start = np.maximum.accumulate(np.where(fresh, b_idx, -1), axis=0)
    vt = ((b_idx - seg_start) * N).astype(np.int64)
    t_now = (vt / sr).astype(np.float32)
    t_end = ((vt + N) / sr).astype(np.float32)

    def seg_gather(arr):
        """arr value at each row's segment start."""
        return np.take_along_axis(arr, seg_start, axis=0)

    # --- release latch ---
    hold = chv("ch_hold")
    eligible = (par["release_req"] <= vt) & (vt >= min_dur) & ~hold
    # latch within segment: count eligible rows since the segment start
    elig_cs = np.cumsum(eligible, axis=0)
    excl = np.zeros_like(elig_cs)
    excl[1:] = elig_cs[:-1]
    elig_in_seg = elig_cs - seg_gather(excl)
    released = elig_in_seg > 0
    # the first eligible row of each segment is where the release lands
    first_elig = eligible & (elig_in_seg == 1)
    marker_row = np.where(first_elig, b_idx, -1)
    marker_cm = np.maximum.accumulate(marker_row, axis=0)
    rel_valid = marker_cm >= seg_start
    rel_row = np.clip(marker_cm, 0, B - 1)
    rel_t = np.where(
        released & rel_valid,
        np.take_along_axis(t_now, rel_row, axis=0),
        0.0,
    ).astype(np.float32)
    released = released & rel_valid

    # --- envelopes / LFOs ---
    rel_vol = _vol_env_np(rel_t, par, False, rel_t, 0.0).astype(np.float32)
    rel_mod = _mod_env_np(rel_t, par, False, rel_t, 0.0).astype(np.float32)
    vol_env = _vol_env_np(t_end, par, released, rel_t, rel_vol)
    mod_env = _mod_env_np(t_end, par, released, rel_t, rel_mod)
    vib = _lfo_np(t_end, par["vib_delay"], par["vib_period"])
    mlf = _lfo_np(t_end, par["mod_delay"], par["mod_period"])

    dead_vol = (vol_env <= NON_AUDIBLE) & (released | (t_end >= par["v_dec_start"]))

    # --- pitch / oscillator advance ---
    pitch = (
        par["key"]
        + (np.float32(0.01) * chv("ch_mod") + par["vib2pitch"]) * vib
        + par["mod2pitch"] * mlf
        + par["modenv2pitch"] * mod_env
        + chv("ch_pitch")
    )
    pitch_change = par["pitch_scale"] * (pitch - par["root_key"]) + par["tune"]
    ratio = par64["srate_ratio"] * 2.0 ** (pitch_change.astype(np.float64) / 12.0)

    looping = (par["loop_mode"] == int(LoopMode.CONTINUOUS)) | (
        (par["loop_mode"] == int(LoopMode.LOOP_UNTIL_NOTE_OFF)) & ~released
    )
    advance = N * ratio
    adv_cs = np.cumsum(advance, axis=0)
    adv_excl = np.zeros_like(adv_cs)
    adv_excl[1:] = adv_cs[:-1]
    base = par64["smp_start"] + (adv_excl - seg_gather(adv_excl))

    # LOOP_UNTIL_NOTE_OFF: after release the head leaves the loop from its
    # *wrapped* position — re-anchor the unwrapped chain at the release row.
    loop_len = np.maximum(par64["loop_end"] - par64["loop_start"], 1.0)
    mode3 = par["loop_mode"] == int(LoopMode.LOOP_UNTIL_NOTE_OFF)
    if mode3.any():
        base_at_rel = np.take_along_axis(base, rel_row, axis=0)
        wrapped_at_rel = (
            np.mod(base_at_rel - par64["loop_start"], loop_len) + par64["loop_start"]
        )
        fix = mode3 & released
        base = np.where(fix, base - base_at_rel + wrapped_at_rel, base)
    dead_osc = ~looping & (base >= par64["smp_end"])
    # Pre-wrap looping bases so the device wrap needs no integer mod.
    base = np.where(
        looping,
        np.mod(base - par64["loop_start"], loop_len) + par64["loop_start"],
        base,
    )

    # --- filter coefficients ---
    res = par["resonance"]
    dynamic = (par["modlfo2cut"] != 0.0) | (par["modenv2cut"] != 0.0)
    if dynamic.any():
        # clamped smoother is sequential; tiny loop over blocks for the
        # dynamic voices only.
        cents = par["modlfo2cut"] * mlf + par["modenv2cut"] * mod_env
        new_cut = (2.0 ** (cents / 1200.0)).astype(np.float32) * par["cutoff"]
        smc = np.empty((B, P), np.float32)
        prev = par["cutoff"][0].copy()
        for b in range(B):
            prev = np.where(fresh[b], par["cutoff"][b], prev)
            prev = np.where(
                dynamic[b],
                np.clip(new_cut[b], 0.5 * prev, 2.0 * prev),
                prev,
            ).astype(np.float32)
            smc[b] = prev
        cutoff = np.where(dynamic, smc, par["cutoff"])
    else:
        cutoff = par["cutoff"]
    flt_on = cutoff < 0.499 * sr
    q = res - rpo / (1.0 + 6.0 * (res - 1.0))
    w = np.float32(2.0 * np.pi) * cutoff / np.float32(sr)
    cosw = np.cos(w)
    alpha = np.sin(w) / (2.0 * np.maximum(q, 1e-6))
    a0 = 1.0 + alpha
    b0 = np.where(flt_on, ((1.0 - cosw) / 2.0) / a0, 1.0).astype(np.float32)
    b1 = np.where(flt_on, (1.0 - cosw) / a0, 0.0).astype(np.float32)
    b2 = np.where(flt_on, ((1.0 - cosw) / 2.0) / a0, 0.0).astype(np.float32)
    a1 = np.where(flt_on, (-2.0 * cosw) / a0, 0.0).astype(np.float32)
    a2 = np.where(flt_on, (1.0 - alpha) / a0, 0.0).astype(np.float32)

    # --- gains ---
    ve = chv("ch_vol_exp")
    mix_gain = par["note_gain"] * ve * ve * vol_env.astype(np.float32)
    dyn_vol = par["modlfo2vol"] > 0.05
    mix_gain = mix_gain * np.where(
        dyn_vol, (10.0 ** (0.05 * par["modlfo2vol"] * mlf)).astype(np.float32), 1.0
    )
    angle = np.float32(np.pi / 200.0) * (
        chv("ch_pan") + par["inst_pan"] + np.float32(50.0)
    )
    gl = np.where(
        angle <= 0.0,
        mix_gain,
        np.where(angle >= np.float32(np.pi / 2), 0.0, mix_gain * np.cos(angle)),
    ).astype(np.float32)
    gr = np.where(
        angle <= 0.0,
        0.0,
        np.where(angle >= np.float32(np.pi / 2), mix_gain, mix_gain * np.sin(angle)),
    ).astype(np.float32)
    pgl = np.where(fresh, gl, np.roll(gl, 1, axis=0))
    pgr = np.where(fresh, gr, np.roll(gr, 1, axis=0))

    # --- liveness chain ---
    active0 = par["note_gain"] >= NON_AUDIBLE
    dead = dead_vol | dead_osc
    dead_cs = np.cumsum(dead, axis=0)
    dead_excl = np.zeros_like(dead_cs)
    dead_excl[1:] = dead_cs[:-1]
    dead_before = (dead_excl - seg_gather(dead_excl)) > 0
    alive = active0 & ~dead_before & ~dead

    return {
        "ratio": ratio.astype(np.float32),
        "base_pos": base,
        "looping": looping,
        "alive": alive,
        "fresh": fresh,
        "flt_on": flt_on,
        "b0": b0,
        "b1": b1,
        "b2": b2,
        "a1": a1,
        "a2": a2,
        "gl": gl,
        "gr": gr,
        "pgl": pgl,
        "pgr": pgr,
        "loop_start": par64["loop_start"].astype(np.float64),
        "loop_len": np.maximum(par64["loop_end"] - par64["loop_start"], 1.0),
        "smp_end": par64["smp_end"],
        "lv_off": par["lv_off"],
    }


# ---- device control pass -------------------------------------------------


def _control_device(pf32, pi32, pf64, cf32, chold, snap_idx, N, flags,
                    min_dur, sr, b0=None, carry=None, with_carry=False):
    """The control pass: schedule stacks -> dict of (B, P) control planes.

    pf32 (33, S, P), pi32 (5, S, P), pf64 (5, S, P) float64, cf32
    (4, S, 16), chold (S, 16) bool and snap_idx (B,) as
    :func:`~pygmu2_tpu_torch.soundfont.convert.schedule_to_torch` makes
    them; flags = (mode3_any, dynamic_any) pick the branches that only
    LOOP_UNTIL_NOTE_OFF voices and modulated cutoffs need.

    Streaming (``carry`` is not None): renders blocks [b0, b0 + B) of a
    longer timeline. Every scan takes the previous segment's last row as
    a prepended carry element, so the segments' control output matches
    the monolithic pass (the int scans exactly; the float64 advance sum
    up to regrouping). ``with_carry`` also returns the (P,)-shaped carry
    for the next segment (:func:`_stream_carry_init` makes the first).
    """
    mode3_any, dynamic_any = flags
    B = snap_idx.shape[0]
    P = pf32.shape[2]
    dev = pf32.device

    # ---- snapshot expansion: (k, S, P) -> (k, B, P) ----
    par = dict(zip(_PAR_F32, pf32[:, snap_idx]))
    pari = dict(zip(_PAR_I32, pi32[:, snap_idx]))
    par64 = dict(zip(_PAR_F64, pf64[:, snap_idx]))
    ch = dict(zip(_CH_F32, cf32[:, snap_idx]))
    ch["ch_hold"] = chold[snap_idx]
    chan = pari["channel"].long()
    C = carry
    # b_idx is GLOBAL under streaming so carried scans stay consistent
    base_b = 0 if b0 is None else int(b0)
    b_idx = (base_b + torch.arange(B, dtype=torch.int32, device=dev))[:, None]

    def chv(name):  # per-voice view of a (B, 16) channel field
        return torch.gather(ch[name], 1, chan)

    def prepend(x, c):
        return x if c is None else torch.cat([c[None].to(x.dtype), x])

    def cscan(x, c=None):  # inclusive cumsum, optionally after a carry row
        y = torch.cumsum(prepend(x, c), 0, dtype=x.dtype)
        return y if c is None else y[1:]

    def cmax(x, c=None):
        y = torch.cummax(prepend(x, c), 0).values
        return y if c is None else y[1:]

    def ffill(values, marked, c=None):
        """Forward fill: at each row, `values` at the latest row where
        `marked` is set (row 0's value before the first mark). ``c``: a
        carried (value, marked) row prepended under streaming. Returns
        (values, marked-so-far)."""
        if c is not None:
            values = torch.cat([c[0][None].to(values.dtype), values])
            marked = torch.cat([c[1][None], marked])
        rows = torch.arange(values.shape[0], device=dev)[:, None]
        last = torch.cummax(torch.where(marked, rows, -1), 0).values
        v = torch.gather(values, 0, last.clamp_min(0))
        m = last >= 0
        if c is not None:
            v, m = v[1:], m[1:]
        return v, m

    true_p = torch.ones((P,), dtype=torch.bool, device=dev)

    epoch = pari["epoch"]
    if C is None:
        fresh = torch.cat(
            [torch.ones((1, P), dtype=torch.bool, device=dev), epoch[1:] != epoch[:-1]]
        )
    else:
        fresh = epoch != torch.cat([C["epoch"][None], epoch[:-1]])
    seg_start = cmax(torch.where(fresh, b_idx, -1), None if C is None else C["seg_start"])
    vt = (b_idx - seg_start) * N
    # divide in float64 then round, as the numpy control pass
    t_now = (vt.double() / sr).float()
    t_end = ((vt + N).double() / sr).float()

    def seg_gather(arr, c_v=None):
        # value at each row's segment start; under streaming the carried
        # mark is always set (every voice is fresh at the stream's block 0)
        c = None if (C is None or c_v is None) else (c_v, true_p)
        return ffill(arr, fresh, c)[0]

    def first_row(x, name):  # exclusive-scan seed: zeros or the carry
        if C is None:
            return torch.zeros((1, P), dtype=x.dtype, device=dev)
        return C[name][None]

    hold = chv("ch_hold")
    eligible = (pari["release_req"] <= vt) & (vt >= min_dur) & ~hold
    elig_cs = cscan(eligible.int(), None if C is None else C["elig_cs"])
    excl = torch.cat([first_row(elig_cs, "elig_cs"), elig_cs[:-1]])
    sg_excl = seg_gather(excl, None if C is None else C["sg_excl"])
    elig_in_seg = elig_cs - sg_excl
    released = elig_in_seg > 0
    first_elig = eligible & (elig_in_seg == 1)
    marker_row = torch.where(first_elig, b_idx, -1)
    marker_cm = cmax(marker_row, None if C is None else C["marker_cm"])
    rel_valid = marker_cm >= seg_start
    relt_f, relt_m = ffill(
        t_now, first_elig, None if C is None else (C["relt_v"], C["relt_m"])
    )
    rel_t = torch.where(released & rel_valid, relt_f, 0.0)
    released = released & rel_valid

    rel_vol = _vol_env_held(rel_t, par)
    rel_mod = _mod_env_held(rel_t, par)
    vol_env = _vol_env(t_end, par, released, rel_t, rel_vol)
    mod_env = _mod_env(t_end, par, released, rel_t, rel_mod)
    vib = _lfo(t_end, par["vib_delay"], par["vib_period"])
    mlf = _lfo(t_end, par["mod_delay"], par["mod_period"])

    dead_vol = (vol_env <= NON_AUDIBLE) & (released | (t_end >= par["v_dec_start"]))

    pitch = (
        par["key"]
        + (_CENT * chv("ch_mod") + par["vib2pitch"]) * vib
        + par["mod2pitch"] * mlf
        + par["modenv2pitch"] * mod_env
        + chv("ch_pitch")
    )
    pitch_change = par["pitch_scale"] * (pitch - par["root_key"]) + par["tune"]
    ratio = par64["srate_ratio"] * 2.0 ** (pitch_change.double() / 12.0)

    loop_mode = pari["loop_mode"]
    looping = (loop_mode == int(LoopMode.CONTINUOUS)) | (
        (loop_mode == int(LoopMode.LOOP_UNTIL_NOTE_OFF)) & ~released
    )
    advance = N * ratio
    adv_cs = cscan(advance, None if C is None else C["adv_cs"])
    adv_excl = torch.cat([first_row(adv_cs, "adv_cs"), adv_cs[:-1]])
    sg_adv = seg_gather(adv_excl, None if C is None else C["sg_adv"])
    base = par64["smp_start"] + (adv_excl - sg_adv)

    loop_start = par64["loop_start"]
    loop_len = torch.clamp_min(par64["loop_end"] - loop_start, 1.0)
    bar_f = bar_m = None
    if mode3_any:
        # LOOP_UNTIL_NOTE_OFF: after release the head leaves the loop from
        # its wrapped position; re-anchor the unwrapped chain there
        bar_f, bar_m = ffill(
            base, first_elig, None if C is None else (C["bar_v"], C["bar_m"])
        )
        wrapped_at_rel = torch.remainder(bar_f - loop_start, loop_len) + loop_start
        fix = (loop_mode == int(LoopMode.LOOP_UNTIL_NOTE_OFF)) & released
        base = torch.where(fix, base - bar_f + wrapped_at_rel, base)
    dead_osc = ~looping & (base >= par64["smp_end"])
    # pre-wrap looping bases into [loop_start, loop_end)
    base = torch.where(
        looping, torch.remainder(base - loop_start, loop_len) + loop_start, base
    )

    res = par["resonance"]
    if dynamic_any:
        # the clamped cutoff smoother is sequential: a short loop over blocks
        dynamic = (par["modlfo2cut"] != 0.0) | (par["modenv2cut"] != 0.0)
        cents = par["modlfo2cut"] * mlf + par["modenv2cut"] * mod_env
        new_cut = (2.0 ** (cents / 1200.0)).float() * par["cutoff"]
        prev = par["cutoff"][0] if C is None else C["cutoff"]
        smc_rows = []
        for b in range(B):
            prev = torch.where(fresh[b], par["cutoff"][b], prev)
            prev = torch.where(
                dynamic[b], torch.clamp(new_cut[b], 0.5 * prev, 2.0 * prev), prev
            )
            smc_rows.append(prev)
        smc = torch.stack(smc_rows)
        cutoff = torch.where(dynamic, smc, par["cutoff"])
    else:
        smc = None
        cutoff = par["cutoff"]
    flt_on = cutoff < 0.499 * sr
    q = res - _RPO / (1.0 + 6.0 * (res - 1.0))
    w = _TWO_PI * cutoff / _F32(sr)
    cosw = torch.cos(w)
    alpha = torch.sin(w) / (2.0 * torch.clamp_min(q, 1e-6))
    a0 = 1.0 + alpha
    b0c = torch.where(flt_on, ((1.0 - cosw) / 2.0) / a0, 1.0)
    b1c = torch.where(flt_on, (1.0 - cosw) / a0, 0.0)
    b2c = torch.where(flt_on, ((1.0 - cosw) / 2.0) / a0, 0.0)
    a1c = torch.where(flt_on, (-2.0 * cosw) / a0, 0.0)
    a2c = torch.where(flt_on, (1.0 - alpha) / a0, 0.0)

    ve = chv("ch_vol_exp")
    mix_gain = par["note_gain"] * ve * ve * vol_env
    dyn_vol = par["modlfo2vol"] > 0.05
    mix_gain = mix_gain * torch.where(
        dyn_vol, 10.0 ** (0.05 * par["modlfo2vol"] * mlf), 1.0
    )
    angle = _PAN_SCALE * (chv("ch_pan") + par["inst_pan"] + 50.0)
    gl = torch.where(
        angle <= 0.0,
        mix_gain,
        torch.where(angle >= _HALF_PI, 0.0, mix_gain * torch.cos(angle)),
    )
    gr = torch.where(
        angle <= 0.0,
        0.0,
        torch.where(angle >= _HALF_PI, mix_gain, mix_gain * torch.sin(angle)),
    )
    if C is None:
        pgl = torch.where(fresh, gl, torch.roll(gl, 1, 0))
        pgr = torch.where(fresh, gr, torch.roll(gr, 1, 0))
    else:
        pgl = torch.where(fresh, gl, torch.cat([C["gl"][None], gl[:-1]]))
        pgr = torch.where(fresh, gr, torch.cat([C["gr"][None], gr[:-1]]))

    active0 = par["note_gain"] >= NON_AUDIBLE
    dead = dead_vol | dead_osc
    dead_cs = cscan(dead.int(), None if C is None else C["dead_cs"])
    dead_excl = torch.cat([first_row(dead_cs, "dead_cs"), dead_cs[:-1]])
    sg_dead = seg_gather(dead_excl, None if C is None else C["sg_dead"])
    dead_before = (dead_excl - sg_dead) > 0
    alive = active0 & ~dead_before & ~dead

    ctrl = {
        "ratio": ratio.float(),
        "base_pos": base,
        "looping": looping,
        "alive": alive,
        "fresh": fresh,
        "b0": b0c,
        "b1": b1c,
        "b2": b2c,
        "a1": a1c,
        "a2": a2c,
        "gl": gl,
        "gr": gr,
        "pgl": pgl,
        "pgr": pgr,
        "loop_start": loop_start,
        "loop_len": loop_len,
        "smp_end": par64["smp_end"],
        "lv_off": pari["lv_off"],
    }
    if not with_carry:
        return ctrl
    carry_out = {
        "epoch": epoch[-1],
        "seg_start": seg_start[-1],
        "elig_cs": elig_cs[-1],
        "sg_excl": sg_excl[-1],
        "marker_cm": marker_cm[-1],
        "relt_v": relt_f[-1],
        "relt_m": relt_m[-1],
        "adv_cs": adv_cs[-1],
        "sg_adv": sg_adv[-1],
        "bar_v": bar_f[-1] if mode3_any else torch.zeros_like(base[-1]),
        "bar_m": bar_m[-1] if mode3_any else torch.zeros_like(true_p),
        "dead_cs": dead_cs[-1],
        "sg_dead": sg_dead[-1],
        "cutoff": (smc if dynamic_any else cutoff)[-1],
        "gl": gl[-1],
        "gr": gr[-1],
    }
    return ctrl, carry_out


def _stream_carry_init(P: int, device):
    """Stream-initial carry for :func:`_control_device`: epoch -1 makes
    every voice fresh at the stream's first block; everything else is the
    neutral element of its scan."""

    def full(value, dtype):
        return torch.full((P,), value, dtype=dtype, device=device)

    i32, f32, f64 = torch.int32, torch.float32, torch.float64
    return {
        "epoch": full(-1, i32),
        "seg_start": full(-1, i32),
        "elig_cs": full(0, i32),
        "sg_excl": full(0, i32),
        "marker_cm": full(-1, i32),
        "relt_v": full(0, f32),
        "relt_m": full(False, torch.bool),
        "adv_cs": full(0, f64),
        "sg_adv": full(0, f64),
        "bar_v": full(0, f64),
        "bar_m": full(False, torch.bool),
        "dead_cs": full(0, i32),
        "sg_dead": full(0, i32),
        "cutoff": full(0, f32),
        "gl": full(0, f32),
        "gr": full(0, f32),
    }


# ---- audio pass ----------------------------------------------------------


def _osc_rows(ctrl, wave):
    """Oscillator control rows for the fused audio pass ((B, P) planes)."""
    W = wave.shape[0]
    loop_start_i = ctrl["loop_start"].to(torch.int32)
    base = ctrl["base_pos"]
    base_floor = torch.floor(base)
    return dict(
        ratio=ctrl["ratio"],
        base_frac=(base - base_floor).float(),
        base_int=base_floor.to(torch.int32),
        loopf=ctrl["looping"].float(),
        loop_start=loop_start_i,
        loop_len=torch.clamp_min(ctrl["loop_len"].to(torch.int32), 1),
        smp_end=ctrl["smp_end"].to(torch.int32),
        ls_val=wave[loop_start_i.clamp(0, W - 1).long()],
    )


def _gain_rows(ctrl, master):
    """Filter-coefficient + gain-ramp rows for the fused audio pass
    ((B, P) planes; dead voices contribute exactly zero gain)."""
    alive = ctrl["alive"]
    m = _F32(master)
    return {
        "b0": ctrl["b0"],
        "b1": ctrl["b1"],
        "b2": ctrl["b2"],
        "a1": ctrl["a1"],
        "a2": ctrl["a2"],
        "freshf": ctrl["fresh"].float(),
        "pgl": m * torch.where(alive, ctrl["pgl"], 0.0),
        "gl": m * torch.where(alive, ctrl["gl"], 0.0),
        "pgr": m * torch.where(alive, ctrl["pgr"], 0.0),
        "gr": m * torch.where(alive, ctrl["gr"], 0.0),
    }


def _audio_pass(ctrl, wave, N: int, master: float, state=None, unfused=False):
    """Control planes -> ((B·N, 2) float32 audio, (4, P) carried state).

    The streamed render's segment pass, and the unfused pass
    (``unfused``: the oscillator in plain tensor ops, then
    :func:`~pygmu2_tpu_torch.soundfont.filter_kernels.filter_gain_mix`; a
    whole render from zero state, ``state`` must be None, no state out).
    The other fused renders take :func:`_render_segments`.
    """
    rows = dict(_gain_rows(ctrl, master), **_osc_rows(ctrl, wave))
    if not unfused:
        return filter_kernels.osc_filter_gain_mix(rows, wave, N, state)
    if state is not None:
        raise ValueError("the unfused audio pass renders from zero state only")
    xt = filter_kernels._oscillator(rows, wave, N)
    return filter_kernels.filter_gain_mix(xt, rows, N), None


def _ratio_bound(par_np, ch_np) -> float:
    """Upper bound on any voice's pitch ratio across the schedule (vibrato,
    mod LFO and mod envelope at full deflection, the largest channel bend
    and modulation that ever occur); ``offline._ratio_bound`` of the JAX
    package (numpy only; the synthesizer argument it takes is unused)."""
    p = par_np
    audible = p["note_gain"] >= NON_AUDIBLE
    if not np.any(audible):
        return 1.0
    mod_hi = float(np.abs(ch_np["ch_mod"]).max()) if len(ch_np["ch_mod"]) else 0.0
    bend_hi = float(np.abs(ch_np["ch_pitch"]).max()) if len(ch_np["ch_pitch"]) else 0.0
    swing = (
        np.abs(0.01 * mod_hi + np.abs(p["vib2pitch"]))
        + np.abs(p["mod2pitch"])
        + np.maximum(p["modenv2pitch"], 0.0)
        + bend_hi
    )
    pitch_hi = p["key"] + swing
    delta = p["pitch_scale"] * (pitch_hi - p["root_key"]) + p["tune"]
    delta = np.where(audible, delta, -np.inf)
    return float(np.max(p["srate_ratio"] * 2.0 ** (delta / 12.0)))


def _out_of_window(synth, par_np, ch_np) -> bool:
    """True where the JAX package's audio pass is unfused: a wavetable too
    large for its resident kernel and pitch ratios beyond its windowed one."""
    return (synth._wave.shape[0] > OSC_KERNEL_MAX_WAVE
            and _ratio_bound(par_np, ch_np) > WINDOW_RATIO_BUCKET)


def _to_wire(out, wire: str):
    """Wire format of the rendered audio: "f32" as rendered, "int16"
    DAC-ready PCM (the render itself stays float32)."""
    if wire == "f32":
        return out
    if wire == "int16":
        scaled = torch.round(out * 32767.0)
        return torch.clamp(scaled, -32768.0, 32767.0).to(torch.int16)
    raise ValueError(f"unknown wire format: {wire!r} (use 'f32' or 'int16')")


# ---- entry points --------------------------------------------------------


def render_midi_offline(synth, midi_file, seconds: float, wire: str = "f32",
                        pipeline: int | None = None, device="cuda") -> np.ndarray:
    """Render ``seconds`` of ``midi_file`` on ``device``.

    The host simulates the score into a schedule; control and audio run
    on the device; returns (samples, 2) float32 (``wire="int16"``: int16
    PCM). Where the JAX package's audio pass is unfused (a large font
    played above its window, :func:`_out_of_window`) and N and the voice
    count are multiples of 128, so is this one.

    ``pipeline``, as the JAX package's: the fused audio pass in K
    segments of blocks, the (4, P) filter state carried from one to the
    next, each segment's download started as soon as it is queued so it
    overlaps the next segment's work. ``None`` (automatic) renders in one
    pass: no timing on the card has shown segments to help yet; 0 or 1 is
    one pass; K > 1 is clamped to the block count, and the segments'
    block counts differ by at most one. The unfused pass renders in one
    pass whatever ``pipeline`` asks.
    """
    N = synth.block_size
    par_np, ch_np, snap_idx, n_blocks = synth.build_schedule(midi_file, seconds)
    unfused = (_out_of_window(synth, par_np, ch_np)
               and N % 128 == 0 and synth.maximum_polyphony % 128 == 0)
    planes, flags = schedule_to_torch(par_np, ch_np, snap_idx, device)
    ctrl = _control_device(
        *planes, N, flags, int(synth._minimum_voice_duration),
        float(synth.sample_rate),
    )
    wave = to_torch(synth._wave, device)
    master = float(synth.master_volume)
    total = int(round(seconds * synth.sample_rate))
    n_blocks = int(n_blocks)
    if unfused:
        out, _state = _audio_pass(ctrl, wave, N, master, unfused=True)
        out = _to_wire(out, wire).cpu().numpy()
    else:
        segments = int(pipeline) if pipeline is not None and pipeline > 1 else 1
        out = _render_segments(ctrl, wave, N, master, segments, wire)
    synth.reset()
    return out[:total]


def _render_segments(ctrl, wave, N: int, master: float, segments: int,
                     wire: str) -> np.ndarray:
    """The fused audio pass in ``segments`` runs of blocks (1: one pass;
    clamped to the block count; the first ``n_blocks % K`` runs one block
    longer), the (4, P) filter state threaded between them. On the card
    each run's download goes to pinned host memory without waiting, so it
    overlaps the next run's kernel; the one wait is at the end."""
    rows = dict(_gain_rows(ctrl, master), **_osc_rows(ctrl, wave))
    n_blocks, P = rows["ratio"].shape
    K = max(1, min(int(segments), n_blocks))
    base, rem = divmod(n_blocks, K)
    state = torch.zeros((4, P), dtype=torch.float32, device=wave.device)
    on_card = wave.device.type == "cuda"
    parts = []
    b0 = 0
    for k in range(K):
        sb = base + (1 if k < rem else 0)
        seg_rows = {name: plane[b0:b0 + sb] for name, plane in rows.items()}
        out, state = filter_kernels.osc_filter_gain_mix(seg_rows, wave, N, state)
        out = _to_wire(out, wire)
        if on_card:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            out = host
        parts.append(out)
        b0 += sb
    if on_card:
        torch.cuda.synchronize(wave.device)
    return torch.cat([p.cpu() for p in parts]).numpy()


def render_midi_offline_streamed(synth, midi_file, seconds: float,
                                 wire: str = "f32",
                                 seg_blocks: int | None = None,
                                 device="cuda") -> np.ndarray:
    """:func:`render_midi_offline` in segments of ``seg_blocks`` blocks.

    Segment k's control and audio work is queued on the device without
    waiting for it, so the host simulates segment k+1 while the device
    renders segment k; the only wait is the final download. The control
    pass threads its scan carries and the audio pass its (4, P) state
    between segments: the output equals the one-pass render up to the
    float64 regrouping of the oscillator advance sum (<= 1e-5). A segment
    whose schedule is out of the JAX package's window
    (:func:`_out_of_window`) abandons the stream for the one-pass render,
    as the JAX package does.
    """
    N = synth.block_size
    sr = float(synth.sample_rate)
    P = synth.maximum_polyphony
    if seg_blocks is None:
        seg_blocks = STREAM_SEG_BLOCKS
    master = float(synth.master_volume)
    min_dur = int(synth._minimum_voice_duration)
    wave = to_torch(synth._wave, device)
    kstate = torch.zeros((4, P), dtype=torch.float32, device=device)
    carry = _stream_carry_init(P, device)
    outs = []
    b0 = 0
    for par_np, ch_np, snap_idx, nb in synth.build_schedule_segments(
        midi_file, seconds, seg_blocks
    ):
        if _out_of_window(synth, par_np, ch_np):
            return render_midi_offline(synth, midi_file, seconds, wire, device=device)
        planes, flags = schedule_to_torch(par_np, ch_np, snap_idx, device)
        ctrl, carry = _control_device(
            *planes, N, flags, min_dur, sr, b0=b0, carry=carry, with_carry=True
        )
        out, kstate = _audio_pass(ctrl, wave, N, master, kstate)
        outs.append(_to_wire(out, wire))
        b0 += nb
    synth.reset()
    total = int(round(seconds * sr))
    return torch.cat(outs)[:total].cpu().numpy()


def render_midi_offline_hostctl(synth, midi_file, seconds: float, device="cuda") -> np.ndarray:
    """:func:`render_midi_offline` with the control pass on the host
    (:func:`compute_control`, numpy): its planes go to ``device`` and
    through the same audio pass, routed as :func:`render_midi_offline`
    routes it. Returns (samples, 2) float32."""
    N = synth.block_size
    par_np, ch_np, snap_idx, _n_blocks = synth.build_schedule(midi_file, seconds)
    unfused = (_out_of_window(synth, par_np, ch_np)
               and N % 128 == 0 and synth.maximum_polyphony % 128 == 0)
    ctrl = to_torch(compute_control(synth, par_np, ch_np, snap_idx), device)
    wave = to_torch(synth._wave, device)
    master = float(synth.master_volume)
    if unfused:
        out = _audio_pass(ctrl, wave, N, master, unfused=True)[0].cpu().numpy()
    else:
        out = _render_segments(ctrl, wave, N, master, 1, "f32")
    total = int(round(seconds * synth.sample_rate))
    synth.reset()
    return out[:total]
