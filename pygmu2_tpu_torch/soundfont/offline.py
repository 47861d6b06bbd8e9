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
   (a hand-written CUDA kernel on the card).

Entry points: :func:`render_midi_offline` (one pass over the whole piece)
and :func:`render_midi_offline_streamed` (segments, with the host
simulation of segment k+1 overlapping the device work of segment k).
"""

from __future__ import annotations

import math

import numpy as np
import torch

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
    phase = torch.remainder(t - delay, safe) / safe
    tri = torch.where(
        phase < 0.25,
        4.0 * phase,
        torch.where(phase < 0.75, 4.0 * (0.5 - phase), 4.0 * (phase - 1.0)),
    )
    return torch.where((period > 0.0) & (t >= delay), tri, 0.0)


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


def _audio_pass(ctrl, wave, N: int, master: float, state=None):
    """Control planes -> ((B·N, 2) float32 audio, (4, P) carried state)."""
    rows = dict(_gain_rows(ctrl, master), **_osc_rows(ctrl, wave))
    return filter_kernels.osc_filter_gain_mix(rows, wave, N, state)


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
                        device="cuda") -> np.ndarray:
    """Render ``seconds`` of ``midi_file`` in one pass on ``device``.

    The host simulates the score into a schedule; control and audio run
    on the device; returns (samples, 2) float32 (``wire="int16"``: int16
    PCM).
    """
    N = synth.block_size
    par_np, ch_np, snap_idx, _n_blocks = synth.build_schedule(midi_file, seconds)
    planes, flags = schedule_to_torch(par_np, ch_np, snap_idx, device)
    ctrl = _control_device(
        *planes, N, flags, int(synth._minimum_voice_duration),
        float(synth.sample_rate),
    )
    wave = to_torch(synth._wave, device)
    out, _state = _audio_pass(ctrl, wave, N, float(synth.master_volume))
    total = int(round(seconds * synth.sample_rate))
    synth.reset()
    return _to_wire(out[:total], wire).cpu().numpy()


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
    float64 regrouping of the oscillator advance sum (<= 1e-5).
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
