#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's main paths through their user entry points:

1. the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``pygmu2_tpu_torch/csrc`` (build seconds);
3. the offline SoundFont render's kernel against its plain PyTorch
   version and against its own order in torch ops
   (``osc_filter_gain_mix_cut``) on the card, at the main path's shapes
   (P=128, N=1024): rows of the small-font and the large-font 3 s
   schedules (B=130) and of the 60 s piece's first streamed segment
   (B=256, large font), and a two-segment hand-off of the (4, P) state;
   max abs error <= 1e-4; two calls on the same rows equal bit for bit.
   Each timed beside its plain version: the kernel alone and every device
   item of a call (torch.profiler's device events: the wrapper's row
   stacks, the int scratch's memset, the kernel), and CUDA events around 20
   back-to-back calls (these also count the wrapper's host enqueue);
4. end to end, ``wire="int16"``: the 3 s chord through the small and the
   large font (``render_midi_offline``) and the 60 s piece through the
   large font (``render_midi_offline_streamed``), and the chord through the
   small font in four segments (``pipeline=4``, below). Each must launch the
   kernel, come out finite and not silent, and match the same render with
   the plain version on the card within 1e-4 (f32 wire). Realtime factors
   after warm-up, by wall clock and by CUDA events;
5. the PE graph's three serial kernels (ladder, comb, ADSR) against their
   plain versions on the card, with a two-call state hand-off: the ladder
   bit for bit at os_n in {1, 2, 4, 3} (3 takes the kernel's generic
   instantiation, the others their own) and C in {1, 33, 128} (33: a
   partial warp), T = 2048 (os_n <= 2) or 1024; the comb bit for bit at
   C in {1, 23, 128}, T = 2048, at a constant and a modulated frequency, a
   delay that jumps across window edges, and delays of 1, 2 and 7 samples;
   the ADSR gated and triggered (sustain counts 2206, 1 and 2**24) with a
   gate of many edges (T = 2048) and one with an edge every sample (T =
   4096: past 2816 edges a tile), on its edge-parallel passes and on its
   per-sample walk, bit for bit, and its
   absolute-clock machine at sustain_samples 0 and 2**24 - 1 bit for bit
   (from the first state and mid-sustain). At the main path's block,
   T = 16384 (C in {1, 128}), each is held to its plain version again and
   timed with CUDA events (the plain version's one call times it), beside
   its bound: the ADSR on the first block of the patch's own gate and
   trigger (its two PEs' parameters), on the many-edges gate and on the
   every-sample gate, its kernel alone by torch.profiler's device events
   (held whole on the patch's gate, on their first 4096 samples on the
   others; the ladder at C = 1 likewise on its first 4096);
6. end to end through ``render_to_array(device="cuda")``: the subtractive
   patch for 60 s and the 128-channel bank for 10 s
   (``pygmu2_tpu_torch/patch_workload.py``, default block 16384). Each
   must launch all three kernels and come out finite and not silent; the
   first 0.1 s (block 4096) must match the same render with the plain
   versions on the card within 1e-4. Realtime factors after the warm-up
   render, by wall clock and by CUDA events;
7. the effects chain's four serial kernels (Karplus-Strong, envelope
   follower, slew limiter, reverse echo) against their plain versions on
   the card at T = 2048, with a two-call state hand-off: the string at
   L in {2, 7, 133, 535, 51201} (51201: longer than shared memory holds)
   with act starting mid-call, all set, none set and with gaps, handed
   off at a window's edge; the follower at C in {1, 33, 128}, the slew limiter in both
   modes, and the echo (cap 22050) at C in {1, 128} with 10 ms blocks a
   fifth up, alternating direction, a modulated block length, pitch and
   feedback, 64-sample (min_block) blocks, and a call that starts
   mid-period with a previous block and a pitch line of noise. At the
   main path's block, T = 16384, on the arguments that are timed (the string at
   L = 535 and 133; the follower and the echo at C in {1, 128}, the echo
   replaying a 0.3 s block from its first sample; the slew limiter in
   both modes), each is held to its plain version again and timed (CUDA
   events, mean of 10 after a warm-up; the plain version's one call),
   beside its bound; the follower and the slew limiter also alone, by
   torch.profiler's device events, as the ADSR in phase 5 (their calls are
   short enough that events around back-to-back calls also count the
   host's enqueue).
   The first three are held to their plain versions bit for bit
   (explicitly rounded ops in the plain versions' order); the echo within
   1e-6 (its Hann window is cosf in the kernel and torch.cos in the plain
   version);
8. end to end through ``render_to_array(device="cuda")``: the mono effects
   chain for 60 s and the 128-channel fx bank for 10 s
   (``pygmu2_tpu_torch/fx_workload.py``). Each must launch its kernels and
   come out finite and not silent; the first 0.4 s (past the echo's first
   0.3 s block, so its replayed and fed-back block is in it) must match
   the same render with the plain versions on the card within 1e-4. Wall
   time and realtime factors after the warm-up render;
9. the order-2 affine scan's kernel against its plain version on the card,
   bit for bit: at T = 4096 with a two-call hand-off through ``s0`` (C in
   {4, 128}, chunk 1024, and chunk 128), and at the main path's block,
   T = 16384, C = 128, on the arguments that are timed (the SVFilterPE
   layout: four matrix planes shared by the channels, two input planes, an
   initial state; and six full planes), two calls bit for bit; the
   unfused SoundFont pass's kernel against its plain version on the
   high-register score's rows (3 s, large font, T = 133120, P = 128,
   N = 1024) within 2e-5 * max(1, peak) and against its own order in
   torch ops (``filter_gain_mix_cut``) within 1e-5 * max(1, peak), two
   calls bit for bit. Each timed alone by torch.profiler's device events,
   every launch of a call summed, and by CUDA events around 10
   back-to-back calls;
10. end to end through ``render_to_array(device="cuda")``: the 128-channel
   filter bank for 10 s (``pygmu2_tpu_torch/filter_workload.py``), which
   must launch the scan kernel (27 blocks, two filters); its first 0.4 s
   must match the same render with the plain version on the card within
   1e-4. Realtime after the warm-up render;
11. the high-register score (3 s, large font) through
   ``render_midi_offline`` and ``render_midi_offline_streamed``: each must
   launch the unfused pass's kernel and not the fused one, and match the
   same render with the plain version on the card within 1e-4. Realtime
   after a warm-up; as a measurement only, the fused kernel on the same
   rows, timed beside the unfused route, and the two outputs' difference;
12. the streaming SoundFont synth at the bench's width (the 3 s chord,
   small font, 128 voices, block 1024): ``Synthesizer.render_midi_schedule``,
   ``MidiFileSequencer.render`` in counts of 1000, 4096 and the rest (blocks
   split across calls) and ``render_midi_offline_hostctl``. The first two
   must launch the scan kernel once a block (130), the third the SoundFont
   pass once; each must come out finite and not silent, match the same
   render through the plain version on the card within 1e-4 and
   ``render_midi_offline`` within 1e-4. Realtime (median of 3 after a
   warm-up), and one traced ``render_midi_schedule``: device ops a block,
   device busy time and idle share. Then a MeltysynthPE fed by
   ``MidiInPE.feed`` (a chord) at block 64 for 1 s through
   ``render_to_array(device="cuda")``: the scan once a synth block, against
   the plain version within 1e-4, realtime;
13. the studio workload (``pygmu2_tpu_torch/studio_workload.py``): 60 s of
   stereo at block 16384 (2,646,000 frames, 162 blocks) through
   ``render_to_array`` into a WavWriterPE, over files made from a seed in
   ``build/smoke/studio/`` while the kernels build (a 30 s WAV recording,
   its FLAC copy, a 2 s impulse response): a tape (TimeWarpPE under a ControlPE over a
   crossfaded LoopPE), 32 faded FLAC slices sequenced behind a fractional
   DelayPE, a WavetablePE drone, brown noise following the loop's RMS
   (WindowPE), a TralfamPE stretch, a CompressorPE (the follower kernel,
   once a block: 162 launches) and a ReverbPE (cuFFT). The file must equal
   the render bit for bit with exactly its frames; each of the main
   path's 162 follower launches must match the plain follower on the card
   on that launch's inputs and carried state (all in one plain loop, the
   launches side by side as channels), and the first 0.5 s of the graph
   its render with the plain follower, within 1e-4 (the whole 60 s
   through the plain per-sample loop would take minutes); the graph at
   2 s the port's CPU render within 1e-4; the tape's live controls through
   ``Program.run`` (a rate change from the next block on and not before, a
   seek, a write landing between a block's render and its scatter); and
   ``render_functional`` must leave every PE's state as it was and equal
   the main path's render (a ``render_scan`` from reset state) bit for
   bit. Realtime (median of 3 after a warm-up), and one traced render of
   the first 16 blocks: device ops a block, idle share, the largest device
   items.

14. the generative performance (``pygmu2_tpu_torch/perform_workload.py``):
   60 s of stereo at block 16384 (2,646,000 frames, 162 blocks) through
   ``render_to_array``: a PortamentoPE glide in just intonation into a
   SuperSawPE and the ladder (cutoff a SMOOTH RandomPE), gated by the ADSR,
   under the KEMAR HRTF; an AnalogOscPE bass with a PiecewisePE duty panned
   by a WALK RandomPE; RandomSelectPE percussion under the HRTF; TriggerPE,
   TriggerRestartPE and ResetPE accents panned by a held RandomPE. It must
   be stereo, exactly 2,646,000 frames, finite and not silent, and launch
   the ladder and the ADSR kernels once a block each (162). Each of those
   launches is recorded on the card (inputs, carried state, results) and
   held to the plain version on the same inputs, each kernel's 162
   launches side by side as channels of one plain loop on the host. Under
   the HRTF the lead restarts every block (ROADMAP queue 3), so every
   launch enters from the initial state: the state the kernels carry from
   block to block is held by phase 5's hand-offs and phase 6's renders.
   Its first 0.5 s must match its render with the plain ladder and ADSR
   (run on the host on the card's inputs), the graph at 1 s the port's CPU
   render (made in a second process while the card renders), and the
   first 2 s through ``AudioRenderer(blocksize=1024)`` on the card into an
   in-script fake output stream ``render_to_array``'s frames, each within
   1e-4; the renderer plays in chunks of 16 callbacks, BLOCK samples, and
   the lead's restart makes the render depend on its block size, so that
   check holds at this chunk only. Then, with the second process done, realtime
   (median of 3 after a warm-up), the host syncs of 16 blocks
   (``torch.cuda.set_sync_debug_mode``), and one traced render of the
   first 16 blocks: device ops a block, idle share, the largest device
   items.

15. the training path (``pygmu2_tpu_torch/fit_workload.py``):
   ``torch.autograd`` of ``engine.render_functional`` with ParamPE
   bindings on the card, through the hand-written backward kernels of the
   ladder, the comb (``csrc/{ladder,comb}_scan_bwd.cu``) and the order-2
   affine scan (the adjoint launch of ``csrc/affine_scan_2.cu``). (a) The
   gradient probe of ``bench.py:_grad_probe`` (4096 samples, block 1024,
   loss mean(out^2)): 4 launches each of the ladder's and the comb's
   forward and backward kernels; each gradient within 0.1 relative of the
   central finite difference on the card (eps 2 for the cutoff, 1e-3 for
   the feedback) and within 1e-3 relative of the port's CPU gradient (its
   plain versions, in a second process); every backward launch against
   autograd of the plain version on its recorded inputs and cotangents,
   each output within 1e-4 of its largest plain cotangent. (b) The fit
   patch, 10 s mono at block 16384 (27 blocks), 5 Adam steps from a
   1500 Hz cutoff centre and feedback 0.6 towards a target rendered at
   1100 Hz and 0.45: the loss must fall; per step the wall time, the
   device span (CUDA events), the launches (27 of each kernel) and the
   peak memory; one T = 16384 launch of each backward kernel against
   autograd of its plain version (on the host, in a second process).
   (c) The fit bank, 2 s of 128 channels at block 16384 (6 blocks), 3
   Adam steps on the BiquadPE's and the SVFilterPE's sweep centres: 12
   launches of the scan's backward a step, the loss must fall, one
   launch against autograd of the plain chunked scan on the card, and
   each of the first step's 12 launches bit for bit with the plain
   version's order (``affine_scan_2_bwd_plain``) on the card and
   launched again: the same bits. Each
   backward kernel timed (CUDA events) at the probe's and the patch's
   shapes (the scan's at the bank's), beside its bound and its plain
   version's autograd.

16. training through the effects chain (``fit_workload.py``): the
   hand-written backward kernels of the follower, the slew limiter, the
   reverse echo and the ADSR (``csrc/{envelope_ar,slew,reverse_echo,
   adsr}_scan_bwd.cu``). (a) The fit chain (``fx_workload.build_chain``
   with the wah's sweep depth and the echo's feedback bound) at 4096
   samples in blocks of 1024: a backward launch of each of the three a
   block; each gradient within 0.1 relative of the central finite
   difference on the card and within 1e-3 relative of the port's CPU
   gradient (a second process); every backward launch within 1e-5 of its
   plain adjoint (``*_bwd_ref``) on its recorded inputs and cotangents,
   relative to the largest plain cotangent of each output. The feedback
   reaches the output only when a block written under it is replayed, two
   echo blocks (0.6 s) in, so its gradient is zero there: the feedback and
   the depth are checked against finite differences again over 0.8 s in
   blocks of 16384. (The fit variants' compressors take the peak detector:
   the RMS detector's gradient is NaN where its input falls silent, in the
   JAX package too.) (b) The ADSR probe
   (a gated ADSR, its gate scaled by a ParamPE): 4 backward launches, each
   held to the plain adjoint, and a gradient of exactly 0, the CPU's and
   the JAX package's. (c) The fit chain, 10 s mono at block 16384, 5 Adam
   steps from depth 2500 Hz and feedback 0.6 towards a target rendered at
   1800 Hz and 0.45, and (d) the fit fx bank (a drive gain before the
   compressor and the feedback bound), 2 s of 128 channels, 3 steps: the
   losses must fall; per step the wall time, the device span, the
   backward launches (one of each a block) and the peak memory. Each
   backward kernel timed (CUDA events) at the fits' shapes (the follower
   and the echo at C = 1 and 128; the ADSR at the probe's T = 1024 and at
   T = 16384) beside its plain adjoint, its bound and the peak memory of a
   launch, and held to the plain adjoint there. The follower's, the slew
   limiter's and the ADSR's recorded launches (the chain's 4 at C = 1, the
   fit chain's first at C = 1, the fit fx bank's first at C = 128; the
   ADSR probe's 4) are held bit for bit to their kernels' orders in torch
   ops (``envelope_ar_scan_bwd_chunked``, ``slew_scan_bwd_chunked``,
   ``adsr_scan_bwd_tiled``) on the card, and launched again: the same
   bits; so are the timed launches;
17. the string's backward kernel (``csrc/ks_scan_bwd.cu``, both orders)
   and batched bindings. (a) ``ks_scan`` with rho, the string and the
   allpass state requiring grad, at T = 4096 with a 300-sample pre-t0 head
   (the per-sample order) and all active (the blocked order) at L in
   {3, 83, 535}, and at L = 51201 (past ``MAX_KERNEL_L``) at T = 2048: one
   backward launch each, within 1e-5 of the plain adjoint
   (``ks_scan_bwd_ref``), within 0.1 of central finite differences along
   seeded directions on the card and 1e-3 of the CPU's gradients (a
   second process). (b) The string fit (``fit_workload.fit_string``: L =
   535, 2 s from t = -64 at block 16384, the first block per sample, the
   rest blocked, 5 Adam steps): the loss must fall; per step the wall, the
   device span, each order's forward and backward launches and the peak
   memory; the backward kernel timed at T = 16384, L in {133, 535}, in
   both orders' calls, beside its bound and its plain adjoint.
   (c)-(h) ``torch.func.vmap`` over ``render_functional``: the example's
   sweep (8 cutoffs, 500-4000 Hz), the fit patch (2 s, 8 cutoff and
   feedback candidates: the ladder, the comb and the ADSR) and the fit
   chain (0.8 s, 4 echo feedbacks each with a wah depth: the follower
   folded, the slew limiter and the echo per member); (f) the fit bank
   (1 s, 128 channels, 4 candidates of both filters' centres: each scan
   folded into one launch of 512 channels); (g) the fit fx bank (1 s, 128
   channels, 4 drives: the follower and the echo folded, the echo's rings
   fresh and unbatched in the first block); (h) the string (1 s from t =
   -64, 4 excitations and rhos: a launch per member in each order). Each
   equal to the loop of renders within 1e-6, its launches a block as each
   kernel's rule gives them, the summed loss's per-candidate gradients
   and ``vmap(grad)`` within 1e-5 relative of the loop's (any error of
   either fails the phase); the walls of the vmapped render and the loop
   printed.
18. the sharded renders of ``pygmu2_tpu_torch/parallel/render.py`` on a
   mesh of 4 shards on the card (``Mesh([cuda:0] * 4)``). (a)
   ``render_midi_offline_sharded``: the 3 s chord (128 voices, block
   1024) through the small and the large font, one launch of the SoundFont
   kernel a shard (32 voices), bit for bit with ``render_midi_offline``
   (the f32 wire, and its int16 conversion against the int16 wire), and
   within 1e-4 of the same sharded render with the plain version on the
   card. (b) ``render_midi_sharded``: 1 s of the chord through the small
   font, within 2e-5 of ``render_midi_schedule``, one scan launch a block
   and shard. (c) ``render_time_sharded_stateful``, the state relay: the
   patch for 60 s at block 16384, bit for bit with ``render_scan``, the
   same ladder, comb and ADSR launches, the PE instances' states
   untouched. (d) The halo mode (one block of warm-up) on the 10 s filter
   bank (its scans on kernel #4): past the first span within 1e-5 of
   ``render_scan``; the gate raises on the patch. (e)
   ``render_time_sharded_affine`` on a mono two-biquad chain (1 s, block
   4096) within 1e-5 of ``render_scan``, and ``render_time_sharded_auto``
   equal to the mode ``select_time_sharding`` names, with and without an
   ``affine_max_basis``. (f) With two cards or more, (a) and (c) again on
   a mesh of 4 shards over distinct cards: the same bits. Each sharded
   render's wall is printed beside its one-device render's.
19. the slice of the player, the examples and the block orders. The main
   path, its counts from 0: (a) a gradient through a LadderPE
   (``render_functional``, T = 1024, C = 1) at oversample 99, 100, 128 and
   320, one backward launch each and none of the plain adjoint; (b)
   SinePE, closed form and carried phase; (c) the heads (16384 samples) of
   the repo's 34 runnable examples (``pygmu2_tpu_torch.example_loader``);
   (e) ``JogShuttleCore`` over a stand-in sound card, stepped so that
   each control change lands between two renders: load a 1 s tone, play,
   shuttle to -2x and +4x, scrub, poll to the end; (f) the MIDI demo's
   scripted arpeggio. Then: every ladder backward launch, the recorded
   ones and seeded ones at C = 4, bit for bit with
   ``ladder_scan_bwd_chunked`` and with a second launch, each launch alone
   timed beside its bound; the kernel at T = 64, C = 4 within 1e-5 of the
   plain adjoint on the host; SinePE, the examples, the player's blocks
   and the arpeggio against the port's CPU renders (1e-4; the arpeggio
   2e-5); SinePE's device ops a block with glibc's sine mirrored and with
   ``torch.sin``; (d) the comb kernel at a static delay of 37 and the echo
   kernel at a static block with unity pitch against ``comb_const_delay``
   and ``reverse_echo_aligned`` (1e-5: the block orders contract x + fb *
   y as XLA's program, the kernels do not). The CPU renders run in three
   more processes.

Phase 4 also renders the 3 s chord through the small font with
``render_midi_offline(pipeline=4)``: four launches of the SoundFont kernel,
equal to the one-pass render within 1e-6.

``python3 chip_smoke.py 13`` runs phases 1, 2 and 13 only, ``python3
chip_smoke.py 14`` phases 1, 2 and 14 only, ``python3 chip_smoke.py 15``
phases 1, 2 and 15 only, ``python3 chip_smoke.py 16`` phases 1, 2 and 16
only, ``python3 chip_smoke.py 17`` phases 1, 2 and 17 only, ``python3
chip_smoke.py 18`` phases 1, 2 and 18 only, ``python3 chip_smoke.py 19``
phases 1, 2 and 19 only (no kernels line).

Prints a JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, before any result, on
any failure or where no CUDA device is present. Imports no JAX.
"""

import concurrent.futures
import contextlib
import functools
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

SR = 44100
TOL = 1e-4
BLOCK = 16384  # the PE graph's default render block

# Bounds: the larger of the bytes a call
# must move over the card's memory rate and the float32 operations it must
# do over the card's non-tensor-core float32 rate (H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per sample, counted from each kernel's arithmetic (tanh and a
# division count as one operation each):
# osc_filter_gain_mix per (sample, voice): oscillator 16, biquad 9,
#   gain ramps 12, mixdown 2
OSC_OPS = 39
# ladder per (sample, channel), os_n = 2, LP24: input and decay 12, then
#   per oversampled step 35 (input interpolation 3, feedback 5, tanh 1,
#   four stages of 6, mix 2)
LADDER_OPS = 82
# comb: per sample (shared by the channels) smoother, delay and position
#   13; per (sample, channel) feedback multiply-add 2
COMB_OPS_SAMPLE, COMB_OPS_CHANNEL = 13, 2
# ADSR per sample: current value 6, edge logic 6, segment step 18
ADSR_OPS = 30
# Karplus-Strong per sample: two-point average 3, allpass 4
KS_OPS = 7
# envelope follower per (sample, channel): compare, subtract, multiply, add
ENV_OPS = 4
# slew limiter per sample: subtract, clamp (2) or compare and multiply, add
SLEW_OPS = 4
# reverse echo: per sample (shared by the channels) smoother and rounding 6,
#   pitch-line positions and taps 16, crossfade weight 4, replay index and
#   window 8 (cos as one), advance 6: 40; per (sample, channel) two taps 6,
#   crossfade 3, windowed replay 1, feedback write 2: 12
ECHO_OPS_SAMPLE, ECHO_OPS_CHANNEL = 40, 12
# order-2 affine scan per (sample, channel): per Kogge-Stone pass six
#   2x2 products (two multiplies and an add each) and two more adds: 20;
#   log2(chunk) passes; the entering state applied: 6
SCAN_OPS_PASS, SCAN_OPS_APPLY = 20, 6
SCAN_CHUNK = 1024
# filter_gain_mix per (sample, voice): biquad 9, gain ramps 12, mixdown 2
FGM_OPS = 23
# the serial kernels' comparisons with two-call hand-offs (their plain
# versions are Python loops over the samples: most of the smoke's time)
FX_T = 2048
SCAN_T = 4096  # the scan's (its plain version is vectorized)
EVERY_T = 4096  # the ADSR's every-sample gate: past 2816 edges a tile
FX_CHECK_S = 0.4  # the effects renders' comparison: past the echo's first block


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    only_studio = sys.argv[1:] == ["13"]
    only_perform = sys.argv[1:] == ["14"]
    only_training = sys.argv[1:] == ["15"]
    only_chain = sys.argv[1:] == ["16"]
    only_string = sys.argv[1:] == ["17"]
    only_sharded = sys.argv[1:] == ["18"]
    only_examples = sys.argv[1:] == ["19"]
    from pygmu2_tpu_torch import _ext, bench_workload
    from pygmu2_tpu_torch.soundfont import MidiFile
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk
    from pygmu2_tpu_torch.soundfont import offline as off

    kernel = fk.osc_filter_gain_mix
    dev = torch.device("cuda", 0)

    @contextlib.contextmanager
    def plain_audio_pass():
        """Renders inside take the kernel's plain version, on the card."""
        fk.osc_filter_gain_mix = fk.osc_filter_gain_mix_ref
        try:
            yield
        finally:
            fk.osc_filter_gain_mix = kernel

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    # the studio's files are made, and its FLAC copy decoded, on the host
    # while nvcc builds; the phases after wait for both
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        setup = (None if only_perform or only_training or only_chain or only_string
                 or only_sharded or only_examples else pool.submit(studio_setup))
        _ext.load()
        print(f"kernel build+load: {time.perf_counter() - t0:.2f} s")
        studio_inputs = None if setup is None else setup.result()
    if studio_inputs is not None:
        print(f"the studio's files made and the FLAC decoded: {studio_inputs[2]:.2f} s, "
              f"{time.perf_counter() - t0:.2f} s with the build")
    if only_studio:
        studio(dev, card, studio_inputs)
        print_ok()
        return
    if only_perform:
        perform(dev, card)
        print_ok()
        return
    if only_training:
        training(dev, card)
        print_ok()
        return
    if only_chain:
        training_chain(dev, card)
        print_ok()
        return
    if only_string:
        training_string_vmap(dev, card)
        print_ok()
        return
    if only_sharded:
        sharded(dev, card)
        print_ok()
        return
    if only_examples:
        examples_and_players(dev, card)
        print_ok()
        return

    # ---- 3. kernel vs plain at the main path's shapes ----
    def bench_rows(large: bool, seconds: float):
        """The control rows of the bench's chord (3 s) or of the first
        ``seconds`` of its 60 s piece."""
        synth, midi = bench_workload.build_workload(large)
        if seconds != 3.0:
            midi = MidiFile(bench_workload.build_midi_bytes(repeats=15))
        return bench_workload.audio_pass_rows(synth, midi, seconds, dev)

    max_err = 0.0
    timings, osc_shapes = {}, {}
    # the 60 s piece streams in segments of STREAM_SEG_BLOCKS blocks of 1024
    segment_s = (off.STREAM_SEG_BLOCKS - 0.5) * 1024 / SR
    shapes = [("small", False, 3.0), ("large", True, 3.0), ("60 s segment", True, segment_s)]
    for name, large, seconds in shapes:
        rows, wave, N = bench_rows(large, seconds)
        B, P = rows["ratio"].shape
        osc_shapes[name] = (B, P, N, wave.shape[0])
        out, st = kernel(rows, wave, N)
        again, st_again = kernel(rows, wave, N)
        torch.cuda.synchronize()
        check(torch.equal(out, again) and torch.equal(st, st_again),
              f"{name}: two calls on the same rows differ")
        ref, st_ref = fk.osc_filter_gain_mix_ref(rows, wave, N)
        mirror, st_mirror = fk.osc_filter_gain_mix_cut(rows, wave, N)
        err = max((out - ref).abs().max().item(), (st - st_ref).abs().max().item())
        err_cut = max((out - mirror).abs().max().item(), (st - st_mirror).abs().max().item())
        peak = ref.abs().max().item()
        print(f"kernel vs plain, {name} (B={B} P={P} N={N}): max abs err {err:.3g}; vs its "
              f"order in torch ops {err_cut:.3g} (peak {peak:.3g}); two calls bit for bit")
        check(torch.isfinite(out).all().item() and peak > 1.0, f"{name}: degenerate")
        check(err <= TOL, f"{name}: kernel disagrees with plain ({err})")
        check(err_cut <= TOL, f"{name}: kernel disagrees with its order in torch ops ({err_cut})")
        max_err = max(max_err, err, err_cut)
        events_ms = device_ms(lambda: kernel(rows, wave, N), 20)
        p_ms = device_ms(lambda: fk.osc_filter_gain_mix_ref(rows, wave, N), 5)
        # the kernel: the segment pass of csrc/filter_pass.cuh over its OscSource
        split = launch_split(lambda: kernel(rows, wave, N), key="OscSource")
        k_ms = next(v for k, v in split.items() if "OscSource" in k)
        timings[name] = (k_ms, p_ms, split, events_ms)
        print(f"  {name}: kernel alone {k_ms:.4f} ms (CUDA events over calls {events_ms:.4f} ms), "
              f"plain {p_ms:.4f} ms per call; a call's device items: "
              + ", ".join(f"{k[:40]} {v:.4f} ms" for k, v in split.items()) + f" [{card}]")
        if name == "large":  # streamed hand-off of the (4, P) state
            cut = B // 2
            o1, s1 = kernel({k: v[:cut] for k, v in rows.items()}, wave, N)
            o2, s2 = kernel({k: v[cut:] for k, v in rows.items()}, wave, N, s1)
            torch.cuda.synchronize()
            err = max((torch.cat([o1, o2]) - ref).abs().max().item(),
                      (s2 - st_ref).abs().max().item())
            print(f"  two-segment state hand-off vs plain one call: {err:.3g}")
            check(err <= TOL, f"state hand-off disagrees ({err})")
            max_err = max(max_err, err)

    # ---- 4. end to end through the entry points ----
    def workload(large: bool, repeats: int):
        synth, _midi = bench_workload.build_workload(large)
        return synth, MidiFile(bench_workload.build_midi_bytes(repeats=repeats))

    cases = [
        ("3 s chord, small font", False, 1, 3.0, off.render_midi_offline),
        ("3 s chord, large font", True, 1, 3.0, off.render_midi_offline),
        ("60 s piece, large font, streamed", True, 15, 60.0,
         off.render_midi_offline_streamed),
    ]
    kernel.launches = 0  # the main path's run starts here
    per_case = []
    for label, large, repeats, seconds, render in cases:
        synth, midi = workload(large, repeats)
        before = kernel.launches
        pcm = render(synth, midi, seconds, wire="int16", device=dev)
        torch.cuda.synchronize()
        per_case.append(kernel.launches - before)
        check(pcm.dtype == np.int16 and pcm.shape == (int(round(seconds * SR)), 2),
              f"{label}: output {pcm.dtype} {pcm.shape}")
        check(np.abs(pcm.astype(np.int32)).max() > 0, f"{label}: silent")
        check(per_case[-1] > 0, f"{label}: the kernel was not launched")
    launches = kernel.launches

    for (label, large, repeats, seconds, render), n in zip(cases, per_case):
        synth, midi = workload(large, repeats)
        got = render(synth, midi, seconds, wire="f32", device=dev)
        with plain_audio_pass():
            ref = render(synth, midi, seconds, wire="f32", device=dev)
        check(np.isfinite(got).all() and np.abs(got).max() > 0.01,
              f"{label}: not finite or silent")
        err = float(np.abs(got - ref).max())
        check(err <= TOL, f"{label}: kernel render vs plain render {err}")
        max_err = max(max_err, err)

        def timed(plain: bool):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            ctx = plain_audio_pass() if plain else contextlib.nullcontext()
            with ctx:
                t = time.perf_counter()
                start.record()
                render(synth, midi, seconds, wire="int16", device=dev)
                end.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            return wall, start.elapsed_time(end) / 1e3

        timed(False)  # warm-up
        k_wall, k_ev = min((timed(False) for _ in range(3)), key=lambda x: x[0])
        p_wall, p_ev = timed(True)
        print(f"{label}: {n} kernel launches; max abs err vs plain {err:.3g}; "
              f"realtime x{seconds / k_wall:.1f} wall ({k_wall * 1e3:.1f} ms), "
              f"x{seconds / k_ev:.1f} by CUDA events ({k_ev * 1e3:.1f} ms); "
              f"plain x{seconds / p_wall:.1f} wall ({p_wall * 1e3:.1f} ms), "
              f"x{seconds / p_ev:.1f} events [{card}]")

    # one CUDA kernel serves both TPU kernels: the resident-table one
    # (#1: the small font) and the windowed one (#2: the large font, whose
    # table exceeds 16384 samples); each entry has its font's renders and
    # times
    osc_entries = []
    for name, replaces, font, n_launch in (
            ("osc_filter_gain_mix", "pygmu2_tpu/soundfont/filter_pallas.py:725", "small",
             per_case[0]),
            ("osc_window_filter_gain_mix", "pygmu2_tpu/soundfont/filter_pallas.py:624", "large",
             per_case[1] + per_case[2])):
        entry = {
            "name": name,
            "route": "cuda",
            "source": "pygmu2_tpu_torch/csrc/osc_filter_gain_mix.cu",
            "replaces": replaces,
            "launches": n_launch,
            "max_abs_err": max_err,
            "ms": timings[font][0],
            "plain_ms": timings[font][1],
            "library_ms": None,  # no single PyTorch call computes this function
            "events_ms": timings[font][3],
            "by_launch_ms": {k[:40]: ms for k, ms in timings[font][2].items()},
        }
        if font == "large":
            entry["ms_60s_segment"] = timings["60 s segment"][0]
            entry["plain_ms_60s_segment"] = timings["60 s segment"][1]
        B, P, N, L = osc_shapes[font]  # the font's 3 s shapes
        entry["bound_ms"], entry["bound_by"] = bound(
            4 * (18 * B * P + L + 8 * P + 2 * B * N), OSC_OPS * B * N * P
        )
        osc_entries.append(entry)
    check(sum(e["launches"] for e in osc_entries) == launches, "osc launches: split by font")

    # the chord through the small font in four segments, the (4, P) state
    # carried; each segment's download overlaps the next one's kernel
    synth, midi = workload(False, 1)
    one_pass = off.render_midi_offline(synth, midi, 3.0, pipeline=0, device=dev)
    before = kernel.launches
    piped = off.render_midi_offline(synth, midi, 3.0, pipeline=4, device=dev)
    n_piped = kernel.launches - before
    err = float(np.abs(piped - one_pass).max())
    check(n_piped == 4, f"pipeline=4: {n_piped} kernel launches")
    check(piped.shape == one_pass.shape and np.abs(one_pass).max() > 0.01 and err <= 1e-6,
          f"pipeline=4 vs one pass {err}")
    osc_entries[0]["launches"] += n_piped
    print(f"3 s chord, small font, pipeline=4: {n_piped} kernel launches; max abs err vs the "
          f"one-pass render {err:.3g}")

    serial = serial_kernels(dev, card, device_ms)
    pe_launches = pe_graph(dev, card)
    serial.update(fx_kernels(dev, card, device_ms))
    pe_launches.update(fx_graph(dev, card))
    serial.update(scan_kernels(dev, card, device_ms))
    pe_launches.update(filter_graph(dev, card))
    pe_launches.update(high_score(dev, card, device_ms))
    stream = streaming_synth(dev, card)
    pe_launches["affine_scan_2"] += stream["affine_scan_2"]
    pe_launches["envelope_ar_scan"] += studio(dev, card, studio_inputs)["envelope_ar_scan"]
    for name, n in perform(dev, card).items():
        pe_launches[name] += n
    backward = training(dev, card)
    backward += training_chain(dev, card)
    string_entries, string_launches = training_string_vmap(dev, card)
    backward += string_entries
    for name, n in string_launches.items():
        pe_launches[name] += n
    osc_entries[0]["launches"] += stream["osc_filter_gain_mix"]  # the small font's
    for name, n in sharded(dev, card).items():
        if name.startswith("osc_"):
            next(e for e in osc_entries if e["name"] == name)["launches"] += n
        else:
            pe_launches[name] += n
    ladder_past, more, ladder_bwd_at_99 = examples_and_players(dev, card)
    for name, n in more.items():
        pe_launches[name] = pe_launches.get(name, 0) + n
    next(e for e in backward if e["name"] == "ladder_scan_bwd")["launches"] += ladder_bwd_at_99
    backward.append(ladder_past)
    entries = list(osc_entries)
    for name, info in serial.items():
        entries.append({"name": name, "route": "cuda", **info,
                        "launches": pe_launches[name], "library_ms": None})
    entries.extend(backward)
    print(json.dumps({"kernels": entries}))
    print_ok()


def device_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` calls of ``fn`` by CUDA events, after a warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_ok() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def _seeded(dev, seed, *shapes, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(lo, hi, s).astype(np.float32)).to(dev)
            for s in shapes]


def _err(got, ref) -> float:
    return max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))


def timed_plain(fn):
    """One call of a plain version (a Python loop over samples): (its
    result, its ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


PROFILER_SESSIONS = 6


def device_events(fn, reps: int = 10, key: str = ""):
    """{name: [ms, ...]} of the device events of ``reps`` calls of ``fn``
    (after a warm-up call), from torch.profiler, or None. A session that
    traced no device event whose name holds ``key`` is run again, up to
    ``PROFILER_SESSIONS`` in all: on the H100 sessions come back empty, often
    one or two in a row and once three, and the next one full."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                events[e.name].append((e.time_range.end - e.time_range.start) / 1e3)
        if any(key in name for name in events):
            return events
        print(f"device_events: session {attempt + 1} traced no device event named {key!r}: "
              f"{sorted(events)[:4]}")
    return None


def busy_stream_ms(fn, reps: int = 10) -> float:
    """Device ms of a call of ``fn``, every item it enqueues, by CUDA events
    around ``reps`` calls enqueued behind a spin of the stream: the
    host's enqueue is hidden, so the events see the calls back to back on
    the card. The stand-in for torch.profiler where no session traced the
    kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms at the H100's 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, key: str, reps: int = 10) -> float:
    """Time on the card a call of ``fn`` spends in the kernels whose name
    holds ``key``, every kernel of a call summed, from torch.profiler's
    device events of ``reps`` calls: the kernel alone, where CUDA events
    around back-to-back calls would also count the host's enqueue of a
    short kernel. Some sessions drop events or trace some twice: a session
    that traced a kernel other than ``reps`` times is run again, at most
    twice more, and past that each kernel counts at its median event (each
    kernel here launches once a call). Where no session traced the kernel,
    the call's every item by ``busy_stream_ms``, which says so."""
    ours = {}
    for _ in range(3):
        events = device_events(fn, reps, key)
        if events is None:
            ms = busy_stream_ms(fn, reps)
            print(f"kernel_ms: torch.profiler traced no {key}; a call's device items by CUDA "
                  f"events behind a busy stream: {ms:.4f} ms")
            return ms
        ours = {name: ts for name, ts in events.items() if key in name}
        if all(len(ts) == reps for ts in ours.values()):
            return sum(sum(ts) for ts in ours.values()) / reps
    print(f"kernel_ms: no session traced each {key} kernel {reps} times; medians")
    return sum(statistics.median(ts) for ts in ours.values())


def launch_split(fn, reps: int = 10, key: str = "") -> dict:
    """Mean device ms a call of ``fn`` spends in each item it enqueues, by
    name (torch.profiler's device events); where no session traced ``key``,
    one entry named for it: the call's every item by ``busy_stream_ms``."""
    events = device_events(fn, reps, key)
    if events is None:
        ms = busy_stream_ms(fn, reps)
        print(f"launch_split: torch.profiler traced no {key}; a call's device items by CUDA "
              f"events behind a busy stream: {ms:.4f} ms")
        return {f"{key} (all items, events behind a busy stream)": ms}
    return {name: sum(ts) / reps for name, ts in events.items()}


def compare(name, got, ref, tol, what):
    err = _err(got, ref)
    print(f"{name} vs plain, {what}: max abs err {err:.3g}")
    finite = all(torch.isfinite(g.float()).all().item() for g in got)
    check(finite and err <= tol, f"{name} {what}: kernel disagrees with plain ({err})")
    return err


def _copies(args):
    """Copies of a call's tensors: the echo kernel updates its block
    buffers in place."""
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def handoff(fn, ref_fn, args, cut, n_state, kw, ref=None):
    """Two kernel calls across ``cut`` vs one plain call (or ``ref``, its
    result)."""
    n_time = len(args) - n_state
    args, given = _copies(args), args
    first = fn(*(a[:cut] for a in args[:n_time]), *args[n_time:], **kw)
    second = fn(*(a[cut:] for a in args[:n_time]), *first[1:1 + n_state], **kw)
    got = (torch.cat([first[0], second[0]]), *second[1:])
    return got, ref if ref is not None else ref_fn(*given, **kw)


def serial_kernels(dev, card, device_ms) -> dict:
    """Phase 5: the PE graph's kernels against their plain versions on the
    card, and their times at the main path's block. Returns the kernels'
    JSON fields but ``launches``."""
    from pygmu2_tpu_torch.ops import adsr, comb, ladder

    T, L = FX_T, 2206  # L: the comb ring at 44.1 kHz, min_frequency 20 Hz
    ladder_kw = dict(os_n=2, pbg=0.5, mode_index=0, input_threshold=1e-5,
                     state_decay=0.95)
    comb_kw = dict(L=L, sr=float(SR), smooth_alpha=1 / 2400)
    adsr_kw = dict(dA=1 / (0.01 * SR), dD=(0.6 - 1) / (0.05 * SR),
                   dR=-0.6 / (0.1 * SR), sus=0.6)
    out = {}

    def ladder_args(T, C, seed):
        x, qa, dsc, st = _seeded(dev, seed, (T, C), (T,), (T,), (9, C))
        (al,) = _seeded(dev, seed + 1, (T,), lo=0.05, hi=0.6)
        (ki,) = _seeded(dev, seed + 2, (T,), lo=0.0, hi=3.2)
        return x, al, qa * 0.1 + 1.0, ki, dsc + 1.5, st * 0.1

    def comb_args(T, C, seed, modulated=False, jumps=False, delay=None):
        """Constant 220 Hz, or ``modulated`` (200-240 Hz noise), or ``jumps``
        (150 and 300 Hz alternating every 500 samples: with a fast smoother
        the delay halves and doubles within a window), or a constant
        ``delay`` in samples."""
        x, fb, buf = _seeded(dev, seed, (T, C), (T,), (L, C))
        if modulated:
            (freq,) = _seeded(dev, seed + 1, (T,), lo=200.0, hi=240.0)
        elif jumps:
            freq = 150.0 + 150.0 * ((torch.arange(T, device=dev) // 500) % 2).float()
        else:
            freq = torch.full((T,), SR / delay if delay else 220.0, device=dev)
        return (x, freq, fb * 0.7, buf * 0.1, torch.tensor(3, dtype=torch.int32, device=dev),
                torch.tensor(-1.0, device=dev))

    def gate_args(T, triggered, every=False):
        """Many edges, or an edge every sample (gated: alternating levels;
        triggered: a trigger every sample)."""
        g = np.zeros(T, np.float32)
        g[100:T // 3] = 1.0
        g[T // 2:T - 100:37] = 1.0  # many edges
        if every:
            g = np.ones(T, np.float32) if triggered else (np.arange(T) % 2).astype(np.float32)
        elif triggered:
            g = (np.diff(g, prepend=0.0) > 0).astype(np.float32)
        return torch.from_numpy(g).to(dev), torch.zeros(4, device=dev)

    # ---- ladder: bit for bit; os_n 1, 2 and 4 take their own instantiations,
    # 3 the generic one; C = 33 leaves a partial warp ----
    errs = []
    for os_n in (1, 2, 4, 3):
        n = T if os_n <= 2 else T // 2  # the plain version's time grows with os_n
        kw = dict(ladder_kw, os_n=os_n, mode_index=os_n % 6)
        for C in (1, 33, 128):
            args = ladder_args(n, C, seed=C + os_n)
            ref = ladder.ladder_scan_ref(*args, **kw)
            got = ladder.ladder_scan(*args, **kw)
            torch.cuda.synchronize()
            errs.append(compare("ladder_scan", got, ref, 0.0, f"os_n={os_n} C={C} T={n}"))
            got, ref = handoff(ladder.ladder_scan, None, args, n // 2 + 5, 1, kw, ref)
            errs.append(compare("ladder_scan", got, ref, 0.0,
                                f"os_n={os_n} C={C} two-call hand-off"))

    def ladder_bound(C):
        return bound(4 * (2 * BLOCK * C + 4 * BLOCK + 18 * C), LADDER_OPS * BLOCK * C)

    times = {}
    for C in (1, 128):  # the main path's block: timed, and held to plain (C = 1 on
        # its first EVERY_T samples; C = 128's plain run times the plain version)
        args = ladder_args(BLOCK, C, seed=10 + C)
        if C == 128:
            ref, plain_ms = timed_plain(lambda: ladder.ladder_scan_ref(*args, **ladder_kw))
            got, n = ladder.ladder_scan(*args, **ladder_kw), BLOCK
        else:
            head = [a[:EVERY_T] for a in args[:5]] + [args[5]]
            ref, plain_ms = ladder.ladder_scan_ref(*head, **ladder_kw), None
            got, n = ladder.ladder_scan(*head, **ladder_kw), EVERY_T
        errs.append(compare("ladder_scan", got, ref, 0.0, f"C={C} T={n}"))
        times[C] = (device_ms(lambda: ladder.ladder_scan(*args, **ladder_kw), 10), plain_ms)
        print(f"ladder_scan T={BLOCK} C={C}: kernel {times[C][0]:.4f} ms, bound "
              f"{ladder_bound(C)[0]:.4g} ms"
              + (f", plain {plain_ms:.1f} ms" if plain_ms is not None else "") + f" [{card}]")
    C = 128
    ms_bound, by = ladder_bound(C)
    out["ladder_scan"] = {
        "source": "pygmu2_tpu_torch/csrc/ladder_scan.cu",
        "replaces": "pygmu2_tpu/ops/ladder_pallas.py:202",
        "max_abs_err": max(errs), "ms": times[C][0], "plain_ms": times[C][1],
        "bound_ms": ms_bound, "bound_by": by, "shape": f"T={BLOCK} C={C}",
    }

    # ---- comb: bit for bit; windows of ~200 samples (modulated), a delay
    # that jumps across window edges, and delays 1, 2, 7 (the serial walk) ----
    errs = []
    for C in (1, 23, 128):
        cases = {"constant frequency": dict(modulated=False),
                 "modulated": dict(modulated=True),
                 "jumping delay": dict(jumps=True)}
        cases.update({f"delay {d}": dict(delay=d) for d in (1, 2, 7)})
        for what, opts in cases.items():
            args = comb_args(T, C, seed=C, **opts)
            kw = dict(comb_kw, smooth_alpha=0.5) if "jumps" in opts else comb_kw
            got = comb.comb_scan(*args, **kw)
            torch.cuda.synchronize()
            errs.append(compare("comb_scan", got, comb.comb_scan_ref(*args, **kw), 0.0,
                                f"C={C} T={T} {what}"))
        args = comb_args(T, C, seed=C, modulated=True)
        got, ref = handoff(comb.comb_scan, comb.comb_scan_ref, args, T // 2, 3, comb_kw)
        errs.append(compare("comb_scan", got, ref, 0.0, f"C={C} two-call hand-off"))
    times = {}
    for C in (1, 128):  # the main path's block: timed, and held to plain
        args = comb_args(BLOCK, C, seed=10 + C, modulated=True)
        ref, plain_ms = timed_plain(lambda: comb.comb_scan_ref(*args, **comb_kw))
        errs.append(compare("comb_scan", comb.comb_scan(*args, **comb_kw), ref, 0.0,
                            f"C={C} T={BLOCK}"))
        times[C] = (device_ms(lambda: comb.comb_scan(*args, **comb_kw), 10), plain_ms)
        print(f"comb_scan T={BLOCK} C={C} L={L}: kernel {times[C][0]:.4f} ms, "
              f"plain {times[C][1]:.1f} ms [{card}]")
    C = 128
    ms_bound, by = bound(4 * (2 * BLOCK * C + 2 * BLOCK + 2 * L * C + 4),
                         COMB_OPS_SAMPLE * BLOCK + COMB_OPS_CHANNEL * BLOCK * C)
    out["comb_scan"] = {
        "source": "pygmu2_tpu_torch/csrc/comb_scan.cu",
        "replaces": "pygmu2_tpu/ops/comb_pallas.py:125",
        "max_abs_err": max(errs), "ms": times[C][0], "plain_ms": times[C][1],
        "bound_ms": ms_bound, "bound_by": by, "shape": f"T={BLOCK} C={C} L={L}",
    }

    # ---- ADSR: bit for bit (env, state and the carried envelope), on the
    # edge walk (many edges) and, past 2816 edges a tile, on the per-sample
    # walk (an edge every sample) ----
    errs = []
    for S in (None, 2206, 1, 1 << 24):  # gated, then triggered: sustain counts
        kw = dict(adsr_kw, sustain_samples=S)
        what = "gated" if S is None else f"triggered, sustain_samples={S}"
        for gate, path in (("many edges", "edge walk"), ("an edge every sample", "per-sample walk")):
            n = T if path == "edge walk" else EVERY_T
            args = gate_args(n, S is not None, every=path == "per-sample walk")
            ref = adsr.adsr_scan_ref(*args, **kw)
            got = adsr.adsr_scan(*args, **kw)
            torch.cuda.synchronize()
            errs.append(compare("adsr_scan", got, ref, 0.0, f"{what}, {gate} T={n} ({path})"))
            got, _ = handoff(adsr.adsr_scan, None, args, n // 3 + 50, 1, kw, ref)
            errs.append(compare("adsr_scan", got, ref, 0.0, f"{what}, {gate}, two-call hand-off"))
    # the absolute-clock machine (AdsrTriggeredPE at sustain_samples + 1 of
    # 1 and 2**24): bit for bit, from the first state and mid-sustain
    def clock_args(n, stage, env, ends):
        trig, _ = gate_args(n, True)
        return (trig, torch.full((), stage, dtype=torch.int32, device=dev),
                torch.full((), env, dtype=torch.float64, device=dev),
                torch.full((), ends, dtype=torch.int64, device=dev))

    for S in (1, 1 << 24):
        kw = dict(adsr_kw, t0=5000, sustain_samples=S - 1)
        for start, state in (("first state", (0, 0.0, 0)),
                             ("mid-sustain", (3, 0.6, 5000 + 700))):
            args = clock_args(T, *state)
            got = adsr.adsr_clock_scan(*args, **kw)
            torch.cuda.synchronize()
            ref = adsr.adsr_clock_scan_ref(*args, **kw)
            errs.append(compare("adsr_clock_scan", [got[0], *got[1]], [ref[0], *ref[1]], 0.0,
                                f"sustain_samples={S - 1} T={T} from the {start}"))
        first = adsr.adsr_clock_scan(*(a[:T // 3] if a.dim() else a for a in args), **kw)
        second = adsr.adsr_clock_scan(args[0][T // 3:], *first[1],
                                      **dict(kw, t0=kw["t0"] + T // 3))
        errs.append(compare("adsr_clock_scan", [torch.cat([first[0], second[0]]), *second[1]],
                            [ref[0], *ref[1]], 0.0,
                            f"sustain_samples={S - 1} two-call hand-off"))
    # the main path's block, timed: a block of the patch's own gate and
    # trigger with its two ADSRs' parameters, the many-edges gate, and an
    # edge every sample; held to plain, the patch's gate whole (its plain
    # run times the plain version), the others on their first EVERY_T samples
    times, cases = {}, patch_adsr_blocks(dev)
    cases["many edges"] = (gate_args(BLOCK, False), adsr_kw)
    cases["an edge every sample"] = (gate_args(BLOCK, False, every=True), adsr_kw)
    for i, (what, (args, kw)) in enumerate(cases.items()):
        if i == 0:
            ref, plain = timed_plain(lambda: adsr.adsr_scan_ref(*args, **kw))
            got, held_on = adsr.adsr_scan(*args, **kw), BLOCK
        else:
            head = (args[0][:EVERY_T], args[1])
            ref, plain = adsr.adsr_scan_ref(*head, **kw), None
            got, held_on = adsr.adsr_scan(*head, **kw), EVERY_T
        errs.append(compare("adsr_scan", got, ref, 0.0, f"{what} T={held_on}"))
        times[what] = (kernel_ms(lambda: adsr.adsr_scan(*args, **kw), "adsr_scan"), plain,
                       device_ms(lambda: adsr.adsr_scan(*args, **kw), 10))
        print(f"adsr_scan T={BLOCK} {what}: kernel {times[what][0]:.4f} ms (CUDA events over "
              f"calls: {times[what][2]:.4f} ms)"
              + (f", plain {plain:.1f} ms" if plain is not None else "") + f" [{card}]")
    args = clock_args(BLOCK, 0, 0.0, 0)
    kw = dict(adsr_kw, t0=0, sustain_samples=0)
    ref, clock_plain = timed_plain(lambda: adsr.adsr_clock_scan_ref(*args, **kw))
    got = adsr.adsr_clock_scan(*args, **kw)
    errs.append(compare("adsr_clock_scan", [got[0], *got[1]], [ref[0], *ref[1]], 0.0,
                        f"sustain_samples=0 T={BLOCK}"))
    clock_ms = device_ms(lambda: adsr.adsr_clock_scan(*args, **kw), 10)
    print(f"adsr_clock_scan T={BLOCK}: kernel {clock_ms:.4f} ms, plain {clock_plain:.1f} ms "
          f"[{card}]")
    ms_bound, by = bound(4 * (2 * BLOCK + 8), ADSR_OPS * BLOCK)
    ms, plain, events_ms = times["the patch's gate"]
    out["adsr_scan"] = {
        "source": "pygmu2_tpu_torch/csrc/adsr_scan.cu",
        "replaces": "pygmu2_tpu/ops/adsr_pallas.py:268",
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
        "bound_ms": ms_bound, "bound_by": by, "shape": f"T={BLOCK}, the patch's gate",
        "ms_trigger": times["the patch's trigger"][0],
        "ms_many_edges": times["many edges"][0],
        "ms_every_sample": times["an edge every sample"][0],
        "events_ms": events_ms,
        "clock_ms": clock_ms, "clock_plain_ms": clock_plain,
    }
    return out


def patch_adsr_blocks(dev) -> dict:
    """The first block of the patch's two ADSRs: the gate and trigger as
    the patch renders them, and each PE's own parameters; (args, kwargs)
    of ``adsr_scan`` from the first state."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import patch_workload

    pg.set_sample_rate(SR)
    out = {}
    gated, trig = patch_workload.patch_envelopes(pg)
    for what, pe, src in (("the patch's gate", gated, gated._gate),
                          ("the patch's trigger", trig, trig._trigger)):
        g = pg.render_to_array(pg.CropPE(src, 0, BLOCK), block=BLOCK, device=dev)[:, 0]
        kw = pe._slopes()
        if pe is trig:
            kw["sustain_samples"] = pe._sustain_samples + 1  # as AdsrTriggeredPE passes it
        out[what] = ((torch.from_numpy(np.ascontiguousarray(g)).to(dev),
                      torch.zeros(4, device=dev)), kw)
    return out


def _on_host(fn):
    """``fn`` on copies of its tensor arguments on the CPU, its results
    copied back to the arguments' device."""
    def call(*args, **kw):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        out = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args), **kw)
        return tuple(o.to(dev) for o in out)
    return call


@contextlib.contextmanager
def plain_versions(swaps, host=False):
    """PE renders inside take the plain versions of the kernels in
    ``swaps``, a list of (module, wrapper name); ``host``: on the CPU, on
    copies of the card's inputs (a per-sample loop runs several times
    faster there than on the card, where each of its steps is a launch)."""
    kernels = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        ref = getattr(mod, name + "_ref")
        setattr(mod, name, _on_host(ref) if host else ref)
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, kernels):
            setattr(mod, name, fn)


def pe_graph(dev, card) -> dict:
    """Phase 6: the subtractive patch and the bank through
    ``render_to_array``; returns each kernel's launches on that path."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import patch_workload
    from pygmu2_tpu_torch.ops import adsr, comb, ladder

    swaps = [(ladder, "ladder_scan"), (comb, "comb_scan"), (adsr, "adsr_scan")]
    counters = {name: getattr(mod, name) for mod, name in swaps}
    cases = [
        ("patch, 60 s mono", 60.0, lambda s: patch_workload.build_patch(pg, s), 1),
        ("bank, 10 s x 128 channels", 10.0,
         lambda s: patch_workload.build_bank(pg, s, seed=0), patch_workload.BANK_CHANNELS),
    ]
    graphs = [build(seconds) for _label, seconds, build, _c in cases]
    for fn in counters.values():
        fn.launches = 0  # the main path's run starts here
    per_case = []
    outs = []
    for (label, seconds, _build, channels), graph in zip(cases, graphs):
        before = {k: fn.launches for k, fn in counters.items()}
        out = pg.render_to_array(graph, device=dev)
        per_case.append({k: fn.launches - before[k] for k, fn in counters.items()})
        outs.append(out)
    launches = {k: fn.launches for k, fn in counters.items()}

    for (label, seconds, build, channels), graph, out, n in zip(cases, graphs, outs, per_case):
        check(out.shape == (int(round(seconds * SR)), channels) and out.dtype == np.float32,
              f"{label}: output {out.dtype} {out.shape}")
        check(bool(np.isfinite(out).all()) and np.abs(out).max() > 0.1,
              f"{label}: not finite or silent")
        for name, count in n.items():
            check(count > 0, f"{label}: {name} was not launched")
        # the first 0.1 s, kernels against plain versions on the card
        got = pg.render_to_array(build(0.1), block=4096, device=dev)
        with plain_versions(swaps):
            ref = pg.render_to_array(build(0.1), block=4096, device=dev)
        err = float(np.abs(got - ref).max())
        check(err <= TOL and np.abs(ref).max() > 0.1,
              f"{label}: first 0.1 s, kernels vs plain {err}")

        # timed, after the main path's render of the same graph (warm-up)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        pg.render_to_array(graph, device=dev)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ev = start.elapsed_time(end) / 1e3
        print(f"{label}: launches {n}; first 0.1 s kernels vs plain max abs err "
              f"{err:.3g}; realtime x{seconds / wall:.2f} wall ({wall * 1e3:.1f} ms), "
              f"x{seconds / ev:.2f} by CUDA events ({ev * 1e3:.1f} ms) [{card}]")
    return launches


def fx_kernels(dev, card, device_ms) -> dict:
    """Phase 7: the effects chain's kernels against their plain versions on
    the card, and their times at the main path's block. Returns the
    kernels' JSON fields but ``launches``."""
    from pygmu2_tpu_torch.ops import envelope, ks, reverse_echo, slew

    T = FX_T
    out = {}

    def held(name, fn, ref_fn, args, kw, tol, what):
        """The plain version first (timed, one call), then the kernel on
        copies of the same arguments: (max abs err, plain ms, plain result)."""
        ref, plain_ms = timed_plain(lambda: ref_fn(*args, **kw))
        got = fn(*_copies(args), **kw)
        torch.cuda.synchronize()
        return compare(name, got, ref, tol, what), plain_ms, ref

    def timed(name, fn, ref_fn, args, kw, tol, what, errs):
        """At the main path's block: held to plain, then timed on the same
        arguments: (kernel ms, plain ms)."""
        err, plain_ms, _ = held(name, fn, ref_fn, args, kw, tol, f"{what} T={BLOCK}")
        errs.append(err)
        ms = device_ms(lambda: fn(*args, **kw), 10)
        print(f"{name} T={BLOCK} {what}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms "
              f"[{card}]")
        return ms, plain_ms

    def entry(source, replaces, errs, ms, plain_ms, nbytes, ops, shape):
        ms_bound, by = bound(nbytes, ops)
        return {"source": f"pygmu2_tpu_torch/csrc/{source}", "replaces": replaces,
                "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": ms_bound, "bound_by": by, "shape": shape}

    # ---- Karplus-Strong: one string (C = 1), from 2 samples (one thread
    # per sample) to longer than shared memory holds ----
    def ks_args(n, L, seed, act="start"):
        """act: the string starts mid-call ("start", as on the main path),
        "all", "none", or "gaps" (a random third of the samples inactive)."""
        (rho,) = _seeded(dev, seed, (n,), lo=0.99, hi=0.9999)
        (buf,) = _seeded(dev, seed + 1, (L,), lo=-0.3, hi=0.3)
        t = torch.arange(n, device=dev)
        (u,) = _seeded(dev, seed + 2, (n,), lo=0.0, hi=1.0)
        mask = {"start": t >= 100, "all": t >= 0, "none": t < 0, "gaps": u < 2 / 3}[act]
        return (rho, mask, buf, torch.tensor(3 % L, dtype=torch.int32, device=dev),
                torch.tensor(0.05, device=dev), torch.tensor(-0.05, device=dev))

    errs = []
    # 535: the low E string at 44.1 kHz; 133: the chain's highest
    for L in (2, 7, 133, 535, ks.MAX_KERNEL_L + 1):
        kw = dict(L=L, allpass_c=0.35)
        for act in ("start", "all", "none", "gaps"):
            args = ks_args(T, L, seed=L, act=act)
            err, _plain, ref = held("ks_scan", ks.ks_scan, ks.ks_scan_ref, args, kw, 0.0,
                                    f"L={L} T={T} act {act}")
            errs.append(err)
        # the hand-off at a window's edge (the third, or the first where three
        # pass the call's end): the string starts at 100, and windows hold
        # window_length(L) active samples
        args = ks_args(T, L, seed=L)
        w = max(1, ks.window_length(L))
        cut = 100 + (3 if 100 + 3 * w < T else 1) * w
        got, ref = handoff(ks.ks_scan, ks.ks_scan_ref, args, cut, 4, kw)
        errs.append(compare("ks_scan", got, ref, 0.0, f"L={L} two-call hand-off at {cut}"))
    ms_133_serial, _ = timed("ks_scan", ks.ks_scan, ks.ks_scan_ref,
                             ks_args(BLOCK, 133, seed=2), dict(L=133, allpass_c=0.35), 0.0,
                             "L=133 (per-sample order)", errs)
    ms_serial, plain_serial = timed("ks_scan", ks.ks_scan, ks.ks_scan_ref,
                                    ks_args(BLOCK, 535, seed=1), dict(L=535, allpass_c=0.35),
                                    0.0, "L=535 (per-sample order)", errs)

    # the blocked order, every sample active (the chain's strings: the JAX
    # KarplusStrongPE's ks_blocked), bit for bit, with a hand-off mid-block
    def blocked(rho, act, buf, r, ai, ao, **kw):
        return ks.ks_scan(rho, act, buf, r, ai, ao, all_active=True, **kw)

    def blocked_ref(rho, act, buf, r, ai, ao, **kw):
        return ks.ks_blocked_ref(rho, buf, r, ai, ao, **kw)

    for L in (16, 133, 535, ks.MAX_KERNEL_L + 1):
        kw = dict(L=L, allpass_c=0.35)
        args = ks_args(T, L, seed=L + 7, act="all")
        err, _plain, _ref = held("ks_scan", blocked, blocked_ref, args, kw, 0.0,
                                 f"blocked L={L} T={T}")
        errs.append(err)
        # blocks start at each call's first sample: two calls against two
        got, _ = handoff(blocked, None, args, 1000, 4, kw, ref=())
        ref, _ = handoff(blocked_ref, None, args, 1000, 4, kw, ref=())
        errs.append(compare("ks_scan", got, ref, 0.0, f"blocked L={L} two-call hand-off"))
    ms_133, plain_133 = timed("ks_scan", blocked, blocked_ref, ks_args(BLOCK, 133, seed=2, act="all"),
                              dict(L=133, allpass_c=0.35), 0.0, "L=133 blocked", errs)
    L, kw = 535, dict(L=535, allpass_c=0.35)
    ms, plain_ms = timed("ks_scan", blocked, blocked_ref, ks_args(BLOCK, L, seed=1, act="all"),
                         kw, 0.0, f"L={L} blocked", errs)
    # the blocked order's operations: two-point average 3, u 2, and row j
    # of a block of B = min(L - 1, 512) rows j + 1 multiply-adds (2 each)
    # plus 9 for the lanes' sums and the state's multiply-add
    B = min(L - 1, ks.BLOCKED_MAX_B)
    nb, rem = divmod(BLOCK, B)
    gemv_ops = 2 * (nb * B * (B + 1) // 2 + rem * (rem + 1) // 2)
    out["ks_scan"] = entry(
        "ks_scan.cu", "pygmu2_tpu/ops/ks_pallas.py:115", errs, ms, plain_ms,
        4 * BLOCK + 4 * (2 * L + 6) + 8 * B, gemv_ops + 14 * BLOCK,
        f"T={BLOCK} L={L} C=1, every sample active (the blocked order)")
    out["ks_scan"].update(ms_L133=ms_133, plain_ms_L133=plain_133, ms_serial=ms_serial,
                          plain_ms_serial=plain_serial, ms_serial_L133=ms_133_serial)

    # ---- envelope follower: the wah's attack and release ----
    env_kw = dict(atk=1.0 - np.exp(-1.0 / (0.005 * SR)), rel=1.0 - np.exp(-1.0 / (0.08 * SR)))

    def env_args(n, C, seed):
        x, env0 = _seeded(dev, seed, (n, C), (C,), lo=0.0, hi=0.5)
        x[n // 3: n // 2] *= 1e-3  # a quiet stretch: the release branch
        return x, env0

    errs, times = [], {}
    name, fn, ref_fn = ("envelope_ar_scan", envelope.envelope_ar_scan,
                        envelope.envelope_ar_scan_ref)
    for C in (1, 33, 128):  # 33: a partial warp, and a block of one channel 33
        # apart (4-byte copies); a hand-off's second call has x unaligned
        args = env_args(T, C, seed=C)
        err, _plain, ref = held(name, fn, ref_fn, args, env_kw, 0.0, f"C={C} T={T}")
        errs.append(err)
        got, ref = handoff(fn, None, args, T // 3, 1, env_kw, ref)
        errs.append(compare(name, got, ref, 0.0, f"C={C} two-call hand-off"))
        if C != 33:
            args = env_args(BLOCK, C, seed=10 + C)
            events_ms, plain_ms = timed(name, fn, ref_fn, args, env_kw, 0.0, f"C={C}", errs)
            ms = kernel_ms(lambda: fn(*args, **env_kw), name)
            print(f"{name} T={BLOCK} C={C}: kernel alone {ms:.4f} ms [{card}]")
            times[C] = (ms, plain_ms, events_ms)
    C = 128
    out["envelope_ar_scan"] = entry(
        "envelope_ar_scan.cu", "pygmu2_tpu/ops/envelope_pallas.py:97", errs, *times[C][:2],
        4 * (2 * BLOCK * C + 2 * C), ENV_OPS * BLOCK * C, f"T={BLOCK} C={C}")
    out["envelope_ar_scan"].update(ms_C1=times[1][0], events_ms=times[C][2],
                                   events_ms_C1=times[1][2])

    # ---- slew limiter: the wah's centre (LINEAR) and an exponential one ----
    modes = {"linear": dict(linear=True, p_rise=40000.0 / SR, p_fall=8000.0 / SR),
             "exponential": dict(linear=False, p_rise=0.05, p_fall=0.002)}

    def slew_args(n, seed):
        (x,) = _seeded(dev, seed, (n // 64 + 1,), lo=300.0, hi=2800.0)
        return x.repeat_interleave(64)[:n].contiguous(), torch.tensor(300.0, device=dev)

    errs, times = [], {}
    for mode, kw in modes.items():
        args = slew_args(T, seed=len(mode))
        err, _plain, ref = held("slew_scan", slew.slew_scan, slew.slew_scan_ref, args, kw,
                                0.0, f"{mode} T={T}")
        errs.append(err)
        got, ref = handoff(slew.slew_scan, None, args, T // 3, 1, kw, ref)
        errs.append(compare("slew_scan", got, ref, 0.0, f"{mode} two-call hand-off"))
        args = slew_args(BLOCK, seed=7)
        events_ms, plain_ms = timed("slew_scan", slew.slew_scan, slew.slew_scan_ref, args, kw,
                                    0.0, mode, errs)
        ms = kernel_ms(lambda: slew.slew_scan(*args, **kw), "slew_scan")
        print(f"slew_scan T={BLOCK} {mode}: kernel alone {ms:.4f} ms [{card}]")
        times[mode] = (ms, plain_ms, events_ms)
    out["slew_scan"] = entry(
        "slew_scan.cu", "pygmu2_tpu/ops/slew_pallas.py:107", errs, *times["linear"][:2],
        4 * (2 * BLOCK + 2), SLEW_OPS * BLOCK, f"T={BLOCK} linear")
    out["slew_scan"].update(ms_exponential=times["exponential"][0],
                            events_ms=times["linear"][2],
                            events_ms_exponential=times["exponential"][2])

    # ---- reverse echo: the chain's rings (0.5 s of buffer, 60 Hz line) ----
    cap, plen = SR // 2, SR // 60
    echo_kw = dict(sr=float(SR), plen=plen, cap=cap, min_block=64, max_block=cap - 1,
                   smooth_alpha=1 / 2400)

    def echo_args(n, C, seed, block_s, alt, replaying=False, modulated=False, mid=False):
        """The echo's arguments from its first state, or (``replaying``)
        from a state with a full previous block of noise: it replays from
        sample 0, as on the main path after its first block. ``modulated``:
        block length, pitch and feedback move per sample; ``mid``: the call
        starts 40 samples into a block, the previous block and the pitch
        line holding noise."""
        (x,) = _seeded(dev, seed, (n, C), lo=-0.3, hi=0.3)
        cols = [torch.full((n,), v, device=dev) for v in (block_s, 1.5, 0.6, alt)]
        if modulated:
            t = torch.arange(n, device=dev, dtype=torch.float32)
            cols[:3] = [block_s + 0.5 * block_s * torch.sin(t / 211.0),
                        torch.clamp(1.0 + 0.5 * torch.sin(t / 97.0), min=0.001),
                        0.4 + 0.3 * torch.sin(t / 131.0)]
        rings = [torch.zeros((cap, C), device=dev), torch.zeros((cap, C), device=dev),
                 torch.zeros((plen, C), device=dev)]
        first = float(round(block_s * SR))
        misc = [1, 0, 0, 0, 0, first, first, first if replaying else 0, 1]
        if replaying:
            (rings[1],) = _seeded(dev, seed + 1, (cap, C), lo=-0.3, hi=0.3)
        if mid:  # the current buffer is b: a holds the previous block
            rings = _seeded(dev, seed + 2, (cap, C), (cap, C), (plen, C), lo=-0.3, hi=0.3)
            misc = [0, 57, 13.7, 40, 40, first, first, first - 9, 0]
        return (x, *cols, *rings, torch.tensor(misc, dtype=torch.float32, device=dev))

    def echo_work(C):
        """(bytes, operations) of a call at the main path's block. Bytes: x
        and y, the controls, one block-buffer row read (every sample
        replays) and one written per sample, the pitch line in and out."""
        return (4 * (4 * BLOCK * C + 4 * BLOCK + 2 * plen * C + 18),
                ECHO_OPS_SAMPLE * BLOCK + ECHO_OPS_CHANNEL * BLOCK * C)

    errs, times = [], {}
    name, fn, ref_fn = ("reverse_echo_scan", reverse_echo.reverse_echo_scan,
                        reverse_echo.reverse_echo_scan_ref)
    echo_cases = {  # name: (block seconds, alternate, echo_args options)
        "10 ms blocks, a fifth up": (0.01, 0.0, {}),
        "alternating": (0.01, 1.0, {}),
        "modulated block, pitch and feedback": (0.01, 0.0, dict(modulated=True)),
        "64-sample blocks": (64 / SR, 1.0, {}),
        "mid-period start": (0.01, 0.0, dict(mid=True)),
    }
    for C in (1, 128):
        for i, (what, (block_s, alt, opts)) in enumerate(echo_cases.items()):
            args = echo_args(T, C, seed=C + i, block_s=block_s, alt=alt, **opts)
            err, _plain, ref = held(name, fn, ref_fn, args, echo_kw, 1e-6,
                                    f"C={C} T={T} {what}")
            check(ref[0].abs().max().item() > 1e-3, f"reverse echo C={C} {what}: silent")
            errs.append(err)
            got, ref = handoff(fn, None, args, T // 3, 4, echo_kw, ref)
            errs.append(compare(name, got, ref, 1e-6, f"C={C} {what}, two-call hand-off"))
        # the chain's 0.3 s blocks, replaying a full previous block
        times[C] = timed(name, fn, ref_fn,
                         echo_args(BLOCK, C, seed=10 + C, block_s=0.3, alt=0.0, replaying=True),
                         echo_kw, 1e-6, f"C={C} cap={cap} replaying", errs)
        print(f"  reverse_echo_scan C={C}: bound {bound(*echo_work(C))[0]:.4g} ms")
    C = 128
    out["reverse_echo_scan"] = entry(
        "reverse_echo_scan.cu", "pygmu2_tpu/ops/reverse_echo_pallas.py:338", errs, *times[C],
        *echo_work(C), f"T={BLOCK} C={C} cap={cap}")
    return out


def fx_graph(dev, card) -> dict:
    """Phase 8: the effects chain and the fx bank through
    ``render_to_array``; returns each kernel's launches on that path."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fx_workload, patch_workload
    from pygmu2_tpu_torch.ops import envelope, ks, reverse_echo, slew

    swaps = [(ks, "ks_scan"), (envelope, "envelope_ar_scan"), (slew, "slew_scan"),
             (reverse_echo, "reverse_echo_scan")]
    counters = {name: getattr(mod, name) for mod, name in swaps}
    cases = [
        ("chain, 60 s mono", 60.0, lambda s: fx_workload.build_chain(pg, s), 1,
         tuple(counters)),
        ("fx bank, 10 s x 128 channels", 10.0,
         lambda s: fx_workload.build_fx_bank(pg, s, seed=0), patch_workload.BANK_CHANNELS,
         ("envelope_ar_scan", "reverse_echo_scan")),
    ]
    graphs = [build(seconds) for _label, seconds, build, _c, _k in cases]
    for fn in counters.values():
        fn.launches = 0  # the main path's run starts here
    per_case, outs, walls = [], [], []
    for graph in graphs:
        before = {k: fn.launches for k, fn in counters.items()}
        t = time.perf_counter()
        out = pg.render_to_array(graph, device=dev)
        walls.append(time.perf_counter() - t)
        per_case.append({k: fn.launches - before[k] for k, fn in counters.items()})
        outs.append(out)
    launches = {k: fn.launches for k, fn in counters.items()}

    for (label, seconds, build, channels, used), graph, out, n, first_wall in zip(
            cases, graphs, outs, per_case, walls):
        check(out.shape == (int(round(seconds * SR)), channels) and out.dtype == np.float32,
              f"{label}: output {out.dtype} {out.shape}")
        check(bool(np.isfinite(out).all()) and np.abs(out).max() > 0.05,
              f"{label}: not finite or silent")
        for name in used:
            check(n[name] > 0, f"{label}: {name} was not launched")
        # the first 0.4 s, kernels against plain versions on the card
        got = pg.render_to_array(build(FX_CHECK_S), block=4096, device=dev)
        with plain_versions(swaps):
            ref = pg.render_to_array(build(FX_CHECK_S), block=4096, device=dev)
        err = float(np.abs(got - ref).max())
        check(err <= TOL and np.abs(ref).max() > 0.05,
              f"{label}: first {FX_CHECK_S} s, kernels vs plain {err}")

        # timed, after the main path's render of the same graph (warm-up)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        pg.render_to_array(graph, device=dev)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ev = start.elapsed_time(end) / 1e3
        print(f"{label}: launches {n}; first {FX_CHECK_S} s kernels vs plain max abs "
              f"err {err:.3g}; first render {first_wall * 1e3:.1f} ms; realtime "
              f"x{seconds / wall:.2f} wall ({wall * 1e3:.1f} ms), x{seconds / ev:.2f} "
              f"by CUDA events ({ev * 1e3:.1f} ms) [{card}]")
    return launches


def _high_score_rows(dev, seconds):
    """The high-register score's control rows through the large font:
    (rows, wave, N)."""
    from pygmu2_tpu_torch import bench_workload
    from pygmu2_tpu_torch.soundfont import MidiFile
    from pygmu2_tpu_torch.soundfont import offline as off

    synth, _ = bench_workload.build_workload(True)
    midi = MidiFile(bench_workload.build_high_midi_bytes(seconds))
    par, ch, _snap, _nb = synth.build_schedule(midi, seconds)
    check(off._out_of_window(synth, par, ch), "high score: not out of the window")
    return bench_workload.audio_pass_rows(synth, midi, seconds, dev)


def scan_kernels(dev, card, device_ms) -> dict:
    """Phase 9: the order-2 affine scan's and the unfused SoundFont pass's
    kernels against their plain versions on the card, and their times at
    the main path's shapes. Returns the kernels' JSON fields but
    ``launches``."""
    from pygmu2_tpu_torch.ops import linrec_kernel as lk
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk

    out = {}

    def scan_args(T, C, seed, shared):
        """Stable 2x2 maps (the SVFilterPE layout when ``shared``: the four
        matrix planes one column for every channel), inputs, a state."""
        mats = _seeded(dev, seed, *[(T, 1 if shared else C)] * 4, lo=-0.7, hi=0.7)
        us = _seeded(dev, seed + 1, (T, C), (T, C))
        s0 = tuple(_seeded(dev, seed + 2, (C,), (C,)))
        return [m.expand(T, C) for m in mats] + us, s0

    errs = []
    for C in (4, 128):
        for chunk in (SCAN_CHUNK, 128):
            what = f"C={C} T={SCAN_T} chunk={chunk}"
            planes, s0 = scan_args(SCAN_T, C, seed=C + chunk, shared=chunk == 128)
            ref = lk.affine_scan_2_chunked_ref(*planes, s0, chunk=chunk)
            got = lk.affine_scan_2_kernel(*planes, s0, chunk=chunk)
            torch.cuda.synchronize()
            errs.append(compare("affine_scan_2", got, ref, 0.0, what))
            cut = SCAN_T // 3  # two calls, the state handed on through s0
            first = lk.affine_scan_2_kernel(*(p[:cut] for p in planes), s0, chunk=chunk)
            second = lk.affine_scan_2_kernel(*(p[cut:] for p in planes),
                                             (first[0][-1], first[1][-1]), chunk=chunk)
            r1 = lk.affine_scan_2_chunked_ref(*(p[:cut] for p in planes), s0, chunk=chunk)
            r2 = lk.affine_scan_2_chunked_ref(*(p[cut:] for p in planes),
                                              (r1[0][-1], r1[1][-1]), chunk=chunk)
            errs.append(compare("affine_scan_2", [torch.cat(x) for x in zip(first, second)],
                                [torch.cat(x) for x in zip(r1, r2)], 0.0,
                                f"{what} two-call hand-off"))
    C = 128
    planes, s0 = scan_args(BLOCK, C, seed=11, shared=True)
    full, _ = scan_args(BLOCK, C, seed=12, shared=False)
    ref, plain_ms = timed_plain(lambda: lk.affine_scan_2_chunked_ref(*planes, s0, chunk=SCAN_CHUNK))
    errs.append(compare("affine_scan_2", lk.affine_scan_2_kernel(*planes, s0, chunk=SCAN_CHUNK),
                        ref, 0.0, f"C={C} T={BLOCK} shared matrix planes"))
    errs.append(compare("affine_scan_2", lk.affine_scan_2_kernel(*full, s0, chunk=SCAN_CHUNK),
                        lk.affine_scan_2_chunked_ref(*full, s0, chunk=SCAN_CHUNK), 0.0,
                        f"C={C} T={BLOCK} six full planes"))
    for p_, what in ((planes, "shared"), (full, "full")):  # the carry's fixed order
        a = lk.affine_scan_2_kernel(*p_, s0, chunk=SCAN_CHUNK)
        b = lk.affine_scan_2_kernel(*p_, s0, chunk=SCAN_CHUNK)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"affine_scan_2 {what}: two calls differ")
    ms = kernel_ms(lambda: lk.affine_scan_2_kernel(*planes, s0, chunk=SCAN_CHUNK), "affine_scan_2")
    full_ms = kernel_ms(lambda: lk.affine_scan_2_kernel(*full, s0, chunk=SCAN_CHUNK),
                        "affine_scan_2")
    ev_ms = device_ms(lambda: lk.affine_scan_2_kernel(*planes, s0, chunk=SCAN_CHUNK), 10)
    full_ev_ms = device_ms(lambda: lk.affine_scan_2_kernel(*full, s0, chunk=SCAN_CHUNK), 10)
    split = launch_split(lambda: lk.affine_scan_2_kernel(*planes, s0, chunk=SCAN_CHUNK),
                         key="affine_scan_2")
    print(f"affine_scan_2 T={BLOCK} C={C} chunk={SCAN_CHUNK}: kernel alone {ms:.4f} ms a call "
          f"(matrix planes shared; CUDA events over calls {ev_ms:.4f} ms), {full_ms:.4f} ms "
          f"(six full planes; events {full_ev_ms:.4f} ms), plain {plain_ms:.1f} ms; a call's "
          "device items: " + ", ".join(f"{k[:48]} {v:.4f} ms" for k, v in split.items())
          + f"; two calls bit for bit [{card}]")
    passes = SCAN_CHUNK.bit_length() - 1
    ms_bound, by = bound(4 * (4 * BLOCK + 2 * BLOCK * C + 2 * C + 2 * BLOCK * C),
                         (SCAN_OPS_PASS * passes + SCAN_OPS_APPLY) * BLOCK * C)
    out["affine_scan_2"] = {
        "source": "pygmu2_tpu_torch/csrc/affine_scan_2.cu",
        "replaces": "pygmu2_tpu/ops/linrec_pallas.py:87",
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "events_ms": ev_ms,
        "full_planes_ms": full_ms, "full_planes_events_ms": full_ev_ms,
        "by_launch_ms": split, "bound_ms": ms_bound, "bound_by": by,
        "shape": f"T={BLOCK} C={C} chunk={SCAN_CHUNK}, matrix planes shared",
    }

    # ---- the unfused SoundFont pass, on the high score's rows ----
    rows, wave, N = _high_score_rows(dev, 3.0)
    xt = fk._oscillator(rows, wave, N)
    T, P = xt.shape
    B = T // N
    ref, plain_ms = timed_plain(lambda: fk.filter_gain_mix_ref(xt, rows, N))
    got = fk.filter_gain_mix(xt, rows, N)
    again = fk.filter_gain_mix(xt, rows, N)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "filter_gain_mix: two calls on the same rows differ")
    peak = ref.abs().max().item()
    check(peak > 0.05, "filter_gain_mix: silent rows")
    err = compare("filter_gain_mix", [got], [ref], 2e-5 * max(1.0, peak),
                  f"high score T={T} P={P} N={N} (peak {peak:.3g})")
    err_cut = _err([got], [fk.filter_gain_mix_cut(xt, rows, N)])
    print(f"filter_gain_mix vs its order in torch ops (filter_gain_mix_cut): max abs err "
          f"{err_cut:.3g}")
    check(err_cut <= 1e-5 * max(1.0, peak),
          f"filter_gain_mix disagrees with its order in torch ops ({err_cut})")
    # the kernel: the segment pass of csrc/filter_pass.cuh over its XtSource
    ms = kernel_ms(lambda: fk.filter_gain_mix(xt, rows, N), "XtSource")
    ev_ms = device_ms(lambda: fk.filter_gain_mix(xt, rows, N), 10)
    split = launch_split(lambda: fk.filter_gain_mix(xt, rows, N), key="XtSource")
    print(f"filter_gain_mix T={T} P={P} N={N}: kernel alone {ms:.4f} ms (CUDA events over calls "
          f"{ev_ms:.4f} ms), plain {plain_ms:.1f} ms; a call's device items: "
          + ", ".join(f"{k[:48]} {v:.4f} ms" for k, v in split.items())
          + f"; two calls bit for bit [{card}]")
    ms_bound, by = bound(4 * (T * P + 10 * B * P + 2 * T), FGM_OPS * T * P)
    out["filter_gain_mix"] = {
        "source": "pygmu2_tpu_torch/csrc/filter_gain_mix.cu",
        "replaces": "pygmu2_tpu/soundfont/filter_pallas.py:182",
        "max_abs_err": err, "max_abs_err_vs_cut": err_cut, "ms": ms, "plain_ms": plain_ms,
        "events_ms": ev_ms, "by_launch_ms": split, "bound_ms": ms_bound, "bound_by": by,
        "shape": f"T={T} P={P} N={N}",
    }
    return out


def filter_graph(dev, card) -> dict:
    """Phase 10: the filter bank through ``render_to_array``; returns the
    scan kernel's launches on that path."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import filter_workload, patch_workload
    from pygmu2_tpu_torch.ops import linrec
    from pygmu2_tpu_torch.ops import linrec_kernel as lk

    seconds = 10.0
    graph = filter_workload.build_filter_bank(pg, seconds, seed=0)
    counter = lk.affine_scan_2_kernel
    counter.launches = 0  # the main path's run starts here
    t = time.perf_counter()
    out = pg.render_to_array(graph, device=dev)
    first_wall = time.perf_counter() - t
    launches = counter.launches
    check(out.shape == (int(round(seconds * SR)), patch_workload.BANK_CHANNELS)
          and out.dtype == np.float32, f"filter bank: output {out.dtype} {out.shape}")
    check(bool(np.isfinite(out).all()) and np.abs(out).max() > 0.05,
          "filter bank: not finite or silent")
    check(launches > 0, "filter bank: affine_scan_2 was not launched")

    # the first 0.4 s, the kernel against its plain version on the card
    got = pg.render_to_array(filter_workload.build_filter_bank(pg, FX_CHECK_S), device=dev)
    linrec.affine_scan_2_kernel = lk.affine_scan_2_chunked_ref
    try:
        ref = pg.render_to_array(filter_workload.build_filter_bank(pg, FX_CHECK_S), device=dev)
    finally:
        linrec.affine_scan_2_kernel = counter
    err = float(np.abs(got - ref).max())
    check(err <= TOL and np.abs(ref).max() > 0.05,
          f"filter bank: first {FX_CHECK_S} s, kernel vs plain {err}")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    pg.render_to_array(graph, device=dev)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ev = start.elapsed_time(end) / 1e3
    print(f"filter bank, 10 s x 128 channels: affine_scan_2 launches {launches}; first "
          f"{FX_CHECK_S} s kernel vs plain max abs err {err:.3g}; first render "
          f"{first_wall * 1e3:.1f} ms; realtime x{seconds / wall:.2f} wall ({wall * 1e3:.1f} ms), "
          f"x{seconds / ev:.2f} by CUDA events ({ev * 1e3:.1f} ms) [{card}]")
    return {"affine_scan_2": launches}


def high_score(dev, card, device_ms) -> dict:
    """Phase 11: the high-register score through the SoundFont entry
    points; returns the unfused pass's launches on that path."""
    from pygmu2_tpu_torch import bench_workload
    from pygmu2_tpu_torch.soundfont import MidiFile
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk
    from pygmu2_tpu_torch.soundfont import offline as off

    seconds = 3.0
    data = bench_workload.build_high_midi_bytes(seconds)
    cases = [("render_midi_offline", off.render_midi_offline),
             ("render_midi_offline_streamed", off.render_midi_offline_streamed)]
    unfused, fused = fk.filter_gain_mix, fk.osc_filter_gain_mix
    fused_before = fused.launches
    unfused.launches = 0  # the main path's run starts here
    per_case = []
    for label, render in cases:
        synth, _ = bench_workload.build_workload(True)
        before = unfused.launches
        pcm = render(synth, MidiFile(data), seconds, wire="int16", device=dev)
        torch.cuda.synchronize()
        per_case.append(unfused.launches - before)
        check(pcm.dtype == np.int16 and pcm.shape == (int(round(seconds * SR)), 2),
              f"high score, {label}: output {pcm.dtype} {pcm.shape}")
        check(np.abs(pcm.astype(np.int32)).max() > 0, f"high score, {label}: silent")
        check(per_case[-1] > 0, f"high score, {label}: filter_gain_mix was not launched")
    launches = unfused.launches
    check(fused.launches == fused_before,
          "high score: the fused kernel was launched on the out-of-window route")

    for (label, render), n in zip(cases, per_case):
        synth, _ = bench_workload.build_workload(True)
        got = render(synth, MidiFile(data), seconds, device=dev)
        fk.filter_gain_mix = fk.filter_gain_mix_ref
        try:
            ref = render(synth, MidiFile(data), seconds, device=dev)
        finally:
            fk.filter_gain_mix = unfused
        err = float(np.abs(got - ref).max())
        check(np.isfinite(got).all() and np.abs(got).max() > 0.05 and err <= TOL,
              f"high score, {label}: kernel render vs plain render {err}")

        def timed():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            render(synth, MidiFile(data), seconds, wire="int16", device=dev)
            end.record()
            torch.cuda.synchronize()
            return time.perf_counter() - t, start.elapsed_time(end) / 1e3

        timed()  # warm-up
        wall, ev = min((timed() for _ in range(3)), key=lambda x: x[0])
        print(f"high score, 3 s, large font, {label}: {n} filter_gain_mix launches; max abs "
              f"err vs plain {err:.3g}; realtime x{seconds / wall:.1f} wall "
              f"({wall * 1e3:.1f} ms), x{seconds / ev:.1f} by CUDA events ({ev * 1e3:.1f} ms) "
              f"[{card}]")

    # a measurement only: the fused kernel on the same rows
    rows, wave, N = _high_score_rows(dev, seconds)
    fused_out, _ = fused(rows, wave, N)
    unfused_out = unfused(fk._oscillator(rows, wave, N), rows, N)
    torch.cuda.synchronize()
    diff = (fused_out - unfused_out).abs().max().item()
    fused_ms = device_ms(lambda: fused(rows, wave, N), 10)
    unfused_ms = device_ms(lambda: unfused(fk._oscillator(rows, wave, N), rows, N), 10)
    print(f"high score rows: fused osc_filter_gain_mix {fused_ms:.4f} ms, unfused route "
          f"(oscillator in torch + filter_gain_mix) {unfused_ms:.4f} ms; outputs differ by "
          f"{diff:.3g} [{card}]")
    return {"filter_gain_mix": launches}


def _stereo_pe(pg, source):
    """A mono source on both channels (so a MidiInPE's drain can be mixed
    before a stereo synth; the port has no SpatialPE yet)."""
    from pygmu2_tpu_torch.core.extent import Extent

    class Stereo(pg.ProcessingElement):
        def __init__(self, source):
            self._source = source

        def inputs(self):
            return [self._source]

        def channel_count(self):
            return 2

        def _compute_extent(self):
            return Extent(None, None)

        def _trace(self, ctx):
            return ctx.pull(self._source).expand(-1, 2)

    return Stereo(source)


def streaming_synth(dev, card) -> dict:
    """Phase 12: the streaming SoundFont synth at the bench's full width
    (the 3 s chord, small font, 128 voices, block 1024) through
    ``Synthesizer.render_midi_schedule``, ``MidiFileSequencer.render`` in
    uneven counts and ``render_midi_offline_hostctl``, then a MeltysynthPE
    fed by a MidiInPE (block 64, 1 s) through ``render_to_array``. Returns
    the kernels' launches on that path."""
    from pathlib import Path

    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import bench_workload
    from pygmu2_tpu_torch.ops import linrec_kernel
    from pygmu2_tpu_torch.soundfont import MidiFileSequencer
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk
    from pygmu2_tpu_torch.soundfont import offline as off
    from pygmu2_tpu_torch.soundfont import synthesizer

    seconds = 3.0
    scan, osc = linrec_kernel.affine_scan_2_kernel, fk.osc_filter_gain_mix
    total = int(round(seconds * SR))

    def schedule(synth, midi):
        return synth.render_midi_schedule(midi, seconds)

    def sequencer(synth, midi):
        seq = MidiFileSequencer(synth)
        seq.play(midi)
        left, right = np.zeros(total, np.float32), np.zeros(total, np.float32)
        at = 0
        for n in (1000, 4096, total - 5096):  # blocks split across calls
            seq.render(left, right, at, n)
            at += n
        return np.stack([left, right], axis=1)

    def hostctl(synth, midi):
        return off.render_midi_offline_hostctl(synth, midi, seconds, device=dev)

    cases = [("render_midi_schedule", schedule, scan),
             ("MidiFileSequencer.render (1000, 4096, rest)", sequencer, scan),
             ("render_midi_offline_hostctl", hostctl, osc)]
    n_blocks = int(np.ceil(seconds * SR / 1024))
    scan.launches = osc.launches = 0  # the main path's run starts here
    outs, per_case = [], []
    for label, render, counter in cases:
        synth, midi = bench_workload.build_workload(False, device=dev)
        before = counter.launches
        outs.append(render(synth, midi))
        per_case.append(counter.launches - before)
    launches = {"affine_scan_2": scan.launches, "osc_filter_gain_mix": osc.launches}
    check(per_case[0] == per_case[1] == n_blocks,
          f"streaming synth: scan launches {per_case[:2]}, expected {n_blocks} a render")
    check(per_case[2] == 1, f"hostctl: {per_case[2]} launches of the SoundFont pass")

    @contextlib.contextmanager
    def plain(counter):
        if counter is scan:
            synthesizer.affine_scan_2_kernel = linrec_kernel.affine_scan_2_chunked_ref
        else:
            fk.osc_filter_gain_mix = fk.osc_filter_gain_mix_ref
        try:
            yield
        finally:
            synthesizer.affine_scan_2_kernel, fk.osc_filter_gain_mix = scan, osc

    synth, midi = bench_workload.build_workload(False, device=dev)
    one_pass = off.render_midi_offline(synth, midi, seconds, device=dev)
    rates = {}
    for (label, render, counter), got, n in zip(cases, outs, per_case):
        check(got.shape == (total, 2) and np.isfinite(got).all() and np.abs(got).max() > 0.1,
              f"{label}: not finite, silent or misshapen {got.shape}")
        synth, midi = bench_workload.build_workload(False, device=dev)
        with plain(counter):
            ref = render(synth, midi)
        err = float(np.abs(got - ref).max())
        check(err <= TOL, f"{label}: kernel render vs plain render {err}")
        vs_offline = float(np.abs(got - one_pass).max())
        check(vs_offline <= TOL, f"{label}: against render_midi_offline {vs_offline}")

        def timed():
            synth, midi = bench_workload.build_workload(False, device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            render(synth, midi)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        timed()  # warm-up
        walls = [timed() for _ in range(3)]
        wall = statistics.median(walls)
        rates[label] = seconds / wall
        print(f"{label}: {n} launches; max abs err vs plain {err:.3g}; vs render_midi_offline "
              f"{vs_offline:.3g}; realtime x{seconds / wall:.2f} wall, median of 3 "
              f"({', '.join(f'{w * 1e3:.1f}' for w in walls)} ms) [{card}]")

    # the block engine's device ops and busy time, one traced render
    traced_render(lambda: functools.partial(schedule, *bench_workload.build_workload(
                      False, device=dev)),
                  n_blocks, card, "render_midi_schedule", {"the scan kernel": ("affine", "scan")})
    t_one = []
    for _ in range(3):
        synth, midi = bench_workload.build_workload(False, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        off.render_midi_offline(synth, midi, seconds, device=dev)
        torch.cuda.synchronize()
        t_one.append(time.perf_counter() - t)
    print(f"render_midi_offline, same score: realtime x{seconds / statistics.median(t_one):.2f} "
          f"wall, median of 3 [{card}]")

    # MeltysynthPE fed by MidiInPE.feed, block 64, 1 s, render_to_array
    font = Path(__file__).resolve().parent / "build" / "smoke" / "bench_small.sf2"
    font.parent.mkdir(parents=True, exist_ok=True)
    font.write_bytes(bench_workload.build_font_bytes(False))
    pg.set_sample_rate(SR)

    def live():
        synth_pe = pg.MeltysynthPE(str(font), block_size=64)
        midi_pe = pg.MidiInPE(port_name=None, callback=lambda start, msg:
                              synth_pe.synthesizer.process_midi_message(*msg))
        graph = pg.CropPE(pg.MixPE(_stereo_pe(pg, midi_pe), synth_pe), 0, SR)
        for key in (48, 52, 55, 60, 64, 67):
            midi_pe.feed((0, 0x90, key, 100))  # drained at the first block
        # render_to_array starts the PEs (the synth exists before the first
        # drain) and renders whole blocks of `block`, the last cropped
        return pg.render_to_array(graph, block=block, device=dev)

    block = 16384
    scan.launches = 0  # the live path's run starts here
    got = live()
    n_live = scan.launches
    launches["affine_scan_2"] += n_live
    check(n_live == -(-SR // block) * block // 64, f"MeltysynthPE: {n_live} scan launches")
    check(got.shape == (SR, 2) and np.isfinite(got).all() and np.abs(got).max() > 0.05,
          f"MeltysynthPE: not finite or silent {got.shape}")
    with plain(scan):
        ref = live()
    err = float(np.abs(got - ref).max())
    check(err <= TOL, f"MeltysynthPE: kernel render vs plain render {err}")
    t = time.perf_counter()  # warmed up by the renders above
    live()
    wall = time.perf_counter() - t
    print(f"MeltysynthPE + MidiInPE, block 64, 1 s, render_to_array: {n_live} scan launches; "
          f"max abs err vs plain {err:.3g}; realtime x{1.0 / wall:.2f} wall [{card}]")
    return launches


STUDIO_S = 60.0
STUDIO_CHECK_S = 0.5  # the whole graph against its plain-follower render
STUDIO_CPU_S = 2.0  # against the port's CPU render
STUDIO_TRACED_BLOCKS = 16  # a traced render's blocks (the profiler slows the host ~7x)


def studio_setup():
    """The studio's files (made with numpy from seed 0) and their readers,
    the FLAC copy decoded; and the seconds that took on the host."""
    from pathlib import Path

    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import studio_workload as sw

    t = time.perf_counter()
    files = sw.make_files(Path(__file__).resolve().parent / "build" / "smoke" / "studio", seed=0)
    readers = sw.readers(pg, files)
    readers["flac"].extent()  # the FLAC copy, decoded once on the host
    return files, readers, time.perf_counter() - t


def traced_render(prepare, n_blocks: int, card: str, label: str, groups: dict) -> None:
    """One render under torch.profiler: device ops a block, busy time and
    idle share, the device time of each of ``groups`` ({label: name
    keys}) and the largest device items by name. ``prepare()``, called
    outside the trace, returns the render's callable. A session that traced
    no device event is run again, up to ``PROFILER_SESSIONS`` in all; where
    none did, the render's device time by CUDA events behind a busy stream
    (an upper bound: it also counts the card waiting on the host after each
    of the render's host syncs)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_events = []
    for attempt in range(PROFILER_SESSIONS):  # sessions may come back empty
        render = prepare()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev_events:
            break
        print(f"{label} traced: session {attempt + 1} traced no device event")
    if not dev_events:
        ms = busy_stream_ms(lambda: prepare()(), reps=1)
        print(f"{label} traced: device ops a block and idle share not measured (no session "
              f"traced a device event); the render's device items by CUDA events behind a busy "
              f"stream: {ms:.3f} ms [{card}]")
        return
    by_name = defaultdict(float)
    for e in dev_events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_name.values())

    def group(keys):
        return sum(v for k, v in by_name.items() if any(key in k.lower() for key in keys))

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label} traced: {len(dev_events)} device ops ({len(dev_events) / n_blocks:.1f} a "
          f"block), device busy {busy:.3f} ms of {wall * 1e3:.1f} ms wall (idle share "
          f"{1 - busy / (wall * 1e3):.3f}); "
          + ", ".join(f"{name} {group(keys):.3f} ms" for name, keys in groups.items())
          + "; largest: " + ", ".join(f"{k[:50]} {v:.3f} ms" for k, v in top) + f" [{card}]")


def studio(dev, card, inputs) -> dict:
    """Phase 13: the studio workload, 60 s through ``render_to_array`` into
    a WavWriterPE; the file, the plain follower, the CPU render, the tape's
    live controls and ``render_functional``. ``inputs`` is what
    :func:`studio_setup` returned. Returns the follower's launches on that
    path."""
    import types
    from pathlib import Path

    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import studio_workload as sw
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.core.extent import Extent
    from pygmu2_tpu_torch.models import envelopes as envelope_pes
    from pygmu2_tpu_torch.ops import envelope
    from pygmu2_tpu_torch.utils import wavio

    t0 = time.perf_counter()
    files, readers, _ = inputs
    follower = envelope.envelope_ar_scan
    total = int(round(STUDIO_S * SR))
    n_blocks = -(-total // BLOCK)
    out_path = str(Path(files["src.wav"]).parent / "out.wav")
    root, parts = sw.build_studio(pg, STUDIO_S, readers, out_path=out_path)
    writer = parts["writer"]
    calls = []

    def recording(x, env0, *, atk, rel):
        """The follower as the main path calls it, each call's inputs,
        carried state and results copied on the card (no host sync)."""
        y, final = follower(x, env0, atk=atk, rel=rel)
        calls.append((x.clone(), env0.clone(), atk, rel, y.clone(), final.clone()))
        return y, final

    follower.launches = 0  # the main path's run starts here
    envelope_pes._envelope = types.SimpleNamespace(envelope_ar_scan=recording)
    try:
        t = time.perf_counter()
        out = pg.render_to_array(root, block=BLOCK, device=dev)
        first_wall = time.perf_counter() - t
    finally:
        envelope_pes._envelope = envelope
    launches = follower.launches
    check(launches == n_blocks, f"studio: {launches} follower launches, expected {n_blocks}")
    peak = float(np.abs(out).max())
    check(out.shape == (total, 2) and np.isfinite(out).all() and peak > 0.05,
          f"studio: not finite, silent or misshapen {out.shape}")
    data, sr = wavio.read_wav(out_path)
    check(writer.frames_written == total and sr == SR and np.array_equal(data, out),
          f"studio: the file ({writer.frames_written} frames) is not the render")
    print(f"studio: {total} frames, {n_blocks} blocks, {launches} follower launches, peak "
          f"{peak:.3g}; the file equals the render bit for bit; first render "
          f"{first_wall * 1e3:.1f} ms [{card}]")

    # every follower launch of the main path against the plain follower on
    # its own inputs and carried state: the launches are independent given
    # those, so one plain loop runs them side by side as channels
    check(len(calls) == launches, f"studio: {len(calls)} follower calls recorded")
    err, plain_s, groups = 0.0, 0.0, {}
    for call in calls:
        groups.setdefault((call[0].shape[0], call[2], call[3]), []).append(call)
    for (_, atk, rel), group in groups.items():
        t = time.perf_counter()
        y, final = envelope.envelope_ar_scan_ref(torch.cat([c[0] for c in group], 1),
                                                 torch.cat([c[1] for c in group]),
                                                 atk=atk, rel=rel)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t
        err = max(err, _err((y, final), (torch.cat([c[4] for c in group], 1),
                                         torch.cat([c[5] for c in group]))))
    check(err <= TOL, f"studio: the main path's follower launches vs plain {err}")
    print(f"studio: all {len(calls)} follower launches of the main path against the plain "
          f"follower on their inputs and carried state: max abs err {err:.3g} (the plain loop "
          f"{plain_s:.1f} s)")

    # the whole graph's first 0.5 s against its render with the plain follower
    plain_graph, _ = sw.build_studio(pg, STUDIO_S, readers)
    head = Extent(0, int(STUDIO_CHECK_S * SR))
    got = pg.render_to_array(plain_graph, extent=head, block=BLOCK, device=dev)
    with plain_versions([(envelope, "envelope_ar_scan")]):
        ref = pg.render_to_array(plain_graph, extent=head, block=BLOCK, device=dev)
    err = float(np.abs(got - ref).max())
    check(err <= TOL, f"studio: first {STUDIO_CHECK_S} s, kernel vs plain {err}")
    print(f"studio: first {STUDIO_CHECK_S} s, kernel vs plain follower max abs err {err:.3g}")

    # the graph at 2 s: the card against the port's CPU render
    short = [sw.build_studio(pg, STUDIO_CPU_S, readers)[0] for _ in range(2)]
    on_card = pg.render_to_array(short[0], block=BLOCK, device=dev)
    t = time.perf_counter()
    on_cpu = pg.render_to_array(short[1], block=BLOCK, device="cpu")
    cpu_s = time.perf_counter() - t
    err = float(np.abs(on_card - on_cpu).max())
    check(on_card.shape == on_cpu.shape and err <= TOL, f"studio at {STUDIO_CPU_S} s: card vs "
          f"CPU {err}")
    print(f"studio at {STUDIO_CPU_S} s: card vs the port's CPU render max abs err {err:.3g} "
          f"(cuFFT against pocketfft; peak {np.abs(on_cpu).max():.3g}; the CPU render "
          f"{cpu_s:.1f} s)")

    # the tape's live controls, block by block through Program.run
    _, live = sw.build_studio(pg, STUDIO_S, readers)
    tape, rate, loop = live["tape"], live["rate"], live["loop"]
    prog = engine.get_program(tape, BLOCK, dev)

    def tape_at(position, value, starts):
        """A second tape over the same loop, from ``position`` at ``value``."""
        ref = pg.TimeWarpPE(loop, rate=pg.ControlPE(value), max_rate=2.0,
                            interpolation=pg.InterpolationMode.CUBIC)
        ref.seek(position)
        ref_prog = engine.get_program(ref, BLOCK, dev)
        return [ref_prog.run(s) for s in starts]

    def sample_at(position):
        return loop.render(int(position), 1, device=dev).data[0]

    blocks = [prog.run(i * BLOCK) for i in range(3)]
    rate.set_value(1.5)  # between blocks 2 and 3
    blocks.append(prog.run(3 * BLOCK))
    before = tape_at(0.0, 1.0, [i * BLOCK for i in range(3)])
    after = tape_at(3.0 * BLOCK, 1.5, [3 * BLOCK])
    check(all(torch.equal(a, b) for a, b in zip(blocks, before + after)),
          "studio: the rate change did not apply from the next block on, or applied before")
    check(tape.position == 3.0 * BLOCK + 1.5 * BLOCK, f"studio: tape at {tape.position}")
    tape.seek(123456.0)
    b = prog.run(4 * BLOCK)
    check(np.array_equal(b[0].cpu().numpy(), sample_at(123456.0))
          and tape.position == 123456.0 + 1.5 * BLOCK, "studio: the seek did not move the tape")
    orig = prog._run

    def render_then_write(start, states, bindings=None):  # lands mid-block
        result = orig(start, states, bindings)
        tape.seek(250000.0)
        rate.set_value(0.75)
        return result

    prog._run = render_then_write
    prog.run(5 * BLOCK)
    prog._run = orig
    check(tape.position == 250000.0 and float(rate._eng_state["user"]) == 0.75,
          "studio: a write landing between a block's render and its scatter was lost")
    b = prog.run(6 * BLOCK)
    check(np.array_equal(b[0].cpu().numpy(), sample_at(250000.0))
          and tape.position == 250000.0 + 0.75 * BLOCK,
          "studio: the block after an in-flight write did not play it")
    print("studio: live controls through Program.run: a rate change from the next block on "
          "and not before, a seek, a write between a block's render and its scatter: all kept")

    # render_functional: no PE state read or written; the blocks of the main
    # path's render, a render_scan from reset state
    functional, _ = sw.build_studio(pg, STUDIO_S, readers)
    pg.render_to_array(functional, extent=Extent(0, 3 * BLOCK), block=BLOCK,
                       device=dev)  # leaves state
    walked = engine._walk(functional)
    held = [pe._eng_state for pe in walked]
    got = engine.render_functional(functional, 0, total, BLOCK, device=dev).cpu().numpy()
    check(all(pe._eng_state is st for pe, st in zip(walked, held)),
          "studio: render_functional touched a PE's state")
    err = float(np.abs(got - out).max())
    check(err == 0.0, f"studio: render_functional vs a fresh render_scan {err}")
    print("studio: render_functional leaves every state as it was and equals the main "
          f"path's render_scan from reset state bit for bit ({time.perf_counter() - t0:.1f} s "
          "into the phase)")

    # realtime: median of 3 after the warm-up (the main path's render)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pg.render_to_array(root, block=BLOCK, device=dev)
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    print(f"studio, {STUDIO_S:g} s stereo into a WAV file: realtime x{STUDIO_S / wall:.2f} wall, median "
          f"of 3 ({', '.join(f'{w * 1e3:.1f}' for w in walls)} ms) [{card}]")
    traced = Extent(0, STUDIO_TRACED_BLOCKS * BLOCK)
    traced_render(lambda: functools.partial(pg.render_to_array, root, extent=traced,
                                            block=BLOCK, device=dev),
                  STUDIO_TRACED_BLOCKS, card, f"studio, its first {STUDIO_TRACED_BLOCKS} blocks,",
                  {"cuFFT": ("fft",), "the follower kernel": ("envelope",),
                   "downloads (the writer's taps and the render)": ("dtoh", "device -> pageable")})
    print(f"studio: phase took {time.perf_counter() - t0:.1f} s")
    return {"envelope_ar_scan": launches}


PERFORM_S = 60.0
PERFORM_CHECK_S = 0.5  # the whole graph against its plain ladder and ADSR render
PERFORM_CPU_S = 1.0  # against the port's CPU render
PERFORM_RENDERER_S = 2.0  # through AudioRenderer into a fake output stream
PERFORM_TRACED_BLOCKS = 16


def perform_cpu_render(seconds: float):
    """The performance's graph at ``seconds`` rendered by the port on the
    CPU (run in a second process)."""
    torch.set_num_threads(2)
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import perform_workload as pw

    t = time.perf_counter()
    out = pg.render_to_array(pw.build_performance(pg, seconds), block=BLOCK, device="cpu")
    return out, time.perf_counter() - t


class _FakeOutputStream:
    """An output stream for AudioRenderer that keeps what it is given."""

    def __init__(self, samplerate, channels, blocksize, device=None, latency=None,
                 dtype="float32", callback=None, finished_callback=None):
        self.channels = channels
        self.writes = []

    def start(self):
        pass

    def write(self, data):
        self.writes.append(np.array(data, copy=True))

    def stop(self):
        pass

    def close(self):
        pass


class _FakeSoundDevice:
    OutputStream = _FakeOutputStream

    class CallbackStop(Exception):
        pass


class _Recorder:
    """Stands for an ops module where a PE module calls it: its wrapper
    ``name`` runs as before (and counts its launches) and each call's
    tensor arguments, keywords and results are kept, copied on the card
    (no host sync); every other attribute is the module's."""

    def __init__(self, mod, name: str):
        self._mod, self.calls = mod, []
        wrapper = getattr(mod, name)

        def record(*args, **kw):
            out = wrapper(*args, **kw)
            self.calls.append(([a.clone() for a in args], kw, [o.clone() for o in out]))
            return out

        setattr(self, name, record)

    def __getattr__(self, attr):
        return getattr(self._mod, attr)


def _launch_groups(calls, join_args, join_out):
    """Recorded calls grouped by length and keywords, each group joined
    into one plain call's arguments and the kernel's results, on the host:
    the launches are independent given their inputs and carried state, so
    a plain loop runs a group's launches side by side as channels."""
    groups = {}
    for args, kw, out in calls:
        groups.setdefault((args[0].shape[0], tuple(sorted(kw.items()))), []).append((args, out))
    for (_, kw), group in groups.items():
        args = [t.cpu() for t in join_args([a for a, _ in group])]
        out = [t.cpu() for t in join_out([o for _, o in group])]
        yield args, dict(kw), out


def _ladder_args(group):
    """(x, al, qa, ki, dsc, state) of ladder launches side by side: each
    launch's channels with its own coefficient columns."""
    def columns(i):
        return torch.cat([a[i][:, None].expand(-1, a[0].shape[1]) for a in group], 1)
    return (torch.cat([a[0] for a in group], 1), *(columns(i) for i in range(1, 5)),
            torch.cat([a[5] for a in group], 1))


def _adsr_args(group):
    """(gate (T, n), state (4, n)) of n ADSR launches side by side."""
    return torch.stack([a[0] for a in group], 1), torch.stack([a[1] for a in group], 1)


def count_syncs(fn) -> int:
    """The synchronizing CUDA operations ``fn`` makes (PyTorch warns on
    each under ``set_sync_debug_mode("warn")``)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def perform(dev, card) -> dict:
    """Phase 14: the generative performance, 60 s of stereo through
    ``render_to_array``; every launch against the plain ladder and ADSR,
    the plain head render, the CPU render, the
    AudioRenderer; realtime, syncs and a trace. Returns the ladder's and
    the ADSR's launches on that path.

    The 1 s CPU render (the plain ladder and ADSR: half a minute of
    per-sample loops) runs in a second process while the card renders and the plain
    versions are checked, and is collected before anything is timed; the
    process is stopped on the way out, whatever happens."""
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        return _perform(dev, card, pool.submit(perform_cpu_render, PERFORM_CPU_S))
    finally:
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


def _perform(dev, card, cpu_job) -> dict:
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import perform_workload as pw
    from pygmu2_tpu_torch.core import audio_renderer
    from pygmu2_tpu_torch.core.extent import Extent
    from pygmu2_tpu_torch.models import envelopes, physical
    from pygmu2_tpu_torch.ops import adsr, ladder

    t0 = time.perf_counter()
    swaps = [(ladder, "ladder_scan"), (adsr, "adsr_scan")]
    counters = {name: getattr(mod, name) for mod, name in swaps}
    total = int(round(PERFORM_S * SR))
    n_blocks = -(-total // BLOCK)
    root = pw.build_performance(pg, PERFORM_S)
    rec_ladder, rec_adsr = _Recorder(ladder, "ladder_scan"), _Recorder(adsr, "adsr_scan")
    for fn in counters.values():
        fn.launches = 0  # the main path's run starts here
    physical._ladder, envelopes._adsr = rec_ladder, rec_adsr
    try:
        t = time.perf_counter()
        out = pg.render_to_array(root, block=BLOCK, device=dev)
        first_wall = time.perf_counter() - t
    finally:
        physical._ladder, envelopes._adsr = ladder, adsr
    launches = {name: fn.launches for name, fn in counters.items()}
    check(launches == {name: n_blocks for name in counters},
          f"performance: launches {launches}, expected {n_blocks} each")
    peak = float(np.abs(out).max())
    check(out.shape == (total, 2) and out.dtype == np.float32 and np.isfinite(out).all()
          and peak > 0.05, f"performance: not finite, silent or misshapen {out.shape}")
    print(f"performance: {total} frames of stereo, {n_blocks} blocks, launches {launches}, "
          f"peak {peak:.3g}; first render {first_wall * 1e3:.1f} ms [{card}]")

    # every ladder and ADSR launch of the main path against the plain
    # versions on its own inputs and carried state, one plain loop a
    # kernel on the host. Under SpatialHRTF the lead restarts every block
    # (ROADMAP queue 3), so each launch here enters from the initial
    # state: the state carried between launches is held by phase 5's
    # hand-offs and phase 6's renders
    n_calls = (len(rec_ladder.calls), len(rec_adsr.calls))
    check(n_calls == (launches["ladder_scan"], launches["adsr_scan"]),
          f"performance: {n_calls} ladder and ADSR calls recorded")
    errs = {"ladder": 0.0, "ADSR": 0.0}
    t = time.perf_counter()
    for args, kw, want in _launch_groups(rec_ladder.calls, _ladder_args,
                                         lambda g: [torch.cat(o, 1) for o in zip(*g)]):
        errs["ladder"] = max(errs["ladder"], _err(ladder.ladder_scan_ref(*args, **kw), want))
    for args, kw, want in _launch_groups(
            rec_adsr.calls, _adsr_args,
            lambda g: [torch.stack(o, o[0].dim()) for o in zip(*g)]):
        errs["ADSR"] = max(errs["ADSR"], _err(adsr.adsr_scan_ref(*args, **kw), want))
    plain_s = time.perf_counter() - t
    rec_ladder.calls.clear()
    rec_adsr.calls.clear()
    check(max(errs.values()) <= TOL, f"performance: the main path's launches vs plain {errs}")
    print(f"performance: all {n_calls[0]} ladder and {n_calls[1]} ADSR launches of the main "
          f"path against the plain versions on their inputs and carried state (on the host, "
          f"each kernel's launches as channels of one plain loop): max abs err ladder "
          f"{errs['ladder']:.3g}, ADSR {errs['ADSR']:.3g} (the plain loops {plain_s:.1f} s)")

    # the first 0.5 s against its render with the plain ladder and ADSR
    # (run on the host, on the card's inputs)
    head = Extent(0, int(PERFORM_CHECK_S * SR))
    got = pg.render_to_array(pw.build_performance(pg, PERFORM_S), extent=head, block=BLOCK,
                             device=dev)
    t = time.perf_counter()
    with plain_versions(swaps, host=True):
        ref = pg.render_to_array(pw.build_performance(pg, PERFORM_S), extent=head,
                                 block=BLOCK, device=dev)
    plain_s = time.perf_counter() - t
    err = float(np.abs(got - ref).max())
    check(err <= TOL and np.abs(ref).max() > 0.05, f"performance: first {PERFORM_CHECK_S} s, "
          f"kernels vs plain {err}")
    print(f"performance: first {PERFORM_CHECK_S} s, kernels vs plain ladder and ADSR (on the "
          f"host) max abs err {err:.3g} (the plain render {plain_s:.1f} s)")

    # the first 2 s through AudioRenderer(blocksize=1024) into a fake
    # stream. It plays in chunks of 16 callbacks, 16384 samples: BLOCK.
    # The lead's restart every block makes the render depend on its block
    # size (ROADMAP queue 3), so this holds at that chunk only
    real_sd = audio_renderer._sd
    audio_renderer._sd = _FakeSoundDevice
    try:
        renderer = pg.AudioRenderer(sample_rate=SR, blocksize=1024, device=dev)
        renderer.set_source(pw.build_performance(pg, PERFORM_RENDERER_S))
        renderer.start()
        streams = []
        orig_output = renderer._output

        def output(snippet):
            orig_output(snippet)
            if renderer._stream is not None and renderer._stream not in streams:
                streams.append(renderer._stream)

        renderer._output = output
        renderer.play_extent()
        renderer.stop()
    finally:
        audio_renderer._sd = real_sd
    played = np.concatenate([w for st in streams for w in st.writes])
    want = pg.render_to_array(pw.build_performance(pg, PERFORM_RENDERER_S), block=BLOCK,
                              device=dev)
    err = float(np.abs(played - want).max()) if played.shape == want.shape else float("inf")
    check(err <= TOL, f"performance: AudioRenderer {played.shape} vs render_to_array {err}")
    print(f"performance: first {PERFORM_RENDERER_S:g} s through AudioRenderer(blocksize=1024) "
          f"on the card, {played.shape[0]} frames written, vs render_to_array max abs err "
          f"{err:.3g}")

    # the graph at 1 s: the card against the port's CPU render
    on_card = pg.render_to_array(pw.build_performance(pg, PERFORM_CPU_S), block=BLOCK,
                                 device=dev)
    t = time.perf_counter()
    on_cpu, cpu_s = cpu_job.result()
    waited = time.perf_counter() - t
    err = float(np.abs(on_card - on_cpu).max()) if on_card.shape == on_cpu.shape else float("inf")
    check(err <= TOL, f"performance at {PERFORM_CPU_S} s: card vs CPU {err}")
    print(f"performance at {PERFORM_CPU_S:g} s: card vs the port's CPU render max abs err "
          f"{err:.3g} (peak {np.abs(on_cpu).max():.3g}; the CPU render {cpu_s:.1f} s in a "
          f"second process, waited {waited:.1f} s for it)")

    # realtime: median of 3 after the warm-up (the main path's render)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pg.render_to_array(root, block=BLOCK, device=dev)
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    print(f"performance, {PERFORM_S:g} s stereo: realtime x{PERFORM_S / wall:.2f} wall, median "
          f"of 3 ({', '.join(f'{w * 1e3:.1f}' for w in walls)} ms) [{card}]")
    traced = Extent(0, PERFORM_TRACED_BLOCKS * BLOCK)
    syncs = count_syncs(lambda: pg.render_to_array(root, extent=traced, block=BLOCK,
                                                   device=dev))
    print(f"performance: {syncs} synchronizing CUDA operations over its first "
          f"{PERFORM_TRACED_BLOCKS} blocks ({syncs / PERFORM_TRACED_BLOCKS:.2f} a block, the "
          f"render's one download included)")
    traced_render(lambda: functools.partial(pg.render_to_array, root, extent=traced,
                                            block=BLOCK, device=dev),
                  PERFORM_TRACED_BLOCKS, card,
                  f"performance, its first {PERFORM_TRACED_BLOCKS} blocks,",
                  {"the ladder kernel": ("ladder",), "the ADSR kernel": ("adsr",),
                   "cuFFT": ("fft",), "copies": ("memcpy",)})
    print(f"performance: phase took {time.perf_counter() - t0:.1f} s")
    return launches


TRAIN_PATCH_S = 10.0  # the fit patch: 27 blocks of BLOCK
TRAIN_PATCH_STEPS = 5
TRAIN_BANK_S = 2.0  # the fit bank: 6 blocks of BLOCK, 128 channels
TRAIN_BANK_STEPS = 3
TRAIN_LR = 0.05
PROBE_THETA = {"cutoff": 1500.0, "fb": 0.6}
PATCH_HIDDEN = {"cutoff": 1100.0, "fb": 0.45}
BANK_START, BANK_HIDDEN = {"low_hz": 1500.0, "band_hz": 800.0}, {"low_hz": 1100.0,
                                                                  "band_hz": 600.0}
FD_EPS = {"cutoff": 2.0, "fb": 1e-3}  # bench.py:_grad_probe's
FD_TOL = 0.1  # relative, bench.py's
CPU_GRAD_TOL = 1e-3  # relative: the card's probe gradients against the CPU's
BWD_TOL = 1e-4  # of the largest plain cotangent of each output
# The backward kernels' bounds count what the gradient needs: each input
#   read once, each output written once, the forward's and the adjoint's
#   operations. What a kernel's design adds (its scratch, the steps it
#   recomputes) is left out of bound_ms and printed as scratch_bytes.
# ladder backward per (sample, channel), os_n = 2: the forward's 82 (the
#   primal values the adjoint reads); two steps' adjoints: four stages 7
#   each, mix 4, tanh 3, feedback 8, input 4: 2 x 47; the decay's 9
#   products and the input's 2: 11. (The kernel re-walks each chunk from
#   its checkpoint twice and walks ten cotangents back through the
#   transfers: not counted.)
LADDER_BWD_OPS = LADDER_OPS + 2 * 47 + 11
# comb backward: per sample the smoother's adjoint 3 (the delays and the
#   windows are the forward's residuals); per (sample, channel) the
#   feedback multiply-add 2, the feedback's part 1, the channel sum 1; the
#   output ring's cotangent added where the ring overlaps the call's
#   samples, 1 per (sample, channel) there
COMB_BWD_OPS_SAMPLE, COMB_BWD_OPS_CHANNEL = 3, 4
# the scan's backward per (sample, channel): the adjoint recurrence (a
#   transposed 2x2 product and the cotangent added) 8, gA's 4 products; a
#   plane shared by the channels summed over them, 1 more each
SCAN_BWD_OPS, SCAN_BWD_OPS_SHARED = 12, 1


# each backward as its wrapper's call, (arguments, results), from what
# diffable.on_backward is given: the forward's arguments, outputs and
# cotangents, and the backward's results
BWD_CALLS = {
    "ladder_scan": ("ladder_scan_bwd", lambda args, outs, grads, got: (
        [*args, grads[0], grads[1], outs[2]], list(got))),
    "comb_scan": ("comb_scan_bwd", lambda args, outs, grads, got: (
        [*args, outs[0], grads[0], grads[1], grads[3], tuple(outs[4:8])],
        [got[i] for i in (0, 1, 2, 3, 5)])),
    "affine_scan_2": ("affine_scan_2_bwd", lambda args, outs, grads, got: (
        [*args, *outs, *grads], list(got))),
    "envelope_ar_scan": ("envelope_ar_scan_bwd", lambda args, outs, grads, got: (
        [args[0], args[1], outs[0], grads[0], grads[1]], list(got))),
    "slew_scan": ("slew_scan_bwd", lambda args, outs, grads, got: (
        [args[0], args[1], outs[0], grads[0], grads[1]], list(got))),
    "reverse_echo_scan": ("reverse_echo_scan_bwd", lambda args, outs, grads, got: (
        [*args[:5], args[7], args[8], outs[0], *grads[:5], tuple(outs[5:8])],
        [got[i] for i in (0, 2, 3, 5, 6, 7, 8)])),
    "ks_scan": ("ks_scan_bwd", lambda args, outs, grads, got: (
        [*args[:4], outs[0], grads[0], grads[1], grads[3], grads[4]],
        [got[i] for i in (0, 2, 4, 5)])),
    "ks_scan (blocked)": ("ks_scan_bwd", lambda args, outs, grads, got: (
        [args[0], None, args[1], args[2], outs[0], grads[0], grads[1], grads[3], grads[4]],
        [got[i] for i in (0, 1, 3, 4)])),
    "adsr_scan": ("adsr_scan_bwd", lambda args, outs, grads, got: (
        [args[0], args[1], outs[0], *grads], [got[1]])),
}


@contextlib.contextmanager
def recording(keep: dict):
    """Records, through ``diffable.on_backward``, copies (on the card) of
    the arguments, keywords and results of the first ``keep[name]`` calls
    of each backward wrapper ``name``; yields {name: [(args, kw, out)]}.
    The hook is cleared on the way out."""
    from pygmu2_tpu_torch.ops import diffable

    calls = {name: [] for name in keep}

    def copy(a):  # a plane shared by the channels stays one column
        if isinstance(a, tuple):  # the comb's and the echo's residuals
            return tuple(copy(v) for v in a)
        if not isinstance(a, torch.Tensor):
            return a
        if a.dim() == 2 and a.shape[1] > 1 and a.stride(1) == 0:
            return a[:, :1].clone().expand(a.shape)
        return a.clone()

    def hook(fwd_name, args, outs, grads, kw, got):
        name, as_call = BWD_CALLS[fwd_name]
        if len(calls.get(name, ())) < keep.get(name, 0):
            bargs, bout = as_call(args, outs, grads, got)
            calls[name].append(([copy(a) for a in bargs], kw, [copy(o) for o in bout]))

    diffable.on_backward = hook
    try:
        yield calls
    finally:
        diffable.on_backward = None


def training_cpu_probe():
    """The probe's loss and gradients through the port's plain versions on
    the CPU (run in a second process)."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch.core import engine

    t = time.perf_counter()
    graph = fw.build_probe(pg)
    theta = {k: torch.tensor(v, requires_grad=True) for k, v in PROBE_THETA.items()}
    out = engine.render_functional(graph, 0, fw.PROBE_N, fw.PROBE_BLOCK, theta, device="cpu")
    loss = torch.mean(out ** 2)
    grads = torch.autograd.grad(loss, list(theta.values()))
    return (loss.item(), {k: g.item() for k, g in zip(theta, grads)},
            time.perf_counter() - t)


def _bwd_errors(got, want):
    """[(max abs difference, max |plain|)] per output."""
    return [(float((torch.as_tensor(g).float() - w.float()).abs().max()),
             float(w.float().abs().max())) for g, w in zip(got, want)]


def plain_backward_on_host(kind: str, args, kw, got):
    """A backward launch's results (numpy) against autograd of the plain
    version on its recorded arguments (numpy), on the CPU (run in a
    second process): per output (max abs difference, max |plain|)."""
    from pygmu2_tpu_torch.ops import comb, ladder

    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    ref = ladder.ladder_scan_bwd_ref if kind == "ladder" else comb.comb_scan_bwd_ref
    t = time.perf_counter()
    want = ref(*args, **kw)
    return _bwd_errors([torch.from_numpy(g) for g in got], want), time.perf_counter() - t


def _host(calls):
    """A recorded call's tensors as numpy arrays (for a second process)."""
    args, kw, out = calls[0]

    def to_np(v):
        if isinstance(v, tuple):
            return tuple(to_np(a) for a in v)
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

    return [to_np(a) for a in args], kw, [to_np(o) for o in out]


def _check_bwd(name, errs, what, tol=BWD_TOL):
    """Each output's error within ``tol`` of its largest plain cotangent;
    returns the largest error."""
    for i, (err, scale) in enumerate(errs):
        check(err <= tol * scale, f"{name} {what}: output {i} differs from its plain "
              f"version by {err} (largest plain {scale})")
    return max(err for err, _ in errs)


def order_checks(bwd, rec_l, rec_c, what):
    """Recorded backward launches of the ladder and the comb against their
    kernels' order in torch ops on the card (``ladder_scan_bwd_chunked``,
    ``comb_scan_bwd_windows``): the comb's bit for bit, the ladder's within
    BWD_TOL of its largest cotangent with its largest difference printed;
    and each launched again on the same inputs: the same bits."""
    from pygmu2_tpu_torch.ops import comb, ladder

    t = time.perf_counter()
    worst, equal = {}, {}
    for key, calls, order in (("ladder", rec_l, ladder.ladder_scan_bwd_chunked),
                              ("comb", rec_c, comb.comb_scan_bwd_windows)):
        worst[key], equal[key] = 0.0, True
        for j, (args, kw, got) in enumerate(calls):
            want = order(*args, **kw)
            again = bwd[key](*args, **kw)
            for i, (g, a, w) in enumerate(zip(got, again, want)):
                w = w.reshape(g.shape)
                check(torch.equal(g, a), f"{key} backward, {what} launch {j}: output {i} "
                      "differs between two launches")
                err, scale = float((g - w).abs().max()), float(w.abs().max())
                worst[key] = max(worst[key], err)
                equal[key] &= torch.equal(g, w)
                if key == "comb":
                    check(err == 0.0, f"comb backward, {what} launch {j}: output {i} differs "
                          f"from comb_scan_bwd_windows by {err}")
                else:
                    check(err <= BWD_TOL * scale, f"ladder backward, {what} launch {j}: output "
                          f"{i} differs from ladder_scan_bwd_chunked by {err} (largest {scale})")
    print(f"{what}: {len(rec_l)} ladder and {len(rec_c)} comb backward launches against their "
          f"kernels' order in torch ops on the card ({time.perf_counter() - t:.1f} s): ladder "
          f"max abs diff {worst['ladder']:.3g} (bit for bit: {equal['ladder']}), comb "
          f"{worst['comb']:.3g} (bit for bit: {equal['comb']}); a second launch of each the "
          f"same bits")


def training(dev, card) -> list:
    """Phase 15: the training path, ``torch.autograd`` through
    ``render_functional`` with ParamPE bindings on the card; returns the
    three backward kernels' JSON entries. Host work (the probe on the CPU,
    the plain backward versions of two T = 16384 launches) runs in two
    more processes while the card works; they are stopped on the way out,
    whatever happens."""
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    try:
        return _training(dev, card, pool)
    finally:
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


def _training(dev, card, pool) -> list:
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import comb, envelope, ladder, linrec_kernel

    t0 = time.perf_counter()
    cpu_job = pool.submit(training_cpu_probe)
    fwd = {"ladder": ladder.ladder_scan, "comb": comb.comb_scan,
           "scan": linrec_kernel.affine_scan_2_kernel}
    bwd = {"ladder": ladder.ladder_scan_bwd, "comb": comb.comb_scan_bwd,
           "scan": linrec_kernel.affine_scan_2_bwd}

    def counts(fns):
        return {k: f.launches for k, f in fns.items()}

    def zero():
        for f in (*fwd.values(), *bwd.values()):
            f.launches = 0

    def theta_on(values, grad):
        return {k: torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=grad)
                for k, v in values.items()}

    total = {"ladder": 0, "comb": 0, "scan": 0}  # backward launches on the path

    # ---- (a) the probe: gradients, finite differences, the CPU's ----
    probe = fw.build_probe(pg)

    def probe_loss(theta):
        out = engine.render_functional(probe, 0, fw.PROBE_N, fw.PROBE_BLOCK, theta, device=dev)
        return torch.mean(out ** 2)

    zero()  # the main path's run starts here
    with recording({"ladder_scan_bwd": 8, "comb_scan_bwd": 8}) as rec:
        theta = theta_on(PROBE_THETA, True)
        loss = probe_loss(theta)
        grads = dict(zip(theta, torch.autograd.grad(loss, list(theta.values()))))
        torch.cuda.synchronize()
    n_fwd, n_bwd = counts(fwd), counts(bwd)
    rec_l, rec_c = rec["ladder_scan_bwd"], rec["comb_scan_bwd"]
    n_blocks = fw.PROBE_N // fw.PROBE_BLOCK
    check(n_fwd["ladder"] == n_fwd["comb"] == n_bwd["ladder"] == n_bwd["comb"] == n_blocks
          and n_bwd["scan"] == 0,
          f"probe: launches forward {n_fwd}, backward {n_bwd}, expected {n_blocks} each")
    for k in total:
        total[k] += n_bwd[k]
    res = {"loss": loss.item()}
    with torch.no_grad():
        for k, eps in FD_EPS.items():
            lo, hi = (torch.tensor(PROBE_THETA[k], dtype=torch.float32) + s * eps
                      for s in (-1.0, 1.0))
            fd = ((probe_loss(theta_on({**PROBE_THETA, k: float(hi)}, False))
                   - probe_loss(theta_on({**PROBE_THETA, k: float(lo)}, False)))
                  / float(hi - lo)).item()
            g = grads[k].item()
            rel = abs(g - fd) / max(abs(fd), 1e-9)
            check(np.isfinite(g) and rel < FD_TOL, f"probe: grad_{k} {g} vs fd {fd} (rel {rel})")
            res.update({f"grad_{k}": g, f"fd_{k}": fd, f"rel_err_{k}": rel})
    print(f"training probe (n={fw.PROBE_N}, block {fw.PROBE_BLOCK}, launches forward "
          f"{n_fwd}, backward {n_bwd}): {json.dumps(res)} [{card}]")

    # every backward launch of the probe against autograd of the plain
    # version on its own recorded inputs and cotangents: the ladder's side
    # by side as channels of one plain loop on the host, the comb's one by one
    errs = {"ladder_scan_bwd": 0.0, "comb_scan_bwd": 0.0}
    t = time.perf_counter()
    ladder_kw = rec_l[0][1]
    args = [[a.cpu() for a in call[0]] for call in rec_l]
    widths = [a[0].shape[1] for a in args]
    joined = [torch.cat([a[i] for a in args], 1) for i in (0,)]
    cols = [torch.cat([a[i][:, None].expand(-1, w) for a, w in zip(args, widths)], 1)
            for i in range(1, 5)]
    rest = [torch.cat([a[i] for a in args], 1) for i in (5, 6, 7)]
    want = ladder.ladder_scan_bwd_ref(*joined, *cols, *rest, **ladder_kw)
    for j, (_, _, got) in enumerate(rec_l):
        lo = sum(widths[:j])
        sl = slice(lo, lo + widths[j])
        per = [want[0][:, sl], *(w[:, sl].sum(1) for w in want[1:5]), want[5][:, sl]]
        errs["ladder_scan_bwd"] = max(errs["ladder_scan_bwd"], _check_bwd(
            "ladder_scan_bwd", _bwd_errors([g.cpu() for g in got], per), f"probe launch {j}"))
    for j, (cargs, kw, got) in enumerate(rec_c):
        want = comb.comb_scan_bwd_ref(*(a.cpu() for a in cargs[:10]), **kw)
        errs["comb_scan_bwd"] = max(errs["comb_scan_bwd"], _check_bwd(
            "comb_scan_bwd", _bwd_errors([g.cpu() for g in got], want), f"probe launch {j}"))
    print(f"training probe: all {len(rec_l)} ladder and {len(rec_c)} comb backward launches "
          f"against autograd of the plain versions on their inputs and cotangents (host, "
          f"{time.perf_counter() - t:.1f} s): max abs err ladder "
          f"{errs['ladder_scan_bwd']:.3g}, comb {errs['comb_scan_bwd']:.3g}")
    probe_calls = {"ladder_scan_bwd": rec_l[0], "comb_scan_bwd": rec_c[0]}
    order_checks(bwd, rec_l, rec_c, "probe")
    # the forward with checkpoints against the forward without, and the
    # checkpoints against the plain forward's entering states
    fwd_args, fwd_kw = rec_l[0][0][:6], rec_l[0][1]
    y0, s0 = ladder.ladder_scan(*fwd_args, **fwd_kw)
    y1, s1, ckpt = ladder._launch(*fwd_args, **fwd_kw, checkpoints=True)  # as recorded
    check(torch.equal(y0, y1) and torch.equal(s0, s1),
          "ladder forward: y or the state differ with checkpoints")
    check(torch.equal(ckpt, rec_l[0][0][8]), "ladder forward: checkpoints differ from the "
          "recorded launch's")
    check(torch.equal(ckpt, ladder.ladder_checkpoints_ref(*fwd_args, **fwd_kw)),
          "ladder forward: checkpoints differ from the plain forward's entering states")
    print(f"ladder forward (T={fwd_args[0].shape[0]}): y and the state bit for bit with and "
          f"without checkpoints; the checkpoints ({tuple(ckpt.shape)}) bit for bit with the "
          f"recorded launch's and the plain forward's entering states")

    # ---- (b) the fit patch and (c) the fit bank, by Adam ----
    def fit_run(label, graph, seconds, start, hidden, steps, keep):
        n = int(round(seconds * SR))
        with torch.no_grad():
            target = engine.render_functional(graph, 0, n, BLOCK, hidden, device=dev)
        rows, mark = [], {}

        def begin():
            zero()
            torch.cuda.reset_peak_memory_stats()
            mark["event"] = torch.cuda.Event(enable_timing=True)
            mark["event"].record()
            mark["t"] = time.perf_counter()

        def on_step(step, loss, values):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            v = float(loss)  # waits for the card
            wall = time.perf_counter() - mark["t"]
            end.synchronize()
            rows.append((step, v, wall, mark["event"].elapsed_time(end), counts(fwd),
                         counts(bwd), torch.cuda.max_memory_allocated() / 2**20,
                         {k: float(x) for k, x in values.items()}))
            begin()

        with recording(keep) as recs:
            begin()
            losses, fitted = fw.fit(graph, target, start, steps, TRAIN_LR, block=BLOCK,
                                    device=dev, on_step=on_step)
        for step, v, wall, span, nf, nb, peak, vals in rows:
            print(f"{label} step {step}: loss {v:.6g}, wall {wall * 1e3:.1f} ms, device span "
                  f"(CUDA events) {span:.1f} ms, launches forward {nf} backward {nb}, peak "
                  f"memory {peak:.0f} MiB, then {json.dumps(vals)} [{card}]")
        check(losses[-1] < losses[0], f"{label}: the loss did not fall {losses}")
        print(f"{label}: loss {losses[0]:.6g} -> {losses[-1]:.6g} in {steps} Adam steps (lr "
              f"{TRAIN_LR}), fitted {json.dumps(fitted)}, hidden {json.dumps(hidden)}")
        return rows, recs

    n_patch = -(-int(round(TRAIN_PATCH_S * SR)) // BLOCK)
    rows, recs = fit_run("fit patch", fw.build_fit_patch(pg, TRAIN_PATCH_S), TRAIN_PATCH_S,
                         PROBE_THETA, PATCH_HIDDEN, TRAIN_PATCH_STEPS,
                         {"ladder_scan_bwd": 1, "comb_scan_bwd": 1})
    for step, *_, nf, nb, _, _ in rows:
        check(nf["ladder"] == nf["comb"] == nb["ladder"] == nb["comb"] == n_patch
              and nb["scan"] == 0,
              f"fit patch step {step}: launches forward {nf} backward {nb}, expected {n_patch}")
        total["ladder"] += nb["ladder"]
        total["comb"] += nb["comb"]
    patch_calls = {name: calls[0] for name, calls in recs.items()}
    order_checks(bwd, recs["ladder_scan_bwd"], recs["comb_scan_bwd"], "fit patch")
    host_jobs = {name: pool.submit(plain_backward_on_host, name.split("_")[0],
                                   *_host(calls))
                 for name, calls in recs.items()}

    n_bank = -(-int(round(TRAIN_BANK_S * SR)) // BLOCK)
    rows, recs = fit_run("fit bank", fw.build_fit_bank(pg, TRAIN_BANK_S), TRAIN_BANK_S,
                         BANK_START, BANK_HIDDEN, TRAIN_BANK_STEPS,
                         {"affine_scan_2_bwd": 2 * n_bank})  # the first step's
    for step, *_, nf, nb, _, _ in rows:
        check(nf["scan"] == nb["scan"] == 2 * n_bank,
              f"fit bank step {step}: scan launches forward {nf} backward {nb}, expected "
              f"{2 * n_bank}")
        total["scan"] += nb["scan"]
    bank_call = recs["affine_scan_2_bwd"][0]
    sargs, skw, sgot = bank_call
    want = linrec_kernel.affine_scan_2_bwd_ref(*sargs, **skw)
    pairs = [(g, w.sum_to_size(g.shape)) for g, w in zip(sgot, want) if g is not None]
    errs["affine_scan_2_bwd"] = _check_bwd(
        "affine_scan_2_bwd", _bwd_errors(*zip(*pairs)),
        f"fit bank launch (T={sargs[4].shape[0]} C={sargs[4].shape[1]})")
    print(f"fit bank: a backward scan launch at T={sargs[4].shape[0]}, C={sargs[4].shape[1]} "
          f"against autograd of the plain chunked scan on the card: max abs err "
          f"{errs['affine_scan_2_bwd']:.3g}")
    # every recorded launch of the first step bit for bit with the plain
    # version's order on the card, and launched again: the same bits
    t = time.perf_counter()
    for j, (args, kw, got) in enumerate(recs["affine_scan_2_bwd"]):
        want = linrec_kernel.affine_scan_2_bwd_plain(*args, **kw)
        n = linrec_kernel.affine_scan_2_bwd.launches
        again = bwd["scan"](*args, **kw)
        linrec_kernel.affine_scan_2_bwd.launches = n  # a comparison's: not the path's
        for i, (g, a, w) in enumerate(zip(got, again, want)):
            if w is None:
                check(g is None and a is None, f"scan backward, fit bank launch {j}: output "
                      f"{i} is not None")
                continue
            check(torch.equal(g, a), f"scan backward, fit bank launch {j}: output {i} differs "
                  "between two launches")
            check(g.shape == w.shape and torch.equal(g, w), f"scan backward, fit bank launch "
                  f"{j}: output {i} differs from affine_scan_2_bwd_plain by "
                  f"{float((g - w).abs().max()) if g.shape == w.shape else 'shape'}")
    print(f"fit bank: all {len(recs['affine_scan_2_bwd'])} backward scan launches of the first "
          f"step bit for bit with affine_scan_2_bwd_plain on the card "
          f"({time.perf_counter() - t:.1f} s); a second launch of each the same bits")

    # ---- times: each backward kernel at its shapes, beside its plain version ----
    times = {}
    for name, fn, ref in (("ladder_scan_bwd", bwd["ladder"], ladder.ladder_scan_bwd_ref),
                          ("comb_scan_bwd", bwd["comb"], comb.comb_scan_bwd_ref)):
        pargs, pkw, _ = probe_calls[name]
        fargs, fkw, _ = patch_calls[name]
        _, plain = timed_plain(lambda: ref(*pargs, **pkw))
        times[name] = (device_ms(lambda: fn(*pargs, **pkw), 10), plain,
                       device_ms(lambda: fn(*fargs, **fkw), 10))
    # the comb at the fit patch's T and 128 channels (the channel tiling):
    # seeded rows on the patch's control residuals
    fargs, fkw, _ = patch_calls["comb_scan_bwd"]
    T, L = fargs[0].shape[0], fargs[3].shape[0]
    x, buf, y, gy, gbuf = _seeded(dev, 16, (T, 128), (L, 128), (T, 128), (T, 128), (L, 128))
    wide = [x, fargs[1], fargs[2], buf, fargs[4], fargs[5], y, gy, gbuf, *fargs[9:]]
    comb_wide_ms = device_ms(lambda: bwd["comb"](*wide, **fkw), 10)
    # each launch of a call alone (torch.profiler's device events): a call
    # at the probe's T is short enough that CUDA events count the host too
    splits = {}
    for name in ("ladder_scan_bwd", "comb_scan_bwd"):
        for label, (a, k, _) in (("probe", probe_calls[name]), ("patch", patch_calls[name])):
            splits[name, label] = launch_split(
                lambda fn=bwd[name.split("_")[0]], a=a, k=k: fn(*a, **k),
                key=name.split("_")[0] + "_bwd")
    splits["comb_scan_bwd", "wide"] = launch_split(lambda: bwd["comb"](*wide, **fkw),
                                                   key="comb_bwd")
    # the forward ladder at the fit patch's T, with and without checkpoints
    largs, lkw, _ = patch_calls["ladder_scan_bwd"]
    fwd_ms = {False: [], True: []}  # in turns: without, with, without, with
    for mode in (False, True, False, True):
        fwd_ms[mode].append(device_ms(
            lambda: ladder._launch(*largs[:6], **lkw, checkpoints=mode), 10))
    # the checkpoint interval K: the chosen one against twice it, at the fit
    # patch's T (each launch alone, summed)
    by_k = {}
    for K in (ladder.CHECKPOINT_EVERY, 2 * ladder.CHECKPOINT_EVERY):
        ck = ladder._launch(*largs[:6], **lkw, checkpoints=True, every=K)[2]
        by_k[K] = sum(launch_split(
            lambda: ladder._launch_bwd(*largs[:5], ck, *largs[6:8], **lkw, every=K),
            key="ladder_bwd").values())
    _, plain = timed_plain(lambda: linrec_kernel.affine_scan_2_bwd_ref(*sargs, **skw))
    # alone: the adjoint and the channel sums (the call's memset left out)
    scan_items = launch_split(lambda: bwd["scan"](*sargs, **skw), key="affine_scan_2")
    times["affine_scan_2_bwd"] = (device_ms(lambda: bwd["scan"](*sargs, **skw), 10), plain,
                                  sum(v for k, v in scan_items.items()
                                      if "affine_scan_2" in k or "channel_sum" in k))

    # ---- the host's results ----
    for name, job in host_jobs.items():
        got, secs = job.result()
        T = patch_calls[name][0][0].shape[0]
        errs[name] = max(errs[name], _check_bwd(name, got, f"fit patch launch (T={T})"))
        print(f"fit patch: a {name} launch at T={T} against autograd of the plain version on "
              f"the host ({secs:.1f} s): max abs err {max(e for e, _ in got):.3g} (largest "
              f"plain cotangent {max(s for _, s in got):.3g})")
    cpu_loss, cpu_grads, cpu_s = cpu_job.result()
    for k, g in cpu_grads.items():
        rel = abs(grads[k].item() - g) / abs(g)
        check(rel <= CPU_GRAD_TOL, f"probe: grad_{k} on the card {grads[k].item()} vs the "
              f"CPU's {g} (rel {rel})")
    print(f"training probe on the CPU (plain versions, {cpu_s:.1f} s in a second process): "
          f"loss {cpu_loss:.6g}, grads {json.dumps(cpu_grads)}; the card's within "
          f"{CPU_GRAD_TOL} relative")

    # ---- the kernels line's entries ----
    entries = []
    pT, pC = probe_calls["ladder_scan_bwd"][0][0].shape
    fT = patch_calls["ladder_scan_bwd"][0][0].shape[0]
    L = patch_calls["comb_scan_bwd"][0][3].shape[0]

    def ladder_bound(T, C):
        # the function's data alone: x, gy, gx; the four columns and their
        # cotangents; the state in, its cotangent in and out. Scratch: the
        # design's own, each written and read: the checkpoints (9 a
        # channel every K samples), the chunks' transfers (96 a chunk and
        # channel) and the cotangents leaving them (9), the columns'
        # per-channel parts (4 a sample and channel)
        n = -(-T // ladder.CHECKPOINT_EVERY)
        return (bound(4 * (3 * T * C + 8 * T + 27 * C), LADDER_BWD_OPS * T * C),
                4 * 2 * (9 * n * C + (n - 1) * (96 + 9) * C + 4 * T * C))

    def comb_bound(T, C):
        # the function's data alone: y, gy, gx; the ring in, its cotangents
        # out and in; freq, fb and their cotangents. Scratch: the design's
        # own, each written and read: the forward's delays, window bounds
        # and count and smoothed values, the feedback's per-channel parts
        # (the tape's cotangent stays in shared memory); the smoother's
        # adjoint's chunk maps, written and read, and its flags
        chunks = -(-T // envelope.GRID_ROWS)
        return (bound(4 * (3 * T * C + 3 * L * C + 4 * T),
                      COMB_BWD_OPS_SAMPLE * T + COMB_BWD_OPS_CHANNEL * T * C + min(L, T) * C),
                4 * 2 * (3 * T + 2 + T * C) + 4 * 2 * 2 * chunks + 4 * (1 + chunks))

    sT, sC = sargs[4].shape
    shared = [a.dim() == 2 and (a.shape[1] == 1 or a.stride(1) == 0) for a in sargs[:4]]
    n_planes = sum(sT if sh else sT * sC for sh in shared)
    # the matrix planes and their cotangents, s1, s2, g1, g2, the state in
    # and its cotangent, gu (u is not read). Scratch: the design's own, each
    # written and read: the tiles' sums of the (T, 1) columns' cotangents
    # (the six planes' columns, tiles of 8 channels where the four matrices
    # are shared, else 4) and the chunks' last rows; the flags
    n_cols = sum(a.dim() == 2 and a.shape[1] == 1 for a in sargs[:6])
    s_tiles = -(-sC // linrec_kernel.tile_width(all(shared)))
    s_chunks = -(-sT // skw["chunk"])
    scan_bound = (bound(4 * (2 * n_planes + 6 * sT * sC + 4 * sC),
                        (SCAN_BWD_OPS + SCAN_BWD_OPS_SHARED * sum(shared)) * sT * sC),
                  4 * 2 * (n_cols * sT * s_tiles + 6 * s_chunks * sC)
                  + 4 * (1 + s_chunks * sC))
    for key, name, source, replaces, bnd, bnd_patch in (
            ("ladder", "ladder_scan_bwd", "pygmu2_tpu_torch/csrc/ladder_scan_bwd.cu",
             "pygmu2_tpu/ops/ladder_pallas.py:253", ladder_bound(pT, pC), ladder_bound(fT, 1)),
            ("comb", "comb_scan_bwd", "pygmu2_tpu_torch/csrc/comb_scan_bwd.cu",
             "pygmu2_tpu/ops/comb_pallas.py:185", comb_bound(pT, pC), comb_bound(fT, 1)),
            ("scan", "affine_scan_2_bwd", "pygmu2_tpu_torch/csrc/affine_scan_2.cu",
             "pygmu2_tpu/ops/linrec_pallas.py:95", scan_bound, None)):
        ms, plain, third = times[name]
        bnd, scratch = bnd
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": total[key], "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                 "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                 "scratch_bytes": scratch}
        if bnd_patch is None:
            entry.update(shape=f"T={sT} C={sC}, the fit bank's", kernel_ms=third,
                         launches_alone_ms={k[:48]: v for k, v in scan_items.items()},
                         header="pygmu2_tpu_torch/csrc/channel_sum.cuh")
        else:
            entry.update(kernel_ms=sum(splits[name, "probe"].values()),
                         kernel_ms_patch=sum(splits[name, "patch"].values()))
            for label in ("probe", "patch", "wide"):
                if (name, label) in splits:
                    print(f"{name} ({label}): each launch alone, ms a call: " + ", ".join(
                        f"{k[:48]} {v:.4f}" for k, v in splits[name, label].items()))
        if key == "comb":
            wide_bnd, wide_scratch = comb_bound(fT, 128)
            entry.update(ms_wide=comb_wide_ms, bound_ms_wide=wide_bnd[0],
                         scratch_bytes_wide=wide_scratch,
                         kernel_ms_wide=sum(splits[name, "wide"].values()),
                         shape_wide=f"T={fT} C=128, seeded rows on the fit patch's controls")
        elif key == "ladder":
            entry.update(forward_ms=fwd_ms[False], forward_ms_checkpoints=fwd_ms[True],
                         kernel_ms_patch_by_checkpoint_interval=by_k)
        if bnd_patch is not None:
            bnd_patch, scratch_patch = bnd_patch
            entry.update(shape=f"T={pT} C={pC}, the probe's", ms_patch=third,
                         bound_ms_patch=bnd_patch[0], scratch_bytes_patch=scratch_patch,
                         shape_patch=f"T={fT} C=1, the fit patch's")
        entries.append(entry)
        print(f"{name} ({entry['shape']}): kernel {ms:.4f} ms, bound {bnd[0]:.4g} ms "
              f"({bnd[1]}; the design's scratch {scratch} bytes more), plain (autograd) "
              f"{plain:.1f} ms"
              + (f"; at {entry['shape_patch']}: {third:.4f} ms, bound {bnd_patch[0]:.4g} ms "
                 f"(scratch {scratch_patch} bytes)"
                 if bnd_patch else f"; its launches alone {third:.4f} ms (" + ", ".join(
                     f"{k[:48]} {v:.4f}" for k, v in scan_items.items()) + ")")
              + f"; {entry['launches']} launches on the training path [{card}]")
    print(f"comb_scan_bwd at T={fT} C=128: kernel {comb_wide_ms:.4f} ms [{card}]")
    print(f"ladder_scan forward at T={fT} C=1, in turns: without checkpoints "
          f"{', '.join(f'{v:.4f}' for v in fwd_ms[False])} ms, with "
          f"{', '.join(f'{v:.4f}' for v in fwd_ms[True])} ms [{card}]")
    print(f"ladder_scan_bwd at T={fT} C=1 by checkpoint interval, launches alone: " + ", ".join(
        f"K={k} {v:.4f} ms" for k, v in by_k.items()) + f" [{card}]")
    print(f"training: phase took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- 16. training through the effects chain ----

CHAIN_N, CHAIN_BLOCK = 4096, 1024  # the chain's gradient check (the probe's size)
CHAIN_FB_S = 0.8  # the feedback check: past two echo blocks (0.6 s)
TRAIN_CHAIN_S = 10.0  # the fit chain: 27 blocks of BLOCK, mono
TRAIN_CHAIN_STEPS = 5
TRAIN_FXBANK_S = 2.0  # the fit fx bank: 6 blocks of BLOCK, 128 channels
TRAIN_FXBANK_STEPS = 3
CHAIN_THETA = {"depth": 2500.0, "fb": 0.6}
CHAIN_HIDDEN = {"depth": 1800.0, "fb": 0.45}
FXBANK_THETA, FXBANK_HIDDEN = {"drive": 1.0, "fb": 0.6}, {"drive": 0.7, "fb": 0.45}
CHAIN_FD_EPS = {"depth": 25.0, "fb": 1e-2}
ADSR_THETA = {"g": 1.0}
EFFECTS_BWD_TOL = 1e-5  # of the largest plain cotangent of each output
# Operations of the effects' backward kernels, counted from their
# arithmetic as the forward's: the follower per (sample, channel): the
# compare and 1 - c (the coefficients recomputed), the adjoint's add and
# multiply, gx's multiply: 5; the slew limiter per sample: the error, the
# compares or the select, 1 - k, add, multiply, multiply: 7; the echo per
# sample (shared) ECHO_OPS_SAMPLE and the ratio's reverse sum 1 (the control
# pass's operations, counted as when the backward ran that pass again; it
# reads the forward's control results now: the bound is kept so the rows
# compare), per
# (sample, channel) the rings' cotangents 4, the four taps' 8, the read
# position's 12, the feedback's and the channel sums 3: 27; the ADSR per
# sample walked: the edge test 4, the candidate and its compare 3, the two
# weighted sums 3: 10
ENV_BWD_OPS, SLEW_BWD_OPS = 5, 7
ECHO_BWD_OPS_SAMPLE, ECHO_BWD_OPS_CHANNEL = ECHO_OPS_SAMPLE + 1, 27
ADSR_BWD_OPS = 10
EFFECTS_BWD = {  # backward wrapper: (source, the JAX custom VJP it replaces, a part of
    # the names of its own kernels on the card)
    "envelope_ar_scan_bwd": ("pygmu2_tpu_torch/csrc/envelope_ar_scan_bwd.cu",
                             "pygmu2_tpu/ops/envelope_pallas.py:134", "adjoint"),
    "slew_scan_bwd": ("pygmu2_tpu_torch/csrc/slew_scan_bwd.cu",
                      "pygmu2_tpu/ops/slew_pallas.py:145", "adjoint"),
    "reverse_echo_scan_bwd": ("pygmu2_tpu_torch/csrc/reverse_echo_scan_bwd.cu",
                              "pygmu2_tpu/ops/reverse_echo_pallas.py:406", "echo"),
    "adsr_scan_bwd": ("pygmu2_tpu_torch/csrc/adsr_scan_bwd.cu",
                      "pygmu2_tpu/ops/adsr_pallas.py:313", "adsr_bwd"),
}


def chain_cpu_grads():
    """The fit chain's loss and gradients at CHAIN_N samples through the
    port's plain versions on the CPU (run in a second process)."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch.core import engine

    t = time.perf_counter()
    graph = fw.build_fit_chain(pg, CHAIN_N / SR)
    theta = {k: torch.tensor(v, requires_grad=True) for k, v in CHAIN_THETA.items()}
    out = engine.render_functional(graph, 0, CHAIN_N, CHAIN_BLOCK, theta, device="cpu")
    loss = torch.mean(out ** 2)
    grads = torch.autograd.grad(loss, list(theta.values()), allow_unused=True,
                                materialize_grads=True)
    probe = fw.build_adsr_probe(pg, CHAIN_N)
    g = {k: torch.tensor(v, requires_grad=True) for k, v in ADSR_THETA.items()}
    out = engine.render_functional(probe, 0, CHAIN_N, CHAIN_BLOCK, g, device="cpu")
    (ga,) = torch.autograd.grad(torch.mean(out ** 2), list(g.values()), allow_unused=True,
                                materialize_grads=True)
    return (loss.item(), {k: v.item() for k, v in zip(theta, grads)}, ga.item(),
            time.perf_counter() - t)


def training_chain(dev, card) -> list:
    """Phase 16: training through the effects chain, ``torch.autograd`` of
    ``render_functional`` through the follower's, the slew limiter's, the
    echo's and the ADSR's backward kernels; returns their JSON entries.
    The CPU's gradients are made in a second process while the card works;
    it is stopped on the way out, whatever happens."""
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        return _training_chain(dev, card, pool)
    finally:
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


def _training_chain(dev, card, pool) -> list:
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import adsr, envelope, reverse_echo, slew

    t0 = time.perf_counter()
    cpu_job = pool.submit(chain_cpu_grads)
    fwd = {"envelope": envelope.envelope_ar_scan, "slew": slew.slew_scan,
           "echo": reverse_echo.reverse_echo_scan, "adsr": adsr.adsr_scan}
    bwd = {"envelope_ar_scan_bwd": envelope.envelope_ar_scan_bwd,
           "slew_scan_bwd": slew.slew_scan_bwd,
           "reverse_echo_scan_bwd": reverse_echo.reverse_echo_scan_bwd,
           "adsr_scan_bwd": adsr.adsr_scan_bwd}
    refs = {"envelope_ar_scan_bwd": envelope.envelope_ar_scan_bwd_ref,
            "slew_scan_bwd": slew.slew_scan_bwd_ref,
            "reverse_echo_scan_bwd": reverse_echo.reverse_echo_scan_bwd_ref,
            "adsr_scan_bwd": adsr.adsr_scan_bwd_ref}

    def counts(fns):
        return {k: f.launches for k, f in fns.items()}

    def zero():
        for f in (*fwd.values(), *bwd.values(), adsr.adsr_clock_scan_bwd):
            f.launches = 0

    def theta_on(values, grad):
        return {k: torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=grad)
                for k, v in values.items()}

    def render_loss(graph, n, block, theta):
        out = engine.render_functional(graph, 0, n, block, theta, device=dev)
        return torch.mean(out ** 2)

    errs = dict.fromkeys(bwd, 0.0)
    echo_orders = []  # the echo's recorded launches held to their kernel's order

    def echo_order(calls, what):
        """Each recorded echo backward launch against its kernel's order in
        torch ops on the same control results, on the card
        (``reverse_echo_scan_bwd_periods``): bit for bit; and launched
        again: the same bits."""
        for j, (args, kw, got) in enumerate(calls):
            want = reverse_echo.reverse_echo_scan_bwd_periods(*args, **kw)
            n = reverse_echo.reverse_echo_scan_bwd.launches
            again = reverse_echo.reverse_echo_scan_bwd(*args, **kw)
            reverse_echo.reverse_echo_scan_bwd.launches = n  # a comparison's: not the path's
            for i, (g, a, w) in enumerate(zip(got, again, want)):
                check(torch.equal(g, a), f"echo backward, {what} launch {j}: output {i} differs "
                      "between two launches")
                err = float((g - w.reshape(g.shape)).abs().max())
                check(err == 0.0, f"echo backward, {what} launch {j}: output {i} differs from "
                      f"reverse_echo_scan_bwd_periods by {err}")
            echo_orders.append(f"{what} {j} (T={args[0].shape[0]} C={args[0].shape[1]})")

    # the backward kernels held to their orders in torch ops, and the
    # recorded launches each was held on
    orders = {"envelope_ar_scan_bwd": envelope.envelope_ar_scan_bwd_chunked,
              "slew_scan_bwd": slew.slew_scan_bwd_chunked,
              "adsr_scan_bwd": adsr.adsr_scan_bwd_tiled}
    held = {name: [] for name in orders}

    def kernel_order(name, calls, what):
        """Each recorded launch of the backward kernel ``name`` against its
        kernel's order in torch ops on the card (``orders[name]``): bit for
        bit; and launched again: the same bits."""
        for j, (args, kw, got) in enumerate(calls):
            want = orders[name](*args, **kw)
            n = bwd[name].launches
            again = bwd[name](*args, **kw)
            bwd[name].launches = n  # a comparison's: not the path's
            got, again, want = ([v] if torch.is_tensor(v) else v for v in (got, again, want))
            for i, (g, a, w) in enumerate(zip(got, again, want)):
                check(torch.equal(g, a), f"{name}, {what} launch {j}: output {i} differs "
                      "between two launches")
                err = float((g - w.reshape(g.shape)).abs().max())
                check(err == 0.0, f"{name}, {what} launch {j}: output {i} differs from "
                      f"{orders[name].__name__} by {err}")
            T, C = args[0].shape[0], (args[0].shape[1] if args[0].dim() == 2 else 1)
            held[name].append(f"{what} {j} (T={T} C={C})")

    def hold(calls, what):
        """Each recorded backward launch against its plain adjoint on the
        same inputs, on the card."""
        for name, rec in calls.items():
            for j, (args, kw, got) in enumerate(rec):
                want = refs[name](*args, **kw)
                want = want if isinstance(want, (tuple, list)) else [want]
                errs[name] = max(errs[name], _check_bwd(
                    name, _bwd_errors([g for g in got], want), f"{what} launch {j}",
                    EFFECTS_BWD_TOL))

    # ---- (a) the chain at CHAIN_N samples: gradients, FD, every launch held ----
    chain = fw.build_fit_chain(pg, CHAIN_N / SR)
    zero()  # the main path's run starts here
    keep = dict.fromkeys(bwd, 64)
    with recording(keep) as rec:
        theta = theta_on(CHAIN_THETA, True)
        loss = render_loss(chain, CHAIN_N, CHAIN_BLOCK, theta)
        grads = dict(zip(theta, torch.autograd.grad(loss, list(theta.values()),
                                                    allow_unused=True, materialize_grads=True)))
        torch.cuda.synchronize()
    n_blocks = CHAIN_N // CHAIN_BLOCK
    nb = counts(bwd)
    check(nb == {"envelope_ar_scan_bwd": n_blocks, "slew_scan_bwd": n_blocks,
                 "reverse_echo_scan_bwd": n_blocks, "adsr_scan_bwd": 0},
          f"chain: backward launches {nb}, expected {n_blocks} each but the ADSR's")
    res = {"loss": loss.item()}
    with torch.no_grad():
        for k, eps in CHAIN_FD_EPS.items():
            fd = ((render_loss(chain, CHAIN_N, CHAIN_BLOCK, theta_on(
                {**CHAIN_THETA, k: CHAIN_THETA[k] + eps}, False))
                   - render_loss(chain, CHAIN_N, CHAIN_BLOCK, theta_on(
                       {**CHAIN_THETA, k: CHAIN_THETA[k] - eps}, False))) / (2 * eps)).item()
            g = grads[k].item()
            rel = abs(g - fd) / max(abs(fd), 1e-9) if fd != 0.0 or g != 0.0 else 0.0
            check(np.isfinite(g) and rel < FD_TOL, f"chain: grad_{k} {g} vs fd {fd} (rel {rel})")
            res.update({f"grad_{k}": g, f"fd_{k}": fd, f"rel_err_{k}": rel})
    print(f"training chain (n={CHAIN_N}, block {CHAIN_BLOCK}, backward launches {nb}): "
          f"{json.dumps(res)} (the feedback reaches the output two echo blocks in, 0.6 s: "
          f"its gradient is zero before) [{card}]")
    t = time.perf_counter()
    hold(rec, "chain")
    echo_order(rec["reverse_echo_scan_bwd"], "chain")
    kernel_order("envelope_ar_scan_bwd", rec["envelope_ar_scan_bwd"], "chain")
    kernel_order("slew_scan_bwd", rec["slew_scan_bwd"], "chain")
    print(f"training chain: all {sum(len(v) for v in rec.values())} backward launches against "
          f"the plain adjoints on their inputs and cotangents (card, "
          f"{time.perf_counter() - t:.1f} s): max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if rec[k])
          + "; the echo's, the follower's and the slew limiter's launches bit for bit with "
          "reverse_echo_scan_bwd_periods, envelope_ar_scan_bwd_chunked and "
          "slew_scan_bwd_chunked, a second launch the same bits")

    # the feedback's gradient where the echo replays: CHAIN_FB_S, card only
    nfb = int(round(CHAIN_FB_S * SR))
    long_chain = fw.build_fit_chain(pg, CHAIN_FB_S)
    theta = theta_on(CHAIN_THETA, True)
    loss = render_loss(long_chain, nfb, BLOCK, theta)
    g_fb = dict(zip(theta, torch.autograd.grad(loss, list(theta.values()))))
    with torch.no_grad():
        for k, eps in CHAIN_FD_EPS.items():
            fd = ((render_loss(long_chain, nfb, BLOCK, theta_on(
                {**CHAIN_THETA, k: CHAIN_THETA[k] + eps}, False))
                   - render_loss(long_chain, nfb, BLOCK, theta_on(
                       {**CHAIN_THETA, k: CHAIN_THETA[k] - eps}, False))) / (2 * eps)).item()
            g = g_fb[k].item()
            rel = abs(g - fd) / max(abs(fd), 1e-9)
            check(np.isfinite(g) and g != 0.0 and rel < FD_TOL,
                  f"chain {CHAIN_FB_S} s: grad_{k} {g} vs fd {fd} (rel {rel})")
            print(f"training chain ({nfb} samples, block {BLOCK}): grad_{k} {g:.6g}, fd "
                  f"{fd:.6g}, rel {rel:.3g}")
    nb = counts(bwd)

    # ---- (b) the ADSR probe: its gradient is the JAX package's, zero ----
    probe = fw.build_adsr_probe(pg, CHAIN_N)
    with recording({"adsr_scan_bwd": 64}) as rec:
        theta = theta_on(ADSR_THETA, True)
        loss = render_loss(probe, CHAIN_N, CHAIN_BLOCK, theta)
        # the gate reaches the output through compares only: no gradient
        # flows back to it (None, materialized as the JAX package's 0)
        (g_adsr,) = torch.autograd.grad(loss, list(theta.values()), allow_unused=True,
                                        materialize_grads=True)
        torch.cuda.synchronize()
    n_adsr = bwd["adsr_scan_bwd"].launches - nb["adsr_scan_bwd"]
    check(n_adsr == n_blocks, f"ADSR probe: {n_adsr} backward launches, expected {n_blocks}")
    check(g_adsr.item() == 0.0, f"ADSR probe: gradient {g_adsr.item()}, the JAX package's is 0")
    hold(rec, "ADSR probe")
    adsr_calls = rec["adsr_scan_bwd"]
    kernel_order("adsr_scan_bwd", adsr_calls, "ADSR probe")
    print(f"ADSR probe (n={CHAIN_N}, block {CHAIN_BLOCK}): loss {loss.item():.6g}, d/dg "
          f"{g_adsr.item()} (the gate enters only through compares), {n_adsr} backward "
          f"launches, each within {EFFECTS_BWD_TOL} of its plain adjoint (max abs err "
          f"{errs['adsr_scan_bwd']:.3g})")
    total = counts(bwd)  # the chain's, the feedback check's and the probe's

    # ---- (c) the fit chain and (d) the fit fx bank, by Adam ----
    def fit_run(label, graph, seconds, start, hidden, steps, keep):
        n = int(round(seconds * SR))
        with torch.no_grad():
            target = engine.render_functional(graph, 0, n, BLOCK, hidden, device=dev)
        rows, mark = [], {}

        def begin():
            zero()
            torch.cuda.reset_peak_memory_stats()
            mark["event"] = torch.cuda.Event(enable_timing=True)
            mark["event"].record()
            mark["t"] = time.perf_counter()

        def on_step(step, loss, values):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            v = float(loss)
            wall = time.perf_counter() - mark["t"]
            end.synchronize()
            rows.append((step, v, wall, mark["event"].elapsed_time(end), counts(bwd),
                         torch.cuda.max_memory_allocated() / 2**20,
                         {k: float(x) for k, x in values.items()}))
            begin()

        with recording({name: 1 for name in keep}) as recs:
            begin()
            losses, fitted = fw.fit(graph, target, start, steps, TRAIN_LR, block=BLOCK,
                                    device=dev, on_step=on_step)
        for step, v, wall, span, nbw, peak, vals in rows:
            print(f"{label} step {step}: loss {v:.6g}, wall {wall * 1e3:.1f} ms, device span "
                  f"(CUDA events) {span:.1f} ms, backward launches {nbw}, peak memory "
                  f"{peak:.0f} MiB, then {json.dumps(vals)} [{card}]")
        check(losses[-1] < losses[0], f"{label}: the loss did not fall {losses}")
        print(f"{label}: loss {losses[0]:.6g} -> {losses[-1]:.6g} in {steps} Adam steps (lr "
              f"{TRAIN_LR}), fitted {json.dumps(fitted)}, hidden {json.dumps(hidden)}")
        return rows, {k: v[0] for k, v in recs.items() if v}

    chain_blocks = -(-int(round(TRAIN_CHAIN_S * SR)) // BLOCK)
    rows, chain_calls = fit_run(
        "fit chain", fw.build_fit_chain(pg, TRAIN_CHAIN_S), TRAIN_CHAIN_S, CHAIN_THETA,
        CHAIN_HIDDEN, TRAIN_CHAIN_STEPS,
        ["envelope_ar_scan_bwd", "slew_scan_bwd", "reverse_echo_scan_bwd"])
    for step, _, _, _, nbw, _, _ in rows:
        check(nbw == {"envelope_ar_scan_bwd": chain_blocks, "slew_scan_bwd": chain_blocks,
                      "reverse_echo_scan_bwd": chain_blocks, "adsr_scan_bwd": 0},
              f"fit chain step {step}: backward launches {nbw}, expected {chain_blocks}")
        for k in total:
            total[k] += nbw[k]
    echo_order([chain_calls["reverse_echo_scan_bwd"]], "fit chain")
    kernel_order("envelope_ar_scan_bwd", [chain_calls["envelope_ar_scan_bwd"]], "fit chain")
    kernel_order("slew_scan_bwd", [chain_calls["slew_scan_bwd"]], "fit chain")
    bank_blocks = -(-int(round(TRAIN_FXBANK_S * SR)) // BLOCK)
    rows, bank_calls = fit_run(
        "fit fx bank", fw.build_fit_fx_bank(pg, TRAIN_FXBANK_S), TRAIN_FXBANK_S, FXBANK_THETA,
        FXBANK_HIDDEN, TRAIN_FXBANK_STEPS, ["envelope_ar_scan_bwd", "reverse_echo_scan_bwd"])
    for step, _, _, _, nbw, _, _ in rows:
        check(nbw == {"envelope_ar_scan_bwd": bank_blocks, "slew_scan_bwd": 0,
                      "reverse_echo_scan_bwd": bank_blocks, "adsr_scan_bwd": 0},
              f"fit fx bank step {step}: backward launches {nbw}, expected {bank_blocks}")
        for k in total:
            total[k] += nbw[k]
    echo_order([bank_calls["reverse_echo_scan_bwd"]], "fit fx bank")
    kernel_order("envelope_ar_scan_bwd", [bank_calls["envelope_ar_scan_bwd"]], "fit fx bank")
    print(f"echo backward: {len(echo_orders)} recorded launches ({', '.join(echo_orders)}) bit "
          f"for bit with reverse_echo_scan_bwd_periods on the card, each launched twice: the "
          f"same bits")
    for name, calls in held.items():
        check(len(calls) > 0, f"{name}: no recorded launch held to {orders[name].__name__}")
        print(f"{name}: {len(calls)} recorded launches ({', '.join(calls)}) bit for bit with "
              f"{orders[name].__name__} on the card, each launched twice: the same bits")

    # ---- times at the fits' shapes (and the ADSR's at BLOCK), beside the plain adjoints ----
    adsr_kw = adsr_calls[0][1]
    T = BLOCK
    gate = torch.zeros(T, device=dev)
    for a, b in ((300, 2500), (4000, 4001), (5000, 9000), (12000, T - 100)):
        gate[a:b] = 1.0
    state = torch.tensor([4.0, 0.5, 0.0, 1.0], device=dev)
    env_t, *_ = adsr.adsr_scan(gate, state, **adsr_kw)
    g_t, gs_t, gn_t = _seeded(dev, 16, (T,), (4,), ())
    adsr_long = ([gate, state, env_t, g_t, gs_t, gn_t], adsr_kw)
    cases = {  # name: [(label, args, kw)], the first the row's ms
        "envelope_ar_scan_bwd": [("C=1", *chain_calls["envelope_ar_scan_bwd"][:2]),
                                 ("C=128", *bank_calls["envelope_ar_scan_bwd"][:2])],
        "slew_scan_bwd": [("C=1", *chain_calls["slew_scan_bwd"][:2])],
        "reverse_echo_scan_bwd": [("C=1", *chain_calls["reverse_echo_scan_bwd"][:2]),
                                  ("C=128", *bank_calls["reverse_echo_scan_bwd"][:2])],
        "adsr_scan_bwd": [(f"T={CHAIN_BLOCK}", *adsr_calls[0][:2]),
                          (f"T={BLOCK}", *adsr_long)],
    }
    entries = []
    for name, shapes in cases.items():
        times = []
        for label, args, kw in shapes:
            want, plain = timed_plain(lambda: refs[name](*args, **kw))
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = bwd[name](*args, **kw)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            got = got if isinstance(got, (tuple, list)) else [got]
            want = want if isinstance(want, (tuple, list)) else [want]
            errs[name] = max(errs[name], _check_bwd(
                name, _bwd_errors(got, want), f"{label} (T={args[0].shape[0]})",
                EFFECTS_BWD_TOL))
            if name in orders:  # the timed shapes held to the kernel's order too
                order = orders[name](*args, **kw)
                order = [order] if torch.is_tensor(order) else order
                check(all(torch.equal(g, w.reshape(g.shape)) for g, w in zip(got, order)),
                      f"{name} ({label}): differs from {orders[name].__name__}")
            ms = device_ms(lambda: bwd[name](*args, **kw), 10)
            alone = kernel_ms(lambda: bwd[name](*args, **kw), EFFECTS_BWD[name][2])
            T, C = args[0].shape[0], (args[0].shape[1] if args[0].dim() == 2 else 1)
            extra = {}
            if name == "reverse_echo_scan_bwd":
                # each pass alone (the readers' index, the period walk, the
                # gather, the channel sums, the torch ops around them), and
                # the design's bytes: the forward's control results kept as
                # residuals (the table, 64 bytes a sample, the bounds and the
                # count) and the scratch (gc and the two parts, the index)
                passes = launch_split(lambda: bwd[name](*args, **kw), key="echo_walk")
                plen = kw["plen"]
                tiles = -(-(T + plen) // reverse_echo._TILE_ROWS)
                extra = {"passes_ms": {k[:48]: v for k, v in passes.items()},
                         "residual_bytes": 64 * T + 4 * (T + 2),
                         "scratch_bytes": 12 * T * C + 4 * (2 * (T + plen)
                                                            + tiles * 4 * (plen + 256))}
                print(f"{name} ({label}, T={T}): each pass alone, ms a call: " + ", ".join(
                    f"{k[:48]} {v:.4f}" for k, v in passes.items()) + f"; residuals "
                    f"{extra['residual_bytes']} bytes, scratch {extra['scratch_bytes']} bytes "
                    f"[{card}]")
            if name == "envelope_ar_scan_bwd":
                bnd = bound(4 * (4 * T * C + 3 * C), ENV_BWD_OPS * T * C)
                # the design's scratch: the chunks' maps, written and read;
                # the flags
                chunks = -(-T // envelope.GRID_ROWS)
                extra = {"scratch_bytes": 4 * 2 * 2 * chunks * C
                         + 4 * (1 + chunks * -(-C // envelope.grid_width(C))),
                         "header": "pygmu2_tpu_torch/csrc/order1_grid.cuh"}
            elif name == "slew_scan_bwd":
                bnd = bound(4 * (4 * T + 3), SLEW_BWD_OPS * T)
                chunks = -(-T // envelope.GRID_ROWS)  # the design's scratch, as the follower's
                extra = {"scratch_bytes": 4 * 2 * 2 * chunks + 4 * (1 + chunks),
                         "header": "pygmu2_tpu_torch/csrc/order1_grid.cuh"}
            elif name == "reverse_echo_scan_bwd":
                cap, plen = kw["cap"], kw["plen"]
                bnd = bound(4 * (4 * T * C + 6 * T + 4 * cap * C + 3 * plen * C + 27),
                            ECHO_BWD_OPS_SAMPLE * T + ECHO_BWD_OPS_CHANNEL * T * C)
            else:
                _, walked = adsr.adsr_scan_bwd_ref(*args, **kw, with_walked=True)
                bnd = bound(4 * (2 * walked + 13), ADSR_BWD_OPS * walked)
                # the design's scratch past one tile of 1024 samples: the
                # ticket, the finished count, a 64-bit last edge a tile, each
                # tile's first cut and sum
                tiles = -(-T // adsr.BWD_TILE)
                extra = {"walked": walked,
                         "scratch_bytes": 4 * (2 + 4 * tiles) if tiles > 1 else 0,
                         "design": "csrc/adsr_scan_bwd.cu adsr_bwd_grid: every sample's cut "
                                   "test at once, a CUDA block a tile of 1024 samples, the "
                                   "first cut and the sums combined by the last block"}
            times.append((label, T, C, ms, plain, bnd, peak, alone, extra))
            print(f"{name} ({label}, T={T}): kernel {ms:.4f} ms (CUDA events; its own kernels "
                  f"alone {alone:.4f} ms, torch.profiler), bound {bnd[0]:.4g} ms "
                  f"({bnd[1]}), plain adjoint {plain:.1f} ms, peak memory of a launch "
                  f"{peak:.2f} MiB; within {EFFECTS_BWD_TOL} of the plain adjoint [{card}]")
        (label, T, C, ms, plain, bnd, peak, alone, extra), *more = times
        source, replaces, _ = EFFECTS_BWD[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": total[name], "max_abs_err": errs[name], "ms": ms,
                 "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                 "library_ms": None, "shape": f"T={T} C={C}", "peak_mib": peak,
                 "kernel_ms": alone, **extra}
        for label2, T2, C2, ms2, plain2, bnd2, peak2, alone2, extra2 in more:
            entry[f"at_{label2}"] = {"T": T2, "C": C2, "ms": ms2, "plain_ms": plain2,
                                     "bound_ms": bnd2[0], "bound_by": bnd2[1],
                                     "peak_mib": peak2, "kernel_ms": alone2, **extra2}
        entries.append(entry)

    # ---- the CPU's gradients ----
    cpu_loss, cpu_grads, cpu_adsr, cpu_s = cpu_job.result()
    for k, g in cpu_grads.items():
        got = grads[k].item()
        rel = abs(got - g) / abs(g) if g != 0.0 else abs(got)
        check(rel <= CPU_GRAD_TOL, f"chain: grad_{k} on the card {got} vs the CPU's {g} "
              f"(rel {rel})")
    check(cpu_adsr == g_adsr.item() == 0.0, f"ADSR probe: the CPU's {cpu_adsr}")
    print(f"training chain on the CPU (plain versions, {cpu_s:.1f} s in a second process): "
          f"loss {cpu_loss:.6g}, grads {json.dumps(cpu_grads)}, ADSR probe {cpu_adsr}; the "
          f"card's within {CPU_GRAD_TOL} relative")
    print(f"training chain: backward launches on the path {json.dumps(total)}; phase took "
          f"{time.perf_counter() - t0:.1f} s")
    return entries


# ---- 17. the string's gradient and batched bindings ----

STRING_T = 4096  # the string probe's calls
STRING_HEAD_T = 300  # their per-sample order's pre-t0 head
STRING_LS = (3, 83, 535)
STRING_LONG_L, STRING_LONG_T = 51201, 2048  # past MAX_KERNEL_L, at a short T
STRING_AP_C = 0.35
STRING_FD_EPS = {"rho": 3e-4, "buf": 1e-2, "ap_in": 1e-2, "ap_out": 1e-2}
STRING_FIT_S = 2.0  # L = 535, 6 blocks of BLOCK
STRING_FIT_STEPS = 5
STRING_BWD_LS = (133, 535)
# the string's backward per active sample: the seed's add, the chain's
# multiply and add, mu's multiply and add, rho / 2 and its product by mu,
# grho's add and two multiplies, the tape cotangent's two adds: 12
KS_BWD_OPS = 12
SWEEP_CUTOFFS = np.linspace(500.0, 4000.0, 8, dtype=np.float32)  # the example's
VMAP_PATCH_S, VMAP_CHAIN_S = 2.0, 0.8
VMAP_PATCH = {"cutoff": np.geomspace(700.0, 2500.0, 8).astype(np.float32),
              "fb": np.linspace(0.3, 0.72, 8).astype(np.float32)}
# the chain's 4 echo feedbacks, each with a wah depth: the depth batches the
# slew limiter (a mono kernel: a launch per member) and the compressor's
# follower (channel-batched: folded into one launch)
VMAP_CHAIN = {"depth": np.asarray([1800.0, 2200.0, 2500.0, 3000.0], np.float32),
              "fb": np.asarray([0.3, 0.45, 0.6, 0.75], np.float32)}
# the fit bank's and the fit fx bank's 4 candidates (3 blocks each, the last
# past the scan's 4096-sample routing threshold)
VMAP_BANK_S, VMAP_STRING_S = 1.0, 1.0
VMAP_BANK = {"low_hz": np.asarray([900.0, 1200.0, 1500.0, 2000.0], np.float32),
             "band_hz": np.asarray([500.0, 700.0, 800.0, 1100.0], np.float32)}
VMAP_FXBANK = {"drive": np.asarray([0.5, 0.8, 1.0, 1.5], np.float32)}
VMAP_TOL = 1e-6
VMAP_GRAD_TOL = 1e-5


def _string_probe_case(L, T, blocked, seed):
    """Seeded numpy arguments of a string call, the weights of its linear
    loss (one per output), and a direction per argument for finite
    differences."""
    rng = np.random.default_rng(seed)
    head = 0 if blocked else STRING_HEAD_T
    args = dict(rho=rng.uniform(0.97, 0.999, T).astype(np.float32),
                buf=rng.standard_normal(L).astype(np.float32),
                ap_in=np.float32(0.1), ap_out=np.float32(-0.2))
    act = np.arange(T) >= head
    weights = [rng.standard_normal(T).astype(np.float32),
               rng.standard_normal(L).astype(np.float32),
               np.float32(rng.standard_normal()), np.float32(rng.standard_normal())]
    dirs = dict(rho=rng.uniform(-1, 1, T).astype(np.float32),
                buf=rng.uniform(-1, 1, L).astype(np.float32),
                ap_in=np.float32(1.0), ap_out=np.float32(1.0))
    return args, act, np.int32(L // 3), weights, dirs


def _string_loss(args, act, r, weights, L, blocked):
    """The probe's loss: each output weighted (so the cotangents are the
    weights), through ks_scan on the tensors' device."""
    from pygmu2_tpu_torch.ops import ks

    y, buf2, _, ai2, ao2 = ks.ks_scan(args["rho"], act, args["buf"], r, args["ap_in"],
                                      args["ap_out"], L=L, allpass_c=STRING_AP_C,
                                      all_active=blocked)
    return sum((o * w).sum() for o, w in zip((y, buf2, ai2, ao2), weights))


def string_cpu_grads(cases):
    """The string probe's gradients through the port's plain versions on the
    CPU (run in a second process): [{name: numpy}] per case."""
    out = []
    t = time.perf_counter()
    for L, T, blocked, seed in cases:
        args, act, r, weights, _ = _string_probe_case(L, T, blocked, seed)
        ins = {k: torch.tensor(v, requires_grad=True) for k, v in args.items()}
        loss = _string_loss(ins, torch.from_numpy(act), torch.tensor(r),
                            [torch.tensor(w) for w in weights], L, blocked)
        grads = torch.autograd.grad(loss, list(ins.values()))
        out.append({k: g.numpy() for k, g in zip(ins, grads)})
    return out, time.perf_counter() - t


def training_string_vmap(dev, card):
    """Phase 17: the string's backward kernel (both orders) and batched
    bindings, ``torch.func.vmap`` over ``render_functional`` on the card;
    returns (the backward kernel's JSON entries, the forward launches of
    each kernel on this phase's path). The CPU's string gradients are made
    in a second process while the card works; it is stopped on the way
    out, whatever happens."""
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        return _training_string_vmap(dev, card, pool)
    finally:
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


def _training_string_vmap(dev, card, pool):
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import (adsr, comb, envelope, ks, ladder, linrec_kernel,
                                      reverse_echo, slew)

    t0 = time.perf_counter()
    fwd = {"ladder_scan": ladder.ladder_scan, "comb_scan": comb.comb_scan,
           "adsr_scan": adsr.adsr_scan, "ks_scan": ks.ks_scan,
           "envelope_ar_scan": envelope.envelope_ar_scan, "slew_scan": slew.slew_scan,
           "reverse_echo_scan": reverse_echo.reverse_echo_scan,
           "affine_scan_2": linrec_kernel.affine_scan_2_kernel}
    total = dict.fromkeys(fwd, 0)  # forward launches on this phase's path

    def zero():
        for f in (*fwd.values(), ks.ks_scan_bwd):
            f.launches = 0
        ks.ks_scan.blocked_launches = ks.ks_scan_bwd.blocked_launches = 0

    def take():
        for k, f in fwd.items():
            total[k] += f.launches

    cases = [(L, STRING_T, blocked, 17 + L) for L in STRING_LS for blocked in (False, True)]
    cases += [(STRING_LONG_L, STRING_LONG_T, blocked, 17) for blocked in (False, True)]
    cpu_job = pool.submit(string_cpu_grads, cases)

    # ---- (a) the string probe: both orders, every L ----
    on = lambda v, grad=False: torch.tensor(v, device=dev, requires_grad=grad)  # noqa: E731
    grads_card, bwd_errs, bwd_total = [], [], 0
    for L, T, blocked, seed in cases:
        args, act, r, weights, dirs = _string_probe_case(L, T, blocked, seed)
        act_t, r_t, w_t = on(act), on(r), [on(w) for w in weights]
        zero()  # the main path's run starts here
        ins = {k: on(v, True) for k, v in args.items()}
        loss = _string_loss(ins, act_t, r_t, w_t, L, blocked)
        got = dict(zip(ins, torch.autograd.grad(loss, list(ins.values()))))
        torch.cuda.synchronize()
        check(ks.ks_scan_bwd.launches == 1,
              f"string L={L} blocked={blocked}: {ks.ks_scan_bwd.launches} backward launches")
        take()
        bwd_total += ks.ks_scan_bwd.launches
        grads_card.append({k: g.cpu().numpy() for k, g in got.items()})
        # the launch against its plain adjoint on the same inputs, on the card
        with torch.no_grad():
            y = ks.ks_scan(on(args["rho"]), act_t, on(args["buf"]), r_t, on(args["ap_in"]),
                           on(args["ap_out"]), L=L, allpass_c=STRING_AP_C,
                           all_active=blocked)[0]
        bargs = (on(args["rho"]), None if blocked and L >= 16 else act_t, on(args["buf"]), r_t,
                 y, *w_t)
        want = ks.ks_scan_bwd_ref(*bargs, L=L, allpass_c=STRING_AP_C)
        errs = _bwd_errors([got[k] for k in ins], want)
        bwd_errs.append(_check_bwd("ks_scan_bwd", errs, f"L={L} blocked={blocked}",
                                   EFFECTS_BWD_TOL))
        for name_, order_ in (("ks_scan_bwd_ref", want),
                              ("ks_scan_bwd_pipelined", ks.ks_scan_bwd_pipelined(
                                  *bargs, L=L, allpass_c=STRING_AP_C))):
            for k, o in zip(ins, order_):
                check(torch.equal(got[k], o.reshape(got[k].shape)),
                      f"string L={L} blocked={blocked}: d/d{k} differs from {name_}")
        fd_rel = {}
        with torch.no_grad():
            for k, eps in STRING_FD_EPS.items():
                shifted = [{**{n: on(v) for n, v in args.items()},
                            k: on(args[k] + s * eps * dirs[k])} for s in (1.0, -1.0)]
                lp, lm = (_string_loss(a, act_t, r_t, w_t, L, blocked).item() for a in shifted)
                fd = (lp - lm) / (2 * eps)
                g = float((got[k] * on(dirs[k])).sum())
                fd_rel[k] = abs(g - fd) / max(abs(fd), 1e-9)
                check(np.isfinite(g) and fd_rel[k] < FD_TOL,
                      f"string L={L} blocked={blocked}: d/d{k} {g} vs fd {fd}")
        order = "blocked" if blocked and L >= ks.BLOCKED_MIN_L else "per sample"
        print(f"string probe L={L} T={T} ({order}{', all active' if blocked else ''}): one "
              f"backward launch; vs its plain adjoint {max(e for e, _ in errs):.3g} (largest "
              f"plain {max(s for _, s in errs):.3g}); vs finite differences "
              + ", ".join(f"{k} {v:.2g}" for k, v in fd_rel.items()) + f" [{card}]")

    # ---- (b) the string fit: L = 535, 2 s at BLOCK, by Adam ----
    L, c = fw.string_shape()
    n = int(round(STRING_FIT_S * SR))
    with torch.no_grad():
        target = fw.render_string(on(fw.string_excitation(L, fw.STRING_HIDDEN["seed"])),
                                  on(fw.STRING_HIDDEN["rho"]), n, BLOCK, allpass_c=c)
    rows, mark = [], {}

    def begin():
        zero()
        torch.cuda.reset_peak_memory_stats()
        mark["event"] = torch.cuda.Event(enable_timing=True)
        mark["event"].record()
        mark["t"] = time.perf_counter()

    def on_step(step, loss, rho):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        v = float(loss)
        wall = time.perf_counter() - mark["t"]
        end.synchronize()
        nf, nfb = ks.ks_scan.launches, ks.ks_scan.blocked_launches
        nb, nbb = ks.ks_scan_bwd.launches, ks.ks_scan_bwd.blocked_launches
        rows.append((step, v, wall, mark["event"].elapsed_time(end),
                     {"per_sample": nf - nfb, "blocked": nfb},
                     {"per_sample": nb - nbb, "blocked": nbb},
                     torch.cuda.max_memory_allocated() / 2**20, float(rho)))
        take()
        begin()

    n_blocks = len(range(-fw.STRING_HEAD, n, BLOCK))
    with recording({"ks_scan_bwd": n_blocks}) as rec:  # the first step's launches
        begin()
        losses, rho_fit, _ = fw.fit_string(
            target, fw.string_excitation(L, fw.STRING_START["seed"]), fw.STRING_START["rho"],
            STRING_FIT_STEPS, TRAIN_LR, block=BLOCK, allpass_c=c, device=dev, on_step=on_step)
    t = time.perf_counter()
    for j, (args_, kw_, got_) in enumerate(rec["ks_scan_bwd"]):
        want_ = ks.ks_scan_bwd_ref(*args_, **kw_)
        for i, (g, w) in enumerate(zip(got_, want_)):
            check(torch.equal(g, w.reshape(g.shape)), f"string fit: backward launch {j} output "
                  f"{i} differs from ks_scan_bwd_ref by {float((g - w).abs().max())}")
    check(len(rec["ks_scan_bwd"]) == n_blocks, "string fit: recorded backward launches")
    print(f"string fit: the first step's {n_blocks} backward launches (one per sample, the rest "
          f"blocked) bit for bit with ks_scan_bwd_ref on the card "
          f"({time.perf_counter() - t:.1f} s)")
    for step, v, wall, span, nf, nb, peak, rho_v in rows:
        print(f"string fit step {step}: loss {v:.6g}, wall {wall * 1e3:.1f} ms, device span "
              f"(CUDA events) {span:.1f} ms, forward launches {nf}, backward launches {nb}, "
              f"peak memory {peak:.0f} MiB, then rho {rho_v:.6g} [{card}]")
        want_n = {"per_sample": 1, "blocked": n_blocks - 1}
        check(nf == want_n and nb == want_n,
              f"string fit step {step}: launches forward {nf} backward {nb}, expected {want_n}")
        bwd_total += sum(nb.values())
    check(losses[-1] < losses[0], f"string fit: the loss did not fall {losses}")
    print(f"string fit (L={L}, {n} samples from t = -{fw.STRING_HEAD}, block {BLOCK}): loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g} in {STRING_FIT_STEPS} Adam steps (lr "
          f"{TRAIN_LR}), rho {fw.STRING_START['rho']} -> {rho_fit:.6g} (hidden "
          f"{fw.STRING_HIDDEN['rho']})")

    # ---- the backward kernel's times at T = BLOCK, beside its bound and plain adjoint ----
    timing = {}
    for Lt in STRING_BWD_LS:
        for blocked in (True, False):
            args, act, r, weights, _ = _string_probe_case(Lt, BLOCK, blocked, 3 + Lt)
            rho_t, buf_t, r_t = on(args["rho"]), on(args["buf"]), on(r)
            act_t = None if blocked else on(act)
            y = ks.ks_scan(rho_t, on(act), buf_t, r_t, on(args["ap_in"]), on(args["ap_out"]),
                           L=Lt, allpass_c=STRING_AP_C, all_active=blocked)[0]
            call = (rho_t, act_t, buf_t, r_t, y, *(on(w) for w in weights))
            want, plain = timed_plain(lambda: ks.ks_scan_bwd_ref(*call, L=Lt,
                                                                  allpass_c=STRING_AP_C))
            got = ks.ks_scan_bwd(*call, L=Lt, allpass_c=STRING_AP_C)
            bwd_errs.append(_check_bwd("ks_scan_bwd", _bwd_errors(got, want),
                                       f"T={BLOCK} L={Lt} blocked={blocked}", EFFECTS_BWD_TOL))
            again = ks.ks_scan_bwd(*call, L=Lt, allpass_c=STRING_AP_C)
            for i, (g, a, w) in enumerate(zip(got, again, want)):
                check(torch.equal(g, w) and torch.equal(g, a), f"ks_scan_bwd T={BLOCK} L={Lt} "
                      f"blocked={blocked}: output {i} off ks_scan_bwd_ref (or a second launch) "
                      f"by {float((g - w).abs().max())}")
            ms = device_ms(lambda: ks.ks_scan_bwd(*call, L=Lt, allpass_c=STRING_AP_C), 10)
            alone = kernel_ms(lambda: ks.ks_scan_bwd(*call, L=Lt, allpass_c=STRING_AP_C),
                              "ks_scan_bwd")
            K = int(act.sum())
            # rho, y, gy and grho (T each), act if given; the string in, its
            # cotangent out and in (L each); four scalars
            nbytes = 4 * (4 * BLOCK + 3 * Lt + 4) + (0 if blocked else BLOCK)
            bnd = bound(nbytes, KS_BWD_OPS * K)
            timing[(Lt, blocked)] = (ms, plain, bnd, alone)
            print(f"ks_scan_bwd (T={BLOCK}, L={Lt}, {'blocked' if blocked else 'per sample'} "
                  f"order's call): kernel {ms:.4f} ms (CUDA events; alone {alone:.4f} ms, "
                  f"torch.profiler), bound {bnd[0]:.4g} ms ({bnd[1]}), plain adjoint "
                  f"{plain:.1f} ms; bit for bit with ks_scan_bwd_ref, two launches the same "
                  f"bits [{card}]")

    cpu_grads, cpu_s = cpu_job.result()
    for (L_, T_, blocked, _), g_card, g_cpu in zip(cases, grads_card, cpu_grads):
        for k in g_cpu:
            rel = float(np.abs(g_card[k] - g_cpu[k]).max() / max(np.abs(g_cpu[k]).max(), 1e-30))
            check(rel <= CPU_GRAD_TOL, f"string L={L_} blocked={blocked}: d/d{k} on the card vs "
                  f"the CPU's: {rel}")
    print(f"string probe on the CPU (plain versions, {cpu_s:.1f} s in a second process): every "
          f"gradient of the {len(cases)} calls within {CPU_GRAD_TOL} relative of the card's")

    # ---- (c)-(g) batched bindings ----
    def vmapped(label, render, batch, per_block, n_blocks):
        """``render`` (a dict of one candidate's values -> its output)
        vmapped over the batch against the loop of renders, its launches a
        block, the walls; the summed loss's per-candidate gradients and
        vmap(grad)'s against the loop's."""
        keys = list(batch)
        B = len(batch[keys[0]])
        cols = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
        members = [{k: cols[k][i] for k in keys} for i in range(B)]

        def loss(b):
            return torch.mean(render(b) ** 2)

        render(members[0])  # warm-up
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = torch.func.vmap(render)(cols)
        torch.cuda.synchronize()
        wall_v = time.perf_counter() - t
        counts = {k: f.launches for k, f in fwd.items() if f.launches}
        take()
        t = time.perf_counter()
        loop = torch.stack([render(m) for m in members])
        torch.cuda.synchronize()
        wall_l = time.perf_counter() - t
        err = float((out - loop).abs().max())
        check(out.shape == loop.shape and torch.isfinite(out).all().item()
              and float(out.abs().max()) > 1e-3, f"{label}: vmapped render {tuple(out.shape)}")
        check(err <= VMAP_TOL, f"{label}: vmapped render vs the loop {err}")
        for k, want_n in per_block.items():
            check(counts.get(k, 0) == want_n * n_blocks,
                  f"{label}: {k} launched {counts.get(k, 0)} times, expected {want_n} a block")
        want = []
        for m in members:
            vals = [m[k].clone().requires_grad_() for k in keys]
            want.append(torch.autograd.grad(loss(dict(zip(keys, vals))), vals))
        want = {k: torch.stack([w[i] for w in want]) for i, k in enumerate(keys)}
        vals = {k: v.clone().requires_grad_() for k, v in cols.items()}
        zero()
        summed = torch.autograd.grad(torch.func.vmap(loss)(vals).sum(), list(vals.values()))
        take()
        rel = {k: float((s - want[k]).abs().max() / want[k].abs().max())
               for k, s in zip(keys, summed)}
        check(all(v <= VMAP_GRAD_TOL for v in rel.values()),
              f"{label}: the summed loss's per-candidate gradients vs the loop's {rel}")
        zero()
        per = torch.func.vmap(torch.func.grad(loss))(cols)
        take()
        rel_pg = {k: float((per[k] - want[k]).abs().max() / want[k].abs().max()) for k in keys}
        check(all(v <= VMAP_GRAD_TOL for v in rel_pg.values()),
              f"{label}: vmap(grad) vs the loop's gradients {rel_pg}")
        fmt = lambda d: json.dumps({k: f"{v:.2g}" for k, v in d.items()})  # noqa: E731
        print(f"{label}: {B} candidates vmapped {tuple(out.shape)}, vs the loop {err:.3g}; "
              f"launches a block {json.dumps({k: v / n_blocks for k, v in counts.items()})}; "
              f"wall vmapped {wall_v * 1e3:.1f} ms, loop of {B} {wall_l * 1e3:.1f} ms; the "
              f"summed loss's gradients vs the loop's {fmt(rel)}; vmap(grad) vs the loop's "
              f"{fmt(rel_pg)} [{card}]")

    def graph_render(graph, seconds, block=BLOCK):
        n = int(round(seconds * SR))
        return (lambda b: engine.render_functional(graph, 0, n, block, b, device=dev),
                -(-n // block))

    render, nb = graph_render(fw.build_sweep(pg, fw.PROBE_N), fw.PROBE_N / SR, fw.PROBE_BLOCK)
    vmapped("the example's sweep (8 cutoffs)", render,
            {"cutoff": SWEEP_CUTOFFS, "gain": np.full(8, 0.42, np.float32)}, {}, nb)
    render, nb = graph_render(fw.build_fit_patch(pg, VMAP_PATCH_S), VMAP_PATCH_S)
    vmapped("the fit patch (8 cutoff, fb candidates)", render, VMAP_PATCH,
            {"ladder_scan": 8, "comb_scan": 8, "adsr_scan": 2}, nb)
    render, nb = graph_render(fw.build_fit_chain(pg, VMAP_CHAIN_S), VMAP_CHAIN_S)
    vmapped("the fit chain (4 echo feedbacks and depths)", render, VMAP_CHAIN,
            {"reverse_echo_scan": 4, "envelope_ar_scan": 2, "slew_scan": 4, "ks_scan": 6}, nb)
    # (f) the fit bank at its 128 channels: both filters' planes batched, so
    # each scan folds 4 x 128 channels into one launch
    render, nb = graph_render(fw.build_fit_bank(pg, VMAP_BANK_S), VMAP_BANK_S)
    vmapped("the fit bank (4 low_hz, band_hz candidates, 128 channels)", render, VMAP_BANK,
            {"affine_scan_2": 2}, nb)
    # (g) the fit fx bank over its drive alone: the follower and the echo see
    # only their input batched and fold; the echo's rings start fresh and
    # unbatched, and come back batched after the first block
    render, nb = graph_render(fw.build_fit_fx_bank(pg, VMAP_BANK_S), VMAP_BANK_S)
    vmapped("the fit fx bank (4 drives, 128 channels)", render, VMAP_FXBANK,
            {"envelope_ar_scan": 1, "reverse_echo_scan": 1}, nb)
    # (h) the string over 4 (excitation, rho) candidates: a mono kernel, a
    # launch per member in each order, its backward per member
    L, c = fw.string_shape()
    n = int(round(VMAP_STRING_S * SR))
    vmapped("the string (4 excitations and rhos)",
            lambda b: fw.render_string(b["exc"], b["rho"], n, BLOCK, allpass_c=c),
            {"exc": np.stack([fw.string_excitation(L, s) for s in range(4)]),
             "rho": np.asarray([0.996, 0.997, 0.998, 0.999], np.float32)},
            {"ks_scan": 4}, len(range(-fw.STRING_HEAD, n, BLOCK)))

    # ---- the kernels line's entry ----
    ms, plain, bnd, alone = timing[(535, True)]
    entry = {"name": "ks_scan_bwd", "route": "cuda",
             "source": "pygmu2_tpu_torch/csrc/ks_scan_bwd.cu",
             "replaces": "pygmu2_tpu/ops/ks_pallas.py:173", "launches": bwd_total,
             "max_abs_err": max(bwd_errs), "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
             "bound_by": bnd[1], "library_ms": None, "shape": f"T={BLOCK} L=535, blocked",
             "kernel_ms": alone}
    for (Lt, blocked), (ms2, plain2, bnd2, alone2) in timing.items():
        if (Lt, blocked) != (535, True):
            entry[f"at_L{Lt}_{'blocked' if blocked else 'per_sample'}"] = {
                "ms": ms2, "plain_ms": plain2, "bound_ms": bnd2[0], "bound_by": bnd2[1],
                "kernel_ms": alone2}
    print(f"string and batched bindings: forward launches on the path {json.dumps(total)}, "
          f"{bwd_total} string backward launches; phase took {time.perf_counter() - t0:.1f} s")
    return [entry], total


def _same_snapshot(a: dict, b: dict) -> bool:
    """Two ``checkpoint_state`` snapshots hold the same keys, cursors and bits."""
    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, (tuple, list)):
            return [x for v in tree for x in flat(v)]
        return [np.asarray(tree)]

    return a.keys() == b.keys() and all(
        int(a[k]["next"]) == int(b[k]["next"])
        and len(flat(a[k]["user"])) == len(flat(b[k]["user"]))
        and all(np.array_equal(x, y) for x, y in zip(flat(a[k]["user"]), flat(b[k]["user"])))
        for k in a)


def sharded(dev, card) -> dict:
    """Phase 18: the sharded renders of ``parallel/render.py`` on a mesh of
    4 shards on the card (and over distinct cards where there are two or
    more). Returns each kernel's launches in the sharded renders."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import bench_workload, filter_workload, patch_workload
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import adsr, comb, ladder, linrec_kernel
    from pygmu2_tpu_torch.parallel import render as par
    from pygmu2_tpu_torch.soundfont import MidiFile
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk
    from pygmu2_tpu_torch.soundfont import offline as off

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    meshes = [("4 shards on one card", par.Mesh([dev] * 4))]
    if n_cards >= 2:  # 4 shards over the cards, in turn
        meshes.append((f"4 shards over {min(n_cards, 4)} cards",
                       par.Mesh([torch.device("cuda", i % n_cards) for i in range(4)])))
    else:
        print("sharded renders: one card, so only shards on one card (virtual shards) ran "
              f"[{card}]")
    virtual = meshes[0][1]
    osc, scan = fk.osc_filter_gain_mix, linrec_kernel.affine_scan_2_kernel
    serial = {"ladder_scan": ladder.ladder_scan, "comb_scan": comb.comb_scan,
              "adsr_scan": adsr.adsr_scan}
    launches = dict.fromkeys(("osc_filter_gain_mix", "osc_window_filter_gain_mix",
                              "affine_scan_2", *serial), 0)

    def walled(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def counts():
        return {k: f.launches for k, f in serial.items()}

    # (a) the offline render, voices sharded: one launch a shard
    midi = MidiFile(bench_workload.build_midi_bytes())
    for font, large, key in (("small", False, "osc_filter_gain_mix"),
                             ("large", True, "osc_window_filter_gain_mix")):
        synth, _ = bench_workload.build_workload(large, device=dev)
        one = off.render_midi_offline(synth, midi, 3.0, device=dev)  # warm-up too
        one16 = off.render_midi_offline(synth, midi, 3.0, wire="int16", device=dev)
        _, one_wall = walled(lambda: off.render_midi_offline(synth, midi, 3.0, device=dev))
        check(np.abs(one).max() > 0.01, f"3 s chord, {font} font: silent")
        for label, mesh in meshes:
            before = osc.launches
            got = par.render_midi_offline_sharded(synth, midi, 3.0, mesh)
            n = osc.launches - before
            launches[key] += n
            check(n == mesh.size, f"offline sharded, {font} font, {label}: {n} kernel launches")
            err = float(np.abs(got - one).max())
            check(got.shape == one.shape and np.array_equal(got, one),
                  f"offline sharded, {font} font, {label}: not bit for bit ({err})")
            got16 = off._to_wire(torch.from_numpy(got), "int16").numpy()
            check(np.array_equal(got16, one16),
                  f"offline sharded, {font} font, {label}: int16 not bit for bit")
            fk.osc_filter_gain_mix = fk.osc_filter_gain_mix_ref
            try:
                ref = par.render_midi_offline_sharded(synth, midi, 3.0, mesh)
            finally:
                fk.osc_filter_gain_mix = osc
            err = float(np.abs(got - ref).max())
            check(err <= TOL, f"offline sharded, {font} font, {label}: vs plain {err}")
            _, wall = walled(lambda: par.render_midi_offline_sharded(synth, midi, 3.0, mesh))
            print(f"render_midi_offline_sharded, 3 s chord, {font} font, {label}: {n} kernel "
                  f"launches; bit for bit with render_midi_offline (f32 and int16); vs the plain "
                  f"version's sharded render {err:.3g}; wall {wall * 1e3:.1f} ms, one device "
                  f"{one_wall * 1e3:.1f} ms [{card}]")

    # (b) the streaming voice engine, voices sharded: a scan launch a block and shard
    synth, _ = bench_workload.build_workload(False, device=dev)
    one, one_wall = walled(lambda: synth.render_midi_schedule(midi, 1.0))
    before = scan.launches
    got, wall = walled(lambda: par.render_midi_sharded(synth, midi, 1.0, virtual))
    n = scan.launches - before
    launches["affine_scan_2"] += n
    n_blocks = -(-SR // 1024)
    err = float(np.abs(got - one).max())
    check(n == n_blocks * virtual.size, f"render_midi_sharded: {n} scan launches")
    check(got.shape == one.shape and err <= 2e-5 and np.abs(one).max() > 0.01,
          f"render_midi_sharded vs render_midi_schedule {err}")
    print(f"render_midi_sharded, 1 s chord, small font, 4 shards: {n} scan launches "
          f"({n_blocks} blocks x 4); vs render_midi_schedule {err:.3g}; wall {wall * 1e3:.1f} ms "
          f"(the first sharded call), one device {one_wall * 1e3:.1f} ms [{card}]")

    # (c) the state relay on the patch: render_scan's bits and launches
    total = int(round(60.0 * SR))
    patch = patch_workload.build_patch(pg, 60.0)
    before = counts()
    one, one_wall = walled(lambda: engine.render_scan(patch, 0, total, BLOCK, device=dev).cpu().numpy())
    one_n = {k: v - before[k] for k, v in counts().items()}
    snap = engine.checkpoint_state(patch)
    check(bool(snap) and np.abs(one).max() > 0.1, "patch: no state left or silent")
    for label, mesh in meshes:
        before = counts()
        got, wall = walled(lambda: par.render_time_sharded_stateful(patch, 0, total, mesh,
                                                                    block=BLOCK))
        got_n = {k: v - before[k] for k, v in counts().items()}
        for k, v in got_n.items():
            launches[k] += v
        check(got.shape == one.shape and np.array_equal(got, one),
              f"relay, {label}: not bit for bit ({float(np.abs(got - one).max())})")
        check(got_n == one_n, f"relay, {label}: launches {got_n}, render_scan's {one_n}")
        check(_same_snapshot(engine.checkpoint_state(patch), snap),
              f"relay, {label}: the PE instances' states changed")
        print(f"render_time_sharded_stateful (relay), patch 60 s, {label}: bit for bit with "
              f"render_scan; launches {got_n} (render_scan's the same); instance states "
              f"untouched; wall {wall * 1e3:.1f} ms, one device {one_wall * 1e3:.1f} ms [{card}]")

    # (d) the halo mode on the filter bank, and its gate on the patch
    try:
        par.render_time_sharded_stateful(patch, 0, total, virtual, block=BLOCK, halo=4096)
        fail("halo: the gate did not raise on the patch")
    except ValueError as exc:
        gate = str(exc)
    seconds = 10.0
    total = int(round(seconds * SR))
    bank = filter_workload.build_filter_bank(pg, seconds, seed=0)
    one, one_wall = walled(lambda: engine.render_scan(bank, 0, total, BLOCK, device=dev).cpu().numpy())
    before = scan.launches
    got, wall = walled(lambda: par.render_time_sharded_stateful(bank, 0, total, virtual,
                                                                block=BLOCK, halo=BLOCK))
    n = scan.launches - before
    launches["affine_scan_2"] += n
    span = par._spans(total, virtual.size, BLOCK)[0]
    err = float(np.abs(got[span:] - one[span:]).max())
    check(n > 0, "halo: the scan kernel was not launched")
    check(got.shape == one.shape and err <= 1e-5 and np.abs(one).max() > 0.05,
          f"halo vs render_scan past the first span {err}")
    print(f"render_time_sharded_stateful (halo {BLOCK}), filter bank 10 s x 128, 4 shards: "
          f"{n} scan launches; past the first span vs render_scan {err:.3g}, in it "
          f"{float(np.abs(got[:span] - one[:span]).max()):.3g}; wall {wall * 1e3:.1f} ms, one "
          f"device {one_wall * 1e3:.1f} ms [{card}]; the gate on the patch: {gate[:90]}...")

    # (e) the affine mode, and the automatic choice
    def chain():
        src = pg.SinePE(frequency=220.0, amplitude=0.7)
        return pg.BiquadPE(pg.BiquadPE(src, 3000.0, 1.2), 800.0, 0.9)

    total, block = SR, 4096
    one = engine.render_scan(chain(), 0, total, block, device=dev).cpu().numpy()  # warm-up
    one, one_wall = walled(lambda: engine.render_scan(chain(), 0, total, block,
                                                      device=dev).cpu().numpy())
    got, wall = walled(lambda: par.render_time_sharded_affine(chain(), 0, total, virtual,
                                                              block=block))
    err = float(np.abs(got - one).max())
    check(got.shape == one.shape and err <= 1e-5, f"affine vs render_scan {err}")
    modes = []
    for cap in (None, 16):
        graph = chain()
        mode, d = par.select_time_sharding(graph, virtual, block=block, affine_max_basis=cap)
        auto = par.render_time_sharded_auto(graph, 0, total, virtual, block=block,
                                            affine_max_basis=cap)
        named = (par.render_time_sharded_affine if mode == "affine"
                 else par.render_time_sharded_stateful)(chain(), 0, total, virtual, block=block)
        check(mode == ("relay" if cap is None else "affine") and d == 8,
              f"select_time_sharding: {mode}, {d}")
        check(np.array_equal(auto, named), f"auto ({mode}) differs from the mode's render")
        modes.append(f"{mode} (D = {d}, cap {cap})")
    print(f"render_time_sharded_affine, two biquads 1 s, 4 shards: vs render_scan {err:.3g}; "
          f"wall {wall * 1e3:.1f} ms, one device {one_wall * 1e3:.1f} ms; "
          f"render_time_sharded_auto takes {', '.join(modes)} "
          f"bit for bit [{card}]")
    print(f"sharded renders: launches {json.dumps(launches)}; phase took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---- 19. the ladder backward past shared memory, SinePE's sine, the repo's
# examples, the block-order functions, the player and the MIDI demo ----

LADDER_OS = (99, 100, 128, 320)  # 99: today's launch; 100, 128: one chunk a
# block; 320: each sample's steps re-walked from its entering state
LADDER_T = 1024
LADDER_HOST_T = 64  # the plain adjoint on the host: two chunks, a per-step loop
LADDER_BWD_FIT_TOL = 1e-5  # of the call's largest plain cotangent
JOG_QUEUE_S = 0.1  # the stand-in stream's read-ahead: 4 blocks of 1024
JOG_TOL = 1e-4
DEMO_TOL = 2e-5  # the streaming synth's (tests/test_torch_meltysynth_pe.py)
BLOCK_ORDER_TOL = 1e-5  # XLA's contraction of x + fb * y in the block orders


def ladder_bwd_ops(os_n: int) -> int:
    """The ladder backward's operations per (sample, channel) at ``os_n``
    (LADDER_BWD_OPS's count at os_n = 2): the forward's input and decay 12
    and 35 a step, the adjoint's 47 a step, the decay's products and the
    input's 11."""
    return 23 + 82 * os_n


def _ladder_case(dev, T, C, os_n, seed):
    x, al, qa, ki, dsc, st, gy, gs = _seeded(dev, seed, (T, C), (T,), (T,), (T,), (T,),
                                             (9, C), (T, C), (9, C))
    x = x * 0.3
    x[T // 3:T // 3 + 4] = 1e-7  # quiet samples take the decay
    cols = (al.abs() * 0.5 + 0.05, qa * 0.1 + 1.0, ki.abs() * 3.0, dsc + 1.5)
    kw = dict(os_n=os_n, pbg=0.3, mode_index=os_n % 6, input_threshold=1e-5,
              state_decay=0.95)
    return (x, *cols, st * 0.1), gy, gs, kw


def ladder_plain_on_host(cases):
    """Each case's kernel results (numpy) against autograd of the plain
    ladder on the CPU (run in a second process): {os_n: ([(max abs
    difference, max |plain|)], seconds)}."""
    from pygmu2_tpu_torch.ops import ladder

    out = {}
    for os_n, args, gy, gs, kw, got in cases:
        t = time.perf_counter()
        want = ladder.ladder_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                                          torch.from_numpy(gy), torch.from_numpy(gs), **kw)
        out[os_n] = (_bwd_errors([torch.from_numpy(g) for g in got], want),
                     time.perf_counter() - t)
    return out


def example_heads_on_cpu(names, folder):
    """The examples' heads through the port on the CPU (run in a second
    process), SuperSawPE's free phases pinned: {name: (head, seconds)}."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import example_loader as ex
    from pygmu2_tpu_torch.models import osc_bandlimited

    torch.set_num_threads(1)
    osc_bandlimited.np = ex.pinned_numpy()
    out = {}
    for name in names:
        t = time.perf_counter()
        head = ex.render_head(name, pg, Path(folder) / "cpu" / name, device="cpu")
        out[name] = (head, time.perf_counter() - t)
    return out


def demo_on_cpu(sf_path):
    from pygmu2_tpu_torch.utils import meltysynth_midi_demo as demo

    torch.set_num_threads(1)
    t = time.perf_counter()
    return demo.scripted_arpeggio(sf_path, device="cpu"), time.perf_counter() - t


class _JogStream:
    """A stand-in sounddevice output stream: the script calls its callback
    (``pull``), a block at a time, in place of a sound card."""

    def __init__(self, samplerate, channels, blocksize, device=None, latency=None,
                 dtype="float32", callback=None, finished_callback=None):
        self.blocksize, self.channels, self.callback = blocksize, channels, callback
        self.writes = []

    def start(self):
        pass

    def stop(self):
        pass

    def close(self):
        pass

    def pull(self, n: int) -> None:
        for _ in range(n):
            out = np.full((self.blocksize, self.channels), np.nan, np.float32)
            self.callback(out, self.blocksize, None, None)
            self.writes.append(out.copy())


class _JogSD:
    OutputStream = _JogStream

    class CallbackStop(Exception):
        pass

    @staticmethod
    def query_devices():
        return [{"name": "stand-in out", "max_output_channels": 2}]


def jog_script(dev, wav_path: str):
    """JogShuttleCore on ``dev`` over the stand-in stream, stepped so that
    every control change lands between renders: the feeder renders one
    block a call and stops when its queue is full (4 blocks, and 1 in
    hand); each step waits for that. Load, play, shuttle to -2x and +4x,
    scrub, poll to the end. Returns (the stream's blocks, the tape
    positions after each step, the poll steps to the end)."""
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch.core import audio_renderer as ar_mod
    from pygmu2_tpu_torch.utils import jogshuttle as js

    renderers = []

    class Stepped(pg.AudioRenderer):
        def stream_start(self, start=0, end=None, **kw):
            src, render = self._source, self._source.render
            self.renders = 0

            def counted(*a, **k):
                out = render(*a, **k)
                self.renders += 1
                return out

            src.render = counted
            renderers.append(self)
            super().stream_start(start, end, batch_blocks=1, queue_seconds=JOG_QUEUE_S)

    saved = ar_mod._sd
    ar_mod._sd = _JogSD
    core = js.JogShuttleCore(
        renderer_factory=lambda sr: Stepped(sample_rate=sr, blocksize=1024, latency="low",
                                            device=dev), device=dev)
    try:
        core.load_file(wav_path)
        (r,) = renderers
        stream = r._cb_stream
        ahead = max(4, int(round(JOG_QUEUE_S * SR / 1024))) + 1
        pulled = [0]
        positions = []

        def settle():
            t = time.perf_counter()
            while r.renders < pulled[0] + ahead:
                check(time.perf_counter() - t < 120, f"jog/shuttle on {dev}: the feeder "
                      f"stalled at {r.renders} renders, {pulled[0]} blocks played")
                time.sleep(0.0005)
            time.sleep(0.002)
            check(r.renders == pulled[0] + ahead, f"jog/shuttle on {dev}: {r.renders} renders")

        def pull(n):  # a block at a time: the feeder refills the queue between
            for _ in range(n):
                stream.pull(1)
                pulled[0] += 1
                settle()

        settle()
        for step, n in ((core.play, 8),
                        (lambda: core.shuttle_changed(js.rate_to_slider(-2.0)), 6),
                        (lambda: core.shuttle_changed(js.rate_to_slider(4.0)), 6),
                        (lambda: core.scrub_start(0.5), 2), (lambda: core.scrub_move(0.25), 2),
                        (core.scrub_end, 2)):
            step()
            pull(n)
            positions.append(core.position)
        steps = 0
        while core.poll()["playing"] and steps < 100:
            pull(1)
            steps += 1
        check(not core.poll()["playing"], f"jog/shuttle on {dev}: never stopped at the end")
        pull(6)  # the blocks rendered at rate 0 after the stop
        positions.append(core.position)
        return np.concatenate(stream.writes), positions, steps
    finally:
        core.close()
        ar_mod._sd = saved


def _sine_graphs(pg):
    return {"SinePE closed form (440 Hz)": lambda: pg.SinePE(440.0, 0.7),
            "SinePE carried phase (FM)": lambda: pg.SinePE(
                pg.MixPE(pg.ConstantPE(300.0), pg.SinePE(5.0, 40.0)), 0.8)}


def examples_and_players(dev, card):
    """Phase 19: the ladder's backward past os_n = 99 (and at 99), SinePE
    on glibc's sine and the flanger, the repo's 34 runnable example heads,
    the comb's and the echo's kernels against their block orders, the
    jog/shuttle player's core and the MIDI demo, all on the card. Returns
    (the new ladder backward entry, the forward kernels' launches, the
    ladder backward launches at os_n <= 99). Host work (the examples' CPU
    heads, the plain adjoint, the demo's CPU render) runs in three more
    processes; they are stopped on the way out, whatever happens."""
    from pygmu2_tpu_torch.models import osc_bandlimited

    pool = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"))
    free_np = osc_bandlimited.np
    try:
        return _examples_and_players(dev, card, pool)
    finally:
        osc_bandlimited.np = free_np
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


def _examples_and_players(dev, card, pool):
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import example_loader as ex
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.models import osc_bandlimited
    from pygmu2_tpu_torch.ops import (adsr, comb, envelope, ks, ladder, linrec_kernel,
                                      reverse_echo, slew)
    from pygmu2_tpu_torch.ops.comb_block import comb_const_delay
    from pygmu2_tpu_torch.ops.reverse_echo_block import reverse_echo_aligned
    from pygmu2_tpu_torch.utils import meltysynth_midi_demo as demo
    from pygmu2_tpu_torch.utils.wavio import write_wav

    t0 = time.perf_counter()
    folder = Path(__file__).resolve().parent / "build" / "smoke" / "examples"
    folder.mkdir(parents=True, exist_ok=True)
    osc_bandlimited.np = ex.pinned_numpy()  # SuperSawPE's free phases, as on the CPU
    names = list(ex.RUNNABLE)
    check(len(names) == 34, f"{len(names)} runnable examples")
    cpu_jobs = [pool.submit(example_heads_on_cpu, names[i::2], str(folder)) for i in range(2)]
    font = folder / "demo.sf2"
    font.write_bytes(demo.demo_font_bytes())
    demo_job = pool.submit(demo_on_cpu, str(font))

    # ---- (a) the ladder backward: the kernel at T = LADDER_HOST_T against
    # the plain adjoint on the host (submitted first: a per-step loop) ----
    host_cases = []
    for os_n in LADDER_OS:
        args, gy, gs, kw = _ladder_case(dev, LADDER_HOST_T, 4, os_n, 300 + os_n)
        ckpt = ladder._launch(*args, **kw, checkpoints=True)[2]
        got = ladder._launch_bwd(*args[:5], ckpt, gy, gs, **kw)
        host_cases.append((os_n, [a.cpu().numpy() for a in args], gy.cpu().numpy(),
                           gs.cpu().numpy(), kw, [g.cpu().numpy() for g in got]))
    host_job = pool.submit(ladder_plain_on_host, host_cases)

    # ---- the main path: counts from 0 ----
    counters = {"ladder_scan": ladder.ladder_scan, "comb_scan": comb.comb_scan,
                "adsr_scan": adsr.adsr_scan, "ks_scan": ks.ks_scan,
                "envelope_ar_scan": envelope.envelope_ar_scan, "slew_scan": slew.slew_scan,
                "reverse_echo_scan": reverse_echo.reverse_echo_scan,
                "affine_scan_2": linrec_kernel.affine_scan_2_kernel}
    for fn in (*counters.values(), ladder.ladder_scan_bwd):
        fn.launches = 0
    plain_bwd = ladder.ladder_scan_bwd_ref
    plain_calls = [0]

    def counted_plain(*a, **k):
        plain_calls[0] += 1
        return plain_bwd(*a, **k)

    ladder.ladder_scan_bwd_ref = counted_plain
    grads, walls = {}, {}
    try:
        # (a) a gradient through a LadderPE at each os_n, render_functional
        with recording({"ladder_scan_bwd": len(LADDER_OS)}) as recs:
            for os_n in LADDER_OS:
                pg.set_sample_rate(SR)
                graph = pg.CropPE(pg.GainPE(pg.LadderPE(
                    pg.BlitSawPE(110.0, 0.6), pg.ParamPE("cutoff"), 0.6, oversample=os_n),
                    pg.ParamPE("gain")), 0, LADDER_T)
                th = {k: torch.tensor(v, device=dev, requires_grad=True)
                      for k, v in (("cutoff", 1800.0), ("gain", 0.7))}
                t = time.perf_counter()
                out = engine.render_functional(graph, 0, LADDER_T, LADDER_T, th, device=dev)
                g = torch.autograd.grad((out ** 2).mean(), list(th.values()))
                grads[os_n] = [float(v) for v in g]
                walls[os_n] = time.perf_counter() - t
                check(all(np.isfinite(grads[os_n])) and grads[os_n][1] != 0.0,
                      f"LadderPE oversample={os_n}: gradient {grads[os_n]}")
        bwd_launches = ladder.ladder_scan_bwd.launches
        # (b) SinePE and the flanger's head
        sine_card = {label: pg.render_to_array(pg.CropPE(build(), 0, BLOCK), device=dev)
                     for label, build in _sine_graphs(pg).items()}
        # (c) the examples' heads
        heads, ex_walls = {}, {}
        for name in names:
            t = time.perf_counter()
            heads[name] = ex.render_head(name, pg, folder / "cuda" / name, device=dev)
            torch.cuda.synchronize()
            ex_walls[name] = time.perf_counter() - t
        # (e) the player's core
        tone = folder / "tone.wav"
        tt = np.arange(SR) / SR
        write_wav(str(tone), (0.5 * np.sin(2 * np.pi * 220.0 * tt)).astype(np.float32)[:, None],
                  SR)
        t = time.perf_counter()
        jog_card, jog_pos_card, jog_steps = jog_script(dev, str(tone))
        jog_wall = time.perf_counter() - t
        # (f) the MIDI demo's scripted arpeggio
        t = time.perf_counter()
        demo_card = demo.scripted_arpeggio(str(font), device=dev)
        demo_wall = time.perf_counter() - t
    finally:
        ladder.ladder_scan_bwd_ref = plain_bwd
    launches = {name: fn.launches for name, fn in counters.items()}
    check(plain_calls[0] == 0, f"the card's ladder backward reached the plain version "
          f"{plain_calls[0]} times")
    check(bwd_launches == len(LADDER_OS) and len(recs["ladder_scan_bwd"]) == len(LADDER_OS),
          f"ladder backward: {bwd_launches} launches for {len(LADDER_OS)} gradients")
    print(f"phase 19 main path: launches {json.dumps(launches)}, ladder_scan_bwd "
          f"{bwd_launches} (no call of the plain adjoint on the card) [{card}]")
    # the kernels its graphs reach (no example has a SlewLimiterPE)
    for name in ("ladder_scan", "comb_scan", "adsr_scan", "ks_scan", "envelope_ar_scan",
                 "reverse_echo_scan", "affine_scan_2"):
        check(launches[name] > 0, f"phase 19's main path launched no {name}")

    # ---- (a) the ladder backward: bit for bit with its order, two launches
    # the same bits, each launch alone timed. At each os_n the recorded
    # launch (C = 1) and a seeded one on its columns (C = 4) run their order
    # in torch ops as one call of five channels, each summing its own ----
    saved = (ladder.ladder_scan_bwd.launches, ladder.ladder_scan.launches)
    t = time.perf_counter()
    rows, times, order_diff = [], {}, 0.0
    for i, os_n in enumerate(LADDER_OS):
        rargs, kw, rgot = recs["ladder_scan_bwd"][i]
        T = rargs[0].shape[0]
        check(kw["os_n"] == os_n and T == LADDER_T and rargs[0].shape[1] == 1,
              f"ladder case {os_n}: {kw} {tuple(rargs[0].shape)}")
        x, st, gy, gs = _seeded(dev, 100 + os_n, (T, 4), (9, 4), (T, 4), (9, 4))
        x[T // 3:T // 3 + 4] = 1e-7  # quiet samples take the decay
        sargs = [x * 0.3, *rargs[1:5], st * 0.1]
        ckpt = ladder._launch(*sargs, **kw, checkpoints=True)[2]
        sargs += [gy, gs, ckpt]
        sgot = list(ladder.ladder_scan_bwd(*sargs, **kw))
        both = [a if a.dim() == 1 else torch.cat([a, b], -1) for a, b in zip(rargs, sargs)]
        gx, parts, gst = ladder.ladder_scan_bwd_parts(*both, **kw)
        for what, args, got, lo, hi in (("recorded", rargs, rgot, 0, 1),
                                         ("seeded", sargs, sgot, 1, 5)):
            C = hi - lo
            want = [gx[:, lo:hi], *ladder.channel_sums(parts, lo, hi), gst[:, lo:hi]]
            again = ladder.ladder_scan_bwd(*args, **kw)
            for j, (g, a, w) in enumerate(zip(got, again, want)):
                w = w.reshape(g.shape)
                order_diff = max(order_diff, float((g - w).abs().max()))
                check(torch.equal(g, a), f"ladder backward os_n={os_n} ({what}, C={C}): "
                      f"output {j} differs between two launches")
                check(torch.equal(g, w), f"ladder backward os_n={os_n} ({what}, C={C}): "
                      f"output {j} differs from ladder_scan_bwd_chunked by "
                      f"{float((g - w).abs().max())}")
            split = launch_split(lambda: ladder.ladder_scan_bwd(*args, **kw), key="ladder_bwd")
            alone = sum(v for k, v in split.items() if "ladder_bwd" in k or "channel_sum" in k)
            events = device_ms(lambda: ladder.ladder_scan_bwd(*args, **kw), 5)
            layout = ladder._bwd_layout(os_n, ladder.CHECKPOINT_EVERY)
            n = -(-T // ladder.CHECKPOINT_EVERY)
            bnd = bound(4 * (3 * T * C + 8 * T + 27 * C), ladder_bwd_ops(os_n) * T * C)
            scratch = 4 * 2 * (9 * n * C + (n - 1) * (96 + 9) * C + 4 * T * C) + (
                4 * n * C * 6 * os_n if layout[2] else 0)
            times[os_n, C] = (alone, events, bnd, scratch, layout)
            rows.append(f"os_n={os_n} C={C} ({what}; layout {layout}): alone {alone:.4f} ms ("
                        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in split.items())
                        + f"), CUDA events {events:.4f} ms, bound {bnd[0]:.4g} ms ({bnd[1]}), "
                        f"scratch {scratch} bytes")
    ladder.ladder_scan_bwd.launches, ladder.ladder_scan.launches = saved
    print(f"ladder backward: {2 * len(LADDER_OS)} launches (T={LADDER_T}, C=1 recorded from "
          f"render_functional, C=4 seeded on its columns) bit for bit with "
          f"ladder_scan_bwd_chunked on the card, two launches the same bits "
          f"({time.perf_counter() - t:.1f} s) [{card}]")
    for row in rows:
        print(f"  ladder_scan_bwd {row} [{card}]")
    for os_n in LADDER_OS:
        print(f"  LadderPE oversample={os_n}: gradient (cutoff, gain) {grads[os_n]}, forward and "
              f"backward {walls[os_n] * 1e3:.1f} ms [{card}]")

    # ---- (b) SinePE: the card against the port's CPU render ----
    for label, build in _sine_graphs(pg).items():
        want = pg.render_to_array(pg.CropPE(build(), 0, BLOCK), device="cpu")
        got = sine_card[label]
        err = float(np.abs(got.astype(np.float64) - want).max())
        check(got.shape == want.shape and err <= TOL, f"{label}: card vs CPU {err}")
        print(f"{label}: card vs the port's CPU render, max abs diff {err:.3g} (bit for bit: "
              f"{bool(np.array_equal(got, want))}) [{card}]")
    # SinePE's device ops a block: glibc's sinf mirrored, and torch.sin as before

    def sine_block():
        return pg.render_to_array(pg.CropPE(pg.SinePE(440.0, 0.7), 0, BLOCK), block=BLOCK,
                                  device=dev)

    from pygmu2_tpu_torch.models import oscillators

    ops = {}
    for label in ("sincosf", "torch.sin"):
        if label == "torch.sin":
            oscillators.xla_math = types.SimpleNamespace(
                sincosf=lambda y: (torch.sin(y), None))
        try:
            ev = device_events(sine_block, reps=1)
        finally:
            oscillators.xla_math = sys.modules["pygmu2_tpu_torch.ops.xla_math"]
        ops[label] = None if ev is None else sum(len(v) for v in ev.values())
    print(f"SinePE(440 Hz) one block of {BLOCK} through render_to_array, device ops (kernels and "
          f"copies, torch.profiler): glibc's sinf mirrored {ops['sincosf']}, torch.sin "
          f"{ops['torch.sin']} [{card}]")

    # ---- (c) the examples: the card against the port's CPU heads ----
    cpu_heads = {}
    for job in cpu_jobs:
        cpu_heads.update(job.result())
    worst = 0.0
    for name in names:
        want, cpu_s = cpu_heads[name]
        got = heads[name]
        err = float(np.abs(got.astype(np.float64) - want).max())
        check(got.shape == want.shape and np.isfinite(got).all() and err <= TOL,
              f"example {name}: card vs CPU {err}")
        check(np.abs(want).max() > 1e-4, f"example {name}: silent")
        worst = max(worst, err)
        print(f"example {name}: head of {ex.HEAD} on the card vs the port's CPU, max abs diff "
              f"{err:.3g}; card wall {ex_walls[name] * 1e3:.1f} ms (CPU {cpu_s:.2f} s) [{card}]")
    print(f"examples: {len(names)} heads within {TOL} of the CPU (largest {worst:.3g}); "
          f"05_flanging {float(np.abs(heads['05_flanging'] - cpu_heads['05_flanging'][0]).max()):.3g}"
          f"; not run: {', '.join(ex.CANNOT_RUN)} ({next(iter(ex.CANNOT_RUN.values()))}) "
          f"[{card}]")

    # ---- (d) the comb's and the echo's kernels against their block orders ----
    saved = (comb.comb_scan.launches, reverse_echo.reverse_echo_scan.launches)
    T, L, d, C = BLOCK, 2206, 37, 4  # 37 divides neither T nor L
    f = np.float32(SR / d)
    check(int(np.rint(np.float32(SR) / f)) == d, "comb: the static delay")
    x, fb, buf = _seeded(dev, 19, (T, C), (T,), (L, C))
    fb = fb * 0.9
    pos = torch.tensor(1000, dtype=torch.int32, device=dev)
    ky, kbuf, kpos, _ = comb.comb_scan(x, torch.full((T,), float(f), device=dev), fb, buf.clone(),
                                       pos, torch.tensor(float(f), device=dev), L=L, sr=float(SR),
                                       smooth_alpha=0.01)
    by, bbuf, bpos = comb_const_delay(x, fb, buf, pos, d=d, L=L)
    err_comb = max(float((ky - by).abs().max()), float((kbuf - bbuf).abs().max()))
    check(int(kpos) == int(bpos) and err_comb <= BLOCK_ORDER_TOL,
          f"comb kernel vs comb_const_delay {err_comb}")
    Lb, plen, cap = 2048, 735, 22050
    x, fb, ba, bb, pb = _seeded(dev, 20, (T, C), (T,), (cap, C), (cap, C), (plen, C))
    fb = fb.abs() * 0.9
    ones = torch.ones(T, device=dev)
    misc = torch.tensor([1, 17, 40.25, 100, 100, Lb, Lb, Lb, 1], dtype=torch.float32,
                        device=dev)
    kw = dict(sr=float(SR), plen=plen, cap=cap, min_block=64, max_block=cap - 1,
              smooth_alpha=0.001)
    err_echo = 0.0
    for alt in (1.0, 0.0):
        kout = reverse_echo.reverse_echo_scan(x, torch.full((T,), Lb / SR, device=dev), ones, fb,
                                              torch.full((T,), alt, device=dev), ba.clone(),
                                              bb.clone(), pb.clone(), misc, **kw)
        bout = reverse_echo_aligned(x, fb, ba, bb, pb, 1, 17, 40.25, 100, Lb, 1, Lb=Lb,
                                    plen=plen, ratio=1.0, alternate=alt >= 0.5)
        err = max(float((a - b).abs().max()) for a, b in zip(kout[:3], bout[:3]))
        check(torch.equal(kout[3], bout[3]) and err <= BLOCK_ORDER_TOL,
              f"echo kernel vs reverse_echo_aligned (alternate {alt}) {err}")
        for k, i in ((0, 4), (1, 5), (3, 7), (7, 8), (8, 9)):
            check(int(kout[4][k]) == int(bout[i]), f"echo state {k}: {kout[4][k]} {bout[i]}")
        err_echo = max(err_echo, err)
    comb.comb_scan.launches, reverse_echo.reverse_echo_scan.launches = saved
    print(f"comb kernel (T={T} C={C} L={L}, static delay {d}) vs comb_const_delay: max abs diff "
          f"{err_comb:.3g}; echo kernel (T={T} C={C}, block {Lb}, unity pitch, alternating "
          f"and not) vs reverse_echo_aligned: {err_echo:.3g} (the block orders contract x + "
          f"fb * y into one rounding as XLA's program, the kernels round twice: not bit for "
          f"bit) [{card}]")

    # ---- (e) the player's core: the card against a CPU core ----
    t = time.perf_counter()
    jog_cpu, jog_pos_cpu, _ = jog_script("cpu", str(tone))
    err = float(np.abs(jog_card.astype(np.float64) - jog_cpu).max())
    check(jog_card.shape == jog_cpu.shape and np.isfinite(jog_card).all() and err <= JOG_TOL
          and np.abs(jog_cpu).max() > 0.1, f"jog/shuttle: card vs CPU {err}")
    check(np.allclose(jog_pos_card, jog_pos_cpu, atol=1e-3), "jog/shuttle: tape positions")
    print(f"jog/shuttle core on the card (play, -2x, +4x, scrub, {jog_steps} polls to the end): "
          f"{jog_card.shape[0] // 1024} blocks vs a CPU core's, max abs diff {err:.3g}; tape "
          f"positions {[round(p) for p in jog_pos_card]}; card {jog_wall:.2f} s, CPU "
          f"{time.perf_counter() - t:.2f} s [{card}]")

    # ---- (f) the MIDI demo's arpeggio ----
    demo_cpu, demo_cpu_s = demo_job.result()
    err = float(np.abs(demo_card.astype(np.float64) - demo_cpu).max())
    check(demo_card.shape == demo_cpu.shape and err <= DEMO_TOL
          and np.abs(demo_cpu).max() > 0.05, f"MIDI demo: card vs CPU {err}")
    print(f"MIDI demo arpeggio on the card vs the CPU: max abs diff {err:.3g} (of {DEMO_TOL}); "
          f"card {demo_wall:.2f} s, CPU {demo_cpu_s:.2f} s [{card}]")

    # ---- (a) the plain adjoint on the host: every output within 1e-5 of
    # the call's largest cotangent, and each within BWD_TOL of its own
    # largest (phase 15's criterion); each output's own share printed ----
    plain_err = 0.0
    for os_n, (errs, secs) in host_job.result().items():
        top = max(s for _, s in errs)
        e = max(err for err, _ in errs)
        check(e <= LADDER_BWD_FIT_TOL * top, f"ladder backward os_n={os_n}: {e} off the plain "
              f"adjoint (largest cotangent {top})")
        _check_bwd(f"ladder_scan_bwd os_n={os_n}", errs,
                   f"T={LADDER_HOST_T} C=4 vs the plain adjoint")
        if os_n > 99:
            plain_err = max(plain_err, e)
        print(f"ladder backward os_n={os_n} T={LADDER_HOST_T} C=4 against autograd of the plain "
              f"ladder on the host ({secs:.1f} s): max abs err {e:.3g} (largest cotangent "
              f"{top:.3g}); each output's error over its own largest: "
              + ", ".join(f"{err / sc:.2e}" for err, sc in errs))
    plain_s = host_job.result()[128][1]

    past = [o for o in LADDER_OS if o > 99]
    print(f"ladder backward past os_n 99: max abs err against the plain adjoint {plain_err:.3g}, "
          f"against its order in torch ops {order_diff:.3g}")
    a128, e128, b128, s128, lay128 = times[128, 1]
    entry = {
        "name": "ladder_scan_bwd (os_n > 99)", "route": "cuda",
        "source": "pygmu2_tpu_torch/csrc/ladder_scan_bwd.cu",
        "replaces": "pygmu2_tpu/ops/ladder_pallas.py:253",
        "launches": sum(1 for _, kw, _ in recs["ladder_scan_bwd"] if kw["os_n"] > 99),
        "max_abs_err": plain_err, "max_abs_diff_chunked_order": order_diff,
        "ms": a128, "events_ms": e128,
        "plain_ms": plain_s * 1e3, "plain_shape": f"T={LADDER_HOST_T} C=4 os_n=128, the "
        "plain adjoint on the host's CPU", "bound_ms": b128[0], "bound_by": b128[1],
        "library_ms": None, "shape": f"T={LADDER_T} C=1 os_n=128, layout {lay128}",
        "scratch_bytes": s128,
        "by_case_ms": {f"os_n={o} C={c}": times[o, c][0] for o in LADDER_OS for c in (1, 4)},
        "by_case_bound_ms": {f"os_n={o} C={c}": times[o, c][2][0]
                             for o in LADDER_OS for c in (1, 4)},
    }
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s; the ladder backward past os_n 99 "
          f"({', '.join(map(str, past))}) launched {entry['launches']} times on its path")
    return entry, launches, bwd_launches - entry["launches"]


if __name__ == "__main__":
    main()
