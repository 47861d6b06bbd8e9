"""PyTorch port: seeded control rows of the SoundFont audio pass for the
tests of ``soundfont.filter_kernels`` (numpy only: the card tests import
``synthetic_rows`` without JAX), and a check of what they hold."""

import numpy as np


def synthetic_rows(B, P, L, seed, fresh_blocks=()):
    """(rows, wave, state) as numpy arrays: (B, P) control rows over an
    (L,) table of four sines, smooth as a sample is (on noise, the JAX
    kernel's read position, rounded otherwise than the XLA branch's, moves
    the result), looping and one-shot voices, low-pass biquads (RBJ,
    cutoff 1-12 kHz, Q 0.5-1.5: a 50 Hz low-pass at Q 4 is ill-conditioned
    in float32, the plain version itself 0.08 off a float64 recursion),
    gain ramps (constant, ramped and inaudible), a fresh epoch at
    ``fresh_blocks``, and a (4, P) state."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)[:, None]
    wave = np.sum(np.sin(2 * np.pi * t / rng.uniform(20.0, 200.0, 4)
                         + rng.uniform(0.0, 6.3, 4)), axis=1).astype(np.float32) / 4
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    loop_start = rng.integers(100, L // 2, (B, P)).astype(np.int32)
    w0 = 2 * np.pi * rng.uniform(1000.0, 12000.0, (B, P)) / 44100.0
    alpha = np.sin(w0) / (2 * rng.uniform(0.5, 1.5, (B, P)))
    a0 = 1 + alpha
    pg = rng.uniform(0.0, 1.0, (4, B, P))
    pg[:, rng.uniform(size=(B, P)) < 0.1] = 1e-4  # inaudible
    const = rng.uniform(size=(B, P)) < 0.3
    pg[1][const] = pg[0][const]  # constant gains
    pg[3][const] = pg[2][const]
    freshf = np.zeros((B, P))
    freshf[list(fresh_blocks)] = 1.0
    rows = dict(
        ratio=f32(rng.uniform(0.3, 4.0, (B, P))),
        base_frac=f32(rng.uniform(0.0, 1.0, (B, P))),
        base_int=rng.integers(0, L // 2, (B, P)).astype(np.int32),
        loopf=f32(rng.uniform(size=(B, P)) < 0.5),
        loop_start=loop_start,
        loop_len=rng.integers(50, L // 2 - 1, (B, P)).astype(np.int32),
        smp_end=rng.integers(L // 2, L, (B, P)).astype(np.int32),
        ls_val=wave[loop_start],
        b0=f32((1 - np.cos(w0)) / 2 / a0), b1=f32((1 - np.cos(w0)) / a0),
        b2=f32((1 - np.cos(w0)) / 2 / a0), a1=f32(-2 * np.cos(w0) / a0),
        a2=f32((1 - alpha) / a0), freshf=f32(freshf),
        pgl=f32(pg[0]), gl=f32(pg[1]), pgr=f32(pg[2]), gr=f32(pg[3]),
    )
    state = f32(rng.uniform(-0.5, 0.5, (4, P)))
    return rows, wave, state


def test_synthetic_rows_hold_what_they_state():
    B, P, L = 5, 33, 4096
    rows, wave, state = synthetic_rows(B, P, L, seed=3, fresh_blocks=(0, 2))
    assert wave.shape == (L,) and state.shape == (4, P)
    assert all(v.shape == (B, P) for v in rows.values())
    assert rows["freshf"][[0, 2]].all() and not rows["freshf"][[1, 3, 4]].any()
    assert np.abs(np.diff(wave)).max() < 0.2  # smooth: periods of 20-200 samples
    loop_end = rows["loop_start"] + rows["loop_len"]
    assert (loop_end < L).all() and (rows["smp_end"] < L).all()
    a1, a2 = rows["a1"].astype(np.float64), rows["a2"].astype(np.float64)
    assert (np.abs(a2) < 1).all() and (np.abs(a1) < 1 + a2).all()  # stable poles
