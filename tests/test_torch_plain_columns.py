"""PyTorch port: the ladder's and the ADSR's plain versions over many
columns at once.

``chip_smoke.py`` holds every ladder and ADSR launch of the performance
against the plain versions by running the launches side by side, as
the columns of one plain call. Each column must equal its one-column
call bit for bit.
"""

import numpy as np
import pytest
import torch

from pygmu2_tpu_torch.ops import adsr, ladder

torch.set_num_threads(1)

T = 300
C = 5


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("os_n,mode_index", [(1, 0), (2, 0), (2, 4)])
def test_ladder_columns_with_their_own_coefficients(os_n, mode_index):
    rng = _rng(os_n + 10 * mode_index)
    f = lambda *shape, lo=-1.0, hi=1.0: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, shape).astype(np.float32))
    x, state = f(T, C), f(9, C, lo=-0.2, hi=0.2)
    al, qa, ki = f(T, C, lo=0.05, hi=0.6), f(T, C, lo=0.5, hi=1.0), f(T, C, lo=0.0, hi=3.5)
    dsc = f(T, C, lo=0.5, hi=2.0)
    x[100:140] = 0.0  # below the input threshold: the state decays
    kw = dict(os_n=os_n, pbg=0.5, mode_index=mode_index, input_threshold=1e-5,
              state_decay=0.95)
    y, out = ladder.ladder_scan_ref(x, al, qa, ki, dsc, state, **kw)
    assert y.shape == (T, C) and out.shape == (9, C)
    for c in range(C):
        y1, out1 = ladder.ladder_scan_ref(x[:, c:c + 1], al[:, c], qa[:, c], ki[:, c],
                                          dsc[:, c], state[:, c:c + 1], **kw)
        assert torch.equal(y[:, c:c + 1], y1) and torch.equal(out[:, c:c + 1], out1), c


def _gates(triggered, seed):
    rng = _rng(seed)
    if triggered:
        return (rng.uniform(size=(T, C)) < 0.02).astype(np.float32) * rng.uniform(
            0.5, 1.0, (T, C)).astype(np.float32)
    flips = rng.uniform(size=(T, C)) < 0.03
    return (np.cumsum(flips, 0) % 2).astype(np.float32)


@pytest.mark.parametrize("triggered", [False, True], ids=["gated", "triggered"])
def test_adsr_columns(triggered):
    gate = torch.from_numpy(_gates(triggered, 3 + triggered))
    # entering states: idle, mid-attack, decay, sustain, release
    state = torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0],
                          [0.0, 0.2, 1.0, 0.6, 0.6],
                          [0.0, 7.0, 3.0, 40.0, 11.0],
                          [0.0, 1.0, 1.0, 1.0, 0.0]])
    kw = dict(dA=0.05, dD=-0.01, dR=-0.02, sus=0.6,
              sustain_samples=25 if triggered else None)
    env, out, nxt = adsr.adsr_scan_ref(gate, state, **kw)
    assert env.shape == (T, C) and out.shape == (4, C) and nxt.shape == (C,)
    assert len(torch.unique(env)) > 20
    for c in range(C):
        env1, out1, nxt1 = adsr.adsr_scan_ref(gate[:, c], state[:, c], **kw)
        assert torch.equal(env[:, c], env1) and torch.equal(out[:, c], out1), c
        assert torch.equal(nxt[c], nxt1), c
