"""Precision policy (counterpart of ``pygmu2_tpu.core.prec``).

Control and phase math runs in float64 and audio in float32, as in the
reference framework (reference: src/pygmu2/snippet.py:43,
sine_pe.py:134-147). The card runs float64 natively, so the port keeps
float64 wherever the JAX package carries ``WIDE``: oscillator phase and
the ADSR's carried envelope.
"""

from __future__ import annotations

import torch

# Audio sample dtype.
AUDIO = torch.float32
# High-precision dtype for phase accumulation / time math.
WIDE = torch.float64
# Absolute sample indices. int64 so multi-hour timelines don't wrap.
INDEX = torch.int64
