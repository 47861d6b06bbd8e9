"""Bundled assets: the KEMAR compact HRTF dataset (MIT Media Lab,
public measurement data) used by SpatialHRTF.

Counterpart of ``pygmu2_tpu.assets`` (reference:
src/pygmu2/assets/__init__.py:11). The port ships no copy of the WAVs:
it finds the JAX package's set by path, ``pygmu2_tpu/assets/kemar/``
beside this package, without importing that package. The (elevation,
azimuth) table is derived by scanning the directory — filenames encode
the position as ``H{elev}e{azimuth:03d}a.wav``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path


def get_kemar_dir() -> Path:
    """Directory containing the KEMAR HRTF WAV set.

    Override with the PYGMU2_TPU_KEMAR_DIR environment variable.
    """
    override = os.environ.get("PYGMU2_TPU_KEMAR_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[2] / "pygmu2_tpu" / "assets" / "kemar"


_NAME_RE = re.compile(r"H(-?\d+)e(\d{3})a\.wav$")


def kemar_entries() -> list[tuple[int, int, str]]:
    """(elevation, azimuth, filename) for every bundled HRTF."""
    entries = []
    directory = get_kemar_dir()
    if directory.is_dir():
        for name in sorted(os.listdir(directory)):
            m = _NAME_RE.match(name)
            if m:
                entries.append((int(m.group(1)), int(m.group(2)), name))
    return entries
