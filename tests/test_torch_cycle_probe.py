"""PyTorch port: ``cycle_probe``'s instrumented kernel copies still find
every line they stamp in the kernels' sources (the probe itself needs a
CUDA card and ``nvcc``; building its sources needs neither)."""

import pytest

from pygmu2_tpu_torch import cycle_probe

NAMES = ["comb roles", "ks roles", "ks bwd roles", "follower roles", "slew roles",
         "osc roles"] + [
    f"adsr passes, {k}" for k in cycle_probe.ADSR_PATHS]


@pytest.mark.parametrize("name", NAMES)
def test_instrumented_sources_find_their_anchors(name):
    text = cycle_probe.instrumented_sources()[name]
    assert "clock64()" in text and "g_cycles" in text


def test_adsr_paths_replace_the_threshold():
    built = cycle_probe.adsr_passes_source(None)
    assert "constexpr int kSerialAbove = " in built
    for path, above in cycle_probe.ADSR_PATHS.items():
        if above is not None:
            text = cycle_probe.adsr_passes_source(above)
            assert f"constexpr int kSerialAbove = {above};" in text
