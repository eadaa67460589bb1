"""Each cell at a small size on the card, the kernels and the profiler's
device trace included (skips without a card)."""

import time

import pytest

from benchmark.harness import core
from benchmark.tests.conftest import SEED, SMALL


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_on_the_card(card, cell, trace):
    r = core.run(cell, SEED, 1.0, bool(trace), card, time.perf_counter(),
                 overrides=SMALL[cell])
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert r["device"]["busy_s"] > 0
        assert r["breakdown"]["device_ops"]
