"""Benchmark timing (gunrock's ad-hoc ``test_timer_t``,
`tests/test_utils.hxx:168-191`, with warmup, repetition statistics and
MTEPS reporting).

On a CUDA device (the default) each run is timed with CUDA events
recorded on the current stream around ``fn()``, after a synchronize; with
``device="cpu"`` with the host clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from mini_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Timing:
    mean_s: float
    min_s: float
    std_s: float
    runs: int

    def mteps(self, edges_traversed: float) -> float:
        """Millions of traversed edges per second (min time = peak rate)."""
        return edges_traversed / self.min_s / 1e6


def time_fn(
    fn: Callable[[], object],
    warmup: int = 2,
    repeat: int = 5,
    device=None,
) -> Timing:
    """Time ``fn`` on ``device`` (``None``: the card): ``warmup`` untimed
    runs, then ``repeat`` timed ones."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    samples = []
    for _ in range(repeat):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    a = np.array(samples)
    return Timing(
        mean_s=float(a.mean()),
        min_s=float(a.min()),
        std_s=float(a.std()),
        runs=repeat,
    )
