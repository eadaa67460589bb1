"""What the traversals' host loops share: argument checks, the round's one
device-to-host read, the choice of a capacity tier, the mean out-degree
that picks a default, and the stacking of per-source results."""

from __future__ import annotations

import dataclasses
import numbers

import torch

from mini_tpu_torch.graph.csr import GraphSlice
from mini_tpu_torch.utils.profiling import annotate


def check_caps(**caps) -> None:
    """Each cap is an integer >= 0 or None (TypeError, ValueError)."""
    for name, cap in caps.items():
        if cap is None:
            continue
        if isinstance(cap, bool) or not isinstance(cap, numbers.Integral):
            raise TypeError(f"{name} must be an integer or None, got "
                            f"{type(cap).__name__}")
        if cap < 0:
            raise ValueError(f"{name} must be >= 0, got {cap}")


@annotate("loop.read")
def _read(*scalars) -> list:
    """The round's one device-to-host read: its scalars in one transfer
    (the span ``loop.read`` while a profiler runs)."""
    return torch.stack([s.to(torch.int32) for s in scalars]).tolist()


def _tier(tiers, fe: int, fl: int):
    """The smallest tier that holds ``fl`` vertices and ``fe`` edges, or
    None (the dense sweep)."""
    return next(((cv, ce) for cv, ce in tiers if fe <= ce and fl <= cv), None)


def _mean_degree(g: GraphSlice) -> float:
    """The mean out-degree of the real vertices, from the metadata (their
    degrees sum to m): no read of the device."""
    return g.m / g.n if g.n else float("nan")


def stack_results(cls, runs, device):
    """One result of ``cls`` from per-source ``runs``: tensors stacked on a
    leading axis, Python counters as int32 (flags as bool) tensors
    ``[len(runs)]`` on ``device``."""
    def stack(vals):
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals)
        dtype = torch.bool if isinstance(vals[0], bool) else torch.int32
        return torch.tensor(vals, dtype=dtype, device=device)

    return cls(**{f.name: stack([getattr(r, f.name) for r in runs])
                  for f in dataclasses.fields(cls)})
