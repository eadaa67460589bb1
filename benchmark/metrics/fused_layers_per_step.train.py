"""Attention layers a training step that left the banded layer for the
fused path: the delta of ``mini_tpu_torch.models.gat.fused_layers`` over
the profiled steps, over those steps.  0.0 when every layer ran
``_GatBandedLayer``; a program without the counter reads None."""

import importlib


def _gat():
    return importlib.import_module("mini_tpu_torch.models.gat")


def counters() -> int:
    return getattr(_gat(), "fused_layers", 0)


def read(ctx):
    steps = ctx.profiled.get("items", 0)
    if not steps or not hasattr(_gat(), "fused_layers"):
        return None
    return ctx.counter_deltas.get("fused_layers_per_step.train", 0) / steps
