"""Full-batch GraphSAGE training: ``sage_train_step`` (SGD with momentum)
on the whole graph with the port's defaults (the banded aggregation) and
the mean's weights pre-banded once by ``sage_normalize`` at the model's
aggregated widths, float32.

Set-up makes the initial parameters from the seed, then drives the step
that the window times through its first ``reference_steps`` steps; the
window goes on from there with the same parameters and optimizer state.
Checked against the float64 reference of those steps
(``reference/sage.py``) by the GCN task's three numbers
(``tasks/gcn_train.compare_runs``): the worst step's relative loss gap,
the first gradient's and the parameters' change's worst leaf gap between
norms.  The reference runs on the card after the program's graph, its
cached layouts and its state are freed."""

from __future__ import annotations

import math

import torch

# at the top, not in set-up: a program without the mean's pre-banded
# weights fails here, before anything is generated
from mini_tpu_torch.models.sage import sage_normalize

from benchmark.reference import sage as ref
from benchmark.reference.graph import both_directions
from benchmark.tasks import _graph
from benchmark.tasks.gcn_train import _padded, compare_runs


def init_params(dims, seed: int, device) -> list:
    """Glorot-uniform ``w`` ``[2 d_in, d_out]`` (the vertex's rows over
    its neighbours' mean) and zero biases, one draw a layer from a
    generator on ``device`` seeded from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    out = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        u = torch.rand(2 * fi, fo, generator=gen, device=device)
        out.append({"w": (u * 2 - 1) * math.sqrt(6.0 / (2 * fi + fo)),
                    "b": torch.zeros(fo, device=device)})
    return out


def setup(inputs, cell, spans, device) -> dict:
    from mini_tpu_torch.models import sage_init_opt

    cfg = cell.config
    g = _graph.build(inputs, spans, device)
    with spans("graph.normalize"):
        norm = sage_normalize(g, cfg["dims"][:-1])
    x = _padded(inputs["x"], g.n_pad)
    labels = _padded(inputs["labels"], g.n_pad)
    mask = _padded(inputs["train_mask"], g.n_pad, False)
    params0 = init_params(cfg["dims"], inputs["seed"], device)
    state = dict(g=g, norm=norm, x=x, batch=(labels, mask),
                 lr=float(cfg["lr"]), params=params0,
                 opt=sage_init_opt(params0))
    inputs["params0"] = [{k: v.clone() for k, v in p.items()}
                         for p in params0]
    losses, grads = [], None
    with spans("warmup"):
        for _ in range(int(cell.workload["reference_steps"])):
            losses.append(step(state))
            if grads is None:  # momentum after one step from zero
                grads = [{k: v.clone() for k, v in o.items()}
                         for o in state["opt"]]
        state["readings"] = dict(
            losses=[float(v) for v in losses], grads=grads,
            params=[{k: v.clone() for k, v in p.items()}
                    for p in state["params"]])
    return state


def step(state) -> torch.Tensor:
    from mini_tpu_torch.models import sage_train_step

    state["params"], state["opt"], loss = sage_train_step(
        state["params"], state["opt"], state["g"], state["x"],
        state["batch"], lr=state["lr"], norm=state["norm"])
    return loss


def keep(state) -> dict:
    return state["readings"]


def release(state) -> None:
    """Free the program's graph, state and the layouts cached for the
    graph (with their arrays on the card) before the reference runs."""
    from mini_tpu_torch.graph import banded

    banded.forget_host_graph(state["g"].fingerprint)
    state.clear()


def shapes(inputs, cell, state) -> dict:
    g = state["g"]
    return dict(n=g.n, m=g.m, dims=list(cell.config["dims"]))


def _reference(inputs, cell, dtype=torch.float64, mask=None, **kw):
    cfg = cell.config
    src, dst = both_directions(inputs["src"], inputs["dst"])
    mean = ref.Mean(src, dst, inputs["n"], dtype)
    params = [{k: v.to(dtype) for k, v in p.items()}
              for p in inputs["params0"]]
    return ref.train(params, mean, inputs["x"].to(dtype), inputs["labels"],
                     inputs["train_mask"] if mask is None else mask,
                     float(cfg["lr"]), float(cfg["momentum"]),
                     int(cell.workload["reference_steps"]), **kw)


def check(inputs, cell, kept) -> dict:
    if not kept:
        return {}
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    return compare_runs(kept, want)


def control(inputs, cell, roots=None) -> dict:
    """The two lower-precision controls, each the reference in float32:
    with TF32-rounded matrix products (under the limits' own names), and
    with bfloat16 messages (``bf16_messages.<name>``); beside them, the
    fault of half the train vertices left out of the loss
    (``half_batch.<name>``)."""
    if "params0" not in inputs:
        inputs["params0"] = init_params(cell.config["dims"], inputs["seed"],
                                        inputs["x"].device)
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    out = compare_runs(_reference(inputs, cell, torch.float32, tf32=True),
                       want)
    out.update({f"bf16_messages.{k}": v for k, v in compare_runs(
        _reference(inputs, cell, torch.float32, bf16_messages=True),
        want).items()})
    rows = torch.nonzero(inputs["train_mask"])[:, 0]
    half = torch.zeros_like(inputs["train_mask"])
    half[rows[: rows.numel() // 2]] = True
    out.update({f"half_batch.{k}": v for k, v in compare_runs(
        _reference(inputs, cell, mask=half), want).items()})
    return out


def step_flops(n: int, m: int, dims) -> float:
    """A step's model operations: per layer the forward product ``n x 2
    d_in x d_out`` and its weight gradient, its input gradient for every
    layer but the first (the features take none), and ``2 m d_in`` for
    each aggregation: every layer's forward mean, and its transpose in
    the backward for every layer but the first."""
    flops = 0.0
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        flops += 2.0 * n * 2 * fi * fo * (2 if i == 0 else 3)
        flops += 2.0 * m * fi * (1 if i == 0 else 2)
    return flops


def step_bytes(n: int, m: int, dims) -> float:
    """The bytes a step's five aggregations need: the mean of each layer's
    input ``[n, d_in]`` over the ``m`` edges forward, and of the cotangent
    at the same width, transposed, backward for every layer but the first
    (widths 100, 256, 256 and 256, 256 here).  Each reads its ``m``
    float32 rows of ``d_in`` columns and its ``m`` edge weights once and
    writes its ``n`` output rows once."""
    widths = list(dims[:-1]) + list(dims[1:-1])
    return float(sum(4 * m * f + 4 * m + 4 * n * f for f in widths))
