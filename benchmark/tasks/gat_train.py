"""Full-batch GAT training: ``gat_train_step`` (SGD with momentum) on the
whole graph with the port's defaults (``attn="auto"``: the banded
attention layer on the card; float32 messages), at the configuration's
widths, heads a layer and skip.

The attention graph is the generated edges in both directions, each
generated self-loop first moved to ``(u, u + 1 mod n)`` as the generator
moves the R-MAT draw's, and then one self-loop a vertex (the paper's
``N(v)`` holds v): ``2 m + n`` directed edges.

Set-up makes the initial parameters from the seed, then drives the step
that the window times through its first ``reference_steps`` steps; the
window goes on from there with the same parameters and optimizer state.
Checked against the float64 reference of those steps
(``reference/gat.py``) by the GCN task's three numbers
(``tasks/gcn_train.compare_runs``): the worst step's relative loss gap,
the first gradient's and the parameters' change's worst leaf gap between
norms."""

from __future__ import annotations

import math

import torch

from benchmark.reference import gat as ref
from benchmark.tasks import _graph
from benchmark.tasks.gcn_train import _padded, compare_runs


def attention_edges(inputs: dict, self_loops: int):
    """``(src, dst)`` int64 of the graph the layers attend over (see the
    module doc).  ``self_loops``, the configuration's count a vertex, must
    be 1: the paper's ``N(v)`` holds v once."""
    if self_loops != 1:
        raise ValueError(f"self_loops {self_loops}: the attention graph "
                         "holds exactly one self-loop a vertex")
    n, src, dst = inputs["n"], inputs["src"], inputs["dst"]
    dst = torch.where(src == dst, (dst + 1) % n, dst)
    loops = torch.arange(n, dtype=src.dtype, device=src.device)
    return torch.cat([src, dst, loops]), torch.cat([dst, src, loops])


def fan_ins(dims, heads) -> list:
    """Each layer's input width: the features, then the previous layer's
    heads times its width."""
    return [dims[0]] + [d * h for d, h in zip(dims[1:-1], heads[:-1])]


def init_params(dims, heads, seed: int, device) -> list:
    """Glorot-uniform ``w`` ``[H, fan_in, d]``, ``a_src`` and ``a_dst``
    ``[H, d]`` (the bound of ``w``), one draw each from a generator on
    ``device`` seeded from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    out = []
    for fi, fo, h in zip(fan_ins(dims, heads), dims[1:], heads):
        bound = math.sqrt(6.0 / (fi + fo))

        def u(*shape):
            return (torch.rand(*shape, generator=gen, device=device) * 2
                    - 1) * bound

        out.append({"w": u(h, fi, fo), "a_src": u(h, fo), "a_dst": u(h, fo)})
    return out


def setup(inputs, cell, spans, device) -> dict:
    from mini_tpu_torch.models import gat_init_opt

    cfg = cell.config
    src, dst = attention_edges(inputs, cfg["self_loops"])
    g = _graph.build(dict(n=inputs["n"], src=src, dst=dst), spans, device,
                     undirected=False)
    x = _padded(inputs["x"], g.n_pad)
    labels = _padded(inputs["labels"], g.n_pad)
    mask = _padded(inputs["train_mask"], g.n_pad, False)
    params0 = init_params(cfg["dims"], cfg["heads"], inputs["seed"], device)
    state = dict(g=g, x=x, batch=(labels, mask), lr=float(cfg["lr"]),
                 slope=float(cfg["negative_slope"]),
                 skip=tuple(cfg["skip"]), params=params0,
                 opt=gat_init_opt(params0))
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
    from mini_tpu_torch.models import gat_train_step

    state["params"], state["opt"], loss = gat_train_step(
        state["params"], state["opt"], state["g"], state["x"],
        state["batch"], lr=state["lr"], negative_slope=state["slope"],
        skip=state["skip"])
    return loss


def keep(state) -> dict:
    return state["readings"]


def release(state) -> None:
    state.clear()


def shapes(inputs, cell, state) -> dict:
    g = state["g"]
    return dict(n=g.n, m=g.m, dims=list(cell.config["dims"]),
                heads=list(cell.config["heads"]))


def _reference(inputs, cell, dtype=torch.float64, **kw):
    cfg = cell.config
    src, dst = attention_edges(inputs, cfg["self_loops"])
    edges = ref.Edges(src, dst, inputs["n"])
    params = [{k: v.to(dtype) for k, v in p.items()}
              for p in inputs["params0"]]
    return ref.train(params, edges, inputs["x"].to(dtype), inputs["labels"],
                     inputs["train_mask"], float(cfg["lr"]),
                     float(cfg["momentum"]),
                     int(cell.workload["reference_steps"]),
                     skip=tuple(cfg["skip"]),
                     slope=float(cfg["negative_slope"]), **kw)


def check(inputs, cell, kept) -> dict:
    if not kept:
        return {}
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    return compare_runs(kept, want)


def control(inputs, cell, roots=None) -> dict:
    """The two lower-precision controls, each the reference in float32:
    with TF32-rounded matrix products (under the limits' own names), and
    with bfloat16 messages (``bf16_messages.<name>``)."""
    if "params0" not in inputs:
        cfg = cell.config
        inputs["params0"] = init_params(cfg["dims"], cfg["heads"],
                                        inputs["seed"], inputs["x"].device)
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    out = compare_runs(_reference(inputs, cell, torch.float32, tf32=True),
                       want)
    out.update({f"bf16_messages.{k}": v for k, v in compare_runs(
        _reference(inputs, cell, torch.float32, bf16_messages=True),
        want).items()})
    return out


def step_flops(n: int, m: int, dims, heads) -> float:
    """A step's model operations: per layer the forward projection ``n x
    fan_in x H d`` and its weight gradient, the input gradient for every
    layer but the first, and ``2 m H d`` for each of the edge stream's
    three passes (the forward aggregation, the backward's weight
    cotangent ``<q, h>`` and its push aggregation).  The scores, softmax,
    ELU and skip, each ``O((n + m) H)``, are left out."""
    flops = 0.0
    for i, (fi, d, h) in enumerate(zip(fan_ins(dims, heads), dims[1:],
                                       heads)):
        flops += 2.0 * n * fi * h * d * (2 if i == 0 else 3)
        flops += 3 * 2.0 * m * h * d
    return flops
