"""Full-batch GCN training: ``gcn_train_step`` (SGD with momentum) on the
whole graph with the port's defaults (``gcn_normalize(g)``, the banded
aggregation), float32.

Set-up makes the initial parameters from the seed, then drives the step
that the window times through its first ``reference_steps`` steps; the
window goes on from there with the same parameters and optimizer state.
Checked against the float64 reference of those steps
(``reference/gcn.py``): each step's loss (``loss_rel_gap``: the worst
step's relative gap), the first gradient as the optimizer holds it (its
momentum after one step from zero; ``grad_norm_gap``) and the parameters'
change over the steps (``change_norm_gap``), both by the worst leaf's gap
between norms (``harness/compare.py``)."""

from __future__ import annotations

import math

import torch

from benchmark.harness import compare
from benchmark.reference import gcn as ref
from benchmark.reference.graph import both_directions
from benchmark.tasks import _graph


def init_params(dims, seed: int, device) -> list:
    """Glorot-uniform weights and zero biases, one draw a layer from a
    generator on ``device`` seeded from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    out = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        u = torch.rand(fi, fo, generator=gen, device=device)
        out.append({"w": (u * 2 - 1) * math.sqrt(6.0 / (fi + fo)),
                    "b": torch.zeros(fo, device=device)})
    return out


def _padded(t, rows: int, fill=0):
    out = t.new_full((rows, *t.shape[1:]), fill)
    out[: t.shape[0]] = t
    return out


def setup(inputs, cell, spans, device) -> dict:
    from mini_tpu_torch.models import gcn_init_opt, gcn_normalize

    cfg = cell.config
    g = _graph.build(inputs, spans, device)
    with spans("graph.normalize"):
        norm = gcn_normalize(g)
    x = _padded(inputs["x"], g.n_pad)
    labels = _padded(inputs["labels"], g.n_pad)
    mask = _padded(inputs["train_mask"], g.n_pad, False)
    params0 = init_params(cfg["dims"], inputs["seed"], device)
    state = dict(g=g, norm=norm, x=x, batch=(labels, mask),
                 lr=float(cfg["lr"]), params=params0,
                 opt=gcn_init_opt(params0))
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
    from mini_tpu_torch.models import gcn_train_step

    state["params"], state["opt"], loss = gcn_train_step(
        state["params"], state["opt"], state["g"], state["norm"],
        state["x"], state["batch"], lr=state["lr"])
    return loss


def keep(state) -> dict:
    return state["readings"]


def release(state) -> None:
    state.clear()


def shapes(inputs, cell, state) -> dict:
    g = state["g"]
    return dict(n=g.n, m=g.m, dims=list(cell.config["dims"]))


def _reference(inputs, cell, dtype=torch.float64, tf32=False, mask=None):
    cfg = cell.config
    src, dst = both_directions(inputs["src"], inputs["dst"])
    adj = ref.Adjacency(src, dst, inputs["n"], dtype)
    params = [{k: v.to(dtype) for k, v in p.items()}
              for p in inputs["params0"]]
    return ref.train(params, adj, inputs["x"].to(dtype), inputs["labels"],
                     inputs["train_mask"] if mask is None else mask,
                     float(cfg["lr"]), float(cfg["momentum"]),
                     int(cell.workload["reference_steps"]), tf32=tf32)


def compare_runs(got: dict, want: dict) -> dict:
    """The three numbers of ``got`` (``losses``, first-step ``grads``,
    ``params`` after the steps) against the reference's ``want``."""
    p0 = want["params0"]
    g_want = compare.leaf_norms(want["grads"])
    moving = compare.moving_leaves(g_want)

    def change(ps):
        return compare.leaf_norms([{k: p[k].to(torch.float64)
                                    - q[k].to(torch.float64) for k in p}
                                   for p, q in zip(ps, p0)])

    return {
        "loss_rel_gap": max(compare.rel_gap(a, b) for a, b in
                            zip(got["losses"], want["losses"])),
        "grad_norm_gap": compare.worst_norm_gap(
            compare.leaf_norms(got["grads"]), g_want, moving),
        "change_norm_gap": compare.worst_norm_gap(
            change(got["params"]), change(want["params"]), moving),
    }


def check(inputs, cell, kept) -> dict:
    if not kept:
        return {}
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    return compare_runs(kept, want)


def control(inputs, cell, roots=None) -> dict:
    """The control: the reference in float32 with TF32 matrix products in
    the program's place; beside it, the fault of half the train vertices
    left out of the loss (the mean over the rest)."""
    if "params0" not in inputs:
        inputs["params0"] = init_params(cell.config["dims"], inputs["seed"],
                                        inputs["x"].device)
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    out = compare_runs(_reference(inputs, cell, torch.float32, tf32=True),
                       want)
    rows = torch.nonzero(inputs["train_mask"])[:, 0]
    half = torch.zeros_like(inputs["train_mask"])
    half[rows[: rows.numel() // 2]] = True
    out.update({f"half_batch.{k}": v for k, v in compare_runs(
        _reference(inputs, cell, mask=half), want).items()})
    return out


def step_flops(n: int, m: int, dims) -> float:
    """A step's model operations: per layer the forward product ``n x
    d_in x d_out`` and its weight gradient, the input gradient for every
    layer but the first (the features take none), and ``2 m d_out`` for
    each of the forward aggregation and its transpose in the backward."""
    flops = 0.0
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        flops += 2.0 * n * fi * fo * (2 if i == 0 else 3)
        flops += 2 * 2.0 * m * fo
    return flops
