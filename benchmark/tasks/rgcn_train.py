"""Full-batch R-GCN training on a typed graph: ``rgcn_train_step`` (SGD
with momentum) over every relation and every vertex with the port's
defaults (the banded aggregation over each relation graph's rectangular
layouts), the means' weights pre-banded once by ``rgcn_normalize`` at the
model's aggregated widths, float32.

Set-up builds each relation graph on the host and the card (``graph.*``
spans), makes the initial parameters from the seed, then drives the step
that the window times through its first ``reference_steps`` steps; the
window goes on from there with the same parameters and optimizer state.
Checked against the float64 reference of those steps
(``reference/rgcn.py``) by the GCN task's three numbers
(``tasks/gcn_train.compare_runs``).  The reference runs on the card after
the program's graphs, their cached layouts and its state are freed."""

from __future__ import annotations

import math

import torch

# at the top, not in set-up: a program without the typed model fails
# here, before anything is generated
from mini_tpu_torch.models.rgcn import rgcn_normalize

from benchmark.reference import rgcn as ref
from benchmark.tasks.gcn_train import _padded, compare_runs

# the planted faults' relations: one left out, one summed
LEFT_OUT = "writes"
SUMMED = "cites"


def relation_edges(cfg: dict, edges: dict) -> dict:
    """Relation name -> ``(src type, dst type, src, dst)`` from the
    generated edge types: as they are, reversed, or in both directions
    (duplicates kept)."""
    out = {}
    for r in cfg["relations"]:
        st, dt, _ = cfg["edge_types"][r["edges"]]
        s, d = edges[r["edges"]]
        if r.get("reverse"):
            st, dt, s, d = dt, st, d, s
        elif r.get("both_directions"):
            s, d = torch.cat([s, d]), torch.cat([d, s])
        out[r["name"]] = (st, dt, s, d)
    return out


def init_params(cfg: dict, seed: int, device) -> list:
    """Glorot-uniform embedding tables, root and relation weights and zero
    biases in ``models/rgcn.py``'s layout, drawn from a generator on
    ``device`` seeded from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)

    def glorot(rows, cols):
        u = torch.rand(rows, cols, generator=gen, device=device)
        return (u * 2 - 1) * math.sqrt(6.0 / (rows + cols))

    dims, types = cfg["dims"], cfg["node_types"]
    params = [{f"emb.{t}": glorot(types[t], dims[0])
               for t in cfg["embedded"]}]
    for fi, fo in zip(dims[:-1], dims[1:]):
        layer = {}
        for t in types:
            layer[f"root.{t}"] = glorot(fi, fo)
            layer[f"bias.{t}"] = torch.zeros(fo, device=device)
        for r in cfg["relations"]:
            layer[f"rel.{r['name']}"] = glorot(fi, fo)
        params.append(layer)
    return params


def build(inputs, cfg, spans, device):
    """The port's ``TypedGraph`` of the generated edges on ``device``: each
    relation by the host build (``from_edges_bipartite``), then its device
    graph (``GraphSlice.from_host``)."""
    from mini_tpu_torch.graph.csr import (GraphSlice, Relation, TypedGraph,
                                          from_edges_bipartite)

    types = inputs["num_nodes"]
    rels = []
    for name, (st, dt, s, d) in relation_edges(cfg, inputs["edges"]).items():
        with spans("inputs.to_host"):
            s, d = s.cpu().numpy(), d.cpu().numpy()
        with spans("graph.from_edges"):
            hg = from_edges_bipartite(s, d, types[st], types[dt])
        with spans("graph.from_host"):
            rels.append(Relation(name, st, dt,
                                 GraphSlice.from_host(hg, device=device)))
    return TypedGraph(dict(types), tuple(rels))


def setup(inputs, cell, spans, device) -> dict:
    from mini_tpu_torch.models import rgcn_init_opt

    cfg = cell.config
    tg = build(inputs, cfg, spans, device)
    with spans("graph.normalize"):
        norm = rgcn_normalize(tg, cfg["dims"][:-1])
    target = cfg["target"]
    rows = tg.n_pad(target)
    x = {target: _padded(inputs["x"], rows)}
    labels = _padded(inputs["labels"], rows)
    mask = _padded(inputs["train_mask"], rows, False)
    params0 = init_params(cfg, inputs["seed"], device)
    state = dict(tg=tg, norm=norm, x=x, batch=(labels, mask), target=target,
                 lr=float(cfg["lr"]), params=params0,
                 opt=rgcn_init_opt(params0))
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
    from mini_tpu_torch.models import rgcn_train_step

    state["params"], state["opt"], loss = rgcn_train_step(
        state["params"], state["opt"], state["tg"], state["x"],
        state["batch"], state["target"], lr=state["lr"], norm=state["norm"])
    return loss


def keep(state) -> dict:
    return state["readings"]


def release(state) -> None:
    """Free the program's graphs, state and the layouts cached for them
    (with their arrays on the card) before the reference runs."""
    from mini_tpu_torch.graph import banded

    for r in state["tg"].relations:
        banded.forget_host_graph(r.graph.fingerprint)
    state.clear()


def shapes(inputs, cell, state) -> dict:
    cfg = cell.config
    return dict(num_nodes=dict(inputs["num_nodes"]),
                relations=[(r.name, r.src, r.dst, r.graph.m)
                           for r in state["tg"].relations],
                dims=list(cfg["dims"]), embedded=list(cfg["embedded"]),
                target=cfg["target"])


def _reference(inputs, cell, dtype=torch.float64, mask=None, skip=(),
               summed=(), **kw):
    cfg = cell.config
    types = inputs["num_nodes"]
    rels = [(name, st, dt, ref.RelationMean(s, d, types[st], types[dt],
                                            dtype, summed=name in summed))
            for name, (st, dt, s, d)
            in relation_edges(cfg, inputs["edges"]).items()]
    params = [{k: v.to(dtype) for k, v in p.items()}
              for p in inputs["params0"]]
    target = cfg["target"]
    return ref.train(params, list(types), rels,
                     {target: inputs["x"].to(dtype)}, inputs["labels"],
                     inputs["train_mask"] if mask is None else mask, target,
                     float(cfg["lr"]), float(cfg["momentum"]),
                     int(cell.workload["reference_steps"]), skip=skip, **kw)


def check(inputs, cell, kept) -> dict:
    if not kept:
        return {}
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    return compare_runs(kept, want)


def control(inputs, cell, roots=None) -> dict:
    """The two lower-precision controls, each the reference in float32:
    with TF32-rounded matrix products (under the limits' own names), and
    with bfloat16 messages (``bf16_messages.<name>``); beside them the
    planted faults: one relation left out of the forward
    (``left_out.<name>``), one relation summed and not averaged
    (``summed.<name>``), and half the train vertices left out of the loss
    (``half_batch.<name>``)."""
    if "params0" not in inputs:
        inputs["params0"] = init_params(cell.config, inputs["seed"],
                                        inputs["x"].device)
    want = _reference(inputs, cell)
    want["params0"] = inputs["params0"]
    out = compare_runs(_reference(inputs, cell, torch.float32, tf32=True),
                       want)
    rows = torch.nonzero(inputs["train_mask"])[:, 0]
    half = torch.zeros_like(inputs["train_mask"])
    half[rows[: rows.numel() // 2]] = True
    for name, kw in (("bf16_messages", dict(dtype=torch.float32,
                                            bf16_messages=True)),
                     ("left_out", dict(skip=(LEFT_OUT,))),
                     ("summed", dict(summed=(SUMMED,))),
                     ("half_batch", dict(mask=half))):
        out.update({f"{name}.{k}": v for k, v in compare_runs(
            _reference(inputs, cell, **kw), want).items()})
    return out


def _plan(relations, dims, embedded, target):
    """What a step runs, layer by layer: ``[(live types, grad types)]``,
    the types whose outputs the loss reaches and, of the layer's inputs,
    those that take a gradient (every one past the first layer; in the
    first, the embedded types)."""
    live = {target}
    plan = []
    for i in reversed(range(len(dims) - 1)):
        takes = None if i else set(embedded)
        plan.append((set(live), takes))
        live = live | {s for _, s, d, _ in relations if d in live}
    return plan[::-1]


def step_flops(num_nodes, relations, dims, embedded, target) -> float:
    """A step's matrix products: forward, every type's root product ``n_t
    x d_in x d_out`` and every relation's ``n_dst x d_in x d_out``; in the
    backward, the weight gradient of each product whose output the loss
    reaches, and its input gradient where that input takes one (a first
    layer's features take none).  The means are bytes, not operations
    (:func:`step_bytes`)."""
    flops = 0.0
    for (fi, fo), (live, takes) in zip(zip(dims[:-1], dims[1:]),
                                       _plan(relations, dims, embedded,
                                             target)):
        per_row = 2.0 * fi * fo

        def product(rows, out_type, in_type):
            f = rows * per_row
            if out_type in live:
                f += rows * per_row * (1 + (takes is None
                                            or in_type in takes))
            return f

        for t, n in num_nodes.items():
            flops += product(n, t, t)
        for _, s, d, _ in relations:
            flops += product(num_nodes[d], d, s)
    return flops


def step_bytes(num_nodes, relations, dims, embedded, target) -> float:
    """The bytes a step's relation means need, each ``4 m F + 8 m + 4
    rows F``: its ``m`` float32 rows of ``F`` columns, its ``m`` ids and
    weights read once, its output rows written once.  Every relation's
    forward mean at each layer's input width (``n_dst`` rows); in the
    backward, the transpose (``n_src`` rows) of each relation whose output
    the loss reaches and whose source takes a gradient."""
    total = 0.0
    for F, (live, takes) in zip(dims[:-1], _plan(relations, dims, embedded,
                                                 target)):
        for _, s, d, m in relations:
            total += 4.0 * m * F + 8.0 * m + 4.0 * num_nodes[d] * F
            if d in live and (takes is None or s in takes):
                total += 4.0 * m * F + 8.0 * m + 4.0 * num_nodes[s] * F
    return total

