"""GraphSAGE with the mean's weights pre-banded by ``sage_normalize`` on the
port, against the plain float64 reference that decides the benchmark's
``correct`` (``benchmark/reference/sage.py``), at a small size on the CPU:
the forward, one step's gradients and three SGD-momentum steps, on the
banded path (forced into three bands; every kernel wrapper runs its plain
version here) and on ``xla``.  Beside them: the lower-precision controls
fail the same tolerances, the pre-banded weights give the per-call
re-banded path's bits with no re-band in a step, a layout of more than
128 bands carries a step, and the configuration holds OGB's published
counts.  No JAX."""

import functools
import sys

import numpy as np
import pytest
import torch

import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models import sage as tsage

from benchmark.gen import arxiv_like
from benchmark.harness import registry
from benchmark.reference import sage as ref
from benchmark.reference.graph import both_directions
from benchmark.tasks import sage_train

CELL = "products-sage-train"
DIMS = [16, 32, 32, 8]
SMALL_TABLE = 128 * 128 * 4  # bands of 128 rows: K = 3 at 384 rows
LR, MOMENTUM = 0.01, 0.9
# The port's float32 against float64, on seeds 11-13 (largest gaps seen on
# both paths in brackets; the controls' least beside them, TF32 products /
# bf16 messages): logits, |got - want| / (|want| + 1) (3.2e-7; 8.2e-4 /
# 2.2e-3); the loss, relative (1.4e-7; 2.2e-6 / 3.6e-7); each gradient
# leaf, its largest gap over its largest entry (3.8e-7; 2.8e-3 / 5.3e-4);
# each of three steps' loss, relative (1.4e-7; 2.5e-5 / 3.1e-5); each
# parameter leaf after them, as the gradients (1.5e-7; 3.6e-3 / 3.2e-3).
# About ten times the float32 gaps: a float32 sum of a few dozen terms in
# another order.
TOL = {"logits": 3e-6, "loss": 1e-6, "grads": 3e-6, "step_losses": 1e-6,
       "params": 1e-6}


@functools.lru_cache(maxsize=None)
def case():
    """The benchmark's inputs at 300 vertices (both directions of 1,200
    generated edges), the port's slice of them, its padded inputs and the
    seeded initial parameters."""
    cfg = {**registry.load_cell(CELL).config, "num_nodes": 300,
           "num_edges": 1200, "feature_dim": DIMS[0],
           "num_classes": DIMS[-1],
           "split": {"train": 150, "valid": 50, "test": 100}}
    inputs = arxiv_like.generate(cfg, 11, "cpu")
    hg = tg.from_edges(inputs["src"].numpy(), inputs["dst"].numpy(), None,
                       num_nodes=300, make_undirected=True)
    g = tg.GraphSlice.from_host(hg, device="cpu")

    def pad(t, fill=0):
        out = t.new_full((g.n_pad, *t.shape[1:]), fill)
        out[: t.shape[0]] = t
        return out

    padded = (pad(inputs["x"]), pad(inputs["labels"]),
              pad(inputs["train_mask"], False))
    return inputs, g, padded, sage_train.init_params(DIMS, 5, "cpu")


def _flat(leaves):
    return [v for p in leaves for v in p.values()]


@functools.lru_cache(maxsize=None)
def port(impl: str) -> dict:
    """The port's readings with ``sage_normalize``'s weights."""
    inputs, g, (x, labels, mask), params = case()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
        assert tbanded.layout_for(g, "pull", DIMS[1]).K == 3
        norm = tsage.sage_normalize(g, DIMS[:-1])
        leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
                  for p in params]
        logits = tsage.sage_forward(leaves, g, x, impl=impl, norm=norm)
        loss = tsage.sage_loss(leaves, g, x, labels, mask, impl=impl,
                               norm=norm)
        grads = torch.autograd.grad(loss, _flat(leaves))
        p, o, losses = params, tsage.sage_init_opt(params), []
        for _ in range(3):
            p, o, step_loss = tsage.sage_train_step(
                p, o, g, x, (labels, mask), LR, impl=impl, norm=norm)
            losses.append(float(step_loss))
    return dict(logits=logits.detach()[:300], loss=float(loss.detach()),
                grads=list(grads), step_losses=losses, params=_flat(p))


@functools.lru_cache(maxsize=None)
def reference(dtype=torch.float64, **kw) -> dict:
    """The reference's readings, in ``dtype`` (float64; float32 for the
    controls, ``tf32`` or ``bf16_messages``)."""
    inputs, _, _, params = case()
    src, dst = both_directions(inputs["src"], inputs["dst"])
    mean = ref.Mean(src, dst, 300, dtype, block=1000)
    p0 = [{k: v.to(dtype) for k, v in p.items()} for p in params]
    x, labels, mask = inputs["x"].to(dtype), inputs["labels"], \
        inputs["train_mask"]
    hs, _ = ref.forward(p0, mean, x, **kw)
    loss, grads = ref.loss_and_grads(p0, mean, x, labels, mask, **kw)
    run = ref.train(p0, mean, x, labels, mask, LR, MOMENTUM, 3, **kw)
    return dict(logits=hs[-1], loss=float(loss), grads=_flat(grads),
                step_losses=run["losses"], params=_flat(run["params"]))


def _leaf_gap(got, want) -> float:
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max()) for a, b in zip(got, want))


def gap(got: dict, want: dict, number: str) -> float:
    a, b = got[number], want[number]
    if number == "logits":
        b = b.double()
        return float(((a.double() - b).abs() / (b.abs() + 1)).max())
    if number == "loss":
        return abs(a - b) / abs(b)
    if number == "step_losses":
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    return _leaf_gap(a, b)


@pytest.mark.parametrize("number", sorted(TOL))
@pytest.mark.parametrize("impl", ["banded", "xla"])
def test_port_matches_the_reference(impl, number):
    assert gap(port(impl), reference(), number) <= TOL[number]


@pytest.mark.parametrize("number", ["logits", "grads", "step_losses",
                                    "params"])
@pytest.mark.parametrize("control", ["tf32", "bf16_messages"])
def test_controls_fail_the_tolerances(control, number):
    """The reference in float32 with TF32 products or bf16 messages lies
    outside every tolerance but the single loss's (bf16 messages move one
    step's loss by only 3.6e-7 here, three steps' by 3.1e-5)."""
    got = reference(torch.float32, **{control: True})
    assert gap(got, reference(), number) > TOL[number]


def _forward_and_grads(g, x, params, norm):
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
              for p in params]
    out = tsage.sage_forward(leaves, g, x, impl="banded", norm=norm)
    return out.detach(), torch.autograd.grad(out.square().sum(),
                                             _flat(leaves))


def test_prebanded_equals_rebanded(monkeypatch):
    """The weights banded once give the bits of the same weights re-banded
    in every call (a ``SAGENorm`` with no bands), forward and gradients;
    a step with them re-bands nothing (``ops.spmm.rebanded``), the
    re-banding path once a layer.  Each band's real slots hold 1 /
    in-degree of their row, its pad slots 0."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    _, g, (x, labels, mask), params = case()
    spmm_mod = sys.modules["mini_tpu_torch.ops.spmm"]
    norm = tsage.sage_normalize(g, DIMS[:-1])
    assert sorted(norm.banded) == [128]  # widths 16 and 32: one layout
    bare = tsage.SAGENorm(norm.edge_weights_csc, {})
    out, grads = _forward_and_grads(g, x, params, norm)
    out_r, grads_r = _forward_and_grads(g, x, params, bare)
    assert torch.equal(out, out_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    for p, n in ((norm, 0), (bare, len(params))):
        before = spmm_mod.rebanded
        tsage.sage_train_step(params, tsage.sage_init_opt(params), g, x,
                              (labels, mask), LR, impl="banded", norm=p)
        assert spmm_mod.rebanded - before == n
    deg = g.in_degrees.double()
    for direction, bands in zip(("pull", "push"), norm.banded[128]):
        lay = tbanded.layout_for(g, direction, DIMS[1])
        dev = lay.dev("cpu")
        dst = g.csc_dsts if direction == "pull" else g.csr_dsts
        for k, w in enumerate(bands):
            rows = dst.long()[torch.from_numpy(lay.eids[k]).long()]
            valid = dev["valid"][k]
            assert torch.equal(w[valid].double(),
                               (1.0 / deg[rows[valid]]).float().double())
            assert bool((w[~valid] == 0).all())


def test_more_than_128_bands_carry_a_step(monkeypatch):
    """Bands of 128 rows on a graph of 19,500 vertices: 153 bands at every
    width, past the kernel's by-value tables, through ``_apply_banded``
    (here its plain version) forward and backward; the step equals
    ``xla``'s within the tolerances above."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 512)
    rng = np.random.RandomState(3)
    n = 19_500
    hg = tg.from_edges(rng.randint(0, n, 20_000), rng.randint(0, n, 20_000),
                       num_nodes=n, make_undirected=True)
    g = tg.GraphSlice.from_host(hg, device="cpu")
    dims = [16, 32, 8]
    assert tbanded.layout_for(g, "pull", 32).K == 153
    params = sage_train.init_params(dims, 7, "cpu")
    x = torch.from_numpy(rng.rand(g.n_pad, dims[0]).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, dims[-1], g.n_pad))
    mask = torch.arange(g.n_pad) < n
    norm = tsage.sage_normalize(g, dims[:-1])
    out = {}
    for impl in ("banded", "xla"):
        p, o, losses = params, tsage.sage_init_opt(params), []
        for _ in range(2):
            p, o, loss = tsage.sage_train_step(p, o, g, x, (labels, mask),
                                               LR, impl=impl, norm=norm)
            losses.append(float(loss))
        out[impl] = dict(step_losses=losses, params=_flat(p))
    for number in ("step_losses", "params"):
        assert gap(out["banded"], out["xla"], number) <= TOL[number]


def test_config_is_ogbs_products_example():
    """OGB's ogbn-products example at its published size: 206,895
    parameters (widths 100, 256, 256, 47, each layer ``[2 d_in, d_out]``
    and a bias), the sales-rank split, nothing reduced, one chip."""
    cell = registry.load_cell(CELL)
    cfg = cell.config
    assert (cfg["num_nodes"], cfg["num_edges"]) == (2_449_029, 61_859_140)
    assert (cfg["feature_dim"], cfg["num_classes"]) == (100, 47)
    assert cfg["split"] == {"train": 196_615, "valid": 39_323,
                            "test": 2_213_091}
    assert sum(cfg["split"].values()) == cfg["num_nodes"]
    assert cfg["dims"] == [100, 256, 256, 47] and cfg["reduced"] == []
    params = sage_train.init_params(cfg["dims"], 1, "cpu")
    count = sum(v.numel() for p in params for v in p.values())
    assert count == cfg["parameters"] == 206_895
    assert [tuple(p["w"].shape) for p in params] == [
        (200, 256), (512, 256), (512, 47)]
    assert "products" in cfg["source"] and cfg["tf32"] is False
    assert cell.workload["chips"] == 1 and cell.workload["task"] == \
        "sage_train"
