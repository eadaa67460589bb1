"""Port parity: the GCN forward and training step of ``mini_tpu_torch``
against ``mini_tpu``'s (``impl="xla"``) and the float64 oracle
``gcn_forward_cpu``, with the JAX package's parameters carried across; and
the JAX suite's training oracles on the port's own RNG."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
import mini_tpu.models.gcn as jgcn
from mini_tpu.graph import banded as jbanded
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models.gcn import (
    gcn_forward,
    gcn_forward_cpu,
    gcn_init,
    gcn_init_opt,
    gcn_loss,
    gcn_normalize,
    gcn_train_step,
    params_from_jax,
)

DIMS = [32, 64, 8]
SMALL_TABLE = 128 * 128 * 4  # 128-row bands at 512-byte rows

# the module (the package exports its function under the same name)
spmm_mod = importlib.import_module("mini_tpu_torch.ops.spmm")


def graphs():
    args = (300, 2400)
    kw = dict(seed=0, undirected=True)
    hj, ht = jg.erdos_renyi(*args, **kw), tg.erdos_renyi(*args, **kw)
    return (hj, ht, jg.GraphSlice.from_host(hj),
            tg.GraphSlice.from_host(ht, device="cpu"))


@pytest.fixture(scope="module")
def setup():
    hj, ht, gj, gt = graphs()
    params_j = jgcn.gcn_init(jax.random.PRNGKey(0), DIMS)
    params_np = [{k: np.asarray(v) for k, v in p.items()} for p in params_j]
    x = np.random.RandomState(0).rand(gt.n_pad, DIMS[0]).astype(np.float32)
    want = np.asarray(jgcn.gcn_forward(
        params_j, gj, jgcn.gcn_normalize(gj), jnp.asarray(x), impl="xla"))
    oracle = gcn_forward_cpu(params_np, ht, x)
    return ht, gt, params_np, x, want, oracle


def test_gcn_normalize_matches():
    _, _, gj, gt = graphs()
    nj, nt = jgcn.gcn_normalize(gj), gcn_normalize(gt)
    for f in ("edge_weights_csc", "self_coeff"):
        # torch's and XLA's float32 rsqrt may round 1 ulp apart, and an
        # edge weight is a product of two: allow 2 ulp (2**-22)
        np.testing.assert_allclose(getattr(nt, f).numpy(),
                                   np.asarray(getattr(nj, f)),
                                   rtol=2.4e-7, atol=0)
    for f in ("banded_pull", "banded_push"):
        assert len(getattr(nt, f)) == len(getattr(nj, f))
        for a, b in zip(getattr(nj, f), getattr(nt, f)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=2.4e-7, atol=0)


def test_gcn_normalize_bands_for_the_spmms_layout(setup, monkeypatch):
    """A ``band_for_f`` off a multiple of 128 (nothing in the repo passes
    one) is where the packages part: the port bands the weights for
    ``layout_for``'s layout at that width, the one its SpMM takes, JAX for
    ``band_for_f * 4`` bytes a row.  At 40 columns and 128-row bands the
    port's weights come in 3 bands and JAX's in 1; the port's forward
    re-bands nothing and is bitwise its forward at the default 128."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    monkeypatch.setattr(jbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    ht, gt, params_np, x, _, _ = setup
    gj = graphs()[2]
    nt, nj = gcn_normalize(gt, band_for_f=40), jgcn.gcn_normalize(
        gj, band_for_f=40)
    assert len(nt.banded_pull) == len(nt.banded_push) == 3
    assert len(nj.banded_pull) == len(nj.banded_push) == 1
    for f, direction in (("banded_pull", "pull"), ("banded_push", "push")):
        lay = tbanded.layout_for(gt, direction, 40)
        assert [int(w.shape[0]) for w in getattr(nt, f)] == [
            len(i) for i in lay.ids]
    params = params_from_jax(params_np, device="cpu")
    before = spmm_mod.rebanded
    got = gcn_forward(params, gt, nt, torch.from_numpy(x), impl="banded")
    assert spmm_mod.rebanded == before
    want = gcn_forward(params, gt, gcn_normalize(gt), torch.from_numpy(x),
                       impl="banded")
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl,bands", [
    ("xla", 1), ("banded", 1), ("banded", 3),
])
def test_gcn_forward_matches(setup, monkeypatch, impl, bands):
    ht, gt, params_np, x, want, oracle = setup
    if bands == 3:  # 128-row bands: the 384-row graph splits into K=3
        monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)
    norm = gcn_normalize(gt)
    assert len(norm.banded_pull) == bands
    out = gcn_forward(params_from_jax(params_np, device="cpu"), gt, norm,
                      torch.from_numpy(x), impl=impl)
    assert out.dtype == torch.float32 and out.shape == want.shape
    # the tolerance of tests/test_gcn.py: float32 sums in another order
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy()[: ht.n], oracle, rtol=1e-4,
                               atol=1e-5)


def test_gcn_forward_bf16_messages(setup):
    ht, gt, params_np, x, want, _ = setup
    norm = gcn_normalize(gt)
    params = params_from_jax(params_np, device="cpu")
    xt = torch.from_numpy(x)
    f32 = gcn_forward(params, gt, norm, xt, impl="banded")
    b16 = gcn_forward(params, gt, norm, xt, impl="banded",
                      message_dtype=torch.bfloat16)
    assert b16.dtype == torch.float32
    # bf16 messages keep ~3 significant digits (tests/test_models.py)
    np.testing.assert_allclose(b16.numpy(), f32.numpy(), rtol=3e-2,
                               atol=3e-2)
    assert not torch.equal(b16, f32)


def test_gcn_init():
    p1 = gcn_init(torch.Generator().manual_seed(3), DIMS, device="cpu")
    p2 = gcn_init(torch.Generator().manual_seed(3), DIMS, device="cpu")
    assert [tuple(p["w"].shape) for p in p1] == [(32, 64), (64, 8)]
    for a, b, (fi, fo) in zip(p1, p2, zip(DIMS[:-1], DIMS[1:])):
        assert torch.equal(a["w"], b["w"])
        assert float(a["w"].abs().max()) <= np.sqrt(6.0 / (fi + fo))
        assert not a["b"].any()


def _labels(gt):
    rng = np.random.RandomState(1)
    labels = rng.randint(0, DIMS[-1], gt.n_pad).astype(np.int32)
    return labels, np.arange(gt.n_pad) < gt.n


@pytest.mark.parametrize("impl,bands,mdt", [
    ("xla", 1, None), ("banded", 1, None), ("banded", 3, None),
    ("banded", 3, "bfloat16"),
])
def test_gcn_train_steps_match(setup, monkeypatch, impl, bands, mdt):
    """Three SGD-momentum steps from the JAX package's params: loss,
    params and momentum against JAX's ``gcn_train_step(impl="xla")``."""
    ht, gt, params_np, x, _, _ = setup
    _, _, gj, _ = graphs()
    labels, mask = _labels(gt)
    pj = [{k: jnp.asarray(v) for k, v in p.items()} for p in params_np]
    oj = jgcn.gcn_init_opt(pj)
    nj = jgcn.gcn_normalize(gj)
    want = []
    for _ in range(3):
        pj, oj, lj = jgcn.gcn_train_step(
            pj, oj, gj, nj, jnp.asarray(x),
            (jnp.asarray(labels), jnp.asarray(mask)), 1e-2, "xla", None)
        # copies: the next step donates these buffers
        want.append((float(lj), *([{k: np.array(v) for k, v in p.items()}
                                   for p in tree] for tree in (pj, oj))))

    if bands == 3:
        monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)
    norm = gcn_normalize(gt)
    assert len(norm.banded_push) == bands
    pt = params_from_jax(params_np, device="cpu")
    ot = gcn_init_opt(pt)
    batch = (torch.from_numpy(labels), torch.from_numpy(mask))
    xt = torch.from_numpy(x)
    loss0 = gcn_loss(pt, gt, norm, xt, *batch, impl=impl)
    np.testing.assert_allclose(float(loss0), want[0][0], rtol=1e-4)
    # bf16 messages keep about 3 significant digits (tests/test_models.py)
    tol = dict(rtol=1e-4, atol=1e-6) if mdt is None else dict(rtol=3e-2,
                                                                atol=3e-2)
    for lj, pj, oj in want:
        pt, ot, lt = gcn_train_step(
            pt, ot, gt, norm, xt, batch, 1e-2, impl=impl,
            message_dtype=None if mdt is None else torch.bfloat16)
        np.testing.assert_allclose(float(lt), lj, **tol)
        for a, b in zip(pt + ot, pj + oj):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k].numpy(), b[k], **tol)


def _setup_small(n=120, m=700, dims=(16, 32, 4), seed=0):
    """tests/test_gcn.py's setup, with the port's own RNG for params."""
    hg = tg.erdos_renyi(n, m, seed=seed, undirected=True)
    gs = tg.GraphSlice.from_host(hg, device="cpu")
    x = np.random.RandomState(seed).rand(gs.n_pad, dims[0]).astype(
        np.float32)
    x[hg.n:] = 0.0
    params = gcn_init(torch.Generator().manual_seed(seed), list(dims),
                      device="cpu")
    return hg, gs, gcn_normalize(gs), params, torch.from_numpy(x)


@pytest.mark.parametrize("impl", ["xla", "banded"])
def test_gcn_training_reduces_loss(impl):
    """tests/test_gcn.py:45-59: fit teacher labels of a random GCN of the
    same shape."""
    hg, gs, norm, params, x = _setup_small()
    teacher = gcn_init(torch.Generator().manual_seed(99), [16, 32, 4],
                       device="cpu")
    labels = torch.argmax(gcn_forward(teacher, gs, norm, x), dim=-1)
    mask = torch.arange(gs.n_pad) < hg.n
    opt = gcn_init_opt(params)
    losses = []
    for _ in range(40):
        params, opt, loss = gcn_train_step(params, opt, gs, norm, x,
                                           (labels, mask), 0.2, impl=impl)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_gcn_overfits_community_labels():
    """tests/test_gcn.py:62-106: two planted communities are separable
    after aggregation."""
    rng = np.random.RandomState(2)
    n = 100
    srcs, dsts = [], []
    for _ in range(1500):
        c = rng.randint(2)
        u = rng.randint(50) + 50 * c
        side = c if rng.rand() < 0.9 else 1 - c
        v = rng.randint(50) + 50 * side
        if u != v:
            srcs.append(u)
            dsts.append(v)
    hg = tg.from_edges(np.array(srcs), np.array(dsts), num_nodes=n,
                       make_undirected=True)
    gs = tg.GraphSlice.from_host(hg, device="cpu")
    norm = gcn_normalize(gs)
    x = torch.from_numpy(rng.rand(gs.n_pad, 8).astype(np.float32))
    labels = torch.cat([torch.zeros(50, dtype=torch.int64),
                        torch.ones(50, dtype=torch.int64),
                        torch.zeros(gs.n_pad - n, dtype=torch.int64)])
    mask = torch.arange(gs.n_pad) < n
    params = gcn_init(torch.Generator().manual_seed(0), [8, 16, 2],
                      device="cpu")
    opt = gcn_init_opt(params)
    for _ in range(60):
        params, opt, _ = gcn_train_step(params, opt, gs, norm, x,
                                        (labels, mask), 0.1, impl="banded")
    logits = gcn_forward(params, gs, norm, x, impl="banded")
    acc = float((torch.argmax(logits[:n], -1) == labels[:n]).float().mean())
    assert acc > 0.9, acc
