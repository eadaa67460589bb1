"""Port parity: the GAT of ``mini_tpu_torch`` against ``mini_tpu``'s, with
the JAX package's parameters carried across by ``params_from_jax``: the
forward in every ``attn``, the gradients of the banded layer's native
backward and of the fused path, the train step; and the JAX suite's
oracles (``gat_forward_cpu``, bf16 within 3e-2, a falling loss).  On the
CPU every kernel wrapper runs its plain version; JAX's banded layer runs
its Pallas kernels in interpret mode, as ``tests/test_models.py`` does."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.graph import banded as jbanded
from mini_tpu.models import gat as jgat
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models import gat as tgat

DIMS = [8, 16, 3]
SMALL_TABLE = 128 * 128 * 4  # 128-row bands: a 384-row graph gets K=3
GRAPHS = {1: (80, 500), 3: (300, 2400)}  # bands -> erdos_renyi(n, m)


@functools.lru_cache(maxsize=None)
def setup(bands, seed=4, heads=2):
    """(host graph, JAX slice, port slice, x, JAX params as numpy), the
    params with ``heads`` heads a layer."""
    n, m = GRAPHS[bands]
    kw = dict(seed=seed, undirected=True)
    hg = tg.erdos_renyi(n, m, **kw)
    gj = jg.GraphSlice.from_host(jg.erdos_renyi(n, m, **kw))
    gt = tg.GraphSlice.from_host(hg, device="cpu")
    x = np.random.RandomState(seed).rand(gt.n_pad, DIMS[0]).astype(
        np.float32)
    x[hg.n:] = 0
    params = jgat.gat_init(jax.random.PRNGKey(6), DIMS, heads=heads)
    return hg, gj, gt, x, jax.tree_util.tree_map(np.asarray, params)


def small_bands(mp, bands):
    if bands == 3:
        mp.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
        mp.setattr(jbanded, "FAST_TABLE_BYTES", SMALL_TABLE)


def loss_of(out, n):
    return (out[:n] ** 2).sum()


KEYS = ("w", "a_src", "a_dst")


def flat_grads(tree):
    return [p[k] for p in tree for k in KEYS]


def jax_run(bands, attn, mdt=None, batch_softmax=False, grads=False,
            heads=2):
    """JAX's forward and, with ``grads``, the gradient of sum(out[:n]^2)
    (the loss of tests/test_models.py:123-144), from one trace, cached
    across the tests.  On the CPU JAX's ``auto`` is its fused path."""
    return _jax_run(bands, attn, mdt, batch_softmax, grads, heads)


@functools.lru_cache(maxsize=None)
def _jax_run(bands, attn, mdt, batch_softmax, grads, heads):
    hg, gj, _, x, params_np = setup(bands, heads=heads)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    with pytest.MonkeyPatch.context() as mp:
        small_bands(mp, bands)
        assert jbanded.get_layout(gj, "pull", row_bytes=512).K == bands

        def fwd(p):
            out = jgat.gat_forward(p, gj, jnp.asarray(x), message_dtype=mdt,
                                   batch_softmax=batch_softmax, attn=attn)
            return loss_of(out, hg.n), out

        if not grads:
            return np.asarray(jax.jit(fwd)(params)[1]), None
        (_, out), g = jax.jit(jax.value_and_grad(fwd, has_aux=True))(params)
    return np.asarray(out), flat_grads(jax.tree_util.tree_map(np.asarray, g))


def port_run(monkeypatch, bands, attn, mdt=None, batch_softmax=False,
             heads=2):
    hg, _, gt, x, params_np = setup(bands, heads=heads)
    small_bands(monkeypatch, bands)
    params = tgat.params_from_jax(params_np, device="cpu")
    leaves = [{k: v.requires_grad_() for k, v in p.items()} for p in params]
    out = tgat.gat_forward(leaves, gt, torch.from_numpy(x),
                           message_dtype=mdt, batch_softmax=batch_softmax,
                           attn=attn)
    grads = torch.autograd.grad(loss_of(out, hg.n), flat_grads(leaves))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("bands,attn,batch_softmax", [
    (1, "auto", False), (1, "banded", False), (1, "fused", False),
    (1, "softmax", False), (1, "softmax", True), (3, "banded", False),
    (3, "fused", False),
])
def test_forward_matches_jax_and_oracle(monkeypatch, bands, attn,
                                        batch_softmax):
    hg, _, _, x, params_np = setup(bands)
    # the same trace gives the gradients of the next test
    want, _ = jax_run(bands, "fused" if attn == "auto" else attn,
                      batch_softmax=batch_softmax, grads=not batch_softmax)
    got, _ = port_run(monkeypatch, bands, attn, batch_softmax=batch_softmax)
    assert got.shape == want.shape == (setup(bands)[2].n_pad, DIMS[-1])
    # float32 sums in another order (JAX's banded "split" accumulate is
    # about 1e-5 relative)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # tests/test_models.py:27-28's tolerance against the float64 oracle
    oracle = tgat.gat_forward_cpu(params_np, hg, x)
    np.testing.assert_allclose(got[: hg.n], oracle, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("attn,batch_softmax", [
    ("fused", False), ("softmax", False), ("softmax", True),
])
def test_one_head_matches_jax_and_oracle(monkeypatch, attn, batch_softmax):
    """One head a layer, the blockwise SpMM at H = 1 (its head padded to
    128 columns, the fused path's denominator in the ones column of the
    padding): the forward against JAX's and the float64 oracle at the
    forward test's tolerances, the gradients against JAX's at the
    gradient test's."""
    hg, _, gt, x, params_np = setup(1, heads=1)
    assert all(p["w"].shape[0] == 1 for p in params_np)
    want, want_g = jax_run(1, attn, batch_softmax=batch_softmax,
                           grads=not batch_softmax, heads=1)
    got, got_g = port_run(monkeypatch, 1, attn, batch_softmax=batch_softmax,
                          heads=1)
    assert got.shape == want.shape == (gt.n_pad, DIMS[-1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    oracle = tgat.gat_forward_cpu(params_np, hg, x)
    np.testing.assert_allclose(got[: hg.n], oracle, rtol=1e-3, atol=1e-4)
    for a, b in zip(want_g or (), got_g):
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-5)
    assert sum(float(np.abs(b).sum()) for b in got_g) > 0


@pytest.mark.parametrize("bands", [1, 3])
def test_one_head_banded_backward_matches_fused(monkeypatch, bands):
    """The banded layer's native backward at one head a layer (the SDDMM
    gives one head's weight cotangent as ``[mk]``, not ``[mk, 1]``)
    against autograd through the port's fused path, at the gradient
    test's tolerance; the forwards within the layer-choice test's.  JAX's
    banded backward does not trace at one head, so the port's fused path
    is the reference here."""
    got, got_g = port_run(monkeypatch, bands, "banded", heads=1)
    want, want_g = port_run(monkeypatch, bands, "fused", heads=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert sum(float(np.abs(b).sum()) for b in got_g) > 0
    for a, b in zip(want_g, got_g):
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("bands,attn", [
    (1, "banded"), (3, "banded"), (1, "fused"), (3, "fused"), (1, "softmax"),
])
def test_grads_match_jax(monkeypatch, bands, attn):
    """The banded layer's native backward, and autograd through the fused
    and softmax paths, against JAX's (its native custom VJP, and autodiff
    of its other paths), and against the port's fused path, within
    tests/test_models.py:142-144's tolerance (rtol 5e-3, atol 5e-5: the
    same gradient through another order of float32 operations)."""
    _, want = jax_run(bands, attn, grads=True)
    _, got = port_run(monkeypatch, bands, attn)
    _, fused = port_run(monkeypatch, bands, "fused")
    assert all(np.isfinite(b).all() for b in got)
    assert sum(float(np.abs(b).sum()) for b in got) > 0
    for a, b, c in zip(want, got, fused):
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-5)
        np.testing.assert_allclose(b, c, rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("attn", ["banded", "fused"])
def test_bf16_messages_close_to_f32(monkeypatch, attn):
    """tests/test_models.py:79-88 and :104-120: bf16 messages (scores
    stay float32) within 3e-2 of float32 and of JAX's bf16 path."""
    f32, _ = port_run(monkeypatch, 1, attn)
    b16, g16 = port_run(monkeypatch, 1, attn, mdt=torch.bfloat16)
    np.testing.assert_allclose(b16, f32, rtol=3e-2, atol=3e-2)
    assert not np.array_equal(b16, f32)
    want, _ = jax_run(1, attn, mdt=jnp.bfloat16)
    np.testing.assert_allclose(b16, want, rtol=2e-2, atol=2e-2)
    assert all(np.isfinite(g).all() for g in g16)


def test_segment_softmax_matches_jax():
    """One and two score columns: rows sum to one over real in-edges,
    masked edges 0, equal to JAX's within float32 rounding."""
    hg, gj, gt, _, _ = setup(1)
    rng = np.random.RandomState(1)
    softmax = jax.jit(jgat.segment_softmax_by_dst)
    for shape in ((gt.m_pad,), (gt.m_pad, 2)):
        scores = rng.randn(*shape).astype(np.float32)
        want = np.asarray(softmax(gj, jnp.asarray(scores)))
        got = tgat.segment_softmax_by_dst(gt, torch.from_numpy(scores))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
        mask = gt.edge_mask_csc.numpy()
        assert np.all(got.numpy()[~mask] == 0)
        sums = np.zeros((gt.n_pad,) + shape[1:])
        np.add.at(sums, gt.csc_dsts.numpy(), got.numpy())
        has_in = hg.in_degrees > 0
        np.testing.assert_allclose(sums[: hg.n][has_in], 1.0, rtol=1e-5)


@pytest.mark.parametrize("attn", ["banded", "fused"])
def test_train_steps_match_jax(monkeypatch, attn):
    """Three SGD-momentum steps from the JAX package's params against
    JAX's ``gat_train_step`` with the same ``attn``: loss, params and
    momentum within the gradient tolerance above."""
    hg, gj, gt, x, params_np = setup(1)
    labels = np.random.RandomState(10).randint(0, DIMS[-1], gt.n_pad)
    mask = np.arange(gt.n_pad) < hg.n
    want = []
    with pytest.MonkeyPatch.context():
        pj = jax.tree_util.tree_map(jnp.asarray, params_np)
        oj = jgat.gat_init_opt(pj)
        for _ in range(3):
            pj, oj, lj = jgat.gat_train_step(
                pj, oj, gj, jnp.asarray(x),
                (jnp.asarray(labels), jnp.asarray(mask)), 0.1, 0.2, None,
                attn)
            # copies: the next step donates these buffers
            want.append((float(lj), flat_grads(jax.tree_util.tree_map(
                np.array, pj)), flat_grads(jax.tree_util.tree_map(
                    np.array, oj))))
    pt = tgat.params_from_jax(params_np, device="cpu")
    ot = tgat.gat_init_opt(pt)
    batch = (torch.from_numpy(labels), torch.from_numpy(mask))
    for lj, pj, oj in want:
        pt, ot, lt = tgat.gat_train_step(pt, ot, gt, torch.from_numpy(x),
                                         batch, 0.1, attn=attn)
        np.testing.assert_allclose(float(lt), lj, rtol=1e-5)
        for a, b in zip(flat_grads(pt), pj):
            np.testing.assert_allclose(a.numpy(), b, rtol=5e-3, atol=5e-5)
        for a, b in zip(flat_grads(ot), oj):
            np.testing.assert_allclose(a.numpy(), b, rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("attn", ["auto", "banded"])
def test_train_step_decreases_loss(attn):
    """tests/test_models.py:196-214 on the port's own RNG."""
    hg = tg.erdos_renyi(80, 500, seed=10, undirected=True)
    gs = tg.GraphSlice.from_host(hg, device="cpu")
    x = np.random.RandomState(10).rand(gs.n_pad, 8).astype(np.float32)
    x[hg.n:] = 0
    params = tgat.gat_init(torch.Generator().manual_seed(10), [8, 16, 4],
                           heads=2, device="cpu")
    opt = tgat.gat_init_opt(params)
    lab = torch.from_numpy(np.random.RandomState(10).randint(0, 4, gs.n_pad))
    msk = torch.arange(gs.n_pad) < hg.n
    losses = []
    for _ in range(5):
        params, opt, loss = tgat.gat_train_step(
            params, opt, gs, torch.from_numpy(x), (lab, msk), 0.1, attn=attn)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_init_and_layer_choice(monkeypatch):
    """``gat_init`` shapes and bounds; ``auto`` takes the fused path on
    the CPU and the banded Function only when asked; heads with no spare
    lane and one head take the banded Function too, and match the fused
    path."""
    p1 = tgat.gat_init(torch.Generator().manual_seed(3), DIMS, heads=2,
                       device="cpu")
    p2 = tgat.gat_init(torch.Generator().manual_seed(3), DIMS, heads=2,
                       device="cpu")
    assert [tuple(p["w"].shape) for p in p1] == [(2, 8, 16), (2, 32, 3)]
    assert [tuple(p["a_src"].shape) for p in p1] == [(2, 16), (2, 3)]
    for a, b in zip(p1, p2):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert float(p1[0]["w"].abs().max()) <= np.sqrt(6.0 / (8 + 16))

    hg, _, gt, x, _ = setup(1)
    calls = []
    real = tgat._GatBandedLayer.apply

    def apply(*a):
        # g, d, slope, message dtype, H, then H each of hw, s_src, s_dst:
        # per-vertex tensors only, no a_src vector
        assert len(a) == 5 + 3 * a[4]
        assert all(t.shape[0] == a[0].n_pad for t in a[5:])
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tgat._GatBandedLayer, "apply", apply)
    xt = torch.from_numpy(x)
    tgat.gat_forward(p1, gt, xt)
    assert calls == []
    tgat.gat_forward(p1, gt, xt, attn="banded")
    assert calls == [1, 1]
    # d = 64 with 2 heads leaves no spare lane in the padding: the banded
    # layer's denominators are the weights' sums and need none
    wide = tgat.gat_init(torch.Generator().manual_seed(3), [8, 64], heads=2,
                         device="cpu")
    np.testing.assert_allclose(
        tgat.gat_forward(wide, gt, xt, attn="banded").detach().numpy(),
        tgat.gat_forward(wide, gt, xt, attn="fused").detach().numpy(),
        rtol=1e-5, atol=1e-6)
    assert calls == [1, 1, 1]
    one = tgat.gat_init(torch.Generator().manual_seed(3), [8, 16], heads=1,
                        device="cpu")
    ref = tgat.gat_forward(one, gt, xt, attn="fused")
    np.testing.assert_allclose(
        tgat.gat_forward(one, gt, xt, attn="banded").detach().numpy(),
        ref.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert calls == [1, 1, 1, 1]
    with pytest.raises(ValueError, match="attn"):
        tgat.gat_forward(p1, gt, xt, attn="nope")


@pytest.mark.parametrize("bands", [1, 3])
def test_banded_backward_moves_one_record_table(monkeypatch, bands):
    """The banded backward moves the weights and score cotangents from
    pull to push bands as the rows of one ``[n_comp, 2H]`` table: one
    ``permute_rows`` a layer, run as a gather by the composite rank's
    inverse; its gradients still match JAX's banded (interpret) path at
    tests/test_models.py:142-144's tolerance."""
    calls = []
    real = tgat.permute_rows

    def spy(rank, table, inverse=False, rank_inv=None):
        calls.append((tuple(table.shape), inverse, rank_inv is not None))
        return real(rank, table, inverse=inverse, rank_inv=rank_inv)

    monkeypatch.setattr(tgat, "permute_rows", spy)
    _, want = jax_run(bands, "banded", grads=True)
    _, got = port_run(monkeypatch, bands, "banded")
    gt = setup(bands)[2]
    lp = tbanded.get_layout(gt, "pull", row_bytes=512)
    lb = tbanded.get_layout(gt, "push", row_bytes=512)
    n_comp = max(lp.total_padded, lb.total_padded)
    assert calls == [((n_comp, 4), False, True)] * (len(DIMS) - 1)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-5)
