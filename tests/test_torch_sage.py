"""Port parity: GraphSAGE of ``mini_tpu_torch`` against ``mini_tpu``'s
with the JAX package's parameters carried across (forward, gradients, the
train step), against the float64 oracle ``sage_forward_cpu``, and the JAX
suite's falling-loss oracle on the port's own RNG."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.models import sage as jsage
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models import sage as tsage

DIMS = [8, 16, 4]


@functools.lru_cache(maxsize=None)
def setup(seed=2):
    kw = dict(seed=seed, undirected=False)
    hg = tg.erdos_renyi(300, 2400, **kw)
    gj = jg.GraphSlice.from_host(jg.erdos_renyi(300, 2400, **kw))
    gt = tg.GraphSlice.from_host(hg, device="cpu")
    x = np.random.RandomState(seed).rand(gt.n_pad, DIMS[0]).astype(
        np.float32)
    x[hg.n:] = 0
    params = jsage.sage_init(jax.random.PRNGKey(seed), DIMS)
    return hg, gj, gt, x, jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def jax_forward_and_grads():
    """JAX's ``xla`` forward and the gradient of sum(out[:n]^2)."""
    hg, gj, _, x, params_np = setup()

    def fwd(p):
        out = jsage.sage_forward(p, gj, jnp.asarray(x), impl="xla")
        return jnp.sum(out[: hg.n] ** 2), out

    (_, out), g = jax.value_and_grad(fwd, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_np))
    return np.asarray(out), [np.asarray(p[k]) for p in g for k in ("w", "b")]


@pytest.mark.parametrize("impl,bands", [("xla", 1), ("banded", 1),
                                        ("banded", 3)])
def test_forward_and_grads_match_jax(monkeypatch, impl, bands):
    """Forward against JAX and the float64 oracle (tests/test_models.py's
    rtol 1e-4, atol 1e-5: float32 sums in another order); gradients
    within 1e-3 of the reference's largest entry (tests/test_spmm_banded.py
    :379)."""
    hg, _, gt, x, params_np = setup()
    if bands == 3:  # 128-row bands: the 384-row graph splits into K=3
        monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)
    assert tbanded.get_layout(gt, "pull", row_bytes=512).K == bands
    want, want_g = jax_forward_and_grads()
    leaves = [{k: v.requires_grad_() for k, v in p.items()}
              for p in tsage.params_from_jax(params_np, device="cpu")]
    out = tsage.sage_forward(leaves, gt, torch.from_numpy(x), impl=impl)
    got_g = torch.autograd.grad((out[: hg.n] ** 2).sum(),
                                [p[k] for p in leaves for k in ("w", "b")])
    got = out.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    oracle = tsage.sage_forward_cpu(params_np, hg, x)
    np.testing.assert_allclose(got[: hg.n], oracle, rtol=1e-4, atol=1e-5)
    for a, b in zip(got_g, want_g):
        assert np.abs(a.numpy() - b).max() <= 1e-3 * np.abs(b).max()


@pytest.mark.parametrize("impl", ["xla", "banded"])
def test_train_steps_match_jax(impl):
    """Three SGD-momentum steps against JAX's ``sage_train_step`` (xla):
    loss, params and momentum (tests/test_torch_gcn.py's rtol 1e-4, atol
    1e-6)."""
    hg, gj, gt, x, params_np = setup()
    labels = np.random.RandomState(9).randint(0, DIMS[-1], gt.n_pad)
    mask = np.arange(gt.n_pad) < hg.n
    pj = jax.tree_util.tree_map(jnp.asarray, params_np)
    oj = jsage.sage_init_opt(pj)
    want = []
    for _ in range(3):
        pj, oj, lj = jsage.sage_train_step(
            pj, oj, gj, jnp.asarray(x),
            (jnp.asarray(labels), jnp.asarray(mask)), 0.1, "xla")
        # copies: the next step donates these buffers
        want.append((float(lj), *([np.array(p[k]) for p in tree
                                   for k in ("w", "b")] for tree in (pj, oj))))
    pt = tsage.params_from_jax(params_np, device="cpu")
    ot = tsage.sage_init_opt(pt)
    batch = (torch.from_numpy(labels), torch.from_numpy(mask))
    for lj, pw, ow in want:
        pt, ot, lt = tsage.sage_train_step(pt, ot, gt, torch.from_numpy(x),
                                           batch, 0.1, impl=impl)
        np.testing.assert_allclose(float(lt), lj, rtol=1e-4)
        got = [t[k].numpy() for tree in (pt, ot) for t in tree
               for k in ("w", "b")]
        for a, b in zip(got, pw + ow):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_train_step_decreases_loss():
    """tests/test_models.py:175-193 on the port's own RNG."""
    hg = tg.erdos_renyi(80, 500, seed=9, undirected=True)
    gs = tg.GraphSlice.from_host(hg, device="cpu")
    x = np.random.RandomState(9).rand(gs.n_pad, 8).astype(np.float32)
    x[hg.n:] = 0
    params = tsage.sage_init(torch.Generator().manual_seed(9), [8, 16, 4],
                             device="cpu")
    assert [tuple(p["w"].shape) for p in params] == [(16, 16), (32, 4)]
    opt = tsage.sage_init_opt(params)
    lab = torch.from_numpy(np.random.RandomState(9).randint(0, 4, gs.n_pad))
    msk = torch.arange(gs.n_pad) < hg.n
    losses = []
    for _ in range(5):
        params, opt, loss = tsage.sage_train_step(
            params, opt, gs, torch.from_numpy(x), (lab, msk), 0.1,
            impl="banded")
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
