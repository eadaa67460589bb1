"""Port parity: the banded SpMM's backward (the x-gradient is the
opposite-direction SpMM, the weight gradient the banded SDDMM), ``sddmm``
and the ``pallas_onehot`` route of ``mini_tpu_torch`` against
``mini_tpu``'s on the same inputs.  On the CPU every kernel wrapper runs
its plain version; the JAX banded path runs its Pallas kernels in
interpret mode."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.graph import banded as jbanded
from mini_tpu.ops.pallas.spmm_kernel import spmm_pallas as jspmm_pallas
from mini_tpu.ops.spmm import _spmm_banded as j_spmm_banded
from mini_tpu.ops.spmm import _weight_cotangent as j_weight_cotangent
from mini_tpu.ops.spmm import sddmm as jsddmm
from mini_tpu.ops.spmm import spmm as jspmm
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.ops.spmm import sddmm as tsddmm
from mini_tpu_torch.ops.spmm import spmm as tspmm

tspmm_mod = sys.modules["mini_tpu_torch.ops.spmm"]

GRAPHS = {  # name -> erdos_renyi(n, m, undirected)
    "undirected": (300, 2400, True),
    "directed": (300, 2500, False),
}
SMALL_TABLE = 128 * 128 * 4  # 128-row bands: the 384-row graphs get K=3


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX GraphSlice, port GraphSlice) of the same weighted graph."""
    n, m, und = GRAPHS[name]
    kw = dict(seed=9, undirected=und, weighted=True)
    return (jg.GraphSlice.from_host(jg.erdos_renyi(n, m, **kw)),
            tg.GraphSlice.from_host(tg.erdos_renyi(n, m, **kw), device="cpu"))


def inputs(g, seed=1):
    rng = np.random.RandomState(seed)
    x = (rng.rand(g.n_pad, 128) - 0.5).astype(np.float32)
    w = (rng.rand(g.m_pad) + 0.5).astype(np.float32)
    return x, w


def small_bands(monkeypatch, bands):
    if bands == 3:
        monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
        monkeypatch.setattr(jbanded, "FAST_TABLE_BYTES", SMALL_TABLE)


@functools.lru_cache(maxsize=None)
def jax_grads(name, bands, direction):
    """jax.grad of sum(sin(spmm)) with respect to (x, w), through JAX's
    banded custom VJP (Pallas in interpret mode) and through ``xla``."""
    gj, _ = pair(name)
    x, w = map(jnp.asarray, inputs(gj))
    with pytest.MonkeyPatch.context() as mp:
        small_bands(mp, bands)
        assert jbanded.get_layout(gj, direction, row_bytes=512).K == bands

        def loss(args, banded):
            xx, ww = args
            if banded:
                out = j_spmm_banded(gj, xx, direction, ww, None, "split",
                                    True)
            else:
                out = jspmm(gj, xx, direction=direction, weights=ww,
                            impl="xla")
            return jnp.sum(jnp.sin(out))

        return tuple(
            tuple(np.asarray(a) for a in jax.grad(loss)((x, w), banded))
            for banded in (True, False)
        )


def close(got, want):
    """tests/test_spmm_banded.py:376-379's bound: max abs error within
    1e-3 of the reference's largest entry."""
    scale = np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() / scale < 1e-3


@pytest.mark.parametrize("wrt", ["x", "w", "xw"])
@pytest.mark.parametrize("name,bands,direction", [
    ("undirected", 1, "pull"), ("undirected", 3, "pull"),
    ("directed", 1, "pull"), ("directed", 3, "pull"),
    ("directed", 3, "push"),
])
def test_banded_grads_match_jax(monkeypatch, name, bands, direction, wrt):
    want_banded, want_xla = jax_grads(name, bands, direction)
    small_bands(monkeypatch, bands)
    _, gt = pair(name)
    x_np, w_np = inputs(gt)
    x = torch.from_numpy(x_np).requires_grad_("x" in wrt)
    w = torch.from_numpy(w_np).requires_grad_("w" in wrt)
    out = tspmm(gt, x, direction, weights=w, impl="banded")
    leaves = [t for t in (x, w) if t.requires_grad]
    got = torch.autograd.grad(torch.sin(out).sum(), leaves)
    idx = [i for i, c in enumerate("xw") if c in wrt]
    for gr, i in zip(got, idx):
        close(gr.numpy(), want_banded[i])
        close(gr.numpy(), want_xla[i])
    if "w" in wrt:  # masked (pad) edges get exactly 0
        mask = gt.edge_mask_csc if direction == "pull" else gt.edge_mask
        assert torch.all(got[-1][~mask] == 0)
        assert got[-1].abs().max() > 0


def test_weight_grad_only_when_asked(monkeypatch):
    """The SDDMM runs only for a weight that requires grad: GCN's weights
    are constants, and its step must not pay for their cotangent."""
    _, gt = pair("undirected")
    x_np, w_np = inputs(gt)
    calls = []
    real = tspmm_mod.banded_sddmm
    monkeypatch.setattr(tspmm_mod, "banded_sddmm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(x_np).requires_grad_()
    w = torch.from_numpy(w_np)
    torch.autograd.grad(tspmm(gt, x, weights=w, impl="banded").sum(), (x,))
    assert calls == []
    w.requires_grad_()
    torch.autograd.grad(tspmm(gt, x, weights=w, impl="banded").sum(), (w,))
    assert calls == [1]


def test_prebanded_weights_backward():
    """Pre-banded weights need their opposite-direction copy for dx, as in
    JAX (spmm.py:299-302); with it, dx matches the ``xla`` path."""
    _, gt = pair("directed")
    x_np, w_np = inputs(gt)
    w = torch.where(gt.edge_mask_csc, torch.from_numpy(w_np), 0)
    lp = tbanded.get_layout(gt, "pull", row_bytes=512)
    lb = tbanded.get_layout(gt, "push", row_bytes=512)
    w_f = lp.permute_to_bands(w)
    w_b = lb.permute_to_bands(w[gt.csr_to_csc_rank.long()])
    x = torch.from_numpy(x_np).requires_grad_()
    out = tspmm(gt, x, weights_banded=w_f, impl="banded")
    with pytest.raises(NotImplementedError, match="opposite-direction"):
        torch.autograd.grad(out.sum(), (x,))
    (got,) = torch.autograd.grad(
        torch.sin(tspmm(gt, x, weights_banded=w_f, weights_banded_bwd=w_b,
                        impl="banded")).sum(), (x,))
    (want,) = torch.autograd.grad(
        torch.sin(tspmm(gt, x, weights=w, impl="xla")).sum(), (x,))
    close(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="heads"):  # scalar weights
        tspmm(gt, x, weights=w, heads=2)


@pytest.mark.parametrize("bands", [1, 3])
def test_sddmm_matches_jax(monkeypatch, bands):
    small_bands(monkeypatch, bands)
    gj, gt = pair("directed")
    rng = np.random.RandomState(6)
    xl = (rng.rand(gt.n_pad, 128) - 0.5).astype(np.float32)
    xr = (rng.rand(gt.n_pad, 128) - 0.5).astype(np.float32)
    for order in ("csr", "csc"):
        want = np.asarray(jsddmm(gj, jnp.asarray(xl), jnp.asarray(xr),
                                 order=order, impl="banded", interpret=True))
        want_xla = np.asarray(jsddmm(gj, jnp.asarray(xl), jnp.asarray(xr),
                                     order=order, impl="xla"))
        mag = np.asarray(jsddmm(gj, jnp.abs(jnp.asarray(xl)),
                                jnp.abs(jnp.asarray(xr)), order=order,
                                impl="xla")) + 1e-6
        for impl in ("banded", "xla"):
            got = tsddmm(gt, torch.from_numpy(xl), torch.from_numpy(xr),
                         order=order, impl=impl).numpy()
            assert got.shape == want.shape
            # tests/test_spmm_banded.py:321-331's bound
            for ref in (want, want_xla):
                assert (np.abs(got - ref) / mag).max() < 1e-4, (order, impl)
        mask = (gt.edge_mask if order == "csr" else gt.edge_mask_csc).numpy()
        assert np.all(got[~mask] == 0)
    # F off the lane width, and one operand for both sides
    x = torch.from_numpy(xl[:, :40])
    np.testing.assert_allclose(
        tsddmm(gt, x, impl="banded").numpy(),
        tsddmm(gt, x, impl="xla").numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_onehot_matches_jax(dtype):
    gj, gt = pair("directed")
    x_np, _ = inputs(gt, seed=3)
    jx = jnp.asarray(x_np).astype(dtype)
    want = np.asarray(jspmm_pallas(gj.col_offsets, gj.csc_srcs,
                                   gj.csc_weights, jx, seg_ids=gj.csc_dsts,
                                   interpret=True))
    x = torch.from_numpy(x_np).to(getattr(torch, dtype))
    got = tspmm(gt, x, impl="pallas_onehot")
    assert got.dtype == torch.float32
    # the same terms summed in another order (tests/test_pallas_kernel.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for direction in ("pull", "push"):
        ref = tspmm(gt, x.float(), direction, impl="xla")
        np.testing.assert_allclose(
            tspmm(gt, x.float(), direction, impl="pallas_onehot").numpy(),
            ref.numpy(), rtol=1e-5, atol=1e-4)
    # impl="pallas" is the JAX package's alias of banded
    assert torch.equal(tspmm(gt, x, impl="pallas"),
                       tspmm(gt, x, impl="banded"))


# -- heads > 1: GAT's blockwise form -----------------------------------------

HEAD_CASES = [("undirected", 1, "pull", 2), ("directed", 3, "pull", 2),
              ("directed", 3, "push", 4)]


def heads_inputs(g, H, seed=11):
    rng = np.random.RandomState(seed)
    x = (rng.rand(g.n_pad, 128) - 0.5).astype(np.float32)
    w = (rng.rand(g.m_pad, H) + 0.5).astype(np.float32)
    return x, w


@functools.lru_cache(maxsize=None)
def jax_heads(name, bands, direction, H):
    """JAX's multi-head SpMM and the gradient of sum(sin(.)) in (x, w),
    banded (Pallas in interpret mode) and ``xla``."""
    gj, _ = pair(name)
    x, w = map(jnp.asarray, heads_inputs(gj, H))
    with pytest.MonkeyPatch.context() as mp:
        small_bands(mp, bands)

        def run(args, impl):
            xx, ww = args
            if impl == "banded":
                return j_spmm_banded(gj, xx, direction, ww, None, "split",
                                     True, heads=H)
            return jspmm(gj, xx, direction=direction, weights=ww,
                         impl="xla", heads=H)

        out = {}
        for impl in ("banded", "xla"):
            def loss(a):
                y = run(a, impl)
                return jnp.sum(jnp.sin(y)), y

            (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                (x, w))
            out[impl] = (np.asarray(y), *map(np.asarray, grads))
        return out


@pytest.mark.parametrize("impl", ["banded", "xla"])
@pytest.mark.parametrize("name,bands,direction,H", HEAD_CASES)
def test_heads_spmm_matches_jax(monkeypatch, name, bands, direction, H,
                                impl):
    """Forward, dx and dw of ``spmm(heads=H)`` against JAX's banded and
    ``xla`` forms: forward within 1e-4 of the reference's largest entry
    (JAX's ``split`` keeps about 1e-5 relative), gradients within
    ``close``'s 1e-3."""
    want = jax_heads(name, bands, direction, H)
    small_bands(monkeypatch, bands)
    _, gt = pair(name)
    x_np, w_np = heads_inputs(gt, H)
    x = torch.from_numpy(x_np).requires_grad_()
    w = torch.from_numpy(w_np).requires_grad_()
    out = tspmm(gt, x, direction, weights=w, impl=impl, heads=H)
    assert out.shape == (gt.n_pad, 128)
    got = (out.detach().numpy(),
           *torch.autograd.grad(torch.sin(out).sum(), (x, w)))
    for ref in want.values():
        scale = np.abs(ref[0]).max()
        assert np.abs(got[0] - ref[0]).max() <= 1e-4 * scale
        for gr, r in zip(got[1:], ref[1:]):
            close(gr.numpy(), r)
    mask = gt.edge_mask_csc if direction == "pull" else gt.edge_mask
    assert torch.all(got[2][~mask] == 0)


@pytest.mark.parametrize("bands,H", [(1, 2), (3, 2), (3, 4)])
def test_heads_weight_cotangent_matches_jax(monkeypatch, bands, H):
    """Kernel 3 with heads (one pass, each head over its own columns)
    against JAX's per-head padded passes (``spmm.py:224-243``, Pallas in
    interpret mode), and against the H=1 kernel on each head's column
    block, per slot."""
    small_bands(monkeypatch, bands)
    gj, gt = pair("directed")
    lj = jbanded.get_layout(gj, "pull", row_bytes=512)
    lt = tbanded.get_layout(gt, "pull", row_bytes=512)
    rng = np.random.RandomState(H)
    x = (rng.rand(gt.n_pad, 128) - 0.5).astype(np.float32)
    go = (rng.rand(gt.n_pad, 128) - 0.5).astype(np.float32)
    want = jax.jit(lambda a, b: j_weight_cotangent(
        a, b, lj, "split", True, heads=H))(jnp.asarray(x), jnp.asarray(go))
    got = tspmm_mod._weight_cotangent(torch.from_numpy(x),
                                      torch.from_numpy(go), lt, "split",
                                      heads=H)
    d = 128 // H
    assert len(got) == lt.K
    for k, (a, b) in enumerate(zip(want, got)):
        assert b.shape == (len(lt.ids[k]), H)
        # tests/test_spmm_banded.py:321-331's bound: 1e-4 of magnitude
        mag = np.abs(np.asarray(a)).max() + 1e-6
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-4 * mag
    for h in range(H):
        blk = tspmm_mod._weight_cotangent(
            torch.from_numpy(np.ascontiguousarray(x[:, h * d:(h + 1) * d])),
            torch.from_numpy(np.ascontiguousarray(go[:, h * d:(h + 1) * d])),
            lt, "split")
        for b, ref in zip(got, blk):
            assert torch.equal(b[:, h], ref)


@pytest.mark.parametrize("H", [1, 2])
def test_sddmm_plain_empty_band(H):
    """A band with no real slot (rmat16's third band at F=128 holds only
    pad slots) gives zeros, with and without heads; the other band's
    slots are its row's dot products."""
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    rng = np.random.RandomState(H)
    bounds = torch.tensor([[0, 300], [0, 0]], dtype=torch.int32)
    offs = np.zeros((1, 2, 128), np.int32)
    offs[0, 0] = np.sort(rng.randint(0, 300, 128))
    offs[0, 0, 0] = 0
    offs2d = torch.from_numpy(offs)
    msgs = [torch.from_numpy(rng.randn(512, 8).astype(np.float32))
            for _ in range(2)]
    y = torch.from_numpy(rng.randn(128, 8).astype(np.float32))
    out = k2.banded_sddmm_plain(bounds, offs2d, msgs, y, heads=H)
    assert out.shape == ((1024,) if H == 1 else (1024, H))
    assert torch.all(out[300:] == 0)
    ends = np.append(offs[0, 0, 1:], 300)
    rows = np.repeat(np.arange(128), ends - offs[0, 0])
    prod = (y.numpy()[rows] * msgs[0].numpy()[:300]).reshape(300, H, -1)
    np.testing.assert_allclose(out[:300].numpy().reshape(300, H),
                               prod.sum(-1), rtol=1e-5, atol=1e-6)


def test_heads_pallas_onehot_raises():
    """The one-band route takes scalar weights: with heads it raises
    rather than running another route under its name."""
    _, gt = pair("directed")
    x_np, w_np = heads_inputs(gt, 2)
    with pytest.raises(ValueError, match="pallas_onehot"):
        tspmm(gt, torch.from_numpy(x_np), weights=torch.from_numpy(w_np),
              impl="pallas_onehot", heads=2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64"])
def test_banded_weights_of_any_dtype(monkeypatch, dtype):
    """Edge weights that are not float32 go through the band permutes
    unchanged and are cast with the messages: the banded SpMM and its
    weight gradient equal those of the same weights in float32."""
    small_bands(monkeypatch, 3)
    _, gt = pair("directed")
    x_np, w_np = inputs(gt, seed=4)
    x = torch.from_numpy(x_np)
    w = torch.from_numpy(w_np).to(getattr(torch, dtype)).requires_grad_()
    w32 = w.detach().float().requires_grad_()
    outs = [tspmm(gt, x, weights=v, impl="banded") for v in (w, w32)]
    assert torch.equal(outs[0], outs[1])
    grads = [torch.autograd.grad(torch.sin(o).sum(), (v,))[0]
             for o, v in zip(outs, (w, w32))]
    assert grads[0].dtype == w.dtype
    assert torch.equal(grads[0], grads[1].to(w.dtype))
