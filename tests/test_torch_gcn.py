"""Port parity: the GCN forward of ``mini_tpu_torch`` against
``mini_tpu``'s (``impl="xla"``) and the float64 oracle
``gcn_forward_cpu``, with the JAX package's parameters carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
import mini_tpu.models.gcn as jgcn
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models.gcn import (
    gcn_forward,
    gcn_forward_cpu,
    gcn_init,
    gcn_normalize,
    params_from_jax,
)

DIMS = [32, 64, 8]


def graphs():
    args = (300, 2400)
    kw = dict(seed=0, undirected=True)
    hj, ht = jg.erdos_renyi(*args, **kw), tg.erdos_renyi(*args, **kw)
    return hj, ht, jg.GraphSlice.from_host(hj), tg.GraphSlice.from_host(ht)


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
    assert len(nt.banded_pull) == len(nj.banded_pull)
    for a, b in zip(nj.banded_pull, nt.banded_pull):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2.4e-7,
                                   atol=0)


@pytest.mark.parametrize("impl,bands", [
    ("xla", 1), ("banded", 1), ("banded", 3),
])
def test_gcn_forward_matches(setup, monkeypatch, impl, bands):
    ht, gt, params_np, x, want, oracle = setup
    if bands == 3:  # 128-row bands: the 384-row graph splits into K=3
        monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 128 * 128 * 4)
    norm = gcn_normalize(gt)
    assert len(norm.banded_pull) == bands
    out = gcn_forward(params_from_jax(params_np), gt, norm,
                      torch.from_numpy(x), impl=impl)
    assert out.dtype == torch.float32 and out.shape == want.shape
    # the tolerance of tests/test_gcn.py: float32 sums in another order
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy()[: ht.n], oracle, rtol=1e-4,
                               atol=1e-5)


def test_gcn_forward_bf16_messages(setup):
    ht, gt, params_np, x, want, _ = setup
    norm = gcn_normalize(gt)
    params = params_from_jax(params_np)
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
    p1 = gcn_init(torch.Generator().manual_seed(3), DIMS)
    p2 = gcn_init(torch.Generator().manual_seed(3), DIMS)
    assert [tuple(p["w"].shape) for p in p1] == [(32, 64), (64, 8)]
    for a, b, (fi, fo) in zip(p1, p2, zip(DIMS[:-1], DIMS[1:])):
        assert torch.equal(a["w"], b["w"])
        assert float(a["w"].abs().max()) <= np.sqrt(6.0 / (fi + fo))
        assert not a["b"].any()
