"""The port's kernels, through their plain torch versions (what a CPU
tensor runs), against the JAX package's Pallas twins in interpret mode, on
the same arrays at n_pad=256 to 512.  The CUDA kernels themselves are
compared with these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_tpu.ops.pallas.segreduce_kernel import segment_reduce_pallas
from mini_tpu.ops.pallas.spmm_banded import (
    banded_sddmm as jax_banded_sddmm,
    banded_segment_sum as jax_banded_segment_sum,
)
from mini_tpu.ops.pallas.spmm_kernel import segment_sum_pallas
from mini_tpu_torch.graph import GraphSlice, erdos_renyi, from_edges
from mini_tpu_torch.graph.banded import build_banded_layout
from mini_tpu_torch.ops.kernels import refuse_grad
from mini_tpu_torch.ops.kernels import spmm_kernel as k4
from mini_tpu_torch.ops.kernels.segreduce_kernel import segment_reduce_plain
from mini_tpu_torch.ops.kernels.spmm_banded import (
    banded_sddmm,
    banded_sddmm_plain,
    banded_segment_sum_plain,
)

N_PAD, M_PAD = 256, 1024


def _segments(seed):
    """Hub-heavy sorted segment ids (one vertex owns half the values) with
    empty segments, and their offsets."""
    rng = np.random.RandomState(seed)
    parts = np.concatenate(
        [np.full(M_PAD // 2, 17), rng.randint(0, N_PAD, M_PAD // 2)]
    )
    dsts = np.sort(parts).astype(np.int32)
    offsets = np.searchsorted(dsts, np.arange(N_PAD + 1)).astype(np.int32)
    assert (np.diff(offsets) == 0).any()  # empty segments are covered
    return rng, offsets, dsts


@pytest.mark.parametrize("op,dtype", [
    ("min", np.int32), ("max", np.int32), ("sum", np.int32),
    ("bor", np.int32), ("min", np.float32), ("max", np.float32),
    ("sum", np.float32),
])
def test_segment_reduce_plain_matches_pallas(op, dtype):
    rng, offsets, dsts = _segments(seed=11)
    if dtype == np.float32:
        vals = (rng.rand(M_PAD) * 100 - 50).astype(dtype)
    else:
        vals = rng.randint(-2**31, 2**31 - 1, M_PAD, dtype=np.int64
                           ).astype(dtype)
    want = np.asarray(segment_reduce_pallas(
        jnp.asarray(offsets), jnp.asarray(dsts), jnp.asarray(vals), op,
        interpret=True,
    ))
    got = segment_reduce_plain(
        torch.from_numpy(offsets), torch.from_numpy(dsts),
        torch.from_numpy(vals), op,
    ).numpy()
    assert got.dtype == want.dtype
    if op == "sum" and dtype == np.float32:
        # the same terms summed in another order (float64 vs float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)  # bitwise


@pytest.fixture(scope="module")
def two_band_layout():
    """A 256-row graph cut into 2 bands of 128 rows (pull layout)."""
    hg = erdos_renyi(200, 1200, seed=3, undirected=True, weighted=True)
    gs = GraphSlice.from_host(hg, device="cpu")
    lay = build_banded_layout(
        gs.col_offsets.numpy(), gs.csc_srcs.numpy(), gs.csc_weights.numpy(),
        gs.edge_mask_csc.numpy(), 128, "pull",
    )
    assert lay.K == 2 and lay.n_pad == N_PAD
    rng = np.random.RandomState(4)
    x = rng.rand(N_PAD, 128).astype(np.float32) - 0.5
    msgs = [
        x[k * 128:(k + 1) * 128][lay.ids[k]] * lay.weights[k][:, None]
        for k in range(lay.K)
    ]
    return lay, msgs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_segment_sum_plain_matches_pallas(two_band_layout, dtype):
    lay, msgs = two_band_layout
    offs2d = np.ascontiguousarray(lay.offs2d.transpose(1, 0, 2))
    jm = [jnp.asarray(m).astype(dtype) for m in msgs]
    want = np.asarray(jax_banded_segment_sum(
        jnp.asarray(lay.bounds), jnp.asarray(offs2d), jm,
        precision="highest", interpret=True,
    ))
    tm = [torch.from_numpy(np.array(m.astype(jnp.float32)))
          .to(getattr(torch, dtype)) for m in jm]
    got = banded_segment_sum_plain(
        torch.from_numpy(lay.bounds), torch.from_numpy(offs2d), tm,
        precision="highest",
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    # f32 sums of identical terms in another order
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def _pull_layout(hg, band_rows):
    gs = GraphSlice.from_host(hg, device="cpu")
    return build_banded_layout(
        gs.col_offsets.numpy(), gs.csc_srcs.numpy(), gs.csc_weights.numpy(),
        gs.edge_mask_csc.numpy(), band_rows, "pull",
    )


def _star_hub_layout():
    """The hub graph of tests/test_spmm_banded.py:225-268: vertex 0 takes
    3000 in-edges, so whole 512-edge chunks lie in its segment (the twin's
    "pure chunk" path); 512 rows in 2 bands."""
    rng = np.random.RandomState(0)
    n = 400
    srcs = np.concatenate([rng.randint(1, n, 3000), rng.randint(0, n, 1500)])
    dsts = np.concatenate([np.zeros(3000, np.int64),
                           rng.randint(0, n, 1500)])
    w = rng.rand(srcs.shape[0]).astype(np.float32) + 0.5
    lay = _pull_layout(from_edges(srcs, dsts, w, num_nodes=n,
                                  make_undirected=True), 256)
    assert lay.K == 2 and max(np.diff(lay.offsets[0])) > 512
    return lay


@pytest.mark.parametrize("graph", ["two_band", "star_hub"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_sddmm_plain_matches_pallas(two_band_layout, graph, dtype):
    lay = two_band_layout[0] if graph == "two_band" else _star_hub_layout()
    rng = np.random.RandomState(5)
    x = rng.rand(lay.n_pad, 128).astype(np.float32) - 0.5
    y = rng.rand(lay.n_pad, 128).astype(np.float32) - 0.5
    bands = [x[k * lay.band_rows:(k + 1) * lay.band_rows][lay.ids[k]]
             for k in range(lay.K)]
    offs2d = np.ascontiguousarray(lay.offs2d.transpose(1, 0, 2))
    # bf16 messages meet bf16 rows, as sddmm(impl="banded") passes them
    jm = [jnp.asarray(b).astype(dtype) for b in bands]
    jy = jnp.asarray(y).astype(dtype)
    want = np.asarray(jax_banded_sddmm(
        jnp.asarray(lay.bounds), jnp.asarray(offs2d), jm, jy,
        precision="split", interpret=True,
    ))

    def tt(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            getattr(torch, dtype))

    args = (torch.from_numpy(lay.bounds), torch.from_numpy(offs2d))
    got = banded_sddmm_plain(*args, [tt(m) for m in jm], tt(jy)).numpy()
    mag = banded_sddmm_plain(*args, [tt(m).abs() for m in jm],
                             tt(jy).abs()).numpy() + 1e-6
    assert got.dtype == np.float32 and got.shape == want.shape
    # the twin's "split" is a 3-pass bf16 product (test_spmm_banded.py:315)
    assert (np.abs(got - want) / mag).max() < 1e-4
    # every slot past a band's end is 0 in both; every real slot is a dot
    base, real = 0, np.zeros(got.shape, bool)
    for k in range(lay.K):
        real[base:base + lay.bounds[k, -1]] = True
        base += len(lay.ids[k])
    assert np.all(got[~real] == 0) and np.all(want[~real] == 0)
    assert np.all(mag[real] > 1e-6)


def test_banded_sddmm_wrapper_takes_plain_on_cpu(two_band_layout):
    lay, msgs = two_band_layout
    args = (torch.from_numpy(lay.bounds),
            torch.from_numpy(np.ascontiguousarray(lay.offs2d.transpose(1, 0,
                                                                       2))))
    tm = [torch.from_numpy(m) for m in msgs]
    y = torch.rand(lay.n_pad, 128, generator=torch.Generator().manual_seed(0))
    got = banded_sddmm(*args, tm, y)
    assert torch.equal(got, banded_sddmm_plain(*args, tm, y))
    with pytest.raises(ValueError, match="y is"):
        banded_sddmm(*args, tm, y[:, :64])
    # "fast" rounds both sides to bf16
    fast = banded_sddmm(*args, tm, y, precision="fast")
    assert torch.equal(fast, banded_sddmm_plain(
        *args, [m.bfloat16() for m in tm], y.bfloat16()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_plain_matches_pallas(dtype):
    """tests/test_pallas_kernel.py:65's boundary shapes: empty rows, a hub
    spanning many 128-edge chunks and the ghost tail."""
    n_pad, F = 256, 128
    hub_edges = 3 * k4.EDGE_CHUNK + 17
    m_pad = ((hub_edges + 5) + 127) // 128 * 128
    dsts = np.full(m_pad, n_pad - 1, np.int32)  # pad tail at ghost
    dsts[:hub_edges] = 7
    dsts[hub_edges:hub_edges + 5] = 9
    offsets = np.searchsorted(dsts, np.arange(n_pad + 1)).astype(np.int32)
    offsets[-1] = m_pad
    msgs = np.random.RandomState(1).rand(m_pad, F).astype(np.float32)
    jm = jnp.asarray(msgs).astype(dtype)
    want = np.asarray(segment_sum_pallas(
        jnp.asarray(offsets), jnp.asarray(dsts), jm, interpret=True))
    tm = torch.from_numpy(np.array(jm.astype(jnp.float32))).to(
        getattr(torch, dtype))
    args = (torch.from_numpy(offsets), torch.from_numpy(dsts), tm)
    got = k4.segment_sum_plain(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    before = k4.launches
    assert torch.equal(k4.segment_sum(*args), got)  # the wrapper on CPU
    assert k4.launches == before
    # f32 sums of identical terms in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[:7] == 0) and np.all(got.numpy()[10:-1] == 0)
    with pytest.raises(ValueError):  # the twin's m_pad % 128
        k4.segment_sum(args[0], args[1], tm[:-1])


def test_refuse_grad():
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3)
    refuse_grad("k", b)  # nothing requires grad
    with pytest.raises(RuntimeError, match="cannot carry gradients"):
        refuse_grad("k", b, a)
    with torch.no_grad():
        refuse_grad("k", a)

    class Double(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            refuse_grad("k", x)  # grad mode is off in forward
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    (g,) = torch.autograd.grad(Double.apply(a).sum(), (a,))
    assert torch.equal(g, torch.full((3,), 2.0))
