"""The port's kernels, through their plain torch versions (what a CPU
tensor runs), against the JAX package's Pallas twins in interpret mode, on
the same arrays at n_pad=256.  The CUDA kernels themselves are compared
with these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_tpu.ops.pallas.segreduce_kernel import segment_reduce_pallas
from mini_tpu.ops.pallas.spmm_banded import (
    banded_segment_sum as jax_banded_segment_sum,
)
from mini_tpu_torch.graph import GraphSlice, erdos_renyi
from mini_tpu_torch.graph.banded import build_banded_layout
from mini_tpu_torch.ops.kernels.segreduce_kernel import segment_reduce_plain
from mini_tpu_torch.ops.kernels.spmm_banded import banded_segment_sum_plain

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
    gs = GraphSlice.from_host(hg)
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
