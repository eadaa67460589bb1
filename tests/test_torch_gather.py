"""Port parity: ``gather_rows``, the Hopper form of the TPU row gathers of
``scratch/probe_dma_gather.py``, ``scratch/probe_dma_bisect.py`` and
``scratch/probe_hbm_and_gather.py``, against those Pallas kernels run in
interpret mode (loaded by path) and their NumPy references, bitwise.  On
the CPU the wrapper runs its plain version; the band gathers of the banded
SpMM go through it."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import mini_tpu.graph as jg
from mini_tpu.ops.spmm import _gather_bands as j_gather_bands
import mini_tpu_torch.graph as tg
from mini_tpu_torch.ops.kernels import gather_rows as kg
from mini_tpu_torch.ops.spmm import _gather_bands as t_gather_bands

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe(name):
    """A scratch probe module, loaded from its file (scratch/ is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scratch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gather(table_np, idx_np):
    return kg.gather_rows(torch.from_numpy(table_np),
                          torch.from_numpy(idx_np)).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["dma_gather", "dma_gather_idxdma"])
def test_matches_probe_dma_gather(variant, dtype):
    """Row 5 (``probe_dma_gather.py:66,123``) at a cut shape: M = 2
    chunks of 512 rows from a 256-row table."""
    mod = probe("probe_dma_gather")
    rng = np.random.RandomState(0)
    table = rng.randn(256, 128).astype(np.float32)
    idx = rng.randint(0, 256, 1024).astype(np.int32)
    jt = jnp.asarray(table).astype(dtype)
    kw = dict(chunk=512, q=8, interpret=True)
    if variant == "dma_gather":
        kw["g"] = 1
    want = np.asarray(getattr(mod, variant)(jnp.asarray(idx), jt, **kw)
                      .astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = kg.gather_rows(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype and got.shape == (1024, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy(),
                                  tt.float().numpy()[idx])


@pytest.mark.parametrize("kern,prefetch", [
    ("kern_direct", False), ("kern_scratch", False),
    ("kern_prefetch_direct", True), ("kern_prefetch_scratch", True),
])
def test_matches_probe_dma_bisect(kern, prefetch):
    """Row 6 (``probe_dma_bisect.py:100``): the four DMA variants at the
    probe's own shape, idx [2048], table f32 [1024, 128], built as its
    ``main`` builds them, and its NumPy reference (``:106``)."""
    mod = probe("probe_dma_bisect")
    M, T, C, F = 2048, 1024, mod.CHUNK, mod.F
    rng = np.random.RandomState(0)
    table = rng.randn(T, F).astype(np.float32)
    idx = rng.randint(0, T, M).astype(np.int32)
    scratch = [pltpu.SemaphoreType.DMA((mod.Q,))]
    if "scratch" in kern:
        scratch.insert(0, pltpu.VMEM((C, F), jnp.float32))
    out_shape = jax.ShapeDtypeStruct((M, F), jnp.float32)
    if prefetch:
        spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(M // C,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((C, F), lambda i, ix: (i, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=scratch)
        call = pl.pallas_call(getattr(mod, kern), grid_spec=spec,
                              out_shape=out_shape, interpret=True)
    else:
        call = pl.pallas_call(
            getattr(mod, kern), grid=(M // C,),
            in_specs=[pl.BlockSpec((C,), lambda i: (i,),
                                   memory_space=pltpu.SMEM),
                      pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((C, F), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=scratch, out_shape=out_shape, interpret=True)
    want = np.asarray(call(jnp.asarray(idx), jnp.asarray(table)))
    got = gather(table, idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[idx])


@pytest.mark.parametrize("W,C", [(512, 512), (2048, 2048), (8192, 8192),
                                 (2048, 512)])
def test_matches_probe_dyn_gather(W, C):
    """Row 7 (``probe_hbm_and_gather.py:55``): the in-kernel
    ``take_along_axis`` gather, rebuilt as the probe builds it (its kernel
    is local to ``dyn_gather``), at each of the probe's shapes, and its
    NumPy reference (``:81``)."""

    def kernel(idx_ref, tab_ref, out_ref):
        idx_full = jnp.broadcast_to(idx_ref[:], out_ref.shape)
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_full, axis=0)

    table = np.arange(W * 128, dtype=np.float32).reshape(W, 128)
    idx = np.random.RandomState(0).randint(0, W, size=(C, 1)).astype(
        np.int32)
    got = gather(table, idx[:, 0])
    np.testing.assert_array_equal(got, table[idx[:, 0]])
    if C <= 2048:  # the interpreted take_along_axis grows as W x C
        want = np.asarray(pl.pallas_call(
            kernel,
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((C, 128), jnp.float32),
            interpret=True,
        )(jnp.asarray(idx), jnp.asarray(table)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("F,dtype", [(128, torch.float32), (40, torch.float32),
                                     (3, torch.bfloat16), (5, torch.int32)])
def test_plain_on_cpu_any_width(F, dtype):
    """The wrapper takes the plain version for CPU tensors (no launch is
    counted), at any width and dtype; bad arguments raise."""
    rng = np.random.RandomState(F)
    table = torch.from_numpy(rng.randn(300, F).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.randint(0, 300, 777).astype(np.int32))
    before = kg.launches
    got = kg.gather_rows(table, idx)
    assert kg.launches == before
    assert torch.equal(got, table[idx.long()])
    assert torch.equal(got, kg.gather_rows_plain(table, idx))
    with pytest.raises(TypeError):
        kg.gather_rows(table, idx.long())
    with pytest.raises(ValueError):
        kg.gather_rows(table[:, None], idx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_band_gathers_match_jax(monkeypatch, direction, dtype):
    """The banded SpMM's K band gathers (K=3 at 128-row bands) equal
    JAX's, bitwise."""
    from mini_tpu.graph import banded as jbanded
    from mini_tpu_torch.graph import banded as tbanded

    small = 128 * 128 * 4
    monkeypatch.setattr(jbanded, "FAST_TABLE_BYTES", small)
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", small)
    kw = dict(seed=4, undirected=False, weighted=True)
    gj = jg.GraphSlice.from_host(jg.erdos_renyi(300, 2500, **kw))
    gt = tg.GraphSlice.from_host(tg.erdos_renyi(300, 2500, **kw), device="cpu")
    lj = jbanded.get_layout(gj, direction, row_bytes=512)
    lt = tbanded.get_layout(gt, direction, row_bytes=512)
    assert lt.K == lj.K == 3
    x = np.random.RandomState(1).randn(gt.n_pad, 128).astype(np.float32)
    want = j_gather_bands(jnp.asarray(x).astype(dtype), lj, "split")
    got = t_gather_bands(torch.from_numpy(x).to(getattr(torch, dtype)), lt,
                         "split")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      b.float().numpy())


# -- the kernel's host side --------------------------------------------------


def fake_gather_launch(idx_p, table_p, out_p, M, W, row_bytes, stream):
    """``csrc/gather_rows.cu``'s gather_rows_launch in NumPy, on the host
    memory its pointers name: a zero row for an index outside [0, W)."""
    import ctypes

    def mem(ptr, n, ct=ctypes.c_uint8):
        return np.ctypeslib.as_array((ct * n).from_address(ptr))

    idx = mem(idx_p, M, ctypes.c_int32)
    table = mem(table_p, W * row_bytes).reshape(W, row_bytes)
    out = mem(out_p, M * row_bytes).reshape(M, row_bytes)
    ok = (idx >= 0) & (idx < W)
    out[:] = 0
    out[ok] = table[idx[ok]]
    return 0


@pytest.mark.parametrize("F,dtype", [
    (128, torch.float32), (40, torch.float32), (33, torch.bfloat16),
    (64, torch.bfloat16), (5, torch.int32),
])
def test_launch_arguments(monkeypatch, F, dtype):
    """The launch path's arguments to the C entry (pointers, sizes, the
    stream), with the entry emulated on CPU memory: index_select where
    indices are in range, zero rows elsewhere, one launch counted."""
    from mini_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(kg, "_launch", fake_gather_launch)
    monkeypatch.setattr(_build, "stream", lambda device_index: 0)
    rng = np.random.RandomState(F)
    table = torch.from_numpy(rng.randn(300, F).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.randint(-20, 320, 1000).astype(np.int32))
    before = kg.launches
    got = kg.gather_rows(on_card(table), on_card(idx))
    assert kg.launches == before + 1
    ok = (idx >= 0) & (idx < 300)
    want = torch.where(ok[:, None], table[idx.clamp(0, 299).long()],
                       torch.zeros((), dtype=dtype))
    assert got.dtype == dtype and torch.equal(got, want)
    with pytest.raises(TypeError):
        kg.gather_rows(on_card(table), on_card(idx.long()))
    with pytest.raises(ValueError):  # the indices on another device
        kg.gather_rows(on_card(table), idx)


class OnCard(torch.Tensor):
    """A CPU tensor that says it is a CUDA one: it reaches a wrapper's
    launch path on a machine without a card."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def on_card(t):
    return torch.Tensor._make_subclass(OnCard, t)


def wrapper_calls():
    """(name, module, counter, call) of every kernel wrapper, each called
    on small CPU tensors; ``call(wrap)`` wraps its tensor arguments."""
    from mini_tpu_torch.ops.kernels import permute_kernel as kp
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.ops.kernels import spmm_banded as k2
    from mini_tpu_torch.ops.kernels import spmm_kernel as k4

    rng = np.random.RandomState(0)
    table = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 64, 100).astype(np.int32))
    rank = torch.from_numpy(rng.permutation(100).astype(np.int32))
    pay = torch.from_numpy(rng.randn(100).astype(np.float32))
    offsets = torch.arange(0, 257, 2, dtype=torch.int32)
    dsts = torch.arange(128, dtype=torch.int32).repeat_interleave(2)
    vals = torch.from_numpy(rng.randn(256).astype(np.float32))
    msgs = torch.from_numpy(rng.randn(256, 8).astype(np.float32))
    return [
        ("gather_rows", kg, "launches",
         lambda w: kg.gather_rows(w(table), w(idx))),
        ("permute", kp, "launches",
         lambda w: kp.permute(w(rank), [w(pay), w(pay.double())])),
        ("permute_rows", kp, "launches",
         lambda w: kp.permute_rows(w(rank), w(table[:50].reshape(100, 4)))),
        ("segment_reduce", k1, "launches",
         lambda w: k1.segment_reduce(w(offsets), w(dsts), w(vals), "max")),
        ("segment_sum", k4, "launches",
         lambda w: k4.segment_sum(w(offsets), w(dsts), w(msgs))),
        ("banded_segment_sum", k2, "launches",
         lambda w: k2.banded_segment_sum(
             w(offsets[::128].reshape(1, -1)),
             w(offsets[:-1].reshape(1, 1, 128)), [w(msgs)], edge_chunk=128,
             row_prefix=w(offsets))),
        ("banded_segment_sum_indexed", k2, "indexed_launches",
         lambda w: k2.banded_segment_sum(
             w(offsets[::128].reshape(1, -1)),
             w(offsets[:-1].reshape(1, 1, 128)), w(msgs), edge_chunk=128,
             row_prefix=w(offsets), ids=[w(torch.arange(
                 256, dtype=torch.int32))], band_rows=256)),
        ("banded_sddmm", k2, "sddmm_launches",
         lambda w: k2.banded_sddmm(
             w(offsets[::128].reshape(1, -1)),
             w(offsets[:-1].reshape(1, 1, 128)), [w(msgs)],
             w(msgs[:128]), edge_chunk=128)),
    ]


@pytest.mark.parametrize("name", ["gather_rows", "permute", "permute_rows",
                                  "segment_reduce", "segment_sum",
                                  "banded_segment_sum",
                                  "banded_segment_sum_indexed",
                                  "banded_sddmm"])
def test_cpu_tensors_never_load_a_library(monkeypatch, name):
    """On CPU tensors every wrapper runs its plain version: nothing is
    built, loaded or bound, and no launch is counted."""
    from mini_tpu_torch.ops.kernels import _build

    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "bind", refuse)
    _, mod, counter, call = next(c for c in wrapper_calls() if c[0] == name)
    before = getattr(mod, counter)
    out = call(lambda t: t)
    assert out is not None and getattr(mod, counter) == before


@pytest.mark.parametrize("name", ["gather_rows", "permute", "permute_rows",
                                  "segment_reduce", "segment_sum",
                                  "banded_segment_sum",
                                  "banded_segment_sum_indexed",
                                  "banded_sddmm"])
def test_cuda_call_without_nvcc_raises(monkeypatch, tmp_path, name):
    """A CUDA tensor launches the kernel or raises: with no nvcc the first
    launch fails to build its library and the error reaches the caller;
    no plain version stands in and no launch is counted."""
    from mini_tpu_torch.ops.kernels import _build
    from mini_tpu_torch.ops.kernels import permute_kernel as kp
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    for mod, attr in ((kg, "_launch"), (kp, "_launch"), (k1, "_launch"),
                      (k2, "_sum_launch")):
        monkeypatch.setattr(mod, attr, None)
    _, mod, counter, call = next(c for c in wrapper_calls() if c[0] == name)
    before = getattr(mod, counter)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        call(on_card)
    assert getattr(mod, counter) == before
    assert not (tmp_path / "build").exists()
