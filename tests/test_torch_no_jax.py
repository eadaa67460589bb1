"""The port stands alone: it imports no jax, its kernel wrappers take the
plain versions only for CPU tensors, and a missing nvcc is an error."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mini_tpu_torch.ops.kernels import _build
from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
from mini_tpu_torch.ops.kernels import spmm_banded as k2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
assert "jax" not in sys.modules
import mini_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    mini_tpu_torch.__path__, "mini_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
assert {"mini_tpu_torch.ops.sort", "mini_tpu_torch.algorithms.kcore",
        "mini_tpu_torch.algorithms.coloring",
        "mini_tpu_torch.algorithms.lspar", "mini_tpu_torch.cli",
        "mini_tpu_torch.entry", "mini_tpu_torch.native",
        "mini_tpu_torch.graph.datasets", "mini_tpu_torch.utils.checkpoint",
        "mini_tpu_torch.utils.profiling", "mini_tpu_torch.parallel",
        "mini_tpu_torch.parallel.partition",
        "mini_tpu_torch.parallel.distributed",
        "mini_tpu_torch.parallel.halo", "mini_tpu_torch.parallel.gcn",
        "mini_tpu_torch.parallel.models",
        "mini_tpu_torch.parallel.launch"} <= set(names), names
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mini_tpu"))
assert not leaked, leaked
print("ok", len(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


IMPORT_PARALLEL = """
import sys
import mini_tpu_torch.parallel
import mini_tpu_torch.parallel.launch
import mini_tpu_torch.entry
from mini_tpu_torch.entry import dryrun_multichip
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mini_tpu"))
assert not leaked, leaked
print("ok")
"""


def test_parallel_and_entry_import_no_jax():
    """A fresh process that imports the multi-device layer and the entry
    points (what every rank of ``run_ranks`` imports) loads no jax."""
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_PARALLEL], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_segment_reduce_wrapper_takes_plain_on_cpu():
    rng = np.random.RandomState(0)
    dsts = torch.from_numpy(np.sort(rng.randint(0, 128, 1024)).astype(np.int32))
    offsets = torch.searchsorted(dsts, torch.arange(129, dtype=torch.int32),
                                 out_int32=True)
    vals = torch.from_numpy(rng.randint(0, 99, 1024).astype(np.int32))
    before = k1.launches
    for op in k1.OPS:
        assert torch.equal(k1.segment_reduce(offsets, dsts, vals, op),
                           k1.segment_reduce_plain(offsets, dsts, vals, op))
    assert k1.launches == before  # no kernel ran
    with pytest.raises(TypeError):
        k1.segment_reduce(offsets, dsts, vals.double(), "min")
    with pytest.raises(ValueError):
        k1.segment_reduce(offsets, dsts, vals, "prod")


def test_banded_wrapper_takes_plain_on_cpu():
    bounds = torch.tensor([[0, 700]], dtype=torch.int32)
    offs2d = torch.sort(torch.randint(0, 700, (1, 1, 128),
                                      generator=torch.Generator()
                                      .manual_seed(0)), dim=-1).values
    offs2d = offs2d.to(torch.int32)
    offs2d[0, 0, 0] = 0
    msgs = [torch.rand(1024, 16, generator=torch.Generator().manual_seed(1))]
    before = k2.launches
    got = k2.banded_segment_sum(bounds, offs2d, msgs)
    assert torch.equal(got, k2.banded_segment_sum_plain(bounds, offs2d, msgs))
    assert k2.launches == before
    # rows sum their own segments; slots past the band's end never count
    ends = torch.cat([offs2d[0, 0, 1:], bounds[0, 1:]]).long()
    want = torch.stack([msgs[0][s:e].double().sum(0) for s, e in
                        zip(offs2d[0, 0].long(), ends)]).float()
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):  # streams must be edge_chunk-padded
        k2.banded_segment_sum(bounds, offs2d, [msgs[0][:1000]])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build("segreduce")
    assert not (tmp_path / "build").exists()
