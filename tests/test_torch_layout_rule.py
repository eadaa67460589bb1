"""One layout rule and one banded aggregation for the port's GCN and GAT,
on the CPU, where every kernel wrapper runs its plain version.

``graph.banded.layout_for(g, direction, width)`` is the layout that each
banded caller takes for rows of that width: the SpMM forward and backward,
the SDDMM, GAT's banded layer forward and backward, and ``gcn_normalize``
for its pre-banded weights.  ``ops.spmm._apply_banded`` is the one route
to kernel 2 (``banded_segment_sum``): a spy patched there alone sees every
launch of a GCN step and of a GAT step, forward and backward.

This file imports no JAX."""

import importlib

import pytest
import torch

from mini_tpu_torch.graph import GraphSlice, rmat
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models import gat as gat_mod
from mini_tpu_torch.models.gcn import (
    gcn_init, gcn_init_opt, gcn_normalize, gcn_train_step,
)
from mini_tpu_torch.ops.kernels import spmm_banded as k2

# the module (the package exports its function under the same name)
spmm_mod = importlib.import_module("mini_tpu_torch.ops.spmm")

# 128-row bands at 4 KB rows; the band height of each width below
TABLE = 128 * 4096
BAND_ROWS = {1: 1024, 40: 1024, 128: 1024, 256: 512, 384: 384, 1024: 128}
# a width -> GAT heads and features a head whose head concat pads to it
GAT_SHAPES = {1: (1, 1), 40: (1, 40), 128: (2, 64), 256: (4, 64),
              384: (6, 64), 1024: (4, 256)}
OPPOSITE = {"pull": "push", "push": "pull"}


@pytest.fixture(scope="module")
def g():
    return GraphSlice.from_host(
        rmat(10, edge_factor=8, seed=2, undirected=True, weighted=True),
        device="cpu")


def _spy(mp, name, seen):
    """Patch ``ops.spmm.<name>`` to append the layout it is handed."""
    real = getattr(spmm_mod, name)

    def spy(*args, **kw):
        seen.append((name, next(a for a in args
                                if isinstance(a, tbanded.BandedLayout))))
        return real(*args, **kw)

    mp.setattr(spmm_mod, name, spy)


def _took(seen, name, want):
    """``ops.spmm.<name>`` was handed exactly the layouts ``want``, the
    same objects in the same order."""
    got = [lay for n, lay in seen if n == name]
    return len(got) == len(want) and all(a is b for a, b in zip(got, want))


@pytest.mark.parametrize("direction", ["pull", "push"])
@pytest.mark.parametrize("width", sorted(GAT_SHAPES))
def test_every_banded_caller_takes_layout_for(monkeypatch, g, width,
                                              direction):
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", TABLE)
    want = tbanded.layout_for(g, direction, width)
    back = tbanded.layout_for(g, OPPOSITE[direction], width)
    assert want.band_rows == back.band_rows == BAND_ROWS[width]
    gen = torch.Generator().manual_seed(width)
    seen = []
    _spy(monkeypatch, "_apply_banded", seen)
    _spy(monkeypatch, "_gather_bands", seen)
    _spy(monkeypatch, "_weight_cotangent", seen)

    # the SpMM: its forward in the direction, its x-gradient opposite
    x = torch.rand(g.n_pad, width, generator=gen, requires_grad=True)
    out = spmm_mod.spmm(g, x, direction=direction, impl="banded")
    assert _took(seen, "_apply_banded", [want])
    torch.autograd.grad(out.sum(), x)
    assert _took(seen, "_apply_banded", [want, back])

    # the SDDMM: the order whose layout has the direction's base order
    seen.clear()
    xl, xr = (torch.rand(g.n_pad, width, generator=gen) for _ in "lr")
    spmm_mod.sddmm(g, xl, xr, order="csc" if direction == "pull" else "csr",
                   impl="banded")
    assert _took(seen, "_gather_bands", [want])

    # GAT's banded layer: pull forward and weight cotangent, push x-gradient
    seen.clear()
    H, d = GAT_SHAPES[width]
    params = gat_mod.gat_init(gen, [8, d], heads=H, device="cpu")
    leaves = [{k: v.requires_grad_() for k, v in p.items()} for p in params]
    out = gat_mod.gat_forward(leaves, g, torch.rand(g.n_pad, 8,
                                                    generator=gen),
                              attn="banded")
    torch.autograd.grad(out.sum(), leaves[0]["w"])
    pull, push = (want, back) if direction == "pull" else (back, want)
    assert _took(seen, "_apply_banded", [pull, push])
    assert _took(seen, "_weight_cotangent", [pull])

    # gcn_normalize: the weights pre-banded on the layout of band_for_f
    banded = []
    real_permute = tbanded.BandedLayout.permute_to_bands

    def permute(self, vals):
        banded.append(self)
        return real_permute(self, vals)

    monkeypatch.setattr(tbanded.BandedLayout, "permute_to_bands", permute)
    gcn_normalize(g, band_for_f=width)
    assert banded[["pull", "push"].index(direction)] is want


def _step(model, g):
    """One train step of a small GCN (3 layers) or GAT (2 layers, 2
    heads) on the banded path."""
    gen = torch.Generator().manual_seed(7)
    x = torch.rand(g.n_pad, 16, generator=gen) - 0.5
    labels = torch.randint(0, 8, (g.n_pad,), generator=gen)
    batch = (labels, torch.arange(g.n_pad) < g.n)
    if model == "gcn":
        params = gcn_init(gen, [16, 32, 32, 8], device="cpu")
        return gcn_train_step(params, gcn_init_opt(params), g,
                              gcn_normalize(g), x, batch, 1e-2,
                              impl="banded")
    params = gat_mod.gat_init(gen, [16, 32, 8], heads=2, device="cpu")
    return gat_mod.gat_train_step(params, gat_mod.gat_init_opt(params), g,
                                  x, batch, 0.1, attn="banded")


@pytest.mark.parametrize("model,launches", [("gcn", 6), ("gat", 4)])
def test_one_seam_carries_every_kernel2_launch(monkeypatch, g, model,
                                               launches):
    """A spy on ``ops.spmm._apply_banded`` alone sees every launch of
    kernel 2 in a step (on the CPU, every call of its plain version, by
    whatever import it is reached): a GCN's three aggregations forward
    and three backward, a GAT layer's message sum forward and its
    x-gradient backward; one launch a call."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", TABLE)
    seen = {"all": 0, "inside": 0, "calls": 0}
    plain, real = k2.banded_segment_sum_plain, spmm_mod._apply_banded

    def kernel(*args, **kw):
        seen["all"] += 1
        return plain(*args, **kw)

    def seam(*args, **kw):
        before = seen["all"]
        out = real(*args, **kw)
        seen["calls"] += 1
        seen["inside"] += seen["all"] - before
        return out

    monkeypatch.setattr(k2, "banded_segment_sum_plain", kernel)
    monkeypatch.setattr(spmm_mod, "_apply_banded", seam)
    _step(model, g)
    assert seen == {"all": launches, "inside": launches, "calls": launches}
