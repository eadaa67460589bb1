"""Port parity of the argument lists: ``bfs``, ``spmm``, ``sddmm``, the
functions of the traversal slice (``bfs_batch``, ``sssp``,
``sssp_batch``, ``pagerank``, ``connected_components``,
``neighborhood_reduce``, ``segment_reduce``) and of the peeling slice
(``kcore`` and its oracles, ``coloring``, ``validate_coloring``, ``lspar``,
``lspar_cpu``, ``segment_sort``, ``segment_argsort``) and the drivers
(``load_mtx``, ``from_edges``, the datasets, checkpoints, profiling
scopes, ``wall_timer`` and the native loader; ``trace`` and ``time_fn``
with one pinned divergence each) of ``mini_tpu_torch``
take the parameters of ``mini_tpu``'s, in its order and with its
defaults, so the same positional call means the same in both packages.
Every call below hands both packages the same positional arguments (numpy
arrays wrapped for each) and compares the results: BFS labels, SSSP dists
and preds, CC, k-core, L-Spar and the sorts bitwise, SpMM, SDDMM and
PageRank within float32 rounding of a sum taken in another order (rtol
and atol 1e-5; PageRank rtol 1e-4, atol 1e-6); coloring, whose draws
differ, by its round cap, its colors' range and the oracle."""

import inspect
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
import mini_tpu.algorithms as jalg
import mini_tpu.ops as jops
from mini_tpu.algorithms import bfs as jbfs
from mini_tpu.graph import banded as jbanded
from mini_tpu.ops import sort as jsort
from mini_tpu.ops.spmm import sddmm as jsddmm
from mini_tpu.ops.spmm import spmm as jspmm
import mini_tpu.native as jnative
import mini_tpu.utils as jutils
from mini_tpu.graph import datasets as jds
import mini_tpu_torch.graph as tg
import mini_tpu_torch.native as tnative
import mini_tpu_torch.utils as tutils
from mini_tpu_torch.graph import datasets as tds
import mini_tpu_torch.algorithms as talg
import mini_tpu_torch.ops as tops
from mini_tpu_torch.algorithms import bfs as tbfs
from mini_tpu_torch.algorithms.bfs import COUNTERS
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.ops import sort as tsort
from mini_tpu_torch.ops.spmm import sddmm as tsddmm
from mini_tpu_torch.ops.spmm import spmm as tspmm

from test_torch_graph import build

tspmm_mod = sys.modules["mini_tpu_torch.ops.spmm"]

TOL = dict(rtol=1e-5, atol=1e-5)


def wrap(pkg_asarray, args):
    """The positional arguments with every numpy array wrapped for one
    package (lists of arrays too)."""
    def one(a):
        if isinstance(a, np.ndarray):
            return pkg_asarray(a)
        if isinstance(a, (list, tuple)):
            return [one(b) for b in a]
        return a

    return [one(a) for a in args]


SLICE = [(getattr(jalg, n), getattr(talg, n)) for n in (
    "bfs_batch", "sssp", "sssp_batch", "pagerank", "connected_components")] \
    + [(getattr(jops, n), getattr(tops, n)) for n in (
        "neighborhood_reduce", "segment_reduce", "segment_argmin_by",
        "reduce_by_dst", "reduce_by_src", "uniquify", "compact_mask")]


# k-core, coloring, L-Spar and the segmented sort
PEELING = [(getattr(jalg, n), getattr(talg, n)) for n in (
    "kcore", "kcore_cpu", "kcore_cpu_true", "coloring", "validate_coloring",
    "lspar", "lspar_cpu")] + [(jsort.segment_sort, tsort.segment_sort),
                              (jsort.segment_argsort, tsort.segment_argsort)]


# ops/permute.py's movers (JAX's last three ops names)
MOVERS = [(getattr(jops, n), getattr(tops, n)) for n in (
    "expand_to_edges", "apply_fixed_perm", "segmented_scan_reduce")]

# the drivers: loaders, datasets, checkpoints, profiling, timing, native
DRIVERS = [(getattr(jg, n), getattr(tg, n)) for n in (
    "load_mtx", "from_edges")] + [
    (getattr(jds, n), getattr(tds, n)) for n in (
        "NodeClassificationDataset", "load_npz_dataset",
        "synthetic_arxiv_like")] + [
    (getattr(jutils, n), getattr(tutils, n)) for n in (
        "save_pytree", "load_pytree", "scope", "annotate", "wall_timer")] + [
    (getattr(jnative, n), getattr(tnative, n)) for n in (
        "native_available", "native_load_mtx", "native_from_edges")]


@pytest.mark.parametrize("jfn,tfn", [(jbfs, tbfs), (jspmm, tspmm),
                                     (jsddmm, tsddmm)] + SLICE + PEELING
                         + MOVERS + DRIVERS,
                         ids=["bfs", "spmm", "sddmm"]
                         + [j.__name__ for j, _ in SLICE + PEELING + MOVERS
                            + DRIVERS])
def test_parameters_are_the_jax_package_s(jfn, tfn):
    want = inspect.signature(jfn).parameters
    got = inspect.signature(tfn).parameters
    assert list(got) == list(want)
    for name in want:
        assert got[name].default == want[name].default, name
        assert got[name].kind == want[name].kind, name


def test_drivers_pinned_divergences():
    """Two driver parameters differ, on purpose.  ``trace``'s directory
    defaults to ``mini_tpu_trace`` in the temporary directory (``$TMPDIR``)
    where ``mini_tpu``'s is ``/tmp/mini_tpu_trace``; ``time_fn``'s fourth
    parameter is the ``device`` it times on (CUDA events on the card)
    where ``mini_tpu``'s is ``block``, the function that waits for JAX's
    asynchronous result."""
    want = inspect.signature(jutils.trace).parameters
    got = inspect.signature(tutils.trace).parameters
    assert list(got) == list(want) == ["dir_path"]
    assert want["dir_path"].default == "/tmp/mini_tpu_trace"
    assert got["dir_path"].default is None
    want = inspect.signature(jutils.time_fn).parameters
    got = inspect.signature(tutils.time_fn).parameters
    assert list(want) == ["fn", "warmup", "repeat", "block"]
    assert list(got) == ["fn", "warmup", "repeat", "device"]
    for name in ("fn", "warmup", "repeat"):
        assert got[name].default == want[name].default, name
    assert got["device"].default is want["block"].default is None


def test_ops_export_the_jax_package_s_names():
    names = {n for n in vars(jops) if not n.startswith("_")
             and not inspect.ismodule(getattr(jops, n))}
    assert len(names) == 28, names
    assert {n for n in vars(tops) if not n.startswith("_")
            and not inspect.ismodule(getattr(tops, n))} == names


def test_utils_export_the_jax_package_s_names():
    names = {n for n in vars(jutils) if not n.startswith("_")
             and not inspect.ismodule(getattr(jutils, n))}
    assert len(names) == 11, names
    assert {n for n in vars(tutils) if not n.startswith("_")
            and not inspect.ismodule(getattr(tutils, n))} == names


@pytest.fixture(scope="module")
def graphs():
    return (jg.GraphSlice.from_host(build(jg, "random")),
            tg.GraphSlice.from_host(build(tg, "random"), device="cpu"))


def assert_same_bfs(want, got):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.preds.numpy(), np.asarray(want.preds))
    for f in COUNTERS:
        assert getattr(got, f) == int(getattr(want, f)), f


@pytest.mark.parametrize("args,kwargs", [
    ((0.5, 5), {}),          # alpha, then the round cap
    ((0.5, 2), {}),          # a cap that cuts the search short
    ((None, None, 0, 0, 0), {}),  # all seven, positionally
    ((1e-3, None, 64, 512, 128), {}),
    ((), dict(alpha=0.25)),
    ((), dict(max_iter=2)),
    ((), dict(sparse_capv=32)),
    ((), dict(sparse_cape=256)),
    ((), dict(chain_cap=0)),
    ((), dict(alpha=2.0, max_iter=3, sparse_capv=16, sparse_cape=128,
              chain_cap=32)),
])
def test_bfs_same_call_same_result(graphs, args, kwargs):
    gj, gt = graphs
    for src in (0, 17):
        want = jbfs(gj, src, *args, **kwargs)
        got = tbfs(gt, src, *args, **kwargs)
        assert_same_bfs(want, got)
        assert got.num_iterations == int(want.num_iterations)


def test_bfs_third_positional_is_alpha_not_the_round_cap(graphs):
    gj, gt = graphs
    full = tbfs(gt, 0)
    assert full.num_iterations > 2
    # as the round cap, 2 would cut the search; as alpha it changes no label
    assert_same_bfs(jbfs(gj, 0, 2), tbfs(gt, 0, 2))
    assert tbfs(gt, 0, 2).num_iterations == full.num_iterations
    assert tbfs(gt, 0, None, 2).num_iterations == 2


@pytest.mark.parametrize("kwargs,error", [
    (dict(alpha="0.5"), TypeError),
    (dict(alpha=True), TypeError),
    (dict(max_iter=2.5), TypeError),
    (dict(sparse_capv="8"), TypeError),
    (dict(sparse_cape=1.0), TypeError),
    (dict(chain_cap=[1]), TypeError),
    (dict(chain_cap=-1), ValueError),
    (dict(max_iter=-3), ValueError),
    (dict(frontier_cap=4), TypeError),  # no such parameter in either package
])
def test_bfs_refuses_a_wrong_type(graphs, kwargs, error):
    with pytest.raises(error):
        tbfs(graphs[1], 0, **kwargs)


@pytest.fixture
def small_bands(monkeypatch):
    """128-row bands in both packages: the 256-row graph gets K=2."""
    small = 128 * 128 * 4
    monkeypatch.setattr(jbanded, "FAST_TABLE_BYTES", small)
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", small)


def spmm_args(gt, direction, impl, interpret, heads, pre_banded):
    """``(x, direction, weights, op, impl, weights_banded,
    weights_banded_bwd, precision, interpret, heads)``: every argument of
    ``spmm`` after the graph, as numpy arrays and plain values."""
    rng = np.random.RandomState(heads + 2 * interpret)
    x = (rng.rand(gt.n_pad, 64) - 0.5).astype(np.float32)
    shape = (gt.m_pad,) if heads == 1 else (gt.m_pad, heads)
    mask = (gt.edge_mask_csc if direction == "pull" else gt.edge_mask).numpy()
    w = (rng.rand(*shape) + 0.5).astype(np.float32)
    w = w * mask.reshape((-1,) + (1,) * (w.ndim - 1))  # pad edges weigh 0
    banded = banded_bwd = None
    if pre_banded:  # the same weights in each layout's band order
        back = "push" if direction == "pull" else "pull"
        wt = torch.from_numpy(w)
        banded = [b.numpy() for b in tbanded.get_layout(
            gt, direction, row_bytes=512).permute_to_bands(wt)]
        banded_bwd = [b.numpy() for b in tbanded.get_layout(
            gt, back, row_bytes=512).permute_to_bands(
                tspmm_mod._other_order(gt, direction, wt))]
    return (x, direction, w, "sum", impl, banded, banded_bwd, "highest",
            interpret, heads)


@pytest.mark.parametrize("direction,impl,interpret,heads,pre_banded", [
    ("pull", "xla", False, 1, False),
    ("push", "xla", False, 2, False),
    ("pull", "xla", True, 2, False),
    ("pull", "banded", True, 1, False),
    ("push", "banded", True, 2, False),
    ("pull", "banded", True, 1, True),
])
def test_spmm_eleven_positional_arguments(graphs, small_bands, direction,
                                          impl, interpret, heads, pre_banded):
    """All eleven arguments positionally: the tenth is ``interpret`` (JAX
    runs its Pallas kernels in interpret mode on the CPU; the port accepts
    it and does the same with either value), the eleventh ``heads``."""
    gj, gt = graphs
    args = spmm_args(gt, direction, impl, interpret, heads, pre_banded)
    assert len(args) == 10  # the graph is the first of the eleven
    want = np.asarray(jspmm(gj, *wrap(jnp.asarray, args)))
    got = tspmm(gt, *wrap(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    flipped = list(args)
    flipped[8] = not interpret  # no effect in the port
    again = tspmm(gt, *wrap(torch.from_numpy, flipped))
    assert torch.equal(got, again)


@pytest.mark.parametrize("order,impl,interpret", [
    ("csr", "xla", False), ("csc", "xla", True), ("csr", "banded", True),
    ("csc", "banded", True),
])
def test_sddmm_seven_positional_arguments(graphs, small_bands, order, impl,
                                          interpret):
    gj, gt = graphs
    rng = np.random.RandomState(3)
    xl = (rng.rand(gt.n_pad, 64) - 0.5).astype(np.float32)
    xr = (rng.rand(gt.n_pad, 64) - 0.5).astype(np.float32)
    args = (xl, xr, order, impl, "highest", interpret)
    want = np.asarray(jsddmm(gj, *wrap(jnp.asarray, args)))
    got = tsddmm(gt, *wrap(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for flag in (False, True):  # by name too
        assert torch.equal(got, tsddmm(
            gt, torch.from_numpy(xl), torch.from_numpy(xr), order=order,
            impl=impl, precision="highest", interpret=flag))


@pytest.mark.parametrize("args", [
    (None, 4, 1024),            # max_iter, sparse_capv, sparse_cape
    (None, 8, 64, None, "delta", 16.0, True, 4),  # all ten, positionally
    (12, None, None, None, "delta", None, False, 0),
    (None, None, None, 0, "auto"),
])
def test_sssp_same_call_same_result(graphs, args):
    gj, gt = graphs
    for src in (0, 17):
        want = jalg.sssp(gj, src, *args)
        got = talg.sssp(gt, src, *args)
        np.testing.assert_array_equal(got.dists.numpy(),
                                      np.asarray(want.dists))
        np.testing.assert_array_equal(got.preds.numpy(),
                                      np.asarray(want.preds))
        assert got.num_iterations == int(want.num_iterations)
        assert got.num_chained_iterations == int(
            want.num_chained_iterations)


def test_traversal_same_call_same_result(graphs):
    gj, gt = graphs
    want = jalg.bfs_batch(gj, jnp.asarray([0, 17]), None, 3, 16, 128, False)
    got = talg.bfs_batch(gt, [0, 17], None, 3, 16, 128, False)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    want = jalg.sssp_batch(gj, jnp.asarray([0, 17]), None, 16, 128, None,
                           "delta", 8.0, False, 8)
    got = talg.sssp_batch(gt, [0, 17], None, 16, 128, None, "delta", 8.0,
                          False, 8)
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.num_iterations.numpy(),
                                  np.asarray(want.num_iterations))
    want = jalg.pagerank(gj, "mini", 0.8, 1e-4, 7)
    got = talg.pagerank(gt, "mini", 0.8, 1e-4, 7)
    np.testing.assert_allclose(got.ranks.numpy(), np.asarray(want.ranks),
                               rtol=1e-4, atol=1e-6)
    want, got = jalg.connected_components(gj, 2), talg.connected_components(
        gt, 2)
    np.testing.assert_array_equal(got.components.numpy(),
                                  np.asarray(want.components))


def test_peeling_same_call_same_result(graphs):
    gj, gt = graphs
    hj, ht = build(jg, "random"), build(tg, "random")
    for variant in ("mini", "hindex", "auto"):
        want, got = jalg.kcore(gj, variant), talg.kcore(gt, variant)
        np.testing.assert_array_equal(got.num_cores.numpy(),
                                      np.asarray(want.num_cores))
        assert got.num_iterations == int(want.num_iterations)
    for oracle in ("kcore_cpu", "kcore_cpu_true"):
        want, got = getattr(jalg, oracle)(hj), getattr(talg, oracle)(ht)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    want, got = jalg.lspar(gj, 1000003, 0.6, 2), talg.lspar(gt, 1000003, 0.6,
                                                             2)
    np.testing.assert_array_equal(got.selected_mask.numpy(),
                                  np.asarray(want.selected_mask))
    hashs = np.arange(gt.n_pad, dtype=np.int32) % 97
    want, got = jalg.lspar_cpu(hj, hashs, 0.6), talg.lspar_cpu(ht, hashs, 0.6)
    np.testing.assert_array_equal(got[0], want[0])
    # prime, max_iter, seed, hashes_per_round: one round of 2 hash orders
    for K in (2, 1):
        want = jalg.coloring(gj, 7, 1, 5, K)
        got = talg.coloring(gt, 7, 1, 5, K)
        assert got.num_iterations == int(want.num_iterations) == 1
        for colors in (got.colors.numpy(), np.asarray(want.colors)):
            assert colors.max() <= 2 * K and (colors > 0).any()
            assert jalg.validate_coloring(colors, hj) == \
                talg.validate_coloring(colors, ht) is False
    full = talg.coloring(gt, 7, None, 5, 2).colors.numpy()
    assert jalg.validate_coloring(full, hj) == talg.validate_coloring(
        full, ht) is True
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 9, gt.m_pad).astype(np.int32)
    pay = rng.rand(gt.m_pad).astype(np.float32)
    seg = gt.csr_srcs.numpy()
    want = jsort.segment_sort(jnp.asarray(keys), jnp.asarray(seg),
                              jnp.asarray(pay), descending=True)
    got = tsort.segment_sort(torch.from_numpy(keys), torch.from_numpy(seg),
                             torch.from_numpy(pay), descending=True)
    for w, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    want = jsort.segment_argsort(jnp.asarray(keys), jnp.asarray(seg), True)
    got = tsort.segment_argsort(torch.from_numpy(keys), torch.from_numpy(seg),
                                True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the multi-device layer: the five modules' public functions
PARALLEL = [(m, n) for m, names in (
    ("partition", ("partition_graph",)),
    ("distributed", ("make_mesh", "make_mesh_2level", "shard_to_mesh",
                     "make_dist_bfs", "dist_bfs", "dist_sssp",
                     "make_dist_spmm", "dist_spmm", "dist_pagerank",
                     "dist_cc", "dist_coloring", "dist_kcore",
                     "dist_lspar")),
    ("halo", ("build_halo_plan", "exchange_slabs", "make_halo_spmm",
              "halo_spmm")),
    ("gcn", ("gcn_norm_arrays", "dist_gcn_train_step_fn",
             "dist_gcn_train")),
    ("models", ("dist_sage_forward", "dist_gat_forward", "dist_sage_train",
                "dist_gat_train")),
) for n in names]


@pytest.mark.parametrize("module,name", PARALLEL,
                         ids=[n for _, n in PARALLEL])
def test_parallel_parameters_are_the_jax_package_s(module, name):
    """JAX's parameters in JAX's order with JAX's defaults; what the port
    adds is keyword-only and last: ``device`` where the function places
    data on a device, ``mesh`` for ``exchange_slabs`` (JAX reads the mesh
    from the ``shard_map`` around it)."""
    import importlib

    jfn = getattr(importlib.import_module(f"mini_tpu.parallel.{module}"),
                  name)
    tfn = getattr(importlib.import_module(
        f"mini_tpu_torch.parallel.{module}"), name)
    want = inspect.signature(jfn).parameters
    got = inspect.signature(tfn).parameters
    extra = [n for n in got if n not in want]
    assert list(got)[: len(want)] == list(want)
    assert extra in ([], ["device"], ["mesh"]), extra
    for n in extra:
        assert got[n].kind == inspect.Parameter.KEYWORD_ONLY, n
    for n in want:
        assert got[n].default == want[n].default, n
        assert got[n].kind == want[n].kind, n
    if module == "distributed" and name.startswith("make_mesh"):
        assert extra == ["device"]


def test_parallel_exports_the_jax_package_s_names():
    import mini_tpu.parallel as jpar
    import mini_tpu_torch.parallel as tpar

    def names(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    assert len(names(jpar)) == 19
    assert names(tpar) == names(jpar)
