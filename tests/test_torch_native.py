"""Port parity: the native graph loader of ``mini_tpu_torch`` (its own copy
of ``loader.cpp``, built into ``mini_tpu_torch/build/``) gives bitwise the
arrays of ``mini_tpu``'s NumPy path, through ``native_from_edges``,
``native_load_mtx`` and ``from_edges`` above its 2^20-edge threshold; two
processes building at once both load a whole library; a failed build is
reported, and the NumPy path then gives the same arrays."""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

import mini_tpu.graph as jg
import mini_tpu_torch.graph as tg
import mini_tpu_torch.native as nat

from test_torch_graph import assert_host_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_into_the_port_build_dir():
    assert nat.native_available(), nat.native_build_error()
    assert nat.native_build_error() is None
    lib_path = os.path.realpath(nat._lib._name)
    build_dir = os.path.realpath(os.path.join(ROOT, "mini_tpu_torch",
                                              "build"))
    assert os.path.dirname(lib_path) == build_dir
    assert os.path.basename(lib_path).startswith("libmini_graph_")


@pytest.mark.parametrize("weighted,directed", [(True, True), (False, True),
                                               (True, False)])
def test_native_from_edges_parity(weighted, directed):
    hg = jg.erdos_renyi(100, 800, seed=5, weighted=weighted)
    srcs, dsts, w = hg.edge_list()
    want = jg.from_edges(srcs, dsts, w if weighted else None,
                         num_nodes=hg.n, directed=directed)
    got = nat.native_from_edges(srcs, dsts, w if weighted else None,
                                num_nodes=hg.n, directed=directed)
    assert got is not None
    assert_host_equal(want, got)


def test_native_from_edges_duplicates_self_loops_and_isolated_vertices():
    rng = np.random.RandomState(0)
    srcs = rng.randint(0, 20, 300)
    dsts = rng.randint(0, 20, 300)
    srcs[:10] = dsts[:10]  # self-loops
    srcs[10:20], dsts[10:20] = 3, 7  # ten copies of one edge
    w = rng.rand(300).astype(np.float32)
    want = jg.from_edges(srcs, dsts, w, num_nodes=25)  # 20-24 isolated
    assert_host_equal(want, nat.native_from_edges(srcs, dsts, w, 25))


@pytest.mark.parametrize("srcs,dsts,weights", [
    ([0, 5], [1, 2], None),      # id 5 outside [0, 5)
    ([0, -1], [1, 2], None),     # negative id
    ([0, 1], [1, 2], [1.0]),     # one weight for two edges
])
def test_native_from_edges_refuses_bad_input(srcs, dsts, weights):
    with pytest.raises(ValueError):
        nat.native_from_edges(np.array(srcs), np.array(dsts),
                              None if weights is None else np.array(weights),
                              num_nodes=5)


@pytest.mark.parametrize("kw", [{}, dict(undirected=True),
                                dict(transpose=True),
                                dict(undirected=True, transpose=True)])
def test_native_load_mtx_parity(tmp_path, kw):
    hg = jg.erdos_renyi(60, 400, seed=6, weighted=True)
    path = str(tmp_path / "g.mtx")
    jg.save_mtx(hg, path, weights=True)
    want = jg.load_mtx(path, use_native=False, **kw)
    got = nat.native_load_mtx(path, **kw)
    assert got is not None
    assert_host_equal(want, got)
    assert_host_equal(want, tg.load_mtx(path, **kw))
    assert_host_equal(want, tg.load_mtx(path, use_native=False, **kw))


def test_undirected_reciprocal_edges_keep_the_numpy_order(tmp_path):
    """A weighted file holding (u,v) and (v,u) with different weights: the
    port's parser appends the reversed edges after the forward ones, as the
    NumPy path does, so ties among equal (src, dst) keep its order.
    ``mini_tpu``'s parser interleaves each edge with its reverse and there
    differs from its own NumPy path (pinned here)."""
    path = str(tmp_path / "recip.mtx")
    with open(path, "w") as f:
        f.write("3 3 3\n1 2 5.0\n2 1 7.0\n2 3 1.0\n")
    want = jg.load_mtx(path, use_native=False, undirected=True)
    assert_host_equal(want, nat.native_load_mtx(path, undirected=True))
    np.testing.assert_array_equal(want.csr_weights, [5, 7, 7, 5, 1, 1])
    from mini_tpu.native import native_available, native_load_mtx

    if native_available():
        jax_native = native_load_mtx(path, undirected=True)
        np.testing.assert_array_equal(jax_native.csr_weights,
                                      [5, 7, 5, 7, 1, 1])


def test_native_declines_random_weights(tmp_path):
    hg = jg.erdos_renyi(10, 30, seed=9)
    path = str(tmp_path / "r.mtx")
    jg.save_mtx(hg, path)
    assert nat.native_load_mtx(path, random_weights=True) is None
    # load_mtx then takes the NumPy path: RandomState's weights, as JAX's
    assert_host_equal(
        jg.load_mtx(path, use_native=False, random_weights=True, seed=4),
        tg.load_mtx(path, random_weights=True, seed=4))


def test_native_load_mtx_refuses_a_bad_file(tmp_path):
    path = str(tmp_path / "bad.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket\n3 3 2\n1 2\n4 1\n")  # vertex 4 of 3
    assert nat.native_load_mtx(path) is None
    with pytest.raises(ValueError):  # the NumPy path says why
        tg.load_mtx(path)


def test_from_edges_takes_the_native_builder_above_2_pow_20(monkeypatch):
    m = (1 << 20) + 1
    rng = np.random.RandomState(1)
    srcs = rng.randint(0, 5000, m)
    dsts = rng.randint(0, 5000, m)
    w = rng.rand(m).astype(np.float32)
    want = jg.from_edges(srcs, dsts, w, num_nodes=5000)
    calls = []
    real = nat.native_from_edges

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(nat, "native_from_edges", spy)
    assert_host_equal(want, tg.from_edges(srcs, dsts, w, num_nodes=5000))
    assert calls == [1]
    # below 2^20 edges it stays on the NumPy path
    k = (1 << 20) - 1
    assert_host_equal(
        jg.from_edges(srcs[:k], dsts[:k], w[:k], num_nodes=5000),
        tg.from_edges(srcs[:k], dsts[:k], w[:k], num_nodes=5000))
    assert calls == [1]
    # without the library the NumPy path gives the same arrays
    monkeypatch.setattr(nat, "native_from_edges", lambda *a, **k: None)
    assert_host_equal(want, tg.from_edges(srcs, dsts, w, num_nodes=5000))


BUILD_AND_USE = textwrap.dedent("""
    import sys
    import numpy as np
    import mini_tpu_torch.native as nat
    nat.BUILD_DIR = sys.argv[1]
    assert nat.native_available(), nat.native_build_error()
    hg = nat.native_from_edges(np.array([0, 1, 1]), np.array([1, 2, 0]),
                               None, 3)
    print(hg.row_offsets.tolist(), hg.csc_eids.tolist())
""")


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_USE,
                               build_dir], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[0, 1, 3, 3] [1, 0, 2]"
    # one library, no private build file left behind
    files = os.listdir(build_dir)
    assert len(files) == 1 and files[0].startswith("libmini_graph_"), files


def test_a_failed_build_is_reported_not_hidden(tmp_path, monkeypatch):
    src = tmp_path / "loader.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(nat, "SRC", str(src))
    monkeypatch.setattr(nat, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_error", None)
    with pytest.warns(RuntimeWarning, match="native graph loader"):
        assert not nat.native_available()
    assert "failed to build" in nat.native_build_error()
    assert nat.native_from_edges(np.array([0]), np.array([1]), None,
                                 2) is None
    # the NumPy path then gives the arrays the library would have
    hg = jg.erdos_renyi(30, 150, seed=8, weighted=True)
    path = str(tmp_path / "t.mtx")
    jg.save_mtx(hg, path, weights=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once, not at every call
        assert_host_equal(jg.load_mtx(path, use_native=False),
                          tg.load_mtx(path))
