"""Port parity of the command-line drivers: every invocation of
tests/test_cli.py, run with ``--cpu`` through ``mini_tpu_torch.cli.main``
and ``mini_tpu.cli.main``, exits with the same code and prints the same
result lines (graph size, iterations, components, largest k-core,
selected edges, the BFS labels and SSSP dists, PageRank's top-10 ids,
``Correct.``).  The divergences allowed, each pinned by name:

* ``pull:`` (BFS's direction counter): every round of the port is the
  dense sweep, so it stays 0;
* PageRank's top-10 values: float32 sums in another order (rtol 1e-4, the
  PageRank tolerance of tests/test_torch_traversal.py);
* coloring's ``iterations`` and ``colors used``: its salts come from a
  torch generator where ``mini_tpu``'s come from ``jax.random``;
* the GNN subcommands' params (the same RNG divergence): only their
  validation is compared.

Both CLIs take the same subcommands and flags; without ``--cpu`` and
without a card the port's raises."""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mini_tpu.cli as jcli
import mini_tpu_torch.cli as tcli
from mini_tpu.graph import erdos_renyi as jer
from mini_tpu.models import sage as jsage
from mini_tpu_torch.models import sage as tsage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXDIR, "test_bfs.mtx")
COLORING = os.path.join(FIXDIR, "test_coloring.mtx")

# tests/test_cli.py's invocations, in its order
INVOCATIONS = [
    ["bfs", "--file", FIXTURE, "--undirected", "--src", "0", "--validate"],
    ["sssp", "--file", FIXTURE, "--undirected", "--src", "0", "--validate"],
    ["pr", "--file", FIXTURE, "--undirected", "--validate"],
    ["coloring", "--file", FIXTURE, "--undirected", "--validate"],
    ["kcore", "--file", FIXTURE, "--undirected", "--validate"],
    ["lspar", "--file", FIXTURE, "--undirected"],
    ["coloring", "--file", COLORING, "--undirected", "--seed", "31",
     "--validate"],
    ["pr", "--file", COLORING, "--undirected", "--validate"],
    ["lspar", "--file", COLORING, "--undirected"],
    ["sssp", "--file", os.path.join(FIXDIR, "test_sssp.mtx"), "--undirected",
     "--src", "0", "--validate"],
    ["kcore", "--file", os.path.join(FIXDIR, "test_kcore.mtx"),
     "--undirected", "--validate"],
    ["gcn", "--file", os.path.join(FIXDIR, "test_kcore.mtx"), "--undirected",
     "--validate"],
    ["bfs", "--rmat-scale", "8", "--src", "0", "--validate"],
    ["cc", "--file", FIXTURE, "--undirected", "--validate"],
    ["bfs", "--file", FIXTURE, "--undirected", "--sources", "0,2,5",
     "--validate"],
    ["sssp", "--file", FIXTURE, "--undirected", "--sources", "0,3",
     "--validate"],
    ["gat", "--rmat-scale", "8", "--validate"],
    ["sage", "--rmat-scale", "8", "--validate"],
]


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def result_lines(algo, out):
    """The printed lines that must match, with the pinned divergences
    taken out: (lines, PageRank's top-10 values or None)."""
    lines, top_vals = [], None
    for line in out.splitlines():
        if line.startswith("elapsed:"):
            continue  # a time
        if algo == "coloring" and line.startswith("iterations:"):
            assert re.fullmatch(r"iterations: \d+ colors used: \d+", line)
            continue  # the salts' RNG
        if line.startswith("top-10:"):
            ids = [int(i) for i in re.findall(r"np\.int64\((\d+)\)", line)]
            top_vals = [float(v) for v in
                        re.findall(r"np\.float32\(([-0-9.e]+)\)", line)]
            assert len(ids) == len(top_vals) == 10
            line = f"top-10 ids: {ids}"
        lines.append(re.sub(r" \(pull: .*\)$", "", line))
    return lines, top_vals


@pytest.mark.parametrize("argv", INVOCATIONS,
                         ids=[" ".join(os.path.basename(a) for a in argv)
                              for argv in INVOCATIONS])
def test_same_exit_and_result_lines_as_jax(argv):
    want_rc, want_out = run(jcli.main, argv + ["--cpu"])
    got_rc, got_out = run(tcli.main, argv + ["--cpu"])
    assert got_rc == want_rc == 0
    want, want_vals = result_lines(argv[0], want_out)
    got, got_vals = result_lines(argv[0], got_out)
    assert got == want
    if "--validate" in argv:
        assert got[-1] == "Correct."
    if want_vals is not None:
        np.testing.assert_allclose(got_vals, want_vals, rtol=1e-4)


def test_bfs_pull_counter_is_zero():
    """The pinned ``pull:`` divergence: the port's counter stays 0."""
    _, out = run(tcli.main, ["bfs", "--file", FIXTURE, "--undirected",
                             "--sources", "0,2", "--cpu"])
    assert "iterations: [3, 3] (pull: [0, 0])" in out.splitlines()


def test_module_entry_runs():
    proc = subprocess.run(
        [sys.executable, "-m", "mini_tpu_torch.cli", "bfs", "--file",
         FIXTURE, "--undirected", "--validate", "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "Correct."


def test_without_cpu_and_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcli.main(["bfs", "--file", FIXTURE, "--undirected"])


def test_no_input_is_the_same_clean_error():
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit, match="need --file"):
            main(["bfs", "--cpu"])


def help_text(module):
    proc = subprocess.run([sys.executable, "-m", module, "--help"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, COLUMNS="200"))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_same_subcommands_and_flags():
    want, got = help_text("mini_tpu.cli"), help_text("mini_tpu_torch.cli")
    for pattern in (r"--[a-z-]+", r"\{[a-z,]+\}"):
        assert sorted(set(re.findall(pattern, got))) == sorted(
            set(re.findall(pattern, want)))
    assert "{bfs,sssp,pr,coloring,kcore,lspar,cc,gcn,gat,sage}" in got


def test_sage_oracle_is_the_dense_one():
    """The port's sparse ``sage_forward_cpu`` (which the CLI's ``sage
    --validate`` needs at RMAT scale 16, where ``mini_tpu``'s dense n x n
    matrix would take 34 GB) equals ``mini_tpu``'s dense one up to float64
    rounding (rtol 1e-12)."""
    hg = jer(150, 900, seed=7, undirected=False, weighted=True)
    rng = np.random.RandomState(0)
    x = rng.rand(hg.n + 10, 6).astype(np.float32)
    params = [{"w": rng.randn(12, 5), "b": rng.randn(5)},
              {"w": rng.randn(10, 3), "b": rng.randn(3)}]
    np.testing.assert_allclose(tsage.sage_forward_cpu(params, hg, x),
                               jsage.sage_forward_cpu(params, hg, x),
                               rtol=1e-12, atol=1e-12)
