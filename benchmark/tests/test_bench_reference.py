"""The plain reference and the generators: the reference imports nothing of
JAX or of the program and agrees with the port (on the CPU) at small
sizes; the generators are deterministic per seed and give the stated
sizes."""

import ast
import os

import numpy as np
import pytest
import torch

from benchmark.gen import arxiv_like, kronecker
from benchmark.harness import registry
from benchmark.reference import bfs as ref_bfs
from benchmark.reference import gcn as ref_gcn
from benchmark.reference import pagerank as ref_pr
from benchmark.reference.graph import both_directions

REF_DIR = os.path.join(registry.HERE, "reference")
BANNED = {"jax", "jaxlib", "flax", "mini_tpu", "mini_tpu_torch"}


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_neither_jax_nor_the_program():
    files = [f for f in os.listdir(REF_DIR) if f.endswith(".py")]
    assert len(files) >= 4
    for f in files:
        names = set(_top_level_imports(os.path.join(REF_DIR, f)))
        assert not names & BANNED, (f, names & BANNED)
        assert names <= {"__future__", "torch", "numpy", "benchmark"}


def _kron(seed, scale=8):
    cfg = {**registry.load_cell("kron20-bfs").config, "scale": scale,
           "search_roots": 8}
    return cfg, kronecker.generate(cfg, seed, "cpu")


def _arxiv(seed):
    cfg = {**registry.load_cell("arxiv-gcn-train").config,
           "num_nodes": 300, "num_edges": 1200, "feature_dim": 16,
           "num_classes": 8, "split": {"train": 150, "valid": 50,
                                       "test": 100}}
    return cfg, arxiv_like.generate(cfg, seed, "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_kronecker_deterministic_and_sized(seed):
    cfg, a = _kron(seed)
    _, b = _kron(seed)
    _, c = _kron(seed + 1)
    for k in ("src", "dst", "weights", "roots"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["src"], c["src"])
    assert a["n"] == 256 and a["src"].numel() == 256 * 16
    assert int(a["src"].max()) < 256 and int(a["dst"].max()) < 256
    assert not bool((a["src"] == a["dst"]).any())
    w = a["weights"]
    assert float(w.min()) >= 1 and float(w.max()) < 64
    assert torch.equal(w, w.round())
    deg = torch.bincount(a["src"], minlength=256) + torch.bincount(
        a["dst"], minlength=256)
    assert a["roots"].unique().numel() == 8 and bool((deg[a["roots"]] > 0)
                                                     .all())


def test_kronecker_config_at_stated_size():
    cfg = registry.load_cell("kron20-bfs").config
    assert (1 << cfg["scale"]) * cfg["edgefactor"] == 16777216


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_arxiv_like_deterministic_and_sized(seed):
    cfg, a = _arxiv(seed)
    _, b = _arxiv(seed)
    for k in ("src", "dst", "x", "labels", "train_mask"):
        assert torch.equal(a[k], b[k])
    assert a["src"].numel() == 1200 and a["x"].shape == (300, 16)
    assert int(a["src"].max()) < 300 and int(a["dst"].max()) < 300
    assert int(a["train_mask"].sum()) == 150
    assert int(a["labels"].max()) < 8


def test_arxiv_config_is_the_published_size():
    cfg = registry.load_cell("arxiv-gcn-train").config
    assert (cfg["num_nodes"], cfg["num_edges"]) == (169343, 1166243)
    assert sum(cfg["split"].values()) == 169343
    assert cfg["dims"] == [128, 256, 256, 40]


def _port_graph(a):
    from mini_tpu_torch import GraphSlice, from_edges

    hg = from_edges(a["src"].numpy(), a["dst"].numpy(), None,
                    num_nodes=a["n"], make_undirected=True)
    return hg, GraphSlice.from_host(hg, device="cpu")


@pytest.mark.parametrize("seed", [3, 4])
def test_bfs_reference_is_the_ports(seed):
    from mini_tpu_torch.algorithms import bfs

    _, a = _kron(seed)
    _, g = _port_graph(a)
    src, dst = both_directions(a["src"], a["dst"])
    for root in a["roots"].tolist()[:4]:
        r = bfs(g, root)
        want = ref_bfs.levels(src, dst, a["n"], root)
        assert torch.equal(r.labels[: a["n"]].long(), want)
        par = ref_bfs.parents(src, dst, want)
        assert torch.equal(r.preds[: a["n"]].long(), par)
        big = ref_bfs.parents(src, dst, want, largest=True)
        assert bool((big >= par).all()) and not torch.equal(big, par)


def test_pagerank_reference_is_the_ports():
    from mini_tpu_torch.algorithms import pagerank

    _, a = _kron(5)
    _, g = _port_graph(a)
    src, dst = both_directions(a["src"], a["dst"])
    want, rounds = ref_pr.pagerank(src, dst, a["n"])
    got = pagerank(g, "standard")
    assert got.num_iterations == rounds
    np.testing.assert_allclose(got.ranks[: a["n"]].double().numpy(),
                               want.numpy(), rtol=1e-5)


def test_gcn_reference_is_the_ports():
    from mini_tpu_torch.models import (gcn_init_opt, gcn_normalize,
                                       gcn_train_step)
    from benchmark.tasks.gcn_train import _padded, init_params

    cfg, a = _arxiv(6)
    a["n"] = 300
    _, g = _port_graph(a)
    dims = [16, 32, 32, 8]
    p0 = init_params(dims, 6, "cpu")
    norm = gcn_normalize(g)
    x = _padded(a["x"], g.n_pad)
    batch = (_padded(a["labels"], g.n_pad),
             _padded(a["train_mask"], g.n_pad, False))
    p, o = p0, gcn_init_opt(p0)
    losses = []
    for _ in range(3):
        p, o, loss = gcn_train_step(p, o, g, norm, x, batch, lr=0.01)
        losses.append(float(loss))
    src, dst = both_directions(a["src"], a["dst"])
    adj = ref_gcn.Adjacency(src, dst, 300, torch.float64)
    want = ref_gcn.train([{k: v.double() for k, v in q.items()} for q in p0],
                         adj, a["x"].double(), a["labels"], a["train_mask"],
                         0.01, 0.9, 3)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    for got, ref in zip(p, want["params"]):
        for k in got:
            np.testing.assert_allclose(got[k].double().numpy(),
                                       ref[k].numpy(), rtol=1e-4, atol=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      1.0 + 2**-12, -3.0])
    got = ref_gcn.tf32_round(x)
    # 10 mantissa bits kept, ties to even
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2 * 2**-10, 1.0,
                            -3.0]
