"""Port parity: ``mini_tpu_torch.graph.datasets`` gives bitwise the arrays
of ``mini_tpu.graph.datasets`` for the same arguments, and the port's GCN
learns the synthetic arxiv-like input on the CPU (the bar of
tests/test_datasets.py: test accuracy above 0.7 after 40 SGD-momentum
steps at lr 0.1)."""

import dataclasses

import numpy as np
import pytest
import torch

from mini_tpu.graph import datasets as jds
from mini_tpu_torch.graph import GraphSlice
from mini_tpu_torch.graph import datasets as tds
from mini_tpu_torch.models.gcn import (
    gcn_forward,
    gcn_init,
    gcn_init_opt,
    gcn_normalize,
    gcn_train_step,
)

from test_torch_graph import assert_host_equal

ARRAYS = ("features", "labels", "train_mask", "valid_mask", "test_mask")


def assert_dataset_equal(want, got):
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    assert_host_equal(want.graph, got.graph)
    for f in ARRAYS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (want.num_classes, want.name) == (got.num_classes, got.name)


@pytest.mark.parametrize("kw", [dict(scale=9),
                                dict(scale=7, feature_dim=8, num_classes=4,
                                     seed=3)])
def test_synthetic_arxiv_like_is_bitwise_jax_s(kw):
    assert_dataset_equal(jds.synthetic_arxiv_like(**kw),
                         tds.synthetic_arxiv_like(**kw))


@pytest.mark.parametrize("undirected", [True, False])
def test_npz_roundtrip_is_bitwise_jax_s(tmp_path, undirected):
    ds = tds.synthetic_arxiv_like(scale=7, feature_dim=8, num_classes=4)
    path = str(tmp_path / "ds.npz")
    np.savez(
        path,
        edges=np.stack([ds.graph.csr_srcs, ds.graph.csr_dsts], 1),
        features=ds.features,
        labels=ds.labels,
        train_mask=ds.train_mask,  # valid and test masks absent: all False
    )
    got = tds.load_npz_dataset(path, undirected=undirected)
    assert_dataset_equal(jds.load_npz_dataset(path, undirected=undirected),
                         got)
    np.testing.assert_array_equal(got.labels, ds.labels)
    assert not got.test_mask.any()
    if not undirected:  # the stored edges, as they were
        np.testing.assert_array_equal(got.graph.row_offsets,
                                      ds.graph.row_offsets)
        np.testing.assert_array_equal(got.graph.csr_dsts, ds.graph.csr_dsts)


def test_synthetic_dataset_is_learnable():
    ds = tds.synthetic_arxiv_like(scale=9, feature_dim=16, num_classes=5)
    gs = GraphSlice.from_host(ds.graph, device="cpu")
    norm = gcn_normalize(gs)
    n = ds.graph.n

    def padded(a, dtype):
        out = np.zeros((gs.n_pad,) + a.shape[1:], dtype)
        out[:n] = a
        return torch.from_numpy(out)

    x = padded(ds.features, np.float32)
    labels = padded(ds.labels, np.int32)
    train = padded(ds.train_mask, bool)
    test = padded(ds.test_mask, bool)
    params = gcn_init(torch.Generator().manual_seed(0),
                      [16, 32, ds.num_classes], device="cpu")
    opt = gcn_init_opt(params)
    losses = []
    for _ in range(40):
        params, opt, loss = gcn_train_step(params, opt, gs, norm, x,
                                           (labels, train), 0.1)
        losses.append(float(loss))
    pred = gcn_forward(params, gs, norm, x).argmax(-1)
    acc = (pred[test] == labels[test]).float().mean().item()
    assert losses[-1] < losses[0]
    assert acc > 0.7, acc
