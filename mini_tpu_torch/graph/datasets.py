"""Dataset loading for GNN workloads (the same NumPy code as
``mini_tpu.graph.datasets``: both packages give bitwise-equal arrays for
the same arguments).

The benchmark configs reference ogbn-arxiv-style node-classification input
(BASELINE.json configs[4]).  Nothing is downloaded:

* ``load_npz_dataset`` reads any pre-staged dataset in the simple npz
  format below (drop ogbn-arxiv in as ``{edges:[m,2], features:[n,F],
  labels:[n], train_mask/valid_mask/test_mask:[n]}``),
* ``synthetic_arxiv_like`` generates a deterministic stand-in with matching
  statistics (RMAT topology, community-correlated features/labels) so the
  GCN pipeline and benchmarks run end-to-end regardless.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from mini_tpu_torch.graph.csr import HostGraph, from_edges
from mini_tpu_torch.graph.generators import rmat


@dataclasses.dataclass
class NodeClassificationDataset:
    graph: HostGraph
    features: np.ndarray  # float32[n, F]
    labels: np.ndarray  # int32[n]
    train_mask: np.ndarray  # bool[n]
    valid_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    name: str


def load_npz_dataset(path: str, undirected: bool = True):
    data = np.load(path)
    edges = data["edges"]
    feats = data["features"].astype(np.float32)
    labels = data["labels"].astype(np.int32)
    n = feats.shape[0]
    hg = from_edges(
        edges[:, 0], edges[:, 1], num_nodes=n, make_undirected=undirected
    )
    masks = {}
    for k in ("train_mask", "valid_mask", "test_mask"):
        masks[k] = (
            data[k].astype(bool)
            if k in data
            else np.zeros(n, dtype=bool)
        )
    return NodeClassificationDataset(
        graph=hg,
        features=feats,
        labels=labels,
        num_classes=int(labels.max()) + 1,
        name=os.path.basename(path),
        **masks,
    )


def synthetic_arxiv_like(
    scale: int = 14,
    feature_dim: int = 128,
    num_classes: int = 40,
    seed: int = 0,
) -> NodeClassificationDataset:
    """Deterministic stand-in for ogbn-arxiv (169k nodes / 1.2M edges /
    128-dim features / 40 classes at scale=17-ish; default smaller).

    Labels follow planted blocks; features = class centroid + noise, so a
    GCN can actually learn (accuracy is meaningful, not random).
    """
    rng = np.random.RandomState(seed)
    hg_topo = rmat(scale, edge_factor=8, seed=seed, undirected=True)
    n = hg_topo.n
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    # class-assortative rewiring: half the edges redirect to a random
    # same-class-as-src vertex (adds homophily so aggregation is
    # informative; keeps the power-law src degrees)
    srcs, dsts, _w = hg_topo.edge_list()
    srcs = srcs.copy().astype(np.int64)
    dsts = dsts.copy().astype(np.int64)
    order_by_class = np.argsort(labels, kind="stable")
    class_sizes = np.bincount(labels, minlength=num_classes)
    class_offsets = np.concatenate([[0], np.cumsum(class_sizes)])
    flip = np.flatnonzero(rng.rand(len(srcs)) < 0.5)
    cs = labels[srcs[flip]]
    ridx = (rng.rand(len(flip)) * np.maximum(class_sizes[cs], 1)).astype(
        np.int64
    )
    dsts[flip] = order_by_class[class_offsets[cs] + ridx]
    hg = from_edges(srcs, dsts, num_nodes=n, make_undirected=True)

    centroids = rng.randn(num_classes, feature_dim).astype(np.float32)
    feats = centroids[labels] + 0.5 * rng.randn(n, feature_dim).astype(
        np.float32
    )
    order = rng.permutation(n)
    n_train, n_valid = int(0.6 * n), int(0.2 * n)
    train_mask = np.zeros(n, bool)
    valid_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[order[:n_train]] = True
    valid_mask[order[n_train : n_train + n_valid]] = True
    test_mask[order[n_train + n_valid :]] = True
    return NodeClassificationDataset(
        graph=hg,
        features=feats,
        labels=labels,
        train_mask=train_mask,
        valid_mask=valid_mask,
        test_mask=test_mask,
        num_classes=num_classes,
        name=f"synthetic-arxiv-s{scale}",
    )
