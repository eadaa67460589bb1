"""A graph of ogbn-arxiv's published size, made on the device from the seed.

The port's ``graph/datasets.synthetic_arxiv_like`` recipe, in torch and at
the exact vertex and edge counts: an R-MAT topology, half of the edges
rewired to a random vertex of the source's class (homophily, so that
aggregation carries signal), features a class centroid plus Gaussian
noise, and OGB's split sizes.  The R-MAT is drawn at the next power of two
and restricted to a random ``num_nodes`` of its vertices, drawing more
edges until ``num_edges`` lie inside.
"""

from __future__ import annotations

import torch

from benchmark.gen.kronecker import kronecker_edges


def generate(cfg: dict, seed: int, device) -> dict:
    """``{"n", "src", "dst", "x", "labels", "train_mask"}``: ``num_edges``
    directed int64 edges among ``num_nodes`` vertices, float32 features
    ``[n, feature_dim]``, int64 labels and the train split's mask."""
    n, m = int(cfg["num_nodes"]), int(cfg["num_edges"])
    C, F = int(cfg["num_classes"]), int(cfg["feature_dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    labels = torch.randint(0, C, (n,), generator=gen, device=device)
    src, dst = _restricted_rmat(n, m, cfg["rmat"], gen, device)
    dst = torch.where(src == dst, (dst + 1) % n, dst)

    # class-assortative rewiring: a share of the edges point to a random
    # vertex of the source's class
    order = torch.argsort(labels, stable=True)
    sizes = torch.bincount(labels, minlength=C)
    starts = torch.cumsum(sizes, 0) - sizes
    flip = torch.rand(m, generator=gen, device=device) < cfg["homophily"]
    cls = labels[src]
    pick = (torch.rand(m, generator=gen, device=device, dtype=torch.float64)
            * sizes[cls].clamp(min=1)).to(torch.int64)
    dst = torch.where(flip, order[starts[cls] + pick], dst)

    centroids = torch.randn(C, F, generator=gen, device=device)
    x = centroids[labels] + cfg["feature_noise"] * torch.randn(
        n, F, generator=gen, device=device)
    split = cfg["split"]
    if sum(split.values()) != n:
        raise ValueError(f"split {split} does not cover {n} vertices")
    perm = torch.randperm(n, generator=gen, device=device)
    train_mask = torch.zeros(n, dtype=torch.bool, device=device)
    train_mask[perm[: split["train"]]] = True
    return dict(n=n, src=src, dst=dst, x=x, labels=labels,
                train_mask=train_mask)


def _restricted_rmat(n: int, m: int, abc: dict, gen, device):
    """``m`` R-MAT edges among a random ``n`` of the next power of two's
    vertices, renumbered ``0..n-1``."""
    scale = max(1, (n - 1).bit_length())
    big = 1 << scale
    perm = torch.randperm(big, generator=gen, device=device)
    keep_share = (n / big) ** 2
    srcs, dsts, have = [], [], 0
    while have < m:
        draw = int((m - have) / keep_share * 1.2) + 1024
        s, d = kronecker_edges(scale, draw, abc["A"], abc["B"], abc["C"],
                               gen, device)
        s, d = perm[s], perm[d]
        inside = (s < n) & (d < n)
        srcs.append(s[inside])
        dsts.append(d[inside])
        have += int(srcs[-1].numel())
    return torch.cat(srcs)[:m], torch.cat(dsts)[:m]
