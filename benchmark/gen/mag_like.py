"""A typed graph of ogbn-mag's published size, made on the device from the
seed.

Each edge type is an R-MAT over its source x destination rectangle at its
published edge count, duplicates kept: the quadrant recursion of
``gen/kronecker.py`` at the larger side's scale, the smaller side keeping
the low bits of its ids, each side renumbered by a random permutation
and restricted to its vertex count, drawing more edges until the count
lies inside.  The target type's labels, features and train split follow
``gen/arxiv_like.py``: a share of each edge type named in
``homophilous`` rewired to a random vertex of the source's class,
features a class centroid plus Gaussian noise, the train vertices a
random subset of the split's size.  Last, an edge type from a type into
itself moves its self loops to ``(u, u + 1 mod n)``.
"""

from __future__ import annotations

import torch

from benchmark.gen.kronecker import kronecker_edges


def generate(cfg: dict, seed: int, device) -> dict:
    """``{"n", "num_nodes", "edges", "x", "labels", "train_mask"}``: the
    vertex count of each type, int64 ``(src, dst)`` ids local to each
    type for each edge type, the target type's float32 features ``[n,
    feature_dim]``, int64 labels and train mask (``n`` counts the target
    type's vertices)."""
    types = {t: int(c) for t, c in cfg["node_types"].items()}
    target = cfg["target"]
    n = types[target]
    C, F = int(cfg["num_classes"]), int(cfg["feature_dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    labels = torch.randint(0, C, (n,), generator=gen, device=device)
    order = torch.argsort(labels, stable=True)
    sizes = torch.bincount(labels, minlength=C)
    starts = torch.cumsum(sizes, 0) - sizes
    edges = {}
    for name, (st, dt, m) in cfg["edge_types"].items():
        src, dst = rectangular_rmat(types[st], types[dt], int(m),
                                    cfg["rmat"], gen, device)
        if name in cfg.get("homophilous", ()):
            # class-assortative rewiring, as gen/arxiv_like.py
            if st != target or dt != target:
                raise ValueError(f"{name} does not join {target} to itself")
            flip = (torch.rand(src.numel(), generator=gen, device=device)
                    < cfg["homophily"])
            cls = labels[src]
            pick = (torch.rand(src.numel(), generator=gen, device=device,
                               dtype=torch.float64)
                    * sizes[cls].clamp(min=1)).to(torch.int64)
            dst = torch.where(flip, order[starts[cls] + pick], dst)
        if st == dt:
            dst = torch.where(src == dst, (dst + 1) % types[dt], dst)
        edges[name] = (src, dst)
    centroids = torch.randn(C, F, generator=gen, device=device)
    x = centroids[labels] + cfg["feature_noise"] * torch.randn(
        n, F, generator=gen, device=device)
    split = cfg["split"]
    if sum(split.values()) != n:
        raise ValueError(f"split {split} does not cover {n} vertices")
    perm = torch.randperm(n, generator=gen, device=device)
    train_mask = torch.zeros(n, dtype=torch.bool, device=device)
    train_mask[perm[: split["train"]]] = True
    return dict(n=n, num_nodes=types, edges=edges, x=x, labels=labels,
                train_mask=train_mask)


def rectangular_rmat(n_src: int, n_dst: int, m: int, abc: dict, gen,
                     device):
    """``m`` R-MAT edges from ``n_src`` vertices into ``n_dst``, renumbered
    ``0..n-1`` on each side."""
    s_bits = max(1, (n_src - 1).bit_length())
    d_bits = max(1, (n_dst - 1).bit_length())
    scale = max(s_bits, d_bits)
    perm_s = torch.randperm(1 << s_bits, generator=gen, device=device)
    perm_d = torch.randperm(1 << d_bits, generator=gen, device=device)
    keep_share = n_src / (1 << s_bits) * n_dst / (1 << d_bits)
    srcs, dsts, have = [], [], 0
    while have < m:
        draw = int((m - have) / keep_share * 1.2) + 1024
        s, d = kronecker_edges(scale, draw, abc["A"], abc["B"], abc["C"],
                               gen, device)
        s = perm_s[s & ((1 << s_bits) - 1)]
        d = perm_d[d & ((1 << d_bits) - 1)]
        inside = (s < n_src) & (d < n_dst)
        srcs.append(s[inside])
        dsts.append(d[inside])
        have += int(srcs[-1].numel())
    return torch.cat(srcs)[:m], torch.cat(dsts)[:m]
