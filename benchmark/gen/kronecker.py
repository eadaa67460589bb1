"""Graph500's Kronecker graph, made on the device from the seed.

The recursive quadrant sampling of the port's ``graph/generators.rmat``
(and of the Graph500 reference code), written in torch so that a scale-20
edge list takes a few large calls on the card instead of seconds of NumPy
on the host.  The edges are directed as generated; the configuration's
``undirected`` says that the program and the reference take both
directions of each.
"""

from __future__ import annotations

import torch


def generate(cfg: dict, seed: int, device) -> dict:
    """``{"n", "src", "dst", "weights", "roots"}``: ``n = 2**scale``
    vertices, ``n * edgefactor`` int64 edges, float32 integer weights in
    ``[1, max_weight)``, and ``search_roots`` distinct roots of degree
    >= 1, all drawn from ``seed`` on ``device``."""
    scale, ef = int(cfg["scale"]), int(cfg["edgefactor"])
    n, m = 1 << scale, (1 << scale) * ef
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    src, dst = kronecker_edges(scale, m, cfg["A"], cfg["B"], cfg["C"], gen,
                               device)
    if cfg.get("permute_vertices", True):
        perm = torch.randperm(n, generator=gen, device=device)
        src, dst = perm[src], perm[dst]
    dst = torch.where(src == dst, (dst + 1) % n, dst)
    weights = torch.randint(1, int(cfg["max_weight"]), (m,), generator=gen,
                            device=device).to(torch.float32)
    roots = draw_roots(src, dst, n, int(cfg["search_roots"]), gen)
    return dict(n=n, src=src, dst=dst, weights=weights, roots=roots)


def kronecker_edges(scale: int, m: int, a: float, b: float, c: float, gen,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """``m`` edges of a ``2**scale``-vertex Kronecker graph: per bit, the
    source half with probability ``a + b`` of the upper one, then the
    destination half given it."""
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(2, m, generator=gen, device=device, dtype=torch.float64)
        s_bit = r[0] > ab
        d_bit = torch.where(s_bit, r[1] > c_norm, r[1] > a_norm)
        src |= s_bit.to(torch.int64) << bit
        dst |= d_bit.to(torch.int64) << bit
    return src, dst


def draw_roots(src, dst, n: int, count: int, gen) -> torch.Tensor:
    """``count`` distinct vertices of degree >= 1 (either direction), in a
    random order drawn from ``gen``: Graph500's search keys."""
    deg = torch.bincount(src, minlength=n) + torch.bincount(dst, minlength=n)
    order = torch.randperm(n, generator=gen, device=src.device)
    roots = order[deg[order] > 0][:count]
    if roots.numel() < count:
        raise ValueError(f"the graph has {roots.numel()} vertices of degree "
                         f">= 1, fewer than {count} roots")
    return roots
