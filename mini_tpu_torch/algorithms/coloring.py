"""Jones-Plassmann-style hash graph coloring.

gunrock's recipe (`coloring/coloring_enactor.hxx:41-97`): each round, two
neighbourhood reductions find the max and min neighbour hash among the
*uncolored* vertices (`coloring/coloring_functor.hxx:40-65`); strict local
minima take color ``2*iter+1`` and strict local maxima ``2*iter+2``
(`coloring/coloring_functor.hxx:11-29`); the hashes are drawn anew each
round (`coloring/coloring_problem.hxx:53-57`).

As in ``mini_tpu``, one round tries ``hashes_per_round`` = K hash orders
(K=1 is the reference's recipe, hashes drawn in ``[0, prime)``; K > 1
re-derives order j from one value per vertex by a 32-bit finaliser).  "v
is the strict min under order j" is "no uncolored out-neighbour u has
``pri_j(u) <= pri_j(v)``", so each (order, min/max) slot gives one blocker
bit per edge, the 2K bits pack into one int32 word, and one launch of the
segment-reduce kernel's ``bor`` reduces them all.  A vertex takes the
color of its first clear slot.  The loop runs on the host, with one
device-to-host read a round (whether a vertex is left uncolored).

Two paths, as in ``mini_tpu``, with the same colors:

* the fast path (undirected graph, K > 1, equal in- and out-degrees):
  ``pri_j(v) = mix(v ^ salt, j)`` from one 32-bit salt a round; an edge's
  "dst uncolored" bit is ``colors[dst] == 0``, one gather (``mini_tpu``
  keeps that bit per edge, updated by a scatter or rebuilt by a sort, to
  spare the TPU a permutation);
* the generic path: a seed in ``[0, prime)`` per vertex a round, the
  dst's seed and its uncolored bit gathered per edge.

``torch`` cannot draw ``jax.random``'s bits, so each path takes its
randomness from its caller (``_coloring_fast``: a salt per round;
``_coloring_generic``: a seed array per round); :func:`coloring` draws
them from one CPU ``torch.Generator`` seeded with ``seed``, so a run on
the card and one on the CPU give the same colors.

The reduce runs over out-edges only, as ``mini_tpu``'s does, so on a
directed graph two vertices joined by one edge can take one color (an
improper coloring; ``tests/test_torch_coloring.py`` pins it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mini_tpu_torch.graph.csr import GraphSlice, HostGraph
from mini_tpu_torch.ops.engine import dst_vals_to_csr, reduce_csr_by_src

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ColoringResult:
    colors: torch.Tensor  # int32[n_pad]; >0 once assigned
    num_iterations: int


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``: ``c`` in two
    16-bit halves keeps every product below 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


class _Slots:
    """The constants of K hash orders on one device, made once a call (a
    tensor made from a list mid-round would wait for the stream)."""

    def __init__(self, K: int, device):
        self.K = K
        self.salts = torch.tensor(  # mini_tpu's _mix constant of order j
            [((j + 1) * 0x9E3779B9) & _M32 for j in range(K)],
            dtype=torch.int64, device=device)
        self.bits = torch.tensor(  # 1 << s as int32 words, bit 31 the sign
            [1 << b if b < 31 else -2**31 for b in range(2 * K)],
            dtype=torch.int32, device=device)
        self.shifts = torch.arange(2 * K, dtype=torch.int32, device=device)

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """``[len(x), K]`` int32: ``mini_tpu``'s ``_mix(x, j)`` for j < K (a
        murmur3-style finaliser of x's 32 bits), less 2^31, so that the
        int32 order is the uint32 order of the mix."""
        h = (x.long() & _M32)[:, None] ^ self.salts
        h = h ^ (h >> 16)
        h = _mul32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        h = _mul32(h, 0xC2B2AE35)
        h = h ^ (h >> 16)
        return (h - 2**31).to(torch.int32)

    def blocked(self, g: GraphSlice, table: torch.Tensor,
                unc_e: torch.Tensor) -> torch.Tensor:
        """Each vertex's 2K blocker bits, or-ed over its out-edges: bit 2j
        when an uncolored dst's priority under order j is <= its own (no
        min claim), bit 2j+1 when >= (no max claim); ``table`` is ``[n_pad,
        K]``, one priority a vertex and order.  One ``bor`` launch; bit 31
        is the int32 sign, which only the bitwise ops read."""
        pe = table.index_select(0, g.csr_dsts)
        po = table.index_select(0, g.csr_srcs)
        claims = torch.stack([pe <= po, pe >= po], dim=2).view(
            -1, 2 * self.K)
        acc = torch.where(claims & unc_e[:, None], self.bits, 0).sum(
            1, dtype=torch.int32)  # distinct bits: the sum is the or
        return reduce_csr_by_src(g, acc, "bor", identity=0)

    def assign(self, colors, uncolored, blocked, it: int) -> torch.Tensor:
        """Each uncolored vertex with a clear slot takes the color of its
        first one, slot s of round ``it`` being color ``2K*it + s + 1``."""
        free = ((blocked[:, None] >> self.shifts) & 1) == 0
        first = free.to(torch.uint8).argmax(1).to(torch.int32)
        return torch.where(uncolored & free.any(1),
                           2 * self.K * it + 1 + first, colors)


def _coloring_fast(g: GraphSlice, salt: Callable[[int], int], max_iter: int,
                   hashes_per_round: int) -> ColoringResult:
    """The fast path: ``salt(it)`` is round ``it``'s uint32 salt."""
    slots = _Slots(hashes_per_round, g.device)
    real = g.vertex_mask()
    ids = torch.arange(g.n_pad, dtype=torch.int64, device=g.device)
    colors = torch.zeros(g.n_pad, dtype=torch.int32, device=g.device)
    it = 0
    while it < max_iter:
        uncolored = (colors == 0) & real
        if not bool(uncolored.any()):  # the round's one read
            break
        unc_e = dst_vals_to_csr(g, colors) == 0
        blocked = slots.blocked(g, slots.mix(ids ^ salt(it)), unc_e)
        colors = slots.assign(colors, uncolored, blocked, it)
        it += 1
    return ColoringResult(colors, it)


def _coloring_generic(g: GraphSlice, seeds: Callable[[int], torch.Tensor],
                      max_iter: int,
                      hashes_per_round: int) -> ColoringResult:
    """The generic path: ``seeds(it)`` is round ``it``'s int32 ``[n_pad]``
    seeds in ``[0, prime)``, on any device (copied at the round's start,
    when the stream is idle after the round's read)."""
    slots = _Slots(hashes_per_round, g.device)
    real = g.vertex_mask()
    colors = torch.zeros(g.n_pad, dtype=torch.int32, device=g.device)
    it = 0
    while it < max_iter:
        uncolored = (colors == 0) & real
        if not bool(uncolored.any()):  # the round's one read
            break
        s = seeds(it).to(g.device)
        table = s[:, None] if hashes_per_round == 1 else slots.mix(s)
        blocked = slots.blocked(g, table, dst_vals_to_csr(g, uncolored))
        colors = slots.assign(colors, uncolored, blocked, it)
        it += 1
    return ColoringResult(colors, it)


def coloring(
    g: GraphSlice,
    prime: int = 1000003,
    max_iter: int | None = None,
    seed: int = 0,
    hashes_per_round: int = 16,
) -> ColoringResult:
    """Color ``g`` on its device in at most ``max_iter`` rounds (default
    ``max(2n, 64)``).  ``hashes_per_round=1`` is the reference's recipe
    (hashes in ``[0, prime)``); K > 1 (up to 16) uses mixed priorities,
    where ``prime`` has no effect, and takes the fast path on an
    undirected graph with equal in- and out-degrees."""
    if max_iter is None:
        max_iter = max(2 * g.n, 64)
    K = int(hashes_per_round)
    if not 1 <= K <= 16:
        raise ValueError(f"hashes_per_round={K}: the 2K blocker bits must "
                         "fit one 32-bit word (1 <= K <= 16)")
    gen = torch.Generator().manual_seed(seed)
    if (K > 1 and not g.directed
            # mini_tpu's test for its fast path, whose per-edge colored
            # bit needs equal in- and out-degrees, not just the flag (one
            # read)
            and torch.equal(g.out_degrees, g.in_degrees)):
        return _coloring_fast(
            g, lambda it: int(torch.randint(2**32, (), generator=gen)),
            int(max_iter), K)
    return _coloring_generic(
        g, lambda it: torch.randint(int(prime), (g.n_pad,), generator=gen,
                                    dtype=torch.int32),
        int(max_iter), K)


def validate_coloring(colors: np.ndarray, hg: HostGraph) -> bool:
    """Oracle check (absent in the reference, which only displays colors,
    `tests/coloring/test_coloring.cu:44`): every vertex colored, no two
    adjacent vertices (excluding self-loops) share a color."""
    if (colors[: hg.n] <= 0).any():
        return False
    s, d = hg.csr_srcs, hg.csr_dsts
    off_diag = s != d
    return not np.any(colors[s[off_diag]] == colors[d[off_diag]])
