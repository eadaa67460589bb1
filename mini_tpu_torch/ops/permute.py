"""Fixed-permutation apply: ``out[rank[i]] = payload[i]``.

The JAX package moves per-edge values between static orders (CSR <-> CSC,
edge order <-> banded order, pull bands <-> push bands) with one
``lax.sort`` keyed by the rank, because the TPU has no fast scatter
(``mini_tpu/ops/permute.py``).  On Hopper the permutation is one launch
of the ``permute`` kernel (ops/kernels/permute_kernel.py), a scatter by
the rank, with every payload moved in the same launch.

JAX's ``expand_to_edges`` (a delta-cumsum broadcast of per-vertex values
onto sorted segments) is ported as its result: a gather by the segment id
of each slot, which a banded layout builds once on the host
(``BandedLayout.dev()["seg"]``).  The sort-key salting and
``apply_fixed_perm_bit`` are TPU workarounds and are not ported.
"""

from __future__ import annotations

import torch

from mini_tpu_torch.ops.kernels.permute_kernel import permute


class _FixedPerm(torch.autograd.Function):
    """Float payloads through the permutation kernel; the gradient is the
    inverse permutation (a permutation's transpose), the same kernel run
    with ``inverse=True``."""

    @staticmethod
    def forward(ctx, rank, *payloads):
        ctx.save_for_backward(rank)
        return tuple(permute(rank, payloads))

    @staticmethod
    def backward(ctx, *cts):
        (rank,) = ctx.saved_tensors
        return (None, *permute(rank, cts, inverse=True))


def apply_fixed_perm(rank: torch.Tensor, *payloads: torch.Tensor):
    """Return the payloads permuted so ``output[rank[i]] = payload[i]``
    (one tensor for one payload, else a tuple), as JAX's
    ``apply_fixed_perm``.  ``rank`` must be an int32 permutation of
    ``[0, m)`` and every payload ``[m]``.  Float payloads are
    differentiable: the gradient is the inverse permutation."""
    if payloads and all(p.dtype.is_floating_point for p in payloads):
        outs = _FixedPerm.apply(rank, *payloads)
    else:
        outs = tuple(permute(rank, payloads))
    return outs[0] if len(outs) == 1 else tuple(outs)
