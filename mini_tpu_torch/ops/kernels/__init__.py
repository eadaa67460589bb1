"""Hand-written CUDA kernels (sources in ``mini_tpu_torch/csrc/``), each
beside its plain torch version.  The counterpart of
``mini_tpu/ops/pallas/``."""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through kernel ``name``.

    A kernel fills its output through a raw pointer, so the result carries
    no ``grad_fn``: returned where an input requires grad, it would drop
    that input's gradient without a word.  Inside a
    ``torch.autograd.Function.forward`` (or under ``torch.no_grad()``)
    grad mode is off and the call passes; the Function's backward then
    supplies the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel cannot carry gradients: an input requires "
            "grad and grad mode is on; call it inside a "
            "torch.autograd.Function (as ops/spmm.py does) or under "
            "torch.no_grad()"
        )
