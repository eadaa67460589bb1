"""The models' shared optimizer: SGD with momentum over a list of
parameter dicts, the contract of the JAX package's ``*_train_step``s
(``m = 0.9 m + grad; p = p - lr m``)."""

from __future__ import annotations

from typing import Callable

import torch

from mini_tpu_torch.utils.profiling import scope


def init_opt(params: list[dict]) -> list[dict]:
    """SGD-momentum state: zeros like the params."""
    return [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]


def sgd_momentum_step(
    params: list[dict],
    opt_state: list[dict],
    loss_fn: Callable[[list[dict]], torch.Tensor],
    lr: float,
    reduce_grads: Callable[[list], list] | None = None,
):
    """One step: the gradient of ``loss_fn`` at ``params`` by
    ``torch.autograd.grad``, then the momentum update.  Returns
    ``(new_params, new_opt, loss)``; the inputs are left as they were.
    ``reduce_grads`` maps the gradients before the update (the
    distributed steps sum them over the ranks).  A parameter the loss
    does not reach (an output no loss reads, as R-GCN's last layer has)
    takes a zero gradient.  While a profiler runs,
    the three phases are the spans ``step.forward``, ``step.backward``
    and ``step.update`` (``reduce_grads`` in the last)."""
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in params]
    with scope("step.forward"):
        loss = loss_fn(leaves)
    flat = [v for p in leaves for v in p.values()]
    with scope("step.backward"):
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(v) if d is None else d
                 for v, d in zip(flat, grads)]
    with scope("step.update"):
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        grads = iter(grads)
        new_opt, new_params = [], []
        for p, m in zip(params, opt_state):
            mo = {k: 0.9 * m[k] + next(grads) for k in p}
            new_opt.append(mo)
            new_params.append({k: p[k] - lr * mo[k] for k in p})
    return new_params, new_opt, loss.detach()
