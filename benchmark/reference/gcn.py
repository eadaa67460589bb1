"""Full-batch GCN training, written out by hand: the loss, the gradients
and SGD with momentum, from the generated edges, features, labels and
initial parameters.

Each layer is ``H' = act(Â (H W) + b)`` with ``Â = D̂^-1/2 (A + I)
D̂^-1/2`` and ``D̂ = in-degree + 1`` (Kipf and Welling; the normalization
of the program's ``gcn_normalize``, worked out again here from the edge
list); ReLU between layers, none after the last; the loss is the mean
softmax cross-entropy over the train vertices; ``m = momentum * m + g``,
``p = p - lr * m``.  The aggregation runs over blocks of edges so that a
graph of millions of edges fits beside the activations.

``dtype`` is the precision of the whole computation: float64 for the
reference.  ``tf32=True`` rounds every matrix product's inputs to TF32's
10-bit mantissa (float32 sums): the lower-precision control.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even), as
    the tensor cores read a TF32 operand."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


class Adjacency:
    """Â's off-diagonal part over directed edges ``src -> dst`` (pull:
    ``out[dst] += w * h[src]``) and its diagonal ``1 / D̂``."""

    def __init__(self, src, dst, n: int, dtype, block: int = 1 << 20):
        deg_hat = torch.bincount(dst, minlength=n).to(dtype) + 1
        inv_sqrt = deg_hat.rsqrt()
        self.src, self.dst, self.block = src, dst, block
        self.w = inv_sqrt[src] * inv_sqrt[dst]
        self.diag = (1.0 / deg_hat)[:, None]

    def _apply(self, h, frm, to):
        out = self.diag * h
        for lo in range(0, frm.numel(), self.block):
            f, t = frm[lo:lo + self.block], to[lo:lo + self.block]
            out.index_add_(0, t, h[f] * self.w[lo:lo + self.block, None])
        return out

    def pull(self, h):
        """``Â h``."""
        return self._apply(h, self.src, self.dst)

    def push(self, g):
        """``Âᵀ g``: the gradient of :meth:`pull`."""
        return self._apply(g, self.dst, self.src)


def _mm(tf32: bool):
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(tf32_round(a), tf32_round(b))


def loss_and_grads(params, adj: Adjacency, x, labels, mask, tf32=False):
    """``(loss, [{"w": dw, "b": db}, ...])`` at ``params``."""
    mm = _mm(tf32)
    hs, pre = [x], []
    h = x
    for i, p in enumerate(params):
        a = adj.pull(mm(h, p["w"])) + p["b"]
        pre.append(a)
        h = torch.relu(a) if i < len(params) - 1 else a
        hs.append(h)
    count = mask.sum()
    logp = torch.log_softmax(h, dim=-1)
    rows = torch.nonzero(mask)[:, 0]
    loss = -logp[rows, labels[rows]].sum() / count
    g = torch.softmax(h, dim=-1)
    g[rows, labels[rows]] -= 1
    g = g * (mask[:, None].to(g.dtype) / count)
    grads = [None] * len(params)
    for i in reversed(range(len(params))):
        dz = adj.push(g)
        grads[i] = {"w": mm(hs[i].transpose(0, 1), dz), "b": g.sum(0)}
        if i:
            g = mm(dz, params[i]["w"].transpose(0, 1)) * (pre[i - 1] > 0)
    return loss, grads


def train(params0, adj: Adjacency, x, labels, mask, lr: float,
          momentum: float, steps: int, tf32: bool = False) -> dict:
    """``steps`` SGD-momentum steps from ``params0``: ``{"losses": [...],
    "grads": the first step's gradients, "params": after the last step}``."""
    params = [dict(p) for p in params0]
    mom = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(params, adj, x, labels, mask, tf32)
        losses.append(float(loss))
        first = grads if first is None else first
        mom = [{k: momentum * m[k] + gr[k] for k in m}
               for m, gr in zip(mom, grads)]
        params = [{k: p[k] - lr * m[k] for k in p}
                  for p, m in zip(params, mom)]
    return dict(losses=losses, grads=first, params=params)
