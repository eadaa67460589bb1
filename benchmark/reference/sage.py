"""Full-batch GraphSAGE training (the mean aggregator with a root weight),
written out by hand: the loss, the gradients and SGD with momentum, from
the generated edges, features, labels and initial parameters.

Hamilton et al. 2017 with the mean aggregator, as OGB's ogbn-products
example runs it (``SAGEConv``: the vertex's own row and the mean of its
in-neighbours' rows, each through its own weight)::

    agg_v = (1 / in_deg(v)) sum_{edges u -> v} h_u     (0 where in_deg is 0)
    h'_v = act( h_v W_self + agg_v W_neigh + b )

``W_self`` and ``W_neigh`` are the first and last ``d_in`` rows of the
program's ``w`` (``[2 d_in, d_out]``, its ``[h ; agg] @ w``).  ReLU
between layers, none after the last; the loss is the mean softmax
cross-entropy over the train vertices; ``m = momentum * m + g``, ``p = p
- lr * m``.  Duplicate edges count as often as they occur.  The mean runs
over blocks of edges (``index_add_``) so that a graph of a hundred
million edges fits beside the activations; its transpose, for the
gradient, pushes each cotangent row scaled by ``1 / in_deg`` back along
the same edges.

``dtype`` is the precision of the whole computation: float64 for the
reference.  The lower-precision controls run in float32 with either
``tf32=True`` (every matrix product's inputs rounded to TF32's 10-bit
mantissa, as the tensor cores read them) or ``bf16_messages=True`` (the
rows each aggregation sums, forward and backward, rounded to bfloat16).
"""

from __future__ import annotations

import torch

from benchmark.reference.gcn import _mm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Mean:
    """The mean over in-edges of directed edges ``src -> dst`` among ``n``
    vertices: :meth:`pull` and its transpose :meth:`push`."""

    def __init__(self, src, dst, n: int, dtype, block: int = 1 << 20):
        deg = torch.bincount(dst, minlength=n).to(dtype)
        self.inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0)
        self.src, self.dst, self.n, self.block = src, dst, n, block

    def _sum(self, h, frm, to, bf16):
        if bf16:
            h = h.to(torch.bfloat16).to(h.dtype)
        out = h.new_zeros(self.n, h.shape[1])
        for lo in range(0, frm.numel(), self.block):
            f, t = frm[lo:lo + self.block], to[lo:lo + self.block]
            out.index_add_(0, t, h[f])
        return out

    def pull(self, h, bf16=False):
        """``agg[v] = mean of h[u]`` over the edges ``u -> v``."""
        return self._sum(h, self.src, self.dst, bf16) * self.inv_deg[:, None]

    def push(self, g, bf16=False):
        """The transpose of :meth:`pull`: ``out[u] = sum g[v] / in_deg(v)``
        over the edges ``u -> v``."""
        return self._sum(g * self.inv_deg[:, None], self.dst, self.src, bf16)


def forward(params, mean: Mean, x, tf32=False, bf16_messages=False):
    """``(hs, aggs)``: each layer's input and, last, the logits; each
    layer's mean of its input."""
    mm = _mm(tf32)
    hs, aggs = [x], []
    h = x
    for i, p in enumerate(params):
        F = h.shape[1]
        agg = mean.pull(h, bf16_messages)
        aggs.append(agg)
        h = mm(h, p["w"][:F]) + mm(agg, p["w"][F:]) + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
        hs.append(h)
    return hs, aggs


def loss_and_grads(params, mean: Mean, x, labels, mask, tf32=False,
                   bf16_messages=False):
    """``(loss, [{"w": dw, "b": db}, ...])`` at ``params``."""
    mm = _mm(tf32)
    hs, aggs = forward(params, mean, x, tf32, bf16_messages)
    h = hs[-1]
    count = mask.sum()
    logp = torch.log_softmax(h, dim=-1)
    rows = torch.nonzero(mask)[:, 0]
    loss = -logp[rows, labels[rows]].sum() / count
    g = torch.softmax(h, dim=-1)
    g[rows, labels[rows]] -= 1
    g = g * (mask[:, None].to(g.dtype) / count)
    grads = [None] * len(params)
    for i in reversed(range(len(params))):
        h_in, agg, w = hs[i], aggs[i], params[i]["w"]
        F = h_in.shape[1]
        grads[i] = {"w": torch.cat([mm(h_in.transpose(0, 1), g),
                                    mm(agg.transpose(0, 1), g)]),
                    "b": g.sum(0)}
        if i:
            dh = (mm(g, w[:F].transpose(0, 1))
                  + mean.push(mm(g, w[F:].transpose(0, 1)), bf16_messages))
            g = dh * (h_in > 0)  # h_in = relu(pre): pre > 0 where h_in > 0
        hs[i + 1] = aggs[i] = None
    return loss, grads


def train(params0, mean: Mean, x, labels, mask, lr: float, momentum: float,
          steps: int, tf32: bool = False, bf16_messages: bool = False) -> dict:
    """``steps`` SGD-momentum steps from ``params0``: ``{"losses": [...],
    "grads": the first step's gradients, "params": after the last step}``."""
    params = [dict(p) for p in params0]
    mom = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(params, mean, x, labels, mask, tf32,
                                     bf16_messages)
        losses.append(float(loss))
        first = grads if first is None else first
        mom = [{k: momentum * m[k] + gr[k] for k in m}
               for m, gr in zip(mom, grads)]
        params = [{k: p[k] - lr * m[k] for k in p}
                  for p, m in zip(params, mom)]
    return dict(losses=losses, grads=first, params=params)
