"""Full-batch GAT training, written out from the paper's equations: the
loss, its gradients and SGD with momentum, from the edge list, features,
labels and initial parameters.

Veličković et al., "Graph Attention Networks" (ICLR 2018,
arXiv:1710.10903), per layer and head k, with ``N(v)`` the sources of v's
in-edges (the caller gives every vertex one self-loop, so ``N(v)`` holds
v)::

    h^k = H W^k
    e_uv = LeakyReLU(a_src^k . h^k_u + a_dst^k . h^k_v)
    alpha_uv = exp(e_uv) / sum_{w in N(v)} exp(e_wv)
    out^k_v = sum_{u in N(v)} alpha_uv h^k_u

Hidden layers concatenate their heads; a layer named in ``skip`` adds its
input to that concatenation; then ELU.  The last layer averages its heads
and feeds the mean softmax cross-entropy over the train vertices.
``m = momentum * m + g``, ``p = p - lr * m``.

Departures from the paper (§3.3, the deep inductive PPI model):

- ``a`` is split into its source and destination halves ``a_src``,
  ``a_dst``: the same score, stored as the program stores it;
- no bias, no dropout and no L2 (the paper's PPI model uses neither of
  the last two; its equations have no bias);
- the skip is an identity added before the ELU (the paper names a skip
  connection across the intermediate layer and gives no form);
- softmax cross-entropy over one label (PPI is multi-label, with a
  sigmoid), full batch instead of 2 graphs a batch, SGD with momentum
  instead of Adam.

The softmax subtracts each destination's largest score (``scatter_reduce``
amax), which changes no value.  The aggregation runs over blocks of edges,
each under ``torch.utils.checkpoint``, so that the gradient keeps no
gathered ``[edges, H d]`` stream: a block's gather is made again in the
backward.  Gradients come from ``torch.autograd``.

``dtype`` is the precision of the whole computation: float64 for the
reference.  The lower-precision controls run in float32 with either
``tf32=True`` (every matrix product's inputs rounded to TF32's 10-bit
mantissa, as the tensor cores read them) or ``bf16_messages=True`` (the
aggregated features rounded to bfloat16, the scores left in float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.gcn import tf32_round

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Edges:
    """Directed edges ``src -> dst`` among ``n`` vertices (pull:
    ``out[dst] += alpha * h[src]``), cut into blocks of ``block`` edges
    for the aggregation."""

    def __init__(self, src, dst, n: int, block: int = 1 << 18):
        self.src, self.dst, self.n, self.block = src, dst, n, block


def _block_sum(hw, alpha, src, dst, n: int):
    """``sum alpha[e, k] hw[src e, k]`` into ``dst e``'s row: ``[n, H,
    d]``."""
    out = hw.new_zeros(n, *hw.shape[1:])
    return out.index_add(0, dst, alpha[:, :, None] * hw[src])


def _aggregate(hw, alpha, edges: Edges):
    out = None
    for lo in range(0, edges.src.numel(), edges.block):
        hi = lo + edges.block
        part = checkpoint(_block_sum, hw, alpha[lo:hi], edges.src[lo:hi],
                          edges.dst[lo:hi], edges.n, use_reentrant=False)
        out = part if out is None else out + part
    return out


def attention(hw, a_src, a_dst, edges: Edges, slope: float,
              messages=None):
    """One layer's heads: ``hw`` ``[n, H, d]`` -> ``[n, H, d]``.
    ``messages`` (``hw`` rounded, for the bf16 control) are what is
    aggregated; the scores always come from ``hw``."""
    s_src = (hw * a_src).sum(-1)  # [n, H]
    s_dst = (hw * a_dst).sum(-1)
    e = F.leaky_relu(s_src[edges.src] + s_dst[edges.dst], slope)  # [m, H]
    idx = edges.dst[:, None].expand_as(e)
    emax = torch.full_like(s_dst, -torch.inf).scatter_reduce(
        0, idx, e.detach(), "amax")
    ex = torch.exp(e - emax[edges.dst])
    den = torch.zeros_like(s_dst).index_add(0, edges.dst, ex)
    alpha = ex / den[edges.dst]
    return _aggregate(hw if messages is None else messages, alpha, edges)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, and its gradients
    likewise: products as the tensor cores form them, forward and
    backward, with float32 sums."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def _mm(tf32: bool):
    return _TF32MatMul.apply if tf32 else torch.matmul


def logits(params, edges: Edges, x, skip=(), slope: float = 0.2,
           tf32: bool = False, bf16_messages: bool = False):
    """The network's ``[n, classes]`` output at ``params`` (``{"w" [H,
    fan_in, d], "a_src" [H, d], "a_dst" [H, d]}`` a layer)."""
    mm = _mm(tf32)
    h = x
    last = len(params) - 1
    for i, p in enumerate(params):
        hw = torch.stack([mm(h, w) for w in p["w"]], dim=1)  # [n, H, d]
        msgs = (hw.to(torch.bfloat16).to(hw.dtype) if bf16_messages
                else None)
        heads = attention(hw, p["a_src"], p["a_dst"], edges, slope, msgs)
        out = heads.flatten(1) if i < last else heads.mean(1)
        if i in skip:
            out = out + h
        h = F.elu(out) if i < last else out
    return h


def loss(params, edges: Edges, x, labels, mask, **kw):
    """Mean softmax cross-entropy over the vertices of ``mask``."""
    logp = torch.log_softmax(logits(params, edges, x, **kw), dim=-1)
    rows = torch.nonzero(mask)[:, 0]
    return -logp[rows, labels[rows]].sum() / rows.numel()


def train(params0, edges: Edges, x, labels, mask, lr: float,
          momentum: float, steps: int, **kw) -> dict:
    """``steps`` SGD-momentum steps from ``params0``: ``{"losses": [...],
    "grads": the first step's gradients, "params": after the last step}``;
    ``kw`` as :func:`logits` takes them."""
    params = [dict(p) for p in params0]
    mom = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    losses, first = [], None
    for _ in range(steps):
        leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
                  for p in params]
        value = loss(leaves, edges, x, labels, mask, **kw)
        flat = torch.autograd.grad(value, [v for p in leaves
                                           for v in p.values()])
        it = iter(flat)
        grads = [{k: next(it) for k in p} for p in leaves]
        losses.append(float(value.detach()))
        first = grads if first is None else first
        mom = [{k: momentum * m[k] + g[k] for k in m}
               for m, g in zip(mom, grads)]
        params = [{k: p[k] - lr * m[k] for k in p}
                  for p, m in zip(params, mom)]
    return dict(losses=losses, grads=first, params=params)
