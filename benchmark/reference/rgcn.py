"""Full-batch R-GCN training on a typed graph, written out by hand: the
loss, the gradients of every parameter (the embedding tables included)
and SGD with momentum, from the generated edges, features, labels and
initial parameters.

Schlichtkrull et al. 2018's layer with the mean over each relation, as
OGB's ogbn-mag example (``examples/nodeproppred/mag/rgcn.py``) runs it::

    agg_r[v] = (1 / deg_r(v)) sum_{edges u -> v of r} h_u   (0 where deg_r is 0)
    h'_v = act( h_v W_root[t] + b[t] + sum_{r into t} agg_r[v] W_r )

for a vertex ``v`` of type ``t``; ReLU between layers, none after the
last; every type's outputs are formed in the last layer, and the loss is
the mean softmax cross-entropy over the target type's train vertices;
``m = momentum * m + g``, ``p = p - lr * m``.  Types without features
take a learned embedding table as their first input.  The parameters
are the program's: a list of dicts, first ``{"emb.<type>"}``, then a dict
a layer of ``"root.<type>"``, ``"bias.<type>"`` and ``"rel.<name>"``.

Departures from the example: SGD with momentum in place of Adam, no
dropout (the example has 0.5 between layers), duplicate edges counted as
often as they occur (the example's ``to_undirected`` merges the cites
duplicates), and every parameter Glorot-uniform (the example's linear
layers draw theirs as ``torch.nn.Linear`` does).  A parameter that only
outputs no loss reads reach has a zero gradient.

Each relation's mean runs over blocks of edges (``index_add_``), so no
``[m, F]`` gather of a whole relation exists at once; its transpose, for
the gradient, pushes each cotangent row scaled by ``1 / deg_r`` back
along the same edges.

``dtype`` is the precision of the whole computation: float64 for the
reference.  The lower-precision controls run in float32 with
``tf32=True`` (every matrix product's inputs rounded to TF32's 10-bit
mantissa) or ``bf16_messages=True`` (the rows each mean sums, forward and
backward, rounded to bfloat16).  The planted faults: ``skip`` (relations
left out of the forward) and ``summed`` (relations summed, not
averaged).
"""

from __future__ import annotations

import torch

from benchmark.reference.gcn import _mm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class RelationMean:
    """The mean over a relation's in-edges, directed edges ``src -> dst``
    from ``n_src`` vertices into ``n_dst``: :meth:`pull` and its transpose
    :meth:`push`.  ``summed=True`` leaves the sums undivided (a fault)."""

    def __init__(self, src, dst, n_src: int, n_dst: int, dtype,
                 summed: bool = False, block: int = 1 << 20):
        deg = torch.bincount(dst, minlength=n_dst).to(dtype)
        self.inv_deg = (torch.ones_like(deg) if summed else
                        torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0))
        self.src, self.dst, self.block = src, dst, block
        self.n_src, self.n_dst = n_src, n_dst

    def _sum(self, h, frm, to, rows, bf16):
        if bf16:
            h = h.to(torch.bfloat16).to(h.dtype)
        out = h.new_zeros(rows, h.shape[1])
        for lo in range(0, frm.numel(), self.block):
            f, t = frm[lo:lo + self.block], to[lo:lo + self.block]
            out.index_add_(0, t, h[f])
        return out

    def pull(self, h, bf16=False):
        """``agg[v] = mean of h[u]`` over the edges ``u -> v``."""
        return (self._sum(h, self.src, self.dst, self.n_dst, bf16)
                * self.inv_deg[:, None])

    def push(self, g, bf16=False):
        """The transpose of :meth:`pull`: ``out[u] = sum g[v] / deg(v)``
        over the edges ``u -> v``."""
        return self._sum(g * self.inv_deg[:, None], self.dst, self.src,
                         self.n_src, bf16)


def forward(params, types, rels, x, tf32=False, bf16_messages=False,
            skip=()):
    """``(hs, aggs)``: each layer's input (type -> rows) and, last, the
    outputs; each layer's relation means (name -> rows).  ``rels``:
    ``[(name, src type, dst type, RelationMean)]``."""
    mm = _mm(tf32)
    h = {**x, **{k.split(".", 1)[1]: v for k, v in params[0].items()}}
    hs, aggs = [h], []
    layers = params[1:]
    for i, p in enumerate(layers):
        out = {t: mm(h[t], p[f"root.{t}"]) + p[f"bias.{t}"] for t in types}
        agg = {}
        for name, st, dt, mean in rels:
            if name in skip:
                continue
            agg[name] = mean.pull(h[st], bf16_messages)
            out[dt] = out[dt] + mm(agg[name], p[f"rel.{name}"])
        if i < len(layers) - 1:
            out = {t: torch.relu(v) for t, v in out.items()}
        aggs.append(agg)
        hs.append(out)
        h = out
    return hs, aggs


def loss_and_grads(params, types, rels, x, labels, mask, target: str,
                   tf32=False, bf16_messages=False, skip=()):
    """``(loss, grads)`` at ``params``, ``grads`` in their layout."""
    mm = _mm(tf32)
    hs, aggs = forward(params, types, rels, x, tf32, bf16_messages, skip)
    logits = hs[-1][target]
    count = mask.sum()
    logp = torch.log_softmax(logits, dim=-1)
    rows = torch.nonzero(mask)[:, 0]
    loss = -logp[rows, labels[rows]].sum() / count
    g = torch.softmax(logits, dim=-1)
    g[rows, labels[rows]] -= 1
    g_out = {target: g * (mask[:, None].to(g.dtype) / count)}
    embedded = {k.split(".", 1)[1] for k in params[0]}
    grads = [None] * len(params)
    for i in reversed(range(len(params) - 1)):
        p, h_in = params[i + 1], hs[i]
        # a layer's input takes a gradient unless it is a first layer's
        # features
        takes = (lambda t: True) if i else (lambda t: t in embedded)
        got, dh = {}, {}

        def add(t, v):
            dh[t] = v if t not in dh else dh[t] + v

        for t in types:
            gt = g_out.get(t)
            if gt is None:
                continue
            got[f"root.{t}"] = mm(h_in[t].transpose(0, 1), gt)
            got[f"bias.{t}"] = gt.sum(0)
            if takes(t):
                add(t, mm(gt, p[f"root.{t}"].transpose(0, 1)))
        for name, st, dt, mean in rels:
            gt = g_out.get(dt)
            if gt is None or name in skip:
                continue
            got[f"rel.{name}"] = mm(aggs[i][name].transpose(0, 1), gt)
            if takes(st):
                add(st, mean.push(mm(gt, p[f"rel.{name}"].transpose(0, 1)),
                                  bf16_messages))
        grads[i + 1] = {k: got[k] if k in got else torch.zeros_like(v)
                        for k, v in p.items()}
        if i:  # h_in = relu(pre): pre > 0 where h_in > 0
            g_out = {t: v * (h_in[t] > 0) for t, v in dh.items()}
        hs[i + 1] = aggs[i] = None
    grads[0] = {k: dh[k.split(".", 1)[1]] if k.split(".", 1)[1] in dh
                else torch.zeros_like(v) for k, v in params[0].items()}
    return loss, grads


def train(params0, types, rels, x, labels, mask, target: str, lr: float,
          momentum: float, steps: int, tf32: bool = False,
          bf16_messages: bool = False, skip=()) -> dict:
    """``steps`` SGD-momentum steps from ``params0``: ``{"losses": [...],
    "grads": the first step's gradients, "params": after the last step}``."""
    params = [dict(p) for p in params0]
    mom = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(params, types, rels, x, labels, mask,
                                     target, tf32, bf16_messages, skip)
        losses.append(float(loss))
        first = grads if first is None else first
        mom = [{k: momentum * m[k] + gr[k] for k in m}
               for m, gr in zip(mom, grads)]
        params = [{k: p[k] - lr * m[k] for k in p}
                  for p, m in zip(params, mom)]
    return dict(losses=losses, grads=first, params=params)
