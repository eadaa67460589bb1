"""The GAT paper's deep attention network on the port, against the plain
float64 reference that decides the benchmark's ``correct``
(``benchmark/reference/gat.py``), at small sizes on the CPU.

Cases: per-layer heads ([2, 2, 3]), hidden widths with and without a spare
lane in the head padding (16 features a head leave one; 2 heads of 64
fill their 128 columns, where no column of the messages could carry a
softmax denominator), and the identity skip across the middle layer.  Each runs
on the banded layer (``attn="banded"``, forced on the CPU, where every
kernel wrapper runs its plain version) and on the fused path, the CPU's
gradient reference.  The graph is the benchmark's: the generated edges in
both directions and a self-loop a vertex, in three bands."""

import numpy as np
import pytest
import torch

import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.models import gat as tgat

from benchmark.gen import arxiv_like
from benchmark.harness import registry
from benchmark.reference import gat as ref
from benchmark.tasks import gat_train

SMALL_TABLE = 128 * 128 * 4  # bands of 128 rows or fewer: K = 3
CASES = {
    "lane": dict(dims=[16, 16, 16, 8], heads=[2, 2, 3], skip=[1]),
    "no_lane": dict(dims=[16, 64, 64, 8], heads=[2, 2, 3], skip=[1]),
    "no_lane_no_skip": dict(dims=[16, 64, 8], heads=[2, 3], skip=[]),
}
LR, MOMENTUM, SLOPE = 0.005, 0.9, 0.2


@pytest.fixture(scope="module")
def graph():
    """The benchmark's inputs at 300 vertices, their attention edges, and
    the port's slice of them."""
    cfg = {**registry.load_cell("arxiv-gat-train").config,
           "num_nodes": 300, "num_edges": 1200, "feature_dim": 16,
           "num_classes": 8,
           "split": {"train": 150, "valid": 50, "test": 100}}
    inputs = arxiv_like.generate(cfg, 11, "cpu")
    src, dst = gat_train.attention_edges(inputs, cfg["self_loops"])
    hg = tg.from_edges(src.numpy(), dst.numpy(), None, num_nodes=300)
    return inputs, (src, dst), tg.GraphSlice.from_host(hg, device="cpu")


def _padded(t, rows, fill=0):
    out = t.new_full((rows, *t.shape[1:]), fill)
    out[: t.shape[0]] = t
    return out


def _case(graph, name, seed=5):
    inputs, (src, dst), g = graph
    c = CASES[name]
    params = gat_train.init_params(c["dims"], c["heads"], seed, "cpu")
    x = inputs["x"][:, : c["dims"][0]].contiguous()
    return c, params, x, ref.Edges(src, dst, inputs["n"], block=1000), g


def _port(monkeypatch, g, params, x, c, attn):
    """The port's logits on the real vertices, its parameter leaves, and
    the layers that ran ``_GatBandedLayer``."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    calls = []
    real = tgat._GatBandedLayer.apply

    def apply(*a):
        # g, d, slope, message dtype, H, then H each of hw, s_src, s_dst:
        # per-vertex tensors only, no a_src vector
        assert len(a) == 5 + 3 * a[4]
        assert all(t.shape[0] == g.n_pad for t in a[5:])
        calls.append(a[1])
        return real(*a)

    monkeypatch.setattr(tgat._GatBandedLayer, "apply", apply)
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
              for p in params]
    before = tgat.fused_layers
    out = tgat.gat_forward(leaves, g, _padded(x, g.n_pad), SLOPE,
                           attn=attn, skip=c["skip"])
    assert tgat.fused_layers == before  # no layer left the banded path
    return out[: x.shape[0]], leaves, calls


def test_the_cases_have_and_lack_a_lane(monkeypatch, graph):
    """The cases hold what they are named for: a spare lane at 2 heads of
    16, none at 2 heads of 64, three bands each."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    assert tgat._head_pad(2, 16) > 16
    assert tgat._head_pad(2, 64) == 64
    g = graph[2]
    assert tbanded.layout_for(g, "pull", 2 * 64).K == 3
    assert g.m == 2 * 1200 + 300


@pytest.mark.parametrize("attn", ["banded", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_loss_and_grads_match_the_reference(monkeypatch, graph, case,
                                                   attn):
    """Logits, the loss over the train vertices and every gradient of one
    step.  Tolerances, the float32 port against float64 (largest gaps
    seen over these cases on both paths in brackets, then what bf16
    messages give): logits within 1e-5 relative plus 5e-6 (6.6e-7 at
    most; bf16 3.7e-3 to 1.0e-2), the loss within 2e-6 relative (1.4e-7;
    bf16 1.0e-5 to 9.2e-5), each gradient within 2e-5 of its leaf's
    largest entry (1.9e-6; bf16 1.1e-2 to 8.4e-2): about ten times the
    float32 gaps, and each under what a lower precision of the messages
    reads."""
    inputs = graph[0]
    c, params, x, edges, g = _case(graph, case)
    out, leaves, banded = _port(monkeypatch, g, params, x, c, attn)
    # every layer on the banded Function when asked, none on the fused path
    assert banded == (c["dims"][1:] if attn == "banded" else [])
    labels, mask = inputs["labels"], inputs["train_mask"]
    logp = torch.log_softmax(out, dim=-1)
    rows = torch.nonzero(mask)[:, 0]
    loss = -logp[rows, labels[rows]].sum() / rows.numel()
    flat = [v for p in leaves for v in p.values()]
    grads = torch.autograd.grad(loss, flat)

    p64 = [{k: v.double().requires_grad_() for k, v in p.items()}
           for p in params]
    want = ref.logits(p64, edges, x.double(), skip=c["skip"], slope=SLOPE)
    np.testing.assert_allclose(out.detach().double().numpy(),
                               want.detach().numpy(), rtol=1e-5, atol=5e-6)
    want_loss = ref.loss(p64, edges, x.double(), labels, mask,
                         skip=c["skip"], slope=SLOPE)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()),
                               rtol=2e-6)
    want_grads = torch.autograd.grad(want_loss,
                                     [v for p in p64 for v in p.values()])
    for got, w in zip(grads, want_grads):
        w = w.numpy()
        np.testing.assert_allclose(got.double().numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max())


@pytest.mark.parametrize("attn", ["banded", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_sgd_momentum_steps_match_the_reference(monkeypatch, graph,
                                                      case, attn):
    """Three ``gat_train_step``s against the reference's ``train``: each
    step's loss within 2e-6 relative (1.7e-7 at most seen; bf16 messages
    2.1e-5 to 2.6e-4) and the parameters after the third within 2e-6 of
    each leaf's largest entry (1.4e-7; bf16 9.7e-6 to 7.0e-5)."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    inputs = graph[0]
    c, params, x, edges, g = _case(graph, case)
    batch = (_padded(inputs["labels"], g.n_pad),
             _padded(inputs["train_mask"], g.n_pad, False))
    p, o, losses = params, tgat.gat_init_opt(params), []
    before = tgat.fused_layers
    for _ in range(3):
        p, o, loss = tgat.gat_train_step(p, o, g, _padded(x, g.n_pad), batch,
                                         LR, SLOPE, attn=attn,
                                         skip=c["skip"])
        losses.append(float(loss))
    assert tgat.fused_layers == before
    want = ref.train([{k: v.double() for k, v in q.items()} for q in params],
                     edges, x.double(), inputs["labels"],
                     inputs["train_mask"], LR, MOMENTUM, 3, skip=c["skip"],
                     slope=SLOPE)
    np.testing.assert_allclose(losses, want["losses"], rtol=2e-6)
    assert losses[-1] < losses[0]
    for got, w in zip(p, want["params"]):
        for k in got:
            wk = w[k].numpy()
            np.testing.assert_allclose(got[k].double().numpy(), wk, rtol=0,
                                       atol=2e-6 * np.abs(wk).max())


@pytest.mark.parametrize("case", ["no_lane", "lane"])
def test_bf16_messages_at_the_new_widths(monkeypatch, graph, case):
    """bf16 messages (scores and softmax in float32) on the banded layer:
    within 3e-2 of float32 (``test_torch_gat.py``'s bound for bf16
    messages), and of the fused path's bf16 run within the same (each
    rounds the weights to bf16 before it scales a message, the banded
    layer's denominators too), with finite gradients."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
    c, params, x, _, g = _case(graph, case)
    xp = _padded(x, g.n_pad)

    def run(attn, mdt):
        leaves = [{k: v.clone().requires_grad_() for k, v in q.items()}
                  for q in params]
        out = tgat.gat_forward(leaves, g, xp, SLOPE, mdt, attn=attn,
                               skip=c["skip"])
        grads = torch.autograd.grad((out[: x.shape[0]] ** 2).sum(),
                                    [v for q in leaves for v in q.values()])
        return out.detach().numpy(), grads

    f32, _ = run("banded", None)
    b16, g16 = run("banded", torch.bfloat16)
    fused16, _ = run("fused", torch.bfloat16)
    assert not np.array_equal(b16, f32)
    np.testing.assert_allclose(b16, f32, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(b16, fused16, rtol=3e-2, atol=3e-2)
    assert all(torch.isfinite(gr).all() for gr in g16)


def _watch_the_layer(monkeypatch):
    """Spies on ``torch.matmul`` as ``models.gat`` sees it and on
    ``_gat_layer_banded``: the shapes of the first operands of the
    products called inside the layer and outside it, and each layer's
    per-band weights with the layout's valid-slot masks."""
    seen = {"inside": [], "outside": [], "weights": []}
    depth = [0]
    real_mm, real_layer = tgat.torch.matmul, tgat._gat_layer_banded

    def matmul(a, *rest, **kw):
        seen["inside" if depth[0] else "outside"].append(tuple(a.shape))
        return real_mm(a, *rest, **kw)

    def layer(g, hws, s_src_l, s_dst_l, d, *rest):
        depth[0] += 1
        try:
            heads, aux = real_layer(g, hws, s_src_l, s_dst_l, d, *rest)
        finally:
            depth[0] -= 1
        H = len(hws)
        lay = tbanded.layout_for(g, "pull", H * tgat._head_pad(H, d))
        seen["weights"].append(list(zip(aux["w_bands"],
                                        lay.dev("cpu")["valid"])))
        return heads, aux

    monkeypatch.setattr(tgat.torch, "matmul", matmul)
    monkeypatch.setattr(tgat, "_gat_layer_banded", layer)
    return seen


@pytest.mark.parametrize("case", ["no_lane", "no_lane_no_skip"])
def test_banded_layer_gathers_the_vertex_scores(monkeypatch, graph, case):
    """At widths with no spare lane, with and without the skip, the banded
    layer takes each slot's source score from the per-vertex scores: no
    ``torch.matmul`` runs inside it (outside it each head's ``h @ W``
    does), and every unnormalized weight of a real slot lies in (0, 1] and
    a pad slot's is 0."""
    c, params, x, _, g = _case(graph, case)
    seen = _watch_the_layer(monkeypatch)
    out, leaves, banded = _port(monkeypatch, g, params, x, c, "banded")
    L = len(c["heads"])
    assert len(banded) == L
    torch.autograd.grad(out.square().sum(),
                        [v for p in leaves for v in p.values()])
    assert seen["inside"] == []
    assert len(seen["outside"]) == sum(c["heads"])
    assert len(seen["weights"]) == L
    for bands in seen["weights"]:
        assert len(bands) == 3
        for w, valid in bands:
            assert bool((w[valid] > 0).all() and (w[valid] <= 1).all())
            assert bool((w[~valid] == 0).all())


def test_init_takes_heads_a_layer():
    """``gat_init`` with one count a layer: each layer's ``w`` is ``[H_i,
    fan_in, d]``, a hidden layer's input the previous heads times its
    width; a list of the wrong length is refused."""
    p = tgat.gat_init(torch.Generator().manual_seed(1), [128, 256, 256, 40],
                      heads=[4, 4, 6], device="cpu")
    assert [tuple(q["w"].shape) for q in p] == [
        (4, 128, 256), (4, 1024, 256), (6, 1024, 40)]
    assert [tuple(q["a_dst"].shape) for q in p] == [(4, 256), (4, 256),
                                                     (6, 40)]
    assert float(p[1]["w"].abs().max()) <= np.sqrt(6.0 / (1024 + 256))
    same = tgat.gat_init(torch.Generator().manual_seed(1), [8, 16, 3],
                         heads=[2, 2], device="cpu")
    as_int = tgat.gat_init(torch.Generator().manual_seed(1), [8, 16, 3],
                           heads=2, device="cpu")
    for a, b in zip(same, as_int):
        for k in a:
            assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError, match="head counts"):
        tgat.gat_init(torch.Generator(), [8, 16, 3], heads=[2])


def test_skip_needs_equal_widths(graph):
    """A skip on a layer whose input and output widths differ is refused,
    as is a skip that names no layer; the skip adds the layer's input
    before the ELU."""
    c, params, x, _, g = _case(graph, "no_lane")
    xp = _padded(x, g.n_pad)
    with pytest.raises(ValueError, match="identity skip"):
        tgat.gat_forward(params, g, xp, attn="fused", skip=[0])
    with pytest.raises(ValueError, match="names no layer"):
        tgat.gat_forward(params, g, xp, attn="fused", skip=[3])
    plain = tgat.gat_forward(params, g, xp, attn="fused")
    skipped = tgat.gat_forward(params, g, xp, attn="fused", skip=[1])
    assert not torch.equal(plain, skipped)


# -- on the card ----------------------------------------------------------------


@pytest.fixture(scope="module")
def card_inputs():
    """The benchmark's inputs at 20,000 vertices on the card, and their
    attention edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the banded layer's kernels run "
                    "only on the card")
    cfg = {**registry.load_cell("arxiv-gat-train").config,
           "num_nodes": 20000, "num_edges": 80000, "feature_dim": 16,
           "num_classes": 8,
           "split": {"train": 10000, "valid": 5000, "test": 5000}}
    inputs = arxiv_like.generate(cfg, 13, "cuda")
    return inputs, gat_train.attention_edges(inputs, cfg["self_loops"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_on_the_card_match_the_reference(monkeypatch,
                                                     card_inputs, case):
    """``attn="auto"`` on the card: every layer on the banded layer (its
    CUDA kernels, several bands, each layer's slot scores gathered from
    its vertex scores), three steps against the float64 reference within
    the CPU test's tolerances."""
    monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", 1 << 20)
    inputs, (src, dst) = card_inputs
    hg = tg.from_edges(src.cpu().numpy(), dst.cpu().numpy(), None,
                       num_nodes=inputs["n"])
    g = tg.GraphSlice.from_host(hg, device="cuda")
    c = CASES[case]
    assert tbanded.layout_for(g, "pull", 128).K > 1
    params = gat_train.init_params(c["dims"], c["heads"], 5, "cuda")
    x = inputs["x"]
    batch = (_padded(inputs["labels"], g.n_pad),
             _padded(inputs["train_mask"], g.n_pad, False))
    p, o, losses = params, tgat.gat_init_opt(params), []
    before = tgat.fused_layers
    for _ in range(3):
        p, o, loss = tgat.gat_train_step(p, o, g, _padded(x, g.n_pad), batch,
                                         LR, SLOPE, skip=c["skip"])
        losses.append(float(loss))
    assert tgat.fused_layers == before
    want = ref.train([{k: v.double() for k, v in q.items()} for q in params],
                     ref.Edges(src, dst, inputs["n"]), x.double(),
                     inputs["labels"], inputs["train_mask"], LR, MOMENTUM,
                     3, skip=c["skip"], slope=SLOPE)
    np.testing.assert_allclose(losses, want["losses"], rtol=2e-6)
    for got, w in zip(p, want["params"]):
        for k in got:
            wk = w[k].cpu().numpy()
            np.testing.assert_allclose(got[k].double().cpu().numpy(), wk,
                                       rtol=0, atol=2e-6 * np.abs(wk).max())
