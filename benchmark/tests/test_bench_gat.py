"""The GAT cell (``arxiv-gat-train``) at small sizes on the CPU: its plain
reference against a dense float64 evaluation, its attention graph, its
operation and byte counts at hand-worked shapes, a sound run and the
faults its check must catch (the controls; TF32 products, bf16
messages, half the batch, an unchanged state and a left-out skip planted
under a run), and the readers of its four per-layer
metrics on hand-written inputs."""

import importlib
import json
import time
import types

import pytest
import torch

from benchmark.gen import arxiv_like
from benchmark.harness import core, registry
from benchmark.reference import gat as ref
from benchmark.reference.gcn import tf32_round
from benchmark.tasks import gat_train
from benchmark.tests.conftest import SEED

CELL = "arxiv-gat-train"
SMALL = {
    "config": {"num_nodes": 300, "num_edges": 1200, "feature_dim": 16,
               "num_classes": 8,
               "split": {"train": 150, "valid": 50, "test": 100},
               "dims": [16, 64, 64, 8], "heads": [2, 2, 3]},
    "workload": {"profile_items": 2},
}


def _run(trace=False):
    return core.run(CELL, SEED, 0.3, trace, "cpu", time.perf_counter(),
                    overrides=SMALL, platform="cpu")


# -- the configuration and its graph ------------------------------------------


def test_config_is_the_papers_network_at_arxivs_size():
    cell = registry.load_cell(CELL)
    cfg = cell.config
    assert (cfg["num_nodes"], cfg["num_edges"]) == (169343, 1166243)
    assert cfg["dims"] == [128, 256, 256, 40]
    assert cfg["heads"] == [4, 4, 6] and cfg["skip"] == [1]
    assert cfg["reduced"] == [] and cfg["tf32"] is False
    gcn = registry.load_cell("arxiv-gcn-train").config
    for k in ("generator", "num_nodes", "num_edges", "feature_dim",
              "num_classes", "split", "rmat", "homophily", "feature_noise"):
        assert cfg[k] == gcn[k], k
    assert cell.workload["reference_steps"] == 3
    assert cell.workload["profile_items"] == 4
    assert {m["name"] for m in cell.per_layer} == {
        "gat_step_mfu", "banded_sddmm_roofline", "attn_backward_ms.train",
        "fused_layers_per_step.train"}
    assert {m["name"] for m in cell.end_to_end} == {
        "train_step_ms", "train_peak_gib", "setup_s"}


def test_attention_edges_hold_one_self_loop_a_vertex():
    # a generated self-loop (2, 2) moves to (2, 3); both directions, then
    # (v, v) for every v
    inputs = {"n": 4, "src": torch.tensor([0, 2]),
              "dst": torch.tensor([1, 2])}
    src, dst = gat_train.attention_edges(inputs, 1)
    assert src.tolist() == [0, 2, 1, 3, 0, 1, 2, 3]
    assert dst.tolist() == [1, 3, 0, 2, 0, 1, 2, 3]
    cfg = {**registry.load_cell(CELL).config, **SMALL["config"]}
    a = arxiv_like.generate(cfg, 7, "cpu")
    src, dst = gat_train.attention_edges(a, cfg["self_loops"])
    assert src.numel() == 2 * 1200 + 300
    loops = src == dst
    assert torch.equal(torch.sort(src[loops]).values, torch.arange(300))


@pytest.mark.parametrize("count", [0, 2])
def test_attention_edges_refuse_another_self_loop_count(count):
    inputs = {"n": 4, "src": torch.tensor([0, 2]),
              "dst": torch.tensor([1, 2])}
    with pytest.raises(ValueError, match="self_loops"):
        gat_train.attention_edges(inputs, count)


# -- the reference against a dense evaluation ---------------------------------


def _dense_logits(params, src, dst, n, x, skip, slope=0.2):
    """The same network with each head's attention as a dense ``[n, n]``
    matrix: ``C[v, u]`` edges ``u -> v``, ``alpha = C exp(e) / sum``."""
    C = torch.zeros(n, n, dtype=x.dtype).index_put_(
        (dst, src), torch.ones(src.numel(), dtype=x.dtype), accumulate=True)
    h = x
    for i, p in enumerate(params):
        heads = []
        for w, a_s, a_d in zip(p["w"], p["a_src"], p["a_dst"]):
            hw = h @ w
            e = torch.nn.functional.leaky_relu(
                (hw @ a_s)[None, :] + (hw @ a_d)[:, None], slope)
            att = C * torch.exp(e - e.max(dim=1, keepdim=True).values)
            heads.append((att / att.sum(1, keepdim=True)) @ hw)
        last = i == len(params) - 1
        out = sum(heads) / len(heads) if last else torch.cat(heads, -1)
        if i in skip:
            out = out + h
        h = out if last else torch.nn.functional.elu(out)
    return h


@pytest.mark.parametrize("skip", [(1,), ()])
def test_reference_is_the_dense_network(skip):
    """Logits and gradients of the reference (edge blocks of 100 under
    checkpoint, so several blocks a layer) equal the dense evaluation's
    within float64 rounding, duplicate edges counted as often as they
    occur."""
    gen = torch.Generator().manual_seed(3)
    n = 40
    src = torch.randint(0, n, (200,), generator=gen)
    dst = torch.randint(0, n, (200,), generator=gen)
    src, dst = gat_train.attention_edges({"n": n, "src": src, "dst": dst},
                                         1)
    x = torch.randn(n, 6, generator=gen, dtype=torch.float64)
    params = [{k: v.double().requires_grad_() for k, v in p.items()}
              for p in gat_train.init_params([6, 8, 8, 3], [2, 2, 3], 9,
                                             "cpu")]
    flat = [v for p in params for v in p.values()]
    got = ref.logits(params, ref.Edges(src, dst, n, block=100), x,
                     skip=skip)
    want = _dense_logits(params, src, dst, n, x, skip)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    g_got = torch.autograd.grad((got ** 2).sum(), flat)
    g_want = torch.autograd.grad((want ** 2).sum(), flat)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_tf32_products_differentiate_as_rounded():
    a = torch.randn(5, 7, dtype=torch.float32, requires_grad=True)
    b = torch.randn(7, 3, dtype=torch.float32, requires_grad=True)
    out = ref._mm(True)(a, b)
    assert torch.equal(out, tf32_round(a) @ tf32_round(b))
    g = torch.randn(5, 3)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    assert torch.equal(ga, tf32_round(g) @ tf32_round(b).T)
    assert torch.equal(gb, tf32_round(a).T @ tf32_round(g))


# -- counts ---------------------------------------------------------------------


def test_gat_step_flops():
    # 2 layers 3 -> 4 (2 heads) -> 2 (3 heads), n = 5, m = 7: layer 1
    # forward and weight gradient 2 * 2*5*3*8 = 480, three edge passes
    # 3 * 2*7*8 = 336; layer 2 (fan-in 8) forward, weight and input
    # gradients 3 * 2*5*8*6 = 1440, edge passes 3 * 2*7*6 = 252
    assert gat_train.step_flops(5, 7, [3, 4, 2], [2, 3]) == (
        480 + 336 + 1440 + 252)
    # the cell: n = 169,343, m = 2 * 1,166,243 + 169,343 = 2,501,829
    n, m = 169343, 2501829
    want = (4 * n * 128 * 1024 + 6 * n * 1024 * 1024 + 6 * n * 1024 * 240
            + 6 * m * (1024 + 1024 + 240))
    assert gat_train.step_flops(n, m, [128, 256, 256, 40], [4, 4, 6]) == want
    assert want == 1_438_250_058_784


def test_banded_sddmm_step_bytes():
    r = registry.metric_reader("banded_sddmm_roofline")
    # one layer of 2 heads of 3 over m = 10 edges, n = 4: 10 * 6 * 4
    # gathered + 4 * 6 * 4 rows of Q + 10 * 2 * 4 out = 416
    assert r.step_bytes(4, 10, [5, 3], [2]) == 416.0
    n, m = 169343, 2501829
    want = sum(4 * m * hd + 4 * n * hd + 4 * m * h
               for hd, h in ((1024, 4), (1024, 4), (240, 6)))
    assert r.step_bytes(n, m, [128, 256, 256, 40], [4, 4, 6]) == want


# -- the check ----------------------------------------------------------------


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_step_ms", "setup_s"}  # no card


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_both_controls_are_not_correct(seed):
    """The TF32 control and the bf16-messages control each fail at least
    one of the committed limits."""
    c = registry.load_cell(CELL, SMALL)
    inputs = registry.generator(c).generate(c.config, seed, "cpu")
    inputs["seed"] = seed
    readings = gat_train.control(inputs, c)
    limits = c.workload["limits"]
    assert any(readings[k] > v for k, v in limits.items()), readings
    assert any(readings[f"bf16_messages.{k}"] > v
               for k, v in limits.items()), readings


def test_tf32_products_planted_under_a_run(monkeypatch):
    """The timed step with every matrix product of the program rounded to
    TF32, forward and backward, is not correct."""
    import mini_tpu_torch.models as models

    step = models.gat_train_step
    matmul = torch.matmul

    def rounded(*a, **k):
        with monkeypatch.context() as mp:
            mp.setattr(torch, "matmul", ref._TF32MatMul.apply)
            return step(*a, **k)

    monkeypatch.setattr(models, "gat_train_step", rounded)
    r = _run()
    assert torch.matmul is matmul
    assert not r["correct"], r["checks"]


def test_bf16_messages_planted_under_a_run(monkeypatch):
    import mini_tpu_torch.models as models

    step = models.gat_train_step

    def bf16(*a, **k):
        return step(*a, message_dtype=torch.bfloat16, **k)

    monkeypatch.setattr(models, "gat_train_step", bf16)
    assert not _run()["correct"]


def test_train_step_returns_its_state_unchanged(monkeypatch):
    import mini_tpu_torch.models as models

    step = models.gat_train_step

    def unchanged(params, opt, *a, **k):
        _, _, loss = step(params, opt, *a, **k)
        return params, opt, loss

    monkeypatch.setattr(models, "gat_train_step", unchanged)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_under_a_run(monkeypatch):
    """The step whose loss is the mean over half the train vertices is not
    correct."""
    import mini_tpu_torch.models as models

    step = models.gat_train_step

    def half(params, opt, g, x, batch, **k):
        labels, mask = batch
        rows = torch.nonzero(mask)[:, 0]
        kept = torch.zeros_like(mask)
        kept[rows[: rows.numel() // 2]] = True
        return step(params, opt, g, x, (labels, kept), **k)

    monkeypatch.setattr(models, "gat_train_step", half)
    r = _run()
    assert not r["correct"], r["checks"]


def test_skip_left_out_under_a_run(monkeypatch):
    import mini_tpu_torch.models as models

    step = models.gat_train_step
    monkeypatch.setattr(models, "gat_train_step",
                        lambda *a, **k: step(*a, **{**k, "skip": ()}))
    assert not _run()["correct"]


# -- the readers ----------------------------------------------------------------


def _X(name, ts, dur, tid=1, cat="user_annotation", **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if args:
        e["args"] = args
    return e


def _K(ts, dur, corr):
    return _X("k(int)", ts, dur, tid=7, cat="kernel", correlation=corr)


def _L(ts, corr, tid):
    return _X("cudaLaunchKernel", ts, 5, tid=tid, cat="cuda_runtime",
              correlation=corr)


# two steps; autograd's thread (tid 3) runs the layers' backward spans
# [300, 400) and [800, 900), which launch kernels of 30 and 50 us; the
# main thread's launch at 420 and tid 3's at 450 and 950 lie outside
# them; a span after the window is left out: 80 us over 2 steps
STEPS = [
    _X("bench.window", 0, 1000),
    _X("step.backward", 250, 200), _X("step.backward", 750, 200),
    _X("gat.attn.backward", 300, 100, tid=3),
    _X("gat.attn.backward", 800, 100, tid=3),
    _X("gat.attn.backward", 1100, 50, tid=3),
    _L(310, 1, 3), _K(320, 30, 1),
    _L(420, 2, 1), _K(425, 40, 2),
    _L(450, 3, 3), _K(460, 10, 3),
    _L(820, 4, 3), _K(830, 50, 4),
    _L(950, 5, 3), _K(955, 20, 5),
    _L(1110, 6, 3), _K(1120, 5, 6),
]


def _ctx(tmp_path, monkeypatch, events, steps=2):
    monkeypatch.setattr(core, "OUT_DIR", str(tmp_path))
    (tmp_path / "cell.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(trace=object(), profiled={"items": steps},
                                 cell=types.SimpleNamespace(name="cell"))


def test_attn_backward_ms(tmp_path, monkeypatch):
    reader = registry.metric_reader("attn_backward_ms.train")
    assert reader.read(_ctx(tmp_path, monkeypatch, STEPS)) == (
        pytest.approx(0.040))
    # a program without the span, and a run without a trace
    bare = _ctx(tmp_path, monkeypatch, STEPS[:3] + STEPS[6:])
    assert reader.read(bare) is None
    bare.trace = None
    assert reader.read(bare) is None


def test_gat_step_mfu():
    reader = registry.metric_reader("gat_step_mfu")
    ctx = types.SimpleNamespace(
        task=gat_train, unprofiled={"items": 10, "seconds": 2.0},
        shapes={"n": 5, "m": 7, "dims": [3, 4, 2], "heads": [2, 3]})
    # 10 steps of 2,508 operations in 2 s against 67e12 a second
    assert reader.read(ctx) == pytest.approx(100 * 10 * 2508 / 2.0 / 67e12)
    ctx.unprofiled = {"items": 0, "seconds": 0.0}
    assert reader.read(ctx) is None


def test_banded_sddmm_roofline():
    from benchmark.harness.trace import Summary

    reader = registry.metric_reader("banded_sddmm_roofline")
    trace = Summary(1.0, 1.0, 3, {
        "void banded_sddmm_scalar_kernel<float, float>(...)": 1e-3,
        "void banded_sddmm_kernel<float, float>(...)": 1e-3,
        "void banded_segment_sum_kernel<float, 4>(...)": 5.0}, {})
    shapes = {"n": 4, "m": 10, "dims": [5, 3], "heads": [2]}
    ctx = types.SimpleNamespace(profiled={"items": 4}, trace=trace,
                                shapes=shapes)
    # 4 steps of 416 bytes in 2 ms against 3.35e12 bytes a second
    assert reader.read(ctx) == pytest.approx(100 * 4 * 416 / 3.35e12 / 2e-3)
    ctx.trace = Summary(1.0, 1.0, 1, {"other": 1.0}, {})
    assert reader.read(ctx) is None


def test_fused_layers_per_step(monkeypatch):
    reader = registry.metric_reader("fused_layers_per_step.train")
    gat = importlib.import_module("mini_tpu_torch.models.gat")
    assert reader.counters() == gat.fused_layers
    ctx = types.SimpleNamespace(
        profiled={"items": 4},
        counter_deltas={"fused_layers_per_step.train": 6})
    assert reader.read(ctx) == 1.5
    ctx.counter_deltas = {"fused_layers_per_step.train": 0}
    assert reader.read(ctx) == 0.0
    monkeypatch.delattr(gat, "fused_layers")
    assert reader.counters() == 0
    assert reader.read(ctx) is None


def test_traced_run_reads_the_counter_on_the_cpu():
    """On the CPU ``auto`` takes the fused path: every layer counts."""
    r = _run(trace=True)
    assert r["metrics"]["fused_layers_per_step.train"]["value"] == 3.0
    assert r["metrics"]["gat_step_mfu"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_on_the_card(card, trace):
    """The cell at a small size on the card, its kernels and the
    profiler's device trace included: correct, every layer on the banded
    layer, and each per-layer metric read."""
    r = core.run(CELL, SEED, 1.0, bool(trace), card, time.perf_counter(),
                 overrides=SMALL)
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0
    if trace:
        m = r["metrics"]
        assert m["fused_layers_per_step.train"]["value"] == 0.0
        assert 0 < m["banded_sddmm_roofline"]["value"] <= 100
        assert m["attn_backward_ms.train"]["value"] > 0
        assert m["gat_step_mfu"]["value"] > 0
