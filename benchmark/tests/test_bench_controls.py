"""The check of ``correct`` fails when it should: the control (the
lower-precision reference, or a broken guarantee) fails one of each
cell's numbers against the committed limits, and a run with the timed
path broken underneath comes out not correct, once for each fault the
cell can have."""

import time

import pytest
import torch

from benchmark.harness import core, registry
from benchmark.tests.conftest import SEED, SMALL


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(cell, seed):
    c = registry.load_cell(cell, SMALL[cell])
    task = registry.task(c)
    inputs = registry.generator(c).generate(c.config, seed, "cpu")
    inputs["seed"] = seed
    roots = inputs["roots"][: c.workload["sample"]].tolist() \
        if "roots" in inputs else None
    readings = task.control(inputs, c, roots)
    assert _fails(readings, c.workload["limits"]), readings


def _run(cell):
    return core.run(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                    overrides=SMALL[cell], platform="cpu")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


def test_bfs_answer_altered(monkeypatch):
    from benchmark.tasks import bfs

    call = bfs.call

    def altered(state, root):
        r = call(state, root)
        far = int(torch.argmax(r.labels))
        r.labels[far] += 1  # one label off where it is produced
        return r

    monkeypatch.setattr(bfs, "call", altered)
    assert not _run("kron20-bfs")["correct"]


def test_bfs_parent_altered(monkeypatch):
    from benchmark.tasks import bfs

    call = bfs.call

    def altered(state, root):
        r = call(state, root)
        v = int(torch.nonzero(r.preds >= 0)[0, 0])
        r.preds[v] = root if r.preds[v] != root else -1
        return r

    monkeypatch.setattr(bfs, "call", altered)
    r = _run("kron20-bfs")
    assert not r["correct"]


def test_pagerank_answer_altered(monkeypatch):
    from benchmark.tasks import pagerank

    call = pagerank.call

    def altered(state, arg):
        r = call(state, arg)
        r.ranks[3] *= 1.01  # one rank off by 1% where it is produced
        return r

    monkeypatch.setattr(pagerank, "call", altered)
    assert not _run("kron20-pagerank")["correct"]


def test_train_step_returns_its_state_unchanged(monkeypatch):
    import mini_tpu_torch.models as models

    step = models.gcn_train_step

    def unchanged(params, opt, *a, **k):
        _, _, loss = step(params, opt, *a, **k)
        return params, opt, loss

    monkeypatch.setattr(models, "gcn_train_step", unchanged)
    r = _run("arxiv-gcn-train")
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_mean_over_the_rest(monkeypatch):
    import mini_tpu_torch.models as models

    step = models.gcn_train_step

    def half(params, opt, g, norm, x, batch, **k):
        labels, mask = batch
        rows = torch.nonzero(mask)[:, 0]
        kept = torch.zeros_like(mask)
        kept[rows[: rows.numel() // 2]] = True
        return step(params, opt, g, norm, x, (labels, kept), **k)

    monkeypatch.setattr(models, "gcn_train_step", half)
    assert not _run("arxiv-gcn-train")["correct"]
