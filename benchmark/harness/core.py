"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

Two drivers.  ``queries``: a closed loop of one client; each query is
timed on the host clock from the call until ``torch.cuda.synchronize()``
has returned, and the window closes with the first query that ends past
``--seconds``.  ``train``: back-to-back steps until ``--seconds`` have
passed on the host, then one synchronize; the window's time runs to it.
With ``--trace 1`` a short profiled part (the workload's
``profile_items`` items, at most ``PROFILE_SECONDS``) comes before the
window; the per-layer metrics come from it and from the window, which
then runs unprofiled as in any run.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import random
import statistics
import sys
import time
import traceback
import types

from benchmark.harness import registry
from benchmark.harness import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "mini_tpu")
PROFILE_SECONDS = 2.0
OUT_DIR = os.path.join(registry.HERE, "_out")
now = time.perf_counter


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole: ``mini_tpu_torch`` passes."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def p95(values) -> float:
    """The 95th percentile of all ``values`` (linear between order
    statistics, Python's ``inclusive`` method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class Spans:
    """Host-clock spans of the set-up, by name (seconds, summed)."""

    def __init__(self, sync):
        self.seconds: dict = {}
        self._sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = now()
        yield
        self._sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + now() - t0


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (what the check compares, kept without a copy)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def _syncer(device):
    import torch

    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


@contextlib.contextmanager
def _window_span():
    import torch

    with torch.profiler.record_function(tracing.WINDOW):
        yield


def _query_part(task, state, args, first: int, seconds: float, limit,
                sync, keep: Reservoir, log: dict) -> int:
    """Queries ``args[first % len], ...`` until one ends ``seconds`` after
    the part began or ``limit`` ran; appends to ``log``; returns the next
    index."""
    import torch

    traced = torch.autograd._profiler_enabled()
    i, t0 = first, now()
    while limit is None or i - first < limit:
        arg = args[i % len(args)]
        ts = now()
        try:
            with (torch.profiler.record_function("bench.query") if traced
                  else contextlib.nullcontext()):
                res = task.call(state, arg)
            sync()
        except Exception:  # a failed query ends the window; it is reported
            traceback.print_exc()
            log["failed"] += 1
            return i + 1
        te = now()
        log["latencies"].append(te - ts)
        log["rounds"].append(task.rounds(res))
        log["args"].append(arg)
        keep.offer((arg, task.keep(res)))
        i += 1
        if te - t0 >= seconds:
            break
    return i


def _prime_sample(task, state, inputs, cell) -> None:
    """Hold as many results as the check keeps, then let them go: the
    allocator then has the blocks that the window's kept sample holds, so
    keeping it allocates nothing new on the card in the window."""
    args = task.args(inputs, cell)
    held = [task.keep(task.call(state, args[i % len(args)]))
            for i in range(int(cell.workload["sample"]) + 1)]
    del held


def drive_queries(task, state, inputs, cell, seed, seconds, trace, sync,
                  counters):
    args = task.args(inputs, cell)
    keep = Reservoir(int(cell.workload["sample"]), seed)
    prof = dict(latencies=[], rounds=[], args=[], failed=0)
    log = dict(latencies=[], rounds=[], args=[], failed=0)
    i, summary = 0, None
    if trace:
        path = os.path.join(OUT_DIR, f"{cell.name}.trace.json")
        with tracing.profile(path):
            i = _query_part(task, state, args, 0, 0.0, 1, sync, keep, prof)
            with _window_span():
                c0, tp = counters(), now()
                i = _query_part(task, state, args, i, PROFILE_SECONDS,
                                int(cell.workload["profile_items"]), sync,
                                keep, prof)
                prof["seconds"] = now() - tp
                prof["counters"] = _delta(c0, counters())
        summary = tracing.summarize(path)
    tu = now()
    if not prof["failed"]:
        _query_part(task, state, args, i, seconds, None, sync, keep, log)
    log["seconds"] = now() - tu
    e2e = {}
    if log["latencies"] and not trace:
        e2e["query_rate"] = len(log["latencies"]) / log["seconds"]
        e2e["query_p95_ms"] = 1e3 * p95(log["latencies"])
    total = prof["latencies"] + log["latencies"]
    return dict(e2e=e2e, attempted=len(total) + prof["failed"]
                + log["failed"], failed=prof["failed"] + log["failed"],
                kept=keep.items, summary=summary, profiled=prof,
                unprofiled=log)


def drive_train(task, state, inputs, cell, seed, seconds, trace, sync,
                counters):
    import torch

    prof = dict(items=0, seconds=0.0)
    log = dict(items=0, seconds=0.0)
    failed, summary = 0, None
    try:
        if trace:
            path = os.path.join(OUT_DIR, f"{cell.name}.trace.json")
            with tracing.profile(path):
                task.step(state)
                sync()
                with _window_span():
                    c0, tp = counters(), now()
                    while (prof["items"] < int(cell.workload["profile_items"])
                           and now() - tp < PROFILE_SECONDS):
                        task.step(state)
                        prof["items"] += 1
                    sync()
                    prof["seconds"] = now() - tp
                    prof["counters"] = _delta(c0, counters())
            summary = tracing.summarize(path)
        tu = now()
        while now() - tu < seconds:
            task.step(state)
            log["items"] += 1
        sync()
        log["seconds"] = now() - tu
    except Exception:  # a failed step ends the window; it is reported
        traceback.print_exc()
        failed = 1
    steps = prof["items"] + log["items"]
    e2e = {}
    if log["items"] and not trace and not failed:
        e2e["train_step_ms"] = 1e3 * log["seconds"] / log["items"]
        if state["cuda"]:
            e2e["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return dict(e2e=e2e, attempted=steps + failed, failed=failed,
                kept=task.keep(state), summary=summary, profiled=prof,
                unprofiled=log)


DRIVERS = {"queries": drive_queries, "train": drive_train}


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, overrides=None, platform: str = "gpu") -> dict:
    """One run; the result line's dict, with ``checks`` last."""
    import torch

    cell = registry.load_cell(cell_name, overrides)
    task, gen = registry.task(cell), registry.generator(cell)
    sync = _syncer(device)
    cuda = torch.device(device).type == "cuda"
    spans = Spans(sync)
    with spans("generate"):
        inputs = gen.generate(cell.config, seed, device)
    inputs["seed"] = seed
    state = task.setup(inputs, cell, spans, device)
    state["cuda"] = cuda
    if cell.workload["driver"] == "queries":
        with spans("warmup.sample"):
            _prime_sample(task, state, inputs, cell)
    readers = {m["name"]: registry.metric_reader(m["name"])
               for m in cell.per_layer} if trace else {}

    def counters():
        return {k: r.counters() for k, r in readers.items()
                if hasattr(r, "counters")}

    sync()
    setup_s = now() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = DRIVERS[cell.workload["driver"]](task, state, inputs, cell, seed,
                                           seconds, trace, sync, counters)
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    shapes = task.shapes(inputs, cell, state)
    task.release(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = task.check(inputs, cell, win["kept"])

    values = {"setup_s": setup_s, **win["e2e"]}
    if trace:
        # what a per-layer reader sees (``metrics/<name>.py``'s ``read``)
        ctx = types.SimpleNamespace(
            cell=cell, inputs=inputs, task=task, spans=spans.seconds,
            trace=win["summary"], profiled=win["profiled"],
            unprofiled=win["unprofiled"], shapes=shapes,
            counter_deltas=win["profiled"].get("counters", {}))
        values = {k: r.read(ctx) for k, r in readers.items()}
        listed = cell.per_layer
    else:
        listed = cell.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in listed if values.get(m["name"]) is not None}
    limits = cell.workload["limits"]
    correct = (win["failed"] == 0 and set(checks) == set(limits)
               and all(math.isfinite(checks[k]) and checks[k] <= limits[k]
                       for k in limits))
    dev = {"platform": platform,
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace and win["summary"] is not None:
        dev["busy_s"] = win["summary"].busy_s
        dev["window_s"] = win["summary"].window_s
        result["breakdown"] = win["summary"].breakdown()
    result["diag"] = {"setup_spans": spans.seconds,
                      "window": _window_shape(win["unprofiled"])}
    result["checks"] = {k: {"value": checks.get(k), "limit": limits[k]}
                        for k in limits}
    return result


def _window_shape(log: dict) -> dict:
    """The window's items a second, and for queries the latency
    quartiles: what a reader of standard error needs to tell a slow host
    from a slow device."""
    out = {"seconds": log.get("seconds")}
    lat = log.get("latencies")
    if lat and len(lat) > 1:
        out["latency_ms_quartiles"] = [1e3 * q for q in
                                       statistics.quantiles(lat, n=4)]
        t, per = 0.0, {}
        for x in lat:
            t += x
            per[int(t)] = per.get(int(t), 0) + 1
        out["per_second"] = [per.get(k, 0) for k in range(int(t) + 1)]
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
