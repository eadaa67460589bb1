"""One reader a per-layer metric, ``<metric name>.py``, loaded by path.

A reader has ``read(ctx) -> float | None`` (None when the run gives it
nothing to read: the metric is then left out of the line) and, where it
reads a program counter over the profiled part, ``counters() -> int``.
``ctx`` (a namespace, ``harness/core.run``) holds the cell, the generated inputs,
the task module, the set-up spans, the trace summary, the profiled and
unprofiled parts' logs, the program's shapes and the counters' deltas."""
