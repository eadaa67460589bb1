"""The device's idle share while queries run: 1 - (union of the profiled
part's device-op intervals) / (its wall time), in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ops or not ctx.profiled.get("latencies"):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
