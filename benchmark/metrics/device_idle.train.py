"""The device's idle share while training steps run: 1 - (union of the
profiled steps' device-op intervals) / (their wall time, to the closing
synchronize), in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ops or not ctx.profiled.get("items"):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
