"""Device operations (kernels, copies, sets) a round of a query: the
profiled part's device operations over the rounds its queries ran (each
query's ``num_iterations``)."""


def read(ctx):
    rounds = sum(ctx.profiled.get("rounds", []))
    if ctx.trace is None or not rounds or not ctx.trace.n_ops:
        return None
    return ctx.trace.n_ops / rounds
