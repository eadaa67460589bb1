"""The device's idle time inside the rounds' own spans, a query: over the
profiled part, the device-idle time that overlaps a round span
(``bfs.round.<kind>``, ``pagerank.round``) over the query spans
(``bfs.query``, ``pagerank.query``), in milliseconds.  The idle that the
loop's launching causes, as against the query's prologue, its reads, its
predecessor pass or the harness between queries."""

from benchmark.harness import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None:
        return None
    queries = w.named(spans.is_query)
    rounds = w.named(spans.is_round)
    if not queries or not rounds:
        return None
    return 1e-3 * w.idle_inside(rounds) / len(queries)
