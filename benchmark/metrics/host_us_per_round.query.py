"""The host's time a round of a query outside the round's read: over the
profiled part, the summed time of the program's query spans
(``bfs.query``, ``pagerank.query``) less that of the ``loop.read`` spans
inside them, over the round spans (``bfs.round.<kind>``,
``pagerank.round``) they hold, in microseconds.  What the host pays to
issue a round's launches, its prologue's and its predecessor pass's
shares spread over its rounds; the read, where the host waits on the
device, is left out."""

from benchmark.harness import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None:
        return None
    queries = w.named(spans.is_query)
    rounds = [r for r in w.named(spans.is_round)
              if any(q.holds(r) for q in queries)]
    if not rounds:
        return None
    reads = [r for r in w.named(lambda n: n == "loop.read")
             if any(q.holds(r) for q in queries)]
    return (sum(q.dur for q in queries)
            - sum(r.dur for r in reads)) / len(rounds)
