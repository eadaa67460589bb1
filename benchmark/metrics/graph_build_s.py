"""Seconds of the port's graph build in set-up: its host CSR
(``from_edges``), its device graph (``GraphSlice.from_host``) and, where
the task normalizes, ``gcn_normalize`` with its banded layouts: the set-up
spans named ``graph.*`` (``tasks/_graph.py``), on the host clock."""


def read(ctx):
    spans = [s for k, s in ctx.spans.items() if k.startswith("graph.")]
    return sum(spans) if spans else None
