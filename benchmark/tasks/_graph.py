"""The program's graph from the generated edges: the port's host build
(``from_edges``), then its device graph (``GraphSlice.from_host``), each
under a set-up span whose name starts with ``graph.``."""

from __future__ import annotations


def build(inputs: dict, spans, device, weights=None, undirected=True):
    """The port's ``GraphSlice`` of ``inputs``' edges on ``device``."""
    from mini_tpu_torch import GraphSlice, from_edges

    with spans("inputs.to_host"):
        src = inputs["src"].cpu().numpy()
        dst = inputs["dst"].cpu().numpy()
        w = None if weights is None else weights.cpu().numpy()
    with spans("graph.from_edges"):
        hg = from_edges(src, dst, w, num_nodes=inputs["n"],
                        make_undirected=undirected)
    with spans("graph.from_host"):
        g = GraphSlice.from_host(hg, device=device)
    return g
