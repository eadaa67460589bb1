from mini_tpu_torch.graph.csr import (  # noqa: F401
    HostGraph,
    GraphSlice,
    Relation,
    TypedGraph,
    from_edges,
    from_edges_bipartite,
)
from mini_tpu_torch.graph.io import load_mtx, save_mtx, parse_mtx_edges  # noqa: F401
from mini_tpu_torch.graph.generators import (  # noqa: F401
    erdos_renyi,
    rmat,
    grid2d,
    delaunay,
)
