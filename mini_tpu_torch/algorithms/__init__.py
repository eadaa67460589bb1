from mini_tpu_torch.algorithms.bfs import (  # noqa: F401
    BfsResult,
    bfs,
    bfs_batch,
    bfs_cpu,
    validate_preds,
)
from mini_tpu_torch.algorithms.sssp import (  # noqa: F401
    SsspResult,
    sssp,
    sssp_batch,
    sssp_cpu,
    validate_pred_tree,
)
from mini_tpu_torch.algorithms.pagerank import (  # noqa: F401
    PageRankResult,
    pagerank,
    pagerank_cpu,
)
from mini_tpu_torch.algorithms.cc import (  # noqa: F401
    CCResult,
    cc_cpu,
    connected_components,
)
