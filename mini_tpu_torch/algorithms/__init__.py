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
from mini_tpu_torch.algorithms.coloring import (  # noqa: F401
    ColoringResult,
    coloring,
    validate_coloring,
)
from mini_tpu_torch.algorithms.kcore import (  # noqa: F401
    KCoreResult,
    kcore,
    kcore_cpu,
    kcore_cpu_true,
)
from mini_tpu_torch.algorithms.lspar import (  # noqa: F401
    LsparResult,
    is_prime,
    lspar,
    lspar_cpu,
)
