from mini_tpu_torch.algorithms.bfs import (  # noqa: F401
    BfsResult,
    bfs,
    bfs_cpu,
    validate_preds,
)
