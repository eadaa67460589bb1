from mini_tpu_torch.ops.frontier import Frontier  # noqa: F401
from mini_tpu_torch.ops.segment import segment_reduce  # noqa: F401
from mini_tpu_torch.ops.operators import (  # noqa: F401
    advance,
    apply_to_dst,
    compute,
    filter_frontier,
)
from mini_tpu_torch.ops.spmm import sddmm, spmm  # noqa: F401
