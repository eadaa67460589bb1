"""mini_tpu_torch: the PyTorch/CUDA port of mini-tpu for an NVIDIA H100.

The same frontier-centric graph framework as ``mini_tpu`` (a data-centric
re-design of gunrock/mini: advance, filter and compute over shared
CSR/CSC storage, SpMM for GNN message passing), in PyTorch, with the TPU
kernels rewritten by hand in CUDA for Hopper (``csrc/``, built at first
use by ``ops/kernels/_build.py``).  Imports torch and never jax; the JAX
package stays the reference the port is tested against.
"""

__version__ = "0.1.0"

from mini_tpu_torch.graph import (  # noqa: F401
    HostGraph,
    GraphSlice,
    load_mtx,
    save_mtx,
    from_edges,
    erdos_renyi,
    rmat,
)
from mini_tpu_torch.ops import (  # noqa: F401
    Frontier,
    segment_reduce,
    advance,
    filter_frontier,
    compute,
    spmm,
)
