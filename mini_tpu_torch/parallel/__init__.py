"""Multi-device execution over ``torch.distributed``, one rank a device:
the port of ``mini_tpu.parallel`` (its 19 names).  Start the ranks with
``parallel.launch.run_ranks`` or ``torchrun``; see ``distributed.py``
for how the ``shard_map`` programs map onto ranks."""

from mini_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionedGraph,
    partition_graph,
)
from mini_tpu_torch.parallel.distributed import (  # noqa: F401
    DeviceShards,
    make_mesh,
    shard_to_mesh,
    dist_bfs,
    dist_sssp,
    dist_spmm,
    make_dist_bfs,
    make_dist_spmm,
)
from mini_tpu_torch.parallel.halo import (  # noqa: F401
    HaloPlan,
    build_halo_plan,
    halo_spmm,
    make_halo_spmm,
)
from mini_tpu_torch.parallel.distributed import dist_lspar  # noqa: F401
from mini_tpu_torch.parallel.models import (  # noqa: F401
    dist_gat_forward,
    dist_sage_forward,
    dist_gat_train,
    dist_sage_train,
)
