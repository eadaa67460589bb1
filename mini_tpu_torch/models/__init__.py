from mini_tpu_torch.models.gcn import (  # noqa: F401
    GCNNorm,
    gcn_normalize,
    gcn_init,
    gcn_forward,
    gcn_forward_cpu,
    gcn_init_opt,
    gcn_loss,
    gcn_train_step,
    params_from_jax,
)
from mini_tpu_torch.models.gat import (  # noqa: F401
    gat_init,
    gat_forward,
    gat_forward_cpu,
    gat_init_opt,
    gat_loss,
    gat_train_step,
    segment_softmax_by_dst,
)
from mini_tpu_torch.models.sage import (  # noqa: F401
    SAGENorm,
    sage_normalize,
    sage_init,
    sage_forward,
    sage_forward_cpu,
    sage_init_opt,
    sage_loss,
    sage_train_step,
)
from mini_tpu_torch.models.rgcn import (  # noqa: F401
    rgcn_normalize,
    rgcn_init,
    rgcn_forward,
    rgcn_init_opt,
    rgcn_loss,
    rgcn_train_step,
)
