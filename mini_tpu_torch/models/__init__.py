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
