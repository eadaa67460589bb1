"""Hand-written CUDA kernels (sources in ``mini_tpu_torch/csrc/``), each
beside its plain torch version.  The counterpart of
``mini_tpu/ops/pallas/``."""
