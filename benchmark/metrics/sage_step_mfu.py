"""The whole GraphSAGE training step's share of the float32 peak (67
TFLOP/s; the port pins TF32 off): ``train_step_mfu``'s reading, the steps'
model operations (``tasks/sage_train.step_flops``: the matrix products
forward, their weight gradients, the input gradients of every layer but
the first, and ``2 m F`` for each of the five aggregations) over the
unprofiled part's host-clock seconds, which end with a synchronize."""

from benchmark.harness.registry import metric_reader

read = metric_reader("train_step_mfu").read
