"""The plain reference: NumPy-free, kernel-free PyTorch that works from the
edge lists, features and weights the benchmark generated, never from
anything the program built.  It imports neither ``jax`` nor ``mini_tpu``
nor anything of ``mini_tpu_torch`` (``tests/test_bench_reference.py``
parses the imports)."""
