"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and ``checks`` last: each number the correctness
check compared, beside its limit); the same numbers end standard error.
Exits 2 without printing a result when there is no card, too few cards,
or when a module of ``jax``, ``jaxlib``, ``flax`` or ``mini_tpu`` was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches() -> None:
    """Every compile cache at a fixed path inside the checkout: the port
    builds its kernels into ``mini_tpu_torch/build/`` beside its sources;
    Triton, where anything loads it, into ``benchmark/_cache/triton``."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_cache", "triton")


def main(argv=None) -> int:
    args = parse(argv)
    caches()
    sys.path[0] = ROOT  # the checkout's root, not benchmark/
    import torch

    from benchmark.harness import core, registry

    chips = int(registry.load_cell(args.workload).workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = core.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T_START)
    bad = core.forbidden_modules()
    if bad:
        print("modules of the JAX package or JAX were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 2
    print("diagnostics: " + json.dumps(result.pop("diag")), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
