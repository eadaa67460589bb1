"""The readings that set the limits of ``correct``: for each seed, the
cell's numbers when the lower-precision control (or, where the task has
no precision, a broken guarantee) stands in the program's place, and the
planted faults the task names, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed.  The benchmark's runs never run this; the limits in
``workloads/<cell>.json`` lie between the program's readings (the runs'
``checks``) and these.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0] = os.path.dirname(HERE)


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark.harness import registry

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = registry.load_cell(args.workload)
    task, gen = registry.task(cell), registry.generator(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        inputs = gen.generate(cell.config, seed, args.device)
        inputs["seed"] = seed
        roots = inputs["roots"][: int(cell.workload.get("sample", 1))] \
            .tolist() if "roots" in inputs else None
        readings = task.control(inputs, cell, roots)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings,
                          "limits": cell.workload["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del inputs
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
