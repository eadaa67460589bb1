"""Start the ranks of a ``torch.distributed`` program from one process.

``mini_tpu``'s callers run a multi-device function from one process
(``dryrun_multichip(n)``); a process group needs one process a rank, so
:func:`run_ranks` spawns them::

    from functools import partial
    from mini_tpu_torch.parallel.launch import run_ranks

    labels = run_ranks(partial(my_rank_fn, arg), world=4)  # 4 cards
    labels = run_ranks(my_rank_fn, world=8, device="cpu")  # 8 gloo ranks

Each rank calls ``fn()`` after ``init_process_group`` (NCCL on card
``rank`` by default; gloo with one thread on ``device="cpu"``), so ``fn``
must be picklable: a module-level function, or a ``functools.partial`` of
one.  The ranks meet over a ``FileStore`` in a fresh temporary directory,
so no TCP port can collide.  If any rank raises or dies, or the clock runs
out, every rank is killed and this raises.  Users of ``torchrun`` call the
``dist_*`` functions directly.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from mini_tpu_torch.utils.device import resolve_device


def _to_host(x):
    """``x`` with every tensor in it (lists, tuples, dicts) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, store, device_type, timeout_s, fn, results):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            backend = "gloo"
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn()
        dist.barrier(device_ids=[rank] if device_type == "cuda" else None)
        dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(_to_host(out)) if rank == 0
                     else None))
    except Exception:  # reported to run_ranks, which kills every rank
        results.put((rank, False, traceback.format_exc()))


def _record(item, done: dict) -> None:
    """One rank's report: its result into ``done``, or its traceback
    raised."""
    rank, ok, payload = item
    if not ok:
        raise RuntimeError(f"rank {rank} failed:\n{payload}")
    done[rank] = payload


def _drain(results, done: dict) -> None:
    """Every report already on the queue into ``done``."""
    while True:
        try:
            _record(results.get(timeout=0.1), done)
        except queue.Empty:
            return


def run_ranks(fn, world: int, *, device=None, timeout_s: float = 600.0):
    """Run ``fn()`` on ``world`` ranks, one process a device (the card
    unless ``device="cpu"``), and return rank 0's result (tensors moved to
    the CPU).  Raises ``RuntimeError`` with the rank's traceback when one
    fails, naming the rank when one ends without a result (whatever its
    exit code), and ``TimeoutError`` when they do not all finish within
    ``timeout_s`` seconds (every rank is killed either way)."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"{world} ranks need {world} cards; "
                         f"{torch.cuda.device_count()} present")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mini_tpu_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, store, device.type, timeout_s, fn, results))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        done: dict = {}
        try:
            while len(done) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(done))} did "
                        f"not finish within {timeout_s} s")
                try:
                    _record(results.get(timeout=min(left, 0.5)), done)
                except queue.Empty:
                    # a rank that has ended (with any code, 0 included:
                    # sys.exit(0) skips the result) without a result is
                    # dead; what it put on the queue before it ended is
                    # read first
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        _drain(results, done)
                        dead = [r for r in dead if r not in done]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))
                       if len(done) == world else 0)
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            results.close()
    return pickle.loads(done[0])
