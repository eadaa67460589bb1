#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mini_tpu_torch``) once on one GPU.

    python3 chip_smoke.py              # every phase, on one card
    python3 chip_smoke.py --profile    # the GAT step's profile alone
    python3 chip_smoke.py --kernels    # phases 1 and 2 alone
    python3 chip_smoke.py --parallel   # phases 1 and 21 alone
    python3 chip_smoke.py --tp-profile # the GCN steps over the meshes
    python3 chip_smoke.py --wide [DIR] # kernel 2's band limits alone, and
                                       # its JSON line at ogbn-products' size
    python3 chip_smoke.py --bipartite  # kernel 2 on rectangular layouts
                                       # at ogbn-mag's shapes alone

Phases; any failure ends with a traceback and a non-zero exit:

1. device and build: the card's name and power limit (nvidia-smi), then
   the CUDA kernels built from ``mini_tpu_torch/csrc/``, one nvcc per
   source, and the native graph loader (g++), all started together;
2. each kernel against its plain torch version on the card, at the main
   path's shapes (RMAT scale 16): the row gather bitwise, also at the
   shapes of the three TPU probes it replaces; the permutation bitwise at
   2^21 elements and at the rmat16 composite rank with 1, 2 and 4
   payloads, as a list and as one table (``permute_rows``), both
   directions, and with payloads of every element size; the SDDMM also with 2 heads; the segment sum
   (kernel 2) scaling the band gathers by their edge weights, as the main
   path calls it, within SUM_TOL at F=128 and 32 in float32 and bf16, two
   launches bitwise equal and equal to the plain emulation of its
   schedule, also on a star graph (F=1 unweighted, F=33 bf16, F=128) and,
   without weights, on the rmat18 pull layout (K=9, F=32); its indexed
   form (each slot's row of x read by the layout's ids, as the models
   launch it) bitwise its stream form on the band gathers, both timed, at
   rmat16 K=3 F=128 (float32, bf16) and on a graph of ogbn-arxiv's size
   at the training cells' shapes (F=256, K=11; F=1024, K=42, ``[mk, 4]``
   weights; pull and push), and past 128 bands (the RMAT graph's layouts
   at bands of 128 rows, K=513, F=128, float32 with and without weights
   and bf16: bitwise its emulation, each launch counted wide, timed);
   kernel wrappers given inputs that require grad must raise.  Every kernel has
   two times: per call over many back-to-back launches (``cuda_ms``: the
   host's enqueue where it is the longer) and on the device alone
   (``graph_ms``: a CUDA graph of captured launches), beside its plain version, its bound (``bound``)
   and, where one PyTorch call computes the same function, that call.
   The launch path's host cost per call is printed too; last, kernel 2 on
   a relation graph's rectangular layouts at ogbn-mag's shapes (author
   -> paper at F=128, K=35; field_of_study -> paper at F=64; pull and
   push; ``--bipartite`` alone): within SUM_TOL of a float64 sum, two
   launches bitwise, each counted bipartite, timed;
3. BFS from the max-degree hub of ``rmat(16, 16, seed=0, undirected,
   weighted)`` and from 3 more reached sources, in three schedules (JAX's
   defaults: a sparse tier, no chain at mean degree 32; dense rounds only;
   every round pull): labels bitwise equal to ``bfs_cpu``, preds the
   host's min-id parent, the round counters logged, kernel 3 launched
   once a dense or pull round plus once for the preds; each schedule's
   time and MTEPS from the hub;
4. the 2-layer GCN forward [128, 128, 32], float32 and bf16 messages, on
   ``erdos_renyi(2048, 16384)`` and the RMAT graph, against the float64
   oracle ``gcn_forward_cpu``;
5. GCN training at the same width on the RMAT graph (``bench.py``'s
   ``gcn_train_f32``/``gcn_train_bf16`` rows): the first step's loss and
   gradients against the same step on ``impl="xla"``, 4 segment-sum (all
   weighted, all reading rows by id), 0 SDDMM and 0 row-gather launches
   per step, the step time;
   then ER-2048 trained on a teacher's labels until the loss falls below
   0.7 of its first value;
6. the SpMM weight gradient (the SDDMM kernel), ``sddmm`` in both edge
   orders and ``spmm(impl="pallas_onehot")`` at RMAT scale 16, F=128,
   against ``impl="xla"``;
7. the GAT of ``bench.py``'s gat rows, [128, 32, 32] with 2 heads, on the
   RMAT graph: ``attn="auto"`` must take the banded layer; its float32
   forward against the float64 oracle ``gat_forward_cpu``, bf16 within
   3e-2, the fused forward; the first train step's loss and gradients,
   the banded native backward against the fused path; per-step launches
   of all six kernels; step times, the step's device time by kernel
   (``torch.profiler``) and the peak device memory of a step (also at
   RMAT scale 18); ER-2048 trained until its loss falls;
8. GraphSAGE [128, 128, 32]: ER-2048 against ``sage_forward_cpu``, the
   RMAT graph's banded forward and gradients against ``impl="xla"``, a
   step with ``sage_normalize``'s pre-banded weights bitwise the re-banded
   one, the gradients with those weights at bands of 128 rows (K=513,
   every kernel-2 launch wide) against ``impl="xla"``, the train step
   time;
9. ``bfs_batch`` from the 8 highest-degree RMAT sources: each row bitwise
   ``bfs``'s, its four round counters too; time per source and amortised
   MTEPS, with and without preds;
10. SSSP from the hub and 3 reached sources: dists bitwise ``sssp_cpu``,
    preds the host's min-id parent; with dense rounds only, one segment
    reduce a round plus one for the preds and the same bits; ``delta`` and
    ``auto`` the same dists; time and MTEPS;
11. ``sssp_batch`` over the 8 sources, each row bitwise ``sssp``'s;
12. SSSP on ``grid2d(2048, 256)`` (524,288 vertices), ``delta`` and
    ``bellman``, bitwise ``sssp_cpu``: rounds, time, time a round;
    12b. BFS on the same graph from vertex 0, JAX's defaults (the chained
    rounds) and dense rounds only, checked as in phase 3: rounds, time,
    time a round;
13. PageRank ``standard`` and ``mini`` (30 rounds at most) against
    ``pagerank_cpu``, one segment reduce a round; time, edges per second;
14. connected components, bitwise ``cc_cpu``, two segment reduces a round;
15. k-core: ``hindex`` bitwise ``kcore_cpu_true``, one segment reduce a
    step; ``mini`` bitwise ``kcore_cpu``, one segment reduce per dense
    peel round; ``auto`` on the directed ``rmat(16, 16, seed=0)`` takes
    ``mini``, bitwise ``kcore_cpu``, and ``hindex`` raises there;
16. coloring at K=16 (the fast path), K=1 and the generic path at K=8:
    proper (``validate_coloring``), one segment reduce (``bor``) a round,
    the first 8 rounds bitwise the CPU's; rounds, colors, time;
17. L-Spar: one segment reduce, counts (per vertex too) ``lspar_cpu``'s,
    the top-by-sim property, the mask bitwise the CPU's;
    phases 9-17 print their time (min of 3), and phases 15-17 each
    oracle's time;
18. the command-line drivers (``mini_tpu_torch.cli.main``) on the card:
    the ten subcommands on ``--rmat-scale 16`` from the hub with
    ``--validate`` (``lspar`` without), each a path of its own, the
    ``bfs`` line of rounds and ``pull:`` logged;
    tests/test_cli.py's fixture invocations; ``python -m
    mini_tpu_torch.cli bfs`` as a process of its own;
19. ``synthetic_arxiv_like(scale=17)``: the native host build bitwise the
    NumPy path, both timed; on its K=5 layouts (pull and push, F=128 and
    40) the segment sum within SUM_TOL of its plain version and the row
    gather bitwise (launches not counted); the GCN [128, 128, 40]
    forward against ``gcn_forward_cpu`` (rtol 1e-4, atol 1e-5) and the
    first step's loss and gradients against ``impl="xla"``; 40 steps,
    test accuracy above 0.7; a checkpoint after step 20 whose resumed
    step 21 is bitwise the live one; a ``trace()`` holding the five
    profiling scopes and the kernels; a ``scope``'s host cost with no
    profiler, and a BFS's scope uses a round;
20. ``mini_tpu_torch.entry.entry()`` against ``gcn_forward_cpu``;
21. ``mini_tpu_torch.parallel`` over NCCL, one rank a card
    (``torch.cuda.device_count()`` ranks, started by ``run_ranks``), on
    the rmat16 graph: ``dist_bfs`` from the hub with and without a halo
    plan bitwise ``bfs_cpu`` (preds the min-id parent), ``dist_sssp``
    bitwise ``sssp_cpu``, ``dist_cc`` ``cc_cpu``, ``dist_kcore``
    ``kcore_cpu_true``, ``dist_coloring`` the single-device ``coloring``
    (the same salts), ``dist_lspar``'s count ``lspar_cpu``'s,
    ``dist_pagerank`` within rtol 1e-3 of ``pagerank``; ``dist_spmm`` and
    ``halo_spmm`` (overlap off and on) at F=128 within rtol 1e-5, atol
    1e-6 of ``spmm(impl="xla")``; GCN and SAGE [128, 128, 32] and GAT
    [128, 32, 32] (2 heads): step 1's loss (rtol 1e-4) and gradients
    (GRAD_TOL) the single-device step's; the GCN step over the 2-D
    (graph, feat) mesh (``parallel/tp.py``: 1 x 1 at one card, 2 x 2 at
    four): step 1's loss (rtol 1e-4), momentum and params (GRAD_TOL) the
    single-device step's, its launches apart; each distributed call's
    time beside the single-device call's; kernel 3, the segment sum and
    the row gather against their plain versions at an 8-way partition's
    shard shapes, the last two also at the 2-D step's 64- and 16-column
    blocks (not counted); ``dryrun_multichip(device_count())``, both
    parts;
22. the script's time, one JSON line of the kernels (launch counts of
   phases 3-21, each path counted from 0, and kernel 2's wide launches
   among them; phase 2's errors, both times, bounds and library calls,
   and kernel 2's time past 128 bands),
   then the last line ``{"ok": true, "device": {"platform": "gpu",
   ...}}``.

With no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SCALE = 16
F_IN, F_HID, F_OUT = 128, 128, 32
# kernel vs plain float sums: the same terms summed in another order
SUM_TOL = 1e-5  # max abs error <= SUM_TOL * max|plain|
# kernel vs plain SDDMM: a float32 dot of F terms against float64, per slot
DOT_TOL = 1e-5  # |kernel - plain| <= DOT_TOL * (|y| . |msgs|) per slot
# kernel path vs xla gradients (tests/test_spmm_banded.py:379's bound)
GRAD_TOL = 1e-3  # max abs error <= GRAD_TOL * max|xla|
BF16_TOL = 3e-2  # bf16 messages: about 3 significant digits
N_CLASSES = F_OUT


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, device, windows: int = 5, min_calls: int = 20,
            min_window_ms: float = 5.0, max_calls: int = 2000) -> float:
    """Mean time of one ``fn()`` call over N back-to-back calls between one
    pair of CUDA events, N >= ``min_calls`` and enough for
    ``min_window_ms`` of work; the median of ``windows`` such windows.
    Where a call's device work is shorter than its host enqueue (about
    10-15 us on the launch path, :func:`check_launch_path`), this is the
    enqueue; :func:`graph_ms` gives the device time alone."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    n = int(min(max_calls, max(min_calls, np.ceil(min_window_ms / once))))
    times = []
    for _ in range(windows):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def graph_ms(fn, device, n: int = 20, replays: int = 5) -> tuple:
    """``(ms, how)``: the device time of one ``fn()`` call alone, without
    the host's enqueue.  ``n`` calls are captured in a CUDA graph and the
    graph replayed ``replays`` times between a pair of CUDA events; the
    median replay over ``n``.  A function that cannot be captured (it
    synchronizes, say) is timed by the kernel durations that
    ``torch.profiler`` records over ``n`` calls instead, and ``how`` says
    why."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
    except Exception as exc:  # capture refused: measure another way
        torch.cuda.synchronize(device)
        return profiled_ms(fn, device, n), (
            "profiler (not capturable: "
            f"{str(exc).splitlines()[0][:60]})")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(times)), "cuda graph"


def device_events(fn, device, n: int = 20) -> list:
    """``(name, us)`` of each device operation (kernel, copy, fill) of
    ``n`` calls of ``fn``, as ``torch.profiler`` records them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]  # as in profile_step


def profiled_ms(fn, device, n: int = 20) -> float:
    """The summed device time of the kernels of ``n`` calls of ``fn``, as
    ``torch.profiler`` records it, over ``n``."""
    return sum(us for _, us in device_events(fn, device, n)) / 1e3 / n


def profiled_parts(fn, device, parts, n: int = 20) -> dict:
    """For each of ``parts``, the device time per call (ms) of the kernels
    whose name holds it, as ``torch.profiler`` records ``n`` calls of
    ``fn``."""
    events = device_events(fn, device, n)
    return {p: sum(us for name, us in events if p in name) / 1e3 / n
            for p in parts}


def walker_and_fixup(fn, device) -> str:
    """Kernel 1's two launches apart, for a log line."""
    split = profiled_parts(fn, device, ("segreduce_walk", "segreduce_fixup"))
    return (f"walker {split['segreduce_walk']:.4f} ms, fix-up "
            f"{split['segreduce_fixup']:.4f} ms (torch.profiler)")


def host_us(fn, device, n: int = 2000) -> float:
    """Host time of one ``fn()`` call in microseconds: ``n`` calls back to
    back on the host clock, after a warm-up (for a launch, its enqueue)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize(device)
    return host


def timed(fn, device) -> dict:
    """A kernel's two times: ``ms``, per call back to back (host enqueue
    included where it is the longer), and ``device_ms``, the device alone
    (:func:`graph_ms`), with ``device_how``."""
    dev_ms, how = graph_ms(fn, device)
    return dict(ms=cuda_ms(fn, device), device_ms=dev_ms, device_how=how)


# The least time the card could take (NVIDIA's H100 SXM data sheet): bytes over the HBM rate, operations over the
# float32 rate outside the tensor cores; the larger bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float = 0.0) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def library(call: str, fn, device):
    """``(call, ms)`` of one PyTorch call that computes a kernel's function,
    timed like the kernel; ``(call + reason, None)`` when it raises."""
    try:
        return call, cuda_ms(fn, device, windows=3)
    except RuntimeError as exc:
        return f"{call} raised: {str(exc).splitlines()[0][:80]}", None


def kernel_stats(err, t, plain_ms, bnd, lib) -> dict:
    """One kernel's entry of the JSON line; ``t`` from :func:`timed`."""
    call, lib_ms = lib
    return dict(max_abs_err=err, **t, plain_ms=plain_ms, **bnd,
                library_ms=lib_ms, lib_call=call, lib_ms=lib_ms)


def pct(ms, bnd) -> str:
    return f"{100 * bnd['bound_ms'] / ms:.0f}% of the {bnd['bound_by']} bound"


def phase_build():
    from mini_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    import mini_tpu_torch.native as nat

    def build_native():
        t0 = time.perf_counter()
        assert nat.native_available(), nat.native_build_error()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    names = ("segreduce", "spmm_banded", "gather_rows", "permute")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        native = pool.submit(build_native)
        paths = list(pool.map(_build.build, names))
        t_native = native.result()
    for name, path in zip(names, paths):
        log(f"# built {os.path.relpath(path)} in "
            f"{_build.last_build_seconds[name]:.2f} s")
    log(f"# built the native graph loader (g++) in {t_native:.2f} s")
    log(f"# phase 1: kernels built in {time.perf_counter() - t0:.2f} s")
    return card


def phase_kernels(g, hg_big, device):
    """Kernel 1 on the graph's CSC offsets, kernels 2 and 3 on its pull
    layout, kernel 2 also on a star graph and on the pull layout of
    ``hg_big``, the rmat18 host graph (K=9), kernel 2 with one band
    (``segment_sum``) on the CSC offsets; each timed against its plain
    version, its bound and, where one PyTorch call computes the same
    function, that call."""
    import torch

    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    rng = np.random.RandomState(0)
    stats = {}

    stats["segment_reduce"] = check_segment_reduce(g, hg_big, rng, device)

    layout = layout_for(g, "pull", F_HID)
    dev = layout.dev(device)
    err2, t2 = 0.0, None
    for F in (F_HID, F_OUT):
        for dtype in (torch.float32, torch.bfloat16):
            msgs, w = band_messages(layout, dev, F, dtype, rng, device)
            err, t, plain_ms, bnd, lib = check_banded_sum(
                f"rmat{SCALE} F={F} {str(dtype)[6:]}", layout, dev, msgs,
                device, weights=w)
            err2 = max(err2, err)
            if F == F_HID and dtype == torch.float32:
                t2 = (t, plain_ms, bnd, lib)
    # the streams of the last case above, made to require grad
    refuses_grad("banded_segment_sum", lambda *rg: k2.banded_segment_sum(
        dev["bounds"], dev["offs2d"], rg), *msgs)
    refuses_grad("banded_segment_sum's weights",
                 lambda *rg: k2.banded_segment_sum(
                     dev["bounds"], dev["offs2d"], msgs, weights=rg), *w)

    # one row holds every edge (n - 1 = 99,999 of them, over 4 bands), so
    # it spans hundreds of walkers; and odd widths take the scalar path.
    # These layouts are built outside the layout cache, so that their
    # device arrays go with them and phase 7's peak memory is the step's.
    from mini_tpu_torch.graph import GraphSlice, from_edges
    from mini_tpu_torch.graph.banded import (
        FAST_TABLE_BYTES, build_banded_layout,
    )

    def pull_layout(hg_):
        gs = GraphSlice.from_host(hg_, device="cpu")
        return build_banded_layout(
            gs.col_offsets.numpy(), gs.csc_srcs.numpy(),
            gs.csc_weights.numpy(), gs.edge_mask_csc.numpy(),
            FAST_TABLE_BYTES // (F_HID * 4), "pull")

    n = 100_000
    lay_s = pull_layout(from_edges(np.arange(1, n), np.zeros(n - 1, np.int64),
                                   num_nodes=n))
    dev_s = lay_s.dev(device)
    for F, dtype, weighted in ((1, torch.float32, False),
                               (33, torch.bfloat16, True),
                               (F_HID, torch.float32, True)):
        msgs, w = band_messages(lay_s, dev_s, F, dtype, rng, device)
        err2 = max(err2, check_banded_sum(
            f"star n={n} F={F} {str(dtype)[6:]}", lay_s, dev_s,
            msgs, device, weights=w if weighted else None)[0])
    del lay_s, dev_s

    lay_b = pull_layout(hg_big)
    dev_b = lay_b.dev(device)
    for dtype in (torch.float32, torch.bfloat16):
        msgs, _ = band_messages(lay_b, dev_b, F_OUT, dtype, rng, device)
        err2 = max(err2, check_banded_sum(
            f"rmat{MEMORY_SCALE} F={F_OUT} {str(dtype)[6:]}", lay_b, dev_b,
            msgs, device)[0])
    del msgs
    stats["banded_segment_sum"] = kernel_stats(err2, *t2)
    # the indexed form, as the models launch it, against the stream form
    for dtype in (torch.float32, torch.bfloat16):
        check_indexed_form(f"rmat{SCALE} pull", layout, dev, F_HID, 1,
                           dtype, rng, device)
    indexed_at_cell_shapes(device)
    stats["banded_segment_sum"].update(wide_bands(g, rng, device))

    stats["banded_sddmm"] = check_sddmm(layout, dev, lay_b, dev_b, rng,
                                        device)
    del lay_b, dev_b
    stats["segment_sum"] = check_segment_sum(g, rng, device)
    check_launch_path(device)
    stats["gather_rows"] = check_gather(layout, dev, rng, device)
    stats["apply_fixed_perm"] = check_permute(g, rng, device)
    log("# phase 2: kernels match their plain versions")
    return stats


def reduce_values(rng, shape, dtype, device):
    """Random int32 over the whole range, or float32 in [-50, 50)."""
    import torch

    if dtype == torch.int32:
        v = rng.randint(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(
            np.int32)
    else:
        v = (rng.rand(*shape) * 100 - 50).astype(np.float32)
    return torch.from_numpy(v).to(device)


def reduce_case(label, offsets, dsts, vals, op, device, time_it=True):
    """Kernel 1 on one set of values: min, max, bor and the int32 sum
    bitwise equal to the plain version; the float32 sum within SUM_TOL of
    it, bitwise equal to the plain emulation of the kernel's schedule and
    across two launches.  Returns ``(err, timed, bound)``."""
    import torch

    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1

    args = (offsets, dsts, vals, op)
    got = k1.segment_reduce(*args)
    again = k1.segment_reduce(*args)
    no_ids = k1.segment_reduce(offsets, None, vals, op)  # built in the call
    want = k1.segment_reduce_plain(*args)
    torch.cuda.synchronize(device)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    assert torch.equal(got, again), f"{label} {op}: two launches differ"
    assert torch.equal(got, no_ids), f"{label} {op}: ids built in the call"
    err, how = 0.0, "bitwise"
    if vals.dtype == torch.float32 and op == "sum":
        err = float((got - want).abs().max())
        limit = SUM_TOL * float(want.abs().max())
        assert err <= limit, (label, op, err, limit)
        emulated = k1.segment_reduce_scheduled_plain([offsets], [vals], op)
        assert torch.equal(got, emulated), f"{label}: not the emulated schedule"
        how = (f"err {err:.3g} (bound {limit:.3g}), two launches and the "
               f"emulated schedule bitwise")
    else:
        assert torch.equal(got, want), (label, op, vals.dtype)
    n = offsets.shape[0] - 1
    cols = 1 if vals.ndim == 1 else vals.shape[1]
    # read once: the values and the offsets; written once: one per segment
    bnd = bound(vals.numel() * 4 + (n + 1) * 4 + n * cols * 4,
                ops=vals.numel())
    if not time_it:
        log(f"# segment_reduce {label} {op} {str(vals.dtype)[6:]} "
            f"{list(vals.shape)}: {how}")
        return err, None, bnd
    t = timed(lambda: k1.segment_reduce(*args), device)
    log(f"# segment_reduce {label} {op} {str(vals.dtype)[6:]} "
        f"{list(vals.shape)}: {how}; kernel {t['ms']:.4f} ms, device "
        f"{t['device_ms']:.4f} ms ({pct(t['device_ms'], bnd)}, "
        f"{bnd['bound_ms']:.4f} ms; {t['device_how']})")
    return err, t, bnd


def check_segment_reduce(g, hg_big, rng, device):
    """Kernel 1: the seven op and dtype cases on the graph's CSC offsets
    against the plain version and a library call; ``[m, 2]`` and ``[m, 8]``
    values against the column-by-column plain version; the star graph (one
    segment of 99,999 values); empty segments at both ends; the CSC offsets
    of ``hg_big`` (rmat18); an empty kernel's device time, the floor under
    any launch; and the K-band entry on the pull and push layouts with 2
    columns against its plain version, the per-band and per-column launches
    it replaces, and kernel 2 at F=2."""
    import ctypes

    import torch

    from mini_tpu_torch.graph import GraphSlice, from_edges
    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.ops.kernels import _build
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    m_pad = g.m_pad
    err1, t1 = 0.0, None
    ivals = reduce_values(rng, (m_pad,), torch.int32, device)
    fvals = reduce_values(rng, (m_pad,), torch.float32, device)
    cases = [(op, ivals) for op in ("min", "max", "bor", "sum")] + [
        (op, fvals) for op in ("min", "max", "sum")]
    offsets64, dsts64 = g.col_offsets.long(), g.csc_dsts.long()
    for op, vals in cases:
        args = (g.col_offsets, g.csc_dsts, vals, op)
        err, t, bnd1 = reduce_case(f"rmat{SCALE}", *args, device)
        err1 = max(err1, err)
        plain_ms = cuda_ms(lambda: k1.segment_reduce_plain(*args), device)
        if op == "bor":
            lib = ("none: no PyTorch call reduces by bitwise or", None)
        elif vals.dtype == torch.float32:
            lib = library(f"torch.segment_reduce({op})", lambda: (
                torch.segment_reduce(vals, op, offsets=offsets64, axis=0)),
                device)
        else:  # segment_reduce takes floating types only
            red = {"min": "amin", "max": "amax", "sum": "sum"}[op]
            lib = library(f"Tensor.scatter_reduce({red})", lambda: (
                torch.zeros(g.n_pad, dtype=vals.dtype, device=device)
                .scatter_reduce(0, dsts64, vals, red, include_self=False)),
                device)
        log(f"#   plain {plain_ms:.4f} ms {lib[0]} {lib[1]} ms")
        if op == "max" and vals.dtype == torch.int32:
            t1 = (t, plain_ms, bnd1, lib)  # the BFS advance's or-reduce
            log("#   " + walker_and_fixup(
                lambda: k1.segment_reduce(*args), device))

    for H in (2, 8):
        for dtype, op in ((torch.float32, "sum"), (torch.int32, "min"),
                          (torch.int32, "bor")):
            err1 = max(err1, reduce_case(
                f"rmat{SCALE}", g.col_offsets, g.csc_dsts,
                reduce_values(rng, (m_pad, H), dtype, device), op,
                device)[0])
    refuses_grad("segment_reduce [m, H]", lambda v: k1.segment_reduce(
        g.col_offsets, g.csc_dsts, v, "sum"), fvals[:, None].expand(-1, 2))

    # the hub case: one segment of n - 1 values, then empty ones
    n = 100_000
    star = GraphSlice.from_host(
        from_edges(np.arange(1, n), np.zeros(n - 1, np.int64), num_nodes=n),
        device=device)
    for dtype, op in ((torch.float32, "sum"), (torch.int32, "max"),
                      (torch.int32, "sum")):
        err1 = max(err1, reduce_case(
            f"star n={n}", star.col_offsets, star.csc_dsts,
            reduce_values(rng, (star.m_pad,), dtype, device), op, device)[0])
    del star
    # empty segments at both ends, a length that is no multiple of 4
    offs = torch.tensor([0, 0, 0, 5, 5, 700, 701, 9999, 9999, 9999],
                        dtype=torch.int32, device=device)
    dsts = torch.repeat_interleave(torch.arange(9, device=device),
                                   torch.diff(offs.long())).int()
    for shape in ((9999,), (9999, 5)):
        for dtype, op in ((torch.float32, "sum"), (torch.int32, "bor"),
                          (torch.float32, "min")):
            err1 = max(err1, reduce_case(
                "empty segments at both ends", offs, dsts,
                reduce_values(rng, shape, dtype, device), op, device,
                time_it=False)[0])
    # 33.6 MB of values: the launch floor no longer hides the share
    offs_b = torch.from_numpy(hg_big.col_offsets.astype(np.int32)).to(device)
    dsts_b = torch.from_numpy(hg_big.csc_dsts.astype(np.int32)).to(device)
    for dtype, op in ((torch.float32, "sum"), (torch.int32, "max")):
        err1 = max(err1, reduce_case(
            f"rmat{MEMORY_SCALE}", offs_b, dsts_b,
            reduce_values(rng, (hg_big.m,), dtype, device), op, device)[0])
    del offs_b, dsts_b

    empty = _build.bind("segreduce", "empty_launch", [ctypes.c_void_p])
    floor_ms, how = graph_ms(lambda: empty(_build.stream(device.index)),
                             device)
    log(f"# an empty kernel's launch: device {floor_ms:.4f} ms ({how}); "
        f"kernel 1 is two launches, and its bound at rmat{SCALE} is "
        f"{bnd1['bound_ms']:.4f} ms")

    # GAT's per-head score cotangent: K bands of [mk, 2] in one launch
    H = GAT_HEADS
    for direction in ("pull", "push"):
        lay = layout_for(g, direction, F_HID)
        dev = lay.dev(device)
        bands = [reduce_values(rng, (len(i), H), torch.float32, device)
                 for i in lay.ids]
        err, limit, want = band_sums_agree(direction, dev, bands, device)
        err1 = max(err1, err)

        def per_band_and_column():  # what one launch replaces
            out = None
            for k, b in enumerate(bands):
                mk = lay.lens[k]
                cols = b[:mk].t().contiguous()
                seg = dev["seg"][k][:mk]
                r = torch.stack([k1.segment_reduce(dev["offsets"][k], seg, c,
                                                   "sum") for c in cols],
                                dim=-1)
                out = r if out is None else out + r
            return out

        assert float((per_band_and_column() - want).abs().max()) <= limit
        real = sum(lay.lens)
        bnd = bound(real * H * 4 + lay.K * (lay.n_pad + 1) * 4
                    + lay.n_pad * H * 4, ops=real * H)
        t = timed(lambda: k1.segment_reduce_bands(
            dev["offsets"], bands, seg=dev["seg"]), device)
        t_old = timed(per_band_and_column, device)
        t_k2 = timed(lambda: k2.banded_segment_sum(
            dev["bounds"], dev["offs2d"], bands,
            row_prefix=dev["row_prefix"]), device)
        plain_ms = cuda_ms(lambda: k1.segment_reduce_bands_plain(
            dev["offsets"], bands), device, windows=3)
        log(f"# segment_reduce_bands rmat{SCALE} {direction} K={lay.K} "
            f"H={H}: err {err:.3g} (bound {limit:.3g}), two launches and the "
            f"emulated schedule bitwise; one launch {t['ms']:.4f} ms, device "
            f"{t['device_ms']:.4f} ms ({pct(t['device_ms'], bnd)}, "
            f"{bnd['bound_ms']:.4f} ms); {lay.K * H} launches per band and "
            f"column {t_old['ms']:.4f} ms, device {t_old['device_ms']:.4f} "
            f"ms; banded_segment_sum at F={H} {t_k2['ms']:.4f} ms, device "
            f"{t_k2['device_ms']:.4f} ms; plain {plain_ms:.4f} ms; "
            + walker_and_fixup(lambda: k1.segment_reduce_bands(
                dev["offsets"], bands, seg=dev["seg"]), device))
    refuses_grad("segment_reduce_bands", lambda *b: k1.segment_reduce_bands(
        dev["offsets"], b), *bands)
    return kernel_stats(err1, *t1)


def band_sums_agree(label, dev, bands, device) -> tuple:
    """Kernel 1's K-band entry (``[mk, H]`` bands, one launch) on a
    layout's offsets: within SUM_TOL of the plain version, two launches
    bitwise equal, bitwise the launch that builds the slots' rows itself
    and the plain emulation of its schedule; returns (max abs error, its
    limit, the plain sums)."""
    import torch

    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1

    offs = dev["offsets"]
    got = k1.segment_reduce_bands(offs, bands, seg=dev["seg"])
    again = k1.segment_reduce_bands(offs, bands, seg=dev["seg"])
    no_ids = k1.segment_reduce_bands(offs, bands)
    want = k1.segment_reduce_bands_plain(offs, bands)
    emulated = k1.segment_reduce_scheduled_plain(offs, bands)
    torch.cuda.synchronize(device)
    err = float((got - want).abs().max())
    limit = SUM_TOL * float(want.abs().max())
    assert err <= limit, (label, err, limit)
    assert torch.equal(got, again), f"{label}: two launches differ"
    assert torch.equal(got, no_ids), f"{label}: slots' rows built in the call"
    assert torch.equal(got, emulated), f"{label}: not the emulated schedule"
    return err, limit, want


def band_messages(layout, dev, F, dtype, rng, device) -> tuple:
    """The K band gathers of a random ``[n_pad, F]`` x, as the banded SpMM
    makes them, and the layout's per-slot edge weights that kernel 2
    scales them by, cast to the messages' dtype as its wrapper casts
    them."""
    import torch

    x = torch.from_numpy(rng.rand(layout.n_pad, F).astype(np.float32)
                         - 0.5).to(device=device, dtype=dtype)
    msgs = []
    for k in range(layout.K):
        lo = k * layout.band_rows
        msgs.append(torch.index_select(x[lo: lo + layout.band_rows], 0,
                                       dev["ids"][k]))
    return msgs, [w.to(dtype) for w in dev["weights"]]


def banded_sum_agrees(label, dev, msgs, device, weights=None) -> tuple:
    """Kernel 2 on a layout's cached schedule, with the per-slot
    ``weights`` where given, within SUM_TOL of the plain version, two
    launches bitwise equal, bitwise the plain emulation of its schedule;
    returns (max abs error, its limit)."""
    import torch

    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    args = (dev["bounds"], dev["offs2d"], msgs)
    prefix = dev["row_prefix"]
    before = k2.weighted_launches
    got = k2.banded_segment_sum(*args, row_prefix=prefix, weights=weights)
    again = k2.banded_segment_sum(*args, row_prefix=prefix, weights=weights)
    assert k2.weighted_launches - before == (2 if weights else 0), label
    want = k2.banded_segment_sum_plain(*args, weights=weights)
    emulated = k2.banded_segment_sum_scheduled_plain(
        *args, row_prefix=prefix, weights=weights)
    torch.cuda.synchronize(device)
    err = float((got - want).abs().max())
    limit = SUM_TOL * float(want.abs().max())
    assert err <= limit, (label, err, limit)
    assert torch.equal(got, again), f"{label}: two launches differ"
    assert torch.equal(got, emulated), f"{label}: not the emulated schedule"
    return err, limit


def check_indexed_form(label, layout, dev, F, H, dtype, rng, device):
    """Kernel 2's indexed form (each slot's row of x read by the layout's
    ids, as ``ops.spmm._apply_banded`` launches it) against its stream
    form on the K band gathers of the same x, bit for bit, weighted by
    ``[mk]`` (H = 1) or ``[mk, H]`` weights in (0, 1]; then timed: the
    gathers, the stream kernel on their streams, the indexed kernel, and
    an aggregation each way (the gathers and the stream kernel, against
    the indexed kernel alone)."""
    import torch

    from mini_tpu_torch.ops.kernels import gather_rows as kg
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    x = torch.from_numpy(rng.rand(layout.n_pad, F).astype(np.float32)
                         - 0.5).to(device=device, dtype=dtype)
    shape = (lambda n: (n,)) if H == 1 else (lambda n: (n, H))
    w = [torch.from_numpy((1.0 - rng.rand(*shape(len(i)))).astype(
        np.float32)).to(device) for i in layout.ids]
    args = (dev["bounds"], dev["offs2d"])
    kw = dict(row_prefix=dev["row_prefix"], weights=w,
              edge_chunk=layout.edge_chunk)
    rows = layout.band_rows

    def gathers():
        return [kg.gather_rows(x[k * rows: (k + 1) * rows], dev["ids"][k])
                for k in range(layout.K)]

    def indexed():
        return k2.banded_segment_sum(*args, x, ids=dev["ids"],
                                     band_rows=rows, **kw)

    streams = gathers()
    before = (k2.launches, k2.indexed_launches)
    got, want = indexed(), k2.banded_segment_sum(*args, streams, **kw)
    assert (k2.launches - before[0], k2.indexed_launches - before[1]) == (
        2, 1), label
    torch.cuda.synchronize(device)
    assert torch.equal(got, want), f"{label}: the forms' bits differ"
    t_g = timed(gathers, device)
    t_s = timed(lambda: k2.banded_segment_sum(*args, streams, **kw), device)
    del streams
    t_i = timed(indexed, device)
    log(f"# kernel 2 indexed vs stream form {label} K={layout.K} F={F} "
        f"H={H} {str(dtype)[6:]}: bitwise; device ms: gathers "
        f"{t_g['device_ms']:.4f}, stream kernel {t_s['device_ms']:.4f}, "
        f"indexed kernel {t_i['device_ms']:.4f}; an aggregation "
        f"{t_g['device_ms'] + t_s['device_ms']:.4f} -> "
        f"{t_i['device_ms']:.4f} (per call {t_g['ms'] + t_s['ms']:.4f} -> "
        f"{t_i['ms']:.4f})")
    return t_g, t_s, t_i


def wide_bands(g, rng, device) -> dict:
    """Kernel 2's indexed form past 128 bands, as ogbn-products' layout at
    256 columns takes it (K = 150): the RMAT graph's pull and push layouts
    at bands of 128 rows (K = 513, built outside the layout cache), F =
    F_HID, float32 weighted and unweighted and bf16 weighted: bitwise its
    scheduled emulation, two launches bitwise, each launch counted in
    ``wide_launches``; the weighted float32 launch timed against the bytes
    ``banded_segment_sum_roofline`` counts.  Returns the pull layout's K,
    time and bound for the kernels line."""
    import torch

    from mini_tpu_torch.graph.banded import ROW_TILE, build_banded_layout
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    def host(name):
        return getattr(g, name).cpu().numpy()

    mask = host("edge_mask")
    m = int(mask.sum())
    res = {}
    for direction, offsets, ends, weights in (
            ("pull", "col_offsets", "csc_srcs", "csc_weights"),
            ("push", "row_offsets", "csr_dsts", "csr_weights")):
        lay = build_banded_layout(host(offsets), host(ends), host(weights),
                                  mask, ROW_TILE, direction)
        assert lay.K > 128, (direction, lay.K)
        dev = lay.dev(device)
        for dtype, weighted in ((torch.float32, True),
                                (torch.float32, False),
                                (torch.bfloat16, True)):
            x = torch.from_numpy(rng.rand(lay.n_pad, F_HID).astype(
                np.float32) - 0.5).to(device=device, dtype=dtype)
            w = [torch.from_numpy((1.0 - rng.rand(len(i))).astype(
                np.float32)).to(device=device, dtype=dtype)
                for i in lay.ids] if weighted else None
            kw = dict(row_prefix=dev["row_prefix"], weights=w,
                      edge_chunk=lay.edge_chunk, ids=dev["ids"],
                      band_rows=lay.band_rows)
            args = (dev["bounds"], dev["offs2d"], x)

            def launch():
                return k2.banded_segment_sum(*args, **kw)

            wide = k2.wide_launches
            got, again = launch(), launch()
            assert k2.wide_launches - wide == 2, (direction, dtype)
            want = k2.banded_segment_sum_scheduled_plain(*args, **kw)
            torch.cuda.synchronize(device)
            assert torch.equal(got, want), (direction, dtype, "emulation")
            assert torch.equal(got, again), (direction, dtype, "launches")
            label = (f"K={lay.K} F={F_HID} {direction} {str(dtype)[6:]} "
                     f"{'weighted' if weighted else 'unweighted'}")
            if direction == "pull" and dtype == torch.float32 and weighted:
                t = timed(launch, device)
                bnd = bound(4 * m * F_HID + 4 * m + 4 * g.n * F_HID)
                res = dict(wide_K=lay.K, wide_ms=t["ms"],
                           wide_device_ms=t["device_ms"],
                           wide_bound_ms=bnd["bound_ms"])
                label += (f"; {t['device_ms']:.4f} ms device, "
                          f"{pct(t['device_ms'], bnd)}")
            log(f"# kernel 2 past 128 bands rmat{SCALE} {label}: bitwise "
                f"its emulation, two launches bitwise, both counted wide")
        del lay, dev
    return res


def arxiv_size_graph(device) -> tuple:
    """A directed graph of ogbn-arxiv's size with skewed in-degrees (hubs
    over many walkers, vertices with no in-edge) on ``device``, and the
    generator that drew it, to draw the rows and weights on from."""
    from mini_tpu_torch.graph import GraphSlice, from_edges

    rng = np.random.RandomState(0)
    n, m = 169_343, 2_332_486  # ogbn-arxiv's vertices, edges
    srcs = rng.randint(0, n, m)
    dsts = (n * rng.rand(m) ** 3).astype(np.int64)
    return GraphSlice.from_host(from_edges(srcs, dsts, num_nodes=n),
                                device=device), rng


def indexed_at_cell_shapes(device) -> None:
    """:func:`check_indexed_form` at the training cells' shapes: a directed
    graph of ogbn-arxiv's size with skewed in-degrees (hubs over many
    walkers, vertices with no in-edge), float32, its pull and push
    layouts at the GCN's F = 256 (K = 11, ``[mk]`` weights) and at GAT's
    F = 1,024 (K = 42, ``[mk, 4]`` weights)."""
    import torch

    from mini_tpu_torch.graph.banded import layout_for

    g, rng = arxiv_size_graph(device)
    for F, H, K in ((256, 1, 11), (1024, 4, 42)):
        for direction in ("pull", "push"):
            lay = layout_for(g, direction, F)
            assert lay.K == K, (F, direction, lay.K)
            check_indexed_form(f"ogbn-arxiv size {direction}", lay,
                               lay.dev(device), F, H, torch.float32, rng,
                               device)
    del g
    torch.cuda.empty_cache()


def parent_sum_launch(parent_dir: str):
    """Kernel 2's C entry built from another tree's
    ``mini_tpu_torch/csrc/spmm_banded.cu`` (the same signature), bound with
    this tree's argument types: what the tree at ``parent_dir`` launches."""
    import ctypes

    from mini_tpu_torch.ops.kernels import _build
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    k2._bind(1)
    src = os.path.join(parent_dir, "mini_tpu_torch", "csrc", "spmm_banded.cu")
    path, _ = _build.compile_library(src, "spmm_banded_parent",
                                     _build.find_nvcc(), _build.NVCC_FLAGS,
                                     _build.BUILD_DIR)
    entry = ctypes.CDLL(path).banded_segment_sum_launch
    entry.argtypes = k2._sum_launch.argtypes
    entry.restype = ctypes.c_int
    return entry


@contextlib.contextmanager
def launching(entry):
    """Kernel 2's wrapper launching through ``entry`` inside the block."""
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    saved, k2._sum_launch = k2._sum_launch, entry
    try:
        yield
    finally:
        k2._sum_launch = saved


def narrow_bands_unchanged(device, parent_dir=None) -> None:
    """A launch of at most 128 bands keeps its bits: at ogbn-arxiv's shape
    (the graph of :func:`indexed_at_cell_shapes`; F = 256, K = 11 with
    ``[mk]`` weights and without, F = 1,024, K = 42 with ``[mk, 4]``),
    pull and push, kernel 2's indexed form is bitwise its scheduled
    emulation (F = 256) and, given ``parent_dir``, bitwise the kernel
    built from that tree's source on the same inputs; no launch counts as
    wide."""
    import torch

    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    parent = None if parent_dir is None else parent_sum_launch(parent_dir)
    g, rng = arxiv_size_graph(device)
    for F, H, K, weighted in ((256, 1, 11, True), (256, 1, 11, False),
                              (1024, 4, 42, True)):
        for direction in ("pull", "push"):
            lay = layout_for(g, direction, F)
            assert lay.K == K, (F, direction, lay.K)
            dev = lay.dev(device)
            x = torch.from_numpy(rng.rand(lay.n_pad, F).astype(np.float32)
                                 - 0.5).to(device)
            shape = (lambda c: (c,)) if H == 1 else (lambda c: (c, H))
            w = [torch.from_numpy((1.0 - rng.rand(*shape(len(i)))).astype(
                np.float32)).to(device) for i in lay.ids] if weighted else None
            kw = dict(row_prefix=dev["row_prefix"], weights=w,
                      edge_chunk=lay.edge_chunk, ids=dev["ids"],
                      band_rows=lay.band_rows)
            args = (dev["bounds"], dev["offs2d"], x)
            wide = k2.wide_launches
            got = k2.banded_segment_sum(*args, **kw)
            assert k2.wide_launches == wide
            said = []
            if F == 256:
                want = k2.banded_segment_sum_scheduled_plain(*args, **kw)
                assert torch.equal(got, want), (F, direction, "emulation")
                said.append("its emulation")
            if parent is not None:
                with launching(parent):
                    old = k2.banded_segment_sum(*args, **kw)
                torch.cuda.synchronize(device)
                assert torch.equal(got, old), (F, direction, "parent")
                said.append("the parent's kernel")
            log(f"# kernel 2 narrow K={K} F={F} H={H} {direction} "
                f"{'weighted' if weighted else 'unweighted'}: bitwise "
                f"{' and '.join(said)}")
    del g
    torch.cuda.empty_cache()


PRODUCTS = (2_449_029, 61_859_140)  # ogbn-products' vertices, edges


def wide_bands_at_products_shape(device) -> dict:
    """Kernel 2 past 128 bands at ogbn-products' size: 2,449,029 vertices
    and 61,859,140 undirected edges made directed both ways (123,718,280;
    sources uniform, destinations skewed to low ids, so hubs span many
    walkers), the mean's weights of ``sage_normalize``, float32.  At F =
    256 (K = 150, the wide tables) and F = 100 (K = 75), pull and push:
    the indexed launch within SUM_TOL of a float64 sum band by band (the
    plain version would gather the whole 127 GB stream at F = 256), two
    launches bitwise equal, the wide and the scanning launches counted;
    then one launch timed against the bytes ``sage_segment_sum_roofline``
    counts for it.  The K = 150 pull launch is also checked and timed over
    rows 4 floats wide: the walk's own cost, apart from the rows' traffic.
    Returns each launch's numbers and the SAGE step's, for the JSON line
    of ``--wide``."""
    import torch

    from mini_tpu_torch.graph import GraphSlice, from_edges
    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.models.sage import sage_normalize
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    rng = np.random.RandomState(0)
    n, m = PRODUCTS
    t0 = time.perf_counter()
    srcs = rng.randint(0, n, m)
    dsts = (n * rng.rand(m) ** 3).astype(np.int64)
    hg = from_edges(srcs, dsts, num_nodes=n, make_undirected=True)
    del srcs, dsts
    g = GraphSlice.from_host(hg, device=device)
    del hg
    t1 = time.perf_counter()
    norm = sage_normalize(g, (100, 256))
    torch.cuda.synchronize(device)
    log(f"# products shape: n={g.n} m={g.m} n_pad={g.n_pad}; graph "
        f"{t1 - t0:.1f} s, sage_normalize (4 layouts) "
        f"{time.perf_counter() - t1:.1f} s")
    found = dict(launches=[])
    for F in (256, 100):
        for direction in ("pull", "push"):
            lay = layout_for(g, direction, F)
            K = lay.K
            assert (K > 128) == (F == 256), (F, direction, K)
            dev = lay.dev(device)
            w = norm.banded[lay.band_rows][direction == "push"]
            x = torch.rand(lay.n_pad, F, device=device) - 0.5

            def launch(x=x):
                return k2.banded_segment_sum(
                    dev["bounds"], dev["offs2d"], x,
                    row_prefix=dev["row_prefix"], weights=w,
                    edge_chunk=lay.edge_chunk, ids=dev["ids"],
                    band_rows=lay.band_rows)

            def checked(x):  # within SUM_TOL of a float64 sum band by band
                got, again = launch(x), launch(x)
                want = torch.zeros(lay.n_pad, x.shape[1],
                                   dtype=torch.float64, device=device)
                for k in range(K):  # a hub's band holds millions of slots
                    seg = k2._segment_ids(dev["bounds"], dev["offs2d"], k)
                    for lo in range(0, seg.numel(), 1 << 22):
                        hi = min(lo + (1 << 22), seg.numel())
                        rows = x[k * lay.band_rows
                                 + dev["ids"][k][lo:hi].long()]
                        want.index_add_(0, seg[lo:hi],
                                        (rows * w[k][lo:hi, None]).double())
                        del rows
                torch.cuda.synchronize(device)
                err = float((got - want).abs().max())
                limit = SUM_TOL * float(want.abs().max())
                assert err <= limit, (x.shape[1], direction, err, limit)
                assert torch.equal(got, again), (x.shape[1], direction,
                                                 "two launches")
                return err, limit

            wide, scanned = k2.wide_launches, k2.scanned_launches
            err, limit = checked(x)
            assert k2.wide_launches - wide == (2 if K > 128 else 0)
            assert k2.scanned_launches - scanned == 2
            ms = cuda_ms(launch, device, windows=3, min_calls=5)
            nbytes = 4 * g.m * F + 4 * g.m + 4 * g.n * F
            bnd = bound(nbytes)
            log(f"# kernel 2 products shape K={K} F={F} {direction} "
                f"weighted (the mean): max err {err:.3g} (limit "
                f"{limit:.3g}), two launches bitwise, "
                f"{'2 wide launches' if K > 128 else 'no wide launch'}; "
                f"{ms:.3f} ms a launch, {pct(ms, bnd)} ({nbytes / 1e9:.1f} "
                f"GB, {bnd['bound_ms']:.3f} ms)")
            found["launches"].append(dict(
                K=K, F=F, direction=direction, wide=K > 128, max_abs_err=err,
                limit=limit, ms=ms, bound_ms=bnd["bound_ms"]))
            if K > 128 and direction == "pull":
                # the same launch over rows 4 floats wide: the walk's own
                # cost, next to nothing of row traffic
                x4 = torch.rand(lay.n_pad, 4, device=device) - 0.5
                err4, limit4 = checked(x4)
                walk_ms = cuda_ms(lambda: launch(x4), device, windows=3,
                                  min_calls=5)
                log(f"# kernel 2 products shape K={K} F=4 {direction} "
                    f"weighted, the walk alone: max err {err4:.3g} (limit "
                    f"{limit4:.3g}), two launches bitwise; {walk_ms:.3f} ms "
                    f"a launch")
                found["walk_ms"] = dict(K=K, F=4, direction=direction,
                                        max_abs_err=err4, ms=walk_ms)
                del x4
    found["sage_step"] = sage_steps_at_products_shape(g, norm, device)
    del g, norm
    torch.cuda.empty_cache()
    return found


# ogbn-mag's relations that a bipartite launch is checked on: (name, n_src,
# n_dst, edges, F), the first layer's width for author -> paper (writes)
# and the second's for field_of_study -> paper (has_topic reversed)
MAG_RELATIONS = (("author->paper", 1_134_649, 736_389, 7_145_660, 128),
                 ("field_of_study->paper", 59_965, 736_389, 7_505_078, 64))


def bipartite_at_mag_shapes(device) -> list:
    """Kernel 2 on a relation graph's rectangular layouts at ogbn-mag's
    shapes (``MAG_RELATIONS``; sources skewed to low ids, so some span
    many walkers, destinations uniform), the mean's weights of
    ``sage_normalize``, float32, pull (author -> paper: K = 35 bands over
    the authors at F = 128; field_of_study -> paper: K = 2) and push (K =
    23 bands over the papers): each launch within SUM_TOL of a float64 sum
    band by band, two launches bitwise equal, each counted in
    ``bipartite_launches``; then one launch timed against the bytes
    ``rgcn_segment_sum_roofline`` counts for it, ``4 m F + 8 m + 4 rows
    F``.  Returns each launch's numbers."""
    import torch

    from mini_tpu_torch.graph import GraphSlice, banded, from_edges_bipartite
    from mini_tpu_torch.models.sage import sage_normalize
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    rng = np.random.RandomState(0)
    found = []
    for name, n_src, n_dst, m, F in MAG_RELATIONS:
        srcs = (n_src * rng.rand(m) ** 2).astype(np.int64)
        dsts = rng.randint(0, n_dst, m)
        g = GraphSlice.from_host(
            from_edges_bipartite(srcs, dsts, n_src, n_dst), device=device)
        del srcs, dsts
        norm = sage_normalize(g, (F,))
        for direction in ("pull", "push"):
            lay = banded.layout_for(g, direction, F)
            dev = lay.dev(device)
            w = norm.bands_for(g, F)[direction == "push"]
            x = torch.rand(lay.table_rows, F, device=device) - 0.5

            def launch(x=x, lay=lay, dev=dev, w=w):
                return k2.banded_segment_sum(
                    dev["bounds"], dev["offs2d"], x,
                    row_prefix=dev["row_prefix"], weights=w,
                    edge_chunk=lay.edge_chunk, ids=dev["ids"],
                    band_rows=lay.band_rows)

            before = k2.bipartite_launches
            got, again = launch(), launch()
            assert k2.bipartite_launches - before == 2, name
            assert got.shape == (lay.n_pad, F), (name, tuple(got.shape))
            want = torch.zeros(lay.n_pad, F, dtype=torch.float64,
                               device=device)
            for k in range(lay.K):
                seg = k2._segment_ids(dev["bounds"], dev["offs2d"], k)
                for lo in range(0, seg.numel(), 1 << 22):
                    hi = min(lo + (1 << 22), seg.numel())
                    rows = x[k * lay.band_rows + dev["ids"][k][lo:hi].long()]
                    want.index_add_(0, seg[lo:hi],
                                    (rows * w[k][lo:hi, None]).double())
                    del rows
            torch.cuda.synchronize(device)
            err = float((got - want).abs().max())
            limit = SUM_TOL * float(want.abs().max())
            assert err <= limit, (name, direction, err, limit)
            assert torch.equal(got, again), (name, direction, "two launches")
            del got, again, want
            ms = cuda_ms(launch, device, windows=3, min_calls=5)
            rows = n_dst if direction == "pull" else n_src
            nbytes = 4 * m * F + 8 * m + 4 * rows * F
            bnd = bound(nbytes)
            log(f"# kernel 2 bipartite {name} {direction} K={lay.K} F={F} "
                f"({lay.table_rows} table rows, {lay.n_pad} out) weighted "
                f"(the mean): max err {err:.3g} (limit {limit:.3g}), two "
                f"launches bitwise; {ms:.3f} ms a launch, {pct(ms, bnd)} "
                f"({nbytes / 1e9:.2f} GB, {bnd['bound_ms']:.3f} ms)")
            found.append(dict(relation=name, direction=direction, K=lay.K,
                              F=F, max_abs_err=err, limit=limit, ms=ms,
                              bound_ms=bnd["bound_ms"]))
        banded.forget_host_graph(g.fingerprint)
        del g, norm
        torch.cuda.empty_cache()
    return found


def sage_steps_at_products_shape(g, norm, device, steps: int = 3) -> dict:
    """OGB's GraphSAGE (widths 100, 256, 256, 47) on the graph of
    :func:`wide_bands_at_products_shape` with ``sage_normalize``'s
    weights: a step re-bands no weight (``ops.spmm.rebanded``) and makes
    4 wide launches of kernel 2 of its 5 (the two forward means and the
    two backward ones at 256 columns; the features' mean takes 75 bands),
    its loss finite; the step timed and its peak memory read (returned
    with the counts of a step)."""
    import torch

    from mini_tpu_torch.models.sage import (
        sage_init, sage_init_opt, sage_train_step,
    )
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    spmm_mod = sys.modules["mini_tpu_torch.ops.spmm"]
    dims = [100, 256, 256, 47]
    params = sage_init(torch.Generator().manual_seed(0), dims, device=device)
    opt = sage_init_opt(params)
    x = torch.rand(g.n_pad, dims[0], device=device) - 0.5
    labels = torch.randint(0, dims[-1], (g.n_pad,), device=device)
    mask = torch.arange(g.n_pad, device=device) < 196_615
    sage_train_step(params, opt, g, x, (labels, mask), 1e-2, norm=norm)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = (spmm_mod.rebanded, k2.wide_launches, k2.launches)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, loss = sage_train_step(params, opt, g, x,
                                            (labels, mask), 1e-2, norm=norm)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / steps * 1e3
    counts = (spmm_mod.rebanded - before[0], k2.wide_launches - before[1],
              k2.launches - before[2])
    assert counts == (0, 4 * steps, 5 * steps), counts
    assert bool(torch.isfinite(loss))
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"# sage step at products shape: {ms:.1f} ms a step, peak "
        f"{peak:.2f} GiB (the graph and four layouts included); a step: 0 "
        f"re-banded weights, 5 launches of kernel 2, 4 of them wide")
    return dict(ms=ms, peak_gib=peak, rebanded=0, launches=5,
                wide_launches=4)


def check_banded_sum(label, layout, dev, msgs, device, weights=None):
    """Kernel 2 on the layout's cached schedule, weighted where
    ``weights`` are given: within SUM_TOL of the plain version, two
    launches bitwise equal, bitwise equal to the plain emulation of its
    schedule; its time against its bound (the weights' bytes and products
    counted), the plain version and ``index_add_`` over the concatenated
    real slots."""
    import torch

    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    err, limit = banded_sum_agrees(label, dev, msgs, device, weights)
    args = (dev["bounds"], dev["offs2d"], msgs)
    prefix = dev["row_prefix"]
    F, elem = msgs[0].shape[1], msgs[0].element_size()
    real = [int(b) for b in layout.bounds[:, -1]]
    weighted = weights is not None
    bnd = bound(sum(real) * (F + weighted) * elem + layout.n_pad * F * 4
                + layout.K * layout.n_pad * 4 + (layout.n_pad + 1) * 4,
                ops=sum(real) * F * (1 + weighted))
    t = timed(lambda: k2.banded_segment_sum(*args, row_prefix=prefix,
                                            weights=weights), device)
    ms = t["ms"]
    plain_ms = cuda_ms(lambda: k2.banded_segment_sum_plain(
        *args, weights=weights), device, windows=3)
    # index_add_ wants one dtype and takes no per-row weights: it adds
    # float32 copies of the messages, weighted, made outside the timed
    # region
    seg = torch.cat([s[:n] for s, n in zip(dev["seg"], real)]).long()
    flat = torch.cat([(m[:n] * w[:n, None]) if weighted else m[:n]
                      for m, w, n in zip(msgs, weights or msgs, real)]
                     ).float()
    lib = library("Tensor.index_add_", lambda: torch.zeros(
        layout.n_pad, F, device=device).index_add_(0, seg, flat), device)
    log(f"# banded_segment_sum {label} K={layout.K}"
        f"{' weighted' if weighted else ''}: err {err:.3g} (bound "
        f"{limit:.3g}), two launches and the emulated schedule bitwise; "
        f"kernel {ms:.4f} ms ({pct(ms, bnd)}, {bnd['bound_ms']:.4f} ms), "
        f"device {t['device_ms']:.4f} ms ({t['device_how']}); plain "
        f"{plain_ms:.4f} ms index_add_ {lib[1]} ms")
    return err, t, plain_ms, bnd, lib


def sddmm_case(label, layout, dev, F, H, msg_dtype, y_dtype, rng, device):
    """Kernel 3 on one layout and shape: every real slot within DOT_TOL of
    the plain version, pad slots exactly 0, two launches bitwise equal,
    bitwise equal to the plain emulation of its schedule, the same with the
    per-slot rows built in the call.  Returns ``(err, timed, plain_ms,
    bound)``."""
    import torch

    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    x = torch.from_numpy(rng.rand(layout.n_pad, F).astype(np.float32)
                         - 0.5).to(device)
    y = torch.from_numpy(rng.rand(layout.n_pad, F).astype(np.float32)
                         - 0.5).to(device=device, dtype=y_dtype)
    msgs = [torch.index_select(x[k * layout.band_rows:
                                 (k + 1) * layout.band_rows], 0,
                               dev["ids"][k]).to(msg_dtype)
            for k in range(layout.K)]
    real = torch.cat([torch.arange(len(i), device=device) < int(b)
                      for i, b in zip(layout.ids, layout.bounds[:, -1])])
    args = (dev["bounds"], dev["offs2d"], msgs, y)
    got = k2.banded_sddmm(*args, heads=H, seg=dev["seg"])
    again = k2.banded_sddmm(*args, heads=H, seg=dev["seg"])
    no_seg = k2.banded_sddmm(*args, heads=H)
    want = k2.banded_sddmm_plain(*args, heads=H)
    emulated = k2.banded_sddmm_scheduled_plain(*args, heads=H)
    mag = k2.banded_sddmm_plain(dev["bounds"], dev["offs2d"],
                                [m.abs() for m in msgs], y.abs(), heads=H)
    torch.cuda.synchronize(device)
    assert got.shape == ((layout.total_padded, H) if H > 1
                         else (layout.total_padded,))
    diff = (got - want).abs()
    ratio = float((diff / mag.clamp(min=1e-30))[real].max())
    assert ratio <= DOT_TOL, (label, F, H, ratio)
    assert torch.all(got[~real] == 0), "pad slots must be exactly 0"
    assert torch.equal(got, again), f"{label}: two launches differ"
    assert torch.equal(got, no_seg), f"{label}: rows built in the call"
    assert torch.equal(got, emulated), f"{label}: not the emulated schedule"
    lanes, head_lanes = k2._sddmm_plan_for(msgs, y, H)
    form = (f"{lanes} lanes a slot, {head_lanes} a head" if lanes
            else "scalar form")
    real_slots = sum(int(b) for b in layout.bounds[:, -1])
    # messages, y and the slots' rows read once, dw written once
    bnd = bound(real_slots * F * msgs[0].element_size()
                + layout.n_pad * F * y.element_size()
                + layout.total_padded * (H + 1) * 4 + layout.bounds.size * 4,
                ops=2 * real_slots * F)
    t = timed(lambda: k2.banded_sddmm(*args, heads=H, seg=dev["seg"]),
              device)
    plain_ms = cuda_ms(lambda: k2.banded_sddmm_plain(*args, heads=H), device,
                       windows=3)
    log(f"# banded_sddmm {label} F={F} H={H} msgs {str(msg_dtype)[6:]} y "
        f"{str(y_dtype)[6:]} K={layout.K} ({form}): err "
        f"{float(diff.max()):.3g} (max per-slot ratio {ratio:.3g}, bound "
        f"{DOT_TOL}), pad slots 0, two launches and the emulated schedule "
        f"bitwise; kernel {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms "
        f"({pct(t['device_ms'], bnd)}, {bnd['bound_ms']:.4f} ms; "
        f"{t['device_how']}); plain {plain_ms:.4f} ms")
    return float(diff.max()), t, plain_ms, bnd


def check_sddmm(layout, dev, lay_big, dev_big, rng, device):
    """Kernel 3 on the pull layout at F=128: float32 and bf16 messages
    with y float32 (the weight cotangent's operands), 2 heads (GAT's), y in
    bf16, 4 heads, F=33 (the scalar form) and F=32; and on ``lay_big``, the
    rmat18 pull layout (K=9), at F=32."""
    import torch

    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    f32, bf16 = torch.float32, torch.bfloat16
    none = ("none: its messages are pre-gathered per band; no one PyTorch "
            "call dots them with their staircase rows", None)
    err3, stat = 0.0, None
    for F, H, mdt, ydt in ((F_HID, 1, f32, f32), (F_HID, 1, bf16, f32),
                           (F_HID, GAT_HEADS, f32, f32),
                           (F_HID, GAT_HEADS, bf16, f32),
                           (F_HID, 1, f32, bf16), (F_HID, 1, bf16, bf16),
                           (F_HID, 4, f32, f32), (33, 1, f32, f32),
                           (33, 3, bf16, f32), (F_OUT, 1, f32, f32)):
        err, t, plain_ms, bnd = sddmm_case(f"rmat{SCALE}", layout, dev, F, H,
                                           mdt, ydt, rng, device)
        err3 = max(err3, err)
        if stat is None:  # F=128, one head, float32: the SpMM's cotangent
            stat = (t, plain_ms, bnd, none)
    for mdt in (f32, bf16):
        err3 = max(err3, sddmm_case(f"rmat{MEMORY_SCALE}", lay_big, dev_big,
                                    F_OUT, 1, mdt, f32, rng, device)[0])
    x = torch.zeros(layout.n_pad, F_HID, device=device)
    refuses_grad("banded_sddmm", lambda yy: k2.banded_sddmm(
        dev["bounds"], dev["offs2d"],
        [x[: len(i)] for i in layout.ids], yy, seg=dev["seg"]), x)
    return kernel_stats(err3, *stat)


def refuses_grad(name, fn, *tensors) -> None:
    """A kernel's output carries no gradient: asked for one, the wrapper
    must raise."""
    import torch

    rg = [t.detach().float().requires_grad_() for t in tensors]
    try:
        fn(*rg)
    except RuntimeError as exc:
        assert "cannot carry gradients" in str(exc), exc
    else:
        raise AssertionError(f"{name} returned a result without gradients "
                             "for inputs that require grad")
    torch.cuda.synchronize()
    log(f"# {name} refuses inputs that require grad")


def check_gather(layout, dev, rng, device):
    """``gather_rows`` bitwise against ``index_select`` at the shapes of
    the TPU probes it replaces (rows 5-7 of PERF.md's kernel table) and at
    the rmat16 band gathers of the F=128 layout (the path shape), float32
    and bf16; indices out of range give zero rows.  Per call and device
    times of the wrapper and of ``index_select``."""
    import torch

    from mini_tpu_torch.ops.kernels import gather_rows as kg

    def case(label, calls, nbytes):
        """``calls(fn)`` runs the case's gathers through ``fn(table,
        idx)``."""
        want = calls(kg.gather_rows_plain)
        got = calls(kg.gather_rows)
        torch.cuda.synchronize(device)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), label
        t = timed(lambda: calls(kg.gather_rows), device)
        lib = timed(lambda: calls(kg.gather_rows_plain), device)
        bnd = bound(nbytes)
        log(f"# gather_rows {label}: bitwise; {t['ms']:.4f} ms per call "
            f"({pct(t['ms'], bnd)}, {bnd['bound_ms']:.4f} ms), device "
            f"{t['device_ms']:.4f} ms ({pct(t['device_ms'], bnd)}); "
            f"index_select {lib['ms']:.4f} ms per call, device "
            f"{lib['device_ms']:.4f} ms")
        return t, lib, bnd

    def probe(label, W, M, dtype=torch.float32, F=128):
        table = torch.from_numpy(rng.randn(W, F).astype(np.float32)).to(
            device=device, dtype=dtype)
        idx = torch.from_numpy(rng.randint(0, W, M).astype(np.int32)).to(
            device)
        elem = table.element_size()
        case(f"{label} table [{W},{F}] {str(dtype)[6:]} idx [{M}]",
             lambda fn: [fn(table, idx)], W * F * elem + M * 4 + M * F * elem)

    for dtype in (torch.float32, torch.bfloat16):
        probe("probe_dma_gather", 65536, 128 * 1024, dtype)
    probe("probe_dma_bisect", 1024, 2048)
    for W, C in ((512, 512), (2048, 2048), (8192, 8192), (2048, 512)):
        probe("probe_hbm_and_gather", W, C)
    probe("width F=40", 4096, 100000, F=40)
    # wide rows
    probe("wide rows F=1024", 4096, 65536, F=1024)
    probe("wide rows F=4096", 1024, 16384, F=4096)
    probe("odd width F=33", 4096, 100000, torch.bfloat16, F=33)

    # out-of-range indices: zero rows
    table = torch.from_numpy(rng.randn(4096, 128).astype(np.float32)).to(
        device)
    idx = torch.from_numpy(rng.randint(-100, 4196, 1 << 16).astype(
        np.int32)).to(device)
    ok = (idx >= 0) & (idx < 4096)
    want = torch.where(ok[:, None], table[idx.clamp(0, 4095).long()], 0.0)
    assert torch.equal(kg.gather_rows(table, idx), want)
    log(f"# gather_rows: {int((~ok).sum())} indices out of range give zero "
        f"rows")

    t = None
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.randn(layout.n_pad, F_HID).astype(
            np.float32)).to(device=device, dtype=dtype)
        bands = [x[k * layout.band_rows: (k + 1) * layout.band_rows]
                 for k in range(layout.K)]
        elem = x.element_size()
        res = case(f"rmat{SCALE} pull bands F={F_HID} {str(dtype)[6:]} "
                   f"K={layout.K} ({layout.total_padded} rows)",
                   lambda fn: [fn(b, i) for b, i in zip(bands, dev["ids"])],
                   layout.n_pad * F_HID * elem + layout.total_padded * 4
                   + layout.total_padded * F_HID * elem)
        if dtype == torch.float32:
            t = res
    refuses_grad("gather_rows", lambda tb: kg.gather_rows(tb, dev["ids"][0]),
                 bands[0])
    # the plain version is the library call: index_select per band
    kt, lib, bnd = t
    return kernel_stats(0.0, kt, lib["ms"], bnd,
                        ("torch.index_select (the plain version)",
                         lib["ms"]))


def check_permute(g, rng, device):
    """The permutation kernel bitwise against its plain versions, both
    directions, with 1, 2 and 4 float32 payloads as a list (stacked into
    one table of 4, 8 or 16-byte rows) and as one ``[n, P]`` table (``permute_rows``): at
    2^21 elements by a random permutation (the butterfly probe's size) and
    at the rmat16 pull-to-push composite rank of the GAT backward (2H=4
    columns: the path shape).  Timed: the forward as (i) a scatter by the
    rank and (ii) a gather by the inverse rank (the path's form: the
    banded layouts and the composite rank cache their inverses), the list
    form, the plain version, one ``index_copy_`` of the table and one per
    payload."""
    import torch

    from mini_tpu_torch.graph.banded import get_pull_to_push_rank, layout_for
    from mini_tpu_torch.ops.kernels import permute_kernel as kp

    def inverse_of(r):
        inv = torch.empty_like(r)
        inv[r.long()] = torch.arange(r.shape[0], dtype=r.dtype, device=device)
        return inv

    m = 1 << 21
    rank = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(device)
    lays = (layout_for(g, "pull", F_HID),
            layout_for(g, "push", F_HID))
    comp = get_pull_to_push_rank(g, *lays)
    assert torch.equal(inverse_of(comp),
                       get_pull_to_push_rank(g, *lays, inverse=True))
    stat = None
    for label, r in (("2^21 random", rank), (f"rmat{SCALE} composite", comp)):
        n = r.shape[0]
        r_inv, r64 = inverse_of(r), r.long()
        for P in (1, 2, 4):
            pay = [torch.from_numpy(rng.randn(n).astype(np.float32)).to(
                device) for _ in range(P)]
            table = torch.stack(pay, dim=1)
            for inverse in (False, True):
                got = kp.permute(r, pay, inverse=inverse)
                want = kp.permute_plain(r, pay, inverse=inverse)
                rows = kp.permute_rows(r, table, inverse=inverse)
                torch.cuda.synchronize(device)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    label, P, inverse)
                assert torch.equal(rows, kp.permute_rows_plain(
                    r, table, inverse=inverse)), (label, P, inverse)
            assert torch.equal(kp.permute_rows(r_inv, table, inverse=True),
                               kp.permute_rows(r, table))
            scatter = timed(lambda: kp.permute_rows(r, table), device)
            gather = timed(lambda: kp.permute_rows(r_inv, table,
                                                   inverse=True), device)
            listed = timed(lambda: kp.permute(r, pay), device)
            plain_ms = cuda_ms(lambda: kp.permute_rows_plain(r, table),
                               device)
            lib = library("Tensor.index_copy_ (one, the [n, P] table)",
                          lambda: torch.empty_like(table).index_copy_(
                              0, r64, table), device)
            lib_p = library(f"Tensor.index_copy_ x {P}", lambda: [
                torch.empty_like(q).index_copy_(0, r64, q) for q in pay],
                device)
            bnd = bound(n * 4 + 2 * n * 4 * P)
            log(f"# apply_fixed_perm {label} [{n}] x {P} float32: bitwise "
                f"both ways, list and table; (i) scatter {scatter['ms']:.4f} "
                f"ms per call ({pct(scatter['ms'], bnd)}, "
                f"{bnd['bound_ms']:.4f} ms), device "
                f"{scatter['device_ms']:.4f} ms; (ii) gather by the inverse "
                f"{gather['ms']:.4f} ms, device {gather['device_ms']:.4f} ms;"
                f" list of {P} {listed['ms']:.4f} ms, device "
                f"{listed['device_ms']:.4f} ms; plain {plain_ms:.4f} ms; "
                f"{lib[0]} {lib[1]} ms; {lib_p[0]} {lib_p[1]} ms")
            if r is comp and P == 4:  # the path's call: a gather, (ii)
                stat = kernel_stats(0.0, gather, plain_ms, bnd, lib)
    check_permute_dtypes(g, comp, pay[0], rng, device)
    refuses_grad("apply_fixed_perm", lambda v: kp.permute(comp, [v]),
                 pay[0])
    refuses_grad("permute_rows", lambda v: kp.permute_rows(comp, v),
                 table)
    return stat


def check_permute_dtypes(g, comp, base, rng, device):
    """Payloads of 1, 2, 4 and 8 bytes move as one table per element size
    (16 bools, 9 two-byte, 7 float32, 3 eight-byte payloads), bitwise
    against the plain version both ways; and the banded
    SpMM with bfloat16, float16 or float64 edge weights (which go through
    the band permutes as they are) equals it with the same weights in
    float32."""
    import torch

    from mini_tpu_torch.ops.kernels import permute_kernel as kp
    from mini_tpu_torch.ops.spmm import spmm

    pays = [base > b for b in np.linspace(-2, 2, 16)]
    pays += [(base * s).to(torch.bfloat16) for s in range(1, 9)]
    pays += [base.half()]
    pays += [base * s for s in range(1, 8)]
    pays += [base.double(), base.double() * 3,
             torch.arange(base.shape[0], device=device, dtype=torch.int64)
             << 33]
    sizes = sorted({p.element_size() for p in pays})
    for inverse in (False, True):
        before = kp.launches
        got = kp.permute(comp, pays, inverse=inverse)
        launched = kp.launches - before
        want = kp.permute_plain(comp, pays, inverse=inverse)
        torch.cuda.synchronize(device)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
        assert launched == len(sizes), launched
    x = torch.from_numpy(rng.rand(g.n_pad, F_HID).astype(np.float32)).to(
        device)
    w = torch.from_numpy(rng.rand(g.m_pad).astype(np.float32)).to(device)
    ref = spmm(g, x, weights=w, impl="banded")
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        wd = w.to(dtype)
        got = spmm(g, x, weights=wd, impl="banded")
        want = spmm(g, x, weights=wd.float(), impl="banded")
        torch.cuda.synchronize(device)
        assert torch.equal(got, want), dtype
        assert float((got - ref).abs().max()) <= 1e-2 * float(
            ref.abs().max()), dtype
    log(f"# apply_fixed_perm {len(pays)} bool/bf16/f16/f32/f64/i64 payloads "
        f"as tables of {sizes}-byte elements, {launched} launch(es): "
        f"bitwise both ways; banded SpMM with "
        f"bf16/f16/f64 weights equals float32 weights")


def check_launch_path(device):
    """The launch path's host cost per call: the bound C entry alone (its
    ctypes call and the kernel launch), the two ways to read the current
    stream, an output's allocation, and the wrapper's enqueue against
    ``index_select``'s at the bisect probe's shape (idx [2048], table
    [1024, 128])."""
    import torch

    from mini_tpu_torch.ops.kernels import gather_rows as kg

    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.randn(1024, 128).astype(np.float32)).to(
        device)
    idx = torch.from_numpy(rng.randint(0, 1024, 2048).astype(np.int32)).to(
        device)
    out = kg.gather_rows(table, idx)  # binds the C entry
    ptrs = (idx.data_ptr(), table.data_ptr(), out.data_ptr())
    raw = torch._C._cuda_getCurrentRawStream(device.index)
    res = dict(
        c_entry=host_us(lambda: kg._launch(*ptrs, 2048, 1024, 512, raw),
                        device),
        current_stream=host_us(
            lambda: torch.cuda.current_stream(device).cuda_stream, device),
        raw_stream=host_us(
            lambda: torch._C._cuda_getCurrentRawStream(device.index), device),
        gather_rows=host_us(lambda: kg.gather_rows(table, idx), device),
        index_select=host_us(lambda: torch.index_select(table, 0, idx),
                             device),
        empty=host_us(lambda: table.new_empty((2048, 128)), device),
    )
    log("# launch path, host us per call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res.items()))


def check_segment_sum(g, rng, device):
    """Kernel 2 launched with one band, as ``segment_sum``, on the CSC
    offsets: the weighted messages of ``spmm(impl="pallas_onehot")``."""
    import torch

    from mini_tpu_torch.ops.kernels import spmm_kernel as k4

    x = torch.from_numpy(rng.rand(g.n_pad, F_HID).astype(np.float32)
                         - 0.5).to(device)
    offsets64, dsts64 = g.col_offsets.long(), g.csc_dsts.long()
    err4, t4 = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        msgs = (torch.index_select(x, 0, g.csc_srcs)
                * g.csc_weights[:, None]).to(dtype)
        args = (g.col_offsets, g.csc_dsts, msgs)
        got = k4.segment_sum(*args)
        want = k4.segment_sum_plain(*args)
        torch.cuda.synchronize(device)
        err = float((got - want).abs().max())
        limit = SUM_TOL * float(want.abs().max())
        assert err <= limit, (dtype, err, limit)
        assert torch.equal(got, k4.segment_sum(*args)), "launches differ"
        err4 = max(err4, err)
        t = timed(lambda: k4.segment_sum(*args), device)
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: k4.segment_sum_plain(*args), device,
                           windows=3)
        elem = msgs.element_size()
        bnd = bound(g.m_pad * F_HID * elem + (g.n_pad + 1) * 4
                    + g.n_pad * F_HID * 4, ops=g.m_pad * F_HID)
        # one call each; index_add_ wants one dtype (float32 copies of bf16
        # messages, made outside the timed region)
        flat = msgs.float()
        libs = [library("torch.segment_reduce(sum)", lambda: (
                    torch.segment_reduce(msgs, "sum", offsets=offsets64,
                                         axis=0)), device),
                library("Tensor.index_add_", lambda: torch.zeros(
                    g.n_pad, F_HID, device=device).index_add_(
                        0, dsts64, flat), device)]
        ran = [lib for lib in libs if lib[1] is not None]
        lib = min(ran, key=lambda c: c[1]) if ran else libs[0]
        log(f"# segment_sum F={F_HID} {str(dtype)[6:]} K=1: err {err:.3g} "
            f"(bound {limit:.3g}), two launches bitwise; kernel {ms:.4f} ms "
            f"({pct(ms, bnd)}, {bnd['bound_ms']:.4f} ms), device "
            f"{t['device_ms']:.4f} ms ({t['device_how']}); plain "
            f"{plain_ms:.4f} ms; " + "; ".join(f"{c} {x} ms" for c, x in libs))
        if dtype == torch.float32:
            t4 = (t, plain_ms, bnd, lib)
    return kernel_stats(err4, *t4)


def host_min_parent(hg, labels):
    """pred[v] = min{u : (u,v) in E, labels[u] == labels[v] - 1}."""
    u, v = hg.csr_srcs, hg.csr_dsts
    cand = (labels[v] > 0) & (labels[u] == labels[v] - 1)
    big = np.iinfo(np.int32).max
    pred = np.full(hg.n, big, np.int64)
    np.minimum.at(pred, v[cand], u[cand])
    return np.where((labels > 0) & (pred != big), pred, -1).astype(np.int32)


# BFS schedules: JAX's defaults (a sparse tier; the chain only below mean
# out-degree 5), dense rounds only, every round a pull round
BFS_SCHEDULES = (("default", {}), ("dense only", dict(sparse_cape=0)),
                 ("all pull", dict(alpha=1e9)))


def bfs_rounds(r) -> str:
    return (f"{r.num_iterations} rounds ({r.num_pull_iterations} pull, "
            f"{r.num_sparse_iterations} sparse, {r.num_chained_iterations} "
            f"chained)")


def check_bfs(hg, g, src, kw, want):
    """``bfs(g, src, **kw)``: labels bitwise ``want`` (``bfs_cpu``'s), preds
    the host's min-id parent, nothing dropped, and kernel 3 launched once a
    dense or pull round and once for the preds (a sparse or chained round
    launches none).  The result."""
    from mini_tpu_torch.algorithms import bfs
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1

    before = k1.launches
    r = bfs(g, src, **kw)
    dense = r.num_iterations - r.num_sparse_iterations
    assert k1.launches - before == dense + 1, (src, kw, k1.launches - before)
    labels = r.labels.cpu().numpy()[: hg.n]
    np.testing.assert_array_equal(labels, want)
    np.testing.assert_array_equal(r.preds.cpu().numpy()[: hg.n],
                                  host_min_parent(hg, labels))
    assert not r.sparse_overflowed, (src, kw)
    return r


def phase_bfs(hg, g, device):
    """BFS from the hub and 3 more reached sources in each of
    ``BFS_SCHEDULES``: the same labels and preds, the oracles'; then each
    schedule timed from the hub."""
    from mini_tpu_torch.algorithms import bfs, bfs_cpu, validate_preds
    from mini_tpu_torch.utils.timing import time_fn

    hub = int(np.argmax(hg.out_degrees))
    reached = np.nonzero(bfs_cpu(hg, hub) >= 0)[0]
    others = np.random.RandomState(0).choice(reached, 3, replace=False)
    for src in [hub] + [int(s) for s in others]:
        want = bfs_cpu(hg, src)
        runs = {label: check_bfs(hg, g, src, kw, want)
                for label, kw in BFS_SCHEDULES}
        assert validate_preds(want, runs["default"].preds.cpu().numpy(), hg,
                              src), src
        assert runs["dense only"].num_sparse_iterations == 0
        pull = runs["all pull"]
        assert pull.num_pull_iterations == pull.num_iterations
        if src == hub:
            hub_runs = runs
        log(f"# bfs src={src}: {int((want >= 0).sum())} reached, labels and "
            f"preds exact in every schedule; " + "; ".join(
                f"{label} {bfs_rounds(r)}" for label, r in runs.items()))
    edges_reached = reached_edges(hg, reached)
    for label, kw in BFS_SCHEDULES:
        r = hub_runs[label]
        t = time_fn(lambda: bfs(g, hub, **kw), warmup=1, repeat=3,
                    device=device)
        log(f"# phase 3: bfs hub={hub} {label}: {bfs_rounds(r)}, "
            f"{t.min_s * 1e3:.3f} ms (min of 3), "
            f"{t.mteps(edges_reached):.2f} MTEPS")


def phase_gcn(name, hg, g, device):
    import torch

    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.models.gcn import (
        gcn_forward, gcn_forward_cpu, gcn_init, gcn_normalize,
    )
    from mini_tpu_torch.ops.kernels import gather_rows as kg
    from mini_tpu_torch.ops.kernels import spmm_banded as k2
    from mini_tpu_torch.utils.timing import time_fn

    norm = gcn_normalize(g)
    K = layout_for(g, "pull", F_HID).K
    params = gcn_init(torch.Generator().manual_seed(0),
                      [F_IN, F_HID, F_OUT], device=device)
    x_np = np.random.RandomState(0).rand(g.n_pad, F_IN).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)

    def forward(mdt):
        before = (k2.launches, kg.launches, k2.indexed_launches)
        out = gcn_forward(params, g, norm, x, message_dtype=mdt)
        # per layer one banded sum, reading x's rows by the K bands' ids:
        # no band gather
        counts = (k2.launches - before[0], kg.launches - before[1],
                  k2.indexed_launches - before[2])
        assert counts == (2, 0, 2), (K, counts)
        return out

    out32 = forward(None)
    ref = gcn_forward_cpu(
        [{k: v.cpu().numpy() for k, v in p.items()} for p in params], hg, x_np
    )
    got32 = out32.cpu().numpy()[: hg.n]
    assert np.isfinite(got32).all() and got32.shape == (hg.n, F_OUT)
    np.testing.assert_allclose(got32, ref, rtol=1e-4, atol=1e-5)
    out16 = forward(torch.bfloat16)
    np.testing.assert_allclose(out16.cpu().numpy()[: hg.n], got32,
                               rtol=3e-2, atol=3e-2)
    t32 = time_fn(lambda: forward(None), warmup=1, repeat=5, device=device)
    t16 = time_fn(lambda: forward(torch.bfloat16), warmup=1, repeat=5,
                  device=device)
    log(f"# phase 4: gcn {name} n={hg.n} m={hg.m}: f32 {t32.min_s * 1e3:.3f}"
        f" ms, bf16 {t16.min_s * 1e3:.3f} ms (min of 5); allclose to "
        f"gcn_forward_cpu")


def max_rel(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def phase_train(g, device):
    """bench.py's gcn_train_f32 / gcn_train_bf16 rows on the RMAT graph."""
    import torch

    from mini_tpu_torch.graph import GraphSlice, erdos_renyi
    from mini_tpu_torch.models.gcn import (
        gcn_forward, gcn_init, gcn_init_opt, gcn_normalize, gcn_train_step,
    )
    from mini_tpu_torch.ops.kernels import gather_rows as kg
    from mini_tpu_torch.ops.kernels import spmm_banded as k2
    from mini_tpu_torch.utils.timing import time_fn

    norm = gcn_normalize(g)
    K = len(norm.banded_pull)
    x = torch.from_numpy(np.random.RandomState(0).rand(g.n_pad, F_IN)
                         .astype(np.float32)).to(device)
    labels = torch.from_numpy(np.random.RandomState(1).randint(
        0, N_CLASSES, g.n_pad)).to(device)
    mask = torch.arange(g.n_pad, device=device) < g.n
    params = gcn_init(torch.Generator().manual_seed(2),
                      [F_IN, F_HID, F_OUT], device=device)
    opt = gcn_init_opt(params)

    def step(impl, mdt=None):
        before = (k2.launches, k2.sddmm_launches, kg.launches,
                  k2.weighted_launches, k2.indexed_launches)
        out = gcn_train_step(params, opt, g, norm, x, (labels, mask), 1e-2,
                             impl=impl, message_dtype=mdt)
        if impl == "banded":  # 2 forward sums, 2 dx sums, no SDDMM; every
            # sum weighted and reading its rows by the K bands' ids: no
            # band gather
            counts = (k2.launches - before[0], k2.sddmm_launches - before[1],
                      kg.launches - before[2],
                      k2.weighted_launches - before[3],
                      k2.indexed_launches - before[4])
            assert counts == (4, 0, 0, 4, 4), (K, counts)
        return out

    # from zero momentum the new momentum is the gradient itself
    _, grads_ref, loss_ref = step("xla")
    for mdt, tol in ((None, GRAD_TOL), (torch.bfloat16, BF16_TOL)):
        _, grads, loss = step("banded", mdt)
        assert torch.isfinite(loss)
        np.testing.assert_allclose(float(loss), float(loss_ref),
                                   rtol=1e-4 if mdt is None else tol)
        errs = [max_rel(gr[k], ref[k]) for gr, ref in zip(grads, grads_ref)
                for k in ("w", "b")]
        assert max(errs) <= tol, (mdt, errs)
        log(f"# gcn train step {'f32' if mdt is None else 'bf16'}: loss "
            f"{float(loss):.6f} (xla {float(loss_ref):.6f}); grad max "
            f"err/max|xla| {max(errs):.3g} (bound {tol})")
    for mdt in (None, torch.bfloat16):
        with torch.no_grad():
            fwd = time_fn(lambda: gcn_forward(params, g, norm, x,
                                              message_dtype=mdt),
                          warmup=1, repeat=5, device=device)
        t = time_fn(lambda: step("banded", mdt), warmup=1, repeat=5,
                    device=device)
        log(f"# gcn train rmat{SCALE} {'f32' if mdt is None else 'bf16'}: "
            f"step {t.min_s * 1e3:.3f} ms, forward {fwd.min_s * 1e3:.3f} ms "
            f"(min of 5); step/forward {t.min_s / fwd.min_s:.2f}")
    t = time_fn(lambda: step("xla"), warmup=1, repeat=5, device=device)
    log(f"# gcn train rmat{SCALE} xla f32: step {t.min_s * 1e3:.3f} ms")

    # the flagship graph learns a teacher's labels (tests/test_gcn.py:45-59)
    g_er = GraphSlice.from_host(
        erdos_renyi(2048, 16384, seed=0, undirected=True), device=device)
    norm_er = gcn_normalize(g_er)
    x_er = torch.from_numpy(np.random.RandomState(0).rand(g_er.n_pad, F_IN)
                            .astype(np.float32) - 0.5).to(device)
    teacher = gcn_init(torch.Generator().manual_seed(99),
                       [F_IN, F_HID, F_OUT], device=device)
    with torch.no_grad():
        y_er = torch.argmax(gcn_forward(teacher, g_er, norm_er, x_er), -1)
    mask_er = torch.arange(g_er.n_pad, device=device) < g_er.n
    p = gcn_init(torch.Generator().manual_seed(2), [F_IN, F_HID, F_OUT],
                 device=device)
    o = gcn_init_opt(p)
    losses = []
    for _ in range(100):
        p, o, loss = gcn_train_step(p, o, g_er, norm_er, x_er,
                                    (y_er, mask_er), 0.2, impl="banded")
        losses.append(float(loss))
    below = [i + 1 for i, v in enumerate(losses) if v < 0.7 * losses[0]]
    assert below, (losses[0], min(losses))
    with torch.no_grad():
        pred = torch.argmax(gcn_forward(p, g_er, norm_er, x_er), -1)
    acc = float((pred == y_er)[mask_er].float().mean())
    log(f"# phase 5: gcn train er2048 lr 0.2: loss {losses[0]:.4f} -> below "
        f"0.7x at step {below[0]}, {losses[-1]:.4f} after 100 steps, "
        f"teacher-label accuracy {acc:.4f}")


def phase_grad(g, device):
    """The SpMM weight gradient (kernel 3 in the backward), sddmm and the
    pallas_onehot route at RMAT scale 16, F=128, against impl="xla"."""
    import torch

    from mini_tpu_torch.ops import sddmm, spmm
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    rng = np.random.RandomState(3)
    x0 = torch.from_numpy(rng.rand(g.n_pad, F_HID).astype(np.float32)
                          - 0.5).to(device)
    w0 = torch.from_numpy(rng.rand(g.m_pad).astype(np.float32)
                          + 0.5).to(device)
    grads = {}
    for impl in ("banded", "xla"):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        before = k2.sddmm_launches
        out = spmm(g, x, "pull", weights=w, impl=impl)
        grads[impl] = torch.autograd.grad(torch.sin(out).sum(), (x, w))
        if impl == "banded":
            assert k2.sddmm_launches - before == 1
    errs = [max_rel(b, r) for b, r in zip(grads["banded"], grads["xla"])]
    assert max(errs) <= GRAD_TOL, errs
    assert torch.all(grads["banded"][1][~g.edge_mask_csc] == 0)
    log(f"# spmm grad (x, w) vs xla: max err/max|xla| {errs[0]:.3g}, "
        f"{errs[1]:.3g} (bound {GRAD_TOL}); masked edges exactly 0")

    xr = torch.from_numpy(rng.rand(g.n_pad, F_HID).astype(np.float32)
                          - 0.5).to(device)
    for order in ("csr", "csc"):
        got = sddmm(g, x0, xr, order=order, impl="banded")
        ref = sddmm(g, x0, xr, order=order, impl="xla")
        mag = sddmm(g, x0.abs(), xr.abs(), order=order, impl="xla") + 1e-6
        err = float(((got - ref).abs() / mag).max())
        assert err <= 1e-4, (order, err)
        log(f"# sddmm {order} banded vs xla: max err/magnitude {err:.3g} "
            f"(bound 1e-4)")

    # against xla in float64, since both float32 sums round
    got = spmm(g, x0, impl="pallas_onehot")
    ref = spmm(g, x0.double(), impl="xla").float()
    err = float((got - ref).abs().max())
    limit = SUM_TOL * float(ref.abs().max())
    assert err <= limit, (err, limit)
    log(f"# phase 6: spmm pallas_onehot vs xla (float64): err {err:.3g} "
        f"(bound {limit:.3g})")


GAT_DIMS, GAT_HEADS = [F_IN, 32, 32], 2  # bench.py:186,225-227
MEMORY_SCALE = 18  # the GAT step's peak memory, where bench.py stops
BUILD_LIMIT_S = 60.0  # skip that scale if its host build takes longer


def launches_now() -> dict:
    """Every kernel's launch count, by the names of KERNELS."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"mini_tpu_torch.ops.kernels.{m}"), attr)
        for name, (m, attr, _, _) in KERNELS.items()}


def launches_since(before: dict) -> dict:
    now = launches_now()
    return {k: now[k] - before[k] for k in now}


# the aten calls that run a cuBLAS product on the card
DENSE_OPS = ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot")


def dense_calls(fn):
    """``fn()`` and the number of dense products (:data:`DENSE_OPS`) it
    dispatched: the cuBLAS calls of a forward or a step, counted on the
    host."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in DENSE_OPS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def gat_dense_calls(dims, heads, step: bool) -> int:
    """The dense products of a GAT forward (``step`` False) or train step
    whose every layer runs the banded layer: a layer's H products ``h @
    W`` and 2H per-vertex scores ``hw @ a`` forward, and backward each
    product's weight gradient, its input gradient (none for the first
    layer, whose input needs none) and each score's ``a`` gradient.  No
    product runs on a band's gathered rows: the product form took one a
    band and layer more, forward only."""
    n = 0
    for i, H in enumerate(heads):
        n += 3 * H
        if step:
            n += H * (1 + (i > 0)) + 2 * H
    return n


def grads_close(got, ref, tol, floor=1e-7) -> float:
    """Per parameter, max |got - ref| <= tol * max|ref| + floor (a float32
    sum of terms that cancel to about 0 keeps an absolute error); returns
    the largest error over max|ref|."""
    worst = 0.0
    for gp, rp in zip(got, ref):
        for k in rp:
            err = float((gp[k] - rp[k]).abs().max())
            scale = float(rp[k].abs().max())
            assert err <= tol * scale + floor, (k, err, scale)
            worst = max(worst, err / max(scale, 1e-30))
    return worst


# kernel names of each part of a step's device time, in the order tried
PROFILE_PARTS = (
    ("kernel 2 (banded_segment_sum)", ("banded_segment_sum_kernel",
                                       "banded_fixup_kernel")),
    ("kernel 3 (banded_sddmm)", ("banded_sddmm",)),
    ("row gather (gather_rows)", ("gather_rows",)),
    ("kernel 1 (segment_reduce)", ("segreduce_",)),
    ("permutation (apply_fixed_perm)", ("permute_kernel",)),
    ("dense mm", ("gemm", "cutlass", "xmma", "sm90_", "cublas")),
)


def profile_step(step, device, steps: int = 3, parts=PROFILE_PARTS):
    """``steps`` calls of ``step`` (after 2 unprofiled) under
    ``torch.profiler``: a log line's text, the device busy time per step,
    its kernel span and idle share, and the busy time by part (``parts``,
    the rest as elementwise and other); None when the profiler saw no
    device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
    # the device side of a record_function range (the program's spans) is
    # a CUDA event too: it spans kernels, and is none itself
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    if not kern:
        return None
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / steps
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3 / steps
    split = {p: [0.0, 0] for p, _ in parts}
    split["elementwise and other"] = [0.0, 0]
    for e in kern:
        part = next((p for p, keys in parts
                     if any(k in e.name for k in keys)),
                    "elementwise and other")
        split[part][0] += e.time_range.elapsed_us() / 1e3 / steps
        split[part][1] += 1
    return (f"busy {busy:.3f} ms/step in a {span:.3f} ms kernel span, idle "
            f"share {1 - busy / span:.3f}, {len(kern) / steps:g} device "
            f"kernels and copies a step; " + "; ".join(
                f"{p} {t:.3f} ms ({100 * t / busy:.1f}%, {n / steps:g} "
                f"kernels)" for p, (t, n) in split.items()))


def profile_gat(g, device, steps: int = 3) -> None:
    """The banded GAT train step (float32 and bf16 messages) under
    ``torch.profiler`` (:func:`profile_step`)."""
    import torch

    from mini_tpu_torch.models.gat import (
        gat_init, gat_init_opt, gat_train_step,
    )

    params = gat_init(torch.Generator().manual_seed(0), GAT_DIMS,
                      heads=GAT_HEADS, device=device)
    opt = gat_init_opt(params)
    x = torch.from_numpy(np.random.RandomState(0).rand(g.n_pad, F_IN)
                         .astype(np.float32)).to(device)
    labels = torch.from_numpy(np.random.RandomState(1).randint(
        0, N_CLASSES, g.n_pad)).to(device)
    mask = torch.arange(g.n_pad, device=device) < g.n
    for mdt in (None, torch.bfloat16):
        def step():
            gat_train_step(params, opt, g, x, (labels, mask), 1e-2,
                           message_dtype=mdt)

        name = "f32" if mdt is None else "bf16"
        text = profile_step(step, device, steps)
        log(f"# gat profile rmat{SCALE} {name} (banded, {steps} steps): "
            + (text or "the profiler saw no device events"))


# the arxiv-gat-train cell's attention layers: (heads, features a head),
# each head's padding empty in the first (no spare lane)
GAT_CELL_HEADS = ((4, 256), (6, 40))
# a no-lane network at rmat16's widths, as the cell's: per-layer heads,
# both heads of 64 and 4 heads of 32 fill 128 columns, a skip on layer 1
GAT_NO_LANE = dict(dims=[F_IN, 64, 64, 32], heads=[2, 2, 4], skip=(1,))


def hold_gat_kernels(label, g, device):
    """The attention layer's kernels at the row bytes of the
    ``arxiv-gat-train`` cell's layers (:data:`GAT_CELL_HEADS`), on ``g``'s
    layouts, float32 as the cell runs them: kernel 2 weighted by ``[mk,
    H]`` weights on the pull layout (the forward's aggregation) and the
    push layout (``g_h``), within SUM_TOL of its plain version and bitwise
    its emulated schedule; kernel 1's K-band entry on ``[mk, H]`` bands of
    both layouts (the denominators, ``ds_dst``, ``ds_src``); the heads
    SDDMM (the weight cotangent) on the pull layout, in the form its plan
    takes at that width (:func:`sddmm_case`)."""
    import torch

    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.models.gat import _head_pad

    rng = np.random.RandomState(0)
    f32 = torch.float32
    for H, d in GAT_CELL_HEADS:
        F = H * _head_pad(H, d)
        for direction in ("pull", "push"):
            lay = layout_for(g, direction, F)
            dev = lay.dev(device)
            at = f"{label} {direction} K={lay.K} F={F} H={H}"
            # the layer's weights lie in (0, 1]
            w = [torch.from_numpy(1.0 - rng.rand(len(i), H).astype(
                np.float32)).to(device) for i in lay.ids]
            msgs, _ = band_messages(lay, dev, F, f32, rng, device)
            err2, limit2 = banded_sum_agrees(at, dev, msgs, device,
                                             weights=w)
            del msgs
            err1, limit1, _ = band_sums_agree(at, dev, w, device)
            log(f"# gat cell kernels {at}: banded_segment_sum weighted by "
                f"[mk, {H}] err {err2:.3g} (bound {limit2:.3g}), "
                f"segment_reduce_bands of the [mk, {H}] weights err "
                f"{err1:.3g} (bound {limit1:.3g}); both two launches and "
                f"the emulated schedule bitwise")
            if direction == "pull":
                sddmm_case(label, lay, dev, F, H, f32, f32, rng, device)
            del w
            torch.cuda.empty_cache()


SCORE_TOL = 1e-5  # float32 dot products of 256 or 40 terms, reordered


def gat_vertex_scores(label, g, device) -> None:
    """The banded layer's slot scores at the ``arxiv-gat-train`` cell's
    widths (:data:`GAT_CELL_HEADS`) on ``g``'s pull layouts: the per-vertex
    scores ``hw_h @ a_h`` gathered by each band's ids (``gather_rows``, as
    the layer gathers them; rows of 16 and 24 bytes) against the product
    of the gathered rows with the block-diagonal score projector ``xg @
    A``, which the layer ran before; the largest gap over the largest
    score, within :data:`SCORE_TOL`."""
    import torch

    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.models.gat import _concat_heads, _head_pad
    from mini_tpu_torch.ops.kernels.gather_rows import gather_rows
    from mini_tpu_torch.ops.spmm import _band

    gen = torch.Generator(device).manual_seed(0)
    for H, d in GAT_CELL_HEADS:
        d_pad = _head_pad(H, d)
        F = H * d_pad
        lay = layout_for(g, "pull", F)
        dev = lay.dev(device)
        hws = [torch.randn(lay.n_pad, d, device=device, generator=gen)
               for _ in range(H)]
        a = [torch.randn(d, device=device, generator=gen) / d ** 0.5
             for _ in range(H)]
        hw_cat = _concat_heads(hws, d, d_pad, ones=False)
        A = hw_cat.new_zeros(F, H)
        for h in range(H):
            A[h * d_pad: h * d_pad + d, h] = a[h]
        s_src = torch.stack([hw @ ah for hw, ah in zip(hws, a)], dim=-1)
        gap = top = 0.0
        for k in range(lay.K):
            ids = dev["ids"][k]
            prod = gather_rows(_band(hw_cat, lay, k), ids) @ A
            got = gather_rows(_band(s_src, lay, k), ids)
            gap = max(gap, float((got - prod).abs().max()))
            top = max(top, float(prod.abs().max()))
        assert gap <= SCORE_TOL * top, (H, d, gap, top)
        log(f"# gat vertex scores {label} pull K={lay.K} F={F} H={H}: "
            f"gathered per-vertex scores vs xg @ A, largest gap / largest "
            f"score {gap / top:.3g} (bound {SCORE_TOL})")
        del hws, hw_cat, s_src
        torch.cuda.empty_cache()


def gat_no_lane_step(g, x, labels, mask, K, device) -> None:
    """:data:`GAT_NO_LANE`'s train step under ``attn="auto"``: every layer
    on the banded layer (the launches a layer of :func:`phase_gat`'s step,
    none sent to the fused path), its loss and gradients against the fused
    path's."""
    import torch

    from mini_tpu_torch.models import gat
    from mini_tpu_torch.models.gat import _head_pad, gat_init, gat_init_opt

    dims, heads, skip = (GAT_NO_LANE[k] for k in ("dims", "heads", "skip"))
    assert all(_head_pad(h, d) == d for h, d in zip(heads, dims[1:]))
    params = gat_init(torch.Generator().manual_seed(3), dims, heads=heads,
                      device=device)

    def step(attn):
        return gat.gat_train_step(params, gat_init_opt(params), g, x,
                                  (labels, mask), 1e-2, attn=attn, skip=skip)

    before, fused = launches_now(), gat.fused_layers
    (_, grads, loss), dense = dense_calls(lambda: step("auto"))
    counts = launches_since(before)
    L = len(heads)
    want = dict(segment_reduce=3 * L, banded_segment_sum=2 * L,
                banded_sddmm=L, segment_sum=0, gather_rows=L * 2 * K,
                apply_fixed_perm=L)
    assert counts == want, counts
    assert gat.fused_layers == fused, "a no-lane layer left the banded path"
    assert dense == gat_dense_calls(dims, heads, True), dense
    _, grads_f, loss_f = step("fused")
    np.testing.assert_allclose(float(loss), float(loss_f), rtol=1e-5)
    err = grads_close(grads, grads_f, GRAD_TOL)
    per = {f"{k}{i}": float((a[k] - b[k]).abs().max() / b[k].abs().max())
           for i, (a, b) in enumerate(zip(grads, grads_f)) for k in b}
    log(f"# gat no-lane step rmat{SCALE} {dims} heads {heads} skip "
        f"{list(skip)}: every layer banded, {json.dumps(counts)}, {dense} "
        f"cuBLAS calls (the product form's {dense + L * K}); loss "
        f"{float(loss):.6f} (fused {float(loss_f):.6f}), grads vs fused "
        f"max err/max|fused| {err:.3g} (bound {GRAD_TOL}; per parameter "
        + ", ".join(f"{k} {v:.3g}" for k, v in per.items()) + ")")


def phase_gat(hg, g, hg_big, device):
    """bench.py's gat rows (gat_f32, gat_bf16, gat_train_*) on the RMAT
    graph, its profile by kernel, the peak memory of a train step (also on
    ``hg_big``, the rmat18 host graph), and ER-2048 learning."""
    import torch

    from mini_tpu_torch.graph import GraphSlice, erdos_renyi
    from mini_tpu_torch.graph.banded import get_pull_to_push_rank, layout_for
    from mini_tpu_torch.models.gat import (
        gat_forward, gat_forward_cpu, gat_init, gat_init_opt, gat_train_step,
    )
    from mini_tpu_torch.utils.timing import time_fn

    F = GAT_HEADS * 64  # two heads of 32, each padded to 64 columns
    K = layout_for(g, "pull", F).K
    params = gat_init(torch.Generator().manual_seed(0), GAT_DIMS,
                      heads=GAT_HEADS, device=device)
    x_np = np.random.RandomState(0).rand(g.n_pad, F_IN).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)

    heads = [GAT_HEADS] * (len(GAT_DIMS) - 1)
    with torch.no_grad():
        before = launches_now()
        out32, dense = dense_calls(lambda: gat_forward(params, g, x))
        counts = launches_since(before)
    # the banded layer: per layer K band gathers of the source scores, one
    # banded sum (reading the rows by the bands' ids) and one segment
    # reduce (the softmax denominators, all bands and heads), and no
    # permutation (the fused path permutes its weights into bands)
    want = dict(segment_reduce=2, banded_segment_sum=2, banded_sddmm=0,
                segment_sum=0, gather_rows=2 * K, apply_fixed_perm=0)
    assert counts == want, counts
    # each layer's slot scores gathered from its vertex scores (K more
    # row gathers): no cuBLAS call on a band's rows (the product form made
    # 12 + 2 K)
    assert dense == gat_dense_calls(GAT_DIMS, heads, False), dense
    ref = gat_forward_cpu(
        [{k: v.cpu().numpy() for k, v in p.items()} for p in params], hg,
        x_np)
    got32 = out32.cpu().numpy()[: hg.n]
    assert np.isfinite(got32).all() and got32.shape == (hg.n, GAT_DIMS[-1])
    np.testing.assert_allclose(got32, ref, rtol=1e-3, atol=1e-4)
    with torch.no_grad():
        out16 = gat_forward(params, g, x, message_dtype=torch.bfloat16)
        fused = gat_forward(params, g, x, attn="fused")
    np.testing.assert_allclose(out16.cpu().numpy(), out32.cpu().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(fused.cpu().numpy(), out32.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    log(f"# gat rmat{SCALE} {GAT_DIMS} H={GAT_HEADS} forward: auto took the "
        f"banded layer (K={K}); f32 allclose to gat_forward_cpu (rtol 1e-3, "
        f"atol 1e-4), bf16 within {BF16_TOL}, fused allclose (rtol 1e-4)")

    labels = torch.from_numpy(np.random.RandomState(1).randint(
        0, N_CLASSES, g.n_pad)).to(device)
    mask = torch.arange(g.n_pad, device=device) < g.n
    opt = gat_init_opt(params)

    def step(attn, mdt=None):
        return gat_train_step(params, opt, g, x, (labels, mask), 1e-2,
                              message_dtype=mdt, attn=attn)

    before = launches_now()
    (_, grads, loss), dense_step = dense_calls(lambda: step("auto"))
    counts = launches_since(before)
    assert dense_step == gat_dense_calls(GAT_DIMS, heads, True), dense_step
    # per layer: forward K gathers (the source scores) + 1 sum (the rows
    # read by id) + 1 segment reduce (the denominators); backward K
    # gathers + 1 SDDMM (weight cotangent), 2 segment reduces (ds_dst off
    # the pull bands, ds_src off the push bands: each one launch for all
    # bands and heads, where a launch per band and head made H (K + K_b)
    # = 12 a layer), 1 permutation (pull to push bands), 1 sum (g_h, the
    # rows read by id); 3 K + K_b gathers a layer before kernel 2 read
    # rows by id
    want = dict(segment_reduce=2 * 3, banded_segment_sum=4,
                banded_sddmm=2, segment_sum=0, gather_rows=2 * 2 * K,
                apply_fixed_perm=2)
    assert counts == want, (
        "a GAT step launches kernel 1 once per layer and direction (all "
        "bands and heads in one launch)", counts)
    log(f"# gat train step launches (banded, native backward): "
        f"{json.dumps(counts)}; cuBLAS calls a forward {dense} and a step "
        f"{dense_step} (the product form's {dense + 2 * K} and "
        f"{dense_step + 2 * K})")
    # from zero momentum the new momentum is the gradient itself
    _, grads_f, loss_f = step("fused")
    np.testing.assert_allclose(float(loss), float(loss_f), rtol=1e-5)
    err = grads_close(grads, grads_f, GRAD_TOL)
    _, grads16, loss16 = step("auto", torch.bfloat16)
    np.testing.assert_allclose(float(loss16), float(loss), rtol=BF16_TOL)
    # bf16 messages: about 3 digits of the step's largest gradient (a
    # small parameter's own gradient can lose more)
    scale = max(float(p[k].abs().max()) for p in grads_f for k in p)
    err16 = max(float((a[k] - b[k]).abs().max())
                for a, b in zip(grads16, grads_f) for k in b) / scale
    assert err16 <= BF16_TOL, err16
    log(f"# gat train step: loss {float(loss):.6f} (fused "
        f"{float(loss_f):.6f}, bf16 {float(loss16):.6f}); banded grads vs "
        f"fused max err/max|fused| {err:.3g} per parameter (bound "
        f"{GRAD_TOL}); bf16 grads max err/largest fused grad {err16:.3g} "
        f"(bound {BF16_TOL})")
    gat_no_lane_step(g, x, labels, mask, K, device)

    for name, attn, mdt in (("gat_train_f32", "auto", None),
                            ("gat_train_bf16", "auto", torch.bfloat16),
                            ("gat_train_fused_f32", "fused", None)):
        with torch.no_grad():
            fwd = time_fn(lambda: gat_forward(params, g, x, message_dtype=mdt,
                                              attn=attn),
                          warmup=1, repeat=5, device=device)
        t = time_fn(lambda: step(attn, mdt), warmup=1, repeat=5,
                    device=device)
        log(f"# {name} rmat{SCALE}: step {t.min_s * 1e3:.3f} ms, forward "
            f"{fwd.min_s * 1e3:.3f} ms (min of 5); step/forward "
            f"{t.min_s / fwd.min_s:.2f}")

    def peak_memory(gg, xx, ll, mm, mdt):
        pp = gat_init(torch.Generator().manual_seed(0), GAT_DIMS,
                      heads=GAT_HEADS, device=device)
        oo = gat_init_opt(pp)
        gat_train_step(pp, oo, gg, xx, (ll, mm), 1e-2, message_dtype=mdt)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        gat_train_step(pp, oo, gg, xx, (ll, mm), 1e-2, message_dtype=mdt)
        torch.cuda.synchronize(device)
        return torch.cuda.max_memory_allocated(device) / 2**30, base / 2**30

    for mdt in (None, torch.bfloat16):
        peak, base = peak_memory(g, x, labels, mask, mdt)
        log(f"# gat train step rmat{SCALE} {'f32' if mdt is None else 'bf16'}"
            f": peak device memory {peak:.3f} GiB (max_memory_allocated; "
            f"{base:.3f} GiB allocated before the step)")
    profile_gat(g, device)
    with uncounted():
        hold_gat_kernels(f"rmat{SCALE}", g, device)
        gat_vertex_scores(f"rmat{SCALE}", g, device)

    t0 = time.perf_counter()
    g_big = GraphSlice.from_host(hg_big, device=device)
    lp = layout_for(g_big, "pull", F)
    lb = layout_for(g_big, "push", F)
    get_pull_to_push_rank(g_big, lp, lb)
    build_s = time.perf_counter() - t0
    log(f"# rmat{MEMORY_SCALE}: n={hg_big.n} m={hg_big.m} (device graph, "
        f"layouts and composite rank {build_s:.2f} s, K={lp.K})")
    if build_s <= BUILD_LIMIT_S:
        x_big = torch.rand(g_big.n_pad, F_IN, device=device,
                           generator=torch.Generator(device).manual_seed(0))
        l_big = torch.randint(0, N_CLASSES, (g_big.n_pad,), device=device)
        m_big = torch.arange(g_big.n_pad, device=device) < g_big.n
        for mdt in (None, torch.bfloat16):
            peak, base = peak_memory(g_big, x_big, l_big, m_big, mdt)
            log(f"# gat train step rmat{MEMORY_SCALE} "
                f"{'f32' if mdt is None else 'bf16'}: peak device memory "
                f"{peak:.3f} GiB ({base:.3f} GiB allocated before the step)")
        del x_big, l_big, m_big
    else:
        log(f"# rmat{MEMORY_SCALE} host build over {BUILD_LIMIT_S} s: its "
            f"peak memory is not measured")
    del g_big

    # tests/test_models.py:196-214: a few steps lower the loss
    g_er = GraphSlice.from_host(
        erdos_renyi(2048, 16384, seed=0, undirected=True), device=device)
    x_er = torch.from_numpy(np.random.RandomState(10).rand(
        g_er.n_pad, F_IN).astype(np.float32)).to(device)
    lab = torch.from_numpy(np.random.RandomState(10).randint(
        0, N_CLASSES, g_er.n_pad)).to(device)
    msk = torch.arange(g_er.n_pad, device=device) < g_er.n
    p = gat_init(torch.Generator().manual_seed(10), GAT_DIMS,
                 heads=GAT_HEADS, device=device)
    o = gat_init_opt(p)
    losses = []
    for _ in range(5):
        p, o, loss = gat_train_step(p, o, g_er, x_er, (lab, msk), 0.1)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    log(f"# phase 7: gat train er2048 lr 0.1: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} in 5 steps")


def phase_sage(g, device):
    """GraphSAGE [128, 128, 32]: ER-2048 against the dense oracle, the RMAT
    graph's banded forward and gradients against impl="xla", the step."""
    import torch

    from mini_tpu_torch.graph import GraphSlice, erdos_renyi
    from mini_tpu_torch.models.sage import (
        sage_forward, sage_forward_cpu, sage_init, sage_init_opt, sage_loss,
        sage_normalize, sage_train_step,
    )
    from mini_tpu_torch.utils.timing import time_fn

    dims = [F_IN, F_HID, F_OUT]
    params = sage_init(torch.Generator().manual_seed(0), dims, device=device)
    params_np = [{k: v.cpu().numpy() for k, v in p.items()} for p in params]
    hg_er = erdos_renyi(2048, 16384, seed=0, undirected=True)
    g_er = GraphSlice.from_host(hg_er, device=device)
    x_np = np.random.RandomState(0).rand(g_er.n_pad, F_IN).astype(np.float32)
    with torch.no_grad():
        out = sage_forward(params, g_er, torch.from_numpy(x_np).to(device))
    np.testing.assert_allclose(out.cpu().numpy()[: hg_er.n],
                               sage_forward_cpu(params_np, hg_er, x_np),
                               rtol=1e-4, atol=1e-5)
    log("# sage er2048: banded forward allclose to sage_forward_cpu (rtol "
        "1e-4, atol 1e-5)")

    x = torch.from_numpy(np.random.RandomState(0).rand(g.n_pad, F_IN)
                         .astype(np.float32)).to(device)
    labels = torch.from_numpy(np.random.RandomState(1).randint(
        0, N_CLASSES, g.n_pad)).to(device)
    mask = torch.arange(g.n_pad, device=device) < g.n
    res = {}
    for impl in ("banded", "xla"):
        leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
                  for p in params]
        out = sage_forward(leaves, g, x, impl=impl)
        loss = sage_loss(leaves, g, x, labels, mask, impl=impl)
        grads = torch.autograd.grad(loss, [v for p in leaves
                                           for v in p.values()])
        res[impl] = (out.detach(), [dict(zip(p, grads[2 * i: 2 * i + 2]))
                                    for i, p in enumerate(leaves)])
    np.testing.assert_allclose(res["banded"][0].cpu().numpy(),
                               res["xla"][0].cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    err = grads_close(res["banded"][1], res["xla"][1], GRAD_TOL)
    log(f"# sage rmat{SCALE} banded vs xla: forward allclose (rtol 1e-4), "
        f"grads max err/max|xla| {err:.3g} (bound {GRAD_TOL})")

    opt = sage_init_opt(params)

    def step(impl):
        return sage_train_step(params, opt, g, x, (labels, mask), 1e-2,
                               impl=impl)

    before = launches_now()
    step("banded")
    counts = launches_since(before)
    # per layer: 2 permutations (the mean's weights into pull and push
    # bands), 1 sum (the rows read by the K bands' ids); the backward: dx
    # of layer 2 only (x needs no gradient), 1 sum; no SDDMM (constant
    # weights), no band gather
    want = dict(segment_reduce=0, banded_segment_sum=3, banded_sddmm=0,
                segment_sum=0, gather_rows=0, apply_fixed_perm=4)
    assert counts == want, counts
    # with the weights pre-banded once (sage_normalize): no permutation
    norm = sage_normalize(g, dims[:-1])
    before = launches_now()
    out_n = sage_train_step(params, opt, g, x, (labels, mask), 1e-2,
                            norm=norm)
    assert launches_since(before) == {**want, "apply_fixed_perm": 0}
    out_r = step("banded")
    for a, b in zip(out_n[0], out_r[0]):
        for k in a:
            assert torch.equal(a[k], b[k]), k  # the same bands, the same bits
    sage_past_128_bands(params, g, x, labels, mask, res["xla"][1], device)
    for impl in ("banded", "xla"):
        t = time_fn(lambda: step(impl), warmup=1, repeat=5, device=device)
        log(f"# sage_train rmat{SCALE} {impl} f32: step "
            f"{t.min_s * 1e3:.3f} ms (min of 5)")
    log(f"# phase 8: sage train step launches {json.dumps(counts)}")


def sage_past_128_bands(params, g, x, labels, mask, ref, device) -> None:
    """The SAGE loss's gradients with ``sage_normalize``'s weights on
    layouts of more than 128 bands, as ogbn-products' 256 columns take
    them (K = 150): the band height cut to 128 rows (K = 513 on the RMAT
    graph), every kernel-2 launch of the forward and backward wide, no
    re-band, the gradients within GRAD_TOL of ``impl="xla"``'s (``ref``).
    The cut layouts leave the layout cache afterwards."""
    import torch

    import mini_tpu_torch.graph.banded as banded
    from mini_tpu_torch.models.sage import sage_loss, sage_normalize
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    spmm_mod = sys.modules["mini_tpu_torch.ops.spmm"]
    saved = banded.FAST_TABLE_BYTES
    banded.FAST_TABLE_BYTES = banded.ROW_TILE * 128 * 4  # 128-row bands
    try:
        norm = sage_normalize(g, [F_IN, F_HID])
        K = banded.layout_for(g, "pull", F_HID).K
        assert K > 128, K
        leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
                  for p in params]
        before = (k2.launches, k2.wide_launches, spmm_mod.rebanded)
        loss = sage_loss(leaves, g, x, labels, mask, norm=norm)
        grads = torch.autograd.grad(loss, [v for p in leaves
                                           for v in p.values()])
        counts = (k2.launches - before[0], k2.wide_launches - before[1],
                  spmm_mod.rebanded - before[2])
        # two layers forward, layer 2's input gradient backward
        assert counts == (3, 3, 0), counts
    finally:
        banded.FAST_TABLE_BYTES = saved
        rows = banded.ROW_TILE
        for key in [k for k in banded._LAYOUT_CACHE if k[2] == rows]:
            del banded._LAYOUT_CACHE[key]
        for key in [k for k in banded._COMPOSITE_CACHE if rows in k[1:5]]:
            del banded._COMPOSITE_CACHE[key]
    err = grads_close([dict(zip(p, grads[2 * i: 2 * i + 2]))
                       for i, p in enumerate(leaves)], ref, GRAD_TOL)
    log(f"# sage rmat{SCALE} past 128 bands (K={K}): 3 launches of kernel "
        f"2, all wide, 0 re-banded weights; grads max err/max|xla| "
        f"{err:.3g} (bound {GRAD_TOL})")


SOURCES = 8  # bench.py:335's Graph500-style batch: the top-degree sources
GRID = (2048, 256)  # a road-like graph: 524,288 vertices, ~2.1M edges


def top_sources(hg) -> list:
    return [int(s) for s in np.argsort(hg.out_degrees)[-SOURCES:]]


def reached_edges(hg, reached) -> float:
    """bench.py's accounting: the out-edges of the reached vertices."""
    return float(hg.out_degrees[reached].sum())


def phase_bfs_batch(hg, g, device):
    """``bfs_batch`` from the 8 highest-degree sources: each row bitwise
    ``bfs``'s, its four round counters too; the time per source and the
    amortised MTEPS with and without preds (``bench.py:329-359``)."""
    import torch

    from mini_tpu_torch.algorithms import bfs, bfs_batch
    from mini_tpu_torch.algorithms.bfs import COUNTERS
    from mini_tpu_torch.utils.timing import time_fn

    srcs = top_sources(hg)
    res = bfs_batch(g, srcs)
    lean = bfs_batch(g, srcs, with_preds=False)
    edges = 0.0
    for i, s in enumerate(srcs):
        one = bfs(g, s)
        assert torch.equal(res.labels[i], one.labels), s
        assert torch.equal(res.preds[i], one.preds), s
        assert torch.equal(lean.labels[i], one.labels), s
        for f in COUNTERS:
            assert int(getattr(res, f)[i]) == getattr(one, f), (s, f)
            assert int(getattr(lean, f)[i]) == getattr(one, f), (s, f)
        assert not bool(res.sparse_overflowed[i]), s
        edges += reached_edges(hg, one.labels.cpu().numpy()[: hg.n] >= 0)
    assert bool((lean.preds == -1).all())
    rounds = int(res.num_iterations.sum())
    for label, kw in (("with preds", {}), ("labels only",
                                           dict(with_preds=False))):
        t = time_fn(lambda: bfs_batch(g, srcs, **kw), warmup=1, repeat=3,
                    device=device)
        log(f"# phase 9: bfs_batch {SOURCES} sources, {label}: "
            f"{t.min_s / SOURCES * 1e3:.3f} ms a source (min of 3), "
            f"amortised {edges / t.min_s / 1e6:.2f} MTEPS; rows "
            f"bitwise bfs, their counters bfs's ({rounds} rounds, "
            f"{int(res.num_sparse_iterations.sum())} sparse)")


def host_sssp_parent(hg, dists, src):
    """pred[v] = min{u : dists[u] + w(u, v) == dists[v]} in float32, -1 for
    the source and the unreached (NumPy)."""
    u, v, w = hg.csr_srcs, hg.csr_dsts, hg.csr_weights
    cand = np.isfinite(dists[v]) & (
        (dists[u] + w).astype(np.float32) == dists[v])
    big = np.iinfo(np.int32).max
    pred = np.full(hg.n, big, np.int64)
    np.minimum.at(pred, v[cand], u[cand])
    pred = np.where(np.isfinite(dists) & (pred != big), pred, -1)
    pred[src] = -1
    return pred.astype(np.int32)


def check_sssp(hg, r, src, label, want=None):
    """One SSSP result against the Dijkstra oracle's dists (``want``, run
    here when None) bitwise, the host's min-id parent and the
    shortest-path-tree check; returns the dists."""
    from mini_tpu_torch.algorithms import sssp_cpu, validate_pred_tree

    dists = r.dists.cpu().numpy()[: hg.n]
    preds = r.preds.cpu().numpy()[: hg.n]
    if want is None:
        want = sssp_cpu(hg, src)[0]
    np.testing.assert_array_equal(dists, want)
    np.testing.assert_array_equal(preds, host_sssp_parent(hg, dists, src))
    assert validate_pred_tree(dists, preds, hg, src), (label, src)
    assert r.sparse_overflowed is False, (label, src)
    return dists


def sssp_rounds(r) -> str:
    return (f"{r.num_iterations} rounds ({r.num_sparse_iterations} sparse, "
            f"{r.num_chained_iterations} chained)")


def phase_sssp(hg, g, device):
    """SSSP from the hub and 3 reached sources: dists bitwise ``sssp_cpu``,
    preds the host's min-id parent; the time and MTEPS (``bench.py:157-
    165``); dense rounds alone launch the segment reduce once a round and
    once for the preds, with the same bits; delta and auto agree."""
    import torch

    from mini_tpu_torch.algorithms import sssp
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.utils.timing import time_fn

    hub = int(np.argmax(hg.out_degrees))
    res = sssp(g, hub)
    dists = check_sssp(hg, res, hub, "bellman")
    reached = np.nonzero(np.isfinite(dists))[0]
    others = np.random.RandomState(0).choice(reached, 3, replace=False)
    for src in [int(s) for s in others]:
        r = sssp(g, src)
        check_sssp(hg, r, src, "bellman")
        log(f"# sssp src={src}: {sssp_rounds(r)}, dists and preds exact")
    before = k1.launches
    dense = sssp(g, hub, sparse_cape=0)
    launched = k1.launches - before
    assert launched == dense.num_iterations + 1, (launched, dense)
    assert dense.num_sparse_iterations == 0
    assert torch.equal(dense.dists, res.dists)
    assert torch.equal(dense.preds, res.preds)
    for variant in ("delta", "auto"):
        other = sssp(g, hub, variant=variant)
        assert torch.equal(other.dists, res.dists), variant
        log(f"# sssp {variant} hub: {sssp_rounds(other)}, dists equal")
    edges = reached_edges(hg, reached)
    t = time_fn(lambda: sssp(g, hub), warmup=1, repeat=3, device=device)
    td = time_fn(lambda: sssp(g, hub, sparse_cape=0), warmup=1, repeat=3,
                 device=device)
    log(f"# phase 10: sssp hub={hub} {sssp_rounds(res)}: "
        f"{t.min_s * 1e3:.3f} ms (min of 3), {t.mteps(edges):.2f} MTEPS; "
        f"dense rounds only: {sssp_rounds(dense)}, "
        f"{td.min_s * 1e3:.3f} ms, segment_reduce launches "
        f"{launched} = rounds + 1")


def phase_sssp_batch(hg, g, device):
    """``sssp_batch`` over the 8 sources: each row bitwise ``sssp``'s; the
    time per source and the amortised MTEPS (``bench.py:362-380``)."""
    import torch

    from mini_tpu_torch.algorithms import sssp, sssp_batch
    from mini_tpu_torch.utils.timing import time_fn

    srcs = top_sources(hg)
    res = sssp_batch(g, srcs)
    edges = 0.0
    for i, s in enumerate(srcs):
        one = sssp(g, s)
        assert torch.equal(res.dists[i], one.dists), s
        assert torch.equal(res.preds[i], one.preds), s
        assert int(res.num_iterations[i]) == one.num_iterations, s
        edges += reached_edges(hg, torch.isfinite(one.dists).cpu().numpy()
                               [: hg.n])
    assert not bool(res.sparse_overflowed.any())
    t = time_fn(lambda: sssp_batch(g, srcs), warmup=1, repeat=3,
                device=device)
    log(f"# phase 11: sssp_batch {SOURCES} sources: "
        f"{t.min_s / SOURCES * 1e3:.3f} ms a source (min of 3), amortised "
        f"{edges / t.min_s / 1e6:.2f} MTEPS; rows bitwise sssp")


def grid_graph(device):
    """``grid2d(2048, 256)``, built once for phases 12 and 12b."""
    from mini_tpu_torch.graph import GraphSlice, grid2d

    t0 = time.perf_counter()
    hg = grid2d(*GRID, seed=0, weighted=True)
    g = GraphSlice.from_host(hg, device=device)
    log(f"# grid2d{GRID}: n={hg.n} m={hg.m} (host build "
        f"{time.perf_counter() - t0:.2f} s)")
    return hg, g


def phase_sssp_grid(hg, g, device):
    """Delta-stepping's target family: ``grid2d(2048, 256)`` from vertex 0,
    ``delta`` and ``bellman`` both bitwise ``sssp_cpu``; many small rounds,
    so the time per round is the host loop's cost."""
    from mini_tpu_torch.algorithms import sssp, sssp_cpu
    from mini_tpu_torch.utils.timing import time_fn

    want = sssp_cpu(hg, 0)[0]
    for variant in ("delta", "bellman"):
        r = sssp(g, 0, variant=variant)
        check_sssp(hg, r, 0, variant, want)
        t = time_fn(lambda: sssp(g, 0, variant=variant), warmup=0, repeat=1,
                    device=device)  # the checked run above was the warm-up
        edges = reached_edges(hg, np.isfinite(r.dists.cpu().numpy()[: hg.n]))
        log(f"# phase 12: sssp grid2d{GRID} {variant}: {sssp_rounds(r)}, "
            f"{t.min_s * 1e3:.1f} ms, "
            f"{t.min_s / r.num_iterations * 1e3:.4f} ms a round, "
            f"{t.mteps(edges):.2f} MTEPS; dists and preds exact")


def phase_bfs_grid(hg, g, device):
    """BFS's chained family: ``grid2d(2048, 256)`` from vertex 0 (mean
    out-degree under 5, so the chain is on by default), JAX's defaults and
    dense rounds only, each checked as phase 3 checks (``check_bfs``), then
    one timed run each (the checked run was the warm-up)."""
    from mini_tpu_torch.algorithms import bfs, bfs_cpu
    from mini_tpu_torch.utils.timing import time_fn

    want, t_oracle = oracle(bfs_cpu, hg, 0)
    edges = reached_edges(hg, want >= 0)
    for label, kw in BFS_SCHEDULES[:2]:
        r = check_bfs(hg, g, 0, kw, want)
        if kw:
            assert r.num_sparse_iterations == 0
        else:
            assert r.num_chained_iterations > 0
        t = time_fn(lambda: bfs(g, 0, **kw), warmup=0, repeat=1,
                    device=device)
        log(f"# phase 12b: bfs grid2d{GRID} {label}: {bfs_rounds(r)}, "
            f"{t.min_s * 1e3:.1f} ms, "
            f"{t.min_s / r.num_iterations * 1e3:.4f} ms a round, "
            f"{t.mteps(edges):.2f} MTEPS; labels and preds exact "
            f"(bfs_cpu {t_oracle:.1f} s)")


def phase_pagerank(hg, g, device):
    """PageRank, ``standard`` and ``mini``, 30 rounds at most
    (``bench.py:167-178``): within rtol 1e-4, atol 1e-6 of ``pagerank_cpu``,
    one segment-reduce launch a round; the time and edges per second."""
    from mini_tpu_torch.algorithms import pagerank, pagerank_cpu
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.utils.timing import time_fn

    for variant in ("standard", "mini"):
        before = k1.launches
        r = pagerank(g, variant=variant, max_iter=30)
        assert k1.launches - before == r.num_iterations, variant
        ranks = r.ranks.cpu().numpy()
        assert np.isfinite(ranks).all()
        np.testing.assert_allclose(
            ranks[: hg.n], pagerank_cpu(hg, variant=variant, max_iter=30),
            rtol=1e-4, atol=1e-6)
        t = time_fn(lambda: pagerank(g, variant=variant, max_iter=30),
                    warmup=1, repeat=3, device=device)
        iters = max(r.num_iterations, 1)
        log(f"# phase 13: pagerank {variant}: {r.num_iterations} rounds, "
            f"{t.min_s * 1e3:.3f} ms (min of 3), "
            f"{hg.m * iters / t.min_s / 1e9:.3f} G edges/s; "
            f"allclose to pagerank_cpu")


def phase_cc(hg, g, device):
    """Connected components: bitwise ``cc_cpu``, the same count, two
    segment-reduce launches a round; the time."""
    from mini_tpu_torch.algorithms import cc_cpu, connected_components
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.utils.timing import time_fn

    before = k1.launches
    r = connected_components(g)
    assert k1.launches - before == 2 * r.num_iterations
    want = cc_cpu(hg)
    np.testing.assert_array_equal(r.components.cpu().numpy()[: hg.n], want)
    assert r.num_components == len(np.unique(want))
    t = time_fn(lambda: connected_components(g), warmup=1, repeat=3,
                device=device)
    log(f"# phase 14: cc {r.num_components} components, "
        f"{r.num_iterations} rounds, {t.min_s * 1e3:.3f} ms (min of 3), "
        "bitwise cc_cpu")


def oracle(fn, *args):
    """``fn(*args)`` and its host seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def timed_path(fn, device, rounds: int) -> str:
    """A path's time, min of 3 after 1 warmup, and its time a round."""
    from mini_tpu_torch.utils.timing import time_fn

    t = time_fn(fn, warmup=1, repeat=3, device=device)
    return (f"{t.min_s * 1e3:.3f} ms (min of 3), "
            f"{t.min_s / max(rounds, 1) * 1e3:.4f} ms a round")


def phase_kcore(hg, g, device):
    """k-core on the RMAT graph: ``hindex`` (the ``auto`` default) bitwise
    ``kcore_cpu_true``, one segment-reduce launch a step; ``mini`` bitwise
    ``kcore_cpu``, one launch per dense peel round; on the directed
    ``rmat(16, 16, seed=0)`` ``auto`` takes ``mini``, bitwise ``kcore_cpu``,
    and ``hindex`` raises ``ValueError``."""
    from mini_tpu_torch.algorithms import kcore, kcore_cpu, kcore_cpu_true
    from mini_tpu_torch.graph import GraphSlice, rmat
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1

    def check(r, want, n, label):
        cores = r.num_cores.cpu().numpy()
        np.testing.assert_array_equal(cores[:n], want[0])
        assert not cores[n:].any(), label
        assert r.largest_k_core == want[1], (label, r.largest_k_core)

    true, s_true = oracle(kcore_cpu_true, hg)
    mini, s_mini = oracle(kcore_cpu, hg)
    before = k1.launches
    h = kcore(g)
    assert k1.launches - before == h.num_iterations, (k1.launches, h)
    check(h, true, hg.n, "hindex")
    before = k1.launches
    m = kcore(g, "mini")
    dense = k1.launches - before
    assert 1 <= dense <= m.num_iterations, (dense, m.num_iterations)
    check(m, mini, hg.n, "mini")
    t_h = timed_path(lambda: kcore(g), device, h.num_iterations)
    log(f"# phase 15: kcore hindex: {h.num_iterations} steps, largest core "
        f"{h.largest_k_core}, {t_h}; bitwise kcore_cpu_true "
        f"({s_true:.2f} s), launches = steps")
    t_m = timed_path(lambda: kcore(g, "mini"), device, m.num_iterations)
    log(f"# phase 15: kcore mini: {m.num_iterations} peel rounds "
        f"({dense} dense, {m.num_iterations - dense} sparse), largest core "
        f"{m.largest_k_core}, {t_m}; bitwise kcore_cpu ({s_mini:.2f} s)")

    hd = rmat(SCALE, edge_factor=16, seed=0, undirected=False)
    gd = GraphSlice.from_host(hd, device=device)
    want, s_want = oracle(kcore_cpu, hd)
    d = kcore(gd)
    check(d, want, hd.n, "directed auto")
    try:
        kcore(gd, "hindex")
    except ValueError:
        pass
    else:
        raise AssertionError("hindex ran on a directed graph")
    t_d = timed_path(lambda: kcore(gd), device, d.num_iterations)
    log(f"# phase 15: kcore auto on directed rmat{SCALE} (m={hd.m}): mini, "
        f"{d.num_iterations} peel rounds, largest core {d.largest_k_core}, "
        f"{t_d}; bitwise kcore_cpu ({s_want:.2f} s); hindex raises "
        f"ValueError")


COLORING_PRIME = 1000003


def generic_coloring(gg, max_iter=None, seed=0, K=8):
    """The generic coloring path at K hash orders, its seeds drawn as
    ``coloring`` draws them."""
    import torch

    from mini_tpu_torch.algorithms.coloring import _coloring_generic

    gen = torch.Generator().manual_seed(seed)
    return _coloring_generic(
        gg, lambda it: torch.randint(COLORING_PRIME, (gg.n_pad,),
                                     generator=gen, dtype=torch.int32),
        max(2 * gg.n, 64) if max_iter is None else max_iter, K)


def phase_coloring(hg, g, device):
    """Coloring on the RMAT graph, K=16 (the fast path), K=1 (the
    reference's recipe) and the generic path at K=8: each proper
    (``validate_coloring``) with the ghosts at 0, one segment-reduce launch
    a round, and its first 8 rounds bitwise the same call's on the CPU."""
    import torch

    from mini_tpu_torch.algorithms import coloring, validate_coloring
    from mini_tpu_torch.graph import GraphSlice
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1

    g_cpu = GraphSlice.from_host(hg, device="cpu")
    runs = {
        "K=16 fast": lambda gg, **kw: coloring(gg, **kw),
        "K=1": lambda gg, **kw: coloring(gg, hashes_per_round=1, **kw),
        "K=8 generic": generic_coloring,
    }
    for label, run in runs.items():
        before = k1.launches
        r = run(g)
        assert k1.launches - before == r.num_iterations, (label, r)
        colors = r.colors.cpu().numpy()
        ok, s_ok = oracle(validate_coloring, colors, hg)
        assert ok, label
        assert not colors[hg.n:].any(), label
        t0 = time.perf_counter()
        on_cpu = run(g_cpu, max_iter=8)
        s_cpu = time.perf_counter() - t0
        assert on_cpu.num_iterations == min(8, r.num_iterations), label
        assert torch.equal(run(g, max_iter=8).colors.cpu(), on_cpu.colors)
        log(f"# phase 16: coloring {label}: {r.num_iterations} rounds, "
            f"{len(np.unique(colors[: hg.n]))} colors, "
            f"{timed_path(lambda: run(g), device, r.num_iterations)}; proper "
            f"(validate_coloring {s_ok:.2f} s), "
            f"{on_cpu.num_iterations} rounds bitwise the CPU's "
            f"({s_cpu:.2f} s)")
    # the first round alone, by kernel: where a round's device time goes
    events = device_events(lambda: coloring(g, max_iter=1), device, 3)
    by_name = {}
    for name, us in events:
        by_name[name[:48]] = by_name.get(name[:48], 0.0) + us / 3e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"# phase 16: one K=16 round: {len(events) / 3:.0f} device ops, "
        f"{sum(by_name.values()):.4f} ms busy; by kernel (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in top))


def phase_lspar(hg, g, device):
    """L-Spar (``prime=999983, e=0.5, seed=0``): one segment-reduce launch;
    the count, per vertex too, equal ``lspar_cpu``'s and the top-by-sim
    property holds; the mask bitwise the CPU's."""
    import torch

    from mini_tpu_torch.algorithms import lspar, lspar_cpu
    from mini_tpu_torch.graph import GraphSlice
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1

    prime, e, seed = 999983, 0.5, 0
    before = k1.launches
    r = lspar(g, prime, e, seed)
    assert k1.launches - before == 1, k1.launches - before
    rng = np.random.RandomState(seed)
    a, b = rng.randint(1, prime), rng.randint(0, prime)
    hashs = ((b + a * np.arange(g.n_pad, dtype=np.int64)) % prime).astype(
        np.int32)
    (want, count), s_want = oracle(lspar_cpu, hg, hashs, e)
    assert int(r.num_selected) == count, (int(r.num_selected), count)
    sel = r.selected_mask.cpu().numpy()[: hg.m]
    srcs = hg.csr_srcs
    np.testing.assert_array_equal(np.bincount(srcs[sel], minlength=hg.n),
                                  np.bincount(srcs[want], minlength=hg.n))
    sims = r.sims.cpu().numpy()[: hg.m]
    low_in = np.full(hg.n, 2)  # least sim of a vertex's selected edges
    np.minimum.at(low_in, srcs[sel], sims[sel])
    high_out = np.full(hg.n, -1)  # greatest sim of its unselected ones
    np.maximum.at(high_out, srcs[~sel], sims[~sel])
    assert (low_in >= high_out).all()
    on_cpu = lspar(GraphSlice.from_host(hg, device="cpu"), prime, e, seed)
    assert torch.equal(r.selected_mask.cpu(), on_cpu.selected_mask)
    assert torch.equal(r.sims.cpu(), on_cpu.sims)
    log(f"# phase 17: lspar: {count} of {hg.m} edges selected, "
        f"{timed_path(lambda: lspar(g, prime, e, seed), device, 1)}; counts "
        f"lspar_cpu's ({s_want:.2f} s), mask bitwise the CPU's")


ROOT = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
# tests/test_cli.py's invocations on the fixture files, in its order
CLI_FIXTURES = [
    [algo, "--file", os.path.join(FIXDIR, f), "--undirected", *more]
    for algo, f, more in (
        ("bfs", "test_bfs.mtx", ("--src", "0", "--validate")),
        ("sssp", "test_bfs.mtx", ("--src", "0", "--validate")),
        ("pr", "test_bfs.mtx", ("--validate",)),
        ("coloring", "test_bfs.mtx", ("--validate",)),
        ("kcore", "test_bfs.mtx", ("--validate",)),
        ("lspar", "test_bfs.mtx", ()),
        ("coloring", "test_coloring.mtx", ("--seed", "31", "--validate")),
        ("pr", "test_coloring.mtx", ("--validate",)),
        ("lspar", "test_coloring.mtx", ()),
        ("sssp", "test_sssp.mtx", ("--src", "0", "--validate")),
        ("kcore", "test_kcore.mtx", ("--validate",)),
        ("gcn", "test_kcore.mtx", ("--validate",)),
        ("cc", "test_bfs.mtx", ("--validate",)),
        ("bfs", "test_bfs.mtx", ("--sources", "0,2,5", "--validate")),
        ("sssp", "test_bfs.mtx", ("--sources", "0,3", "--validate")),
    )
]
CLI_ALGOS = ("bfs", "sssp", "pr", "coloring", "kcore", "lspar", "cc", "gcn",
             "gat", "sage")


def run_cli(argv) -> list:
    """``mini_tpu_torch.cli.main(argv)`` in this process, on the card: it
    must return 0 and, with ``--validate``, print ``Correct.``; its
    printed lines."""
    import contextlib
    import io

    from mini_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    lines = out.getvalue().splitlines()
    assert rc == 0, (argv, rc, lines)
    if "--validate" in argv:
        assert lines[-1] == "Correct.", (argv, lines)
    return lines


def phase_cli(hub: int) -> list:
    """The command-line drivers on the card, in this process: each of the
    ten subcommands on ``--rmat-scale 16`` (``rmat(16, 16, seed=0)``,
    undirected) from the hub, with ``--validate`` (``lspar`` has no
    oracle), each counted as a path of its own; tests/test_cli.py's
    invocations on the fixture files; then ``python -m
    mini_tpu_torch.cli`` once as a process of its own.  Returns the
    launch counts of the paths."""
    t_phase = time.perf_counter()
    counts = []
    for algo in CLI_ALGOS:
        argv = [algo, "--rmat-scale", str(SCALE), "--src", str(hub)]
        argv += [] if algo == "lspar" else ["--validate"]
        t0 = time.perf_counter()
        lines = []
        counts.append(drive(f"cli {algo}", lambda: lines.extend(
            run_cli(argv))))
        shown = [ln for ln in lines if not ln.startswith(("labels[", "dists[",
                                                          "top-10", " "))]
        if algo == "bfs":  # the rounds and the pull count, as JAX prints them
            assert any(ln.startswith("iterations: ") and " (pull: " in ln
                       for ln in lines), lines
        log(f"# cli {' '.join(argv)}: {' | '.join(shown)} "
            f"({time.perf_counter() - t0:.2f} s with the oracle)")
    t0 = time.perf_counter()
    counts.append(drive("cli fixtures", lambda: [run_cli(a)
                                                  for a in CLI_FIXTURES]))
    log(f"# cli: tests/test_cli.py's {len(CLI_FIXTURES)} fixture "
        f"invocations passed in {time.perf_counter() - t0:.2f} s")
    argv = ["bfs", "--rmat-scale", str(SCALE), "--src", str(hub),
            "--validate"]

    def module_entry():  # its launches are the child's, not counted here
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mini_tpu_torch.cli", *argv], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.splitlines()[-1] == "Correct.", proc.stdout[-2000:]
        log(f"# cli: python -m mini_tpu_torch.cli {' '.join(argv)}: "
            f"Correct. ({time.perf_counter() - t0:.2f} s, the process "
            "included)")

    counts.append(drive("cli module entry", module_entry))
    log(f"# phase 18: cli passed in {time.perf_counter() - t_phase:.1f} s")
    return counts


ARXIV = dict(scale=17, feature_dim=128, num_classes=40, seed=0)
ARXIV_DIMS = [128, 128, 40]
ARXIV_STEPS, ARXIV_LR, ARXIV_RESUME = 40, 0.1, 20
HOST_FIELDS = ("row_offsets", "csr_dsts", "csr_srcs", "csr_weights",
               "col_offsets", "csc_srcs", "csc_dsts", "csc_weights",
               "csc_eids")
SCOPES = ("spmm.band_gather_0", "spmm.banded_kernel", "engine.src_to_csc",
          "engine.expand_dst", "engine.segreduce_dst.")
TRACED_KERNELS = ("banded_segment_sum_kernel", "gather_rows_kernel",
                  "segreduce_walk_kernel")


def phase_arxiv(device):
    """``synthetic_arxiv_like(scale=17)`` (131,072 vertices, 4,194,304
    edges): its graph from the native builder, bitwise the NumPy path on
    the same edges, both timed; GCN [128, 128, 40] trained 40 steps at lr
    0.1 on the banded path, the loss falling and test accuracy above 0.7
    (tests/test_datasets.py's bar); after step 20 the params and momentum
    saved and loaded into a fresh structure, step 21 from the loaded state
    bitwise step 21 from the live one; one step, an SDDMM (the band
    gathers) and a BFS under ``trace()``, whose Chrome trace holds the
    five scopes and the port's kernels; the host cost of a ``scope`` with
    no profiler."""
    import json
    import tempfile

    import torch

    import mini_tpu_torch.native as nat
    from mini_tpu_torch.algorithms import bfs, bfs_cpu
    from mini_tpu_torch.graph import GraphSlice
    from mini_tpu_torch.graph.csr import from_edges_numpy
    from mini_tpu_torch.graph.datasets import synthetic_arxiv_like
    from mini_tpu_torch.models.gcn import (
        gcn_forward, gcn_forward_cpu, gcn_init, gcn_init_opt, gcn_normalize,
        gcn_train_step,
    )
    from mini_tpu_torch.ops import engine
    from mini_tpu_torch.ops.spmm import sddmm
    from mini_tpu_torch.utils import load_pytree, save_pytree, scope, trace
    from mini_tpu_torch.utils.profiling import scope_of
    from mini_tpu_torch.utils.timing import time_fn

    t_phase = time.perf_counter()
    assert nat.native_available(), nat.native_build_error()
    builds = []
    real = nat.native_from_edges

    def timed_native(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        builds.append((a, k, time.perf_counter() - t0, out))
        return out

    nat.native_from_edges = timed_native
    try:
        t0 = time.perf_counter()
        ds = synthetic_arxiv_like(**ARXIV)
        t_ds = time.perf_counter() - t0
    finally:
        nat.native_from_edges = real
    hg = ds.graph
    n_want = 2 ** ARXIV["scale"]  # 131,072 vertices, 4,194,304 edges
    assert (hg.n, hg.m) == (n_want, 32 * n_want), (hg.n, hg.m)
    (srcs, dsts, w, n), kw, t_native, built = builds[-1]
    assert built is hg, "from_edges did not take the native builder"
    t0 = time.perf_counter()
    ref = from_edges_numpy(srcs, dsts, w, n, kw["directed"])
    t_numpy = time.perf_counter() - t0
    for f in HOST_FIELDS:
        assert np.array_equal(getattr(ref, f), getattr(hg, f)), f
    log(f"# arxiv s{ARXIV['scale']}: n={hg.n} m={hg.m}, dataset {t_ds:.2f} s; host build "
        f"of its {hg.m} edges: native {t_native:.3f} s, NumPy "
        f"{t_numpy:.3f} s, bitwise equal ({len(builds)} native builds)")

    t0 = time.perf_counter()
    gs = GraphSlice.from_host(hg, device=device)
    norm = gcn_normalize(gs)
    torch.cuda.synchronize(device)
    log(f"# arxiv s{ARXIV['scale']}: device graph and GCN norm (banded layouts) "
        f"{time.perf_counter() - t0:.2f} s")
    with uncounted():
        hold_gcn_kernels(f"arxiv s{ARXIV['scale']}", gs, ARXIV_DIMS,
                         device)

    def padded(a, dtype):
        out = np.zeros((gs.n_pad,) + a.shape[1:], dtype)
        out[: hg.n] = a
        return torch.from_numpy(out).to(device)

    x = padded(ds.features, np.float32)
    labels = padded(ds.labels, np.int32)
    train, test = padded(ds.train_mask, bool), padded(ds.test_mask, bool)

    def step(p, o):
        return gcn_train_step(p, o, gs, norm, x, (labels, train), ARXIV_LR)

    def state_leaves(p, o):
        return [d[k] for d in p + o for k in sorted(d)]

    params = gcn_init(torch.Generator().manual_seed(0), ARXIV_DIMS,
                      device=device)
    opt = gcn_init_opt(params)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = gcn_forward(params, gs, norm, x).cpu().numpy()[: hg.n]
    want = gcn_forward_cpu([{k: v.cpu().numpy() for k, v in p.items()}
                            for p in params], hg, ds.features)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    with uncounted():  # the plain step, for step 1's loss and gradients
        _, grads_ref, loss_ref = gcn_train_step(
            params, opt, gs, norm, x, (labels, train), ARXIV_LR, impl="xla")
    log(f"# arxiv: GCN {ARXIV_DIMS} forward within rtol 1e-4, atol 1e-5 of "
        f"gcn_forward_cpu (max abs err {np.abs(out - want).max():.3g}); "
        f"{time.perf_counter() - t0:.2f} s with the xla step")
    losses = []
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(ARXIV_STEPS):
        if i == ARXIV_RESUME:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "gcn.npz")
                torch.cuda.synchronize(device)
                t1 = time.perf_counter()
                save_pytree(path, {"params": params, "opt": opt})
                t_save = time.perf_counter() - t1
                fresh = gcn_init(torch.Generator().manual_seed(1),
                                 ARXIV_DIMS, device=device)
                t1 = time.perf_counter()
                state = load_pytree(path, {"params": fresh,
                                           "opt": gcn_init_opt(fresh)})
                torch.cuda.synchronize(device)
                t_load = time.perf_counter() - t1
            p_res, o_res, l_res = step(state["params"], state["opt"])
            params, opt, loss = step(params, opt)
            same = all(torch.equal(a, b) for a, b in zip(
                state_leaves(p_res, o_res) + [l_res],
                state_leaves(params, opt) + [loss]))
            assert same, "the resumed step is not the live step bitwise"
            log(f"# arxiv: checkpoint after step {ARXIV_RESUME}: save "
                f"{t_save:.4f} s, load {t_load:.4f} s; step "
                f"{ARXIV_RESUME + 1} from the loaded state bitwise the live "
                f"one")
        else:
            params, opt, loss = step(params, opt)
        if i == 0:  # from zero momentum the new momentum is the gradient
            np.testing.assert_allclose(float(loss), float(loss_ref),
                                       rtol=1e-4)
            errs = [max_rel(gr[k], ref[k]) for gr, ref in zip(opt, grads_ref)
                    for k in ("w", "b")]
            assert max(errs) <= GRAD_TOL, errs
            log(f"# arxiv: step 1 loss {float(loss):.6f} (xla "
                f"{float(loss_ref):.6f}); grad max err/max|xla| "
                f"{max(errs):.3g} (bound {GRAD_TOL})")
        losses.append(loss)
    torch.cuda.synchronize(device)
    t_train = time.perf_counter() - t0
    losses = torch.stack(losses).tolist()
    with torch.no_grad():
        pred = gcn_forward(params, gs, norm, x).argmax(-1)
    acc = (pred[test] == labels[test]).float().mean().item()
    t = time_fn(lambda: step(params, opt), warmup=1, repeat=5, device=device)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert acc > 0.7, acc
    log(f"# arxiv: GCN {ARXIV_DIMS} {ARXIV_STEPS} steps lr {ARXIV_LR}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, test accuracy {acc:.4f}; "
        f"{t_train:.3f} s for the steps (checkpoint included), step "
        f"{t.min_s * 1e3:.3f} ms (min of 5, CUDA events)")

    hub = int(np.argmax(hg.out_degrees))
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            step(params, opt)
            # the band gathers' route since kernel 2 reads rows by id
            sddmm(gs, x, impl="banded")
            r = bfs(gs, hub)
            torch.cuda.synchronize(device)
        with open(os.path.join(d, "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    np.testing.assert_array_equal(r.labels.cpu().numpy()[: hg.n],
                                  bfs_cpu(hg, hub))
    for want in SCOPES + TRACED_KERNELS:
        assert any(nm.startswith(want) or want in nm for nm in names), want
    n_calls = 200_000
    t0 = time.perf_counter()
    for _ in range(n_calls):
        with scope("engine.src_to_csc"):
            pass
    t_scope = (time.perf_counter() - t0) / n_calls * 1e6
    t0 = time.perf_counter()
    for _ in range(n_calls):
        with scope_of("engine.segreduce_dst.{}", "min"):
            pass
    t_scope_of = (time.perf_counter() - t0) / n_calls * 1e6
    t0 = time.perf_counter()
    for _ in range(n_calls):
        pass
    t_loop = (time.perf_counter() - t0) / n_calls * 1e6
    # a BFS's scope uses, against its time a round
    uses, real_scopes = [0], (engine.scope, engine.scope_of)

    def counting(f):
        def counted(*a):
            uses[0] += 1
            return f(*a)
        return counted

    engine.scope, engine.scope_of = map(counting, real_scopes)
    try:
        bfs(gs, hub)
    finally:
        engine.scope, engine.scope_of = real_scopes
    t_bfs = time_fn(lambda: bfs(gs, hub), warmup=1, repeat=3, device=device)
    per_round = t_bfs.min_s * 1e6 / r.num_iterations
    log(f"# arxiv: trace of one step, an SDDMM and a BFS (hub {hub}, "
        f"{r.num_iterations} rounds, labels bitwise bfs_cpu) holds the "
        f"scopes {list(SCOPES)} "
        f"and the kernels {list(TRACED_KERNELS)}; with no profiler a scope "
        f"costs {t_scope:.3f} us of host a use, scope_of {t_scope_of:.3f} "
        f"us ({t_loop:.3f} us of each the bare loop); the BFS enters "
        f"{uses[0] / r.num_iterations:.2f} scopes a round, at "
        f"{per_round:.1f} us a round (min of 3)")
    log(f"# phase 19: arxiv passed in {time.perf_counter() - t_phase:.1f} s")


def hold_gcn_kernels(label, gs, dims, device):
    """The segment sum and the row gather on the GCN's layouts of ``gs``
    (pull for the forward, push for the backward; one layout serves every
    width up to 128) at each of ``dims[1:]``'s widths, float32: the sum,
    weighted as the GCN calls it, within SUM_TOL of its plain version, the
    gather bitwise."""
    import torch

    from mini_tpu_torch.graph.banded import layout_for
    from mini_tpu_torch.ops.kernels import gather_rows as kg

    rng = np.random.RandomState(0)
    worst = 0.0
    for direction in ("pull", "push"):
        layout = layout_for(gs, direction, 128)
        dev = layout.dev(device)
        for F in sorted(set(dims[1:])):
            msgs, w = band_messages(layout, dev, F, torch.float32, rng,
                                    device)
            err, limit = banded_sum_agrees(f"{label} {direction} F={F}",
                                           dev, msgs, device, weights=w)
            worst = max(worst, err / limit if limit else 0.0)
            del msgs, w
            x = torch.from_numpy(rng.randn(layout.n_pad, F).astype(
                np.float32)).to(device)
            for k in range(layout.K):
                band = x[k * layout.band_rows: (k + 1) * layout.band_rows]
                assert torch.equal(kg.gather_rows(band, dev["ids"][k]),
                                   kg.gather_rows_plain(band, dev["ids"][k])
                                   ), (label, direction, F, k)
    log(f"# {label}: weighted banded_segment_sum on the pull and push "
        f"layouts (K={layout.K}) at F={sorted(set(dims[1:]))} within "
        f"SUM_TOL of plain (worst {worst:.3g} of the bound), two launches "
        f"and the emulated schedule bitwise; gather_rows bitwise "
        f"index_select on every band")


def phase_entry(device):
    """``mini_tpu_torch.entry.entry()``'s ``fn(*args)`` on the card against
    the float64 oracle ``gcn_forward_cpu`` (rtol 1e-4, atol 1e-5), timed."""
    import torch

    from mini_tpu_torch.entry import entry
    from mini_tpu_torch.graph import erdos_renyi
    from mini_tpu_torch.models.gcn import gcn_forward_cpu
    from mini_tpu_torch.utils.timing import time_fn

    t0 = time.perf_counter()
    fn, args = entry()
    params, gs, _, x = args
    with torch.no_grad():
        out = fn(*args)
        t = time_fn(lambda: fn(*args), warmup=1, repeat=5, device=device)
    assert out.is_cuda and tuple(out.shape) == (gs.n_pad, F_OUT), out.shape
    hg = erdos_renyi(2048, 16384, seed=0, undirected=True)
    want = gcn_forward_cpu([{k: v.cpu().numpy() for k, v in p.items()}
                            for p in params], hg, x.cpu().numpy())
    np.testing.assert_allclose(out.cpu().numpy()[: hg.n], want, rtol=1e-4,
                               atol=1e-5)
    log(f"# phase 20: entry(): GCN {[p['w'].shape[0] for p in params]} -> "
        f"{F_OUT} on er2048 within rtol 1e-4, atol 1e-5 of gcn_forward_cpu; "
        f"fn {t.min_s * 1e3:.3f} ms (min of 5); "
        f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------ phase 21: parallel
PARALLEL_DIMS = {"gcn": [F_IN, F_HID, F_OUT], "sage": [F_IN, F_HID, F_OUT],
                 "gat": [F_IN, 32, 32]}
SHARD_WAYS = 8  # the shard shapes the kernels are held at (n_loc 8,200)


def parallel_rank(kind=None) -> dict:
    """One rank of phase 21 (one NCCL rank a card): every distributed call
    of ``mini_tpu_torch.parallel`` at full width on the rmat16 graph,
    held against the oracles and the single-device port on the same card,
    its launches counted (the checked call of each, not the references or
    the timing runs) and its time beside the single-device call's.  Rank 0
    returns its lines, times and launch counts.  ``kind="cpu"`` runs it on
    gloo ranks, to rehearse it on the CPU."""
    import torch
    import torch.distributed as dist

    from mini_tpu_torch.algorithms import (
        bfs, bfs_cpu, cc_cpu, coloring, connected_components, kcore,
        kcore_cpu_true, lspar, lspar_cpu, pagerank, sssp, sssp_cpu,
        validate_coloring,
    )
    from mini_tpu_torch.graph import GraphSlice, rmat
    from mini_tpu_torch.models.gat import gat_init, gat_train_step
    from mini_tpu_torch.models.gcn import gcn_init, gcn_train_step, \
        gcn_normalize
    from mini_tpu_torch.models.sage import sage_init, sage_train_step
    from mini_tpu_torch.ops.spmm import spmm
    from mini_tpu_torch.parallel import (
        build_halo_plan, dist_bfs, dist_gat_train, dist_lspar,
        dist_sage_train, dist_sssp, make_dist_bfs, make_dist_spmm,
        make_halo_spmm, make_mesh, partition_graph, shard_to_mesh,
    )
    from mini_tpu_torch.parallel.distributed import (
        all_gather, dist_cc, dist_coloring, dist_kcore, dist_pagerank,
        mesh_device,
    )
    from mini_tpu_torch.parallel.gcn import (
        dist_gcn_train_step_fn, gcn_norm_arrays,
    )
    from mini_tpu_torch.parallel.tp import (
        gather_gcn_params_2d, gcn_train_step_2d, make_mesh_2d,
        shard_gcn_params_2d,
    )
    from mini_tpu_torch.utils.timing import time_fn

    assert dist.get_backend() == ("gloo" if kind == "cpu" else "nccl")
    D = dist.get_world_size()
    hg = rmat(SCALE, edge_factor=16, seed=0, undirected=True, weighted=True)
    mesh = make_mesh(D, device=kind)
    device = mesh_device(mesh)
    pg = partition_graph(hg, D)
    shards = shard_to_mesh(pg, mesh)
    plan = build_halo_plan(pg)
    gs = GraphSlice.from_host(hg, device=device)
    hub = int(np.argmax(hg.out_degrees))
    s, n = shards.shard, hg.n
    lines, times = [], []
    total = {name: 0 for name in counters()}

    def counted(fn, into=None):
        """``fn()``, its launches added to this path's counts (and to
        ``into``)."""
        before = {k: getattr(m, a) for k, (m, a) in counters().items()}
        out = fn()
        for k, (m, a) in counters().items():
            total[k] += getattr(m, a) - before[k]
            if into is not None:
                into[k] = getattr(m, a) - before[k]
        return out

    def full(t):  # every rank's block, in shard order, on the host
        return all_gather(t.contiguous(), None).cpu().numpy()

    def timing(name, dist_fn, single_fn):  # min of 3 after 1, CUDA events
        times.append((name,) + tuple(
            time_fn(f, warmup=1, repeat=3, device=device).min_s * 1e3
            for f in (dist_fn, single_fn)))

    plans = (("all-gather", None), ("halo", plan))
    # traversals, against the oracles and the single-device port
    for label, pl in plans:
        labels, preds = counted(lambda: dist_bfs(pg, shards, hub, mesh,
                                                 plan=pl))
        labels, preds = full(labels)[:n], full(preds)[:n]
        np.testing.assert_array_equal(labels, bfs_cpu(hg, hub))
        np.testing.assert_array_equal(preds, host_min_parent(hg, labels))
    lines.append(f"dist_bfs from the hub {hub} (all-gather and halo): labels "
                 f"bitwise bfs_cpu, preds the min-id parent")
    want_d = sssp_cpu(hg, hub)[0]
    for label, pl in plans:
        got = full(counted(lambda: dist_sssp(pg, shards, hub, mesh,
                                             plan=pl)))[:n]
        np.testing.assert_array_equal(got, want_d)
    want_cc = cc_cpu(hg)
    for label, pl in plans:
        got, _ = counted(lambda: dist_cc(pg, shards, mesh, plan=pl))
        np.testing.assert_array_equal(full(got)[:n], want_cc)
    want_k = kcore_cpu_true(hg)[0]
    for label, pl in plans:
        got, it = counted(lambda: dist_kcore(pg, shards, mesh, plan=pl))
        np.testing.assert_array_equal(full(got)[:n], want_k)
    single_col = coloring(gs, seed=0)
    for label, pl in plans:
        got, it = counted(lambda: dist_coloring(pg, shards, mesh, seed=0,
                                                plan=pl))
        got = full(got)
        np.testing.assert_array_equal(got[:n],
                                      single_col.colors.cpu().numpy()[:n])
        assert validate_coloring(got, hg) and it == single_col.num_iterations
    rng = np.random.RandomState(0)
    a_, b_ = rng.randint(1, 999983), rng.randint(0, 999983)
    hashs = ((b_ + a_ * np.arange(pg.n_pad, dtype=np.int64)) % 999983
             ).astype(np.int32)
    (_, want_cnt) = lspar_cpu(hg, hashs, 0.5)
    for label, pl in plans:
        _, _, cnt = counted(lambda: dist_lspar(pg, shards, mesh, plan=pl))
        assert cnt == want_cnt, (cnt, want_cnt)
    single_pr = pagerank(gs, variant="standard").ranks.cpu().numpy()[:n]
    for label, pl in plans:
        got, it = counted(lambda: dist_pagerank(pg, shards, mesh, plan=pl))
        np.testing.assert_allclose(full(got)[:n], single_pr, rtol=1e-3,
                                   atol=1e-7)
    lines.append("dist_sssp bitwise sssp_cpu, dist_cc cc_cpu, dist_kcore "
                 "kcore_cpu_true, dist_coloring the single-device coloring "
                 "(the same salts, proper, the same rounds), dist_lspar's "
                 f"count lspar_cpu's ({want_cnt}), dist_pagerank within "
                 "rtol 1e-3 of pagerank; each all-gather and halo")

    # SpMM at F=128 against spmm(impl="xla")
    x = torch.from_numpy(np.random.RandomState(1).rand(
        pg.n_pad, F_IN).astype(np.float32)).to(device)
    xs = x.view(D, pg.n_loc, F_IN)[s: s + 1]
    x_gs = torch.zeros(gs.n_pad, F_IN, device=device)
    x_gs[:n] = x[:n]
    want = spmm(gs, x_gs, impl="xla").cpu().numpy()[:n]
    calls = {"dist_spmm": make_dist_spmm(pg, mesh),
             "halo_spmm": make_halo_spmm(pg, plan, mesh),
             "halo_spmm overlap": make_halo_spmm(pg, plan, mesh,
                                                 overlap=True)}
    for name, call in calls.items():
        with torch.no_grad():
            got = counted(lambda: call(shards, xs))
        np.testing.assert_allclose(full(got).reshape(pg.n_pad, F_IN)[:n],
                                   want, rtol=1e-5, atol=1e-6)
    lines.append("dist_spmm and halo_spmm (overlap off and on) at F=128 "
                 "within rtol 1e-5, atol 1e-6 of spmm(impl='xla')")

    # training: step 1's loss and gradients against the single device
    labels = torch.from_numpy(np.random.RandomState(2).randint(
        0, N_CLASSES, pg.n_pad).astype(np.int32)).to(device)
    mask = torch.arange(pg.n_pad, device=device) < n
    lab1 = labels.view(D, -1)[s: s + 1]
    msk1 = mask.view(D, -1)[s: s + 1]
    lab_gs = torch.zeros(gs.n_pad, dtype=torch.int32, device=device)
    lab_gs[:n] = labels[:n]
    msk_gs = torch.arange(gs.n_pad, device=device) < n
    norm = gcn_normalize(gs)
    inv_sqrt, self_c = gcn_norm_arrays(pg, device=device)
    self_c = self_c[s: s + 1]
    init = {"gcn": gcn_init, "sage": sage_init,
            "gat": lambda gen, d, device: gat_init(gen, d, heads=2,
                                                   device=device)}
    single_step = {
        "gcn": lambda p, o: gcn_train_step(p, o, gs, norm, x_gs,
                                           (lab_gs, msk_gs), 1.0),
        "sage": lambda p, o: sage_train_step(p, o, gs, x_gs,
                                             (lab_gs, msk_gs), 1.0),
        "gat": lambda p, o: gat_train_step(p, o, gs, x_gs,
                                           (lab_gs, msk_gs), 1.0),
    }
    gcn_step = dist_gcn_train_step_fn(pg, mesh, lr=1.0)
    # SAGE's and GAT's step returns params only: from zero momentum the
    # step is p - lr g, and a large lr keeps g's float32 digits in p0 - p1
    lr = 1e4
    dist_train = {
        "sage": lambda p: dist_sage_train(pg, shards, mesh, p, xs, lab1,
                                          msk1, steps=1, lr=lr),
        "gat": lambda p: dist_gat_train(pg, shards, mesh, p, xs, lab1,
                                        msk1, steps=1, lr=lr),
    }
    for model, dims in PARALLEL_DIMS.items():
        p0 = init[model](torch.Generator().manual_seed(3), dims,
                         device=device)
        zeros = [{k: torch.zeros_like(v) for k, v in p.items()} for p in p0]
        _, ref_grads, ref_loss = single_step[model](p0, zeros)
        if model == "gcn":
            _, grads, loss = counted(lambda: gcn_step(
                shards, p0, zeros, xs, lab1, msk1, inv_sqrt, self_c))
            loss = float(loss)
        else:
            p1, losses = counted(lambda: dist_train[model](p0))
            loss = losses[0]
            grads = [{k: (p[k] - q[k]) / lr for k in p}
                     for p, q in zip(p0, p1)]
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-4)
        err = grads_close(grads, ref_grads, GRAD_TOL)
        lines.append(f"dist_{model}_train {dims}: step 1 loss {loss:.6f} "
                     f"(single device {float(ref_loss):.6f}), gradients "
                     f"within GRAD_TOL x max|ref| + 1e-7 (largest error "
                     f"over max|ref| {err:.3g})")
        # a step, its edge sums and their transposes already built (the
        # shards keep them from the checked call)
        timing(f"dist_{model}_train step", (lambda: gcn_step(
            shards, p0, zeros, xs, lab1, msk1, inv_sqrt, self_c)) if model
            == "gcn" else (lambda: dist_train[model](p0)),
            lambda: single_step[model](p0, zeros))

    # the GCN step over the 2-D (graph, feat) mesh (JAX's dry-run part 2):
    # 1 x 1 at one card, 2 x 2 at four, on the 1-D step's inputs
    mesh2d = make_mesh_2d(D, device=kind)
    gp, fp = mesh2d.size(0), mesh2d.size(1)
    pg2 = pg if gp == D else partition_graph(hg, gp)
    shards2d = shard_to_mesh(pg2, mesh2d, axis="graph")

    def rows2d(a):  # this rank's [1, n_loc, ...] rows of the first n
        out = a.new_zeros((pg2.n_pad,) + tuple(a.shape[1:]))
        out[:n] = a[:n]
        return out.view((gp, pg2.n_loc) + tuple(a.shape[1:]))[
            shards2d.shard: shards2d.shard + 1]

    x2, batch2 = rows2d(x), (rows2d(labels), rows2d(mask))
    dims = PARALLEL_DIMS["gcn"]
    p0 = gcn_init(torch.Generator().manual_seed(3), dims, device=device)
    zeros = [{k: torch.zeros_like(v) for k, v in p.items()} for p in p0]
    ref_p, ref_m, ref_loss = single_step["gcn"](p0, zeros)
    blocks = shard_gcn_params_2d(p0, mesh2d)
    zero_blocks = shard_gcn_params_2d(zeros, mesh2d)

    def step2d():
        return gcn_train_step_2d(blocks, zero_blocks, pg2, shards2d, x2,
                                 batch2, 1.0, mesh=mesh2d)

    tp_launches = {}
    p1, m1, loss = counted(step2d, tp_launches)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    err_m = grads_close(gather_gcn_params_2d(m1, mesh2d), ref_m, GRAD_TOL)
    err_p = grads_close(gather_gcn_params_2d(p1, mesh2d), ref_p, GRAD_TOL)
    lines.append(f"gcn_train_step_2d {dims} on a {gp} x {fp} (graph, feat) "
                 f"mesh (column blocks {[d // fp for d in dims[1:]]}): step "
                 f"1 loss {float(loss):.6f} (single device "
                 f"{float(ref_loss):.6f}), momentum and params within "
                 f"GRAD_TOL x max|ref| + 1e-7 (largest error over max|ref| "
                 f"{err_m:.3g}, {err_p:.3g})")
    timing(f"gcn_train_step_2d ({gp}x{fp} mesh)", step2d,
           lambda: single_step["gcn"](p0, zeros))

    # times: each distributed call beside the single-device call
    bfs_call = make_dist_bfs(pg, mesh)
    bfs_plan = make_dist_bfs(pg, mesh, plan=plan)
    timing("dist_bfs (all-gather)", lambda: bfs_call(shards, hub),
           lambda: bfs(gs, hub))
    timing("dist_bfs (halo)", lambda: bfs_plan(shards, hub),
           lambda: bfs(gs, hub))
    timing("dist_sssp", lambda: dist_sssp(pg, shards, hub, mesh),
           lambda: sssp(gs, hub, variant="bellman"))
    timing("dist_pagerank", lambda: dist_pagerank(pg, shards, mesh),
           lambda: pagerank(gs, variant="standard"))
    timing("dist_cc", lambda: dist_cc(pg, shards, mesh),
           lambda: connected_components(gs))
    timing("dist_kcore", lambda: dist_kcore(pg, shards, mesh),
           lambda: kcore(gs, variant="hindex"))
    timing("dist_coloring", lambda: dist_coloring(pg, shards, mesh),
           lambda: coloring(gs))
    timing("dist_lspar", lambda: dist_lspar(pg, shards, mesh),
           lambda: lspar(gs))
    with torch.no_grad():
        for name, call in calls.items():
            timing(name, lambda: call(shards, xs), lambda: spmm(gs, x_gs))
    return {"lines": lines, "times": times, "launches": total, "world": D,
            "tp_launches": tp_launches}


def check_shard_kernels(hg, device):
    """Kernel 3, the segment sum and the row gather against their plain
    versions at the shapes of one shard of an 8-way partition of ``hg``
    (its largest), as ``parallel`` gives them: kernel 3 over the shard's
    ``col_offsets`` (int32 min, max, sum and bor, float32 min and sum, the
    pad edges holding the identity), the segment sum over the offsets
    padded to the row tile and the row gather of ``[n_pad, F]`` rows by
    the edges' sources at F=128 and at the 2-D step's column blocks with
    ``feat`` 2 (F=64, 16), and the row gather of 4-byte rows (a
    frontier)."""
    import torch

    from mini_tpu_torch.ops.kernels import gather_rows as kg
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.ops.kernels import spmm_kernel as k4
    from mini_tpu_torch.parallel import build_halo_plan, partition_graph
    from mini_tpu_torch.parallel.distributed import EdgeSum
    from mini_tpu_torch.ops.segment import identity_for

    pg = partition_graph(hg, SHARD_WAYS)
    s = int(np.argmax(pg.col_offsets[:, -1]))
    m = int(pg.col_offsets[s, -1])
    rng = np.random.RandomState(0)
    off = torch.from_numpy(pg.col_offsets[s]).to(device)
    dst = torch.from_numpy(pg.csc_dsts_local[s]).to(device)
    real = torch.from_numpy(pg.edge_mask[s]).to(device)
    for dtype, ops in ((torch.int32, ("min", "max", "sum", "bor")),
                       (torch.float32, ("min", "sum"))):
        raw = torch.from_numpy(rng.randint(-2**20, 2**20, pg.m_loc)).to(
            device).to(dtype)
        for op in ops:
            ident = identity_for("sum" if op == "bor" else op, dtype)
            vals = torch.where(real, raw, ident)
            got = k1.segment_reduce(off, dst, vals, op)
            want = k1.segment_reduce_plain(off, dst, vals, op)
            if dtype == torch.int32 or op == "min":
                assert torch.equal(got, want), (dtype, op)
            else:
                err = float((got - want).abs().max())
                assert err <= SUM_TOL * float(want.abs().max()), err
    es = EdgeSum(pg.csc_srcs[s, :m], pg.csc_dsts_local[s, :m], pg.n_loc,
                 pg.n_pad, device)
    table = torch.from_numpy(rng.randn(pg.n_pad, F_IN).astype(
        np.float32)).to(device)
    vec = torch.from_numpy(rng.randint(0, 2, (pg.n_pad, 1)).astype(
        np.int32)).to(device)
    assert torch.equal(kg.gather_rows(vec, es.idx),
                       kg.gather_rows_plain(vec, es.idx))
    w = torch.zeros(es.idx.shape[0], device=device)
    w[:m] = torch.from_numpy(pg.csc_weights[s, :m]).to(device)
    errs = {}
    for F in (F_IN, F_HID // 2, F_OUT // 2):  # 1-D, then the 2-D step's
        # column blocks at feat_par 2 (64- and 16-column tables)
        tab = table if F == F_IN else torch.from_numpy(rng.randn(
            pg.n_pad, F).astype(np.float32)).to(device)
        rows = kg.gather_rows(tab, es.idx)
        assert torch.equal(rows, kg.gather_rows_plain(tab, es.idx)), F
        msgs = rows * w[:, None]
        got = k4.segment_sum(es.offsets, None, msgs)
        want = k4.segment_sum_plain(es.offsets, None, msgs)
        errs[F] = float((got - want).abs().max())
        assert errs[F] <= SUM_TOL * float(want.abs().max()), (F, errs[F])
    for ways in (4, SHARD_WAYS):  # what a rank's halo moves (host counts)
        pw = partition_graph(hg, ways)
        plan = build_halo_plan(pw)
        halo_edges = int(plan.halo_mask.sum())
        log(f"# phase 21: halo plan at D={ways}: H={plan.halo_width}, a "
            f"rank receives {ways * plan.halo_width} slab rows against the "
            f"all-gather's {pw.n_pad}; {halo_edges} of {hg.m} edges "
            f"({halo_edges / hg.m:.0%}) read a halo row")
    log(f"# phase 21: the {SHARD_WAYS}-way shard {s} (n_loc {pg.n_loc}, "
        f"{m} edges, rows padded to {es.offsets.shape[0] - 1}): kernel 3 "
        f"bitwise (int32 min/max/sum/bor, f32 min) and within SUM_TOL (f32 "
        f"sum); segment_sum within SUM_TOL at F={F_IN} and the 2-D step's "
        f"column blocks F={F_HID // 2}, {F_OUT // 2} (errs "
        f"{', '.join(f'{v:.3g}' for v in errs.values())}); gather_rows "
        f"bitwise at {F_IN * 4}-, {F_HID * 2}-, {F_OUT * 2}- and 4-byte "
        f"rows")


def phase_parallel(hg, device):
    """Phase 21: ``mini_tpu_torch.parallel`` over NCCL, one rank a card
    (:func:`parallel_rank`), its launches added to this process's counts;
    the kernels at 8-way shard shapes of ``hg`` (not counted); the dry
    run."""
    import torch

    from mini_tpu_torch.entry import dryrun_multichip
    from mini_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    res = run_ranks(parallel_rank, world, timeout_s=900)
    for name, (mod, attr) in counters().items():
        setattr(mod, attr, getattr(mod, attr) + res["launches"][name])
    for line in res["lines"]:
        log(f"# parallel ({world} NCCL rank{'s' if world > 1 else ''}): "
            f"{line}")
    for name, dm, sm in res["times"]:
        log(f"# parallel time {name}: {dm:.3f} ms, single device {sm:.3f} "
            f"ms, ratio {dm / sm:.2f} (min of 3, CUDA events)")
    log(f"# launches on parallel gcn_train_step_2d (rank 0): "
        f"{json.dumps(res['tp_launches'])}")
    for name in ("segment_sum", "gather_rows"):
        assert res["tp_launches"][name] > 0, f"the 2-D step ran no {name}"
    t1 = time.perf_counter()
    with uncounted():
        check_shard_kernels(hg, device)
    dryrun_multichip(world)
    log(f"# phase 21: parallel path {t1 - t0:.1f} s, dryrun_multichip("
        f"{world}) passed; {time.perf_counter() - t0:.1f} s")


def tp_profile_rank(kind=None) -> list:
    """The GCN step [128, 128, 32] on phase 21's rmat16 inputs, one NCCL
    rank a card: the 1-D ``dist_gcn_train`` step, then the 2-D step on the
    D x 1, the default (``feat`` 2 when D is even) and the 1 x D meshes,
    each timed (min of 5 after 1, CUDA events) and profiled
    (:func:`profile_step`, collectives apart: an NCCL kernel's time holds
    its wait for the other ranks).  Rank 0 returns its log lines.
    ``kind="cpu"`` runs it on gloo ranks, to rehearse it on the CPU."""
    import torch
    import torch.distributed as dist

    from mini_tpu_torch.graph import rmat
    from mini_tpu_torch.models.gcn import gcn_init
    from mini_tpu_torch.parallel import make_mesh, partition_graph, \
        shard_to_mesh
    from mini_tpu_torch.parallel.distributed import make_mesh_2level, \
        mesh_device
    from mini_tpu_torch.parallel.gcn import dist_gcn_train_step_fn, \
        gcn_norm_arrays
    from mini_tpu_torch.parallel.tp import AXES, feat_par_for, \
        gcn_train_step_2d, shard_gcn_params_2d
    from mini_tpu_torch.utils.timing import time_fn

    D = dist.get_world_size()
    hg = rmat(SCALE, edge_factor=16, seed=0, undirected=True, weighted=True)
    mesh = make_mesh(D, device=kind)
    device = mesh_device(mesh)
    n = hg.n
    x = torch.from_numpy(np.random.RandomState(1).rand(n, F_IN).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(np.random.RandomState(2).randint(
        0, N_CLASSES, n).astype(np.int32)).to(device)
    p0 = gcn_init(torch.Generator().manual_seed(3), PARALLEL_DIMS["gcn"],
                  device=device)
    zeros = [{k: torch.zeros_like(v) for k, v in p.items()} for p in p0]
    pgs = {}

    def blocks(pg, shard):  # a shard's rows of x, labels and the mask
        def rows(a):
            out = a.new_zeros((pg.n_pad,) + tuple(a.shape[1:]))
            out[:n] = a
            return out.view((pg.num_shards, pg.n_loc) + tuple(
                a.shape[1:]))[shard: shard + 1]
        return rows(x), rows(labels), rows(torch.ones_like(labels,
                                                           dtype=torch.bool))

    pg = pgs[D] = partition_graph(hg, D)
    shards = shard_to_mesh(pg, mesh)
    inv_sqrt, self_c = gcn_norm_arrays(pg, device=device)
    one_d = dist_gcn_train_step_fn(pg, mesh, lr=1.0)
    xs, lab, msk = blocks(pg, shards.shard)
    steps = {"dist_gcn_train (1-D)": lambda: one_d(
        shards, p0, zeros, xs, lab, msk, inv_sqrt,
        self_c[shards.shard: shards.shard + 1])}
    fp = feat_par_for(D)
    for gp, fp in dict.fromkeys([(D, 1), (D // fp, fp), (1, D)]):
        if any(d % fp for d in PARALLEL_DIMS["gcn"][1:]):
            continue  # the columns do not split into fp blocks
        m2 = make_mesh_2level(gp, fp, axes=AXES, device=kind)
        pg2 = pgs.setdefault(gp, pg if gp == D else partition_graph(hg, gp))
        sh2 = shard_to_mesh(pg2, m2, axis="graph")
        x2, lab2, msk2 = blocks(pg2, sh2.shard)
        steps[f"gcn_train_step_2d ({gp}x{fp})"] = functools.partial(
            gcn_train_step_2d, shard_gcn_params_2d(p0, m2),
            shard_gcn_params_2d(zeros, m2), pg2, sh2, x2, (lab2, msk2), 1.0,
            mesh=m2)
    parts = PROFILE_PARTS + (("collectives (NCCL, waits included)",
                              ("nccl",)),)
    lines = []
    for name, step in steps.items():
        ms = time_fn(step, warmup=1, repeat=5, device=device).min_s * 1e3
        text = profile_step(step, device, parts=parts)
        lines.append(f"{name} at {D} rank(s): {ms:.3f} ms (min of 5, CUDA "
                     f"events); rank 0 " + (text or "no device events"))
    return lines


# kernel -> (wrapper module, its launch counter, source, the TPU kernel)
KERNELS = {
    "segment_reduce": ("segreduce_kernel", "launches",
                       "mini_tpu_torch/csrc/segreduce.cu",
                       "mini_tpu/ops/pallas/segreduce_kernel.py:155"),
    "banded_segment_sum": ("spmm_banded", "launches",
                           "mini_tpu_torch/csrc/spmm_banded.cu",
                           "mini_tpu/ops/pallas/spmm_banded.py:65"),
    "banded_sddmm": ("spmm_banded", "sddmm_launches",
                     "mini_tpu_torch/csrc/spmm_banded.cu",
                     "mini_tpu/ops/pallas/spmm_banded.py:279"),
    "segment_sum": ("spmm_kernel", "launches",
                    "mini_tpu_torch/csrc/spmm_banded.cu",
                    "mini_tpu/ops/pallas/spmm_kernel.py:113"),
    "gather_rows": ("gather_rows", "launches",
                    "mini_tpu_torch/csrc/gather_rows.cu",
                    "scratch/probe_dma_gather.py:66,123; "
                    "scratch/probe_dma_bisect.py:100; "
                    "scratch/probe_hbm_and_gather.py:55"),
    "apply_fixed_perm": ("permute_kernel", "launches",
                         "mini_tpu_torch/csrc/permute.cu",
                         "scratch/probe_butterfly.py:74"),
}


def counters() -> dict:
    """kernel -> (its wrapper module, the name of its launch counter), and
    ``banded_segment_sum.weighted``, ``.indexed``, ``.wide`` and
    ``.scanned``, kernel 2's launches that scaled by weights, that read rows
    of a table by ids, whose layout had more than 128 bands and whose
    walker scanned a row's bands a window at a time."""
    import importlib

    refs = {name: (m, attr) for name, (m, attr, _, _) in KERNELS.items()}
    refs["banded_segment_sum.weighted"] = ("spmm_banded", "weighted_launches")
    refs["banded_segment_sum.indexed"] = ("spmm_banded", "indexed_launches")
    refs["banded_segment_sum.wide"] = ("spmm_banded", "wide_launches")
    refs["banded_segment_sum.scanned"] = ("spmm_banded", "scanned_launches")
    return {name: (importlib.import_module(f"mini_tpu_torch.ops.kernels.{m}"),
                   attr) for name, (m, attr) in refs.items()}


def drive(path: str, fn, *args) -> dict:
    """Run one main path with every launch counter set to 0 just before
    it; return the counts read just after."""
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    fn(*args)
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters().items()}
    log(f"# launches on {path}: {json.dumps(counts)}")
    return counts


@contextlib.contextmanager
def uncounted():
    """The launches of a comparison inside a driven path: every launch
    counter is put back as it was before the block."""
    saved = {name: getattr(mod, attr)
             for name, (mod, attr) in counters().items()}
    try:
        yield
    finally:
        for name, (mod, attr) in counters().items():
            setattr(mod, attr, saved[name])


def main(argv) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mini_tpu_torch.graph import GraphSlice, erdos_renyi, rmat

    started = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    phase_build()
    t0 = time.perf_counter()
    hg = rmat(SCALE, edge_factor=16, seed=0, undirected=True, weighted=True)
    g = GraphSlice.from_host(hg, device=device)
    log(f"# rmat{SCALE}: n={hg.n} m={hg.m} n_pad={g.n_pad} m_pad={g.m_pad} "
        f"(host build {time.perf_counter() - t0:.2f} s)")
    if argv == ["--profile"]:  # the GAT step's profile alone, no result
        profile_gat(g, device)
        return
    if argv == ["--parallel"]:  # phase 21 alone, no result
        drive("parallel", phase_parallel, hg, device)
        return
    if argv == ["--bipartite"]:  # kernel 2 on rectangular layouts alone
        print(json.dumps({"kernel2_mag_shapes":
                          bipartite_at_mag_shapes(device)}), flush=True)
        return
    if argv[:1] == ["--wide"]:  # kernel 2's band limits alone
        narrow_bands_unchanged(device, argv[1] if len(argv) > 1 else None)
        print(json.dumps({"kernel2_products_shape":
                          wide_bands_at_products_shape(device)}), flush=True)
        return
    if argv == ["--tp-profile"]:  # the GCN steps' profiles, no result
        from mini_tpu_torch.parallel.launch import run_ranks

        for line in run_ranks(tp_profile_rank, torch.cuda.device_count(),
                              timeout_s=900):
            log(f"# tp profile {line}")
        return
    t0 = time.perf_counter()
    hg_big = rmat(MEMORY_SCALE, edge_factor=16, seed=0, undirected=True,
                  weighted=True)
    log(f"# rmat{MEMORY_SCALE}: n={hg_big.n} m={hg_big.m} (host graph "
        f"{time.perf_counter() - t0:.2f} s)")
    stats = phase_kernels(g, hg_big, device)
    bipartite_at_mag_shapes(device)
    if argv == ["--kernels"]:  # phases 1 and 2 alone, no result
        return

    hg_er = erdos_renyi(2048, 16384, seed=0, undirected=True)

    def gcn_forward_path():
        phase_gcn("er2048", hg_er,
                  GraphSlice.from_host(hg_er, device=device), device)
        phase_gcn(f"rmat{SCALE}", hg, g, device)

    paths = [
        drive("bfs", phase_bfs, hg, g, device),
        drive("gcn_forward", gcn_forward_path),
        drive("gcn_train", phase_train, g, device),
        drive("spmm_grad_sddmm", phase_grad, g, device),
        drive("gat", phase_gat, hg, g, hg_big, device),
    ]
    del hg_big
    torch.cuda.empty_cache()
    paths += [
        drive("sage", phase_sage, g, device),
        drive("bfs_batch", phase_bfs_batch, hg, g, device),
        drive("sssp", phase_sssp, hg, g, device),
        drive("sssp_batch", phase_sssp_batch, hg, g, device),
    ]
    grid = grid_graph(device)
    paths += [
        drive("sssp_grid", phase_sssp_grid, *grid, device),
        drive("bfs_grid", phase_bfs_grid, *grid, device),
        drive("pagerank", phase_pagerank, hg, g, device),
        drive("cc", phase_cc, hg, g, device),
        drive("kcore", phase_kcore, hg, g, device),
        drive("coloring", phase_coloring, hg, g, device),
        drive("lspar", phase_lspar, hg, g, device),
    ]
    del grid
    paths += phase_cli(int(np.argmax(hg.out_degrees)))
    paths += [
        drive("arxiv", phase_arxiv, device),
        drive("entry", phase_entry, device),
        drive("parallel", phase_parallel, hg, device),
    ]
    launches = {name: sum(p[name] for p in paths) for name in KERNELS}
    for name, count in launches.items():
        assert count > 0, f"{name} was not launched on the main path"
    wide = sum(p["banded_segment_sum.wide"] for p in paths)
    assert wide > 0, "kernel 2 took no layout past 128 bands on the main path"
    stats["banded_segment_sum"]["wide_launches"] = wide

    log(f"# chip_smoke: every phase passed in "
        f"{time.perf_counter() - started:.1f} s, the build included")
    kernels = [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches[name], **stats[name])
        for name, (_, _, source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
