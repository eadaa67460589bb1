#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mini_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases; any failure ends with a traceback and a non-zero exit:

1. device and build: the card's name and power limit (nvidia-smi), then
   the CUDA kernels built from ``mini_tpu_torch/csrc/``;
2. each kernel against its plain torch version on the card, at the main
   path's shapes (RMAT scale 16), with the times of both;
3. BFS from the max-degree hub of ``rmat(16, 16, seed=0, undirected,
   weighted)`` and from 3 more reached sources: labels bitwise equal to
   ``bfs_cpu``, preds the host's min-id parent; time and MTEPS;
4. the 2-layer GCN forward [128, 128, 32], float32 and bf16 messages, on
   ``erdos_renyi(2048, 16384)`` and the RMAT graph, against the float64
   oracle ``gcn_forward_cpu``;
5. one JSON line of the kernels (launch counts of phases 3-4, errors of
   phase 2, times), then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

With no CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SCALE = 16
F_IN, F_HID, F_OUT = 128, 128, 32
# kernel vs plain float sums: the same terms summed in another order
SUM_TOL = 1e-5  # max abs error <= SUM_TOL * max|plain|


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, device, warmup: int = 2, samples: int = 7) -> float:
    """Median of ``samples`` CUDA-event timings of one ``fn()`` call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_build():
    from mini_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    for name in ("segreduce", "spmm_banded"):
        path = _build.build(name)
        log(f"# built {os.path.relpath(path)} in "
            f"{_build.last_build_seconds[name]:.2f} s")
    log(f"# phase 1: kernels built in {time.perf_counter() - t0:.2f} s")
    return card


def phase_kernels(g, device):
    """Kernel 1 on the graph's CSC offsets, kernel 2 on its pull layout."""
    import torch

    from mini_tpu_torch.graph.banded import get_layout
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

    rng = np.random.RandomState(0)
    m_pad = g.m_pad
    stats = {}

    err1, t1 = 0.0, None
    ivals = torch.from_numpy(
        rng.randint(-2**31, 2**31 - 1, m_pad, dtype=np.int64)
        .astype(np.int32)).to(device)
    fvals = torch.from_numpy(
        (rng.rand(m_pad) * 100 - 50).astype(np.float32)).to(device)
    cases = [(op, ivals) for op in ("min", "max", "bor", "sum")] + [
        (op, fvals) for op in ("min", "max", "sum")]
    for op, vals in cases:
        args = (g.col_offsets, g.csc_dsts, vals, op)
        got = k1.segment_reduce(*args)
        want = k1.segment_reduce_plain(*args)
        torch.cuda.synchronize(device)
        if vals.dtype == torch.float32 and op == "sum":
            err = float((got - want).abs().max())
            bound = SUM_TOL * float(want.abs().max())
            assert err <= bound, (op, err, bound)
        else:
            assert torch.equal(got, want), (op, vals.dtype)
            err = 0.0
        err1 = max(err1, err)
        ms = cuda_ms(lambda: k1.segment_reduce(*args), device)
        plain_ms = cuda_ms(lambda: k1.segment_reduce_plain(*args), device)
        log(f"# segment_reduce {op} {str(vals.dtype)[6:]}: err {err:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if op == "max" and vals.dtype == torch.int32:
            t1 = (ms, plain_ms)  # the BFS advance's or-reduce
    stats["segment_reduce"] = dict(max_abs_err=err1, ms=t1[0],
                                   plain_ms=t1[1])

    layout = get_layout(g, "pull", row_bytes=F_HID * 4)
    dev = layout.dev(device)
    err2, t2 = 0.0, None
    for F in (F_HID, F_OUT):
        x32 = torch.from_numpy(
            rng.rand(g.n_pad, F).astype(np.float32) - 0.5).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            msgs = []
            for k in range(layout.K):
                lo = k * layout.band_rows
                hi = min(lo + layout.band_rows, layout.n_pad)
                xg = torch.index_select(x[lo:hi], 0, dev["ids"][k])
                msgs.append(xg * dev["weights"][k][:, None].to(dtype))
            args = (dev["bounds"], dev["offs2d"], msgs)
            got = k2.banded_segment_sum(*args)
            want = k2.banded_segment_sum_plain(*args)
            torch.cuda.synchronize(device)
            err = float((got - want).abs().max())
            bound = SUM_TOL * float(want.abs().max())
            assert err <= bound, (F, dtype, err, bound)
            err2 = max(err2, err)
            ms = cuda_ms(lambda: k2.banded_segment_sum(*args), device)
            plain_ms = cuda_ms(
                lambda: k2.banded_segment_sum_plain(*args), device)
            log(f"# banded_segment_sum F={F} {str(dtype)[6:]} K={layout.K}: "
                f"err {err:.3g} (bound {bound:.3g}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms")
            if F == F_HID and dtype == torch.float32:
                t2 = (ms, plain_ms)
    stats["banded_segment_sum"] = dict(max_abs_err=err2, ms=t2[0],
                                       plain_ms=t2[1])
    log("# phase 2: kernels match their plain versions")
    return stats


def host_min_parent(hg, labels):
    """pred[v] = min{u : (u,v) in E, labels[u] == labels[v] - 1}."""
    u, v = hg.csr_srcs, hg.csr_dsts
    cand = (labels[v] > 0) & (labels[u] == labels[v] - 1)
    big = np.iinfo(np.int32).max
    pred = np.full(hg.n, big, np.int64)
    np.minimum.at(pred, v[cand], u[cand])
    return np.where((labels > 0) & (pred != big), pred, -1).astype(np.int32)


def phase_bfs(hg, g, device):
    from mini_tpu_torch.algorithms import bfs, bfs_cpu, validate_preds
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.utils.timing import time_fn

    hub = int(np.argmax(hg.out_degrees))
    res = bfs(g, hub)
    labels_hub = res.labels.cpu().numpy()[: hg.n]
    reached = np.nonzero(labels_hub >= 0)[0]
    others = np.random.RandomState(0).choice(reached, 3, replace=False)
    for src in [hub] + [int(s) for s in others]:
        r = bfs(g, src)
        labels = r.labels.cpu().numpy()[: hg.n]
        preds = r.preds.cpu().numpy()[: hg.n]
        np.testing.assert_array_equal(labels, bfs_cpu(hg, src))
        np.testing.assert_array_equal(preds, host_min_parent(hg, labels))
        assert validate_preds(labels, preds, hg, src), src
        assert not r.sparse_overflowed
        log(f"# bfs src={src}: {r.num_iterations} iterations, "
            f"{int((labels >= 0).sum())} reached, labels and preds exact")
    t = time_fn(lambda: bfs(g, hub), warmup=1, repeat=3, device=device)
    edges_reached = float(hg.out_degrees[reached].sum())
    mteps = t.mteps(edges_reached)
    assert k1.launches > 0
    log(f"# phase 3: bfs hub={hub} iterations={res.num_iterations} "
        f"time {t.min_s * 1e3:.3f} ms (min of 3) mteps {mteps:.2f} "
        f"segment_reduce launches {k1.launches}")


def phase_gcn(name, hg, g, device):
    import torch

    from mini_tpu_torch.models.gcn import (
        gcn_forward, gcn_forward_cpu, gcn_init, gcn_normalize,
    )
    from mini_tpu_torch.ops.kernels import spmm_banded as k2
    from mini_tpu_torch.utils.timing import time_fn

    norm = gcn_normalize(g)
    params = gcn_init(torch.Generator().manual_seed(0),
                      [F_IN, F_HID, F_OUT], device=device)
    x_np = np.random.RandomState(0).rand(g.n_pad, F_IN).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)

    def forward(mdt):
        before = k2.launches
        out = gcn_forward(params, g, norm, x, message_dtype=mdt)
        assert k2.launches - before == 2, k2.launches - before
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mini_tpu_torch.graph import GraphSlice, erdos_renyi, rmat
    from mini_tpu_torch.ops.kernels import segreduce_kernel as k1
    from mini_tpu_torch.ops.kernels import spmm_banded as k2

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
    stats = phase_kernels(g, device)

    # the main path: every launch from here on is counted
    k1.launches = 0
    k2.launches = 0
    phase_bfs(hg, g, device)
    hg_er = erdos_renyi(2048, 16384, seed=0, undirected=True)
    phase_gcn("er2048", hg_er, GraphSlice.from_host(hg_er, device=device),
              device)
    phase_gcn(f"rmat{SCALE}", hg, g, device)
    launches = {"segment_reduce": k1.launches,
                "banded_segment_sum": k2.launches}
    for name, count in launches.items():
        assert count > 0, f"{name} was not launched on the main path"

    kernels = [
        dict(name="segment_reduce", route="cuda",
             source="mini_tpu_torch/csrc/segreduce.cu",
             replaces="mini_tpu/ops/pallas/segreduce_kernel.py:155",
             launches=launches["segment_reduce"],
             **stats["segment_reduce"]),
        dict(name="banded_segment_sum", route="cuda",
             source="mini_tpu_torch/csrc/spmm_banded.cu",
             replaces="mini_tpu/ops/pallas/spmm_banded.py:65",
             launches=launches["banded_segment_sum"],
             **stats["banded_segment_sum"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
