"""Command-line drivers, ``mini_tpu.cli``'s on the port: load graph -> run
primitive -> time -> extract -> CPU-validate -> report, as gunrock's
per-algorithm test binaries (`tests/*/test_*.cu`) do.

Usage:
    python -m mini_tpu_torch.cli bfs --file tests/fixtures/test_bfs.mtx --src 0
    python -m mini_tpu_torch.cli sssp --file g.mtx --src 0 --random-weights
    python -m mini_tpu_torch.cli pr --file g.mtx --max-iter 50
    python -m mini_tpu_torch.cli coloring|kcore|lspar --file g.mtx
    python -m mini_tpu_torch.cli bfs --rmat-scale 16 --src 0 --cpu

The subcommands, flags, defaults, printed lines and exit codes are
``mini_tpu.cli``'s (gunrock's `tests/test_utils.hxx:17-155` plus the
per-driver flags).  It runs on the card; ``--cpu`` runs the plain torch
versions on the CPU, and without it and without a card it raises.  Times
are CUDA events on the card (``utils.timing.time_fn``).  The GNN
subcommands draw their params from ``torch.Generator().manual_seed(seed)``
where ``mini_tpu`` draws from ``jax.random``, so their outputs differ from
``mini_tpu``'s; their validation against the float64 oracle does not.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A result field (tensor on any device, or a Python value) as NumPy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _load(args, device):
    from mini_tpu_torch.graph import (
        load_mtx, rmat, delaunay, grid2d, GraphSlice,
    )

    if args.file:
        hg = load_mtx(
            args.file,
            undirected=args.undirected,
            random_weights=args.random_weights,
            seed=args.seed,
        )
    elif args.rmat_scale:
        hg = rmat(
            args.rmat_scale,
            edge_factor=args.edge_factor,
            seed=args.seed,
            weighted=args.random_weights,
        )
    elif args.delaunay_scale:
        hg = delaunay(
            args.delaunay_scale, seed=args.seed,
            weighted=args.random_weights,
        )
    elif args.grid:
        hg = grid2d(
            args.grid, args.grid, seed=args.seed,
            weighted=args.random_weights,
        )
    else:
        sys.exit("need --file, --rmat-scale, --delaunay-scale or --grid")
    return hg, GraphSlice.from_host(hg, device=device)


def _params_np(params) -> list[dict]:
    return [{k: _np(v) for k, v in p.items()} for p in params]


def main(argv=None):
    p = argparse.ArgumentParser(prog="mini_tpu_torch")
    p.add_argument(
        "algo",
        choices=["bfs", "sssp", "pr", "coloring", "kcore", "lspar",
                 "cc", "gcn", "gat", "sage"],
    )
    p.add_argument("--file", default=None)
    p.add_argument("--rmat-scale", type=int, default=None)
    p.add_argument(
        "--delaunay-scale", type=int, default=None,
        help="Delaunay triangulation of 2**scale random points (the "
        "delaunay_nXX SuiteSparse family named in BASELINE.json)",
    )
    p.add_argument(
        "--grid", type=int, default=None,
        help="N x N 4-neighbor lattice (road-network stress profile)",
    )
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--src", type=int, default=0)
    p.add_argument(
        "--sources", default=None,
        help="comma list of sources for batched BFS/SSSP (one result with "
        "a row per source)",
    )
    p.add_argument(
        "--heads", type=int, default=2,
        help="gat: attention heads per layer",
    )
    p.add_argument(
        "--sssp-variant", choices=["bellman", "delta", "auto"],
        default="bellman",
        help="sssp algorithm: frontier Bellman-Ford (default), "
        "delta-stepping (bucketed, for high-diameter weighted graphs), "
        "or auto (degree-based pick)",
    )
    p.add_argument(
        "--delta", type=float, default=None,
        help="delta-stepping bucket width (default: mean edge weight)",
    )
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--undirected", action="store_true")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--prime", type=int, default=999983)
    p.add_argument("--e", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--queue-sizing",
        type=float,
        default=None,
        help="sparse-frontier capacity as a fraction of m (the reference's "
        "frontier-capacity multiplier, tests/test_utils.hxx via "
        "--queue-sizing); default lets the tier builder pick ~m/64",
    )
    p.add_argument(
        "--kcore-variant",
        choices=["auto", "mini", "hindex"],
        default="auto",
        help="kcore algorithm: reference peel semantics (mini) or true "
        "coreness via the h-index fixpoint (hindex, undirected only)",
    )
    p.add_argument(
        "--hashes-per-round",
        type=int,
        default=16,
        help="coloring: independent hash orders per round (1 = exact "
        "reference recipe)",
    )
    p.add_argument("--validate", action="store_true")
    p.add_argument("--repeat", type=int, default=5)
    p.add_argument(
        "--cpu",
        action="store_true",
        help="run on the CPU (the plain torch versions); the default is "
        "the card",
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None

    from mini_tpu_torch.utils.timing import time_fn
    from mini_tpu_torch.utils.validate import (
        validate_exact, display_device_data,
    )

    hg, gs = _load(args, device)
    device = gs.device
    print(f"graph: n={hg.n} m={hg.m} (padded {gs.n_pad}/{gs.m_pad})")
    qs_cap = (
        None
        if args.queue_sizing is None
        else max(2048, int(gs.m_pad * args.queue_sizing))
    )

    srcs = (
        [int(s) for s in args.sources.split(",")]
        if args.sources
        else None
    )

    if args.algo == "bfs":
        from mini_tpu_torch.algorithms import bfs, bfs_cpu
        from mini_tpu_torch.algorithms.bfs import bfs_batch

        if srcs is not None:
            run = lambda: bfs_batch(gs, srcs, alpha=args.alpha,  # noqa: E731
                                    sparse_capv=qs_cap,
                                    sparse_cape=qs_cap)
        else:
            run = lambda: bfs(gs, args.src, alpha=args.alpha,  # noqa: E731
                              sparse_capv=qs_cap, sparse_cape=qs_cap)
        res = run()
        t = time_fn(run, device=device)
        labels = _np(res.labels)
        labels2d = labels if labels.ndim == 2 else labels[None]
        edges = sum(
            hg.out_degrees[(lab >= 0)[: hg.n]].sum() for lab in labels2d
        )
        if bool(np.any(_np(res.sparse_overflowed))):
            print("WARNING: sparse tier overflowed — result untrusted")
        print(
            f"iterations: {_np(res.num_iterations).tolist()} "
            f"(pull: {_np(res.num_pull_iterations).tolist()})"
        )
        per = f" ({t.min_s / labels2d.shape[0] * 1e3:.3f} ms/src)" \
            if labels.ndim == 2 else ""
        print(f"elapsed: {t.min_s * 1e3:.3f} ms{per}  "
              f"MTEPS: {t.mteps(edges):.1f}")
        display_device_data(labels2d[0], name="labels")
        if args.validate:
            ok = all(
                validate_exact(lab[: hg.n], bfs_cpu(hg, s))
                for lab, s in zip(
                    labels2d, srcs if srcs is not None else [args.src]
                )
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "sssp":
        from mini_tpu_torch.algorithms import sssp, sssp_cpu
        from mini_tpu_torch.algorithms.sssp import sssp_batch

        if srcs is not None:
            run = lambda: sssp_batch(gs, srcs, sparse_capv=qs_cap,  # noqa: E731
                                     sparse_cape=qs_cap,
                                     variant=args.sssp_variant,
                                     delta=args.delta)
        else:
            run = lambda: sssp(gs, args.src, sparse_capv=qs_cap,  # noqa: E731
                               sparse_cape=qs_cap,
                               variant=args.sssp_variant,
                               delta=args.delta)
        res = run()
        t = time_fn(run, device=device)
        dists = _np(res.dists)
        dists2d = dists if dists.ndim == 2 else dists[None]
        # MTEPS over the edges of the reached component, as for BFS
        # (gunrock prints the wall clock only, tests/sssp/test_sssp.cu:38-42)
        edges = sum(
            hg.out_degrees[np.isfinite(d)[: hg.n]].sum() for d in dists2d
        )
        if bool(np.any(_np(res.sparse_overflowed))):
            print("WARNING: sparse tier overflowed — result untrusted")
        print(f"iterations: {_np(res.num_iterations).tolist()}")
        per = f" ({t.min_s / dists2d.shape[0] * 1e3:.3f} ms/src)" \
            if dists.ndim == 2 else ""
        print(f"elapsed: {t.min_s * 1e3:.3f} ms{per}  "
              f"MTEPS: {t.mteps(edges):.1f}")
        display_device_data(dists2d[0], name="dists")
        if args.validate:
            ok = all(
                validate_exact(d[: hg.n], sssp_cpu(hg, s)[0])
                for d, s in zip(
                    dists2d, srcs if srcs is not None else [args.src]
                )
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "pr":
        from mini_tpu_torch.algorithms import pagerank, pagerank_cpu

        res = pagerank(gs, max_iter=args.max_iter)
        t = time_fn(lambda: pagerank(gs, max_iter=args.max_iter),
                    device=device)
        ranks = _np(res.ranks)
        print(f"iterations: {int(res.num_iterations)}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        top = np.argsort(-ranks)[:10]
        print("top-10:", list(zip(top, ranks[top])))
        if args.validate:
            exp = pagerank_cpu(hg, max_iter=args.max_iter)
            ok = np.allclose(ranks[: hg.n], exp, rtol=1e-3, atol=1e-6)
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "coloring":
        from mini_tpu_torch.algorithms import coloring, validate_coloring

        res = coloring(
            gs,
            prime=args.prime,
            seed=args.seed,
            hashes_per_round=args.hashes_per_round,
        )
        t = time_fn(
            lambda: coloring(
                gs,
                prime=args.prime,
                seed=args.seed,
                hashes_per_round=args.hashes_per_round,
            ),
            device=device,
        )
        colors = _np(res.colors)
        print(
            f"iterations: {int(res.num_iterations)} "
            f"colors used: {len(np.unique(colors[: hg.n]))}"
        )
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        if args.validate:
            ok = validate_coloring(colors, hg)
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "kcore":
        from mini_tpu_torch.algorithms import (
            kcore, kcore_cpu, kcore_cpu_true,
        )

        variant = args.kcore_variant
        res = kcore(gs, variant=variant)
        t = time_fn(lambda: kcore(gs, variant=variant), device=device)
        print(f"largest k-core: {int(res.largest_k_core)}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        if args.validate:
            effective = (
                ("mini" if hg.directed else "hindex")
                if variant == "auto"
                else variant
            )
            oracle = kcore_cpu if effective == "mini" else kcore_cpu_true
            exp_cores, exp_largest = oracle(hg)
            ok = (
                validate_exact(_np(res.num_cores)[: hg.n], exp_cores)
                and int(res.largest_k_core) == exp_largest
            )
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo == "lspar":
        from mini_tpu_torch.algorithms import lspar

        res = lspar(gs, prime=args.prime, e=args.e, seed=args.seed)
        t = time_fn(lambda: lspar(gs, prime=args.prime, e=args.e,
                                  seed=args.seed), device=device)
        print(f"selected edges: {int(res.num_selected)} / {hg.m}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
    elif args.algo == "cc":
        from mini_tpu_torch.algorithms import connected_components, cc_cpu

        res = connected_components(gs)
        t = time_fn(lambda: connected_components(gs), device=device)
        print(f"components: {int(res.num_components)}")
        print(f"elapsed: {t.min_s * 1e3:.3f} ms")
        if args.validate:
            ok = validate_exact(_np(res.components)[: hg.n], cc_cpu(hg))
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    elif args.algo in ("gcn", "gat", "sage"):
        return _gnn(args, hg, gs, device, time_fn)
    return 0


def _gnn(args, hg, gs, device, time_fn) -> int:
    """The GNN forwards at ``mini_tpu.cli``'s widths: GCN and SAGE [128,
    128, 32], GAT [128, 32, 32] with ``--heads``; inputs from
    ``RandomState(seed)`` as there, params from a torch generator."""
    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    x_np = rng.rand(gs.n_pad, 128).astype(np.float32)
    if args.algo == "gcn":
        from mini_tpu_torch.models.gcn import (
            gcn_normalize, gcn_init, gcn_forward, gcn_forward_cpu,
        )

        norm = gcn_normalize(gs)
        params = gcn_init(gen, [128, 128, 32], device=device)
        fwd = lambda p, xx: gcn_forward(p, gs, norm, xx)  # noqa: E731
        oracle = gcn_forward_cpu
    elif args.algo == "gat":
        from mini_tpu_torch.models.gat import (
            gat_init, gat_forward, gat_forward_cpu,
        )

        params = gat_init(gen, [128, 32, 32], heads=args.heads,
                          device=device)
        x_np = x_np * 0.1
        fwd = lambda p, xx: gat_forward(p, gs, xx)  # noqa: E731
        oracle = gat_forward_cpu
    else:
        from mini_tpu_torch.models.sage import (
            sage_init, sage_forward, sage_forward_cpu,
        )

        params = sage_init(gen, [128, 128, 32], device=device)
        fwd = lambda p, xx: sage_forward(p, gs, xx)  # noqa: E731
        oracle = sage_forward_cpu
    x = torch.from_numpy(x_np).to(device)
    with torch.no_grad():
        t = time_fn(lambda: fwd(params, x), device=device)
        eps = 2 * hg.m / t.min_s  # 2 layers
        print(f"elapsed: {t.min_s * 1e3:.3f} ms  agg edges/s: {eps:.3e}")
        if args.validate:
            exp = oracle(_params_np(params), hg, x_np)
            got = _np(fwd(params, x))[: hg.n]
            # f32 device vs f64 oracle
            ok = np.allclose(got, exp, rtol=2e-3, atol=2e-3)
            print("Correct." if ok else "Validation Error.")
            return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
