"""Entry points: the flagship workload and the multi-device dry
run, ``__graft_entry__``'s ``entry()`` and ``dryrun_multichip`` on the
port.

    from mini_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    logits = fn(*args)
    dryrun_multichip(torch.cuda.device_count())  # one NCCL rank a card
    dryrun_multichip(8, device="cpu")            # 8 gloo ranks

The dry run ports both parts of JAX's: the explicit ``shard_map``
programs, and the GSPMD GCN step over a 2-D (graph, feat) mesh, written
out here as an explicit graph- and tensor-parallel step
(``parallel/tp.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def _flagship(n=2048, m=16384, fin=128, fhid=128, fout=32, seed=0,
              device=None):
    """Flagship workload: the 2-layer GCN forward [fin, fhid, fout] over
    ``erdos_renyi(n, m, undirected)`` (the BASELINE.json config-5 shape,
    neighborhood-reduce as SpMM).  The graph and the features are
    ``mini_tpu``'s for the same seed; the params come from
    ``torch.Generator().manual_seed(seed)`` (``params_from_jax`` carries
    ``mini_tpu``'s across)."""
    from mini_tpu_torch.graph import GraphSlice, erdos_renyi
    from mini_tpu_torch.models.gcn import gcn_init, gcn_normalize

    hg = erdos_renyi(n, m, seed=seed, undirected=True)
    gs = GraphSlice.from_host(hg, device=device)
    norm = gcn_normalize(gs)
    params = gcn_init(torch.Generator().manual_seed(seed), [fin, fhid, fout],
                      device=gs.device)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(gs.n_pad, fin).astype(np.float32)).to(
        gs.device)
    return gs, norm, params, x


def entry(device=None):
    """``(fn, example_args)``: the GCN forward step and its inputs on
    ``device`` (``None``: the card, which must be present)."""
    from mini_tpu_torch.models.gcn import gcn_forward

    gs, norm, params, x = _flagship(device=device)

    def fn(params, gs, norm, x):
        return gcn_forward(params, gs, norm, x)

    return fn, (params, gs, norm, x)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every distributed program once on tiny shapes over
    ``n_devices`` ranks (``parallel.launch.run_ranks``: one rank a card,
    or gloo ranks with ``device="cpu"``) and hold each against the
    single-device port on the rank's device: BFS (all-gather and halo)
    bitwise ``bfs_cpu``, SSSP bitwise ``sssp_cpu``, PageRank within rtol
    1e-3, CC, coloring (the same draws) and k-core (``hindex``) bitwise,
    L-Spar's count equal, the GAT and SAGE forwards finite, the GCN, GAT
    and SAGE training losses falling, at an even ``n_devices >= 4`` the
    2-level (dcn, ici) GCN's first loss within rtol 1e-5 of the flat one,
    and (JAX's part 2) one GCN step over the (graph, feat) mesh, ``feat``
    2 ranks when ``n_devices`` is even: its loss finite and, on gloo ranks,
    the loss and the updated parameters those of the single-device step.
    Raises if any rank fails."""
    import functools

    from mini_tpu_torch.parallel.launch import run_ranks

    run_ranks(functools.partial(_dryrun_rank, n_devices), n_devices,
              device=device)


def _dryrun_rank(n_devices: int) -> None:
    import torch.distributed as dist

    from mini_tpu_torch.algorithms import (
        bfs_cpu,
        cc_cpu,
        coloring,
        kcore,
        lspar,
        pagerank,
        sssp_cpu,
    )
    from mini_tpu_torch.graph import GraphSlice, erdos_renyi
    from mini_tpu_torch.models.gat import gat_init
    from mini_tpu_torch.models.gcn import gcn_init, gcn_normalize, \
        gcn_train_step
    from mini_tpu_torch.models.sage import sage_init
    from mini_tpu_torch.parallel import (
        build_halo_plan,
        dist_bfs,
        dist_gat_forward,
        dist_gat_train,
        dist_lspar,
        dist_sage_forward,
        dist_sage_train,
        dist_spmm,
        dist_sssp,
        make_mesh,
        partition_graph,
        shard_to_mesh,
    )
    from mini_tpu_torch.parallel.distributed import (
        all_gather,
        dist_cc,
        dist_coloring,
        dist_kcore,
        dist_pagerank,
        make_mesh_2level,
    )
    from mini_tpu_torch.parallel.gcn import dist_gcn_train
    from mini_tpu_torch.parallel.tp import (
        gather_gcn_params_2d,
        gcn_train_step_2d,
        make_mesh_2d,
        shard_gcn_params_2d,
    )

    D = n_devices
    kind = "cpu" if dist.get_backend() == "gloo" else None  # else the card
    mesh = make_mesh(D, device=kind)
    hg = erdos_renyi(300, 2400, seed=0, undirected=True)
    pg = partition_graph(hg, D)
    shards = shard_to_mesh(pg, mesh)
    dev, s, n = shards.device, shards.shard, hg.n

    def full(t):  # every rank's block, in shard order
        return all_gather(t.contiguous(), None).cpu().numpy()

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # 1. BFS, all-gather and boundary-only exchange
    labels, _ = dist_bfs(pg, shards, 0, mesh)
    labels = full(labels)
    np.testing.assert_array_equal(labels[:n], bfs_cpu(hg, 0))
    plan = build_halo_plan(pg)
    labels_bd, _ = dist_bfs(pg, shards, 0, mesh, plan=plan)
    np.testing.assert_array_equal(full(labels_bd), labels)

    # 2. SpMM
    F = 8
    rng = np.random.RandomState(0)
    x = rng.rand(D, pg.n_loc, F).astype(np.float32)
    xs = torch.from_numpy(x[s: s + 1]).to(dev)
    out = dist_spmm(pg, shards, xs, mesh)
    assert tuple(out.shape) == (1, pg.n_loc, F), out.shape

    # 3. GCN training (graph-parallel, summed replicated gradients)
    lab = rng.randint(0, 4, (D, pg.n_loc)).astype(np.int32)
    msk = (np.arange(pg.n_pad) < n).reshape(D, pg.n_loc)
    lab1 = torch.from_numpy(lab[s: s + 1]).to(dev)
    msk1 = torch.from_numpy(msk[s: s + 1]).to(dev)
    _, losses = dist_gcn_train(pg, shards, mesh,
                               gcn_init(gen(1), [F, 16, 4], device=dev),
                               xs, lab1, msk1, steps=2)
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses

    # 4. every traversal, with the halo plan, against the single device
    gs = GraphSlice.from_host(hg, device=dev)
    dists = dist_sssp(pg, shards, 0, mesh, plan=plan)
    np.testing.assert_array_equal(full(dists)[:n], sssp_cpu(hg, 0)[0])
    ranks, _ = dist_pagerank(pg, shards, mesh, plan=plan)
    np.testing.assert_allclose(
        full(ranks)[:n],
        pagerank(gs, variant="standard").ranks.cpu().numpy()[:n],
        rtol=1e-3, atol=1e-7)
    comp, _ = dist_cc(pg, shards, mesh, plan=plan)
    np.testing.assert_array_equal(full(comp)[:n], cc_cpu(hg))
    colors, _ = dist_coloring(pg, shards, mesh, plan=plan, seed=0)
    np.testing.assert_array_equal(  # the same draws: the same claims
        full(colors)[:n], coloring(gs, seed=0).colors.cpu().numpy()[:n])
    cores, _ = dist_kcore(pg, shards, mesh, plan=plan)
    np.testing.assert_array_equal(
        full(cores)[:n],
        kcore(gs, variant="hindex").num_cores.cpu().numpy()[:n])
    _, _, count = dist_lspar(pg, shards, mesh, plan=plan)
    assert count == int(lspar(gs).num_selected), count

    # 5. GAT and SAGE forwards and training
    out = dist_gat_forward(pg, shards, mesh,
                           gat_init(gen(2), [F, 8, 3], heads=2, device=dev),
                           xs, plan=plan)
    assert bool(torch.isfinite(out).all())
    out = dist_sage_forward(pg, shards, mesh,
                            sage_init(gen(3), [F, 8, 3], device=dev), xs,
                            plan=plan)
    assert bool(torch.isfinite(out).all())
    _, gat_losses = dist_gat_train(
        pg, shards, mesh, gat_init(gen(4), [F, 8, 4], heads=2, device=dev),
        xs, lab1, msk1, steps=2, plan=plan)
    assert np.isfinite(gat_losses).all() and gat_losses[1] < gat_losses[0]
    _, sage_losses = dist_sage_train(
        pg, shards, mesh, sage_init(gen(5), [F, 8, 4], device=dev), xs,
        lab1, msk1, steps=2, plan=plan)
    assert np.isfinite(sage_losses).all() \
        and sage_losses[1] < sage_losses[0]

    # 6. the 2-level (dcn, ici) mesh: hierarchical halo exchange with
    # collective/compute overlap, GCN training
    if D % 2 == 0 and D >= 4:
        axes = ("dcn", "ici")
        mesh2 = make_mesh_2level(2, D // 2, device=kind)
        shards2 = shard_to_mesh(pg, mesh2, axis=axes)
        _, losses2 = dist_gcn_train(
            pg, shards2, mesh2, gcn_init(gen(1), [F, 16, 4], device=dev),
            xs, lab1, msk1, steps=1, axis=axes, halo_plan=plan,
            overlap=True)
        np.testing.assert_allclose(losses2[0], losses[0], rtol=1e-5)

    # 7. (JAX's part 2) one GCN train step over the 2-D (graph, feat) mesh:
    # rows over graph, each w and its momentum by columns over feat
    mesh2d = make_mesh_2d(D, device=kind)
    gp = mesh2d.size(0)
    pg2 = partition_graph(hg, gp)
    shards2d = shard_to_mesh(pg2, mesh2d, axis="graph")
    g2 = shards2d.shard
    xf = np.zeros((pg2.n_pad, 16), np.float32)
    xf[:n] = rng.rand(n, 16)
    lab_f = np.zeros(pg2.n_pad, np.int32)
    lab_f[:n] = rng.randint(0, 4, n)
    msk_f = np.arange(pg2.n_pad) < n

    def rows(a):  # this rank's [1, n_loc, ...] block
        return torch.from_numpy(a.reshape((gp, pg2.n_loc) + a.shape[1:])[
            g2: g2 + 1]).to(dev)

    params = gcn_init(gen(0), [16, 32, 4], device=dev)
    opt = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    blocks, opt_blocks, loss2d = gcn_train_step_2d(
        shard_gcn_params_2d(params, mesh2d),
        shard_gcn_params_2d(opt, mesh2d), pg2, shards2d, rows(xf),
        (rows(lab_f), rows(msk_f)), 0.05, mesh=mesh2d)
    assert np.isfinite(float(loss2d)), float(loss2d)
    if kind == "cpu":
        x1 = torch.zeros(gs.n_pad, 16, device=dev)
        x1[:n] = torch.from_numpy(xf[:n])
        lab1 = torch.zeros(gs.n_pad, dtype=torch.int32, device=dev)
        lab1[:n] = torch.from_numpy(lab_f[:n])
        want, _, want_loss = gcn_train_step(
            params, opt, gs, gcn_normalize(gs), x1,
            (lab1, torch.arange(gs.n_pad, device=dev) < n), 0.05)
        np.testing.assert_allclose(float(loss2d), float(want_loss),
                                   rtol=1e-5)
        for got, ref in zip(gather_gcn_params_2d(blocks, mesh2d), want):
            for k in ref:
                np.testing.assert_allclose(got[k].cpu().numpy(),
                                           ref[k].cpu().numpy(), rtol=1e-4,
                                           atol=1e-6)
