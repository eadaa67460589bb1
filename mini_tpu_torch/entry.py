"""Driver entry point: the flagship workload, ``__graft_entry__.entry()``'s
on the port.

    from mini_tpu_torch.entry import entry
    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    logits = fn(*args)

The multi-chip dry run (``__graft_entry__.dryrun_multichip``) waits for
the port's ``parallel`` layer.
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
