"""Port parity of the GCN train step over a 2-D ("graph", "feat") mesh
(``parallel/tp.py``) against part 2 of ``__graft_entry__.dryrun_multichip``
(``mini_tpu.models.gcn.gcn_train_step`` under GSPMD, rebuilt here on a
``(4, 2)`` mesh of JAX's 8 virtual CPU devices) and against the port's
single-device ``models/gcn.gcn_train_step``, at the dry run's sizes:
``erdos_renyi(300, 2400, seed=0, undirected=True)``, GCN ``[16, 32, 4]``
from ``gcn_init(PRNGKey(0), ...)``, lr 0.05.  One spawn of 8 ``gloo``
ranks runs three meshes: 4 x 2 (the dry run's at D=8), 8 x 1 and 2 x 4
(one class a feat rank in the last layer).  Step 1's loss within rtol
1e-5 of both; every reassembled parameter and momentum within rtol 1e-4,
atol 1e-6 of both; the ``w`` blocks' replicas over ``graph`` and ``b``'s
over the mesh bitwise equal; the loss falls over two steps.

JAX is imported inside the tests only: the ranks import this module."""

import functools

import numpy as np
import pytest
import torch

from mini_tpu_torch.models._sgd import init_opt
from mini_tpu_torch.models.gcn import params_from_jax
from mini_tpu_torch.parallel import partition_graph, shard_to_mesh
from mini_tpu_torch.parallel.distributed import all_gather, make_mesh_2level
from mini_tpu_torch.parallel.launch import run_ranks
from mini_tpu_torch.parallel.tp import (
    AXES,
    gather_gcn_params_2d,
    gcn_train_step_2d,
    shard_gcn_params_2d,
)

D = 8
MESHES = [(4, 2), (8, 1), (2, 4)]  # (graph_par, feat_par)
DIMS = [16, 32, 4]
LR = 0.05
SEED = 11
TOL = dict(rtol=1e-4, atol=1e-6)


def graph(pkg):
    """The dry run's graph (``__graft_entry__.py:108``), by ``pkg``."""
    return pkg.erdos_renyi(300, 2400, seed=0, undirected=True)


def inputs(n, n_pad):
    """Features, labels and mask of ``n_pad`` rows: a fixed draw for the
    first ``n``, zeros and masked past them."""
    rng = np.random.RandomState(SEED)
    x = np.zeros((n_pad, DIMS[0]), np.float32)
    x[:n] = rng.rand(n, DIMS[0])
    labels = np.zeros(n_pad, np.int32)
    labels[:n] = rng.randint(0, DIMS[-1], n)
    return x, labels, np.arange(n_pad) < n


def _rank_cases(jp):
    """Two steps on every mesh; rank 0 returns the losses, the reassembled
    parameters and momentum after step 1, and every rank's blocks."""
    import mini_tpu_torch.graph as tg

    hg = graph(tg)
    out = {}
    for gp, fp in MESHES:
        mesh = make_mesh_2level(gp, fp, axes=AXES, device="cpu")
        pg = partition_graph(hg, gp)
        shards = shard_to_mesh(pg, mesh, axis="graph")
        s = shards.shard
        x, labels, mask = (torch.from_numpy(a.reshape(
            (gp, pg.n_loc) + a.shape[1:])[s: s + 1])
            for a in inputs(hg.n, pg.n_pad))
        params = params_from_jax(jp, device="cpu")
        p = shard_gcn_params_2d(params, mesh)
        o = shard_gcn_params_2d(init_opt(params), mesh)
        losses = []
        for step in range(2):
            p, o, loss = gcn_train_step_2d(p, o, pg, shards, x,
                                           (labels, mask), LR, mesh=mesh)
            losses.append(float(loss))
            if step == 0:
                case = {"params": gather_gcn_params_2d(p, mesh),
                        "opt": gather_gcn_params_2d(o, mesh),
                        "blocks": [{k: all_gather(v[None], None)
                                    for k, v in layer.items()}
                                   for layer in p + o]}
        out[(gp, fp)] = dict(case, losses=losses,
                             loss_on_rank=all_gather(
                                 torch.tensor([losses[0]]), None))
    return out


def np_tree(tree):
    return [{k: np.asarray(v) for k, v in p.items()} for p in tree]


@functools.lru_cache(maxsize=None)
def jax_params():
    import jax

    from mini_tpu.models.gcn import gcn_init

    return np_tree(gcn_init(jax.random.PRNGKey(0), DIMS))


@pytest.fixture(scope="module")
def port():
    return run_ranks(functools.partial(_rank_cases, jax_params()), D,
                     device="cpu", timeout_s=600)


@pytest.fixture(scope="module")
def jax_step():
    """``__graft_entry__.py:230-282`` at D=8: one GSPMD step on the (4, 2)
    mesh; (params, opt, loss) as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import mini_tpu.graph as jg
    from mini_tpu.models.gcn import gcn_init_opt, gcn_normalize, \
        gcn_train_step

    gp, fp = 4, 2
    mesh = Mesh(np.array(jax.devices()[:D]).reshape(gp, fp), AXES)
    hg = graph(jg)
    gs = jg.GraphSlice.from_host(hg, n_multiple=128 * gp, m_multiple=1024)
    x, labels, mask = inputs(hg.n, gs.n_pad)
    row = NamedSharding(mesh, P("graph", None))
    col = NamedSharding(mesh, P(None, "feat"))
    repl = NamedSharding(mesh, P())

    def put(tree):
        return [{"w": jax.device_put(jnp.asarray(t["w"]), col),
                 "b": jax.device_put(jnp.asarray(t["b"]), repl)}
                for t in tree]

    params = put(jax_params())
    opt = put(np_tree(gcn_init_opt(params)))
    p, o, loss = gcn_train_step(params, opt, gs, gcn_normalize(gs),
                                jax.device_put(jnp.asarray(x), row),
                                (jnp.asarray(labels), jnp.asarray(mask)),
                                LR)
    return np_tree(p), np_tree(o), float(loss)


@pytest.fixture(scope="module")
def single_step():
    """The port's single-device step on the same inputs, twice."""
    import mini_tpu_torch.graph as tg
    from mini_tpu_torch.models.gcn import gcn_normalize, gcn_train_step

    hg = graph(tg)
    gs = tg.GraphSlice.from_host(hg, device="cpu")
    x, labels, mask = map(torch.from_numpy, inputs(hg.n, gs.n_pad))
    norm = gcn_normalize(gs)
    params = params_from_jax(jax_params(), device="cpu")
    opt = init_opt(params)
    out = []
    for _ in range(2):
        params, opt, loss = gcn_train_step(params, opt, gs, norm, x,
                                           (labels, mask), LR, impl="xla")
        out.append((np_tree(params), np_tree(opt), float(loss)))
    return out


def assert_trees(got, want, **tol):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), w[k], err_msg=k,
                                       **tol)


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{g}x{f}" for g, f in MESHES])
def test_step_matches_jax_gspmd(port, jax_step, mesh):
    """Step 1's loss within rtol 1e-5 and the updated parameters and
    momentum within rtol 1e-4, atol 1e-6 of JAX's GSPMD step on the (4, 2)
    mesh (the step's result does not depend on the mesh)."""
    jp, jo, jl = jax_step
    got = port[mesh]
    np.testing.assert_allclose(got["losses"][0], jl, rtol=1e-5)
    assert_trees(got["params"], jp, **TOL)
    assert_trees(got["opt"], jo, **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{g}x{f}" for g, f in MESHES])
def test_step_matches_single_device(port, single_step, mesh):
    """Step 1 against the port's ``gcn_train_step``: the loss within rtol
    1e-5, the parameters and momentum within rtol 1e-4, atol 1e-6; step
    2's loss too, and it is below step 1's."""
    got = port[mesh]
    (sp, so, sl), (_, _, sl2) = single_step
    np.testing.assert_allclose(got["losses"], [sl, sl2], rtol=1e-5)
    assert_trees(got["params"], sp, **TOL)
    assert_trees(got["opt"], so, **TOL)
    assert got["losses"][1] < got["losses"][0], got["losses"]


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{g}x{f}" for g, f in MESHES])
def test_replicas_are_bitwise_equal(port, mesh):
    """After a step every rank holds the same loss; the ranks of one feat
    column hold the same ``w`` block (and momentum) bit for bit, every rank
    the same ``b``; the blocks side by side are the reassembled ``w``."""
    gp, fp = mesh
    got = port[mesh]
    assert len(set(got["loss_on_rank"].tolist())) == 1
    whole = got["params"] + got["opt"]
    for layer, full in zip(got["blocks"], whole):
        w, b = layer["w"].numpy(), layer["b"].numpy()  # [D, ...]: by rank
        assert (b == b[0]).all()
        np.testing.assert_array_equal(b[0], np.asarray(full["b"]))
        for r in range(D):  # rank r = (r // fp, r % fp)
            np.testing.assert_array_equal(w[r], w[r % fp])
        np.testing.assert_array_equal(np.concatenate(list(w[:fp]), axis=1),
                                      np.asarray(full["w"]))
        assert w.shape[-1] == np.asarray(full["w"]).shape[1] // fp
