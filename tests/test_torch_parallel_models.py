"""Port parity of the distributed GNNs (``parallel/gcn.py``,
``parallel/models.py``) against ``mini_tpu.parallel`` at D=8 (JAX's 8
virtual CPU devices here, the port's 8 ``gloo`` ranks from one spawn),
on the JAX tests' graphs, features, labels and params (JAX's draws,
carried by ``params_from_jax``):

* GCN (tests/test_dist_gcn.py, test_dist_gcn_halo.py): the loss falls on
  a teacher's labels; a step's loss within 1e-4 of the single-device
  port's and of JAX's, its gradient the single-device port's (rtol 1e-4,
  atol 1e-6); the halo, overlapped and 2-level losses within rtol 1e-5 of
  the all-gather ones and of JAX's;
* SAGE and GAT (tests/test_dist_models.py): forwards within that file's
  tolerances of JAX's and of the single-device port's, both exchanges;
  losses falling, the boundary exchange's within rtol 1e-5 of the
  all-gather's and of JAX's; one step's gradient the single-device
  port's (GAT at that file's rtol 1e-3, atol 1e-5; SAGE rtol 1e-4,
  atol 1e-6).

JAX is imported inside the tests only: the ranks import this module."""

import functools

import numpy as np
import pytest
import torch

from mini_tpu_torch.models.gcn import params_from_jax
from mini_tpu_torch.parallel import (
    build_halo_plan,
    dist_gat_forward,
    dist_gat_train,
    dist_sage_forward,
    dist_sage_train,
    make_mesh,
    partition_graph,
    shard_to_mesh,
)
from mini_tpu_torch.parallel.distributed import make_mesh_2level
from mini_tpu_torch.parallel.gcn import dist_gcn_train
from mini_tpu_torch.parallel.launch import run_ranks

from test_torch_parallel import D, full, graphs

GRAD_LR = 0.5  # a first momentum step: new = p - lr * grad


def np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def grads_of(old, new, lr=GRAD_LR):
    return [{k: (o[k] - np.asarray(n[k])) / lr for k in o}
            for o, n in zip(old, new)]


def gcn_inputs(hg, pg, seed, F, C):
    """tests/test_dist_gcn.py's ``[n_pad]`` features (zero past n),
    labels and mask."""
    rng = np.random.RandomState(seed)
    x = rng.rand(pg.n_pad, F).astype(np.float32)
    x[hg.n:] = 0
    labels = rng.randint(0, C, pg.n_pad).astype(np.int32)
    return x, labels, np.arange(pg.n_pad) < hg.n


def gcn_halo_inputs(hg, pg, seed=0, F=8, C=3):
    """tests/test_dist_gcn_halo.py's ``[D, n_loc]`` inputs."""
    rng = np.random.RandomState(seed)
    x = rng.rand(pg.num_shards, pg.n_loc, F).astype(np.float32)
    labels = rng.randint(0, C, (pg.num_shards, pg.n_loc)).astype(np.int32)
    return x, labels, (np.arange(pg.n_pad) < hg.n).reshape(x.shape[:2])


def model_inputs(hg, pg, seed, F=8, n_classes=4):
    """tests/test_dist_models.py's ``_setup``/``_train_setup`` inputs:
    ``[D, n_loc, F]`` features, labels and mask."""
    n = hg.n
    xn = np.random.RandomState(seed).rand(n, F).astype(np.float32) * 0.1
    x = np.zeros((pg.num_shards, pg.n_loc, F), np.float32)
    x.reshape(-1, F)[:n] = xn
    lab = np.zeros((pg.num_shards, pg.n_loc), np.int32)
    lab.reshape(-1)[:n] = np.random.RandomState(seed).randint(0, n_classes, n)
    return x, lab, (np.arange(pg.n_pad) < n).reshape(lab.shape)


def _rank_cases(jp):
    """Every case of this file on one rank; ``jp``: JAX's params (numpy)
    and the teacher's labels."""
    import mini_tpu_torch.graph as tg

    mesh = make_mesh(D, device="cpu")
    s = torch.distributed.get_rank()
    g = graphs(tg)
    out = {}

    def setup(name, mesh_=mesh, axis="graph"):
        hg = g[name]
        pg = partition_graph(hg, D)
        return hg, pg, shard_to_mesh(pg, mesh_, axis=axis), build_halo_plan(pg)

    def block(a):
        return torch.from_numpy(np.ascontiguousarray(a.reshape(
            (D, -1) + a.shape[1:] if a.shape[0] != D else a.shape)[s: s + 1]))

    def params(key):
        return params_from_jax(jp[key], device="cpu")

    # GCN: tests/test_dist_gcn.py
    hg, pg, shards, plan = setup("gcn")
    x, _, mask = gcn_inputs(hg, pg, 0, 16, 4)
    _, out["gcn_teacher"] = dist_gcn_train(
        pg, shards, mesh, params("gcn_student"), block(x.reshape(
            D, pg.n_loc, 16)), block(jp["teacher_labels"]), block(mask),
        steps=25, lr=0.3)
    x, labels, mask = gcn_inputs(hg, pg, 1, 8, 3)
    args = (block(x.reshape(D, pg.n_loc, 8)), block(labels), block(mask))
    _, out["gcn_loss0"] = dist_gcn_train(pg, shards, mesh, params("gcn_fwd"),
                                         *args, steps=1, lr=0.0)
    new, _ = dist_gcn_train(pg, shards, mesh, params("gcn_fwd"), *args,
                            steps=1, lr=GRAD_LR)
    out["gcn_step"] = new

    # GCN with the halo exchange: tests/test_dist_gcn_halo.py
    hg, pg, shards, plan = setup("gcn_halo")
    args = [block(a) for a in gcn_halo_inputs(hg, pg)]
    for name, kw in (("ag", {}), ("halo", dict(halo_plan=plan)),
                     ("overlap", dict(halo_plan=plan, overlap=True))):
        _, out[f"gcn_{name}"] = dist_gcn_train(
            pg, shards, mesh, params("gcn_halo"), *args, steps=3, lr=0.1,
            **kw)
    hg, pg, shards, plan = setup("gcn_halo2")
    args = [block(a) for a in gcn_halo_inputs(hg, pg)]
    _, out["gcn_2level_ag"] = dist_gcn_train(
        pg, shards, mesh, params("gcn_halo"), *args, steps=3, lr=0.1)
    axes = ("dcn", "ici")
    mesh2 = make_mesh_2level(2, D // 2, device="cpu")
    hg, pg, shards2, plan = setup("gcn_halo2", mesh2, axes)
    _, out["gcn_2level"] = dist_gcn_train(
        pg, shards2, mesh2, params("gcn_halo"), *args, steps=3, lr=0.1,
        axis=axes, halo_plan=plan, overlap=True)

    # SAGE and GAT forwards: tests/test_dist_models.py:_setup(seed=11)
    hg, pg, shards, plan = setup("models")
    x = block(model_inputs(hg, pg, 11)[0])
    for name, pl in (("ag", None), ("plan", plan)):
        out[f"sage_fwd_{name}"] = full(dist_sage_forward(
            pg, shards, mesh, params("sage_fwd"), x, plan=pl))
        out[f"gat_fwd_{name}"] = full(dist_gat_forward(
            pg, shards, mesh, params("gat_fwd"), x, plan=pl))

    # training: _train_setup(seed=13)
    hg, pg, shards, plan = setup("models13")
    args = [block(a) for a in model_inputs(hg, pg, 13)]
    for name, pl in (("ag", None), ("plan", plan)):
        _, out[f"sage_train_{name}"] = dist_sage_train(
            pg, shards, mesh, params("sage_train"), *args, steps=5, lr=0.1,
            plan=pl)
        _, out[f"gat_train_{name}"] = dist_gat_train(
            pg, shards, mesh, params("gat_train"), *args, steps=5, lr=0.1,
            plan=pl)
        out[f"sage_step_{name}"], _ = dist_sage_train(
            pg, shards, mesh, params("sage_train"), *args, steps=1,
            lr=GRAD_LR, plan=pl)
        out[f"gat_step_{name}"], _ = dist_gat_train(
            pg, shards, mesh, params("gat_train"), *args, steps=1,
            lr=GRAD_LR, plan=pl)
    return out


@functools.lru_cache(maxsize=None)
def jax_params():
    """JAX's params of every case, and the teacher's labels
    (tests/test_dist_gcn.py:35-51)."""
    import jax
    import jax.numpy as jnp

    import mini_tpu.graph as jg
    from mini_tpu.graph import GraphSlice
    from mini_tpu.models.gat import gat_init
    from mini_tpu.models.gcn import gcn_forward, gcn_init, gcn_normalize
    from mini_tpu.models.sage import sage_init
    from mini_tpu.parallel import partition_graph as jpart

    key = jax.random.PRNGKey
    hg = graphs(jg)["gcn"]
    pg = jpart(hg, D)
    x, _, _ = gcn_inputs(hg, pg, 0, 16, 4)
    gs = GraphSlice.from_host(hg, n_multiple=pg.n_pad, m_multiple=1024)
    teacher = gcn_init(key(7), [16, 32, 4])
    tl = np.asarray(jnp.argmax(gcn_forward(
        teacher, gs, gcn_normalize(gs), jnp.asarray(x)), -1)).astype(np.int32)
    return {
        "teacher_labels": tl[: pg.n_pad],
        "gcn_student": np_params(gcn_init(key(0), [16, 32, 4])),
        "gcn_fwd": np_params(gcn_init(key(3), [8, 16, 3])),
        "gcn_halo": np_params(gcn_init(key(0), [8, 16, 3])),
        "sage_fwd": np_params(sage_init(key(2), [8, 16, 4])),
        "gat_fwd": np_params(gat_init(key(3), [8, 16, 3], heads=2)),
        "sage_train": np_params(sage_init(key(4), [8, 16, 4])),
        "gat_train": np_params(gat_init(key(5), [8, 16, 4], heads=2)),
    }


@pytest.fixture(scope="module")
def port():
    return run_ranks(functools.partial(_rank_cases, jax_params()), D,
                     device="cpu", timeout_s=600)


def jax_mesh_case(name, axes="graph"):
    """JAX's mesh, partition, shards and plan of graph ``name``."""
    import mini_tpu.graph as jg
    from mini_tpu.parallel import build_halo_plan as jplan
    from mini_tpu.parallel import make_mesh as jmesh
    from mini_tpu.parallel import partition_graph as jpart
    from mini_tpu.parallel import shard_to_mesh as jshard
    from mini_tpu.parallel.distributed import make_mesh_2level as jmesh2

    hg = graphs(jg)[name]
    mesh = jmesh(D) if axes == "graph" else jmesh2(2, D // 2)
    pg = jpart(hg, D)
    return hg, mesh, pg, jshard(pg, mesh, axis=axes), jplan(pg)


def sharded(mesh, axes, *arrays):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = NamedSharding(mesh, P(axes))
    return [jax.device_put(jnp.asarray(a), spec) for a in arrays]


def single(name, n_multiple=128):
    """The single-device port's graph of ``name`` on the CPU."""
    import mini_tpu_torch.graph as tg

    return tg.GraphSlice.from_host(graphs(tg)[name], n_multiple=n_multiple,
                                   device="cpu")


def single_grads(loss_fn, params_np):
    params = [{k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in p.items()} for p in params_np]
    flat = [v for p in params for v in p.values()]
    grads = iter(torch.autograd.grad(loss_fn(params), flat))
    return [{k: next(grads).numpy() for k in p} for p in params]


def assert_grads(got, want, **tol):
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


# ------------------------------------------------------------------ GCN
def test_dist_gcn_loss_decreases(port):
    """tests/test_dist_gcn.py: 25 steps at lr 0.3 on a teacher GCN's
    labels; the loss falls below 0.8 of its first value, and the first
    loss is JAX's within rtol 1e-5."""
    from mini_tpu.models.gcn import gcn_init
    from mini_tpu.parallel.gcn import dist_gcn_train as jtrain
    import jax

    losses = port["gcn_teacher"]
    assert losses[-1] < losses[0] * 0.8, losses
    hg, mesh, pg, shards, _ = jax_mesh_case("gcn")
    x, _, mask = gcn_inputs(hg, pg, 0, 16, 4)
    xs, ls, ms = sharded(mesh, "graph", x.reshape(D, pg.n_loc, 16),
                         jax_params()["teacher_labels"].reshape(D, -1),
                         mask.reshape(D, -1))
    _, jl = jtrain(pg, shards, mesh, gcn_init(jax.random.PRNGKey(0),
                                              [16, 32, 4]),
                   xs, ls, ms, steps=1, lr=0.3)
    np.testing.assert_allclose(losses[0], jl[0], rtol=1e-5)


def test_dist_gcn_forward_matches_single_chip(port):
    """tests/test_dist_gcn.py: a 0-lr step's loss within 1e-4 of the
    single-device port's ``gcn_loss`` and of JAX's; one step's gradient
    the single-device port's (rtol 1e-4, atol 1e-6)."""
    from mini_tpu.models.gcn import gcn_loss as jloss
    from mini_tpu.models.gcn import gcn_normalize as jnorm
    from mini_tpu.graph import GraphSlice as JGS
    import jax.numpy as jnp
    import mini_tpu.graph as jg
    from mini_tpu_torch.models.gcn import gcn_loss, gcn_normalize
    from mini_tpu_torch.parallel import partition_graph as tpart

    import mini_tpu_torch.graph as tg

    hg = graphs(tg)["gcn"]
    pg = tpart(hg, D)
    x, labels, mask = gcn_inputs(hg, pg, 1, 8, 3)
    gs = single("gcn", n_multiple=pg.n_pad)
    norm = gcn_normalize(gs)
    args = (torch.from_numpy(x), torch.from_numpy(labels),
            torch.from_numpy(mask))

    def loss(p):
        return gcn_loss(p, gs, norm, *args, impl="xla")

    p0 = jax_params()["gcn_fwd"]
    ref = float(loss(params_from_jax(p0, device="cpu")))
    assert abs(port["gcn_loss0"][0] - ref) < 1e-4
    jgs = JGS.from_host(graphs(jg)["gcn"], n_multiple=pg.n_pad,
                        m_multiple=1024)
    jref = float(jloss(p0, jgs, jnorm(jgs), jnp.asarray(x),
                       jnp.asarray(labels), jnp.asarray(mask)))
    assert abs(port["gcn_loss0"][0] - jref) < 1e-4
    assert_grads(grads_of(p0, port["gcn_step"]), single_grads(loss, p0),
                 rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def jax_gcn_halo_losses():
    """JAX's all-gather losses of tests/test_dist_gcn_halo.py's case."""
    from mini_tpu.models.gcn import gcn_init
    from mini_tpu.parallel.gcn import dist_gcn_train as jtrain
    import jax

    hg, mesh, pg, shards, _ = jax_mesh_case("gcn_halo")
    args = sharded(mesh, "graph", *gcn_halo_inputs(hg, pg))
    _, jl = jtrain(pg, shards, mesh, gcn_init(jax.random.PRNGKey(0),
                                              [8, 16, 3]),
                   *args, steps=3, lr=0.1)
    return jl


@pytest.mark.parametrize("name", ["halo", "overlap"])
def test_halo_gcn_matches_allgather_gcn(port, jax_gcn_halo_losses, name):
    """tests/test_dist_gcn_halo.py: 3 steps with the boundary exchange
    (and with the own-edge sum overlapped) give the all-gather losses and
    JAX's, within rtol 1e-5."""
    got = port[f"gcn_{name}"]
    np.testing.assert_allclose(got, port["gcn_ag"], rtol=1e-5)
    np.testing.assert_allclose(got, jax_gcn_halo_losses, rtol=1e-5)
    np.testing.assert_allclose(port["gcn_ag"], jax_gcn_halo_losses,
                               rtol=1e-5)


def test_halo_gcn_2level_mesh_matches(port):
    """tests/test_dist_gcn_halo.py:112: GCN on the (dcn, ici) 2 x 4 mesh
    with the hierarchical, overlapped exchange reproduces the flat
    all-gather losses and JAX's 2-level ones, within rtol 1e-5."""
    from mini_tpu.models.gcn import gcn_init
    from mini_tpu.parallel.gcn import dist_gcn_train as jtrain
    import jax

    np.testing.assert_allclose(port["gcn_2level"], port["gcn_2level_ag"],
                               rtol=1e-5)
    axes = ("dcn", "ici")
    hg, mesh2, pg, shards2, plan = jax_mesh_case("gcn_halo2", axes)
    args = sharded(mesh2, axes, *gcn_halo_inputs(hg, pg))
    _, jl = jtrain(pg, shards2, mesh2, gcn_init(jax.random.PRNGKey(0),
                                                [8, 16, 3]),
                   *args, steps=3, lr=0.1, axis=axes, halo_plan=plan,
                   overlap=True)
    np.testing.assert_allclose(port["gcn_2level"], jl, rtol=1e-5)


# ---------------------------------------------------------- SAGE, GAT
def _single_x(name, seed):
    gs = single(name)
    x = np.zeros((gs.n_pad, 8), np.float32)
    x[: gs.n] = np.random.RandomState(seed).rand(gs.n, 8).astype(
        np.float32) * 0.1
    return gs, torch.from_numpy(x)


@pytest.mark.parametrize("plan", ["ag", "plan"])
def test_dist_sage_forward_matches(port, plan):
    """tests/test_dist_models.py's SAGE forward: JAX's distributed forward
    and the single-device port's ``sage_forward`` within rtol 1e-5, atol
    1e-5."""
    from mini_tpu.parallel import dist_sage_forward as jfwd
    from mini_tpu_torch.models.sage import sage_forward

    p = jax_params()["sage_fwd"]
    hg, mesh, pg, shards, jplan = jax_mesh_case("models")
    (xs,) = sharded(mesh, "graph", model_inputs(hg, pg, 11)[0])
    got = port[f"sage_fwd_{plan}"].numpy().reshape(pg.n_pad, -1)[: hg.n]
    want = jfwd(pg, shards, mesh, p, xs, plan=jplan if plan == "plan"
                else None)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(want).reshape(pg.n_pad, -1)[: hg.n], **tol)
    gs, x = _single_x("models", 11)
    ref = sage_forward(params_from_jax(p, device="cpu"), gs, x, impl="xla")
    np.testing.assert_allclose(got, ref.numpy()[: hg.n], **tol)


@pytest.mark.parametrize("plan", ["ag", "plan"])
def test_dist_gat_forward_matches(port, plan):
    """tests/test_dist_models.py's GAT forward (2 heads): JAX's
    distributed forward and the single-device port's fused
    ``gat_forward`` within rtol 1e-4, atol 1e-5."""
    from mini_tpu.parallel import dist_gat_forward as jfwd
    from mini_tpu_torch.models.gat import gat_forward

    p = jax_params()["gat_fwd"]
    hg, mesh, pg, shards, jplan = jax_mesh_case("models")
    (xs,) = sharded(mesh, "graph", model_inputs(hg, pg, 11)[0])
    got = port[f"gat_fwd_{plan}"].numpy().reshape(pg.n_pad, -1)[: hg.n]
    want = jfwd(pg, shards, mesh, p, xs, plan=jplan if plan == "plan"
                else None)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(want).reshape(pg.n_pad, -1)[: hg.n], **tol)
    gs, x = _single_x("models", 11)
    ref = gat_forward(params_from_jax(p, device="cpu"), gs, x, attn="fused")
    np.testing.assert_allclose(got, ref.numpy()[: hg.n], **tol)


def _jax_train_losses(model):
    from mini_tpu.parallel.models import dist_gat_train as jgat
    from mini_tpu.parallel.models import dist_sage_train as jsage

    hg, mesh, pg, shards, _ = jax_mesh_case("models13")
    args = sharded(mesh, "graph", *model_inputs(hg, pg, 13))
    train = jsage if model == "sage" else jgat
    _, jl = train(pg, shards, mesh, jax_params()[f"{model}_train"], *args,
                  steps=5, lr=0.1)
    return jl


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_dist_train_loss_decreases(port, model):
    """tests/test_dist_models.py: 5 steps at lr 0.1; the losses fall, the
    boundary exchange's are the all-gather's within rtol 1e-5, and both
    are JAX's within rtol 1e-5."""
    losses = port[f"{model}_train_ag"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(port[f"{model}_train_plan"], losses,
                               rtol=1e-5)
    np.testing.assert_allclose(losses, _jax_train_losses(model), rtol=1e-5)


@pytest.mark.parametrize("plan", ["ag", "plan"])
@pytest.mark.parametrize("model", ["sage", "gat"])
def test_dist_train_grads_match_single_chip(port, model, plan):
    """tests/test_dist_models.py's gradient check: one distributed step's
    gradient is the single-device port's gradient of the same loss (GAT:
    the fused forward, at that test's rtol 1e-3, atol 1e-5; SAGE at rtol
    1e-4, atol 1e-6)."""
    from mini_tpu_torch.models.gat import gat_loss
    from mini_tpu_torch.models.sage import sage_loss

    p0 = jax_params()[f"{model}_train"]
    gs, x = _single_x("models13", 13)
    lab = np.zeros(gs.n_pad, np.int32)
    lab[: gs.n] = np.random.RandomState(13).randint(0, 4, gs.n)
    args = (x, torch.from_numpy(lab), torch.arange(gs.n_pad) < gs.n)
    if model == "gat":
        def loss(p):
            return gat_loss(p, gs, *args, attn="fused")
        tol = dict(rtol=1e-3, atol=1e-5)
    else:
        def loss(p):
            return sage_loss(p, gs, *args, impl="xla")
        tol = dict(rtol=1e-4, atol=1e-6)
    assert_grads(grads_of(p0, port[f"{model}_step_{plan}"]),
                 single_grads(loss, p0), **tol)
