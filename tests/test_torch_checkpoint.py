"""Port parity: ``mini_tpu_torch.utils.checkpoint`` writes and reads
``mini_tpu.utils.checkpoint``'s file format.  A GCN and a GAT params +
optimizer-state file written by either package loads into the other's
structure with equal arrays; a structural mismatch (leaf count, shape,
dtype, key names) raises ``ValueError`` in both; the key paths and the
leaf order are ``jax.tree_util``'s; bfloat16 leaves are stored as their
raw 2-byte words (dtype ``V2``), the bytes ``mini_tpu`` writes."""

import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_tpu.models import gat as jgat
from mini_tpu.models import gcn as jgcn
from mini_tpu.utils import checkpoint as jck
from mini_tpu_torch.models import gat as tgat
from mini_tpu_torch.models import gcn as tgcn
from mini_tpu_torch.utils import checkpoint as tck
from mini_tpu_torch.utils import load_pytree, save_pytree


def jax_state(model):
    """A JAX model's params and momentum after one nonzero update, so
    every leaf differs from the fresh structure's."""
    key = jax.random.PRNGKey(3)
    if model == "gcn":
        params = jgcn.gcn_init(key, [8, 16, 4])
    else:
        params = jgat.gat_init(key, [8, 6, 4], heads=2)
    opt = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.25, params)
    return {"params": params, "opt": opt, "step": jnp.asarray(7)}


def torch_like(model):
    gen = torch.Generator().manual_seed(0)
    if model == "gcn":
        params = tgcn.gcn_init(gen, [8, 16, 4], device="cpu")
        opt = tgcn.gcn_init_opt(params)
    else:
        params = tgat.gat_init(gen, [8, 6, 4], heads=2, device="cpu")
        opt = tgat.gat_init_opt(params)
    return {"params": params, "opt": opt,
            "step": torch.tensor(0, dtype=torch.int32)}


def leaves_np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_jax_file_loads_into_the_port_structure(tmp_path, model):
    path = str(tmp_path / "j.npz")
    state = jax_state(model)
    jck.save_pytree(path, state)
    got = load_pytree(path, torch_like(model))
    got_leaves, _ = tck._flatten(got)
    want = leaves_np(state)
    assert len(got_leaves) == len(want)
    for a, b in zip(got_leaves, want):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)
    # the port's structure, its dict key order included
    assert list(got) == ["params", "opt", "step"]
    assert list(got["params"][0]) == list(torch_like(model)["params"][0])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_port_file_loads_into_the_jax_structure(tmp_path, model):
    path = str(tmp_path / "t.npz")
    state = jax_state(model)
    like_t = torch_like(model)
    leaves, _ = tck._flatten(like_t)
    src = tck._unflatten(like_t, [torch.from_numpy(np.array(a))
                                  for a in leaves_np(state)])
    save_pytree(path, src)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, state)
    restored = jck.load_pytree(path, zeros)
    for a, b in zip(leaves_np(restored), leaves_np(state)):
        np.testing.assert_array_equal(a, b)
    # and back into the port, bitwise
    back = load_pytree(path, like_t)
    for a, b in zip(tck._flatten(back)[0], leaves_np(state)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_key_paths_leaf_order_and_treedef_are_jax_s(tmp_path):
    """Key paths and leaf order are JAX's; the stored ``treedef`` is the
    fixed placeholder, which JAX does not compare in a file whose writer is
    not a JAX version."""
    P = collections.namedtuple("P", "x y")
    trees_j = [
        [{"w": jnp.ones((2, 3)), "b": jnp.zeros(3)},
         ({"a": jnp.ones(2)}, None), {"k": jnp.arange(3)}],
        {"z": P(jnp.ones(1), jnp.zeros(2)), "a": (jnp.ones(1),)},
    ]
    for i, tj in enumerate(trees_j):
        tt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                    tj)
        leaves, paths = tck._flatten(tt)
        assert paths == jck._key_paths(tj)
        for a, b in zip(leaves, leaves_np(tj)):
            np.testing.assert_array_equal(a.numpy(), b)
        path = str(tmp_path / f"{i}.npz")
        save_pytree(path, tt)
        with np.load(path) as data:
            meta = json.loads(data["__treedef__"].tobytes().decode())
        assert meta["treedef"] == tck.TREEDEF
        assert meta["jax_version"] == tck.WRITER != jax.__version__
        got = jck.load_pytree(path, tj)
        for a, b in zip(leaves_np(got), leaves_np(tj)):
            np.testing.assert_array_equal(a, b)


def test_dataclass_and_namedtuple_round_trip(tmp_path):
    @dataclasses.dataclass
    class State:
        params: list
        step: torch.Tensor

    P = collections.namedtuple("P", "lo hi")
    tree = {"s": State([{"w": torch.rand(3, 2)}], torch.tensor(4)),
            "r": P(torch.arange(5), torch.ones(2, dtype=torch.bool))}
    path = str(tmp_path / "s.npz")
    save_pytree(path, tree)
    like = {"s": State([{"w": torch.zeros(3, 2)}], torch.tensor(0)),
            "r": P(torch.zeros(5, dtype=torch.int64),
                   torch.zeros(2, dtype=torch.bool))}
    got = load_pytree(path, like)
    assert isinstance(got["s"], State) and isinstance(got["r"], P)
    assert torch.equal(got["s"].params[0]["w"], tree["s"].params[0]["w"])
    assert torch.equal(got["r"].hi, tree["r"].hi)
    assert got["s"].step.item() == 4
    assert tck._flatten(tree)[1] == ["['r'].lo", "['r'].hi",
                                     "['s'].params[0]['w']", "['s'].step"]


def mismatches_t():
    base = {"a": torch.zeros(4), "b": torch.zeros(3)}
    return base, [
        {"a": torch.zeros(4)},                                  # count
        {"a": torch.zeros(4), "b": torch.zeros(5)},             # shape
        {"a": torch.zeros(4), "b": torch.zeros(3,
                                               dtype=torch.int32)},  # dtype
        {"a": torch.zeros(4), "c": torch.zeros(3)},             # key name
        [torch.zeros(4), torch.zeros(3)],                       # key kind
    ]


def test_mismatches_raise_in_both_packages(tmp_path):
    base, wrong = mismatches_t()
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_pytree(tpath, base)
    jck.save_pytree(jpath, {"a": jnp.zeros(4), "b": jnp.zeros(3)})
    for like in wrong:
        for path in (tpath, jpath):  # the port refuses either file
            with pytest.raises(ValueError):
                load_pytree(path, like)
        like_j = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                        like)
        with pytest.raises(ValueError):  # and JAX refuses the port's
            jck.load_pytree(tpath, like_j)


def test_list_file_loads_into_a_tuple_target(tmp_path):
    """A tuple where a list was: the same key paths and signature, so both
    packages load the file, each into ``like``'s kind."""
    path = str(tmp_path / "t.npz")
    save_pytree(path, [torch.zeros(2), torch.ones(2)])
    got = load_pytree(path, (torch.zeros(2), torch.zeros(2)))
    assert isinstance(got, tuple) and torch.equal(got[1], torch.ones(2))
    got = jck.load_pytree(path, (jnp.zeros(2), jnp.zeros(2)))
    assert isinstance(got, tuple)
    np.testing.assert_array_equal(np.asarray(got[1]), np.ones(2))


def test_bfloat16_leaves_are_raw_words(tmp_path):
    """The choice pinned: a bfloat16 leaf is stored as its 2-byte words,
    dtype ``V2``, signature ``bfloat16``: the bytes ``mini_tpu`` writes for
    the same values.  The port reads them back bitwise from either
    package's file.  (``mini_tpu``'s own ``load_pytree`` cannot read a
    ``V2`` leaf back: its ``jnp.asarray`` raises TypeError.)"""
    vals = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    tt = {"w": torch.from_numpy(vals).to(torch.bfloat16),
          "b": torch.ones(2)}
    tj = {"w": jnp.asarray(vals).astype(jnp.bfloat16), "b": jnp.ones(2)}
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_pytree(tpath, tt)
    jck.save_pytree(jpath, tj)
    with np.load(tpath) as t, np.load(jpath) as j:
        assert t["leaf_1"].dtype == j["leaf_1"].dtype == np.dtype("V2")
        assert t["leaf_1"].tobytes() == j["leaf_1"].tobytes()
    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16), "b": torch.ones(2)}
    for path in (tpath, jpath):
        got = load_pytree(path, like)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16),
                           tt["w"].view(torch.int16))
    with pytest.raises(ValueError):  # a float32 target is a mismatch
        load_pytree(tpath, {"w": torch.zeros(3, 5), "b": torch.ones(2)})
    with pytest.raises(TypeError):
        jck.load_pytree(jpath, tj)


def test_leaves_take_the_target_s_dtype_and_device(tmp_path):
    path = str(tmp_path / "t.npz")
    state = [{"w": torch.rand(2, 2), "i": torch.arange(3, dtype=torch.int32)}]
    save_pytree(path, state)
    got = load_pytree(path, [{"w": torch.zeros(2, 2, device="cpu"),
                              "i": torch.zeros(3, dtype=torch.int32)}])
    assert got[0]["i"].dtype == torch.int32
    assert got[0]["w"].device == torch.device("cpu")
    assert torch.equal(got[0]["w"], state[0]["w"])
