"""Port parity of the driver entry point: ``mini_tpu_torch.entry.entry()``
builds ``__graft_entry__.entry()``'s flagship (the GCN [128, 128, 32]
forward over the undirected ER-2048 graph with m = 16384): the same graph
and features bitwise; with ``mini_tpu``'s params carried across
(``params_from_jax``) its ``fn`` gives ``jax.jit(fn)``'s logits within
rtol 1e-4, atol 1e-5 (tests/test_gcn.py's tolerance); with its own params
it matches the float64 oracle.  Without a card and without
``device="cpu"`` it raises."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mini_tpu_torch.entry import entry
from mini_tpu_torch.graph import erdos_renyi
from mini_tpu_torch.models.gcn import gcn_forward_cpu, params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def both():
    jfn, jargs = ge.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    return jargs, want, entry(device="cpu")


def test_same_inputs(both):
    (jparams, jgs, _, jx), _, (_, (params, gs, _, x)) = both
    assert (gs.n, gs.m, gs.n_pad, gs.m_pad) == (jgs.n, jgs.m, jgs.n_pad,
                                                jgs.m_pad)
    for f in ("row_offsets", "csr_dsts", "col_offsets", "csc_srcs"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(),
                                      np.asarray(getattr(jgs, f)))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert [{k: tuple(v.shape) for k, v in p.items()} for p in params] == [
        {k: v.shape for k, v in p.items()} for p in jparams]


def test_fn_matches_jax_with_its_params(both):
    (jparams, *_), want, (fn, (_, gs, norm, x)) = both
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    got = fn(params, gs, norm, x)
    assert got.shape == (2176, 32) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fn_with_its_own_params_matches_the_oracle(both):
    _, _, (fn, (params, gs, norm, x)) = both
    got = fn(params, gs, norm, x).numpy()
    assert np.isfinite(got).all()
    hg = erdos_renyi(2048, 16384, seed=0, undirected=True)
    params_np = [{k: v.numpy() for k, v in p.items()} for p in params]
    np.testing.assert_allclose(got[: hg.n],
                               gcn_forward_cpu(params_np, hg, x.numpy()),
                               **TOL)


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        entry()
