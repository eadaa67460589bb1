"""Port parity: ``apply_fixed_perm`` (the permutation kernel's plain
version on the CPU) against ``mini_tpu.ops.permute.apply_fixed_perm`` and
against the Benes-butterfly oracle of ``scratch/probe_butterfly.py``; the
banded permutes and the composite pull-to-push rank against JAX's; and
the composite rank's cache against graph eviction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.graph import banded as jbanded
from mini_tpu.ops.permute import apply_fixed_perm as j_apply_fixed_perm
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.ops.kernels import permute_kernel as kp
from mini_tpu_torch.ops.permute import apply_fixed_perm

SMALL_TABLE = 128 * 128 * 4  # 128-row bands: the 384-row graphs get K=3


def rank_and_payloads(m, seed=0):
    rng = np.random.RandomState(seed)
    rank = rng.permutation(m).astype(np.int32)
    f = [rng.randn(m).astype(np.float32) for _ in range(3)]
    i = [rng.randint(-2**31, 2**31 - 1, m, dtype=np.int64).astype(np.int32)
         for _ in range(2)]
    return rank, f, i


@pytest.mark.parametrize("kind", ["float32", "int32", "one"])
def test_matches_jax_bitwise(kind):
    rank, f, i = rank_and_payloads(5000)
    pay = {"float32": f, "int32": i, "one": f[:1]}[kind]
    want = j_apply_fixed_perm(jnp.asarray(rank), *map(jnp.asarray, pay))
    got = apply_fixed_perm(torch.from_numpy(rank),
                           *map(torch.from_numpy, pay))
    if kind == "one":  # one payload: a tensor, as in JAX
        want, got = (want,), (got,)
    assert len(got) == len(pay)
    for a, b, p in zip(want, got, pay):
        assert b.dtype == torch.from_numpy(p).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        out = np.empty_like(p)
        out[rank] = p
        np.testing.assert_array_equal(b.numpy(), out)


def test_gradient_matches_jax_vjp():
    """The gradient is the inverse permutation (``permute.py:110-134``)."""
    rank, f, _ = rank_and_payloads(4096, seed=1)
    cts = [np.random.RandomState(2).randn(4096).astype(np.float32)
           for _ in f]
    _, vjp = jax.vjp(lambda *p: j_apply_fixed_perm(jnp.asarray(rank), *p),
                     *map(jnp.asarray, f))
    want = vjp(tuple(map(jnp.asarray, cts)))
    xs = [torch.from_numpy(p).requires_grad_() for p in f]
    outs = apply_fixed_perm(torch.from_numpy(rank), *xs)
    got = torch.autograd.grad(outs, xs, [torch.from_numpy(c) for c in cts])
    for a, b, c in zip(want, got, cts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(b.numpy(), c[rank])


def test_inverse_is_transpose_and_checks():
    rank, f, i = rank_and_payloads(3000, seed=3)
    r = torch.from_numpy(rank)
    pays = [torch.from_numpy(p) for p in f + i]
    before = kp.launches
    fwd = kp.permute(r, pays)
    back = kp.permute(r, fwd, inverse=True)
    assert kp.launches == before  # the CPU path launches nothing
    for a, b in zip(back, pays):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        kp.permute(r.long(), pays)
    with pytest.raises(ValueError):
        kp.permute(r, [pays[0][:-1]])


def test_payloads_of_every_element_size():
    """Payloads of 1, 2, 4 and 8 bytes per element move together, each
    keeping its dtype and bits, both ways."""
    rank, f, _ = rank_and_payloads(2000, seed=4)
    r = torch.from_numpy(rank)
    base = torch.from_numpy(f[0])
    pays = [base > 0, base.to(torch.bfloat16), base.half(), base,
            base.double(), torch.arange(2000, dtype=torch.int64) * 2**40]
    fwd = kp.permute(r, pays)
    for p, o in zip(pays, fwd):
        assert o.dtype == p.dtype
        want = torch.empty_like(p)
        want[r.long()] = p
        assert torch.equal(o, want)
    for p, b in zip(pays, kp.permute(r, fwd, inverse=True)):
        assert torch.equal(b, p)


def butterfly(logm, seed=0):
    """``scratch/probe_butterfly.py:86-109`` at ``LOGM=logm`` with all
    ``2 logm - 1`` stages: the pair-consistent random switch masks, the
    stage oracle, and the input.  Not imported: the probe reads sys.argv
    and sets a JAX cache directory when it is imported."""
    m = 1 << logm
    strides = ([1 << j for j in range(logm - 1, -1, -1)]
               + [1 << j for j in range(1, logm)])
    rng = np.random.RandomState(seed)
    x = rng.rand(m).astype(np.float32)
    mask = np.zeros(m, np.int32)
    idx = np.arange(m)
    for j, s in enumerate(strides):
        bits = rng.randint(0, 2, m).astype(np.int32)
        mask |= bits[idx & ~s] << j  # both ends of a pair read one bit

    def oracle(v):
        v = v.copy()
        for j, s in enumerate(strides):
            swap = ((mask >> j) & 1) == 1
            v = np.where(swap, v[idx ^ s], v)
        return v

    return x, oracle, len(strides)


def test_matches_butterfly_oracle():
    """The Benes stages realize a fixed permutation; applied by its rank
    the port gives the oracle's output, bitwise."""
    x, oracle, n_stages = butterfly(10)
    assert n_stages == 19
    m = x.shape[0]
    src = oracle(np.arange(m)).astype(np.int64)  # out[i] = in[src[i]]
    assert np.array_equal(np.sort(src), np.arange(m))  # a permutation
    rank = np.empty(m, np.int32)
    rank[src] = np.arange(m)
    got = apply_fixed_perm(torch.from_numpy(rank), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), oracle(x))


def pair(bands, directed=True):
    kw = dict(seed=9, undirected=not directed, weighted=True)
    args = (300, 2500 if directed else 2400)
    return (jg.GraphSlice.from_host(jg.erdos_renyi(*args, **kw)),
            tg.GraphSlice.from_host(tg.erdos_renyi(*args, **kw), device="cpu"))


def small_bands(monkeypatch, bands):
    if bands == 3:
        monkeypatch.setattr(tbanded, "FAST_TABLE_BYTES", SMALL_TABLE)
        monkeypatch.setattr(jbanded, "FAST_TABLE_BYTES", SMALL_TABLE)


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("bands", [1, 3])
def test_composite_rank_matches_jax(monkeypatch, bands, directed):
    small_bands(monkeypatch, bands)
    gj, gt = pair(bands, directed)
    lj = [jbanded.get_layout(gj, d, row_bytes=512) for d in ("pull", "push")]
    lt = [tbanded.get_layout(gt, d, row_bytes=512) for d in ("pull", "push")]
    assert lt[0].K == bands
    want = np.asarray(jbanded.get_pull_to_push_rank(gj, *lj))
    got = tbanded.get_pull_to_push_rank(gt, *lt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # it carries each pull slot's edge to that edge's push slot
    eid_pull = np.concatenate(lt[0].eids)  # CSC position per pull slot
    eid_push = np.concatenate(lt[1].eids)  # CSR position per push slot
    csc_eids = gt.csc_eids.numpy()
    real = np.concatenate(lt[0].valid)
    slots = np.nonzero(real)[0]
    np.testing.assert_array_equal(
        eid_push[got.numpy()[slots]], csc_eids[eid_pull[slots]])
    assert tbanded.get_pull_to_push_rank(gt, *lt) is got  # cached


@pytest.mark.parametrize("H", [1, 3])
def test_permute_to_bands_multi_matches_jax(monkeypatch, H):
    small_bands(monkeypatch, 3)
    gj, gt = pair(3)
    lj = jbanded.get_layout(gj, "pull", row_bytes=512)
    lt = tbanded.get_layout(gt, "pull", row_bytes=512)
    cols = np.random.RandomState(H).randn(H, gt.m_pad).astype(np.float32)
    want = lj.permute_to_bands_multi(*map(jnp.asarray, cols))
    got = lt.permute_to_bands_multi(*map(torch.from_numpy, cols))
    assert len(got) == lt.K
    for a, b in zip(want, got):
        assert b.shape == (a.shape[0], H)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # and the way back, column by column
    for h in range(H):
        back = lt.permute_from_bands([b[:, h] for b in got])
        np.testing.assert_array_equal(back.numpy(), cols[h])


def test_composite_cache_dropped_with_its_graph():
    """Evicting a graph from the host cache (MAX_HOST_GRAPHS + 1
    registrations) drops its composite rank too; JAX's
    ``_COMPOSITE_CACHE`` keeps it (a known fault of the reference)."""
    g0 = tg.GraphSlice.from_host(tg.erdos_renyi(200, 900, seed=100),
                                 device="cpu")
    lp = tbanded.get_layout(g0, "pull", row_bytes=512)
    lb = tbanded.get_layout(g0, "push", row_bytes=512)
    assert tbanded.get_pull_to_push_rank(g0, lp, lb) is not None
    mine = [k for k in tbanded._COMPOSITE_CACHE if k[0] == g0.fingerprint]
    assert mine
    for s in range(tbanded.MAX_HOST_GRAPHS):
        tg.GraphSlice.from_host(tg.erdos_renyi(200, 900, seed=101 + s),
                                device="cpu")
    assert g0.fingerprint not in tbanded._HOST_CACHE
    assert not any(k in tbanded._COMPOSITE_CACHE for k in mine)
    assert not any(k[0] == g0.fingerprint for k in tbanded._LAYOUT_CACHE)
    assert tbanded.get_pull_to_push_rank(g0, lp, lb) is None
