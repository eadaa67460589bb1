"""Port parity: ``apply_fixed_perm`` (the permutation kernel's plain
version on the CPU) against ``mini_tpu.ops.permute.apply_fixed_perm`` and
against the Benes-butterfly oracle of ``scratch/probe_butterfly.py``; the
banded permutes and the composite pull-to-push rank against JAX's; the
composite rank's cache against graph eviction; and ``expand_to_edges``
and ``segmented_scan_reduce`` against JAX's on tests/test_engine.py's
cases (bitwise but for the float32 sum, a sum in another order: rtol
1e-5, that file's tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_tpu.graph as jg
from mini_tpu.graph import banded as jbanded
from mini_tpu.ops.permute import apply_fixed_perm as j_apply_fixed_perm
from mini_tpu.ops.permute import expand_to_edges as j_expand
from mini_tpu.ops.permute import segmented_scan_reduce as j_scan
import mini_tpu_torch.graph as tg
from mini_tpu_torch.graph import banded as tbanded
from mini_tpu_torch.ops.kernels import permute_kernel as kp
from mini_tpu_torch.ops.permute import (
    apply_fixed_perm,
    expand_to_edges,
    segmented_scan_reduce,
)

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


# -- the kernel's host side: records, the C entry's arguments ----------------

DTYPES = {"bool": torch.bool, "bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32, "f64": torch.float64, "i64": torch.int64}
JAX_DTYPES = ("bool", "bf16", "f16", "f32")  # JAX without x64 holds these


def payload(kind, m, seed):
    x = np.random.RandomState(seed).randn(m).astype(np.float32) * 100
    t = torch.from_numpy(x)
    if kind == "bool":
        return t > 0
    if kind == "i64":
        return t.long() << 33
    return t.to(DTYPES[kind])


def fake_permute_launch(rank_p, in_p, out_p, word, words, m, inverse,
                        stream):
    """``csrc/permute.cu``'s permute_launch in NumPy, reading and writing
    the host memory its pointers name: rows of ``words`` words of
    ``word`` bytes."""
    import ctypes

    def mem(ptr, n):
        return np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(ptr))

    assert word in (1, 2, 4, 8, 16) and in_p % word == 0 and out_p % word == 0
    rank = np.ctypeslib.as_array((ctypes.c_int32 * m).from_address(rank_p))
    rows = mem(in_p, m * word * words).reshape(m, -1)
    out = mem(out_p, rows.size).reshape(m, -1)
    if inverse:
        out[:] = rows[rank]
    else:
        out[rank] = rows
    return 0


def to_jax(kind, t):
    if kind == "bf16":
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.fixture
def emulated(monkeypatch):
    """The wrappers' CUDA path on CPU tensors, the C entry emulated."""
    from mini_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(kp, "_on_card", lambda rank, tensors, name: True)
    monkeypatch.setattr(kp, "_launch", fake_permute_launch)
    monkeypatch.setattr(_build, "stream", lambda device_index: 0)
    monkeypatch.setattr(kp, "launches", 0)


@pytest.mark.parametrize("kinds", [
    ["f32"], ["f32"] * 2, ["f32"] * 3, ["f32"] * 4, ["f32"] * 5,
    ["bool"] * 16, ["bf16"] * 8 + ["f16"], ["f64", "i64", "f64"],
    ["bool", "bf16", "f16", "f32", "f64", "i64"],
    ["bool", "bf16", "f32", "f64"] * 4,
])
def test_records_match_plain_and_jax(emulated, kinds):
    """Every mix of dtypes and P from 1 to 16 through the kernel's host
    side (one table, and one launch, per element size; the C entry's
    arguments; the outputs as columns of the tables) equals
    ``permute_plain``, and JAX's ``apply_fixed_perm`` for the dtypes JAX
    holds, bitwise, both ways."""
    m = 3001
    rank = np.random.RandomState(len(kinds)).permutation(m).astype(np.int32)
    inv = np.argsort(rank).astype(np.int32)
    r = torch.from_numpy(rank)
    pays = [payload(k, m, i) for i, k in enumerate(kinds)]
    n_tables = len({p.element_size() for p in pays})
    for inverse in (False, True):
        before = kp.launches
        got = kp.permute(r, pays, inverse=inverse)
        assert kp.launches - before == n_tables
        want = kp.permute_plain(r, pays, inverse=inverse)
        for k, a, b in zip(kinds, got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (k, inverse)
        jp = [(k, p) for k, p in zip(kinds, pays) if k in JAX_DTYPES]
        if jp:
            jr = jnp.asarray(inv if inverse else rank)
            js = j_apply_fixed_perm(jr, *[to_jax(k, p) for k, p in jp])
            js = js if isinstance(js, tuple) else (js,)
            outs = [a for k, a in zip(kinds, got) if k in JAX_DTYPES]
            for (k, _), a, b in zip(jp, outs, js):
                assert str(b.dtype) == {"bool": "bool", "bf16": "bfloat16",
                                        "f16": "float16",
                                        "f32": "float32"}[k]
                np.testing.assert_array_equal(a.float().numpy(),
                                              np.asarray(b, np.float32))


@pytest.mark.parametrize("P,dtype", [(1, torch.float32), (2, torch.float32),
                                     (3, torch.float32), (4, torch.float32),
                                     (8, torch.float32), (5, torch.bfloat16),
                                     (3, torch.uint8)])
def test_permute_rows_matches_plain(emulated, P, dtype):
    """``permute_rows`` on an ``[m, P]`` table (rows of 1 to 32 bytes, moved
    in their widest aligned words) equals its plain version both ways, and
    a forward with the inverse rank at hand is the same gather."""
    m = 2000
    rng = np.random.RandomState(P)
    rank = torch.from_numpy(rng.permutation(m).astype(np.int32))
    table = torch.from_numpy(rng.randn(m, P).astype(np.float32) * 50).to(
        dtype)
    for inverse in (False, True):
        got = kp.permute_rows(rank, table, inverse=inverse)
        assert torch.equal(got, kp.permute_rows_plain(rank, table, inverse))
    inv = torch.argsort(rank).to(torch.int32)
    assert torch.equal(kp.permute_rows(inv, table, inverse=True),
                       kp.permute_rows_plain(rank, table))
    assert kp.word_bytes(P * table.element_size(), 0) in (1, 2, 4, 8, 16)


def test_word_bytes():
    assert kp.word_bytes(16, 0, 256) == 16
    assert kp.word_bytes(12, 0, 256) == 4
    assert kp.word_bytes(32, 0, 8) == 8
    assert kp.word_bytes(6, 0) == 2
    assert kp.word_bytes(3, 0) == 1


@pytest.mark.parametrize("inverse,P", [(False, 1), (False, 3), (True, 1),
                                       (True, 3)])
def test_permute_rows_gradient(inverse, P):
    """The gradient of ``permute_rows`` is the permutation the other way,
    both directions gathers (by the rank or by its inverse), and equals
    JAX's VJP of ``apply_fixed_perm`` column by column."""
    from mini_tpu_torch.ops.permute import permute_rows

    m = 1500
    rng = np.random.RandomState(7)
    rank = rng.permutation(m).astype(np.int32)
    inv = np.argsort(rank).astype(np.int32)
    x = rng.randn(m, P).astype(np.float32)
    ct = rng.randn(m, P).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = permute_rows(torch.from_numpy(rank), xt, inverse=inverse,
                       rank_inv=torch.from_numpy(inv))
    (g,) = torch.autograd.grad(out, [xt], [torch.from_numpy(ct)])
    jr = jnp.asarray(inv if inverse else rank)
    def j_perm(*c):  # a tuple for every P (JAX gives one payload bare)
        out = j_apply_fixed_perm(jr, *c)
        return out if isinstance(out, tuple) else (out,)

    _, vjp = jax.vjp(j_perm, *[jnp.asarray(x[:, p]) for p in range(P)])
    want = vjp(tuple(jnp.asarray(ct[:, p]) for p in range(P)))
    for p in range(P):
        np.testing.assert_array_equal(g[:, p].numpy(), np.asarray(want[p]))
        np.testing.assert_array_equal(
            out[:, p].detach().numpy(),
            x[inv, p] if not inverse else x[rank, p])


@pytest.mark.parametrize("inverse", [False, True])
def test_path_permutes_are_gathers(emulated, monkeypatch, inverse):
    """``ops.permute.permute_rows``, the training paths' permutation,
    launches the kernel only as a gather (its inverse mode), forward and
    backward, and its result and gradient equal the plain version's."""
    from mini_tpu_torch.ops.permute import permute_rows

    modes = []

    def spy(*args):
        modes.append(args[6])
        return fake_permute_launch(*args)

    monkeypatch.setattr(kp, "_launch", spy)
    m = 1000
    rng = np.random.RandomState(11)
    rank = torch.from_numpy(rng.permutation(m).astype(np.int32))
    inv = torch.argsort(rank).to(torch.int32)
    x = torch.from_numpy(rng.randn(m, 4).astype(np.float32)).requires_grad_()
    ct = torch.from_numpy(rng.randn(m, 4).astype(np.float32))
    out = permute_rows(rank, x, inverse=inverse, rank_inv=inv)
    (g,) = torch.autograd.grad(out, [x], [ct])
    assert modes == [1, 1]
    assert torch.equal(out, kp.permute_rows_plain(rank, x.detach(), inverse))
    assert torch.equal(g, kp.permute_rows_plain(rank, ct, not inverse))


def test_composite_inverse_cached_with_rank(monkeypatch):
    """The composite rank's inverse is built with it on the host and
    cached under the same key."""
    small_bands(monkeypatch, 3)
    _, gt = pair(3)
    lt = [tbanded.get_layout(gt, d, row_bytes=512) for d in ("pull", "push")]
    comp = tbanded.get_pull_to_push_rank(gt, *lt)
    inv = tbanded.get_pull_to_push_rank(gt, *lt, inverse=True)
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(inv.numpy()[comp.numpy()],
                                  np.arange(comp.shape[0]))
    assert tbanded.get_pull_to_push_rank(gt, *lt, inverse=True) is inv


# --------------------------------------- tests/test_engine.py's movers
def engine_slices(seed):
    """tests/test_engine.py's ``_slice``: both packages' padded graphs."""
    def one(pkg, **kw):
        hg = pkg.erdos_renyi(150, 900, seed=seed, undirected=True,
                             weighted=True)
        return pkg.GraphSlice.from_host(hg, **kw)

    return one(jg), one(tg, device="cpu")


def both(jfn, tfn, j_args, t_args):
    """Each package's result, as numpy arrays."""
    return np.asarray(jfn(*j_args)), tfn(*t_args).numpy()


def assert_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", ["int_csr", "float_csc", "heads"])
def test_expand_to_edges_bitwise_jax(case):
    """test_engine.py's expansions: int32 by the CSR offsets, float32 with
    inf and -0.0 by the CSC offsets, and a trailing head axis, bitwise
    JAX's and the gather by the sorted segment ids."""
    seed = {"int_csr": 0, "float_csc": 1, "heads": 7}[case]
    jgs, tgs = engine_slices(seed)
    rng = np.random.RandomState(seed)
    if case == "int_csr":
        v = rng.randint(-(2**31), 2**31 - 1, jgs.n_pad).astype(np.int32)
        off, ids = "row_offsets", "csr_srcs"
    else:
        v = rng.randn(*((jgs.n_pad, 3) if case == "heads" else
                        (jgs.n_pad,))).astype(np.float32)
        v[::7] = np.inf
        v[3::11] = -0.0
        off, ids = "col_offsets", "csc_dsts"
    want, got = both(j_expand, expand_to_edges,
                     (jnp.asarray(v), getattr(jgs, off), jgs.m_pad),
                     (torch.from_numpy(v), getattr(tgs, off), tgs.m_pad))
    assert_bits(got, want)
    assert_bits(got, v[np.asarray(getattr(jgs, ids))])


def test_expand_to_edges_past_the_last_offset():
    """Slots past ``offsets[-1]`` and empty segments before them take the
    last segment that begins at or before the slot, as JAX's cumsum gives
    them."""
    off = np.array([0, 2, 2, 5, 5, 5], np.int32)  # 5 segments, 3 empty
    v = np.arange(10, 15, dtype=np.int32)
    want, got = both(j_expand, expand_to_edges,
                     (jnp.asarray(v), jnp.asarray(off), 8),
                     (torch.from_numpy(v), torch.from_numpy(off), 8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [10, 10, 12, 12, 12, 14, 14, 14])


def test_apply_fixed_perm_csr_to_csc_roundtrip():
    """test_engine.py's roundtrip: CSR to CSC order by the graph's rank,
    one payload and two sharing the permutation, bitwise JAX's."""
    jgs, tgs = engine_slices(2)
    vals = np.random.RandomState(2).rand(jgs.m_pad).astype(np.float32)
    want = np.asarray(j_apply_fixed_perm(jgs.csr_to_csc_rank,
                                         jnp.asarray(vals)))
    got = apply_fixed_perm(tgs.csr_to_csc_rank, torch.from_numpy(vals))
    assert_bits(got.numpy(), want)
    a, b = apply_fixed_perm(tgs.csr_to_csc_rank, torch.from_numpy(vals),
                            torch.from_numpy(vals * 2))
    np.testing.assert_array_equal(a.numpy() * 2, b.numpy())


SCAN_CASES = [  # (op, dtype, identity, trailing dims)
    ("min", np.int32, np.iinfo(np.int32).max, ()),
    ("max", np.int32, np.iinfo(np.int32).min, ()),
    ("sum", np.int32, 0, ()),
    ("bor", np.int32, 0, ()),
    ("min", np.int32, -7, ()),  # empty segments take a non-neutral identity
    ("max", np.float32, -np.inf, (4,)),
    ("min", np.float32, 3.0, (2, 5)),  # 10 columns: two launches
    ("bor", np.int32, 5, (3,)),
    ("sum", np.float32, 0.0, ()),
    ("sum", np.float32, 0.0, (4,)),
]


@pytest.mark.parametrize("op,dtype,identity,tail", SCAN_CASES)
def test_segmented_scan_reduce_matches_jax(op, dtype, identity, tail):
    """test_engine.py's segmented scans (min, max, the float sum, the
    batched [m, 4] max and sum) and JAX's ``bor``, plus int32 sums, a
    non-neutral identity for the empty segments (the pad vertices) and 10
    trailing columns: bitwise JAX's, but the float32 sum within rtol 1e-5
    of JAX's and of the float64 oracle; every column the one-column call
    bitwise."""
    jgs, tgs = engine_slices(5)
    rng = np.random.RandomState(5)
    shape = (jgs.m_pad,) + tail
    if dtype == np.int32:
        vals = rng.randint(0, 10000 if op != "bor" else 2**31 - 1,
                           shape).astype(np.int32)
    else:
        vals = rng.rand(*shape).astype(np.float32)
    ident = np.array(identity, dtype)
    want = np.asarray(j_scan(jnp.asarray(vals), jgs.csc_dsts,
                             jgs.col_offsets, op, jnp.asarray(ident)))
    got = segmented_scan_reduce(torch.from_numpy(vals), tgs.csc_dsts,
                                tgs.col_offsets, op, identity).numpy()
    assert got.shape == want.shape == (jgs.n_pad,) + tail
    assert got.dtype == want.dtype
    off = np.asarray(jgs.col_offsets)
    empty = off[1:] == off[:-1]
    assert empty.any() and (got[empty] == ident).all()
    if op == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5)
        ref = np.zeros((jgs.n_pad,) + tail)
        np.add.at(ref, np.asarray(jgs.csc_dsts), vals.astype(np.float64))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    flat, cols = vals.reshape(jgs.m_pad, -1), got.reshape(jgs.n_pad, -1)
    for k in range(flat.shape[1] if tail else 0):
        one = segmented_scan_reduce(
            torch.from_numpy(np.ascontiguousarray(flat[:, k])),
            tgs.csc_dsts, tgs.col_offsets, op, identity).numpy()
        np.testing.assert_array_equal(cols[:, k], one)


def test_segmented_scan_reduce_checks_its_arguments():
    """``max_seg_len`` is checked as ``bfs``'s caps are and changes
    nothing; a dtype the kernel does not take raises, on a CUDA tensor as
    on the CPU (no plain fallback on the card)."""
    from test_torch_gather import on_card

    jgs, tgs = engine_slices(5)
    vals = torch.from_numpy(np.random.RandomState(5).randint(
        0, 100, jgs.m_pad).astype(np.int32))
    args = (tgs.csc_dsts, tgs.col_offsets, "max", -1)
    ref = segmented_scan_reduce(vals, *args)
    assert torch.equal(segmented_scan_reduce(vals, *args, max_seg_len=3),
                       ref)
    with pytest.raises(ValueError):
        segmented_scan_reduce(vals, *args, max_seg_len=-1)
    with pytest.raises(TypeError):
        segmented_scan_reduce(vals, *args, max_seg_len=2.5)
    for wrap in (lambda t: t, on_card):
        with pytest.raises(TypeError, match="int32 or float32"):
            segmented_scan_reduce(wrap(vals.double()), *args)
