"""The device graph engine's build (`lancet_tpu_torch.gpu.dbg.build_k`, its
kernels those of `csrc/dbg.cu` behind `gpu.dbgk`) on the CPU, against the
JAX package.

- the port's `build_k` (on the CPU `build_k_plain`: the four plain stages
  composed) bit-equal to the JAX `tpu.dbg.build_k` on every crafted window
  of `gpu.buildcases` at bucket 0's shape and k 11, 31, 33, 61 and 63, and
  on the hub batch at D = HUB_D: every key, the mers as 128-bit values
  (masked to their 2K bits: the JAX build's empty groups hold all-ones
  words);
- the crafted windows reach what they are built for (past N, past E, the
  hub past D, the mate-overlap candidate, the palindromic self-loop, a
  pair whose two mers are past N);
- `window_sort_plain` against `numpy.lexsort` on seeded keys with ties,
  and a numpy replay of the kernel's network (tiles in shared memory, the
  strides past a tile through device memory) against it;
- the dispatch: the stage wrappers and `build_k` on the CPU run the plain
  versions with no launch, `build_plan` / `sort_plan` and their refusals,
  the mixed-device refusal, the payload bits against csrc/dbg.cu's.

The `cuda` test holds the kernels bit-equal to the plain versions, dtypes
too, on the crafted batches at every bucket's shape, thirteen launches a
build and no host sync.
"""

import contextlib
import functools
import os
import re

import numpy as np
import pytest
import torch

from lancet_tpu_torch.gpu import buildcases as bc
from lancet_tpu_torch.gpu import dbg, dbgk
from lancet_tpu_torch.gpu.pack import words_to_128

torch.set_num_threads(1)

R0, L0, N0, E0 = bc.BUCKETS[0]


@functools.lru_cache(maxsize=None)
def _batch(K, hub=False):
    if hub:
        return bc.hub_batch(K, R0, L0)
    return bc.batch(K, R0, L0, N0, E0)


def _mers_128(words, K, jax_words=False):
    """A build's mer words as 128-bit (hi, lo) halves masked to 2K bits."""
    if jax_words:
        w = [np.asarray(x).astype(np.uint64) for x in words]
        zero = np.zeros_like(w[0])
        lo = w[0] | ((w[1] if len(w) > 1 else zero) << np.uint64(32))
        hi = ((w[2] if len(w) > 2 else zero)
              | ((w[3] if len(w) > 3 else zero) << np.uint64(32)))
    else:
        hi, lo = words_to_128([m.numpy() for m in words], K)
    bits = 2 * K
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    mlo = full if bits >= 64 else np.uint64((1 << bits) - 1)
    mhi = np.uint64((1 << (bits - 64)) - 1) if bits > 64 else np.uint64(0)
    return hi & mhi, lo & mlo


def _jax_vs_port(arrs, K, D):
    from lancet_tpu.tpu import dbg as jdbg

    kw = dict(N=N0, E=E0, D=D, Lraw=bc.LRAW, **bc.SCALARS)
    jo = jdbg.build_k(K, *[arrs[f] for f in bc.FIELDS], **kw)
    po = dbg.build_k(K, *[torch.from_numpy(arrs[f]) for f in bc.FIELDS],
                     **kw)
    assert set(po) == set(dbg.BUILD_KEYS)
    for key in jo:
        if key in ("mers_w", "mers_hi", "mers_lo"):
            continue
        want = np.asarray(jo[key])
        got = po[key].numpy()
        assert want.shape == got.shape, (key, want.shape, got.shape)
        bad = want != got.astype(want.dtype)
        assert not bad.any(), (K, key, np.argwhere(bad)[:5])
    jh, jl = _mers_128(jo["mers_w"], K, jax_words=True)
    ph, pl = _mers_128(po["mers_w"], K)
    assert (jh == ph).all() and (jl == pl).all(), K
    return po


@pytest.mark.parametrize("K", bc.KS)
def test_build_equals_jax_on_crafted_windows(K):
    po = _jax_vs_port(_batch(K), K, bc.D_ENGINE)
    lane = bc.lane
    fb = po["fallback"].tolist()
    assert po["n_nodes"][lane("over_n")] == N0 and fb[lane("over_n")]
    assert fb[lane("over_e")]
    assert po["mate_cand"].tolist() == [i == lane("mate")
                                        for i in range(len(bc.LANES))]
    assert not fb[lane("off")] and not po["n_nodes"][lane("off")]
    assert not po["n_nodes"][lane("empty")]
    # the palindromic self-loop: one row, src == dst, dir FR or RF
    pal = lane("palindrome")
    loop = (po["edge_exists"][pal] & (po["edge_src"][pal]
                                      == po["edge_dst"][pal])
            & ((po["edge_dir"][pal] == 1) | (po["edge_dir"][pal] == 2)))
    assert loop.any()
    # a pair whose two mers are past N: its twin row leaves from N + 63
    src = po["edge_src"][lane("over_n")]
    assert (src == N0 + 63).any()


def test_build_equals_jax_small_k_over_e_alone():
    """At k 11 the over_e window stays within N: past E alone."""
    po = _jax_vs_port(_batch(11), 11, bc.D_ENGINE)
    w = bc.lane("over_e")
    assert po["n_nodes"][w] <= N0 and po["n_edges"][w] > E0


def test_build_equals_jax_on_the_hub():
    """The hub window at D = HUB_D: its mer's eight out-edges pass D."""
    po = _jax_vs_port(_batch(11, hub=True), 11, bc.HUB_D)
    assert po["fallback"].tolist() == [False, True]
    assert int(po["deg"][1].max()) == 8


# ---------------------------------------------------------------------------
# window_sort
# ---------------------------------------------------------------------------

def _seeded_keys(rng, NK, W, n, span):
    return torch.from_numpy(rng.integers(-span, span, (NK, W, n)))


@pytest.mark.parametrize("NK,n,span", [(1, 1, 3), (1, 37, 4), (2, 300, 3),
                                       (3, 1000, 2), (4, 513, 2),
                                       (1, 4096, 50)])
def test_window_sort_plain_equals_numpy_lexsort(NK, n, span):
    rng = np.random.default_rng([NK, n])
    keys = _seeded_keys(rng, NK, 3, n, span)
    got = dbg.window_sort_plain(keys)
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, n)
    k = keys.numpy()
    for w in range(3):
        want = np.lexsort(tuple(k[c, w] for c in reversed(range(NK))))
        assert np.array_equal(got[w].numpy(), want)


def _bitonic_replay(keys: np.ndarray, T: int) -> np.ndarray:
    """csrc/dbg.cu's window_sort network on one window [NK, n]: records
    (keys, index) padded to P with (INT64_MAX words, index); tiles of T
    sorted in the direction of their position, then each merge's strides
    >= T over the whole array and the rest tile by tile."""
    NK, n = keys.shape
    P = 1 << max(1, (n - 1).bit_length())
    rec = [tuple(int(keys[c, i]) if i < n else 2**63 - 1
                 for c in range(NK)) + (i,) for i in range(P)]

    def stage(k, j, lo, hi):
        for l in range(lo, hi):
            u = l ^ j
            if u > l and u < hi:
                asc = (l & k) == 0
                if (rec[l] > rec[u]) == asc:
                    rec[l], rec[u] = rec[u], rec[l]

    for t0 in range(0, P, T):
        k = 2
        while k <= T:
            j = k // 2
            while j >= 1:
                stage(k, j, t0, t0 + T)
                j //= 2
            k *= 2
    k = 2 * T
    while k <= P:
        j = k // 2
        while j >= T:
            stage(k, j, 0, P)
            j //= 2
        for t0 in range(0, P, T):
            j = T // 2
            while j >= 1:
                stage(k, j, t0, t0 + T)
                j //= 2
        k *= 2
    return np.array([r[-1] for r in rec[:n]])


@pytest.mark.parametrize("NK,n,T", [(1, 300, 8), (2, 77, 4), (4, 129, 2),
                                    (1, 64, 64)])
def test_window_sort_network_replay(NK, n, T):
    rng = np.random.default_rng([NK, n, T])
    keys = _seeded_keys(rng, NK, 2, n, 3)
    want = dbg.window_sort_plain(keys).numpy()
    for w in range(2):
        assert np.array_equal(_bitonic_replay(keys[:, w].numpy(), T),
                              want[w])


def test_sort_plan():
    p = dbgk.sort_plan(1, 10_000, 32)
    assert (p.P, p.T, p.scratch) == (16384, 16384, 0)
    p = dbgk.sort_plan(1, 118_626, 32)
    assert (p.P, p.T) == (131072, 16384) and p.smem <= dbgk.SORT_SMEM
    assert p.scratch == 32 * 131072 + 16 * 131072
    assert dbgk.sort_plan(4, 1, 1).P == 2
    for NK in range(1, 5):
        T = dbgk.sort_plan(NK, 1 << 20, 1).T
        assert dbgk.sort_smem(NK, T) <= dbgk.SORT_SMEM
        assert dbgk.sort_smem(NK, 2 * T) > dbgk.SORT_SMEM
    for bad in ((0, 5, 1), (5, 5, 1), (1, 0, 1), (1, 5, 0),
                (1, dbgk.MAX_SORT_N + 1, 1)):
        with pytest.raises(ValueError):
            dbgk.sort_plan(*bad)


# ---------------------------------------------------------------------------
# plans, dispatch and refusals
# ---------------------------------------------------------------------------

def test_build_plan_takes_every_engine_shape():
    for R, L, N, E in bc.BUCKETS:
        for K in range(11, 64, 2):
            for W in (8, 16, 32):
                p = dbgk.build_plan(K, W, R, L, bc.LRAW, N, E, bc.D_ENGINE)
                assert p.I == R * (L - K + 1) + 3 * (bc.LRAW - K + 1)
                assert len(p.sorts) == 6
                assert all(sp.smem <= dbgk.SORT_SMEM
                           for sp in p.sorts.values())
    p = dbgk.build_plan(11, 32, 768, 160, bc.LRAW, 4096, 10240, 12)
    assert p.I == 118_626 and p.sorts["mate"].NK == 2


@pytest.mark.parametrize("args", [
    (0, 4, 48, 160, 1152, 1536, 3840, 12),
    (64, 4, 48, 160, 1152, 1536, 3840, 12),
    (11, 0, 48, 160, 1152, 1536, 3840, 12),
    (11, 4, 0, 160, 1152, 1536, 3840, 12),
    (41, 4, 48, 40, 1152, 1536, 3840, 12),
    (41, 4, 48, 160, 40, 1536, 3840, 12),
    (11, 4, 48, 160, 1152, 0, 3840, 12),
    (11, 4, 48, 160, 1152, 1536, 0, 12),
    (11, 4, 48, 160, 1152, 1536, 3840, 0),
    (11, 4, 48, 160, 1152, 30_000, 3840, 12),
    (11, 4, 48, 160, 1152, 1536, 30_000, 12),
    (11, 1, 1 << 22, 160, 1152, 1536, 3840, 12),
])
def test_build_plan_refusals(args):
    with pytest.raises(ValueError):
        dbgk.build_plan(*args)


def _tensors(arrs):
    return [torch.from_numpy(arrs[f]) for f in bc.FIELDS]


def test_cpu_dispatch_runs_the_plain_stages():
    """On the CPU the stage wrappers are the plain stages, their
    composition build_k_plain, with no launch."""
    K = 31
    arrs = _batch(K)
    t = _tensors(arrs)
    kw = dict(N=N0, E=E0, D=bc.D_ENGINE, Lraw=bc.LRAW, **bc.SCALARS)
    dbgk.reset_launches()
    want = dbg.build_k_plain(K, *t, **kw)
    inst = dbgk.mer_instances(K, *t[:11], t[12], Lraw=bc.LRAW,
                              min_qual_call=bc.SCALARS["min_qual_call"])
    assert inst["keys"].shape == (1, len(bc.LANES), _plan(K).I)
    perm = dbgk.window_sort(inst["keys"])
    nodes = dbgk.node_tables(
        K, inst, perm, t[8], t[11], N=N0, R=R0, L=L0, Lraw=bc.LRAW,
        low_cov_threshold=bc.SCALARS["low_cov_threshold"],
        min_cov_ratio=bc.SCALARS["min_cov_ratio"])
    edges = dbgk.edge_tables(K, inst, nodes, t[12], R=R0, L=L0, N=N0, E=E0,
                             D=bc.D_ENGINE, Lraw=bc.LRAW)
    got = {**nodes, **edges}
    via = dbgk.build_k(K, *t, **kw)
    for k in dbg.BUILD_KEYS:
        for out in (got, via):
            a, b = out[k], want[k]
            if isinstance(b, tuple):
                assert all(torch.equal(x, y) for x, y in zip(a, b)), k
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), k
    assert want["mq"].dtype == torch.int32
    assert not any(dbgk.LAUNCHES.values())


def _plan(K):
    return dbgk.build_plan(K, len(bc.LANES), R0, L0, bc.LRAW, N0, E0,
                           bc.D_ENGINE)


def test_mixed_devices_are_refused():
    t = _tensors(_batch(11))
    kw = dict(N=N0, E=E0, D=bc.D_ENGINE, Lraw=bc.LRAW, **bc.SCALARS)
    mixed = list(t)
    mixed[1] = torch.empty(mixed[1].shape, dtype=mixed[1].dtype,
                           device="meta")
    with pytest.raises(ValueError, match="inputs lie on"):
        dbgk.build_k(11, *mixed, **kw)
    with pytest.raises(ValueError, match="inputs lie on"):
        dbgk.mer_instances(11, *mixed[:11], mixed[12], Lraw=bc.LRAW,
                           min_qual_call=1)
    keys = torch.zeros((1, 2, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="unsupported device"):
        dbgk.window_sort(keys.to("meta"))


def test_payload_bits_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(dbgk._SRC), "dbg.cu")).read()
    names = {"kValid": dbg.P_VALID, "kRead": dbg.P_READ, "kIdx": dbg.P_IDX,
             "kStrand": dbg.P_STRAND, "kTflag": dbg.P_TFLAG,
             "kIsF": dbg.P_ISF, "kPair": dbg.P_PAIR, "kTmr": dbg.P_TMR,
             "kNml": dbg.P_NML, "kRef": dbg.P_REF, "kOrder": dbg.P_ORDER}
    for name, bit in names.items():
        m = re.search(rf"\b{name} = (\d+)", src)
        assert m and int(m.group(1)) == bit, name
    assert len(re.findall(r"^__global__", src, re.M)) <= 4
    assert "cub::" not in src and "thrust::" not in src


def test_payload_fields():
    """mer_instances_plain's payload: times sign-extended, flags only
    where their part allows them."""
    K = 11
    t = _tensors(_batch(K))
    inst = dbg.mer_instances_plain(K, *t[:11], t[12], Lraw=bc.LRAW,
                                   min_qual_call=bc.SCALARS["min_qual_call"])
    pay = inst["pay"]
    p = _plan(K)
    read = dbg.pay_bit(pay, dbg.P_READ)
    valid = dbg.pay_bit(pay, dbg.P_VALID)
    assert not (read & ~valid).any()
    assert not dbg.pay_bit(pay[:, :p.IP], dbg.P_IDX).any()
    assert not dbg.pay_bit(pay[:, p.IP + p.Mraw:], dbg.P_READ).any()
    tm = dbg.pay_time(pay)
    assert (tm[~read] == dbg.BIG).all() and (tm[read] < 2 * p.I).all()
    assert (inst["keys"][:, ~valid] == dbg.SENT).all()
    assert (inst["qok"][:, p.IP:] == 0).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_sync():
    torch.cuda.set_sync_debug_mode("error")  # a host sync raises
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """build_k on the card bit-equal, dtypes too, to build_k_plain on the
    crafted batches at every bucket's shape (the hub at HUB_D), thirteen
    launches a build, no host sync."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for R, L, N, E in bc.BUCKETS:
        for K in (11, 33, 63):
            for arrs, D in ((bc.batch(K, R, L, N, E), bc.D_ENGINE),
                            (bc.hub_batch(K, R, L), bc.HUB_D)):
                before = dict(dbgk.LAUNCHES)
                got = bc.run(arrs, K, N, E, D, "cuda", guard=_no_sync)
                assert {k: dbgk.LAUNCHES[k] - before[k]
                        for k in before} == dbgk.BUILD_LAUNCHES
                want = bc.run(arrs, K, N, E, D, "cuda", plain=True)
                for k in dbg.BUILD_KEYS:
                    a, b = got[k], want[k]
                    if isinstance(b, tuple):
                        assert all(torch.equal(x, y) for x, y in zip(a, b))
                    else:
                        assert a.dtype == b.dtype and torch.equal(a, b), k
