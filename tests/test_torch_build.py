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
  and a numpy replay of the kernel's radix sort (the declared ranges and
  sentinels, each tile's digit counts, the offsets in the window, the
  ranks by warp) against it; a numpy replay of `mer_instances` (the bit
  strings, the read tiles' counts before the stream positions, the
  reference tiles) against `mer_instances_plain`; numpy replays of
  `node_tables` and `edge_tables` (tiles of sorted positions: each tile's
  group starts and head, the groups numbered from the earlier tiles'
  counts, least times across tile edges; the quality bits' ballot counts)
  against `node_tables_plain` and `edge_tables_plain`, also at exactly N +
  1 and E + 1 groups and with the sorts' ties reversed;
- the dispatch: the stage wrappers and `build_k` on the CPU run the plain
  versions with no launch, `build_plan` / `sort_plan` and their refusals,
  the mixed-device refusal, the payload bits against csrc/dbg.cu's.

The `cuda` tests hold the kernels bit-equal to the plain versions, dtypes
too, on the crafted batches at every bucket's shape with the plan's
launches a build and no host sync, and window_sort on generic keys and
mer_instances alone.
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


def _radix_replay(keys: np.ndarray, words, tile: int) -> np.ndarray:
    """csrc/dbg.cu's window_sort on keys [NK, W, n]: each word mapped into
    its declared range (lo, bits, sent), the sentinel to 2^bits, the
    records' keys the mapped words side by side (word 0 most
    significant); then a pass for each 8 bits: each tile's digit counts,
    a digit's offset in the window (the totals' exclusive sums over the
    digits plus the earlier tiles' counts), each warp's records (32 x 8 a
    warp) ranked by digit after the earlier warps' counts, every record
    to its offset plus its place among the tile's records of its digit."""
    NK, W, n = keys.shape
    B = sum(b + (s is not None) for _, b, s in words)
    P, T, S = (B + 7) // 8, -(-n // tile), 32 * 8
    perm = np.zeros((W, n), np.int64)
    for w in range(W):
        recs = []
        for i in range(n):
            key = 0
            for c, (lo, bits, sent) in enumerate(words):
                v = int(keys[c, w, i])
                u = 1 << bits if sent is not None and v == sent else \
                    (v - lo) % (1 << 64)
                key = (key << (bits + (sent is not None))) | u
            recs.append((key, i))
        for p in range(P):
            dig = [(k >> (8 * p)) & 255 for k, _ in recs]
            cnt = np.zeros((T, 256), np.int64)
            for j, d in enumerate(dig):
                cnt[j // tile, d] += 1
            base = np.concatenate([[0], np.cumsum(cnt.sum(0))[:-1]])
            goff = base + np.cumsum(cnt, 0) - cnt  # earlier tiles' counts
            out = [None] * n
            for t in range(T):
                idx = range(t * tile, min(n, (t + 1) * tile))
                tcnt = cnt[t]
                tst = np.concatenate([[0], np.cumsum(tcnt)[:-1]])
                whist = np.zeros(256, np.int64)  # the earlier warps'
                for w0 in range(t * tile, idx.stop, S):
                    seen = np.zeros(256, np.int64)
                    for j in range(w0, min(idx.stop, w0 + S)):
                        d = dig[j]
                        pos = tst[d] + whist[d] + seen[d]
                        seen[d] += 1
                        out[goff[t, d] + pos - tst[d]] = recs[j]
                    whist += seen
            recs = out
        perm[w] = [i for _, i in recs]
    return perm


_SENTS = {"SENT": dbg.SENT, "BIG": dbg.BIG, "I32": dbgk.I32_MAX}


@pytest.mark.parametrize("case", [
    # NK, n, tile, words: a build-like instance word (2 bits a base of 11,
    # SENT), one tile and several
    (1, 1000, 256, ((0, 22, "SENT"),)),
    # times from -1 with BIG, n not a power of two, two warps a tile
    (1, 777, 512, ((-1, 17, "BIG"),)),
    # generic full-width words with negative values and the extremes
    (2, 600, 256, (dbgk.GENERIC, dbgk.GENERIC)),
    # the mate sort's words at k 33 (two mer words and a fragment)
    (3, 300, 256, ((0, 4, "SENT"), (0, 62, "SENT"), (-(1 << 31), 32, None))),
    # pair keys from below 0 with I32_MAX, one tile
    (1, 200, 256, ((-6404, 24, "I32"),)),
])
def test_window_sort_radix_replay(case):
    NK, n, tile, words = case
    words = tuple((lo, b, _SENTS.get(s, s)) for lo, b, s in words)
    rng = np.random.default_rng([NK, n, tile])
    k = np.zeros((NK, 2, n), np.int64)
    for c, (lo, b, s) in enumerate(words):
        if b == 64:
            v = rng.integers(-4, 4, (2, n)) * (1 << 61)
            v[:, ::5] = rng.integers(-(1 << 63), (1 << 63) - 1,
                                     (2, len(range(0, n, 5))))
            v[0, :2] = (-(1 << 63), (1 << 63) - 1)
        else:  # few values, ties; the range's ends; the sentinel
            v = lo + rng.integers(0, 6, (2, n)) * (((1 << b) - 1) // 5)
            if s is not None:
                v[rng.random((2, n)) < 0.2] = s
        k[c] = v
    sp = dbgk.sort_plan(NK, n, 2, words)
    assert sp.T == -(-n // dbgk.SORT_TILE) and sp.B == sum(
        b + (s is not None) for _, b, s in words)
    want = dbg.window_sort_plain(torch.from_numpy(k)).numpy()
    assert np.array_equal(_radix_replay(k, words, tile), want)


@pytest.mark.parametrize("K", bc.KS)
def test_build_sort_keys_lie_in_their_declared_ranges(K, monkeypatch):
    """Every key word of the six sorts of build_k_plain on the crafted
    windows (and the hub) lies in the range build_plan declares for it
    (lo + [0, 2^bits) or its sentinel): the radix sort's mapping keeps
    the order of exactly these values."""
    seen = []
    real = dbg.window_sort_plain

    def capture(keys):
        seen.append(keys.clone())
        return real(keys)

    monkeypatch.setattr(dbg, "window_sort_plain", capture)
    for arrs, D in ((_batch(K), bc.D_ENGINE), (_batch(K, hub=True),
                                               bc.HUB_D)):
        seen.clear()
        W = len(arrs["rlen"])
        dbg.build_k_plain(K, *_tensors(arrs), N=N0, E=E0, D=D, Lraw=bc.LRAW,
                          **bc.SCALARS)
        p = dbgk.build_plan(K, W, R0, L0, bc.LRAW, N0, E0, D)
        assert len(seen) == 6
        for keys, (name, sp) in zip(seen, p.sorts.items()):
            assert tuple(keys.shape) == (sp.NK, W, sp.n), name
            for c, (lo, bits, sent) in enumerate(sp.words):
                k = keys[c]
                inside = (k >= lo) & (k - lo < 2 ** bits if bits < 63
                                      else torch.ones_like(k, dtype=bool))
                if sent is not None:
                    inside |= k == sent
                assert inside.all(), (K, name, c, k[~inside][:5])


def test_sort_plan():
    # the largest case 1 call: W 32, k 11, bucket 2
    p = dbgk.build_plan(11, 32, 512, 112, 1152, 4096, 10240, 12)
    got = {k: (s.NK, s.B, s.NL, s.P, s.T, s.launches)
           for k, s in p.sorts.items()}
    assert got == {"inst": (1, 23, 1, 3, 14, 6), "node": (1, 18, 1, 3, 1, 1),
                   "pair": (1, 28, 1, 4, 14, 8), "time": (1, 18, 1, 3, 5, 6),
                   "adj": (1, 14, 1, 2, 3, 4), "mate": (2, 55, 2, 7, 13, 14)}
    assert p.I == 55_650 and (p.TR, p.TF) == (26, 3)
    assert p.launches == {"mer_instances": 2, "window_sort": 39,
                          "node_tables": 3, "edge_tables": 5}
    # node_tables: 28 tiles of 2,048 sorted instances, 128 blocks of 32
    # creation slots a window; edge_tables: 27 tiles of pair keys, 5 of
    # rows, 1 reference tile and 26 mate tiles a window, and the
    # adjacency block's [N + 64] first slots and counts and [E] sources
    assert (p.T, p.SL, p.TN, p.NB) == (2048, 32, 28, 128)
    assert (p.TPu, p.TE, p.TJ, p.TM) == (27, 5, 1, 26)
    assert p.edge_smem == 2 * 4 * 4160 + 4 * 10240 <= dbgk.SMEM_LIMIT
    s = p.sorts["inst"]
    assert s.scratch == (2 * 32 * 2 * 55_650 + 32 * 14 * 256 + 1) // 2
    assert s.smem == 4 * (16 * 256 + 512 + 4096 * 2) <= dbgk.SMEM_LIMIT
    # passes and launches at each bucket and at k 11, 33 and 63
    for R, L, N, E in bc.BUCKETS:
        for K in (11, 33, 63):
            p = dbgk.build_plan(K, 32, R, L, bc.LRAW, N, E, bc.D_ENGINE)
            NW = p.NW
            mer = [2 * (K - 31 * (NW - 1)) + 1] + [63] * (NW - 1)
            assert p.sorts["inst"].B == sum(mer)
            assert p.sorts["mate"].B == sum(mer) + 32
            for k, s in p.sorts.items():
                assert s.P == -(-s.B // 8) and s.tile == dbgk.SORT_TILE
                assert s.launches == (1 if s.T == 1 else 2 * s.P)
                assert (s.scratch == 0) == (s.T == 1)
                assert s.smem <= dbgk.SMEM_LIMIT
            assert p.launches["window_sort"] == sum(
                s.launches for s in p.sorts.values())
            assert p.TR == -(-R * (L - K + 1) // dbgk.INST_TILE)
    # the largest scratch a build allocates: bucket 3, k 63, the instance
    # sort's records (six key lanes) and counts, 141 MB
    p = dbgk.build_plan(63, 32, 768, 160, bc.LRAW, 4096, 10240, 12)
    big = max(s.scratch for s in p.sorts.values())
    assert p.sorts["inst"].scratch == big and p.sorts["inst"].NL == 6
    assert 8 * big == 8 * ((2 * 32 * 7 * 78_534 + 32 * 20 * 256 + 1) // 2)
    # any n, a power of two or not; generic words take 64 bits each
    assert dbgk.sort_plan(1, 1, 1).launches == 1
    g = dbgk.sort_plan(4, 5000, 2)
    assert (g.B, g.NL, g.P, g.T, g.launches) == (256, 8, 32, 2, 64)
    for bad in ((0, 5, 1), (5, 5, 1), (1, 0, 1), (1, 5, 0),
                (1, dbgk.MAX_SORT_N + 1, 1)):
        with pytest.raises(ValueError):
            dbgk.sort_plan(*bad)
    for words in (((0, 0, None),), ((0, 64, 5),), ((0, 65, None),),
                  ((0, 8, None), (0, 8, None))):
        with pytest.raises(ValueError):
            dbgk.sort_plan(1, 10, 1, words)


_U64 = np.uint64


def _spread16(x):
    x = x & 0xFFFF
    for s, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                 (1, 0x55555555)):
        x = (x | (x << s)) & m
    return x


def _stage(b, q, minq):
    """csrc/dbg.cu's stage_seqs on rows [S, n] of bases (and qualities, or
    None): each chunk of 32 positions a warp's four ballots, the 2-bit
    codes spread from two of them. Returns the code, bad-base and
    bad-quality strings, uint64 arrays of 32-bit words, each with its two
    words of padding."""
    S, n = b.shape
    nc = -(-n // 32)
    bv = np.zeros((S, 32 * nc), np.int64)
    bv[:, :n] = b
    qb = np.zeros((S, 32 * nc), bool)
    if q is not None:
        qb[:, :n] = q.astype(np.int64) < minq
    lane = np.arange(32, dtype=np.int64)

    def ballot(pred):
        return (pred.reshape(S, nc, 32).astype(np.int64) << lane).sum(-1)

    lo, hi = ballot(bv & 1), ballot((bv >> 1) & 1)
    code = np.zeros((S, 2 * nc + 2), np.int64)
    code[:, 0:2 * nc:2] = _spread16(lo) | (_spread16(hi) << 1)
    code[:, 1:2 * nc:2] = _spread16(lo >> 16) | (_spread16(hi >> 16) << 1)
    pad = np.zeros((S, 2), np.int64)
    return tuple(x.astype(_U64) for x in (
        code, np.concatenate([ballot(bv >= 4), pad], 1),
        np.concatenate([ballot(qb), pad], 1)))


def _ext(s, row, off, n):
    """csrc ext: bits [off, off + n) of rows `row` of the strings s."""
    off = np.asarray(off, np.int64)
    i, sh = off >> 5, (off & 31).astype(_U64)
    v = (s[row, i] | (s[row, i + 1] << _U64(32))) >> sh
    v |= np.where(sh > 0, s[row, i + 2] << (_U64(64) - np.maximum(sh, 1)),
                  _U64(0))
    n = np.asarray(n, np.int64)
    mask = np.where(n >= 64, _U64(2**64 - 1),
                    (_U64(1) << np.minimum(n, 63).astype(_U64)) - _U64(1))
    return v & mask


def _brev(x):
    r = np.zeros_like(x)
    for i in range(64):
        r |= ((x >> _U64(i)) & _U64(1)) << _U64(63 - i)
    return r


def _mer_words(code, bad, row, m, K, NW):
    """csrc mer_words: the forward and reverse-complement words and the
    bases' check, a few extractions a mer."""
    f, r = [], []
    for i in range(NW):
        lo, hi = max(K - 31 * (NW - i), 0), K - 31 * (NW - 1 - i)
        x = _brev(_ext(code, row, 2 * (m + lo), 2 * (hi - lo)))
        x = ((x >> _U64(1)) & _U64(0x5555555555555555)) | (
            (x & _U64(0x5555555555555555)) << _U64(1))
        f.append((x >> _U64(64 - 2 * (hi - lo))).astype(np.int64))
        rlo = 31 * (NW - 1 - i)
        nb = min(31 * (NW - i), K) - rlo
        r.append((_ext(code, row, 2 * (m + rlo), 2 * nb)
                  ^ _U64((1 << (2 * nb)) - 1)).astype(np.int64))
    lt, eq = np.zeros(len(m), bool), np.ones(len(m), bool)
    for a, b in zip(f, r):
        lt |= eq & (a < b)
        eq &= a == b
    return f, r, lt, _ext(bad, row, m, K) == 0


def _instances_replay(arrs, K, TQ, RQ, minq):
    """csrc/dbg.cu's mer_instances in numpy: the reads and the reference
    staged as bit strings; each read tile of TQ instances counts its valid
    ones (launch 1); an instance's stream position g is the earlier
    tiles' counts plus its place among the tile's valid ones, and a
    reference tile's times start at the window's total (launch 2)."""
    b, q = arrs["bases"], arrs["quals"]
    W, R, L = b.shape
    Lraw = arrs["raw"].shape[1]
    NW, M, Mraw = (K + 30) // 31, L - K + 1, Lraw - K + 1
    RM, I = R * M, R * M + 3 * (Lraw - K + 1)
    code, bad, qbad = _stage(b.reshape(W * R, L), q.reshape(W * R, L), minq)
    wq = np.repeat(np.arange(W), RM)
    qq = np.tile(np.arange(RM), W)
    rr, m = qq // M, qq % M
    row = wq * R + rr
    f, r, isF, bok = _mer_words(code, bad, row, m, K, NW)
    rl = arrs["rlen"].reshape(-1)[row].astype(np.int64)
    n_mers = np.maximum(rl - K + 1, 0)
    use = rl - K > 0
    valid = use & (m < n_mers) & bok
    last = m == n_mers - 1
    qf = ~_ext(qbad, row, m, K) & _U64((1 << K) - 1)
    qr = _brev(qf) >> _U64(64 - K)
    qb_pair = _ext(qbad, row, m, K + 1) != 0
    mp = np.maximum(m - 1, 0)
    qb_prev = np.where(m >= 1, _ext(qbad, row, mp, K + 1),
                       _ext(qbad, row, mp, K)) != 0
    bad_prev = np.where(m >= 1, _ext(bad, row, mp, K),
                        _ext(bad, row, mp, K - 1)) != 0
    samp = arrs["rsample"].reshape(-1)[row].astype(np.int64)
    order = arrs["rorder"].reshape(-1)[row].astype(np.int64)
    pair_ok = (m < L - K) & ~qb_pair & (samp == 0) & ~last & valid
    prev_ok = ((m >= 1) & ~qb_prev & (samp == 0) & (m - 1 != n_mers - 1)
               & use & (m - 1 < n_mers) & ~bad_prev)
    # launch 1: each tile's count; launch 2: g from the counts and a scan
    TR = -(-RM // TQ)
    v = valid.reshape(W, RM)
    cnt = np.stack([v[:, t * TQ:(t + 1) * TQ].sum(1) for t in range(TR)], 1)
    g = np.zeros((W, RM), np.int64)
    for t in range(TR):
        blk = v[:, t * TQ:(t + 1) * TQ].astype(np.int64)
        g[:, t * TQ:(t + 1) * TQ] = (cnt[:, :t].sum(1)[:, None]
                                     + np.cumsum(blk, 1) - blk)
    g = g.reshape(-1)
    okW = arrs["window_ok"][wq].astype(bool)
    isread = valid & okW
    paired = (order > 0) & valid
    tm = np.where(isread, 2 * g - (m > 0), dbg.BIG) & 0xFFFFFFFF
    bits = ((isread, dbg.P_VALID), (isread, dbg.P_READ),
            (arrs["rstrand"].reshape(-1)[row] != 0, dbg.P_STRAND),
            (pair_ok | prev_ok, dbg.P_TFLAG), (isF, dbg.P_ISF),
            (valid & ~last & okW, dbg.P_PAIR), (samp == 0, dbg.P_TMR),
            (samp == 1, dbg.P_NML), (samp == 2, dbg.P_REF))
    pv = tm
    for x, bt in bits:
        pv = pv | (x.astype(np.int64) << bt)
    pv = pv | (np.where(paired, order, 0) << dbg.P_ORDER)
    mw = [np.where(isF, a, c) for a, c in zip(f, r)]
    out = {"keys": np.zeros((NW, W, I), np.int64),
           "pay": np.zeros((W, I), np.int64),
           "qok": np.zeros((W, I), np.int64),
           "fkeys": np.zeros((NW + 1, W, RM), np.int64)}
    out["pay"][:, :RM] = pv.reshape(W, RM)
    out["qok"][:, :RM] = np.where(isF, qf, qr).astype(np.int64).reshape(
        W, RM)
    for i in range(NW):
        out["keys"][i, :, :RM] = np.where(isread, mw[i], dbg.SENT).reshape(
            W, RM)
        out["fkeys"][i] = np.where(paired, mw[i], dbg.SENT).reshape(W, RM)
    out["fkeys"][NW] = np.where(paired, arrs["rfrag"].reshape(-1)[row],
                                dbgk.I32_MAX).reshape(W, RM)
    # the reference tiles of RQ offsets, times after the window's total
    pcode, pbad, _ = _stage(arrs["raw"], None, 0)
    total = cnt.sum(1)
    for t in range(-(-Mraw // RQ)):
        ro = np.arange(t * RQ, min((t + 1) * RQ, Mraw))
        for w in range(W):
            wr = np.full(len(ro), w)
            pf, prc, pisF, pok = _mer_words(pcode, pbad, wr, ro, K, NW)
            rawlen = int(arrs["rawlen"][w])
            nm = max(rawlen - K + 1, 0)
            ok = bool(arrs["window_ok"][w])
            rv = (ro < nm) & pok & (rawlen - K > 0) & ok
            tr = 2 * (total[w] + ro) - (ro > 0)
            pv = np.where(rv, tr, dbg.BIG) & 0xFFFFFFFF
            pv |= (rv.astype(np.int64) << dbg.P_VALID) | (
                rv.astype(np.int64) << dbg.P_READ) | (
                pisF.astype(np.int64) << dbg.P_ISF) | (
                (rv & (ro != nm - 1)).astype(np.int64) << dbg.P_PAIR) | (
                1 << dbg.P_REF)
            pv_ok = (ro < rawlen - K + 1) & pok & ok
            ipos = int(arrs["seq_off"][w]) + ro
            ip = np.clip(ipos, 0, Mraw - 1)
            fi, ri, iisF, iok = _mer_words(pcode, pbad, wr, ip, K, NW)
            iv = (ro < int(arrs["seq_len"][w]) - K) & (ipos < Mraw) & iok & ok
            out["pay"][w, RM + ro] = pv
            out["pay"][w, RM + Mraw + ro] = dbg.BIG | (
                pv_ok.astype(np.int64) << dbg.P_VALID) | (
                pisF.astype(np.int64) << dbg.P_ISF)
            out["pay"][w, RM + 2 * Mraw + ro] = dbg.BIG | (
                iv.astype(np.int64) << dbg.P_VALID) | (
                iv.astype(np.int64) << dbg.P_IDX)
            for i in range(NW):
                pw = np.where(pisF, pf[i], prc[i])
                iw = np.where(iisF, fi[i], ri[i])
                out["keys"][i, w, RM + ro] = np.where(rv, pw, dbg.SENT)
                out["keys"][i, w, RM + Mraw + ro] = np.where(pv_ok, pw,
                                                             dbg.SENT)
                out["keys"][i, w, RM + 2 * Mraw + ro] = np.where(
                    iv, iw, dbg.SENT)
    return out, cnt


@pytest.mark.parametrize("K,TQ,RQ", [(11, 100, 300), (33, 2048, 512),
                                     (63, 37, 128)])
def test_mer_instances_tile_replay(K, TQ, RQ):
    """The kernel's bit strings, its read tiles (TQ 100 and 37 cut reads of
    150 and 98 mers) with each tile's count before the stream positions,
    and its reference tiles, bit-equal to mer_instances_plain."""
    arrs = _batch(K)
    minq = bc.SCALARS["min_qual_call"]
    got, cnt = _instances_replay(arrs, K, TQ, RQ, minq)
    t = _tensors(arrs)
    want = dbg.mer_instances_plain(K, *t[:11], t[12], Lraw=bc.LRAW,
                                   min_qual_call=minq)
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy()), (K, k)
    assert cnt.shape[1] == -(-R0 * (L0 - K + 1) // TQ)
    assert TQ == 2048 or cnt.shape[1] > 1
    assert cnt.sum() > 0


_POP16 = np.array([bin(i).count("1") for i in range(1 << 16)], np.int64)


def _popc(x):
    x = np.asarray(x, np.int64)
    return _POP16[x & 0xFFFF] + _POP16[(x >> 16) & 0xFFFF]


def _ballots(pred, chunk):
    """A warp's ballot of each chunk of 32 positions: pred [n] and each
    position's chunk (chunks of consecutive positions, lane i of a chunk
    its i-th) -> [chunk.max() + 1] 32-bit masks, lane i bit i."""
    nch = int(chunk.max()) + 1 if len(chunk) else 0
    start = np.searchsorted(chunk, chunk, "left")
    lane = np.arange(len(chunk)) - start
    return np.bincount(chunk, weights=pred.astype(np.int64) << lane,
                       minlength=nch).astype(np.int64), lane


def _tile_scan(f):
    """csrc tile_scan on each tile's flags f [tiles, T] (a tile's
    positions in order: warp chunks of 32): each chunk's ballot total,
    exclusive-summed in order, plus the popcount of the chunk's ballot
    below each lane. Returns each position's count of set flags ahead of
    it in its tile [tiles, T] and each tile's total [tiles]."""
    nt, T = f.shape
    col = np.arange(T)
    chunk = (np.arange(nt)[:, None] * (-(-T // 32)) + col // 32).ravel()
    m, lane = _ballots(f.ravel(), chunk)
    pm = _popc(m).reshape(nt, -1)
    run = np.cumsum(pm, 1) - pm
    below = _popc(m[chunk] & ((1 << lane) - 1)).reshape(nt, T)
    return run[:, col // 32] + below, pm.sum(1)


def _tile_groups(start, live, t_vals, T, cap):
    """Phase 0's two launches (node_tables' groups, edge_tables' canonical
    groups) on one window's sorted positions in tiles of T: start[p] a
    group's first position, live[p] a position of some group, t_vals [V,
    n] its time lanes. Launch 1: each tile's count of starts and its head
    (the least time of each lane over its live positions ahead of its
    first start). Launch 2: a group's number is the earlier tiles' counts
    plus its tile scan; its least times by tile (shared minima), the last
    group of a tile's with the heads of the tiles it runs into, up to the
    first that holds a start. Returns (first position [min(total, cap +
    1)], least times [V, min(total, cap)], total, the most tiles a group
    spans)."""
    n, V = len(start), len(t_vals)
    nt = -(-n // T)
    pad = nt * T - n

    def tiled(a, fill):
        return np.concatenate([a, np.full(a.shape[:-1] + (pad,), fill,
                                          a.dtype)], -1).reshape(
            a.shape[:-1] + (nt, T))

    st, lv, tv = tiled(start, False), tiled(live, False), tiled(t_vals, 0)
    # launch 1: the counts and the heads
    before, cnt = _tile_scan(st)
    h = lv & (before + st == 0)
    inf = np.int64(1) << 62
    head = np.where(h, tv, inf).min(-1)  # [V, tiles]; inf: no head
    total = int(cnt.sum())
    # launch 2: the groups
    carry = np.cumsum(cnt) - cnt
    lo = before + st - 1  # -1: the head
    g = carry[:, None] + lo
    pos = np.arange(nt * T).reshape(nt, T)
    s = st & (g <= cap)
    first = np.full(min(total, cap + 1), -1, np.int64)
    first[g[s]] = pos[s]
    gt = np.unique(np.stack([g[lv], np.nonzero(lv)[0]]), axis=1)[0]
    span = int(np.bincount(gt - gt.min()).max()) if len(gt) else 0
    m = lv & (lo >= 0)
    smin = np.full((V, total), inf, np.int64)
    for v in range(V):
        np.minimum.at(smin[v], g[m], tv[v][m])
    # the last group of each tile that holds a start: the heads of the
    # tiles after it, up to and with the next that holds one
    starts = np.nonzero(cnt > 0)[0]
    gl = carry[starts] + cnt[starts] - 1
    for v in range(V):
        seg = np.minimum.reduceat(np.append(head[v], inf), starts + 1)
        smin[v, gl] = np.minimum(smin[v, gl], seg)
    least = smin[:, :min(total, cap)]
    return first, least, total, span


def _node_tables_replay(K, inst, perm, rawlen, totalreadbp, N, T, SL):
    """csrc/dbg.cu's node_tables in numpy, window by window: phase 0 in
    tiles of T sorted positions (_tile_groups: the group starts into
    gstart, their first read times, heads across tile edges), the groups
    past the last start at the valid count; the creation order (a stable
    sort of the first times); phase 1 in blocks of SL slots, a warp a slot
    over its group's positions 32 at a time: the class counts and each
    quality bit's count by ballots (popc(ballot(q >> b & 1) & class
    mask)), nid, the flags, the mers and the prune."""
    keys, pay, qok = (inst[k].numpy() for k in ("keys", "pay", "qok"))
    perm = perm.numpy()
    NW, W, I = keys.shape
    thr = bc.SCALARS["low_cov_threshold"]
    ratio = np.float32(bc.SCALARS["min_cov_ratio"])
    out = {"counts": np.zeros((W, N, 4), np.int64),
           "mq": np.zeros((W, N, K, 4), np.int32),
           "totq": np.zeros((W, N, K), np.int64),
           "mincov_qv": np.zeros((W, N), np.int64),
           "nid": np.full((W, I), -1, np.int64),
           "n_nodes": np.zeros(W, np.int64),
           "over_n": np.zeros(W, bool)}
    for k in ("exists", "alive", "low", "in_index", "is_tumor",
              "is_normal"):
        out[k] = np.zeros((W, N), bool)
    mers = np.zeros((NW, W, N), np.int64)
    out["avgcov"] = (totalreadbp.numpy().astype(np.float32)
                     / np.maximum(rawlen.numpy().astype(np.float32),
                                  np.float32(1)))
    out["rawlen_dev"] = rawlen.numpy().astype(np.int64)
    stats = {"span": 0, "groups": []}

    def bit(v, b):
        return ((v >> b) & 1).astype(bool)

    for w in range(W):
        x = perm[w]
        pv, kw = pay[w, x], keys[:, w, x]
        valid = bit(pv, dbg.P_VALID)
        differ = np.ones(I, bool)
        differ[1:] = (kw[:, 1:] != kw[:, :-1]).any(0)
        newg = valid & differ
        tm = np.where(valid, dbg.pay_time(torch.from_numpy(pv)).numpy(),
                      dbg.BIG)
        gs, nk, total, span = _tile_groups(newg, valid, tm[None], T, N)
        stats["span"] = max(stats["span"], span)
        stats["groups"].append(total)
        gstart = np.full(N + 1, int(valid.sum()), np.int64)
        gstart[:len(gs)] = gs
        node_key = np.full(N, dbg.BIG, np.int64)
        node_key[:nk.shape[1]] = nk[0]
        out["over_n"][w] = total > N
        order = np.argsort(node_key, kind="stable")
        # phase 1: slot c (a warp) walks its group's positions 32 at a time
        gs0, ln = gstart[order], gstart[order + 1] - gstart[order]
        slot = np.repeat(np.arange(N), ln)
        off = np.arange(len(slot)) - np.repeat(np.cumsum(ln) - ln, ln)
        xs = x[gs0[slot] + off]
        nch = -(-ln // 32)
        chunk = np.repeat(np.cumsum(nch) - nch, ln) + off // 32
        cslot = np.repeat(np.arange(N), nch)
        p, q = pay[w, xs], qok[w, xs]
        out["nid"][w, xs] = slot
        rd = bit(p, dbg.P_READ)

        def any_(f):
            return np.bincount(slot, weights=f, minlength=N) > 0

        has, inidx = any_(rd), any_(bit(p, dbg.P_IDX))
        nml, tum = any_(rd & bit(p, dbg.P_NML)), any_(bit(p, dbg.P_TFLAG))
        cov = rd & ~bit(p, dbg.P_REF)
        cls = np.where(bit(p, dbg.P_TMR), 0, 2) + bit(p, dbg.P_STRAND)
        cm = [_ballots(cov & (cls == j), chunk)[0] for j in range(4)]
        qm = np.stack([_ballots(((q >> b) & 1).astype(bool), chunk)[0]
                       for b in range(K)], 1)  # [chunks, K]
        cn = np.stack([np.bincount(cslot, weights=_popc(cm[j]),
                                   minlength=N) for j in range(4)],
                      1).astype(np.int64)
        qc = np.stack([np.stack([np.bincount(
            cslot, weights=_popc(qm[:, b] & cm[j]), minlength=N)
            for b in range(K)], 1) for j in range(4)], 1).astype(np.int64)
        for i in range(NW):
            nb = K - 31 * (NW - 1) if i == 0 else 31
            mers[i, w] = np.where(ln > 0, keys[i, w, x[np.minimum(gs0,
                                                                I - 1)]],
                                  (1 << (2 * nb)) - 1)
        out["mq"][w] = qc.transpose(0, 2, 1)
        out["totq"][w] = qc.sum(1)
        mincov = np.where(has, qc.sum(1).min(1), 0)
        low = ((mincov <= thr) | (mincov.astype(np.float32)
                                  <= ratio * out["avgcov"][w])
               | ((cn[:, 0] + cn[:, 1] == 1) & (cn[:, 2] + cn[:, 3] == 1)))
        out["counts"][w] = cn
        out["mincov_qv"][w] = mincov
        for k, v in (("exists", has), ("alive", has & ~low), ("low", low),
                     ("in_index", inidx), ("is_tumor", tum),
                     ("is_normal", nml)):
            out[k][w] = v
        # n_nodes: each block of SL slots adds its count
        out["n_nodes"][w] = np.add.reduceat(has.astype(np.int64),
                                            np.arange(0, N, SL)).sum()
    out["mers_w"] = tuple(mers)
    return out, stats


def _nodes_at(K, N):
    """The instance table of the crafted windows at bucket 0's shape, its
    sort permutation and node_tables_plain at N."""
    t = _tensors(_batch(K))
    inst = dbg.mer_instances_plain(K, *t[:11], t[12], Lraw=bc.LRAW,
                                   min_qual_call=bc.SCALARS["min_qual_call"])
    perm = dbg.window_sort_plain(inst["keys"])
    nodes = dbg.node_tables_plain(
        K, inst, perm, t[8], t[11], N=N,
        low_cov_threshold=bc.SCALARS["low_cov_threshold"],
        min_cov_ratio=bc.SCALARS["min_cov_ratio"])
    return t, inst, perm, nodes


def _equal_outputs(got: dict, want: dict, keys, tag) -> None:
    for k in keys:
        a, b = got[k], want[k]
        if isinstance(b, tuple):
            assert all(np.array_equal(x, y.numpy()) for x, y in zip(a, b)), \
                (tag, k)
        else:
            b = b.numpy()
            assert a.dtype == b.dtype, (tag, k, a.dtype, b.dtype)
            assert np.array_equal(a, b), (tag, k, np.argwhere(a != b)[:5])


def _plain_groups(K):
    """Each crafted window's count of groups of equal mers."""
    _, inst, perm, _ = _nodes_at(K, N0)
    out = []
    for w in range(perm.shape[0]):
        x = perm[w].numpy()
        kw = inst["keys"][:, w].numpy()[:, x]
        valid = dbg.pay_bit(inst["pay"][w], dbg.P_VALID).numpy()[x]
        d = np.ones(len(x), bool)
        d[1:] = (kw[:, 1:] != kw[:, :-1]).any(0)
        out.append(int((d & valid).sum()))
    return out


@pytest.mark.parametrize("K,T,SL", [(11, 7, 8), (33, 16, 16), (63, 5, 8)])
@pytest.mark.parametrize("at", ["bucket", "groups_plus_one", "ties_reversed"])
def test_node_tables_tile_replay(K, T, SL, at):
    """node_tables' three launches replayed in numpy (tiles of T sorted
    positions: groups cut at tile edges, one over three tiles or more;
    the heads; the ballot counts) bit-equal to node_tables_plain on the
    crafted windows, at bucket 0's N, at N one below the plain window's
    group count (exactly N + 1 groups: over_n) and on a permutation with
    the sort's ties reversed (each group's first read time at its end: the
    heads decide it; node_tables_plain's outputs do not depend on the
    order of ties)."""
    N = N0
    if at == "groups_plus_one":
        N = _plain_groups(K)[bc.lane("plain")] - 1
    t, inst, perm, want = _nodes_at(K, N)
    if at == "ties_reversed":
        perm = _reversed_ties(inst["keys"])
    got, stats = _node_tables_replay(K, inst, perm, t[8], t[11], N, T, SL)
    _equal_outputs(got, want, [k for k in want], (K, T, at))
    assert stats["span"] >= 3
    if at == "groups_plus_one":
        assert stats["groups"][bc.lane("plain")] == N + 1
        assert got["over_n"][bc.lane("plain")]


def _reversed_ties(keys):
    """A sort permutation of keys [NK, W, n] with ties in reverse index
    order (window_sort's are in index order): the groups' least times then
    lie at their last positions, across tile edges."""
    k = keys.numpy()
    n = k.shape[2]
    return torch.from_numpy(np.stack([
        np.lexsort((-np.arange(n),) + tuple(k[c, w] for c in
                                            reversed(range(len(k)))))
        for w in range(k.shape[1])]))


def _edge_tables_replay(K, inst, nodes, window_ok, N, E, D, T,
                        ties="stable"):
    """csrc/dbg.cu's edge_tables in numpy, window by window: launch 0 the
    pair keys and time lanes; after the pair sort, launches 1-2 in tiles
    of T sorted keys (_tile_groups: the canonical groups and their two
    time lanes' minima, heads across tile edges) and each group's two
    directed rows, the rows past the last group empty, each tile's
    self-loops; after the time sort, launch 3: the rows in time order cut
    to E, n_edges and over_e from the tiles' counts, the reference
    projection and refcov, the mate keys' runs (after the mate sort too:
    fragments first, words only where they agree); after the adjacency
    sort, launch 4: each source's first slot and count, adj, deg by its
    segment arithmetic, the flags. ties "reversed": the pair sort's ties
    in reverse index order."""
    pay, fk = inst["pay"].numpy(), inst["fkeys"].numpy()
    nid, counts = nodes["nid"].numpy(), nodes["counts"].numpy()
    in_index, rawlen = nodes["in_index"].numpy(), nodes["rawlen_dev"].numpy()
    over_n, ok = nodes["over_n"].numpy(), window_ok.numpy()
    fperm = dbg.window_sort_plain(inst["fkeys"]).numpy()
    W, NW, Lraw = pay.shape[0], fk.shape[0] - 1, bc.LRAW
    M, Mraw = L0 - K + 1, bc.LRAW - K + 1
    RM = R0 * M
    PU, NODECAP, NC = RM + Mraw, N + 64, N + 64
    BIG, I32 = dbg.BIG, dbgk.I32_MAX
    out = {"n_edges": np.zeros(W, np.int64),
           "edge_src": np.zeros((W, E), np.int64),
           "edge_dst": np.zeros((W, E), np.int64),
           "edge_dir": np.zeros((W, E), np.int64),
           "edge_exists": np.zeros((W, E), bool),
           "adj": np.full((W, N, D), -1, np.int64),
           "deg": np.zeros((W, N), np.int64),
           "nid_proj": nid[:, RM + Mraw:RM + 2 * Mraw].copy(),
           "proj_isF": ((pay[:, RM:RM + Mraw] >> dbg.P_ISF) & 1).astype(bool),
           "refcov": np.zeros((W, Lraw, 4), np.int64),
           "mate_cand": np.zeros(W, bool), "fallback": np.zeros(W, bool)}
    stats = {"span": 0, "groups": []}

    def bit(v, b):
        return (v >> b) & 1

    def flip(d):
        return ((d & 1) ^ 1) * 2 + ((d >> 1) ^ 1)

    q = np.arange(PU)
    off = np.where(q < RM, q % M, q - RM)
    nxt = np.where(q < RM, off + 1 < M, off + 1 < Mraw)
    for w in range(W):
        # launch 0
        pv, u = pay[w, :PU], nid[w, :PU]
        v = np.where(nxt, nid[w, q + 1], -1)
        uF = bit(pv, dbg.P_ISF)
        vF = np.where(nxt, bit(pay[w, q + 1], dbg.P_ISF), 0)
        pm = bit(pv, dbg.P_PAIR).astype(bool)
        tq = dbg.pay_time(torch.from_numpy(pv)).numpy() + (off > 0)
        fdir = (1 - uF) * 2 + (1 - vF)
        rdir = flip(fdir)
        tw = (v < u) | ((v == u) & (rdir < fdir))
        ckey = np.where(pm, (np.where(tw, v, u) * NODECAP + np.where(tw, u, v))
                        * 4 + np.where(tw, rdir, fdir), I32)
        tA = np.where(pm & ~tw, tq, BIG)
        tB = np.where(pm & tw, tq, BIG)
        # launches 1-2, after the pair sort
        cperm = (np.argsort(ckey, kind="stable") if ties == "stable" else
                 _reversed_ties(torch.from_numpy(ckey)[None, None])[0].numpy())
        ck = ckey[cperm]
        ev = ck != I32
        enew = ev.copy()
        enew[1:] &= ck[1:] != ck[:-1]
        first, least, total, span = _tile_groups(
            enew, ev, np.stack([tA[cperm], tB[cperm]]), T, E)
        stats["span"] = max(stats["span"], span)
        stats["groups"].append(total)
        n = min(total, E)
        gck = np.full(E, I32, np.int64)
        gA = np.full(E, I32, np.int64)
        gB = np.full(E, I32, np.int64)
        gck[:n], gA[:n], gB[:n] = ck[first[:n]], least[0], least[1]
        ex = gck != I32
        gdir = np.where(ex, gck % 4, 0)
        gdst = np.where(ex, (gck // 4) % NODECAP, 0)
        gsrc = np.where(ex, gck // (4 * NODECAP), 0)
        tc = np.minimum(gA, np.minimum(gB, BIG - 1) + 1)
        tt = np.minimum(gB, np.minimum(gA, BIG - 1) + 1)
        selftw = ex & (gsrc == gdst) & ((gdir == 1) | (gdir == 2))
        ex2 = ex & ~selftw
        de_src = np.concatenate([gsrc, gdst])
        de_dst = np.concatenate([gdst, gsrc])
        de_dir = np.concatenate([gdir, flip(gdir)])
        de_ex = np.concatenate([ex, ex2])
        et = np.concatenate([np.where(ex, tc, BIG), np.where(ex2, tt, BIG)])
        # launch 3, after the time sort
        n_edges = 2 * n - int(selftw.sum())
        over_e = n_edges > E or total > E
        out["n_edges"][w] = n_edges
        eo = np.argsort(et, kind="stable")[:E]
        exo = de_ex[eo]
        src = np.where(exo, de_src[eo], -1)
        out["edge_src"][w] = src
        out["edge_dst"][w] = np.where(exo, de_dst[eo], -1)
        out["edge_dir"][w] = np.where(exo, de_dir[eo], 0)
        out["edge_exists"][w] = src >= 0
        ak = np.where(src >= 0, src, I32)
        # launch 3: the reference tiles, the mate tiles
        nidp = nid[w, RM + Mraw:RM + 2 * Mraw]
        n_proj = max(int(rawlen[w]) - K, 0)
        r = np.arange(Lraw)
        i = np.where(r >= K - 1, r - K + 1, 0)
        on = np.where(r >= K - 1, i < n_proj, n_proj > 0)
        nd = np.where(on, nidp[i], -1)
        ndc = np.maximum(nd, 0)
        for c in range(4):
            cc = counts[w, ndc, c]
            out["refcov"][w, :, c] = np.where(
                (nd >= 0) & in_index[w, ndc] & (cc > 0), cc, 0)
        x = fperm[w]
        fx = fk[NW, w, x]
        cand = False
        for p in np.nonzero((fx[1:] != I32) & (fx[1:] == fx[:-1]))[0] + 1:
            a, b = x[p], x[p - 1]
            same = all(fk[i, w, a] == fk[i, w, b] for i in range(NW))
            oa, ob = (pay[w, a] >> dbg.P_ORDER) & 0xFF, (
                pay[w, b] >> dbg.P_ORDER) & 0xFF
            cand |= bool(same and oa != ob and oa > 0 and ob > 0)
        # launch 4, after the adjacency sort
        aperm = np.argsort(ak, kind="stable")
        ks = ak[aperm]
        inr = (ks >= 0) & (ks < NC)
        fp = np.full(NC, I32, np.int64)
        cn = np.zeros(NC, np.int64)
        np.minimum.at(fp, ks[inr], np.nonzero(inr)[0])
        np.add.at(cn, ks[inr], 1)
        for s in np.nonzero(cn)[0]:  # deg's segment w (N + 1) + source
            sw, sn = divmod(w * (N + 1) + int(s), N + 1)
            if sw < W and sn < N:
                out["deg"][sw, sn] += cn[s]
        for p in np.nonzero(inr & (ks < N))[0]:
            slot = p - fp[ks[p]]
            if slot < D:
                out["adj"][w, ks[p], slot] = aperm[p]
        out["mate_cand"][w] = cand and bool(ok[w])
        out["fallback"][w] = (bool(over_n[w]) or over_e or bool(
            (cn > D).any()) or cand) and bool(ok[w])
    return out, stats


@pytest.mark.parametrize("K,T", [(11, 7), (33, 16), (63, 5)])
@pytest.mark.parametrize("at", ["bucket", "groups_plus_one", "ties_reversed"])
def test_edge_tables_tile_replay(K, T, at):
    """edge_tables' five launches replayed in numpy (the canonical groups in
    tiles of T sorted pair keys, cut at tile edges, one over three tiles
    or more; their time minima sA and sB with the heads) bit-equal to
    edge_tables_plain on the crafted windows, at bucket 0's E, at E one
    below the plain window's canonical group count (exactly E + 1 groups:
    over_e) and with the pair sort's ties reversed (each group's least
    times at its end: the heads decide them)."""
    t, inst, _, nodes = _nodes_at(K, N0)
    D = bc.D_ENGINE
    E = E0
    if at == "groups_plus_one":
        _, stats = _edge_tables_replay(K, inst, nodes, t[12], N0, E0, D, T)
        E = stats["groups"][bc.lane("plain")] - 1
    want = dbg.edge_tables_plain(K, inst, nodes, t[12], R=R0, L=L0, N=N0,
                                 E=E, D=D, Lraw=bc.LRAW)
    got, stats = _edge_tables_replay(
        K, inst, nodes, t[12], N0, E, D, T,
        "reversed" if at == "ties_reversed" else "stable")
    _equal_outputs(got, want, [k for k in want], (K, T, at))
    assert stats["span"] >= 3
    if at == "groups_plus_one":
        assert stats["groups"][bc.lane("plain")] == E + 1
        assert got["fallback"][bc.lane("plain")]


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
                assert all(sp.smem <= dbgk.SMEM_LIMIT
                           for sp in p.sorts.values())
                assert p.inst_smem <= dbgk.SMEM_LIMIT
                assert p.edge_smem <= dbgk.SMEM_LIMIT
                # every launch but the adjacency's on more than W blocks
                assert min(p.TN, p.NB, p.TPu, p.TE, p.TJ + p.TM) > 1
                assert p.launches["node_tables"] == 3
                assert p.launches["edge_tables"] == 5
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
    (11, 4, 48, 160, 1152, 1536, 60_000, 12),
    (11, 4, 48, 160, 1152, 4096, 50_000, 12),
    (11, 1, 1 << 22, 160, 1152, 1536, 3840, 12),
    (11, 1, 1, 240_000, 1152, 1536, 3840, 12),
    (11, 4, 48, 160, 500_000, 1536, 3840, 12),
    # node_tables' and edge_tables' tiles: 128 and 2,304 positions, 1,000
    # (not a multiple of 256); blocks of 4, 12 and 264 slots
    (11, 4, 48, 160, 1152, 1536, 3840, 12, (128, 32)),
    (11, 4, 48, 160, 1152, 1536, 3840, 12, (2304, 32)),
    (11, 4, 48, 160, 1152, 1536, 3840, 12, (1000, 32)),
    (11, 4, 48, 160, 1152, 1536, 3840, 12, (2048, 4)),
    (11, 4, 48, 160, 1152, 1536, 3840, 12, (2048, 12)),
    (11, 4, 48, 160, 1152, 1536, 3840, 12, (2048, 264)),
])
def test_build_plan_refusals(args, monkeypatch):
    """Shapes the kernels do not take (an adjacency block past the card's
    shared memory: E 60,000 at N 1,536, E 50,000 at N 4,096), and tiles
    and slot blocks they do not take."""
    *args, tiles = args if len(args) == 9 else (*args, None)
    if tiles is not None:
        monkeypatch.setattr(dbgk, "BUILD_TILE", tiles[0])
        monkeypatch.setattr(dbgk, "NODE_SLOTS", tiles[1])
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
    assert torch.equal(perm, dbgk.window_sort(
        inst["keys"], plan=_plan(K).sorts["inst"]))
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
    # mer_instances 2, window_sort 4, node_tables 3, edge_tables 5
    assert len(re.findall(r"^__global__", src, re.M)) == 14
    for name in ("node_tables_count", "node_tables_groups",
                 "node_tables_order", "edge_tables_pairs",
                 "edge_tables_count", "edge_tables_groups",
                 "edge_tables_order", "edge_tables_adj"):
        assert re.search(rf"\b{name}\(const (Node|Edge)Args a\)", src), name
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
    crafted batches at every bucket's shape (the hub at HUB_D), the plan's
    launches a build, no host sync."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for R, L, N, E in bc.BUCKETS:
        for K in (11, 33, 63):
            for arrs, D in ((bc.batch(K, R, L, N, E), bc.D_ENGINE),
                            (bc.hub_batch(K, R, L), bc.HUB_D)):
                before = dict(dbgk.LAUNCHES)
                got = bc.run(arrs, K, N, E, D, "cuda", guard=_no_sync)
                p = dbgk.build_plan(K, arrs["rlen"].shape[0], R, L, bc.LRAW,
                                    N, E, D)
                assert {k: dbgk.LAUNCHES[k] - before[k]
                        for k in before} == p.launches
                want = bc.run(arrs, K, N, E, D, "cuda", plain=True)
                for k in dbg.BUILD_KEYS:
                    a, b = got[k], want[k]
                    if isinstance(b, tuple):
                        assert all(torch.equal(x, y) for x, y in zip(a, b))
                    else:
                        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.cuda
def test_sort_and_instances_on_card():
    """window_sort on generic int64 keys (both signs, ties, one tile and
    several, n not a power of two) and mer_instances alone, on the card,
    bit-equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(3)
    for NK, W, n in ((1, 3, 100), (1, 4, 9000), (2, 3, 5000), (4, 2, 4097)):
        k = rng.integers(-4, 4, (NK, W, n)) * (1 << 61)
        k[..., ::3] = rng.integers(-(1 << 63), (1 << 63) - 1,
                                   (NK, W, len(range(0, n, 3))))
        keys = torch.from_numpy(k).cuda()
        before = dbgk.LAUNCHES["window_sort"]
        got = dbgk.window_sort(keys)
        assert dbgk.LAUNCHES["window_sort"] - before == dbgk.sort_plan(
            NK, n, W).launches
        assert torch.equal(got, dbg.window_sort_plain(keys))
    R, L, N, E = bc.BUCKETS[2]
    for K in (11, 33, 63):
        t = [x.cuda() for x in _tensors(bc.batch(K, R, L, N, E))]
        ik = dict(Lraw=bc.LRAW, min_qual_call=bc.SCALARS["min_qual_call"])
        got = dbgk.mer_instances(K, *t[:11], t[12], **ik)
        want = dbg.mer_instances_plain(K, *t[:11], t[12], **ik)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), (K, k)
