"""The device graph engine's compression pass (`lancet_tpu_torch.gpu.compress`,
`csrc/compress.cu`) on the CPU, against the JAX package.

- `stages.compress_round_plain` bit-equal to the JAX `compress_round`
  (`lancet_tpu.tpu.stages`, int32 and int8 inputs) on every window of
  `gpu.compresscases.crafted_batch` at the engine's first shape (NI 1,552,
  EE 3,872, NM 1,536): a chain whose members flip, a mutual-buddy cycle, a
  mid-compress loopback, links blocked by a tandem self-loop, an anchor and
  a branch, okey sentinels and a source with 70 out-edges, dead items with
  merlen and mers that point at them, a chain of 1,530 items and a cycle of
  1,500 (dist saturated), seeded windows. Every output and the fallback is
  compared whole, but for `mer_pos`: the JAX sorts of the items are
  unstable (`jax.lax.sort(..., is_stable=False)`), so the order of items
  with one key (every dead item; the members of a saturated cycle) is left
  open there, and `start_off`, then `mer_pos`, of their mers with it.
  `mer_pos` is compared on every mer whose item is alive with a key no
  other item of its window has; the other mers' differ only there;
- a numpy replay of the kernel, step for step (the state words and their
  per-window fixed point, the orders by counting and the bitonic network
  of (key, index) pairs, run totals from inclusive sums, the edges' ranks
  in their sources' buckets), by clusters of 1 to 4 blocks (the workers'
  ranges adding counts and 64-bit width totals into the owners'),
  bit-equal to the plain version on every batch: the crafted one, the
  compact shape's, W 1, an empty window and the straddle window, whose
  mers and edges the workers' ranges cut;
- the plain version on a batch equal to it on each window alone (the
  kernel stops each window at its own fixed point);
- `compress.compress_plan`: the cluster size it picks by W, the blocks'
  shared memory at the engine's shapes, and its refusals; the wrapper's
  dispatch on the CPU and its refusal of mixed devices.

The JAX side runs once, at one shape (its compile takes ~20 s). The `cuda`
test holds the kernel bit-equal to the plain version on every batch on the
card.
"""

import functools

import numpy as np
import pytest
import torch

from lancet_tpu_torch.gpu import compress
from lancet_tpu_torch.gpu import compresscases as cc
from lancet_tpu_torch.gpu import stages

torch.set_num_threads(1)

OUT_KEYS = tuple(k for k, _, _ in compress.OUTPUTS)
BIG = 1 << 30
DB = 13
DM = (1 << DB) - 1


@functools.lru_cache(maxsize=None)
def _crafted():
    return cc.crafted_batch()


@functools.lru_cache(maxsize=None)
def _batches():
    return {name: (arrs, K) for name, arrs, K in cc.batches()}


def _plain(arrs, K):
    NI = arrs["alive"].shape[1]
    out, fb = stages.compress_round_plain(cc.to_torch(arrs), K, NI,
                                          NI - 2 * cc.CMAX)
    return {k: out[k].numpy() for k in OUT_KEYS}, fb.numpy()


# ---------------------------------------------------------------------------
# the kernel, replayed in numpy
# ---------------------------------------------------------------------------

def bitonic(key, idx):
    """csrc/compress.cu block_sort: the bitonic network over (key, index)
    pairs, P a power of two (pads: key INT64_MAX, index INT32_MAX)."""
    key, idx = key.copy(), idx.copy()
    P = len(key)
    i = np.arange(P // 2)
    k = 2
    while k <= P:
        j = k >> 1
        while j > 0:
            x = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            y = x + j
            kx, ky, ix, iy = key[x], key[y], idx[x], idx[y]
            gt = (kx > ky) | ((kx == ky) & (ix > iy))
            sw = gt == ((x & k) == 0)
            key[x], key[y] = np.where(sw, ky, kx), np.where(sw, kx, ky)
            idx[x], idx[y] = np.where(sw, iy, ix), np.where(sw, ix, iy)
            j >>= 1
        k <<= 1
    return key, idx


def _sort(key, n):
    P = 1
    while P < n:
        P <<= 1
    k = np.full(P, np.iinfo(np.int64).max, np.int64)
    x = np.full(P, np.iinfo(np.int32).max, np.int64)
    k[:n], x[:n] = key, np.arange(n)
    k, x = bitonic(k, x)
    return k[:n], x[:n]


def _runs(key, shift):
    """(run-start flags, each position's run start, run end by start)."""
    n = len(key)
    nr = np.ones(n, bool)
    nr[1:] = (key[1:] >> shift) != (key[:-1] >> shift)
    rs = np.maximum.accumulate(np.where(nr, np.arange(n), 0)) if n else nr
    rend = np.zeros(n, np.int64)
    last = np.ones(n, bool)
    last[:-1] = nr[1:]
    rend[rs[last]] = np.arange(n)[last]
    return nr, rs, rend


def _excl(c):
    return np.concatenate([[0], c[:-1]]).astype(np.int64)


def _place(ranks, groups, n_groups):
    """The kernel's order by counting: each element goes to its group's run
    start (groups in ascending order) plus its rank; None where a rank is
    outside [0, the group's count) or two elements share a place (the
    kernel then takes the bitonic sort). Returns (the element at each
    place, each place's run start, each run start's end)."""
    cnt = np.bincount(groups, minlength=n_groups)
    end = np.cumsum(cnt)  # inclusive
    c = cnt[groups]
    if ((ranks < 0) | (ranks >= c)).any():
        return None
    k = end[groups] - c + ranks
    if len(np.unique(k)) != len(k):
        return None
    ix = np.empty(len(k), np.int64)
    ix[k] = np.arange(len(k))
    s0 = (end - cnt)[groups][ix]
    rend = np.zeros(len(k), np.int64)
    rend[s0] = (end - 1)[groups][ix]
    return ix, s0, rend


def _ranges(n, C):
    """The workers' contiguous ranges of n elements in a cluster of C
    blocks (csrc/compress_body.cuh roles, range_chunk)."""
    nw = C - 1 if C > 1 else 1
    ch = compress._range_chunk(n, nw)
    return [(min(j * ch, n), min(j * ch + ch, n)) for j in range(nw)]


def replay_window(a, w, K, NI, N, Dcap=64, sort=False, paths=None, C=1):
    """csrc/compress.cu's compress_kernel on window w of the batch `a`
    (numpy [W, ...]) by a cluster of C blocks; returns (outputs, fallback,
    label, pos_u). `sort` takes the bitonic sorts of the items and mers
    everywhere; `paths` (a dict) counts the windows whose items and mers
    went by counting, whose mtot went by item (negpos), whose workers'
    ranges cut a member item's mers (mers_cut) or a source's edges
    (edges_cut), and whose negative-new_pos item took width totals from
    two ranges (negpos_ranks)."""
    EE, NM = a["e_src"].shape[1], a["mer_item"].shape[1]
    S = 2 * NI
    paths = {} if paths is None else paths
    alive, special = a["alive"][w], a["special"][w]
    rank = a["rank"][w]
    ea, src, dst, dr = (a["e_alive"][w], a["e_src"][w], a["e_dst"][w],
                        a["e_dir"][w])
    # links: counts and the single writer's word; self-loops
    st = np.clip(src * 2 + (dr >> 1), 0, S - 1)
    cnt = np.bincount(st[ea], minlength=S)
    pk = np.zeros(S, np.int64)
    pk[st[ea]] = np.clip(dst * 2 + (dr & 1), 0, S - 1)[ea]
    tandem = np.zeros(NI, bool)
    tandem[np.clip(src[ea & (src == dst)], 0, NI - 1)] = True
    s_ = np.arange(S)
    u = s_ >> 1
    v, b = pk >> 1, pk & 1
    vs = np.clip(v, 0, NI - 1)
    g = vs * 2 + (1 - b)
    valid = ((cnt == 1) & alive[u] & ~special[u] & ~tandem[u] & (v != u)
             & ~special[vs] & ~tandem[vs] & (cnt[g] == 1)
             & ((pk[g] >> 1) == u))
    p = np.where(valid, (pk << DB) | 1, s_ << DB)
    # pointer jumping to the window's own fixed point
    rounds = max(2, int(NI + 8).bit_length())
    dcap = min(NI + 8, DM)
    for _ in range(rounds):
        q = p[p >> DB]
        p2 = (q & ~DM) | np.minimum((p & DM) + (q & DM), dcap)
        same = (p2 == p).all()
        p = p2
        if same:
            break
    cyc = bool(((p & DM) > NI - 1).any())
    # the merge
    wF, wR = p[0::2], p[1::2]
    endF, endR = (wF >> DB) >> 1, (wR >> DB) >> 1
    dF, dR = wF & DM, wR & DM
    thi = np.maximum(endF, endR)
    lab = np.minimum(endF, endR)
    au = endF != thi
    dlo = np.where(endF == thi, dR, dF)
    idx = np.arange(NI)
    combo = np.where(alive, np.minimum(rank, N) * NI + idx, BIG)
    cmin = np.full(NI, BIG, np.int64)
    np.minimum.at(cmin, lab, combo)
    citems = np.zeros(NI, np.int64)
    np.maximum.at(citems, lab, np.where(alive, dlo + 1, 0))
    sit = np.where(alive, np.mod(cmin[lab], NI), idx)
    a_s = au[sit]
    flip = alive & (au != a_s)
    posu = np.where(a_s, citems[lab] - 1 - dlo, dlo)
    # items: the (label, pos_u) order, start_off, survivors' run totals
    dead = ~alive
    placed = None if sort else _place(
        np.where(alive, posu, np.cumsum(dead) - 1),
        np.where(alive, lab, NI), NI + 1)
    if placed is not None:
        ix, rs, rend = placed
        nr = rs == np.arange(NI)
        paths["items"] = paths.get("items", 0) + 1
    else:
        ikey = np.where(alive, (lab << 13) | np.minimum(posu, 8191),
                        NI << 13)
        ik, ix = _sort(ikey, NI)
        nr, rs, rend = _runs(ik, 13)
    kpos = np.empty(NI, np.int64)
    kpos[ix] = np.arange(NI)
    vals = np.concatenate(
        [a["merlen"][w][:, None], a["csum"][w], a["n_t"][w][:, None],
         a["is_tumor"][w][:, None].astype(np.int64),
         a["is_normal"][w][:, None].astype(np.int64)], axis=1)[ix]
    lanes = np.cumsum(vals, axis=0)
    ex0 = _excl(lanes[:, 0])
    irb = np.maximum.accumulate(np.where(nr, ex0, 0))
    soff = np.empty(NI, np.int64)
    soff[ix] = ex0 - irb
    surv = alive & (sit == idx)
    s0 = rs[kpos]
    e0 = rend[s0]
    prev = np.where(s0[:, None] > 0, lanes[np.maximum(s0 - 1, 0)], 0)
    tot = np.where(surv[:, None], lanes[e0] - prev, 0)
    out = {"alive": surv, "merlen": tot[:, 0], "csum": tot[:, 1:5],
           "n_t": tot[:, 5], "is_tumor": tot[:, 6] > 0,
           "is_normal": tot[:, 7] > 0}
    # mers: each worker's range (C - 1 workers, or the one block at C =
    # 1) adds its member mers' counts and 64-bit width totals into the
    # owner's, in any order
    mi = np.clip(a["mer_item"][w], 0, NI - 1)
    mp, lo, hi = a["mer_pos"][w], a["keep_lo"][w], a["keep_hi"][w]
    uf = flip[mi]
    ml = a["merlen"][w][mi]
    np_ = soff[mi] + np.where(uf, ml - 1 - mp, mp)
    mem = sit[mi] != mi
    width = hi - lo
    mtot = np.zeros(NI, np.uint64)
    mcnt = np.zeros(NI, np.int64)
    mrank = np.full(NM, -1)
    for r, (m0, m1) in enumerate(_ranges(NM, C)):
        on = np.zeros(NM, bool)
        on[m0:m1] = mem[m0:m1]
        mrank[m0:m1] = r
        mcnt += np.bincount(mi[on], minlength=NI)
        part = np.zeros(NI, np.uint64)
        np.add.at(part, mi[on], width[on].astype(np.uint64))
        mtot += part
    cut = {i for i in set(mi[mem].tolist())
           if len(set(mrank[mem & (mi == i)].tolist())) > 1}
    if cut:
        paths["mers_cut"] = paths.get("mers_cut", 0) + 1
    members = np.nonzero(mem)[0]
    # the order by counting needs no start_off (a member's rank is new_pos
    # - start_off); then the range check of new_pos
    placed = None if sort else _place((np_ - soff[mi])[members],
                                      mi[members], NI)
    assert placed is None or (mcnt[mi[members]]
                              == np.bincount(mi[members],
                                             minlength=NI)[mi[members]]
                              ).all()
    if ((np_[mem] < 0) | (np_[mem] > 8191)).any():
        if placed is not None:
            paths["far"] = paths.get("far", 0) + 1
        placed = None
    if placed is not None:  # the member mers only
        mx, mrs, mrend = placed
        mx = members[mx]
        mnr = mrs == np.arange(len(mx))
        paths["mers"] = paths.get("mers", 0) + 1
    else:
        mkey = np.where(mem, (mi << 13) | np.minimum(np_, 8191), NI << 13)
        mk, mx = _sort(mkey, NM)
        mnr, mrs, mrend = _runs(mk, 13)
    cw = np.cumsum(width[mx])
    cex = _excl(cw)
    mrb = np.maximum.accumulate(np.where(mnr, cex, 0))
    before_k = cex - mrb
    neg = mem & (np_ < 0)
    if neg.any():  # mtot by item
        paths["negpos"] = paths.get("negpos", 0) + 1
        if set(mi[neg].tolist()) & cut:
            paths["negpos_ranks"] = paths.get("negpos_ranks", 0) + 1
        tot_k = mtot.view(np.int64)[mi[mx]]
    else:  # the member item's run total
        tot_k = cw[mrend[mrs]] - np.where(mrs > 0,
                                          cw[np.maximum(mrs - 1, 0)], 0)
    before = np.zeros(NM, np.int64)
    after = np.zeros(NM, np.int64)
    before[mx] = before_k
    after[mx] = tot_k - before_k - width[mx]
    klo2 = np.where(uf, K - hi, lo)
    khi2 = np.where(uf, K - lo, hi)
    facing_low = posu[mi] > posu[sit[mi]]
    cut_lo = np.minimum(np.maximum(K - 1 - before, 0), width)
    cut_hi = np.minimum(np.maximum(K - 1 - after, 0), width)
    out.update(mer_item=sit[mi], mer_flip=a["mer_flip"][w] != uf,
               mer_pos=np_,
               keep_lo=np.where(mem & facing_low, klo2 + cut_lo, klo2),
               keep_hi=np.where(mem & ~facing_low, khi2 - cut_hi, khi2))
    # edges: each worker's range adds its alive edges' degrees into the
    # owner's; the owner ranks each alive edge by (clamped okey, index) in
    # its source's whole bucket; then the rewiring
    ok = a["e_okey"][w]
    ok2 = np.where(ok >= BIG - 2,
                   np.minimum(ok - (BIG - 2) + ((1 << 14) - 2),
                              (1 << 14) - 1),
                   np.minimum(ok, (1 << 14) - 3))
    esrc = np.clip(src, 0, NI - 1)
    deg = np.zeros(NI, np.int64)
    erank = np.full(EE, -1)
    for r, (e0, e1) in enumerate(_ranges(EE, C)):
        on = np.zeros(EE, bool)
        on[e0:e1] = ea[e0:e1]
        erank[e0:e1] = r
        deg += np.bincount(esrc[on], minlength=NI)
    if any(len(set(erank[ea & (esrc == s)].tolist())) > 1
           for s in np.nonzero(deg >= 2)[0]):
        paths["edges_cut"] = paths.get("edges_cut", 0) + 1
    alive_e = np.nonzero(ea)[0]
    order = alive_e[np.lexsort((alive_e, ok2[alive_e], esrc[alive_e]))]
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.zeros(EE, np.int64)
    slot[order] = np.arange(len(order)) - start[esrc[order]]
    sb, db = dr >> 1, dr & 1
    consumed = ea & valid[np.clip(src * 2 + sb, 0, S - 1)]
    es, ed = np.clip(src, 0, NI - 1), np.clip(dst, 0, NI - 1)
    nsrc, ndst = sit[es], sit[ed]
    nea = ea & ~consumed
    loop = (nea & (nsrc == ndst) & (src != dst)).any()
    moved = nea & (nsrc != src)
    okr = np.where(ea, slot, BIG)
    out.update(e_src=np.where(nea, nsrc, 0), e_dst=np.where(nea, ndst, 0),
               e_dir=np.where(nea, (sb ^ flip[es]) * 2 + (db ^ flip[ed]), 0),
               e_alive=nea,
               e_okey=np.where(moved, Dcap * np.where(
                   posu[es] > posu[nsrc], 1, 2) + okr, okr))
    return out, cyc or bool(loop), lab, posu


def replay(a, K, sort=False, paths=None, C=1):
    NI = a["alive"].shape[1]
    N = NI - 2 * cc.CMAX
    per = [replay_window(a, w, K, NI, N, sort=sort, paths=paths, C=C)
           for w in range(a["alive"].shape[0])]
    outs = {k: np.stack([p[0][k] for p in per]) for k in OUT_KEYS}
    return (outs, np.array([p[1] for p in per], bool),
            np.stack([p[2] for p in per]), np.stack([p[3] for p in per]))


def _assert_equal(got, want, what):
    for k in OUT_KEYS:
        assert got[k].shape == want[k].shape, (what, k)
        bad = np.argwhere(np.asarray(got[k]) != np.asarray(want[k]))
        assert not len(bad), f"{what}: {k} differs at {bad[:5].tolist()}"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_plain_equals_jax():
    """compress_round_plain bit-equal to the JAX compress_round on every
    crafted window (one call), mer_pos where the JAX sort's order is
    determined; and each crafted window reaches its corner."""
    import jax.numpy as jnp

    from lancet_tpu.tpu import stages as jstages

    arrs, names, K = _crafted()
    NI = arrs["alive"].shape[1]
    N = NI - 2 * cc.CMAX
    st = {k: jnp.asarray(v if v.dtype == bool else
                         v.astype(np.int8 if k == "e_dir" else np.int32))
          for k, v in arrs.items()}
    jo, jfb = jstages.compress_round(st, K, NI, N)
    want = {k: np.asarray(jo[k]) for k in OUT_KEYS}
    got, fb = _plain(arrs, K)
    np.testing.assert_array_equal(fb, np.asarray(jfb))
    _, _, lab, posu = replay(arrs, K)
    key = np.where(arrs["alive"], (lab << 13) | posu, -1 - np.arange(NI))
    unique = np.array([np.unique(r, return_counts=True)[1][
        np.searchsorted(np.unique(r), r)] == 1 for r in key])
    mi = np.clip(arrs["mer_item"], 0, NI - 1)
    determined = np.take_along_axis(arrs["alive"] & unique, mi, 1)
    for k in OUT_KEYS:
        g, w = got[k], want[k]
        if k == "mer_pos":
            g, w = g[determined], w[determined]
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
    verdict = dict(zip(names, fb.astype(int).tolist()))
    assert verdict == {"flip_chain": 0, "buddy_cycle": 1, "loopback": 1,
                       "blocked": 0, "sentinels": 0, "dead_mers": 0,
                       "mixed": 1, "chain_1530": 0, "cycle_1500": 1,
                       **{n: verdict[n] for n in names
                          if n.startswith("seeded")}}
    row = {n: i for i, n in enumerate(names)}
    # flip_chain: one survivor (item 4), members on both sides flipped
    r = row["flip_chain"]
    assert got["alive"][r].sum() == 1 and got["alive"][r, 4]
    assert got["merlen"][r, 4] == arrs["merlen"][r, :8].sum()
    assert (got["mer_flip"][r] != arrs["mer_flip"][r]).any()
    # sentinels: the hub's edges moved past Dcap (slots up to 69)
    r = row["sentinels"]
    moved = got["e_alive"][r] & (got["e_okey"][r] >= 64)
    assert moved.sum() >= 60 and got["e_okey"][r].max() >= 64 + 60
    # the long chain: a few survivors (its ends meet the anchors), one of
    # 1,500 items or more; the cycle: dist saturated at DCAP
    r = row["chain_1530"]
    assert got["alive"][r].sum() <= 4 and posu[r].max() >= 1500
    r = row["cycle_1500"]
    st = cc.to_torch({k: v[r:r + 1] for k, v in arrs.items()})
    lnk = stages.links(st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
                       st["e_okey"], st["alive"], st["special"], NI)
    assert int(stages.chain_jump(lnk, NI)[1].max()) == NI + 8  # DCAP


# ---------------------------------------------------------------------------
# the kernel's formulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", ["crafted", "compact", "w1", "empty",
                                   "straddle"])
@pytest.mark.parametrize("sort", [False, True])
def test_replay_equals_plain(batch, sort, C):
    """The numpy replay of csrc/compress.cu by a cluster of C blocks
    bit-equal to the plain version on every window of the batch, mer_pos
    included: as the kernel runs (the items' and mers' orders by counting
    where they can be, else the bitonic sort; the workers' ranges adding
    counts and 64-bit width totals into the owners'), and with those sorts
    everywhere. In the straddle window at C 3 and 4 the ranges cut a
    member item's mers, the 70-edge hub's edges and a negative-new_pos
    item's mers; in far_members counting would place the mers but their
    new_pos leave [0, 8191]."""
    arrs, K = _batches()[batch]
    paths: dict = {}
    got, fb, _, _ = replay(arrs, K, sort=sort, paths=paths, C=C)
    want, wfb = _plain(arrs, K)
    np.testing.assert_array_equal(fb, wfb)
    _assert_equal(got, want, batch)
    W = arrs["alive"].shape[0]
    if batch == "straddle":
        want_cut = {"mers_cut", "edges_cut", "negpos_ranks"}
        assert want_cut <= set(paths) if C >= 3 else not want_cut & set(
            paths)
        # far_members: counting places its mers, their new_pos do not fit
        assert paths["negpos"] == 1
        assert paths.get("far", 0) == (0 if sort else 1)
    elif sort:
        assert not {"items", "mers"} & set(paths)
    elif batch in ("crafted", "compact"):
        # the cycles' items sort, so do dead_mers' (twice: alone and in
        # mixed) mers, whose mtot then goes by item
        assert 0 < paths["items"] < W if batch == "crafted" else True
        assert paths["mers"] == W - 2 and paths["negpos"] == 2
    else:
        assert paths["items"] == W
    for k in OUT_KEYS:
        assert got[k].dtype == want[k].dtype or (
            got[k].dtype == np.int64 and want[k].dtype == np.int64), k


def test_windows_alone_equal_the_batch():
    """The plain version on the crafted batch equals it on each window
    alone: its pointer jumping, which stops when no window of the batch
    changes, gives each window its own fixed point (the kernel stops each
    window there), a mutual-buddy cycle's too."""
    arrs, names, K = _crafted()
    whole, wfb = _plain(arrs, K)
    for r, name in enumerate(names):
        one, fb = _plain({k: v[r:r + 1] for k, v in arrs.items()}, K)
        assert fb[0] == wfb[r], name
        _assert_equal({k: v[0] for k, v in one.items()},
                      {k: v[r] for k, v in whole.items()}, name)


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000, 1552])
def test_bitonic_is_the_stable_sort(n):
    """The bitonic network over (key, index) pairs, padded to a power of
    two, gives torch's stable sort, ties (the dead run) included."""
    rng = np.random.default_rng(n)
    key = rng.integers(-3, 6, n).astype(np.int64) << 13
    key[rng.random(n) < 0.3] = 1552 << 13
    k, x = _sort(key, n)
    sk, perm = torch.sort(torch.from_numpy(key), stable=True)
    np.testing.assert_array_equal(k, sk.numpy())
    np.testing.assert_array_equal(x, perm.numpy())


# ---------------------------------------------------------------------------
# the plan and the wrapper
# ---------------------------------------------------------------------------

# the most clusters of C blocks an H100 SXM holds at once at the kernel's
# 512 threads and one block an SM (cudaOccupancyMaxActiveClusters,
# tools/cluster_probe.py)
H100_CLUSTERS = {4: 30, 3: 39, 2: 66, 1: 132}


def test_plan():
    """compress_plan: the cluster size it picks by W on an H100's cluster
    occupancy (C 4 up to W 30, 3 up to 39, 2 up to 66, then 1, past 132
    in turns), the blocks' shared memory at the engine's shapes, W 1 and
    the crafted shapes (each C's largest rank's, as csrc/compress_body.cuh
    lays them out); where a C does not fit a block the next one; its
    refusals."""
    for W, C in ((1, 4), (8, 4), (16, 4), (30, 4), (31, 3), (32, 3),
                 (33, 3), (34, 3), (39, 3), (40, 2), (66, 2), (67, 1),
                 (132, 1), (133, 1)):
        assert compress.compress_plan(W, *cc.ENGINE_COMPACT,
                                      H100_CLUSTERS).C == C, W
    assert compress.compress_plan(32, *cc.ENGINE_FIRST,
                                  H100_CLUSTERS) == (3, 224656)
    assert compress.compress_plan(16, *cc.ENGINE_FIRST,
                                  H100_CLUSTERS) == (4, 224656)
    # W 64 would take C 2, whose rank 1 (the mers' and the edges' owner)
    # does not fit at the engine's first shape: C 1
    assert compress.compress_plan(64, *cc.ENGINE_FIRST,
                                  H100_CLUSTERS) == (1, 231296)
    assert compress.compress_plan(64, *cc.ENGINE_COMPACT,
                                  H100_CLUSTERS) == (2, 229328)
    assert compress.compress_plan(32, *cc.ENGINE_COMPACT,
                                  H100_CLUSTERS) == (3, 170448)
    assert compress.compress_plan(16, *cc.ENGINE_COMPACT,
                                  H100_CLUSTERS) == (4, 162000)
    assert compress.compress_plan(1, *cc.SMALL, H100_CLUSTERS) == (4, 31264)
    assert compress.compress_plan(1, 1, 0, 0, H100_CLUSTERS) == (4, 18832)
    # rank 0 the largest at the engine's first shape
    assert [compress.rank_smem(*cc.ENGINE_FIRST, 3, r)
            for r in range(3)] == [224656, 190928, 114576]
    assert compress.cluster_smem(*cc.ENGINE_FIRST, 2) == 303056
    # NI 1,610 at EE 4,000: neither C 2's rank 1 nor C 1's block fits, so
    # W 39 takes C 3 and W 40, past C 3's 39 clusters, C 3 in turns
    assert compress.compress_plan(39, 1610, 4000, 1536,
                                  H100_CLUSTERS) == (3, 231504)
    assert compress.compress_plan(40, 1610, 4000, 1536,
                                  H100_CLUSTERS) == (3, 231504)
    assert compress.cluster_smem(1610, 4000, 1536, 1) > 232448
    for shape in ((0, 10, 10), (1 << 17, 10, 10), (10, -1, 10)):
        with pytest.raises(ValueError):
            compress.compress_plan(1, *shape, H100_CLUSTERS)
    for shape in ((1620, 4000, 1536), (4000, 8000, 1536),
                  (1000, 17, 3000)):
        with pytest.raises(ValueError, match="shared memory"):
            compress.compress_plan(1, *shape, H100_CLUSTERS)


class _Occupancy:
    """A stand-in for a build of csrc/compress.cu's plan entry points: the
    clusters of each C held at once, the layout's smem (`skew` bytes off),
    and a count of its occupancy queries."""

    def __init__(self, clusters: dict, skew: int = 0):
        self.clusters, self.skew, self.queries = clusters, skew, 0

    def compress_max_clusters(self, C, smem):
        self.queries += 1
        return self.clusters[C]

    def compress_smem(self, NI, EE, NM, C):
        return compress.cluster_smem(NI, EE, NM, C) + self.skew


def test_plan_for_caches_by_shape():
    """compress.plan_for: compress_plan over the build's occupancy, queried
    once a shape (a repeated call is a lookup, another W or shape a new
    query); a forced `clusters` neither queries nor enters the cache; a
    build whose layout disagrees, a failed occupancy query and a refused
    shape raise and leave nothing cached."""
    cpu = torch.device("cpu")
    lib = _Occupancy(H100_CLUSTERS)
    shape = cc.ENGINE_COMPACT
    assert compress.plan_for(32, *shape, cpu, lib) == (3, 170448)
    asked = lib.queries
    assert asked == len(compress.CLUSTER_SIZES)
    for _ in range(3):
        assert compress.plan_for(32, *shape, cpu, lib) == (3, 170448)
    assert lib.queries == asked
    assert compress.plan_for(16, *shape, cpu, lib) == (4, 162000)
    assert lib.queries == 2 * asked
    # C 2 does not fit a block at the engine's first shape: not queried
    assert compress.plan_for(32, *cc.ENGINE_FIRST, cpu, lib) == (3, 224656)
    assert lib.queries == 2 * asked + 3
    forced = {4: 0, 3: 0, 2: 32, 1: 0}
    assert compress.plan_for(32, *shape, cpu, lib, forced).C == 2
    assert lib.queries == 2 * asked + 3
    assert compress.plan_for(32, *shape, cpu, lib) == (3, 170448)
    bad = _Occupancy(H100_CLUSTERS, skew=16)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="disagrees"):
            compress.plan_for(32, *shape, cpu, bad)
    assert bad.queries == 2 * asked
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        compress.plan_for(32, *shape, cpu, _Occupancy({4: -3, 3: 39, 2: 66,
                                                       1: 132}))
    with pytest.raises(ValueError, match="shared memory"):
        compress.plan_for(1, 1620, 4000, 1536, cpu, lib)


def test_cpu_runs_the_plain_version():
    """On the CPU stages.compress_round is the plain version, passes every
    other key through as the same tensor, and launches nothing."""
    compress.reset_launches()
    arrs, K = _batches()["compact"]
    st = cc.to_torch(arrs)
    st["mer_tot"] = torch.zeros(3)
    NI = arrs["alive"].shape[1]
    out, fb = stages.compress_round(st, K, NI, NI - 16)
    want, wfb = _plain(arrs, K)
    np.testing.assert_array_equal(fb.numpy(), wfb)
    _assert_equal({k: out[k].numpy() for k in OUT_KEYS}, want, "cpu")
    assert out["mer_tot"] is st["mer_tot"] and out["rank"] is st["rank"]
    assert compress.LAUNCHES == {"compress_round": 0}


def test_wrapper_refuses_mixed_devices_and_dtypes():
    """Inputs on two devices raise before any work; the card path's checks
    refuse other shapes and dtypes."""
    arrs, K = _batches()["w1"]
    st = cc.to_torch(arrs)
    st["keep_hi"] = st["keep_hi"].to("meta")
    with pytest.raises(ValueError, match="one device"):
        compress.compress_round(st, K, 96, 80)
    st = cc.to_torch(arrs)
    W, NI = st["alive"].shape
    EE, NM = st["e_src"].shape[1], st["mer_item"].shape[1]
    compress._shapes(st, W, NI, EE, NM)
    st["e_dir"] = st["e_dir"].to(torch.int8)
    with pytest.raises(ValueError, match="e_dir"):
        compress._shapes(st, W, NI, EE, NM)
    st = cc.to_torch(arrs)
    st["csum"] = st["csum"][:, :, :3]
    with pytest.raises(ValueError, match="csum"):
        compress._shapes(st, W, NI, EE, NM)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """compress_round on the card bit-equal to the plain version on every
    batch, dtypes too, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for name, (arrs, K) in _batches().items():
        before = compress.LAUNCHES["compress_round"]
        got, fb = cc.run(arrs, K, "cuda")
        assert compress.LAUNCHES["compress_round"] == before + 1
        want, wfb = _plain(arrs, K)
        np.testing.assert_array_equal(fb.numpy(), wfb)
        for k in OUT_KEYS:
            assert got[k].numpy().dtype == want[k].dtype, (name, k)
        _assert_equal({k: got[k].numpy() for k in OUT_KEYS}, want, name)
