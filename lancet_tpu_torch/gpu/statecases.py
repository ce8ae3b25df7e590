"""Crafted and seeded states for `components`, `compact_state` and
`low_cov_pass` / `item_mincovs` (gpu.graphstate; their plain versions in
gpu.stages): windows that reach the corners of each function, which the
engine's states reach rarely or never, batched by shape.
`tests/test_torch_graphstate.py` holds each plain version on them against
the JAX package and a numpy replay of each kernel against the plain
version; `chip_smoke.py` holds each kernel against its plain version on
them on the card.

A window is numpy arrays with the engine's dtypes (int64 and bool; the
low-coverage threshold's avgcov float32), an item axis NI = N + 2 CMAX
whose last 2 CMAX slots are the anchors. The cases:

- components (`components_batch`): several components whose least ranks
  tie (numbered by root index); alive edges through dead endpoints, one
  and two in a row, and alive edges among dead items only; more
  components than CMAX; a chain through 600 items in shuffled index order
  (many rounds); ranks at and past BIG (a root key of BIG sorts among the
  other items by index) and below 0; self-loops and duplicate edges; no
  alive edge; nothing alive; junk in dead edge rows; seeded graphs; item
  NI - 1 dead but labelled through an alive edge (outside the engine's
  states, whose anchor slot NI - 1 is untouched), whose label the clamp
  hands to unlabelled items and on to an alive item of another component.
- compact_state (`compact_batch`): regular, special and dead items with
  anchors alive and dead; an alive anchor that is not special (it takes a
  regular slot and its fixed slot); more regular items than NCR and more
  alive edges than EC (with edges then touching dropped and dead items);
  exactly NCR and EC; dead mers and mer_item outside [0, NI); a state
  without `comp`. `dead_edge_batch` holds a lane within the caps whose
  alive edge touches a dead item: the plain version asserts, the kernel
  flags it.
- low_cov_pass / item_mincovs (`lowcov_batch`): flipped mers with trimmed
  kept intervals, intervals past [0, K], widths 0 and below (which donate
  nothing), mer_item outside [0, NI), totq past BIG; an item of coverage 1
  (csum's tumor and normal sums equal merlen); mincov_qv at, just under
  and just over the float threshold, also past 2^24 where the int64 to
  float32 conversion rounds (2^24 + 1 -> 2^24); special and dead items;
  alive edges out of [0, NI) (clamped).
- the low-coverage kernels' cluster (`ranges_batch`, at NM 1,001 and EE
  705, multiples of neither 32 nor any cluster size, and K 63 and 64): an
  item whose donor mers fall in every rank's range of the mers (its least
  mincov_qv in the last rank's, its least mincov in a middle one's) and
  whose edges lie in every rank's range of the edges; kept windows of
  every width around the kernels' narrow limit (0, 1, 2, 7, 8, 9, 16,
  K - 1, K, clamped, negative), flipped and not, each item's least kept
  position at its window's far end and smaller values outside it; a warp
  whose 32 mers are all wide; seeded mixtures; an empty window; and the
  first window alone (W 1).
- W 1 and an empty window at a small shape (`edge_batches`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .graphstate import NARROW

BIG = 1 << 30
CMAX = 8  # the engine's anchors a window (engine/devicepipe.py _CMAX)
# the engine's shapes: components and compact_state at the first item axis
# (NI, EE, NM); low_cov_pass and item_mincovs at the compact one; the caps
ENGINE_FIRST = (1552, 3872, 1536)
ENGINE_COMPACT = (528, 1568, 1536)
NCR, ECR = 512, 1536  # gpu/pipeline.py NCR_DEFAULT, ECR_DEFAULT
SMALL = (272, 704, 256)  # the JAX comparisons' shape
SMALL_CAPS = (96, 224)
K_ENGINE, K_SMALL = 41, 21
# (low_cov_threshold, min_cov_ratio): the engine's defaults, and a
# threshold of 0 so that the float test alone decides
LOWCOV_PARAMS = ((1, 0.01), (0, 0.01), (0, 1.0))


def _edges(EE: int, pairs, rng, junk: bool = False):
    """Edge rows: the alive (src, dst) pairs first, then dead rows (0, or
    junk ids past the item axis)."""
    src = np.zeros(EE, np.int64)
    dst = np.zeros(EE, np.int64)
    ea = np.zeros(EE, bool)
    if len(pairs) > EE:
        raise ValueError(f"{len(pairs)} edges do not fit EE={EE}")
    for j, (u, v) in enumerate(pairs):
        src[j], dst[j], ea[j] = u, v, True
    if junk:
        n = len(pairs)
        src[n:] = rng.integers(-5, 1 << 20, EE - n)
        dst[n:] = rng.integers(-5, 1 << 20, EE - n)
    return src, dst, ea


def _stack(wins: list) -> dict:
    return {k: np.stack([w[k] for w in wins]) for k in wins[0]}


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def _comp_window(NI, EE, rng, alive, pairs, rank=None, junk=False):
    N = NI - 2 * CMAX
    al = np.zeros(NI, bool)
    al[list(alive)] = True
    al[N:] = False  # the anchors are wired after components
    if rank is None:
        rank = np.full(NI, 1 << 28, np.int64)
        rank[:N] = rng.permutation(N)
    src, dst, ea = _edges(EE, pairs, rng, junk)
    return {"alive": al, "e_src": src, "e_dst": dst, "e_alive": ea,
            "rank": rank.astype(np.int64)}


def _path(items):
    out = []
    for u, v in zip(items, items[1:]):
        out += [(u, v), (v, u)]
    return out


def components_windows(NI: int, EE: int, seed: int):
    """(windows, names) at one shape."""
    N = NI - 2 * CMAX
    r = np.random.default_rng(seed)
    wins, names = [], []

    def add(name, *a, **k):
        wins.append(_comp_window(NI, EE, r, *a, **k))
        names.append(name)

    # ties: three components whose least rank is 7, roots 5, 10 and 20
    rank = np.full(NI, 1 << 28, np.int64)
    rank[:N] = 100 + r.permutation(N)
    rank[[11, 20, 30]] = 7
    add("ties", [5, 30, 10, 11, 12, 20, 21, 40, 41],
        _path([10, 11, 12]) + _path([20, 21]) + _path([30, 5])
        + _path([41, 40]), rank)
    # dead endpoints: 40 - (41) - 42, 50 - (51) - (52) - 53, (60) - (61)
    add("dead_bridge", [40, 42, 50, 53, 70],
        _path([40, 41, 42]) + _path([50, 51, 52, 53]) + _path([60, 61])
        + [(70, 71)])
    # item NI - 1 (dead) labelled through (0, NI - 1): the clamp hands its
    # label 0 to the unlabelled dead items 32 and 33, and through 31 to
    # the alive 30, which joins 0's component unconnected
    add("last_labelled", [0, 30],
        _path([0, NI - 1]) + _path([30, 31, 32, 33]))
    # more components than CMAX: 30 isolated items and 10 pairs
    alive = list(range(100, 130)) + list(range(200, 220))
    add("many", alive, _path([200, 201]) + _path([202, 203])
        + [(204 + 2 * q, 205 + 2 * q) for q in range(8)])
    # a chain through 600 items in shuffled index order
    order = r.permutation(min(N, 600))
    add("chain", order.tolist(), _path(order.tolist()))
    # ranks at and past BIG and below 0
    rank = np.full(NI, 1 << 28, np.int64)
    rank[:N] = r.permutation(N)
    rank[[3, 4]] = BIG
    rank[[8, 9]] = BIG + 5
    rank[14] = -7
    rank[[1, 2]] = BIG
    add("big_rank", [1, 2, 3, 4, 8, 9, 14, 15, 16],
        _path([3, 4]) + _path([8, 9]) + _path([14, 15]), rank)
    # self-loops, duplicate edges, junk in the dead rows
    add("loops_dups", list(range(0, 40)),
        [(5, 5), (6, 6), (5, 6), (5, 6), (6, 5), (7, 7)] + _path([1, 2, 3])
        + _path([1, 2, 3]), junk=True)
    add("no_edges", list(range(0, N, 7)), [])
    add("nothing_alive", [], _path([1, 2, 3]))
    for s in range(3):  # seeded: random graphs over a random alive set
        al = np.nonzero(r.random(N) < 0.7)[0].tolist()
        cand = np.nonzero(r.random(N) < 0.85)[0]
        pairs = [(int(u), int(v)) for u, v in
                 r.choice(cand, (min(EE, 3 * N // 4) // 2, 2))]
        add(f"seeded{s}", al, [p for u, v in pairs for p in ((u, v), (v, u))]
            [:EE], junk=bool(s % 2))
    return wins, names


def components_batch(shape=ENGINE_FIRST, seed: int = 11):
    NI, EE, _ = shape
    wins, names = components_windows(NI, EE, seed)
    return _stack(wins), names


# ---------------------------------------------------------------------------
# compact_state
# ---------------------------------------------------------------------------

def _state_window(NI, EE, NM, K, rng, reg, special, pairs, mer_items=None,
                  junk=False):
    """A full state window: `reg` regular alive items, `special` alive
    specials (anchors), the alive edges `pairs` (random direction and
    okey), mers onto `mer_items` (default: every item in turn)."""
    al = np.zeros(NI, bool)
    sp = np.zeros(NI, bool)
    al[list(reg)] = True
    al[list(special)] = True
    sp[list(special)] = True
    src, dst, ea = _edges(EE, pairs, rng, junk)
    if mer_items is None:
        mer_items = np.arange(NM) % NI
    lo = rng.integers(0, K + 1, NM)
    hi = np.maximum(lo, rng.integers(0, K + 1, NM))
    return {
        "alive": al, "special": sp,
        "rank": rng.integers(-3, 1 << 28, NI).astype(np.int64),
        "merlen": rng.integers(0, 30, NI).astype(np.int64),
        "n_t": rng.integers(0, 9, NI).astype(np.int64),
        "is_tumor": rng.random(NI) < 0.5, "is_normal": rng.random(NI) < 0.5,
        "comp": rng.integers(0, CMAX + 3, NI).astype(np.int64),
        "csum": rng.integers(0, 50, (NI, 4)).astype(np.int64),
        "e_src": src, "e_dst": dst,
        "e_dir": rng.integers(0, 4, EE).astype(np.int64), "e_alive": ea,
        "e_okey": rng.integers(0, 5000, EE).astype(np.int64),
        "mer_item": np.asarray(mer_items, np.int64),
        "mer_flip": rng.random(NM) < 0.5,
        "mer_pos": rng.integers(0, 30, NM).astype(np.int64),
        "keep_lo": lo.astype(np.int64), "keep_hi": hi.astype(np.int64),
        "mer_tot": rng.integers(0, 200, NM).astype(np.int64),
        "mer_totq": rng.integers(0, 400, (NM, K)).astype(np.int64)}


def _pairs_among(rng, items, n):
    items = np.asarray(list(items))
    if not len(items):
        return []
    return [(int(u), int(v)) for u, v in rng.choice(items, (n, 2))]


def compact_windows(NI, EE, NM, K, caps, seed):
    """(windows, names) at one shape, caps (NCR, ECR); no lane within the
    caps has an alive edge on a dead item."""
    ncr, ecr = caps
    N = NI - 2 * CMAX
    EC = ecr + 4 * CMAX
    r = np.random.default_rng(seed)
    anchors = list(range(N, NI))
    wins, names = [], []

    def add(name, **k):
        wins.append(_state_window(NI, EE, NM, K, r, **k))
        names.append(name)

    # mixed: regular, special, dead items; half the anchors alive
    reg = np.nonzero(r.random(N) < min(0.5, 0.8 * ncr / N))[0]
    live_anchors = anchors[::2]
    mers = r.integers(-3, NI + 4, NM)
    add("mixed", reg=reg, special=live_anchors,
        pairs=_pairs_among(r, list(reg) + anchors, min(EE, ecr) // 2),
        mer_items=mers, junk=True)
    # an alive anchor that is not special: a regular slot and its own
    reg2 = np.concatenate([reg[:ncr // 2], [N + 3]])
    add("anchor_regular", reg=reg2, special=anchors[4:],
        pairs=_pairs_among(r, list(reg2) + anchors, min(EE, ecr) // 3))
    # over: regular items past NCR, edges on dropped and dead items
    reg3 = np.arange(min(N, ncr + 20))
    add("reg_over", reg=reg3, special=anchors,
        pairs=_pairs_among(r, range(NI), min(EE, ecr) // 2))
    # over: alive edges past EC
    reg4 = np.arange(min(N, ncr // 2))
    add("edge_over", reg=reg4, special=anchors,
        pairs=_pairs_among(r, list(reg4) + anchors, min(EE, EC + 17)))
    # exactly NCR regular items and EC alive edges: within the caps
    reg5 = np.sort(r.choice(N, min(N, ncr), replace=False))
    add("exact_caps", reg=reg5, special=anchors[:6],
        pairs=_pairs_among(r, list(reg5) + anchors, min(EE, EC)))
    # dead mers only, and nothing alive
    add("dead_mers", reg=[], special=[], pairs=[],
        mer_items=r.integers(0, N, NM))
    return wins, names


def compact_batch(shape=ENGINE_FIRST, caps=(NCR, ECR), K=K_ENGINE,
                  seed: int = 21, comp: bool = True):
    NI, EE, NM = shape
    wins, names = compact_windows(NI, EE, NM, K, caps, seed)
    arrs = _stack(wins)
    if not comp:
        del arrs["comp"]
    return arrs, names


def dead_edge_batch(shape=SMALL, caps=SMALL_CAPS, K=K_SMALL):
    """Two windows within the caps: the first's alive edge touches a dead
    item (the hold-point), the second's does not."""
    NI, EE, NM = shape
    r = np.random.default_rng(5)
    N = NI - 2 * CMAX
    a = _state_window(NI, EE, NM, K, r, reg=range(10), special=[],
                      pairs=[(1, 2), (3, 40)])
    b = _state_window(NI, EE, NM, K, r, reg=range(10), special=[N],
                      pairs=[(1, 2), (3, N)])
    return _stack([a, b])


# ---------------------------------------------------------------------------
# low_cov_pass / item_mincovs
# ---------------------------------------------------------------------------

def lowcov_windows(NI, EE, NM, K, seed):
    """(windows, names, avgcov [W] float32) at one shape."""
    N = NI - 2 * CMAX
    r = np.random.default_rng(seed)
    wins, names, avg = [], [], []

    def base(reg, special=()):
        w = _state_window(NI, EE, NM, K, r, reg=reg, special=special,
                          pairs=_pairs_among(r, range(-2, NI + 2), EE // 3),
                          mer_items=r.integers(0, N, NM), junk=True)
        w["mer_totq"] = r.integers(2, 3000, (NM, K)).astype(np.int64)
        w["csum"] = r.integers(0, 60, (NI, 4)).astype(np.int64)
        return w

    # flips, trims, widths <= 0, intervals past [0, K], mer_item outside
    w = base(np.nonzero(r.random(N) < 0.8)[0], special=range(N, NI, 3))
    lo = r.integers(-4, K + 4, NM)
    w["keep_lo"] = lo
    w["keep_hi"] = lo + r.integers(-3, K, NM)
    w["mer_item"][::17] = r.integers(-4, NI + 4, len(w["mer_item"][::17]))
    big = slice(0, NM, 29)  # fully kept mers with totq past BIG
    w["keep_lo"][big], w["keep_hi"][big] = 0, K
    w["mer_totq"][big] = BIG + r.integers(1, 1000, (len(w["keep_lo"][big]),
                                                     K))
    wins.append(w)
    names.append("intervals")
    avg.append(np.float32(300.0))
    # coverage 1: tumor and normal sums equal merlen (and merlen 0)
    w = base(np.arange(N))
    w["mer_totq"][:] = 2000  # no item low by its coverage
    for i in range(0, 60, 3):
        ml = 1 + i % 7
        w["merlen"][i] = ml
        w["csum"][i] = (ml - i % 2, i % 2, ml, 0)
    w["merlen"][1] = 0
    w["csum"][1] = 0
    wins.append(w)
    names.append("coverage_one")
    avg.append(np.float32(40.0))
    # the float threshold: mincov_qv at, under and over it
    for name, av, qs in (
            ("thr_25", 2500.0, (23, 24, 25, 26, 27)),
            ("thr_2p24", float(1 << 24), ((1 << 24) - 1, 1 << 24,
                                          (1 << 24) + 1, (1 << 24) + 2,
                                          (1 << 24) + 3)),
            ("thr_1", 100.0, (0, 1, 2, 3))):
        w = base(np.arange(N))
        w["mer_totq"][:] = (1 << 25) + 10  # every other item not low
        w["keep_lo"][:], w["keep_hi"][:] = 0, K
        w["merlen"][:len(qs)] = 0  # not low by coverage 1
        for j, q in enumerate(qs):  # item j's least kept totq is q
            m = np.nonzero(w["mer_item"] == j)[0]
            if not len(m):
                w["mer_item"][j] = j
                m = [j]
            w["mer_totq"][m[0], K // 2] = q
        wins.append(w)
        names.append(name)
        avg.append(np.float32(av))
    for s in range(2):
        w = base(np.nonzero(r.random(N) < 0.9)[0], special=range(N, NI, 2))
        wins.append(w)
        names.append(f"seeded{s}")
        avg.append(np.float32(r.uniform(50, 5000)))
    return wins, names, np.array(avg, np.float32)


def lowcov_batch(shape=ENGINE_COMPACT, K=K_ENGINE, seed: int = 31):
    NI, EE, NM = shape
    wins, names, avg = lowcov_windows(NI, EE, NM, K, seed)
    return _stack(wins), names, avg


# the low-coverage kernels' cluster ranges: NM and EE multiples of neither
# 32 nor any cluster size; K past the narrow limit up to MAX_K
RANGES = (272, 705, 1001)
RANGE_KS = (63, 64)
HUB = 5  # the item whose donors and edges span every rank's range


def ranges_windows(NI, EE, NM, K, seed):
    """(windows, names, avgcov [W] float32) at one shape: every_rank,
    widths, seeded and empty (see the module's docstring). Every other
    item's kept totq is 5,000 or more, so at avgcov 1,000 only the crafted
    minima are low."""
    N = NI - 2 * CMAX
    r = np.random.default_rng(seed)
    wins, names = [], []

    def base():
        items = r.integers(0, N, NM)
        items[items == HUB] = HUB + 1
        w = _state_window(NI, EE, NM, K, r, reg=np.arange(N),
                          special=range(N, NI, 2),
                          pairs=_pairs_among(r, range(NI), EE // 3),
                          mer_items=items, junk=True)
        w["mer_totq"] = r.integers(5000, 9000, (NM, K)).astype(np.int64)
        w["mer_tot"] = r.integers(5000, 9000, NM).astype(np.int64)
        w["keep_lo"] = r.integers(0, K, NM).astype(np.int64)
        w["keep_hi"] = w["keep_lo"] + 1
        w["merlen"] = r.integers(1, 30, NI).astype(np.int64)
        w["csum"] = r.integers(31, 60, (NI, 4)).astype(np.int64)
        return w

    # HUB's donors in every rank's range (the ends and the quarters), its
    # least totq in the last rank's (low at every LOWCOV_PARAMS), its least
    # tot in a middle one's; its edges at the ends and quarters of the
    # edge axis
    w = base()
    donors = (0, NM // 4 + 3, NM // 2 + 1, 3 * NM // 4 + 2, NM - 1)
    for q, m in enumerate(donors):
        w["mer_item"][m] = HUB
        w["keep_lo"][m], w["keep_hi"][m] = q, q + 1
        w["mer_flip"][m] = False
        w["mer_totq"][m, q] = (40, 30, 20, 15, 7)[q]  # low at the last
        w["mer_tot"][m] = 50 + abs(q - 2)  # 50 at the middle
    for j, e in enumerate((0, EE // 4 + 1, EE // 2, 3 * EE // 4, EE - 1)):
        w["e_alive"][e] = True
        w["e_src"][e], w["e_dst"][e] = ((HUB, 7 + j) if j % 2
                                        else (9 + j, HUB))
    wins.append(w)
    names.append("every_rank")
    # kept windows of every width, each its own item, spread over the mer
    # axis; a warp of 32 wide mers
    w = base()
    widths = [0, 1, 2, NARROW - 1, NARROW, NARROW + 1, 16, K - 1, K]
    cases = [(wd, f) for wd in widths for f in (False, True)]
    cases += [("clamped", False), ("clamped", True), ("negative", False)]
    step = NM // len(cases)
    for j, (wd, f) in enumerate(cases):
        m = j * step + 7
        item = 20 + j
        w["mer_item"][m] = item
        w["mer_flip"][m] = f
        w["mer_tot"][m] = 10 + j  # the item's least, where it donates
        if wd == "clamped":  # past [0, K] on both sides: all K kept
            lo, hi = -3, K + 2
        elif wd == "negative":
            lo, hi = 5, 3
        else:
            lo = min(2, K - wd)
            hi = lo + wd
        w["keep_lo"][m], w["keep_hi"][m] = lo, hi
        clo = max(0, min(K, K - hi if f else lo))
        chi = max(0, min(K, K - lo if f else hi))
        w["mer_totq"][m] = 1  # outside the kept window: never read
        w["mer_totq"][m, clo:chi] = 7000
        if chi > clo:
            w["mer_totq"][m, chi - 1] = 200 + j  # the far end's
    wide = np.arange(64, 96)
    w["mer_item"][wide] = 100 + wide % 8
    w["keep_lo"][wide], w["keep_hi"][wide] = 0, K
    w["mer_totq"][wide, (wide * 7) % K] = 300 + wide
    wins.append(w)
    names.append("widths")
    # seeded: mostly one kept position, some wide and some empty windows
    w = base()
    lo = r.integers(-2, K + 2, NM)
    w["keep_lo"] = lo.astype(np.int64)
    w["keep_hi"] = (lo + r.choice([1, 1, 1, 1, 1, 1, 2, NARROW,
                                   NARROW + 1, K, 0, -1], NM)).astype(
                                       np.int64)
    w["mer_totq"] = r.integers(2, 3000, (NM, K)).astype(np.int64)
    wins.append(w)
    names.append("seeded")
    # empty: nothing alive, no alive edge, no donating mer
    w = _state_window(NI, EE, NM, K, r, reg=[], special=[], pairs=[])
    w["keep_hi"] = w["keep_lo"].copy()
    wins.append(w)
    names.append("empty")
    return wins, names, np.full(len(wins), 1000.0, np.float32)


def ranges_batch(K: int, shape=RANGES, seed: int = 41):
    NI, EE, NM = shape
    wins, names, avg = ranges_windows(NI, EE, NM, K, seed)
    return _stack(wins), names, avg


# ---------------------------------------------------------------------------
# every batch
# ---------------------------------------------------------------------------

def edge_batches():
    """W 1 (a seeded window) and an empty window (nothing alive, no alive
    edge) at the small shape, for every function:
    [(name, function, arrays, params)]."""
    NI, EE, NM = SMALL
    c, _ = components_batch(SMALL, seed=12)
    s, _ = compact_batch(SMALL, SMALL_CAPS, K_SMALL, seed=22)
    lc, _, avg = lowcov_batch(SMALL, K_SMALL, seed=32)
    last = slice(-1, None)
    e = _stack([_state_window(NI, EE, NM, K_SMALL, np.random.default_rng(2),
                              reg=[], special=[], pairs=[])])
    out = []
    for tag, c, s, lc, avg in (
            ("w1", {k: v[last] for k, v in c.items()},
             {k: v[last] for k, v in s.items()},
             {k: v[last] for k, v in lc.items()}, avg[last]),
            ("empty", _stack([_comp_window(NI, EE, np.random.default_rng(1),
                                           [], [])]), e, e,
             np.array([10.0], np.float32))):
        out += [(tag, "components", c, {}),
                (tag, "compact_state", s, {"caps": SMALL_CAPS}),
                (tag, "item_mincovs", lc, {"K": K_SMALL}),
                (tag, "low_cov_pass", lc, {"K": K_SMALL, "avgcov": avg,
                                           "params": LOWCOV_PARAMS[0]})]
    return out


def batches():
    """Every batch: [(name, function, arrays, params)]: the engine's
    shapes, the small shape, the cluster ranges' (`ranges_batch` at each
    of RANGE_KS, its first window alone), W 1 and the empty window."""
    out = []
    for tag, shape, caps, K in (("engine", None, (NCR, ECR), K_ENGINE),
                                ("small", SMALL, SMALL_CAPS, K_SMALL)):
        c, _ = components_batch(shape or ENGINE_FIRST,
                                seed=11 if shape is None else 12)
        s, _ = compact_batch(shape or ENGINE_FIRST, caps, K,
                             seed=21 if shape is None else 22)
        lc, _, avg = lowcov_batch(shape or ENGINE_COMPACT, K,
                                  seed=31 if shape is None else 32)
        out.append((tag, "components", c, {}))
        out.append((tag, "compact_state", s, {"caps": caps}))
        nc = dict(s)
        del nc["comp"]
        out.append((f"{tag}_no_comp", "compact_state", nc, {"caps": caps}))
        out.append((tag, "item_mincovs", lc, {"K": K}))
        out.append((f"{tag}_sliced", "item_mincovs", lc,
                    {"K": K, "totq_pad": 64}))
        for p in LOWCOV_PARAMS:
            out.append((f"{tag}_lct{p[0]}_r{p[1]}", "low_cov_pass", lc,
                        {"K": K, "avgcov": avg, "params": p}))
        out.append((f"{tag}_sliced", "low_cov_pass", lc,
                    {"K": K, "avgcov": avg, "params": LOWCOV_PARAMS[0],
                     "totq_pad": 64}))
    for K in RANGE_KS:
        rb, _, avg = ranges_batch(K)
        out.append((f"ranges_k{K}", "item_mincovs", rb, {"K": K}))
        for p in LOWCOV_PARAMS:
            out.append((f"ranges_k{K}_lct{p[0]}_r{p[1]}", "low_cov_pass", rb,
                        {"K": K, "avgcov": avg, "params": p}))
    rb, _, avg = ranges_batch(RANGE_KS[0])
    first = {k: v[:1] for k, v in rb.items()}
    out.append(("ranges_w1", "item_mincovs", first, {"K": RANGE_KS[0]}))
    out.append(("ranges_w1", "low_cov_pass", first,
                {"K": RANGE_KS[0], "avgcov": avg[:1],
                 "params": LOWCOV_PARAMS[2]}))
    return out + edge_batches()


def to_torch(arrs: dict, dev="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrs.items()}


def state(arrs: dict, params: dict, dev="cpu") -> dict:
    """The batch's state dict on `dev` (params["totq_pad"]: mer_totq the
    first NM of NM + pad mers, a slice as the engine's is)."""
    st = to_torch(arrs, dev)
    pad = params.get("totq_pad", 0)
    if pad:
        t = st["mer_totq"]
        W, NM, K = t.shape
        wide = torch.full((W, NM + pad, K), -1, dtype=t.dtype, device=dev)
        wide[:, :NM] = t
        st["mer_totq"] = wide[:, :NM]
    return st


def run(func: str, arrs: dict, params: dict, dev="cpu", plain=False,
        guard=contextlib.nullcontext):
    """gpu.stages' function (or its plain version) on the batch on `dev`,
    inside the context `guard()` (the inputs' copies and the outputs'
    outside it), its state from `state`; returns its outputs on the host
    as a flat dict of tensors;
    components (comp, numcomp, over); compact_state the rewritten
    keys, over and dead_edge; item_mincovs (mincov,
    mincov_qv); low_cov_pass (alive, e_alive, any)."""
    from . import stages

    st = state(arrs, params, dev)
    avg = (torch.from_numpy(params["avgcov"]).to(dev) if "avgcov" in params
           else None)
    NI = arrs["alive"].shape[1]
    N = NI - 2 * CMAX
    real = getattr(stages, f"{func}_plain" if plain else func)

    def fn(*a):
        with guard():
            return real(*a)
    if func == "components":
        out = fn(st["alive"], st["e_src"], st["e_dst"], st["e_alive"],
                 st["rank"], CMAX)
        res = dict(zip(("comp", "numcomp", "over"), out))
    elif func == "compact_state":
        ncr, ecr = params["caps"]
        out = fn(st, N, NI, CMAX, ncr, ecr)
        res = {k: out[0][k] for k in COMPACT_KEYS if k in out[0]}
        res["over"] = out[1]
        res["dead_edge"] = out[2]
    elif func == "item_mincovs":
        res = dict(zip(("mincov", "mincov_qv"),
                       fn(st, params["K"], N, NI)))
    else:
        lct, ratio = params["params"]
        out, low_any = fn(st, params["K"], N, NI, lct, ratio, avg)
        res = {"alive": out["alive"], "e_alive": out["e_alive"],
               "any": low_any}
    return {k: v.cpu() for k, v in res.items()}


COMPACT_KEYS = ("alive", "special", "rank", "merlen", "n_t", "is_tumor",
                "is_normal", "comp", "csum", "e_src", "e_dst", "e_dir",
                "e_alive", "e_okey", "mer_item", "keep_lo", "keep_hi")
