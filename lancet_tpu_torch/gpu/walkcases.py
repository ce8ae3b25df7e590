"""Crafted inputs for the four walks of csrc/walks.cu: graphs for the two
that stage a window's graph in shared memory and walk it (K1
`path_cover`, K4 `cycle_dfs`): the corners where their order of work
decides the result, their overflow flags, and shapes that take each
staging mode; path strings for K3 `almost_repeat_paths`: hits at the edges
of its shift, start, tile and word ranges, mismatch budgets at and past
their limits, odd codes and the engine's longest strings; and states for
K2 `seq_removal`, the whole removal pass: chained kills, rank ties, more
live items than slots, a source past D2 edges, self-loops, duplicate
edges and edges to dead items or anchors, empty windows, the guard of the
links mode. `tests/test_torch_walks_crafted.py` holds the plain versions
on these cases against the JAX package, and `chip_smoke.py` the kernels
against the plain versions on the card.

Each case is a dict of numpy arrays and ints, one lane (window) per row,
with the edge lists' creation order as their okey order (so a lane's
adjacency slots follow the order its edges are listed in). Items
[0, N) are regular; component c's source and sink anchors are the special
items N + 2(c-1) and N + 2(c-1) + 1.
"""

from __future__ import annotations

import numpy as np
import torch

FF, FR, RF, RR = 0, 1, 2, 3  # edge directions: start bit << 1 | dest bit


def edge_arrays(lanes, EE: int):
    """Edge lists [(src, dst, dir), ...] per lane -> e_src, e_dst, e_dir,
    e_alive, e_okey [W, EE] (okey = position in the list; unused rows dead
    with okey 1 << 30)."""
    W = len(lanes)
    e = np.zeros((5, W, EE), np.int64)
    e[4] = 1 << 30
    for w, edges in enumerate(lanes):
        assert len(edges) <= EE
        for i, (s, d, r) in enumerate(edges):
            e[:, w, i] = (s, d, r, 1, i)
    return e[0], e[1], e[2], e[3].astype(bool), e[4]


def _items(W: int, N: int, Cmax: int, live_comps=1):
    """alive and special [W, NI]: every regular item alive, the anchors of
    the first `live_comps` components alive, every anchor special."""
    NI = N + 2 * Cmax
    alive = np.zeros((W, NI), bool)
    alive[:, :N] = True
    alive[:, N:N + 2 * live_comps] = True
    special = np.zeros((W, NI), bool)
    special[:, N:] = True
    return alive, special


def _cycle_case(lanes, N, Cmax, D2, EE, live_comps=1, mask=None):
    W = len(lanes)
    alive, special = _items(W, N, Cmax, live_comps)
    e_src, e_dst, e_dir, e_alive, e_okey = edge_arrays(lanes, EE)
    return dict(e_src=e_src, e_dst=e_dst, e_dir=e_dir, e_alive=e_alive,
                e_okey=e_okey, alive=alive, special=special,
                lane_mask=(np.ones((W, Cmax), bool) if mask is None
                           else mask),
                N=N, NI=N + 2 * Cmax, Cmax=Cmax, D2=D2)


def _chain(src: int, items, sink: int, d=FF):
    path = [src, *items, sink]
    return [(a, b, d) for a, b in zip(path, path[1:])]


def cycle_cases() -> dict:
    """has_cycle_seq inputs, and the flags [W, Cmax] the reference's
    hasCycleRec gives where they were worked out by hand (else None)."""
    cases = {}

    # item 0 (v) and item 1 (x); src 8 and sink 9. Lane 0 enters v from
    # src first: v -> x -> v (as R) finds v GREY, a cycle. Lane 1 lists
    # src -> x first: x -> v (R) blackens v (no R edge leaves it), so
    # src -> v later finds it BLACK: no cycle. The edges into the sink (a
    # special item) are never entered.
    N = 8
    src, snk = N, N + 1
    tail = [(0, 1, FF), (1, 0, FR), (0, snk, FF), (1, snk, FF)]
    c = _cycle_case([[(src, 0, FF), (src, 1, FF)] + tail,
                     [(src, 1, FF), (src, 0, FF)] + tail], N, 1, 16, 16)
    c["expect"] = np.array([[True], [False]])
    cases["slot_order"] = c

    # four components in one window, each with its own source: a
    # directed cycle, an acyclic chain, an item reached as R then as F,
    # and a cycle that lane 0 masks out; lane 1 unmasks it and kills the
    # second component's source
    N, Cmax = 12, 4
    s = [N + 2 * c for c in range(Cmax)]
    edges = ([(s[0], 0, FF), (0, 1, FF), (1, 0, FF), (1, s[0] + 1, FF)]
             + _chain(s[1], [2, 3, 4], s[1] + 1)
             + [(s[2], 5, FF), (5, 6, FR), (6, 7, RF), (7, 6, FF),
                (6, s[2] + 1, FF)]
             + [(s[3], 8, FF), (8, 9, FF), (9, 8, FF), (9, s[3] + 1, FF)])
    mask = np.ones((2, Cmax), bool)
    mask[0, 3] = False
    c = _cycle_case([edges, edges], N, Cmax, 16, 64, live_comps=Cmax,
                    mask=mask)
    c["alive"][1, s[1]] = False
    c["expect"] = np.array([[True, False, True, False],
                            [True, False, True, True]])
    cases["several_components"] = c

    # the deepest walk: a chain through every regular item of the first
    # bucket's shape (NI 1,552, D2 16), acyclic in lane 0 (the stack holds
    # all 1,536 items and the source, then unwinds), and closed by a back
    # edge in lane 1 (the cycle is found at the deepest frame)
    N, Cmax = 1536, 8
    chain = _chain(N, range(N), N + 1)
    c = _cycle_case([chain, chain + [(N - 1, 0, FF)]], N, Cmax, 16,
                    3840 + 4 * Cmax)
    c["expect"] = np.zeros((2, Cmax), bool)
    c["expect"][1, 0] = True
    cases["stack_bound"] = c

    # the largest bucket (NI 4,112 at D2 16: the successor lists take the
    # global mode): lane 0 a chain through all 4,096 items, lane 1 a seeded
    # random graph with mixed directions and three live components
    N, Cmax, EE = 4096, 8, 10240 + 4 * 8
    rng = np.random.default_rng(4112)
    rand = [(N + 2 * c, int(v), FF) for c in range(3)
            for v in rng.integers(0, N, 3)]
    rand += [(int(a), int(b), int(d)) for a, b, d in zip(
        rng.integers(0, N, 9000), rng.integers(0, N, 9000),
        rng.integers(0, 4, 9000))]
    c = _cycle_case([_chain(N, range(N), N + 1), rand], N, Cmax, 16, EE,
                    live_comps=3)
    c["expect"] = None
    cases["largest_bucket"] = c
    return cases


CYCLE_ARGS = ("e_src", "e_dst", "e_dir", "e_alive", "e_okey", "alive",
               "special")


def _t(a, dev):
    a = np.asarray(a)
    return torch.from_numpy(a.copy() if a.dtype == bool
                            else a.astype(np.int64)).to(dev)


def run_cycle(c: dict, dev="cpu"):
    """A cycle case through the port's stages.has_cycle_seq on `dev`:
    (flags [W, Cmax], adjacency overflow [W])."""
    from . import stages

    return stages.has_cycle_seq(*[_t(c[k], dev) for k in CYCLE_ARGS],
                                c["N"], c["NI"], c["Cmax"], D2=c["D2"],
                                lane_mask=_t(c["lane_mask"], dev))


def run_cover(c: dict, dev="cpu"):
    """A path cover case through the port's pipeline.path_cover on
    `dev`: its output dict."""
    from . import pipeline

    def tree(x):
        return ({k: tree(v) for k, v in x.items()} if isinstance(x, dict)
                else _t(x, dev))

    return pipeline.path_cover(tree(c["st"]), tree(c["res"]), c["K"],
                               c["N"], c["NI"], c["Cmax"],
                               _t(c["reflens"], dev), c["dfs_limit"],
                               c["max_indel"], **c["caps"])


def _dag_lane(rng, N, n_nodes, width, extra):
    """A layered DAG over items 0..n_nodes-1 from component 1's source
    anchor N to its sink anchor N+1: (src, dst, dir) edges, all FF."""
    layers = [list(range(i, min(i + width, n_nodes)))
              for i in range(0, n_nodes, width)]
    edges = [(N, v, FF) for v in layers[0]]
    for a, b in zip(layers, layers[1:]):
        for u in a:
            for v in b:
                if rng.random() < extra:
                    edges.append((u, v, FF))
        for v in b:  # every node reached
            edges.append((a[rng.integers(len(a))], v, FF))
    edges += [(u, N + 1, FF) for u in layers[-1]]
    return edges


def _cover_case(lanes, N, Cmax, EE, caps, rng, dfs_limit=1 << 30,
                numcomp=1, merlen=None):
    W = len(lanes)
    alive, special = _items(W, N, Cmax, numcomp)
    e_src, e_dst, e_dir, e_alive, e_okey = edge_arrays(lanes, EE)
    NI = N + 2 * Cmax
    st = dict(e_src=e_src, e_dst=e_dst, e_dir=e_dir, e_alive=e_alive,
              e_okey=e_okey, special=special, alive=alive,
              merlen=(rng.integers(1, 4, (W, NI)) if merlen is None
                      else merlen).astype(np.int64))
    ends = dict(anchored=np.ones((W, Cmax), bool),
                dist=np.full((W, Cmax), 10_000, np.int64),
                src_pos=np.zeros((W, Cmax), np.int64))
    res = dict(ends=ends, cyc1=np.zeros((W, Cmax), bool),
               cyc2=np.zeros((W, Cmax), bool),
               numcomp=np.full(W, numcomp, np.int64))
    return dict(st=st, res=res, reflens=ends["dist"], K=11, N=N, NI=NI,
                Cmax=Cmax, dfs_limit=dfs_limit, max_indel=10_000,
                caps=caps)


def path_cover_cases() -> dict:
    """pipeline.path_cover inputs (st, res, reflens, the scalars and the
    caps Q, POPMAX, JMAX, PN, D2) and the expected fallback flags [W]."""
    rng = np.random.default_rng(5)
    small = dict(Q=48, POPMAX=40, JMAX=3, PN=12, D2=24)
    roomy = dict(Q=512, POPMAX=1024, JMAX=8, PN=24, D2=24)
    cases = {}

    # equal-score paths: two diamonds (component 1, then 2) and a fan of
    # three parallel 2-hop paths; every merlen 1. The first path found
    # (the earlier slot) wins each tie, then the uncovered one follows
    N, Cmax = 16, 2
    s1, t1, s2, t2 = N, N + 1, N + 2, N + 3
    lane0 = [(s1, 0, FF), (s1, 1, FF), (0, 2, FF), (1, 2, FF), (2, t1, FF),
             (s2, 3, FF), (s2, 4, FF), (3, t2, FF), (4, t2, FF)]
    lane1 = [(s1, 5, FF), (s1, 6, FF), (s1, 7, FF), (5, t1, FF),
             (6, t1, FF), (7, t1, FF), (s2, 8, FF), (8, t2, FF)]
    c = _cover_case([lane0, lane1], N, Cmax, 64, roomy, rng, numcomp=2,
                    merlen=np.ones((2, N + 2 * Cmax)))
    c["expect_fallback"] = [False, False]
    cases["fifo_ties"] = c

    N, Cmax = 40, 2
    c = _cover_case([_dag_lane(rng, N, 36, 6, 0.9),
                     _dag_lane(rng, N, 8, 2, 0.0)], N, Cmax, 400, small,
                    rng)
    c["expect_fallback"] = [True, False]
    cases["queue_overflow"] = c

    c = _cover_case([_dag_lane(rng, N, 24, 4, 0.6),
                     _dag_lane(rng, N, 6, 2, 0.0)], N, Cmax, 400,
                    dict(small, Q=400), rng)
    c["expect_fallback"] = [True, False]
    cases["popmax"] = c

    # the DFS visit limit stops a round early without a fallback: lane 0
    # stops before any entry reaches its sink, lane 1 finds its paths
    # within the limit
    c = _cover_case([_dag_lane(rng, N, 24, 4, 0.6),
                     _dag_lane(rng, N, 8, 2, 0.0)], N, Cmax, 400, roomy,
                    rng, dfs_limit=14)
    c["expect_fallback"] = [False, False]
    cases["dfs_limit"] = c

    c = _cover_case([_chain(N, range(30), N + 1),
                     _chain(N, range(5), N + 1)], N, Cmax, 400, small, rng)
    c["expect_fallback"] = [True, False]
    cases["longer_than_pn"] = c

    # staged words beyond a block's shared memory beside the queue (NI
    # 1,216 x D2 24 x 8 bytes): the global mode
    N, Cmax = 1200, 8
    c = _cover_case([_dag_lane(rng, N, 20, 2, 0.0),
                     _dag_lane(rng, N, 12, 3, 0.2)], N, Cmax, 1536 + 32,
                    roomy, rng)
    c["expect_fallback"] = [False, False]
    cases["global_mode"] = c
    return cases


def _plant(row, p: int, d: int, K: int, n_mis: int, rng, guard=False):
    """Copy row[p:p+K+1] to row[p+d:...] position by position (so that a
    copy overlapping its source repeats with period d), then change n_mis
    of the copied codes, away from the window's ends (a neighbouring start
    that dropped one would need as many chance matches as it dropped).
    With `guard`, the codes just before the source and just after the copy
    are made to differ from their partners at shift d, so that no
    neighbouring start matches exactly."""
    for q in range(K + 1):
        row[p + d + q] = row[p + q]
    for q in rng.choice(np.arange(K // 4, K + 1 - K // 4), n_mis,
                        replace=False):
        row[p + d + q] = (row[p + d + q] + 1) % 4
    if guard:
        if p >= 1:
            row[p - 1] = (row[p - 1 + d] + 1) % 4
        if p + d + K + 1 < len(row):
            row[p + d + K + 1] = (row[p + K + 1] + 1) % 4


def _repeat_case(rows, lens, K, mm, expect, LP):
    """One call: the strings as [1, J, LP] int8 (codes past a length
    random), lens [1, J] and the verdicts worked out by construction."""
    seq = np.stack([np.asarray(r, np.int64) for r in rows])[None]
    assert seq.shape[2] == LP
    return dict(seq=seq.astype(np.int8), lens=np.array([lens], np.int64),
                K=K, mm=mm, expect=np.array([expect], bool))


def almost_repeat_cases() -> dict:
    """almost_repeat_paths inputs (one K and max_mismatch a case, as a
    call takes them) and the verdicts [1, J] each string was built to
    give. Random strings are of the codes 0-3 at K >= 15, where a chance
    window of at most mm mismatches is unlikely (< 0.3% a string); the
    tests hold the verdicts against the JAX package as well."""
    rng = np.random.default_rng(1728)
    cases = {}

    def rand(LP):
        return rng.integers(0, 4, LP)

    # the largest shift d = maxp (p = 0) with exactly mm = 2 mismatches,
    # then mm + 1
    K, LP, L = 15, 256, 200
    maxp = L - K - 1
    rows = [rand(LP) for _ in range(2)]
    _plant(rows[0], 0, maxp, K, 2, rng)
    _plant(rows[1], 0, maxp, K, 3, rng)
    cases["largest_shift"] = _repeat_case(rows, [L, L], K, 2,
                                          [True, False], LP)
    # an exact copy whose window ends at the last code (p = maxp - d),
    # then the same string one code shorter, where that window passes the
    # end (and the start before it is guarded)
    row = rand(LP)
    _plant(row, maxp - 37, 37, K, 0, rng, guard=True)
    cases["last_start"] = _repeat_case([row, row], [L, L - 1], K, 0,
                                       [True, False], LP)

    # exactly mm mismatches beside mm + 1, at mm 3 and at mm 0
    K, LP = 19, 128
    for mm in (3, 0):
        rows = [rand(LP) for _ in range(2)]
        _plant(rows[0], 30, 20, K, mm, rng)
        _plant(rows[1], 30, 20, K, mm + 1, rng)
        cases[f"mm{mm}_at_and_past"] = _repeat_case(
            rows, [LP - 3, LP - 3], K, mm, [True, False], LP)

    # len K+1 (no shift) and K+2 (one shift, d = 1 and p = 0), a string of
    # period 2 at len K+2, an empty slot, an all-N string and a random one
    K, LP = 15, 40
    rows = [np.zeros(LP, np.int64), np.zeros(LP, np.int64),
            np.arange(LP) % 2, rand(LP), np.full(LP, 4), rand(LP)]
    cases["short_strings"] = _repeat_case(
        rows, [K + 1, K + 2, K + 2, 0, LP, LP], K, 1,
        [False, True, False, False, True, False], LP)

    # a budget below 0 never hits; K+1 mismatches or more always, once
    # there is a shift
    K, LP = 15, 64
    rows = [np.zeros(LP, np.int64), rand(LP), rand(LP), rand(LP)]
    cases["mm_negative"] = _repeat_case(rows, [LP, LP, K + 2, 0], K, -1,
                                        [False] * 4, LP)
    for mm in (K + 1, 10**6):
        cases[f"mm_{mm}"] = _repeat_case(
            rows, [LP, K + 1, K + 2, 0], K, mm, [True, False, True, False],
            LP)

    # N codes (4): two copies of a window holding Ns match each other;
    # an N against a base is a mismatch; an all-N string repeats
    K, LP = 17, 160
    rows = [rand(LP) for _ in range(3)]
    rows[0][40:40 + K + 1:3] = 4
    _plant(rows[0], 40, 55, K, 0, rng)
    rows[1][40:40 + K + 1:3] = 4
    _plant(rows[1], 40, 55, K, 0, rng)
    rows[1][40 + 55 + 3] = 2  # one N of the copy becomes a base
    rows[2][:] = 4
    cases["n_codes"] = _repeat_case(rows, [LP, LP, 120], K, 0,
                                    [True, False, True], LP)

    # codes outside 0-4 (any int8 value compares by equality)
    K, LP = 17, 160
    odd = np.array([-128, 127, -1, 50])
    rows = [odd[rand(LP)] for _ in range(2)]
    for q in range(K + 1):
        rows[0][70 + 33 + q] = rows[0][70 + q]
    cases["odd_codes"] = _repeat_case(rows, [LP, LP], K, 2, [True, False],
                                      LP)

    # the engine's string width LP 1,728, full and one short: no repeat,
    # the largest shift, the last start
    K, LP = 19, 1728
    rows = [rand(LP) for _ in range(3)]
    maxp = LP - K - 1
    _plant(rows[1], 0, maxp, K, 2, rng)
    _plant(rows[2], maxp - 1 - 900, 900, K, 1, rng)
    cases["full_lp"] = _repeat_case(rows, [LP, LP, LP - 1], K, 2,
                                    [False, True, True], LP)

    # exact hits (mm 0, neighbours guarded) at the edges of the kernel's
    # 32-start words and 64-start tiles (K <= 32) for shifts 1, 2 and 5,
    # on strings whose start counts straddle those edges, and one string
    # with no hit at 129 starts of shift 1
    K, LP = 19, 224
    spec = [(64, 1, 63), (65, 1, 64), (64, 2, 62), (100, 5, 31),
            (100, 5, 32), (128, 128, 0), (96, 3, 93 - 1)]
    rows, lens = [], []
    for maxp, d, p in spec:
        r = rand(LP)
        _plant(r, p, d, K, 0, rng, guard=True)
        rows.append(r)
        lens.append(maxp + K + 1)
    rows.append(rand(LP))
    lens.append(128 + K + 1)
    cases["tile_edges"] = _repeat_case(rows, lens, K, 0,
                                       [True] * len(spec) + [False], LP)

    # K 33 (a window's bits pass a second word; tiles of 128 starts): hits
    # at starts 31, 32, 127 and 128; K 63, the largest, at exactly mm and
    # mm + 1, with len K+1 and K+2
    K, LP = 33, 320
    rows, lens = [], []
    for p in (31, 32, 127, 128):
        r = rand(LP)
        _plant(r, p, 7, K, 0, rng, guard=True)
        rows.append(r)
        lens.append(p + 7 + K + 1 + 20)
    cases["k33_word_and_tile_edges"] = _repeat_case(rows, lens, K, 0,
                                                    [True] * 4, LP)
    K, LP = 63, 300
    rows = [rand(LP) for _ in range(2)] + [np.zeros(LP, np.int64)] * 2
    _plant(rows[0], 10, 150, K, 5, rng)
    _plant(rows[1], 10, 150, K, 6, rng)
    cases["k63"] = _repeat_case(rows, [LP, LP, K + 1, K + 2], K, 5,
                                [True, False, False, True], LP)
    return cases


def run_almost_repeat(c: dict, dev="cpu"):
    """An almost-repeat case through the port's walks.almost_repeat on
    `dev`: is_rep [1, J] bool."""
    from . import walks

    return walks.almost_repeat(_t(c["seq"], dev), _t(c["lens"], dev),
                               c["K"], c["mm"])


def _removal_case(lanes, NI, EE, U, D2, mode, max_len, thr=None):
    """One removal-pass call. Each lane is a dict: `live` (regular live
    items), `special` (live anchors), `dead` items are the rest; `rank`
    {item: rank} (default: the item id), `merlen` {item: len} (default
    1), `mincov` and `guard` {item: value} (links mode; default 0 and
    False), `edges` [(src, dst)] alive in that order, `dead_edges` [(src,
    dst)] listed dead after them (their endpoints may lie outside [0,
    NI))."""
    W = len(lanes)
    a = dict(alive=np.zeros((W, NI), bool), special=np.zeros((W, NI), bool),
             rank=np.tile(np.arange(NI, dtype=np.int64), (W, 1)),
             merlen=np.ones((W, NI), np.int64),
             mincov=np.zeros((W, NI), np.int64),
             guard=np.zeros((W, NI), bool),
             e_src=np.zeros((W, EE), np.int64),
             e_dst=np.zeros((W, EE), np.int64),
             e_alive=np.zeros((W, EE), bool))
    for w, ln in enumerate(lanes):
        for i in ln.get("live", ()):
            a["alive"][w, i] = True
        for i in ln.get("special", ()):
            a["alive"][w, i] = a["special"][w, i] = True
        for key in ("rank", "merlen", "mincov", "guard"):
            for i, v in ln.get(key, {}).items():
                a[key][w, i] = v
        edges = list(ln.get("edges", ()))
        dead = list(ln.get("dead_edges", ()))
        assert len(edges) + len(dead) <= EE
        for e, (s, d) in enumerate(edges + dead):
            a["e_src"][w, e], a["e_dst"][w, e] = s, d
            a["e_alive"][w, e] = e < len(edges)
    st = {k: a[k] for k in ("alive", "special", "rank", "merlen", "e_src",
                            "e_dst", "e_alive")}
    return dict(st=st, mode=mode, max_len=max_len, mincov=a["mincov"],
                thr=np.zeros(W, np.int64) if thr is None
                else np.asarray(thr, np.int64),
                guard=a["guard"], U=U, D2=D2)


def _both_ways(*pairs):
    """Each (a, b) as the two directed edges a -> b and b -> a."""
    return [e for a, b in pairs for e in ((a, b), (b, a))]


def removal_cases() -> dict:
    """Removal-pass inputs (the state, the mode and its scalars, U, D2)
    and, where worked out by hand, the items each lane removes
    ("expect_removed") and the overflow flags ("expect_over")."""
    cases = {}

    # a chain 0-1-2-3 of short items hung on item 4 (long: never killed).
    # Lane 0 sweeps the chain from its free end: each kill makes the next
    # slot a tip, so the whole chain goes. Lane 1 sweeps it from 3 (degree
    # 2 at its slot, kept) towards 0: only 0, the one tip, goes. Lane 2:
    # two chains in one window, and a tip whose neighbour is an anchor
    chain = _both_ways((0, 1), (1, 2), (2, 3), (3, 4))
    cases["chained_tips"] = _removal_case([
        dict(live=range(5), merlen={4: 50}, edges=chain),
        dict(live=range(5), merlen={4: 50}, edges=chain,
             rank={0: 4, 1: 3, 2: 2, 3: 1, 4: 0}),
        dict(live=range(8), special=[9], merlen={4: 50},
             edges=chain + _both_ways((5, 6), (6, 7), (7, 9)))],
        NI=10, EE=32, U=10, D2=4, mode="tips", max_len=10)
    cases["chained_tips"]["expect_removed"] = [[0, 1, 2, 3], [0],
                                               [0, 1, 2, 3, 5, 6, 7]]

    # z (long) - a - b, a and b of equal rank: the lower id goes first.
    # Lane 0 (a = 1, b = 2): a has degree 2 at its slot and stays, b goes.
    # Lane 1 (a = 2, b = 1): b goes first, then a is a tip and goes. Lane
    # 2: five items of one rank in a star around item 0 (long)
    cases["rank_ties"] = _removal_case([
        dict(live=[0, 1, 2], merlen={0: 50}, rank={0: 3, 1: 7, 2: 7},
             edges=_both_ways((0, 1), (1, 2))),
        dict(live=[0, 1, 2], merlen={0: 50}, rank={0: 3, 1: 7, 2: 7},
             edges=_both_ways((0, 2), (2, 1))),
        dict(live=range(6), merlen={0: 50}, rank={i: 2 for i in range(6)},
             edges=_both_ways(*[(0, i) for i in range(1, 6)]))],
        NI=8, EE=24, U=8, D2=8, mode="tips", max_len=10)
    cases["rank_ties"]["expect_removed"] = [[2], [1, 2], [1, 2, 3, 4, 5]]

    # more live items than slots: lane 0 has 6 isolated tips and U 4, so
    # the last two in rank order stay and over is set; lane 1 exactly U
    iso = dict(rank={0: 5, 1: 0, 2: 4, 3: 1, 4: 3, 5: 2})
    cases["n_over_u"] = _removal_case([
        dict(live=range(6), **iso), dict(live=range(4), **iso)],
        NI=8, EE=4, U=4, D2=2, mode="tips", max_len=10)
    cases["n_over_u"]["expect_removed"] = [[1, 3, 5, 4], [1, 3, 2, 0]]
    cases["n_over_u"]["expect_over"] = [True, False]

    # a hub (item 0) of 6 alive edges at D2 3 in the links mode: its kill
    # lowers only the first three in edge order (to 5, 2, 4), which then
    # hold degree 1 and stay; 1, 3 and 6 keep degree 2 and go. Lane 1: the
    # same edges with every mincov above thr: no kill, only over shows.
    # Lane 2 stays within D2
    hub = [(0, 5), (0, 2), (0, 4), (0, 1), (0, 3), (0, 6)]
    back = [(v, 0) for _, v in hub] + _both_ways(*[(v, 7) for v in
                                                    range(1, 7)])
    cases["deg_over_d2"] = _removal_case([
        dict(live=range(8), merlen={7: 50}, mincov={i: 1 for i in range(8)},
             edges=hub + back),
        dict(live=range(8), merlen={7: 50}, mincov={i: 9 for i in range(8)},
             edges=hub + back),
        dict(live=range(4), mincov={0: 1, 1: 1},
             edges=_both_ways((0, 1), (1, 2), (0, 3)))],
        NI=8, EE=40, U=8, D2=3, mode="links", max_len=10, thr=[2, 2, 2])
    cases["deg_over_d2"]["expect_removed"] = [[0, 1, 3, 6], [], [0]]
    cases["deg_over_d2"]["expect_over"] = [True, True, False]

    # self-loops, duplicate edges, edges to dead items and to an anchor,
    # and dead edges with endpoints outside [0, NI). Lane 0: item 0's
    # self-loop counts in its degree (2: no tip), item 8's lone self-loop
    # makes it a tip that lowers nothing of its own; the tips 5 and 6 lower
    # 1 to a tip, whose edge 1 -> 2, listed twice, lowers 2 (degree 3) by
    # two to a tip. Lane 1: an alive edge from 3 to the dead item 6 and from
    # 4 to the anchor 7; tips whose edges die with them
    cases["loops_and_dead_ends"] = _removal_case([
        dict(live=[0, 1, 2, 3, 4, 5, 6, 8], merlen={3: 50, 4: 50},
             rank={5: 0, 6: 1, 1: 2, 2: 3, 0: 4, 3: 5, 4: 6, 8: 7},
             edges=[(0, 0), (0, 3), (8, 8), (1, 2), (1, 2), (1, 5), (5, 1),
                    (6, 1), (2, 1), (2, 3), (2, 4), (3, 2)],
             dead_edges=[(-5, 99), (40, -1)]),
        dict(live=range(6), special=[7], merlen={5: 50},
             edges=[(3, 6), (6, 3), (4, 7), (7, 4), (5, 4)],
             dead_edges=[(99, 99)])],
        NI=10, EE=16, U=10, D2=4, mode="tips", max_len=10)
    cases["loops_and_dead_ends"]["expect_removed"] = [[1, 2, 5, 6, 8],
                                                      [0, 1, 2, 3, 4]]

    # an empty window; a window of anchors only, with edges among them;
    # a window of one isolated item; each also alone (W 1)
    empty = dict()
    anchors = dict(special=range(4), edges=_both_ways((0, 1), (2, 3)))
    one = dict(live=[2])
    cases["empty_windows"] = _removal_case(
        [empty, anchors, one], NI=4, EE=8, U=4, D2=2, mode="tips",
        max_len=10)
    cases["empty_windows"]["expect_removed"] = [[], [], [2]]
    for name, ln, want in (("w1_empty", empty, []),
                           ("w1_anchors", anchors, []),
                           ("w1_one", one, [2])):
        cases[name] = _removal_case([ln], NI=4, EE=8, U=4, D2=2,
                                    mode="tips", max_len=10)
        cases[name]["expect_removed"] = [want]

    # the links mode's static tests: a bubble 0 -> {1, 2} -> 3 (both
    # branches of degree 2). Lane 0: the guard keeps branch 1, branch 2
    # goes. Lane 1: mincov above thr keeps branch 1, merlen at max_len
    # keeps branch 2. Lane 2 (thr 0): nothing passes mincov
    bub = _both_ways((0, 1), (0, 2), (1, 3), (2, 3))
    long_ends = {0: 50, 3: 50}
    cases["links_guard"] = _removal_case([
        dict(live=range(4), merlen=long_ends, mincov={1: 1, 2: 1},
             guard={1: True}, edges=bub),
        dict(live=range(4), merlen={**long_ends, 2: 10},
             mincov={1: 3, 2: 1}, edges=bub),
        dict(live=range(4), merlen=long_ends, mincov={1: 1, 2: 1},
             edges=bub)],
        NI=4, EE=8, U=4, D2=4, mode="links", max_len=10, thr=[2, 2, 0])
    cases["links_guard"]["expect_removed"] = [[2], [], []]

    # the engine's cleanup shape (NI 528, EE 1,568, U 256, D2 24), seeded
    # random graphs: sparse short items (the engine's case), a dense lane
    # (sources past D2), a lane of 300 live items (n > U), and a lane of
    # 512 live items whose every edge is alive
    rng = np.random.default_rng(528)
    NI, EE = 528, 1568
    lanes = []
    for n_live, n_edges, n_ranks in ((40, 90, 40), (60, 1500, 20),
                                     (300, 700, 300), (512, EE, 500)):
        live = rng.choice(NI - 16, n_live, replace=False)
        src = rng.choice(live, n_edges)
        dst = rng.choice(np.concatenate([live, np.arange(NI - 16, NI)]),
                         n_edges)
        lanes.append(dict(
            live=live.tolist(), special=range(NI - 16, NI),
            rank={int(i): int(rng.integers(0, n_ranks)) for i in live},
            merlen={int(i): int(rng.integers(1, 30)) for i in live},
            edges=list(zip(src.tolist(), dst.tolist()))))
    cases["engine_shape"] = _removal_case(lanes, NI=NI, EE=EE, U=256,
                                          D2=24, mode="tips", max_len=12)
    cases["engine_shape"]["expect_over"] = [False, True, True, True]
    return cases


def removal_cond(c: dict, dev="cpu"):
    """A removal case's condition tuple on `dev`, as cleanup builds it."""
    merlen = _t(c["st"]["merlen"], dev)
    if c["mode"] == "tips":
        return ("tips", merlen, c["max_len"])
    return ("links", merlen, c["max_len"], _t(c["mincov"], dev),
            _t(c["thr"], dev), _t(c["guard"], dev))


def run_removal(c: dict, dev="cpu"):
    """A removal case through the port's stages._seq_removal_pass on
    `dev`: (alive [W, NI], e_alive [W, EE], removed_any [W], over [W])."""
    from . import stages

    st = {k: _t(v, dev) for k, v in c["st"].items()}
    out, removed_any, over = stages._seq_removal_pass(
        st, removal_cond(c, dev), c["U"], c["D2"])
    return out["alive"], out["e_alive"], removed_any, over
