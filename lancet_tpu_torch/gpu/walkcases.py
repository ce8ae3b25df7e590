"""Crafted graphs for the two walks that stage a window's graph in shared
memory (csrc/walks.cu K1 `path_cover`, K4 `cycle_dfs`): the corners where
their order of work decides the result, their overflow flags, and shapes
that take each staging mode. `tests/test_torch_walks_crafted.py` holds the
plain versions on these cases against the JAX package, and `chip_smoke.py`
the kernels against the plain versions on the card.

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
