"""Crafted and seeded states for `compress_round` (gpu.compress, the plain
version gpu.stages.compress_round_plain): windows that reach the corners of
the pass, which the engine's states reach rarely or never, batched by
shape. `tests/test_torch_compress.py` holds the plain version on each
against the JAX package and a numpy replay of the kernel against the plain
version; `chip_smoke.py` holds the kernel against the plain version on
each on the card.

A window is built as the engine builds its state: items with merlen mers
each (mer_pos 0..merlen - 1, a random flip and kept interval), edges with
their twins (u -> v with direction (o_u, o_v) and v -> u with its
fliplink), okeys in creation order, the anchors' edges as
gpu.stages.wire_anchors wires them (okeys 0, BIG - 2 and BIG - 1), ranks a
permutation of the regular items and 2^28 on the anchors. The cases:

- `flip_chain`: a chain of eight items whose orientation changes twice,
  its survivor R-oriented in the middle, so members on both sides flip;
- `buddy_cycle`: four items in a mutual-buddy cycle (a chain with no end:
  the window falls back, and its words depend on every round run);
- `loopback`: a chain whose two ends also share a second edge (not a
  link), which the merge turns into a self-loop: a mid-compress loopback;
- `blocked`: links stopped by a tandem self-loop, by a special item (an
  anchor wired to a chain's middle) and by a branch of out-degree two;
- `sentinels`: okeys at and past the clamp (16,381 and up), the anchors'
  BIG - 2 and BIG - 1, and one source with 70 out-edges (slots past Dcap
  64) whose edges move when its chain merges;
- `dead_mers`: dead items with nonzero merlen and mers that point at
  them, mers pointing past the item axis (clamped), member mers whose
  new_pos falls below 0 and a survivor of rank -3;
- `mixed`: every one of the above in one window;
- at the engine's first shape (NI 1,552, EE 3,872, NM 1,536), beside the
  cases above: a chain of 1,530 items (11 rounds of jumping, dist up to
  1,529), a mutual-buddy cycle of 1,500 items (dist saturates at DCAP
  1,560) and seeded windows of single-mer items (the un-compacted state);
- at its compact shape (NI 528, EE 1,568, NM 1,536) the cases above and
  seeded windows of long unitigs (merlen up to 23: member mers that take
  junction trims);
- W 1 and an empty window at a small shape;
- `straddle` at the small shape: the kernel's worker ranges
  (gpu.compress.range_chunk: 80 and 112 mers, 112 and 160 edges at a
  cluster of 4 and of 3 blocks) cut through one member item's mers,
  through the 70-edge hub's out-edges and between a negative-new_pos
  member item's mers; beside it `far_members`, members whose ranks are
  0..c - 1 but whose new_pos start past 8,191 (the mers go by the sort
  though counting would place them).
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 30
FF, FR, RF, RR = 0, 1, 2, 3
K_SMALL = 21
CMAX = 8  # the engine's anchors a window (engine/devicepipe.py _CMAX)
ENGINE_FIRST = (1552, 3872, 1536)  # NI, EE, NM of compress #1
ENGINE_COMPACT = (528, 1568, 1536)  # the cleanup's calls
SMALL = (96, 320, 224)

KEYS = ("alive", "special", "rank", "comp", "merlen", "csum", "n_t",
        "is_tumor", "is_normal", "e_src", "e_dst", "e_dir", "e_alive",
        "e_okey", "mer_item", "mer_flip", "mer_pos", "keep_lo", "keep_hi")


def fliplink(d: int) -> int:
    return ((d & 1) ^ 1) * 2 + ((d >> 1) ^ 1)


class Window:
    """One window's state under construction (numpy, the engine's dtypes:
    int64 and bool)."""

    def __init__(self, NI: int, EE: int, NM: int, K: int, rng):
        self.NI, self.EE, self.NM, self.K = NI, EE, NM, K
        self.N = NI - 2 * CMAX
        self.rng = rng
        self.alive = np.zeros(NI, bool)
        self.special = np.zeros(NI, bool)
        self.rank = np.full(NI, 1 << 28, np.int64)
        self.comp = np.zeros(NI, np.int64)
        self.merlen = np.zeros(NI, np.int64)
        self.csum = np.zeros((NI, 4), np.int64)
        self.n_t = np.zeros(NI, np.int64)
        self.is_tumor = np.zeros(NI, bool)
        self.is_normal = np.zeros(NI, bool)
        self.edges = []  # (src, dst, dir, okey)
        self.anchor_edges = {}  # row -> (src, dst, dir, okey)
        self.mers = []  # (item, flip, pos, lo, hi)

    def item(self, i: int, merlen: int = 1, alive: bool = True):
        r = self.rng
        self.alive[i] = alive
        self.merlen[i] = merlen
        self.csum[i] = r.integers(0, 40, 4)
        self.n_t[i] = r.integers(0, merlen + 1)
        self.is_tumor[i] = r.random() < 0.5
        self.is_normal[i] = r.random() < 0.5
        self.comp[i] = 1
        for p in range(merlen):
            lo = int(r.integers(0, self.K + 1))
            hi = int(r.integers(lo, self.K + 1))
            self.mers.append((i, bool(r.random() < 0.5), p, lo, hi))

    def edge(self, u: int, v: int, d: int, twin: bool = True,
             okey: int | None = None):
        self.edges.append((u, v, d, len(self.edges) if okey is None
                           else okey))
        if twin and not (u == v and d in (FR, RF)):
            self.edges.append((v, u, fliplink(d), len(self.edges)
                               if okey is None else okey))

    def path(self, items, ori):
        """Edges along `items` with orientations `ori` (0 F, 1 R)."""
        for a, b, oa, ob in zip(items, items[1:], ori, ori[1:]):
            self.edge(a, b, oa * 2 + ob)

    def anchor(self, c: int, src_item: int, snk_item: int,
               so: bool = True, ko: bool = True):
        """Component c's fake source and sink wired to two items, as
        wire_anchors wires them (rows E + 4c .. E + 4c + 3)."""
        fs, fk = self.N + 2 * c, self.N + 2 * c + 1
        for x in (fs, fk):
            self.alive[x] = self.special[x] = True
            self.comp[x] = c + 1
        E = self.EE - 4 * CMAX
        sdir = 0 if so else 1
        kdir = 3 if ko else 0
        self.anchor_edges[E + 4 * c] = (fs, src_item, sdir, 0)
        self.anchor_edges[E + 4 * c + 1] = (src_item, fs, fliplink(sdir),
                                            BIG - 2)
        self.anchor_edges[E + 4 * c + 2] = (fk, snk_item, kdir, 0)
        self.anchor_edges[E + 4 * c + 3] = (snk_item, fk, fliplink(kdir),
                                            BIG - 1)

    def ranks(self):
        """Map-order ranks: a permutation over the regular items."""
        self.rank[:self.N] = self.rng.permutation(self.N)
        self.rank[self.N:] = 1 << 28

    def arrays(self) -> dict:
        NI, EE, NM = self.NI, self.EE, self.NM
        E = EE - 4 * CMAX
        if len(self.edges) > E or len(self.mers) > NM:
            raise ValueError(f"{len(self.edges)} edges / {len(self.mers)} "
                             f"mers do not fit E={E} / NM={NM}")
        e = np.zeros((EE, 4), np.int64)
        e[:, 3] = BIG
        ea = np.zeros(EE, bool)
        for j, row in enumerate(self.edges):
            e[j] = row
            ea[j] = True
        for j, row in self.anchor_edges.items():
            e[j] = row
            ea[j] = True
        m = np.zeros((NM, 5), np.int64)
        dead = [i for i in range(NI) if not self.alive[i]] or [NI - 1]
        for j in range(NM):  # spare mers point at dead items, empty
            m[j] = (dead[j % len(dead)], 0, j, 0, 0)
        for j, row in enumerate(self.mers):
            m[j] = row
        return {"alive": self.alive.copy(), "special": self.special.copy(),
                "rank": self.rank.copy(), "comp": self.comp.copy(),
                "merlen": self.merlen.copy(), "csum": self.csum.copy(),
                "n_t": self.n_t.copy(), "is_tumor": self.is_tumor.copy(),
                "is_normal": self.is_normal.copy(),
                "e_src": e[:, 0].copy(), "e_dst": e[:, 1].copy(),
                "e_dir": e[:, 2].copy(), "e_alive": ea,
                "e_okey": e[:, 3].copy(), "mer_item": m[:, 0].copy(),
                "mer_flip": m[:, 1].astype(bool), "mer_pos": m[:, 2].copy(),
                "keep_lo": m[:, 3].copy(), "keep_hi": m[:, 4].copy()}


def _stack(wins) -> dict:
    return {k: np.stack([w[k] for w in wins]) for k in KEYS}


def _ori(n, flips=()):
    o, cur = [], 0
    for j in range(n):
        if j in flips:
            cur ^= 1
        o.append(cur)
    return o


def flip_chain(w: Window, base: int = 0):
    """Eight items whose orientation changes twice; rank_flip_chain gives
    the survivor (item base + 4, R-oriented) the lowest rank."""
    items = list(range(base, base + 8))
    for i in items:
        w.item(i, merlen=int(w.rng.integers(1, 4)))
    w.path(items, _ori(8, flips=(3, 6)))
    return items


def rank_flip_chain(w: Window, base: int = 0):
    w.rank[base:base + 8] = [5, 6, 7, 4, 0, 3, 2, 1]


def buddy_cycle(w: Window, base: int = 10):
    items = list(range(base, base + 4))
    for i in items:
        w.item(i, merlen=2)
    w.path(items + items[:1], [0, 0, 0, 0, 0])
    return items


def loopback(w: Window, base: int = 16):
    """a.R and c.R link each other (c -> a RF and its twin a -> c RF); the
    edge a -> c FR leaves a's F side (one edge) for c's R side, whose back
    edge c.F has two (c -> b FR and a's twin c -> a FR): not a link, so it
    stays, and the merge of a and c makes it a self-loop."""
    a, b, c = base, base + 1, base + 2
    for i in (a, b, c):
        w.item(i, merlen=2)
    w.edge(c, a, RF)
    w.edge(c, b, FR)
    w.edge(a, c, FR)
    return [a, b, c]


def blocked(w: Window, base: int = 24):
    # a - b(tandem) - c: the self-loop on b blocks both links
    a, b, c = base, base + 1, base + 2
    for i in (a, b, c):
        w.item(i, merlen=1)
    w.path([a, b, c], [0, 0, 0])
    w.edge(b, b, FF)
    # d - e - f with e wired to an anchor: e's side toward the anchor has
    # two out-edges, and the anchor (special) ends its other link
    d, e, f = base + 3, base + 4, base + 5
    for i in (d, e, f):
        w.item(i, merlen=2)
    w.path([d, e, f], [0, 0, 0])
    w.anchor(0, e, f)
    # g -> {h, i}: a branch of out-degree two
    g, h, i2 = base + 6, base + 7, base + 8
    for i in (g, h, i2):
        w.item(i, merlen=1)
    w.edge(g, h, FF)
    w.edge(g, i2, FF)
    return [a, b, c, d, e, f, g, h, i2]


def sentinels(w: Window, base: int = 36, fan: int = 70):
    """Okeys past the clamp; a hub with `fan` out-edges (slots past Dcap)
    whose single in-link merges it into its predecessor, so every one of
    its edges moves."""
    p, hub = base, base + 1
    w.item(p, merlen=1)
    w.item(hub, merlen=3)
    w.edge(p, hub, FF, okey=16381)
    for j in range(fan):
        leaf = base + 2 + (j % 6)
        if not w.alive[leaf]:
            w.item(leaf, merlen=1)
        w.edge(hub, leaf, FF if j % 2 else FR, twin=False,
               okey=int(w.rng.integers(0, 20000)))
    w.anchor(1, p, base + 2)
    if w.rank[p] > w.rank[hub]:  # p survives: the hub's edges move
        w.rank[[p, hub]] = w.rank[[hub, p]]
    return [p, hub]


def dead_mers(w: Window, base: int = 46):
    for i in range(base, base + 6):
        w.item(i, merlen=int(w.rng.integers(1, 5)), alive=i % 2 == 0)
    w.path([base, base + 2, base + 4], [0, 1, 1])
    # mers pointing past the items (clamped to NI - 1 and 0)
    w.mers.append((w.NI + 3, False, 1, 2, 9))
    w.mers.append((-5, True, 0, 0, 4))
    # a mer_pos past its item's merlen on the two absorbed, flipped items:
    # new_pos below 0 (the member mers' order then leaves their items'
    # runs); the survivor's rank below 0 (a negative survivor word, its
    # item by floor modulo)
    w.mers.append((base + 2, False, 40, 1, 7))
    w.mers.append((base + 4, True, 41, 0, 9))
    w.rank[base] = -3
    return list(range(base, base + 6))


def seeded(w: Window, n_paths: int, path_len: tuple, merlen: tuple,
           extra: int, loops: int, first_item: int = 0):
    """Random unitig paths with orientation changes, branches between
    them, self-loops and anchors; returns the items used."""
    r = w.rng
    i = first_item
    paths = []
    for _ in range(n_paths):
        n = int(r.integers(*path_len))
        if i + n > w.N:
            break
        items = list(range(i, i + n))
        i += n
        for x in items:
            w.item(x, merlen=int(r.integers(*merlen)))
        flips = tuple(int(f) for f in r.integers(1, max(n, 2), 2))
        w.path(items, _ori(n, flips))
        paths.append(items)
    used = [x for p in paths for x in p]
    for _ in range(extra):
        u, v = (int(x) for x in r.choice(used, 2))
        w.edge(u, v, int(r.integers(0, 4)))
    for _ in range(loops):
        u = int(r.choice(used))
        w.edge(u, u, FF)
    for c, p in enumerate(paths[:CMAX]):
        w.anchor(c, p[0], p[-1], so=bool(r.random() < 0.5),
                 ko=bool(r.random() < 0.5))
    return used


def straddle(w: Window):
    """dead_mers' items with their two past-merlen mers moved behind a
    chain of four items of 30 mers each (mers ~15-135: its members' mers
    cross mer 80 and 112), then 90 filler edges between two items and
    sentinels' hub, whose 70 out-edges (~100-170) cross edge 112 and
    160."""
    dead_mers(w, base=0)
    late = w.mers[-2:]
    del w.mers[-2:]
    chain = list(range(10, 14))
    for i in chain:
        w.item(i, merlen=30)
    w.path(chain, _ori(4, flips=(2,)))
    w.mers.extend(late)
    a, b = 30, 31
    w.item(a, merlen=1)
    w.item(b, merlen=1)
    for _ in range(45):
        w.edge(a, b, FF)
    sentinels(w, base=20)
    return chain


def far_members(w: Window, base: int = 0):
    """A chain of three items, its ends of merlen 9,000 and the first the
    survivor (rank 0): the middle member's start_off is 9,000 from either
    end, its mers' ranks 0 and 1."""
    items = [base, base + 1, base + 2]
    for i in items:
        w.item(i, merlen=2)
    w.merlen[[base, base + 2]] = 9000
    w.path(items, [0, 0, 0])
    w.rank[items] = [0, 1, 2]
    return items


CASES = {"flip_chain": flip_chain, "buddy_cycle": buddy_cycle,
         "loopback": loopback, "blocked": blocked, "sentinels": sentinels,
         "dead_mers": dead_mers}


def _crafted(NI: int, EE: int, NM: int, K: int, seed: int):
    """Each case of CASES alone, then all of them in one window."""
    wins, names = [], []
    for s, (name, fn) in enumerate(CASES.items()):
        w = Window(NI, EE, NM, K, np.random.default_rng(seed + s))
        w.ranks()
        fn(w)
        if name == "flip_chain":
            rank_flip_chain(w)
        wins.append(w.arrays())
        names.append(name)
    w = Window(NI, EE, NM, K, np.random.default_rng(seed + len(CASES)))
    w.ranks()
    for fn in CASES.values():
        fn(w)
    rank_flip_chain(w)
    wins.append(w.arrays())
    names.append("mixed")
    return wins, names


def crafted_batch() -> tuple[dict, list, int]:
    """At the engine's first shape: the crafted windows, the long chain,
    the long cycle and seeded windows of single-mer items (the un-compacted
    state). Returns (arrays [W, ...], window names, K)."""
    NI, EE, NM = ENGINE_FIRST
    K = 13
    wins, names = _crafted(NI, EE, NM, K, 100)
    w = Window(NI, EE, NM, K, np.random.default_rng(11))
    items = list(range(1530))
    for i in items:
        w.item(i, merlen=1)
    w.path(items, _ori(len(items), flips=(400, 401, 1200)))
    w.ranks()
    w.anchor(0, items[0], items[-1])
    wins.append(w.arrays())
    names.append("chain_1530")
    w = Window(NI, EE, NM, K, np.random.default_rng(12))
    items = list(range(1500))
    for i in items:
        w.item(i, merlen=1)
    w.path(items + items[:1], _ori(len(items) + 1, flips=(9, 700)))
    w.ranks()
    wins.append(w.arrays())
    names.append("cycle_1500")
    for s in range(3):
        w = Window(NI, EE, NM, K, np.random.default_rng(300 + s))
        w.ranks()
        seeded(w, n_paths=6, path_len=(20, 300), merlen=(1, 2),
               extra=40, loops=2)
        wins.append(w.arrays())
        names.append(f"seeded{s}")
    return _stack(wins), names, K


def compact_batch() -> tuple[dict, list, int]:
    """At the engine's compact shape: the crafted windows and seeded
    windows of long unitigs."""
    NI, EE, NM = ENGINE_COMPACT
    K = 25
    wins, names = _crafted(NI, EE, NM, K, 500)
    for s in range(5):
        w = Window(NI, EE, NM, K, np.random.default_rng(400 + s))
        w.ranks()
        seeded(w, n_paths=12, path_len=(2, 8), merlen=(1, 24), extra=10,
               loops=1)
        wins.append(w.arrays())
        names.append(f"seeded{s}")
    return _stack(wins), names, K


def edge_batches() -> list[tuple[str, dict, int]]:
    """W 1 (one seeded window), an empty window (nothing alive) and the
    straddle and far_members windows."""
    NI, EE, NM = SMALL
    w = Window(NI, EE, NM, K_SMALL, np.random.default_rng(9))
    w.ranks()
    seeded(w, n_paths=5, path_len=(2, 9), merlen=(1, 4), extra=4, loops=1)
    one = _stack([w.arrays()])
    e = Window(NI, EE, NM, K_SMALL, np.random.default_rng(10))
    empty = _stack([e.arrays()])
    s = Window(NI, EE, NM, K_SMALL, np.random.default_rng(13))
    s.ranks()
    straddle(s)
    f = Window(NI, EE, NM, K_SMALL, np.random.default_rng(14))
    f.ranks()
    far_members(f)
    return [("w1", one, K_SMALL), ("empty", empty, K_SMALL),
            ("straddle", _stack([s.arrays(), f.arrays()]), K_SMALL)]


def batches() -> list[tuple[str, dict, int]]:
    """Every batch: (name, arrays, K)."""
    out = []
    for name, fn in (("crafted", crafted_batch), ("compact", compact_batch)):
        arrs, _, K = fn()
        out.append((name, arrs, K))
    return out + edge_batches()


def shape_of(arrs: dict) -> tuple[int, int, int]:
    return (arrs["alive"].shape[1], arrs["e_src"].shape[1],
            arrs["mer_item"].shape[1])


def to_torch(arrs: dict, dev="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrs.items()}


def run(arrs: dict, K: int, dev="cpu"):
    """stages.compress_round on the batch's state on `dev`: (out, fallback)
    with every key on the host."""
    from . import stages

    NI = arrs["alive"].shape[1]
    N = NI - 2 * CMAX
    out, fb = stages.compress_round(to_torch(arrs, dev), K, NI, N)
    return {k: v.cpu() for k, v in out.items()}, fb.cpu()
