"""Crafted and seeded states for the cleanup (gpu.pipeline.cleanup, its
loops the kernels of gpu.cleanup: `tip_fixpoint` and `short_link_strings`):
windows that reach the corners of the tips fixpoint and the short-link
stage, batched at the engine's compact shape (NI 528, EE 1,568, NM 1,536;
U 256, D2 24) and at W 1. `tests/test_torch_cleanup.py` holds the port's
cleanup on them against the JAX package's; `chip_smoke.py` holds the
kernel path against gpu.pipeline.cleanup_plain on them on the card.

A window is built as gpu.compresscases builds one (items with their mers,
edges with their twins, okeys in creation order, the anchors wired as
wire_anchors wires them), with the keys the cleanup reads beside those of
compress_round: each mer's total count (mer_tot), its per-position
quality sums (mer_totq) and its canonical bases (mer_base). A unitig item
holds merlen mers as the engine's compressed unitigs do: mer p at position
p, the first keeping [0, K), the others [K - 1, K), so that its string is
merlen + K - 1 bases. The cases:

- `bubble`: an anchored SNV bubble of long branches: no tip, no short
  link; the window converges at round 0 while the batch goes on;
- `deep_tree`: a binary tree of 255 short items (depth 7) off an anchored
  spine, ranks growing with depth, so that each round removes one level
  (a parent is swept before its children) and no compress merges a level:
  all 6 rounds hit and the verify pass still removes (fallback);
- `compress_fb`: gpu.compresscases' mutual-buddy cycle and mid-compress
  loopback: every compress of the window raises its fallback;
- `over_u`: 300 isolated long items (more live items than U: every
  removal pass of the window sets over), no candidate;
- `over_d2`: a hub of 30 out-edges (more than D2), no candidate;
- `links`: two anchored bubbles whose short branch has low coverage (pre):
  one plain string (the links pass kills it and the compress merges the
  bubble), one a dinucleotide repeat (the STR guard keeps it);
- `many_cands`: a ladder of 40 bubbles of short items, 121 candidates
  (only the first 64 by item index get strings), every fifth branch of low
  coverage;
- `colliding`: a low-coverage candidate whose mers' positions pass the
  string's cap and fall below 0 (clipped to 63 and 0), flipped and not, so
  that writes of one j and of several j meet in a cell;
- two seeded windows of random unitig paths, branches, self-loops and
  anchors (gpu.compresscases.seeded);
- an empty window (nothing alive).
"""

from __future__ import annotations

import numpy as np
import torch

from . import compresscases as cc

CMAX = cc.CMAX
ENGINE_COMPACT = cc.ENGINE_COMPACT  # NI, EE, NM of the cleanup's calls
U, D2, TIP_ROUNDS = 256, 24, 6  # gpu/pipeline.py cleanup's defaults
K_ENGINE = 21
AVGCOV = 30.0  # thr = floor(sqrt(30)) = 5
# engine/devicepipe.py _cfg_scalars at the defaults (max_link_len K // 2)
CFG = dict(low_cov_threshold=1, min_cov_ratio=0.01, max_tip_len=11,
           max_unit_len=4, min_report_units=3, min_report_len=7,
           dist_from_str=1)
KEYS = cc.KEYS + ("mer_tot", "mer_totq", "mer_base")
FF = cc.FF


def cfg_s(K: int) -> dict:
    return dict(CFG, max_link_len=K // 2)


class Window(cc.Window):
    """A compresscases window with each mer's count, qualities and bases."""

    def __init__(self, NI: int, EE: int, NM: int, K: int, rng):
        super().__init__(NI, EE, NM, K, rng)
        self.extra = []  # per mer: (tot, totq [K], bases [K])

    def item(self, i: int, merlen: int = 1, alive: bool = True):
        n0 = len(self.mers)
        super().item(i, merlen, alive)
        r = self.rng
        for _ in range(len(self.mers) - n0):
            self.extra.append((int(r.integers(20, 40)),
                               r.integers(20, 40, self.K),
                               r.integers(0, 4, self.K)))

    def unitig(self, i: int, merlen: int, cov: int = 30, qv: int = 30,
               bases=None, n_mers: int | None = None):
        """Item i, a unitig of merlen mers (n_mers of them kept, all by
        default) of count `cov` and quality `qv` a position; its string
        `bases` (merlen + K - 1 codes, random by default)."""
        K = self.K
        self.alive[i] = True
        self.merlen[i] = merlen
        self.csum[i] = 4 * cov * merlen + 1
        self.n_t[i] = 0
        self.is_tumor[i] = self.is_normal[i] = True
        self.comp[i] = 1
        seq = (self.rng.integers(0, 4, merlen + K - 1) if bases is None
               else np.asarray(bases))
        for p in range(merlen if n_mers is None else n_mers):
            lo, hi = (0, K) if p == 0 else (K - 1, K)
            self.mers.append((i, False, p, lo, hi))
            self.extra.append((cov, np.full(K, qv), seq[p:p + K]))

    def arrays(self) -> dict:
        out = super().arrays()
        NM, K = self.NM, self.K
        tot = np.zeros(NM, np.int64)
        totq = np.zeros((NM, K), np.int64)
        base = np.zeros((NM, K), np.int64)
        for j, (t, q, b) in enumerate(self.extra):
            tot[j], totq[j], base[j] = t, q, b
        out.update(mer_tot=tot, mer_totq=totq, mer_base=base)
        return out


def _chain_edges(w: Window, pairs):
    for u, v in pairs:
        w.edge(u, v, FF)


def bubble(w: Window, base: int = 0):
    s1, a, b, s2 = range(base, base + 4)
    for i, ml in ((s1, 30), (a, 21), (b, 21), (s2, 30)):
        w.unitig(i, ml)
    _chain_edges(w, ((s1, a), (a, s2), (s1, b), (b, s2)))
    w.anchor(0, s1, s2)


def deep_tree(w: Window, base: int = 0, depth: int = 7):
    """A spine item and a binary tree of depth `depth` (2^(depth+1) - 1
    items of merlen 2) whose ranks grow with depth."""
    spine = base
    w.unitig(spine, 15)
    n = 2 ** (depth + 1) - 1
    nodes = list(range(base + 1, base + 1 + n))
    for x in nodes:
        w.unitig(x, 2)
    w.edge(spine, nodes[0], FF)
    for k in range(1, n):
        w.edge(nodes[(k - 1) // 2], nodes[k], FF)
    w.anchor(0, spine, spine)
    w.rank[spine] = 0
    for k, x in enumerate(nodes):
        w.rank[x] = k + 1


def compress_fb(w: Window, base: int = 0):
    cc.buddy_cycle(w, base + 10)
    cc.loopback(w, base + 16)
    bubble(w, base + 30)


def over_u(w: Window, base: int = 0):
    for i in range(base, base + 300):
        w.unitig(i, 12, n_mers=1)


def over_d2(w: Window, base: int = 0):
    hub = base
    w.unitig(hub, 12)
    for j in range(30):
        w.unitig(base + 1 + j, 12, n_mers=1)
        w.edge(hub, base + 1 + j, FF)


def links(w: Window, base: int = 0):
    K = w.K
    s1, low, mid, s2 = range(base, base + 4)
    for i, ml in ((s1, 30), (mid, 21), (s2, 30)):
        w.unitig(i, ml)
    w.unitig(low, 5, cov=2)
    _chain_edges(w, ((s1, low), (low, s2), (s1, mid), (mid, s2)))
    w.anchor(0, s1, s2)
    t1, rep, mid2, t2 = range(base + 4, base + 8)
    for i, ml in ((t1, 30), (mid2, 21), (t2, 30)):
        w.unitig(i, ml)
    w.unitig(rep, 5, cov=2, bases=[0, 1] * ((5 + K) // 2))
    _chain_edges(w, ((t1, rep), (rep, t2), (t1, mid2), (mid2, t2)))
    w.anchor(1, t1, t2)


def many_cands(w: Window, base: int = 0, n: int = 40):
    spine = list(range(base, base + n + 1))
    for x in spine:
        w.unitig(x, 3)
    nxt = base + n + 1
    for k in range(n):
        for j in range(2):
            w.unitig(nxt, 3, cov=2 if (j == 0 and k % 5 == 0) else 30)
            _chain_edges(w, ((spine[k], nxt), (nxt, spine[k + 1])))
            nxt += 1
    w.anchor(0, spine[0], spine[-1])


def colliding(w: Window, base: int = 0):
    K = w.K
    r1, q, p, r2 = range(base, base + 4)
    for i, ml in ((r1, 30), (p, 21), (r2, 30)):
        w.unitig(i, ml)
    w.unitig(q, 4, cov=2, n_mers=0)
    r = w.rng
    for flip, pos, lo, hi in ((False, 60, 0, K), (True, 61, 0, K),
                              (False, -3, 0, K), (False, 60, 2, 9),
                              (True, 45, 5, K), (False, 0, 0, K),
                              (True, -7, 3, K + 4)):
        w.mers.append((q, flip, pos, lo, hi))
        w.extra.append((2, np.full(K, 30), r.integers(0, 4, K)))
    _chain_edges(w, ((r1, q), (q, r2), (r1, p), (p, r2)))
    w.anchor(0, r1, r2)


def seeded(w: Window, seed_paths: int = 12):
    cc.seeded(w, n_paths=seed_paths, path_len=(2, 8), merlen=(1, 24),
              extra=10, loops=1)


CASES = {"bubble": bubble, "deep_tree": deep_tree,
         "compress_fb": compress_fb, "over_u": over_u, "over_d2": over_d2,
         "links": links, "many_cands": many_cands, "colliding": colliding}


def _window(name: str, fn, shape, K: int, seed: int) -> dict:
    NI, EE, NM = shape
    w = Window(NI, EE, NM, K, np.random.default_rng(seed))
    w.ranks()
    if fn is not None:
        fn(w)
    return w.arrays()


def _stack(wins) -> dict:
    return {k: np.stack([w[k] for w in wins]) for k in KEYS}


def engine_batch(K: int = K_ENGINE) -> tuple[dict, list, int]:
    """At the engine's compact shape: every case, two seeded windows and an
    empty one. Returns (arrays [W, ...], window names, K)."""
    wins, names = [], []
    for s, (name, fn) in enumerate(CASES.items()):
        wins.append(_window(name, fn, ENGINE_COMPACT, K, 700 + s))
        names.append(name)
    for s in range(2):
        wins.append(_window("seeded", seeded, ENGINE_COMPACT, K, 800 + s))
        names.append(f"seeded{s}")
    wins.append(_window("empty", None, ENGINE_COMPACT, K, 900))
    names.append("empty")
    return _stack(wins), names, K


def w1_batch(K: int = K_ENGINE) -> tuple[dict, list, int]:
    """W 1: the deep tree and a low-coverage short link in one window."""
    NI, EE, NM = ENGINE_COMPACT
    w = Window(NI, EE, NM, K, np.random.default_rng(950))
    w.ranks()
    deep_tree(w, 0)
    links(w, 300)
    return _stack([w.arrays()]), ["tree_and_links"], K


def batches() -> list[tuple[str, dict, int]]:
    """Every batch: (name, arrays, K)."""
    return [("engine", *engine_batch()[::2]), ("w1", *w1_batch()[::2])]


def to_torch(arrs: dict, dev="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrs.items()}


def inputs(arrs: dict, K: int, dev="cpu") -> tuple:
    """The cleanup's arguments for a batch: (st, K, N, NI, cfg_s, avgcov)
    with N the regular items' count NI - 2 CMAX."""
    NI = arrs["alive"].shape[1]
    W = arrs["alive"].shape[0]
    avg = torch.full((W,), AVGCOV, dtype=torch.float32, device=dev)
    return to_torch(arrs, dev), K, NI - 2 * CMAX, NI, cfg_s(K), avg


def run(arrs: dict, K: int, dev="cpu", plain: bool = False):
    """gpu.pipeline.cleanup (or cleanup_plain) on the batch on `dev`:
    (state, fallback) on the host."""
    from . import pipeline

    fn = pipeline.cleanup_plain if plain else pipeline.cleanup
    st, fb = fn(*inputs(arrs, K, dev), U=U, D2=D2, TIP_ROUNDS=TIP_ROUNDS)
    return {k: v.cpu() for k, v in st.items()}, fb.cpu()
