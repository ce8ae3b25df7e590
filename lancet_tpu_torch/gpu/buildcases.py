"""Crafted windows for the device graph engine's build (gpu.dbg.build_k;
its kernels those of gpu.dbgk): windows that reach the corners of the
instance table, the groups, the pair dedup, the adjacency, the reference
projection and the fallback flags, packed as pack.WindowBatch packs a
chunk, at any of the engine's shape buckets (R, L, N, E) with its Lraw.
`tests/test_torch_build.py` holds the port's build on them against the JAX
package's at bucket 0; `chip_smoke.py` holds the kernels against
gpu.dbg.build_k_plain on them at every bucket's shape.

The windows, one lane each (`LANES`, in order):

- `plain`: reads tiled from the window's reference with a few errors,
  tumor and normal, both strands, mates of distinct fragments;
- `over_n`: reads of random sequence: more distinct mers than N;
- `over_e`: reads and reference over A and C with no run of more A's
  than the case allows, chosen so that the mers stay few (within N at a
  small k) and their adjacent pairs many (past E);
- `mate`: the two mates of a fragment overlapping (a mate-overlap
  candidate), beside two reads of one order sharing mers, and mates of
  another fragment apart;
- `off`: the plain window with window_ok False;
- `codes`: reads and reference with codes past ACGT (4, 5, 255);
- `short`: reads of length 0, 1, K - 1, K (a single mer: skipped), K + 1
  and L;
- `quals`: tumor reads with qualities exactly at min_qual_call and one
  below it (the pair gate and the per-base bits);
- `palindrome`: reads through a (K+1)-mer that is its own reverse
  complement (a palindromic self-loop);
- `seq_clip`: the index at its clip edges: seq_off below 0 and seq_len
  past the reference;
- `seq_tail`: seq_off near the end of the reference (index positions
  past Mraw) and seq_len below K;
- `raw_short`: rawlen K - 1: no ref-read, projection or index mer;
- `raw_k`: rawlen K: one projection mer, no ref-read mer (rawlen - K is
  0);
- `empty`: nothing packed, window_ok True;
- `hub`: a mer whose successors and predecessors differ in every base
  (an SNV on each side, every allele), more out-edges than HUB_D.

`batch(K, R, L, N, E)` packs every lane; `hub_batch(K, R, L)` the hub
alone beside the plain window, for a build at D = HUB_D (a mer has at most
eight distinct neighbours, so no window passes the engine's D of 12).
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from .pack import S_NML, S_TMR, WindowBatch

LRAW = 1152  # engine/devicepipe.py's Lraw
D_ENGINE = 12  # engine/devicepipe.py's _D
HUB_D = 4
KS = (11, 31, 33, 61, 63)
# engine/devicepipe.py's _BUCKETS (R, L, N, E)
BUCKETS = ((48, 160, 1536, 3840), (192, 160, 1536, 3840),
           (512, 112, 4096, 10240), (768, 160, 4096, 10240))
_CFG = Config()
SCALARS = dict(min_qual_call=_CFG.min_qual_call,
               low_cov_threshold=_CFG.low_cov_threshold,
               min_cov_ratio=_CFG.min_cov_ratio)
HIGH_Q = SCALARS["min_qual_call"] + 10
LANES = ("plain", "over_n", "over_e", "mate", "off", "codes", "short",
         "quals", "palindrome", "seq_clip", "seq_tail", "raw_short",
         "raw_k", "empty", "hub")
FIELDS = ("bases", "quals", "rlen", "rsample", "rstrand", "rfrag", "rorder",
          "raw", "rawlen", "seq_off", "seq_len", "totalreadbp", "window_ok")


def _rc(s: np.ndarray) -> np.ndarray:
    return (3 - s[::-1]).astype(np.uint8)


class _Lane:
    """One lane of a WindowBatch, filled read by read."""

    def __init__(self, b: WindowBatch, w: int, rng):
        self.b, self.w, self.rng = b, w, rng
        self.r = 0

    def ref(self, seq, seq_off: int = 0, seq_len: int | None = None):
        b, w = self.b, self.w
        b.raw[w, :len(seq)] = seq
        b.rawlen[w] = len(seq)
        b.seq_off[w] = seq_off
        b.seq_len[w] = len(seq) if seq_len is None else seq_len
        b.window_ok[w] = True

    def read(self, seq, quals=None, sample=S_TMR, strand=0, frag=-1,
             order=0):
        b, w, r = self.b, self.w, self.r
        if r >= b.R:
            return
        seq = np.asarray(seq, np.uint8)[:b.L]
        n = len(seq)
        b.bases[w, r, :n] = seq
        b.quals[w, r, :n] = HIGH_Q if quals is None else quals[:n]
        b.rlen[w, r] = n
        b.rsample[w, r] = sample
        b.rstrand[w, r] = strand
        b.rfrag[w, r] = frag
        b.rorder[w, r] = order
        b.totalreadbp[w] += n
        self.r += 1

    def tiled(self, ref, n_reads: int, err: float = 0.0, frag0: int = 0):
        """n_reads reads of length L at random offsets of ref, alternating
        tumor/normal and strand, each its own fragment's first mate."""
        L = self.b.L
        for i in range(n_reads):
            o = int(self.rng.integers(0, max(1, len(ref) - L)))
            s = ref[o:o + L].copy()
            hit = self.rng.random(len(s)) < err
            s[hit] = self.rng.integers(0, 4, int(hit.sum()))
            self.read(s, sample=S_TMR if i % 2 == 0 else S_NML,
                      strand=i % 3 == 0, frag=frag0 + i, order=1)

    def fill(self, seqs):
        for i, s in enumerate(seqs):
            self.read(s, sample=S_TMR if i % 2 == 0 else S_NML,
                      strand=i % 2)


def _limited(rng, n: int, run: int) -> np.ndarray:
    """n bases over A (0) and C (1) with no run of more than `run` A's."""
    out = np.empty(n, np.uint8)
    k = 0
    for i in range(n):
        a = k < run and rng.random() < 0.5
        out[i] = 0 if a else 1
        k = k + 1 if a else 0
    return out


def _count_limited(n: int, run: int) -> int:
    """Strings of length n over two letters with no run of more than
    `run` of the first."""
    f = [1]
    for i in range(1, n + 1):
        f.append(sum(f[max(0, i - run - 1):i]) if i > run else 2 ** i)
    return f[n]


def _dense_run(K: int, N: int, E: int) -> int:
    """The run limit whose K-mers stay within N while enough of its
    (K+1)-mers, as a window's reads cover them, pass E pairs; no limit
    (every A/C string, past N too) when none does."""
    for run in range(K, 0, -1):
        if (_count_limited(K, run) <= N
                and _count_limited(K + 1, run) > 0.6 * E):
            return run
    return K


def _palindrome(rng, K: int) -> np.ndarray:
    h = rng.integers(0, 4, (K + 1) // 2).astype(np.uint8)
    return np.concatenate([h, _rc(h)])  # its own reverse complement


def _case(name: str, lane: _Lane, K: int, N: int, E: int):
    rng, b = lane.rng, lane.b
    R, L = b.R, b.L
    ref = rng.integers(0, 4, min(LRAW, 1000)).astype(np.uint8)
    if name in ("plain", "off"):
        lane.ref(ref)
        lane.tiled(ref, R - 2, err=4 / (R * L))
        if name == "off":
            b.window_ok[lane.w] = False
    elif name == "over_n":
        lane.ref(ref)
        lane.fill(rng.integers(0, 4, (R, L)).astype(np.uint8))
    elif name == "over_e":
        run = _dense_run(K, N, E)
        lane.ref(_limited(rng, LRAW - 8, run))
        lane.fill([_limited(rng, L, run) for _ in range(R)])
    elif name == "mate":
        lane.ref(ref)
        s = ref[100:100 + L]
        lane.read(s, frag=7, order=1)
        lane.read(ref[100 + L // 2:100 + L // 2 + L], frag=7, order=2,
                  strand=1)
        lane.read(ref[400:400 + L], frag=8, order=1)
        lane.read(ref[400 + L // 3:400 + L // 3 + L], frag=8, order=1)
        lane.read(ref[600:600 + L], frag=9, order=1)
        lane.read(ref[800 - L:800], frag=9, order=2)
        lane.tiled(ref, R // 2, frag0=100)
    elif name == "codes":
        bad = ref.copy()
        bad[[50, 51, 300]] = (4, 5, 255)
        lane.ref(bad)
        lane.tiled(bad, R // 2, err=0.0)
        for r in range(0, lane.r, 3):
            b.bases[lane.w, r, (r * 7) % max(1, b.rlen[lane.w, r])] = 4 + r % 2
    elif name == "short":
        lane.ref(ref)
        for n in (0, 1, K - 1, K, K + 1, L, K + 1, K):
            lane.read(ref[200:200 + n])
        lane.tiled(ref, R // 2)
    elif name == "quals":
        lane.ref(ref)
        mq = SCALARS["min_qual_call"]
        for i in range(R // 2):
            o = 10 + 3 * i
            q = np.full(L, mq, np.uint8)
            q[(i * 5) % L] = mq - 1
            q[(i * 11 + 3) % L] = mq - 1 if i % 2 else mq + 1
            lane.read(ref[o:o + L], q, sample=S_TMR if i % 3 else S_NML,
                      strand=i % 2)
    elif name == "palindrome":
        pal = _palindrome(rng, K)
        seq = np.concatenate([ref[:300], pal, ref[300:600]])
        lane.ref(seq)
        for i in range(R // 2):
            o = max(0, 300 - (i * 7) % (L - K - 1))
            lane.read(seq[o:o + L], strand=i % 2,
                      sample=S_TMR if i % 2 else S_NML)
        lane.read(np.concatenate([pal, pal, pal, pal])[:L])
    elif name == "seq_clip":
        lane.ref(ref, seq_off=-3, seq_len=LRAW + 40)
        lane.tiled(ref, R // 2)
    elif name == "seq_tail":
        lane.ref(ref, seq_off=LRAW - K - 2, seq_len=K - 1)
        lane.tiled(ref, R // 2)
    elif name == "raw_short":
        lane.ref(ref[:K - 1])
        lane.tiled(ref, R // 2)
    elif name == "raw_k":
        lane.ref(ref[:K])
        lane.tiled(ref, R // 2)
    elif name == "empty":
        b.window_ok[lane.w] = True
    elif name == "hub":
        lane.ref(ref)
        lw = max(0, (L - K - 2) // 2)
        for i in range(R):
            a, z = i % 4, (i // 4) % 4
            s = np.concatenate([ref[499 - lw:499], [a], ref[500:500 + K],
                                [z], ref[501 + K:501 + K + lw]])
            lane.read(s.astype(np.uint8), strand=i % 2,
                      sample=S_TMR if i % 2 else S_NML)


def batch(K: int, R: int, L: int, N: int, E: int, seed: int = 0,
          lanes=LANES) -> dict:
    """Every lane of `lanes` packed at (R, L, LRAW): {field: numpy array}
    in pack.WindowBatch's dtypes (FIELDS)."""
    b = WindowBatch(len(lanes), R, L, LRAW)
    rng = np.random.default_rng([seed, K, R, L])
    for w, name in enumerate(lanes):
        _case(name, _Lane(b, w, rng), K, N, E)
    return {f: getattr(b, f) for f in FIELDS}


def hub_batch(K: int, R: int, L: int, seed: int = 0) -> dict:
    """The hub lane beside the plain one, for a build at D = HUB_D."""
    return batch(K, R, L, 1, 1, seed, lanes=("plain", "hub"))


def lane(name: str) -> int:
    return LANES.index(name)


def run(arrs: dict, K: int, N: int, E: int, D: int = D_ENGINE,
        device: str = "cpu", plain: bool = False, guard=None):
    """gpu.dbg.build_k (or build_k_plain) on a batch's arrays moved to
    `device` (the copies made first, the build alone inside the context
    manager `guard` where one is given)."""
    import contextlib

    import torch

    from . import dbg

    fn = dbg.build_k_plain if plain else dbg.build_k
    t = [torch.from_numpy(np.ascontiguousarray(arrs[f])).to(device)
         for f in FIELDS]
    with guard() if guard is not None else contextlib.nullcontext():
        return fn(K, *t, N=N, E=E, D=D, Lraw=LRAW, **SCALARS)
