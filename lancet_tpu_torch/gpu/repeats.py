"""Batched repeat gates: isRepeat / isAlmostRepeat over all windows and all
k values in one device pass.

The reference runs an O(L^2*K) CPU scan per (window, k) retry
(util.cc:295-360, called at Microassembler.cc:118-131, 799-800). Here every
(window, k) verdict of a batch comes from one launch of the hand-written
CUDA kernel of `csrc/repeats.cu` (`repeat_gates`). `gates_plain` is the
plain PyTorch version: the JAX package's `gates_impl` step for step (a
scan over the shifts d with [W, L] mismatch prefix sums shared across k).

Semantics preserved exactly, including the reference's quirks: the final
k-mer offset L-k is excluded, and the "almost" window is K+1 long.

The kernel reduces a window to two numbers, the longest exact run Z and
the longest stretch A within the mismatch budget over all shifts, clamped
to the k list, and deals the window's (shift, start) plane in tiles over
a cluster of blocks; `gates_plan` picks the cluster, the block, the tile
and the mismatch words a thread holds from (W, L, ks, max_mismatch).

`gates` takes tensors on one device: on the CPU it runs `gates_plain`; on
a CUDA device it launches the kernel on that device and raises if the
kernel library cannot be built or the launch is refused. There is no
fallback from the card to the plain version. Each launch adds one to
`LAUNCHES["repeat_gates"]`. Windows reach it as latin-1 bytes, so `N` and
lowercase compare as bytes. Every k must be >= 0; any max_mismatch is
taken.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from .._build import build_shared
from . import count_launch, resolve_device
from .gotoh import NVCC_FLAGS, SMEM_LIMIT, _check, _nvcc, _stream

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "repeats.cu")
PLAIN_ROWS = 256  # windows a step of the plain version holds at once
# csrc/repeats.cu: a cluster of at most 8 blocks a window, at most 5
# mismatch words in a thread's registers, 64 zeroed bytes past a window
MAX_CLUSTER = 8
MAX_WORDS = 5
PAD = 64
MAX_TILE = 1024  # window starts a tile, a multiple of 32
H100_SMS = 132
# the kernel's threads an SM holds at once: ~50 registers a thread (ptxas,
# csrc/repeats.cu) leave room for ~1,150 of 2,048
THREADS_PER_SM = 1024

LAUNCHES = {"repeat_gates": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gates_plain(seq, lens, ks: tuple, max_mismatch: int):
    """seq: [W, L] uint8; lens: [W] int32; every k >= 0.
    Returns (gates, exact) bool [W, len(ks)]: gates True if k is gated
    (repeat or near-repeat), exact True if it is an exact repeat.

    The JAX package's `gates_impl` step for step: a scan over the shift
    axis d; at each d the mismatches of seq against itself shifted by d+1
    (index clamped at L-1, masked beyond each window's length), their
    prefix sums, and per k the windowed counts at every offset o, valid
    while o <= len - k - 1 - (d+1). Offsets past L-d-2 are never valid
    for k >= 0 and are left out; windows go PLAIN_ROWS at a time, to bound
    the [rows, nk, L+1] counts."""
    W, L = seq.shape
    dev = seq.device
    nk = len(ks)
    gates = torch.zeros((W, nk), dtype=torch.bool, device=dev)
    exact_acc = torch.zeros((W, nk), dtype=torch.bool, device=dev)
    if W == 0 or nk == 0:
        return gates, exact_acc
    p_idx = torch.arange(L, device=dev)
    o_full = torch.arange(L + 1, device=dev)
    ks_arr = torch.tensor(ks, dtype=torch.int64, device=dev)  # [nk]
    # per-k window-end gather indices [nk, L+1]
    hi_k = torch.clamp(o_full[None, :] + ks_arr[:, None], max=L)
    hi_k1 = torch.clamp(o_full[None, :] + ks_arr[:, None] + 1, max=L)
    for r0 in range(0, W, PLAIN_ROWS):
        sq = seq[r0 : r0 + PLAIN_ROWS]
        ln = lens[r0 : r0 + PLAIN_ROWS].to(torch.int64)
        g_acc = gates[r0 : r0 + PLAIN_ROWS]
        e_acc = exact_acc[r0 : r0 + PLAIN_ROWS]
        zero = torch.zeros((sq.shape[0], 1), dtype=torch.int32, device=dev)
        for d in range(L - 1):
            idx = torch.clamp(p_idx + d + 1, max=L - 1)
            neq = (sq[:, idx] != sq).to(torch.int32)  # [w, L]
            neq = torch.where((p_idx + d + 1)[None, :] < ln[:, None], neq, 0)
            pref = torch.cat([zero, torch.cumsum(neq, 1, dtype=torch.int32)],
                             1)
            no = L - d - 1  # offsets 0 .. L-d-2
            o = o_full[:no]
            cnt_k = pref[:, hi_k[:, :no]] - pref[:, None, :no]  # [w, nk, no]
            cnt_k1 = pref[:, hi_k1[:, :no]] - pref[:, None, :no]
            lim = ln[:, None, None] - ks_arr[None, :, None] - 1 - (d + 1)
            mask = o[None, None, :] <= lim
            exact = (mask & (cnt_k == 0)).any(2)  # [w, nk]
            almost = (mask & (cnt_k1 <= max_mismatch)).any(2)
            g_acc |= exact | almost
            e_acc |= exact
    return gates, exact_acc


class GatePlan(NamedTuple):
    words: int  # mismatch words a thread holds (2-5); 0: the plain scan
    blocks: int  # blocks a window (a thread block cluster)
    threads: int  # a block's threads
    tile: int  # window starts of one shift a tile (a multiple of 32)
    smem: int  # bytes of dynamic shared memory a block takes
    kmin: int  # the least and largest k, clamped to L + 1
    kmax: int


def gates_smem(L: int, words: int) -> int:
    """A block's shared memory, as csrc/repeats.cu's repeat_gates_smem:
    the window's bytes, rounded to 16, and, where words are built, PAD
    zeroed bytes past them and the two bit planes of as many positions."""
    if not words:
        return (L + 15) // 16 * 16
    n = L + PAD
    return (n + 15) // 16 * 16 + (n + 31) // 32 * 8


def clamp_ks(ks, L: int) -> tuple[int, int]:
    """(kmin, kmax) of a k list as the kernel takes them: no window of
    width L repeats past L + 1, so both are clamped there."""
    kmax = min(max(ks), L + 1)
    return min(min(ks), kmax), kmax


def first_starts(n: int, kmin: int, kmax: int, max_mismatch: int) -> int:
    """maxp of a window of length n: shift s (1 <= s <= maxp) holds the
    window starts [0, maxp - s] of the first windows tested, Z's
    max(kmin-1, 0)+1 bits inside [0, n-1-s) and A's kmin+1 inside [0,
    n-s); 0 where no window is tested (csrc/repeats.cu computes the
    same)."""
    bz, ba = max(kmin - 1, 0), kmin if max_mismatch >= 0 else 0
    acap = kmax + 1 if max_mismatch >= 0 else 0
    c0 = min(bz + 2 if bz < kmax else 1 << 31, ba + 1 if ba < acap
             else 1 << 31)
    return 0 if c0 == 1 << 31 else max(n - c0, 0)


def tile_count(maxp: int, tile: int) -> int:
    """Tiles of a window: (maxp + 1) // 2 pairs of shifts (1+i, maxp-i),
    whose starts laid end to end make maxp + 1, each cut into tiles of
    `tile` starts (the last one shorter)."""
    if maxp < 1:
        return 0
    return (maxp + 1) // 2 * ((maxp + tile) // tile)


def gates_plan(W: int, L: int, ks, max_mismatch: int,
               sms: int = H100_SMS) -> GatePlan:
    """The launch of one batch of W windows of width L: the words a thread
    holds, from the widest window tested (kmax+1, or kmax without an A
    budget; 0, the plain scan, past MAX_WORDS words or where the window
    and its pad do not fit a block's shared memory); threads a window
    enough to fill the card's sms x THREADS_PER_SM threads when W is
    small (at most a cluster of MAX_CLUSTER blocks of 512, and no more
    than the tiles of 32 starts), as blocks of at most 512; then the tile
    (a multiple of 32 up to MAX_TILE starts) that gives a window's
    busiest thread the fewest starts, a word of halo each tile counted,
    the longest of those. Raises for a window beyond a block's shared
    memory."""
    if W < 1 or L < 1 or not ks:
        raise ValueError(f"gates_plan needs W, L >= 1 and a k, got W={W}, "
                         f"L={L}, ks={ks}")
    kmin, kmax = clamp_ks(ks, L)
    widest = max(kmax + 1 if max_mismatch >= 0 else kmax, 1)
    words = -(-widest // 32) + 1
    if words > MAX_WORDS or gates_smem(L, words) > SMEM_LIMIT - 16:
        words = 0
    smem = gates_smem(L, words)
    if smem > SMEM_LIMIT - 16:  # 16: the block's bars
        raise ValueError(f"repeat_gates: windows of L={L} bytes do not fit "
                         f"in a block's shared memory")
    maxp = first_starts(L, kmin, kmax, max_mismatch)
    per_window = sms * THREADS_PER_SM // W // 128 * 128
    per_window = min(max(per_window, 128), MAX_CLUSTER * 512,
                     max(32, (tile_count(maxp, 32) + 31) // 32 * 32))
    blocks = -(-per_window // 512)
    threads = (-(-per_window // blocks) + 31) // 32 * 32
    halo = 32 if words else widest  # positions a tile reads past its end

    def busiest(g):  # the starts and halos of a window's busiest thread
        return -(-tile_count(maxp, g) // (blocks * threads)) * (g + halo)

    tile = min(range(MAX_TILE, 31, -32), key=busiest)
    return GatePlan(words, blocks, threads, tile, smem, kmin, kmax)


def build() -> str:
    """Compile csrc/repeats.cu for sm_90a (if not built yet); returns the
    .so path. Raises _build.BuildError with nvcc's error text."""
    return build_shared(_SRC, "librepeats", [_nvcc()] + NVCC_FLAGS + [_SRC])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.repeat_gates.restype = ci
            lib.repeat_gates.argtypes = [vp] * 6 + [ci] * 10 + [
                ctypes.c_size_t, vp]
            _lib = lib
        return _lib


def gates(seq, lens, ks, max_mismatch: int, work=None):
    """Repeat gates of a batch: `gates_plain` on the CPU, one
    `repeat_gates` launch on the card (gates_plan). Returns (gates, exact)
    bool [W, len(ks)]. `work`, an int64 [3] tensor on the card, gets the
    kernel's mismatch words built from bytes (positions, for the plain
    scan), window tests and words built from bit planes added to it."""
    dev = seq.device
    if seq.dim() != 2:
        raise ValueError(f"seq must be [W, L], got {tuple(seq.shape)}")
    W, L = seq.shape
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check("seq", seq, torch.uint8, (W, L), dev)
    _check("lens", lens, torch.int32, (W,), dev)
    if work is not None:
        _check("work", work, torch.int64, (3,), dev)
    ks = tuple(int(k) for k in ks)
    if any(k < 0 for k in ks):
        raise ValueError(f"every k must be >= 0, got {ks}")
    if dev.type == "cpu":
        return gates_plain(seq, lens, ks, max_mismatch)
    g = torch.zeros((W, len(ks)), dtype=torch.bool, device=dev)
    e = torch.zeros((W, len(ks)), dtype=torch.bool, device=dev)
    if W == 0 or not ks or L == 0:
        return g, e
    launch(seq, lens, ks, max_mismatch,
           gates_plan(W, L, ks, max_mismatch, _sms(dev)), g, e, work)
    count_launch(LAUNCHES, "repeat_gates")
    return g, e


def launch(seq, lens, ks: tuple, max_mismatch: int, pl: GatePlan, g, e,
           work=None) -> None:
    """One repeat_gates launch of plan `pl` on checked card tensors,
    writing the bool [W, nk] outputs g and e (gates() counts it; the
    comparisons of other plans call it directly)."""
    dev = seq.device
    W, L = seq.shape
    lib = _load()
    # a budget past the widest window's bits is one past it
    mm = max(min(int(max_mismatch), pl.kmax + 1), -1)
    ks_d = torch.tensor(ks, dtype=torch.int32).to(dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.repeat_gates(seq.data_ptr(), lens.data_ptr(),
                              ks_d.data_ptr(), g.data_ptr(), e.data_ptr(),
                              None if work is None else work.data_ptr(), W,
                              L, len(ks), mm, pl.kmin, pl.kmax, pl.words,
                              pl.blocks, pl.threads, pl.tile, pl.smem,
                              _stream(dev))
    if rc != 0:
        raise RuntimeError(f"repeat_gates launch failed: CUDA error {rc}")


_SMS: dict = {}


def _sms(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def pack(windows: list[str]):
    """[W, L] uint8 latin-1 bytes, zero padded to the longest window, and
    the lengths [W] int32."""
    L = max(1, max(len(w) for w in windows))
    seq = np.zeros((len(windows), L), np.uint8)
    lens = np.zeros(len(windows), np.int32)
    for i, w in enumerate(windows):
        seq[i, : len(w)] = np.frombuffer(w.encode("latin-1"), np.uint8)
        lens[i] = len(w)
    return seq, lens


def repeat_gates(windows: list[str], ks: list[int], max_mismatch: int,
                 with_exact: bool = False, device="cuda"):
    """Per-window, per-k gate verdicts (True = skip this k) as numpy bool
    [len(windows), len(ks)], computed on `device` at the batch's exact
    width; optionally also the exact-repeat matrix (used for the maxK
    window skip)."""
    if not windows:
        z = np.zeros((0, len(ks)), bool)
        return (z, z) if with_exact else z
    dev = resolve_device(device)
    seq, lens = pack(windows)
    g, e = gates(torch.from_numpy(seq).to(dev), torch.from_numpy(lens).to(dev),
                 ks, max_mismatch)
    g = g.cpu().numpy()
    if with_exact:
        return g, e.cpu().numpy()
    return g
