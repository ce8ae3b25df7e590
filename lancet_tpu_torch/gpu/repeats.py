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

import numpy as np
import torch

from .._build import build_shared
from . import count_launch, resolve_device
from .gotoh import NVCC_FLAGS, _check, _nvcc, _stream

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "repeats.cu")
MAX_THREADS = 256  # csrc/repeats.cu kMaxThreads
PLAIN_ROWS = 256  # windows a step of the plain version holds at once

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


def plan_threads(L: int) -> int:
    """Block size for windows of width L: the L // 2 shift pairs of the
    longest window split into the fewest rounds of at most MAX_THREADS
    threads, the threads rounded up to whole warps."""
    pairs = max(1, L // 2)
    rounds = -(-pairs // MAX_THREADS)
    return (-(-pairs // rounds) + 31) // 32 * 32


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
            lib.repeat_gates.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                         ci, vp]
            _lib = lib
        return _lib


def gates(seq, lens, ks, max_mismatch: int):
    """Repeat gates of a batch: `gates_plain` on the CPU, one
    `repeat_gates` launch on the card. Returns (gates, exact) bool
    [W, len(ks)]."""
    dev = seq.device
    if seq.dim() != 2:
        raise ValueError(f"seq must be [W, L], got {tuple(seq.shape)}")
    W, L = seq.shape
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check("seq", seq, torch.uint8, (W, L), dev)
    _check("lens", lens, torch.int32, (W,), dev)
    ks = tuple(int(k) for k in ks)
    if any(k < 0 for k in ks):
        raise ValueError(f"every k must be >= 0, got {ks}")
    if dev.type == "cpu":
        return gates_plain(seq, lens, ks, max_mismatch)
    nk = len(ks)
    g = torch.zeros((W, nk), dtype=torch.bool, device=dev)
    e = torch.zeros((W, nk), dtype=torch.bool, device=dev)
    if W == 0 or nk == 0 or L == 0:
        return g, e
    lib = _load()
    ks_d = torch.tensor(ks, dtype=torch.int32).to(dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.repeat_gates(seq.data_ptr(), lens.data_ptr(),
                              ks_d.data_ptr(), g.data_ptr(), e.data_ptr(), W,
                              L, nk, int(max_mismatch), plan_threads(L),
                              _stream(dev))
    if rc != 0:
        raise RuntimeError(f"repeat_gates launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "repeat_gates")
    return g, e


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
