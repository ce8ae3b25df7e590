"""Batched Gotoh alignment: the fused hand-written CUDA kernel of
`csrc/gotoh.cu` (`gotoh_align`, fill and traceback in one launch) and its
plain PyTorch versions.

`align` takes tensors on one device. On the CPU it runs the plain versions
(`traceback_plain(dp_fill_plain(...))`); on a CUDA device it launches
`gotoh_align` on that device (whatever the thread's current device) and
raises if the kernel library cannot be built or a launch is refused. There
is no fallback from the card to the plain version.
`plan(N, M)` picks, from the batch's widths alone, where the kernel keeps
the traceback codes: in shared memory ("smem") when they fit, else in a
scratch buffer in device memory ("global"); a batch wider than one block's
8,192 rows (or whose shared staging does not fit) takes the "strips" mode,
codes in device memory and the rows filled in strips of 8,192. Each launch
adds one to `LAUNCHES["gotoh_align_" + mode]`.

Layouts are the JAX package's: S [P, N+1] and T [P, M+1] uint8 with the
characters 1-indexed and zero padding; the plain fill's tb [D, P, N+1]
uint8, D = N+M-1, tb[d-2, p, i] the packed byte (mtb | xext << 2 |
yext << 3) of cell (i, d-i); ops [P, N+M] uint8, back to front, zero past
the count. Preconditions: 0 <= n_len[p] <= N and 0 <= m_len[p] <= M.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import NamedTuple

import torch

from .._build import build_shared
from ..engine.align import (DIAG, GAP_EXTEND, GAP_OPEN, LEFT, MATCH,
                            MISMATCH, OP_DIAG, OP_SGAP, OP_TGAP, UP)
from . import count_launch

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "gotoh.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
RING = 128  # slots of each ring between warps (csrc/gotoh.cu kRing)
ROWS_PER_THREAD = (4, 5, 6, 8, 10, 12, 16, 24, 32)  # instantiations
STRIP_ROWS = 32 * 256  # rows of a block; the strip mode's strip

LAUNCHES = {"gotoh_align_smem": 0, "gotoh_align_global": 0,
            "gotoh_align_strips": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def dp_fill_plain(S, T, n_len, m_len, N: int, M: int):
    """Anti-diagonal Gotoh fill vectorised over pairs and the diagonal's
    lanes, step for step the JAX package's `_dp_fill`. Returns tb
    [N+M-1, P, N+1] uint8. Lanes outside a pair's cells hold don't-cares,
    as in the JAX version; the traceback never reads them."""
    P = S.shape[0]
    dev = S.device
    i32 = torch.int32
    idx = torch.arange(N + 1, device=dev)
    TR = torch.cat([T.flip(1), torch.zeros((P, N + 1), dtype=T.dtype,
                                           device=dev)], 1).to(i32)
    Si = S.to(i32)
    b1 = GAP_OPEN + GAP_EXTEND
    zero = torch.zeros((P, N + 1), dtype=i32, device=dev)
    Mp = torch.where(idx <= 1, b1, zero)
    Xp = torch.where(idx == 0, b1, zero)
    Yp = torch.where(idx == 1, b1, zero)
    Mp2 = zero
    out = torch.empty((N + M - 1, P, N + 1), dtype=torch.uint8, device=dev)
    is0 = idx == 0
    for d in range(2, N + M + 1):
        Mp_s = torch.roll(Mp, 1, 1)
        # X (vertical, consumes S) and Y (horizontal, consumes T): a tie
        # opens the gap
        ext = torch.roll(Xp, 1, 1) + GAP_EXTEND
        opn = Mp_s + GAP_OPEN
        xgt = ext > opn
        Xc = torch.where(xgt, ext, opn)
        exty = Yp + GAP_EXTEND
        opny = Mp + GAP_OPEN
        ygt = exty > opny
        Yc = torch.where(ygt, exty, opny)
        # T char of cell (i, d-i): TR[p, M - d + i]
        start = max(M - d, 0)
        tc = TR[:, start:start + N + 1]
        if d > M:
            tc = torch.roll(tc, d - M, 1)
        diagv = torch.roll(Mp2, 1, 1) + torch.where(Si == tc, MATCH,
                                                    MISMATCH)
        # M keeps the diagonal unless X, then Y, is strictly greater
        xw = Xc > diagv
        best = torch.where(xw, Xc, diagv)
        mtb = torch.where(xw, LEFT, DIAG)
        yw = Yc > best
        best = torch.where(yw, Yc, best)
        mtb = torch.where(yw, UP, mtb)
        b = GAP_OPEN + d * GAP_EXTEND
        isd = idx == d
        Mc = torch.where(is0 | isd, b, best)
        Xc = torch.where(is0, b, Xc)
        Yc = torch.where(isd, b, Yc)
        out[d - 2] = (mtb | (xgt.to(mtb.dtype) << 2)
                      | (ygt.to(mtb.dtype) << 3)).to(torch.uint8)
        Mp2, Mp, Xp, Yp = Mp, Mc.to(i32), Xc, Yc
    return out


def traceback_plain(tbs, n_len, m_len, N: int, M: int):
    """Forced-gap traceback vectorised over pairs, step for step the JAX
    package's `_dp_and_traceback` scan. Returns (ops [P, N+M] uint8 back
    to front, count [P] int32)."""
    D, P = tbs.shape[0], tbs.shape[1]
    dev = tbs.device
    ar = torch.arange(P, device=dev)
    i = n_len.to(torch.int64)
    j = m_len.to(torch.int64)
    fx = torch.zeros(P, dtype=torch.bool, device=dev)
    fy = torch.zeros(P, dtype=torch.bool, device=dev)
    k = torch.zeros(P, dtype=torch.int32, device=dev)
    ops = torch.zeros((N + M, P), dtype=torch.uint8, device=dev)
    # after n+m steps every pair is done; later steps emit 0 and change
    # nothing
    steps = int((i + j).max()) if P else 0
    for s in range(steps):
        tb = tbs[(i + j - 2).clamp(0, D - 1), ar, i.clamp(0, N)].to(
            torch.int64)
        mtb = tb & 3
        xext = ((tb >> 2) & 1).bool()
        yext = ((tb >> 3) & 1).bool()
        i0 = i == 0
        j0 = j == 0
        done = i0 & j0
        is_i0 = i0 & ~done
        is_j0 = ~i0 & j0
        inner = ~i0 & ~j0
        use_fx = inner & fx
        use_left = inner & ~fx & (mtb == LEFT)
        use_fy = inner & ~fx & (mtb != LEFT) & fy
        use_up = inner & ~fx & ~fy & (mtb == UP)
        use_diag = inner & ~(use_fx | use_left | use_fy | use_up)
        sgap = is_j0 | use_fx | use_left
        tgap = is_i0 | use_fy | use_up
        op = torch.where(use_diag, OP_DIAG,
                         torch.where(sgap, OP_SGAP, OP_TGAP))
        ops[s] = torch.where(done, 0, op).to(torch.uint8)
        i = i - (sgap | use_diag).to(torch.int64)
        j = j - (tgap | use_diag).to(torch.int64)
        fx = torch.where(use_fx | use_left, xext, fx)
        fy = torch.where(use_fy | use_up, yext, fy)
        k = torch.where(done, k, k + 1)
    return ops.t().contiguous(), k


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    mode: str  # "smem", "global" or "strips": see the module's docstring
    rows_per_thread: int
    threads: int
    smem: int  # bytes of dynamic shared memory a block takes


def _r16(x: int) -> int:
    return (x + 15) // 16 * 16


def code_rows(N: int, R: int) -> int:
    """Rows of code words a pair keeps: N rounded up to whole threads."""
    return -(-N // R) * R


def smem_bytes(N: int, M: int, R: int, threads: int,
               global_codes: bool) -> int:
    """Dynamic shared memory of one block, as csrc/gotoh.cu's `layout`:
    the code words (4 bits a cell, 8 cells of a row to a uint32; shared
    mode only), one ring of (M, X) pairs between neighbouring warps, T's
    characters, the staged ops and the op count."""
    words = 0 if global_codes else _r16(code_rows(N, R) * ((M + 7) // 8) * 4)
    return (words + _r16((threads // 32 - 1) * RING * 8) + _r16(M + 1)
            + _r16(N + M) + 16)


def strip_smem_bytes() -> int:
    """Dynamic shared memory of a strip-mode block: the rings between its 8
    warps and the op count (T's characters and the ops stay in device
    memory)."""
    return _r16(7 * RING * 8) + 16


def strip_scratch_words(P: int, N: int, M: int) -> int:
    """int32 words of the strip mode's scratch: every pair's code words,
    then one edge row of M+1 (M, X) pairs a pair."""
    return P * code_rows(N, 32) * ((M + 7) // 8) + 2 * P * (M + 1)


def plan(N: int, M: int) -> Plan:
    """The launch of `gotoh_align` for batch widths N, M: the fewest rows
    per thread that keep a block within 4 warps (one per scheduler of the
    SM; up to 8 warps at 32 rows), and the shared mode wherever the codes
    fit in a block's shared memory. N above STRIP_ROWS, or a global-mode
    block whose staged T and ops overflow shared memory, takes the strip
    mode (32 rows a thread, 256 threads)."""
    if N <= STRIP_ROWS:
        for R in ROWS_PER_THREAD:
            threads = (-(-N // R) + 31) // 32 * 32
            if threads <= 128 or (R == 32 and threads <= 256):
                break
        smem = smem_bytes(N, M, R, threads, False)
        if smem <= SMEM_LIMIT:
            return Plan("smem", R, threads, smem)
        smem = smem_bytes(N, M, R, threads, True)
        if smem <= SMEM_LIMIT:
            return Plan("global", R, threads, smem)
    return Plan("strips", 32, 256, strip_smem_bytes())


# ---------------------------------------------------------------------------
# kernel library
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    return shutil.which("nvcc") or "nvcc"


def build() -> str:
    """Compile csrc/gotoh.cu for sm_90a (if not built yet); returns the .so
    path. Raises _build.BuildError with nvcc's error text. The ptxas report
    (registers, shared memory, spills) is kept beside the library as
    <so>.log."""
    return build_shared(_SRC, "libgotoh", [_nvcc()] + NVCC_FLAGS + [_SRC])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.gotoh_align.restype = ci
            lib.gotoh_align.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                        ci, ci, ci, ci, ctypes.c_size_t, vp]
            lib.gotoh_align_strips.restype = ci
            lib.gotoh_align_strips.argtypes = [vp] * 7 + [ci] * 3 + [
                ctypes.c_size_t, vp]
            _lib = lib
        return _lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_batch(n_len, m_len, N, M, device):
    """Validate the lengths and widths of a batch; returns P."""
    if N < 1 or M < 1:
        raise ValueError(f"N and M must be >= 1, got {N}, {M}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    P = n_len.shape[0]
    _check("n_len", n_len, torch.int32, (P,), device)
    _check("m_len", m_len, torch.int32, (P,), device)
    return P


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def align(S, T, n_len, m_len, N: int, M: int):
    """Gotoh fill and forced-gap traceback of a batch: the plain versions on
    the CPU, one `gotoh_align` launch on the card. Returns (ops [P, N+M]
    uint8 back to front, count [P] int32)."""
    dev = S.device
    P = _check_batch(n_len, m_len, N, M, dev)
    _check("S", S, torch.uint8, (P, N + 1), dev)
    _check("T", T, torch.uint8, (P, M + 1), dev)
    if dev.type == "cpu":
        return traceback_plain(dp_fill_plain(S, T, n_len, m_len, N, M),
                               n_len, m_len, N, M)
    pl = plan(N, M)
    lib = _load()
    ops = torch.empty((P, N + M), dtype=torch.uint8, device=dev)
    count = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return ops, count
    glob = pl.mode == "global"
    ptrs = (S.data_ptr(), T.data_ptr(), n_len.data_ptr(), m_len.data_ptr(),
            ops.data_ptr(), count.data_ptr())
    # the launch (and its cudaFuncSetAttribute) goes to the current
    # device: make that the inputs' device
    with torch.cuda.device(dev):
        if pl.mode == "strips":
            scratch = torch.empty(strip_scratch_words(P, N, M),
                                  dtype=torch.int32, device=dev)
            rc = lib.gotoh_align_strips(*ptrs, scratch.data_ptr(), P, N, M,
                                        pl.smem, _stream(dev))
        else:
            scratch = (torch.empty((P, code_rows(N, pl.rows_per_thread)
                                    * ((M + 7) // 8)), dtype=torch.int32,
                                   device=dev) if glob else None)
            rc = lib.gotoh_align(*ptrs, scratch.data_ptr() if glob else None,
                                 P, N, M, pl.rows_per_thread, pl.threads,
                                 int(glob), pl.smem, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"gotoh_align ({pl.mode}) launch failed: CUDA "
                           f"error {rc}")
    count_launch(LAUNCHES, "gotoh_align_" + pl.mode)
    return ops, count
