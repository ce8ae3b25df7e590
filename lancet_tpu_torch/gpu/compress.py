"""The device graph engine's unitig compression pass: the hand-written CUDA
kernel of `csrc/compress.cu` and the dispatch to its plain version.

The JAX package runs `compress_round` (`tpu/stages.py::compress_round`,
:928, with its pointer jumping a `lax.while_loop`, :369) inside its jitted
attempt; PyTorch would launch each of its ~390 ops from the host and sync
on the jumping's predicate every round. Here it is one kernel launch per
call, one block a window (`compress_plan` sizes the block's shared memory),
with no host sync.

The wrapper takes the engine's state dict (the keys of INPUTS) on one
device and raises, before any work, when they span two. On the CPU it runs
the plain version (gpu.stages.compress_round_plain: the JAX function op for
op); on a CUDA device it launches the kernel on that device and raises,
before the launch, for shapes or dtypes the kernel does not take, and after
it if the library cannot be built or the launch is refused. There is no
fallback from the card to the plain version. The kernel reads the engine's
int64 and bool tensors as they are (no copy). Each launch adds one to
`LAUNCHES["compress_round"]`.

The kernel assumes what the plain version's scatters need of an alive edge:
its source and destination in [0, NI) and its direction in [0, 3]; and an
alive edge's okey >= 0 (creation order, the anchors' 0, BIG-2 and BIG-1,
Dcap * (1 or 2) + slot). The engine's states hold it; other data gives
wrong answers, never a fault.
"""

from __future__ import annotations

import ctypes
import os
import threading
import torch

from .._build import build_shared
from . import count_launch, input_device
from .gotoh import NVCC_FLAGS, SMEM_LIMIT, _nvcc, _r16, _stream

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "compress.cu")
LAUNCHES = {"compress_round": 0}

# the state's keys the pass reads, in the kernel's order, with their
# dtypes and item / edge / mer axis
INPUTS = (("alive", torch.bool, "i"), ("special", torch.bool, "i"),
          ("rank", torch.int64, "i"), ("merlen", torch.int64, "i"),
          ("csum", torch.int64, "i4"), ("n_t", torch.int64, "i"),
          ("is_tumor", torch.bool, "i"), ("is_normal", torch.bool, "i"),
          ("e_src", torch.int64, "e"), ("e_dst", torch.int64, "e"),
          ("e_dir", torch.int64, "e"), ("e_alive", torch.bool, "e"),
          ("e_okey", torch.int64, "e"), ("mer_item", torch.int64, "m"),
          ("mer_flip", torch.bool, "m"), ("mer_pos", torch.int64, "m"),
          ("keep_lo", torch.int64, "m"), ("keep_hi", torch.int64, "m"))
INPUT_KEYS = tuple(k for k, _, _ in INPUTS)
# the keys the pass rewrites, in the kernel's order (then the fallback)
OUTPUTS = (
    ("alive", torch.bool, "i"), ("merlen", torch.int64, "i"),
    ("csum", torch.int64, "i4"), ("n_t", torch.int64, "i"),
    ("is_tumor", torch.bool, "i"), ("is_normal", torch.bool, "i"),
    ("e_src", torch.int64, "e"), ("e_dst", torch.int64, "e"),
    ("e_dir", torch.int64, "e"), ("e_alive", torch.bool, "e"),
    ("e_okey", torch.int64, "e"), ("mer_item", torch.int64, "m"),
    ("mer_flip", torch.bool, "m"), ("mer_pos", torch.int64, "m"),
    ("keep_lo", torch.int64, "m"), ("keep_hi", torch.int64, "m"))
OUTPUT_KEYS = tuple(k for k, _, _ in OUTPUTS)

LANES = 8  # item aggregates: merlen, csum[4], n_t, is_tumor, is_normal
MAX_STATES = 1 << 18  # a state id (2 NI of them) fits the packed word
SCAN_WARPS = 8  # warps a block scan runs on (csrc/compress.cu kScanWarps)
# dynamic shared memory a block may take beside the scans' static arrays
# (csrc/compress.cu kDynLimit)
DYN_LIMIT = SMEM_LIMIT - LANES * 32 * 8 - LANES * SCAN_WARPS * 32 * 8

_lib = None
_lib_lock = threading.Lock()


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def compress_smem(NI: int, EE: int, NM: int) -> int:
    """A block's dynamic shared memory, as csrc/compress.cu's layout(): 32
    bytes an item kept for the whole block (flags, label, survivor, pos_u,
    start_off, merlen), then the largest of the stages' scratch: links,
    jumping and merge (36 an item), the items' order and aggregates (12 a
    padded item for the sort, 85 an item), the mers' (12 a padded mer,
    49 a mer, 12 an item) and the edges' (16 an edge, 16 an item)."""
    ni, S = NI, 2 * NI
    keep = 4 * _r16(4 * ni) + 2 * _r16(8 * ni)
    links = 2 * _r16(4 * S) + _r16(8 * ni) + _r16(4 * ni) + _r16(8 * ni)
    pi, pm = _pow2(NI), _pow2(NM)
    items = (_r16(8 * pi) + _r16(4 * pi) + _r16(ni) + 3 * _r16(4 * ni)
             + LANES * _r16(8 * ni) + _r16(8 * ni))
    mers = (_r16(8 * pm) + _r16(4 * pm) + _r16(NM) + _r16(4 * NM)
            + 4 * _r16(8 * NM) + _r16(8 * ni) + _r16(4 * ni) + _r16(4 * NM)
            + _r16(8 * NM))
    edges = 4 * _r16(4 * EE) + 2 * _r16(4 * ni) + _r16(8 * ni)
    return keep + max(links, items, mers, edges)


def compress_plan(NI: int, EE: int, NM: int) -> int:
    """The bytes of dynamic shared memory a block takes (206,160 at the
    engine's first call, NI 1,552, EE 3,872, NM 1,536; 123,072 at its
    compact calls, NI 528, EE 1,568). Raises for NI < 1 or 2 NI >= 2^18
    (the packed word of the pointer jumping), EE or NM < 0, or a window
    that does not fit a block's shared memory (NI past ~1,610 at EE
    4,000)."""
    if NI < 1 or 2 * NI >= MAX_STATES:
        raise ValueError(f"compress_round takes 1 to {MAX_STATES // 2 - 1} "
                         f"items, got NI={NI}")
    if EE < 0 or NM < 0:
        raise ValueError(f"compress_round: EE={EE} and NM={NM} must be >= 0")
    smem = compress_smem(NI, EE, NM)
    if smem > DYN_LIMIT:
        raise ValueError(f"compress_round: a window of NI={NI} items, "
                         f"EE={EE} edges and NM={NM} mers does not fit in a "
                         f"block's shared memory")
    return smem


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> str:
    """Compile csrc/compress.cu for sm_90a (if not built yet); returns the
    .so path. Raises _build.BuildError with nvcc's error text."""
    return build_shared(_SRC, "libcompress", [_nvcc()] + NVCC_FLAGS + [_SRC])


def bind(path: str) -> ctypes.CDLL:
    """Loads a build of csrc/compress.cu and declares its entry points."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll, sz = ctypes.c_longlong, ctypes.c_size_t
    lib.compress_round.restype = ci
    lib.compress_round.argtypes = [vp, vp] + [ci] * 4 + [ll] * 3 + [sz, vp]
    lib.compress_smem.restype = sz
    lib.compress_smem.argtypes = [ci] * 3
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _shapes(st: dict, W: int, NI: int, EE: int, NM: int) -> None:
    want = {"i": (W, NI), "i4": (W, NI, 4), "e": (W, EE), "m": (W, NM)}
    for k, dt, ax in INPUTS:
        t = st[k]
        if tuple(t.shape) != want[ax]:
            raise ValueError(f"compress_round: {k} has shape "
                             f"{tuple(t.shape)}, the kernel takes "
                             f"{want[ax]}")
        if t.dtype != dt:
            raise ValueError(f"compress_round takes {k} as {dt}, got "
                             f"{t.dtype}")


def _launch(st: dict, K: int, NI: int, N: int, Dcap: int, lib=None):
    """Checks, allocates the outputs and launches the kernel of `lib` (a
    `bind`-loaded build; by default `build()`'s). Returns (outputs in
    OUTPUTS order, fallback)."""
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    dev = st["alive"].device
    _shapes(st, W, NI, EE, NM)
    smem = compress_plan(NI, EE, NM)
    shape = {"i": (W, NI), "i4": (W, NI, 4), "e": (W, EE), "m": (W, NM)}
    outs = [torch.empty(shape[ax], dtype=dt, device=dev)
            for _, dt, ax in OUTPUTS]
    fallback = torch.empty((W,), dtype=torch.bool, device=dev)
    if W == 0:
        return outs, fallback
    ins = [st[k].contiguous() for k in INPUT_KEYS]
    ip = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    op = (ctypes.c_void_p * (len(outs) + 1))(
        *[t.data_ptr() for t in outs], fallback.data_ptr())
    args = (W, NI, EE, NM, int(N), int(K), int(Dcap), smem)
    with torch.cuda.device(dev):  # the launch goes to the current device
        lib = lib or _load()
        if lib.compress_smem(NI, EE, NM) != smem:
            raise RuntimeError("compress_smem disagrees with "
                               "csrc/compress.cu's layout")
        rc = lib.compress_round(ip, op, *args, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"compress_round launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "compress_round")
    return outs, fallback


def compress_round(st: dict, K: int, NI: int, N: int, Dcap: int = 64):
    """One graph-wide compression pass (gpu.stages.compress_round_plain) of
    the state dict `st`: returns (a new dict with the rewritten keys of
    OUTPUTS, every other key passed through as the same tensor; fallback
    [W] bool). On the card one block a window (compress_plan)."""
    dev = input_device("compress_round", *[st[k] for k in INPUT_KEYS])
    if dev.type == "cpu":
        from .stages import compress_round_plain

        return compress_round_plain(st, K, NI, N, Dcap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    outs, fallback = _launch(st, K, NI, N, Dcap)
    out = dict(st)
    out.update(zip(OUTPUT_KEYS, outs))
    return out, fallback
