"""The device graph engine's unitig compression pass: the hand-written CUDA
kernel of `csrc/compress.cu` and the dispatch to its plain version.

The JAX package runs `compress_round` (`tpu/stages.py::compress_round`,
:928, with its pointer jumping a `lax.while_loop`, :369) inside its jitted
attempt; PyTorch would launch each of its ~390 ops from the host and sync
on the jumping's predicate every round. Here it is one kernel launch per
call, a thread block cluster of C blocks a window (`compress_plan` picks C
and sizes the blocks' shared memory), with no host sync.

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

import contextlib
import ctypes
import os
import threading
from typing import NamedTuple

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
SCAN_WARPS = 8  # warps a block scan runs on (csrc/compress_body.cuh)
HEAD = 64  # a block's flags and staging barrier (compress_body.cuh kHead)
STAGED = 5  # mer inputs a worker stages at C >= 3 (kStaged)
# the cluster sizes the plans try, largest first (compress_body.cuh kMaxC)
CLUSTER_SIZES = (4, 3, 2, 1)

_lib = None
_lib_lock = threading.Lock()
_plans: dict = {}  # (library, device, W, NI, EE, NM) -> Plan


class Plan(NamedTuple):
    C: int     # blocks a window's cluster
    smem: int  # dynamic shared memory a block


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _mers_bytes(NI: int, NM: int) -> int:
    """The mers' owner's arrays (compress_body.cuh mer_layout): the sort's
    keys and indices (a padded mer), run starts, run ends, widths, their
    sums, the run base, after and before (a mer), the width totals, run
    ends and counts (an item), each mer's item, rank, survivor, flags and
    kept interval's low end."""
    pm = _pow2(NM)
    return (_r16(8 * pm) + _r16(4 * pm) + _r16(NM) + _r16(4 * NM)
            + 5 * _r16(8 * NM) + 2 * _r16(8 * NI) + _r16(4 * NI)
            + _r16(4 * NM) + _r16(8 * NM) + _r16(4 * NM) + _r16(NM)
            + _r16(8 * NM))


def _edges_bytes(NI: int, EE: int) -> int:
    """The edges' owner's (edge_layout): slots, buckets, clamped okeys and
    sources (an edge), degrees, cursors and offsets (an item)."""
    return 4 * _r16(4 * EE) + 2 * _r16(4 * NI) + _r16(8 * NI)


def _range_chunk(n: int, nw: int) -> int:
    """A worker's range of n elements (range_chunk): a multiple of 16."""
    return -(-(-(-n // nw)) // 16) * 16


def rank_smem(NI: int, EE: int, NM: int, C: int, rank: int) -> int:
    """Block `rank`'s dynamic shared memory in a cluster of C blocks, as
    compress_body.cuh's roles(): rank 0 the head, eight lanes of scan
    scratch, 32 bytes an item kept for the pass (flags, label, survivor,
    pos_u, start_off, merlen) and the largest of the item chain's scratch
    (links, jumping and merge: 36 an item; the items' order and aggregates:
    12 a padded item, 85 an item), at C = 1 also the mers' and the edges'
    arrays; a worker the head, one lane of scan scratch, the mers' owner's
    arrays (rank 1), the edges' owner's (rank C - 1) and its staged range
    of the mer inputs."""
    ni, S = NI, 2 * NI
    if rank == 0:
        keep = 4 * _r16(4 * ni) + 2 * _r16(8 * ni)
        links = (2 * _r16(4 * S) + _r16(8 * ni) + _r16(4 * ni)
                 + _r16(8 * ni))
        pi = _pow2(NI)
        items = (_r16(8 * pi) + _r16(4 * pi) + _r16(ni) + 3 * _r16(4 * ni)
                 + LANES * _r16(8 * ni) + _r16(8 * ni))
        need = max(links, items)
        if C == 1:
            need = max(need, _mers_bytes(NI, NM), _edges_bytes(NI, EE))
        return HEAD + LANES * (32 + SCAN_WARPS * 32) * 8 + keep + need
    o = HEAD + (32 + SCAN_WARPS * 32) * 8
    if rank == 1:
        o += _mers_bytes(NI, NM)
    if rank == C - 1:
        o += _edges_bytes(NI, EE)
    if C >= 2:
        ch = _range_chunk(NM, C - 1)
        o += 4 * (_r16(8 * ch) + 16) + _r16(ch) + 16
    return o


def cluster_smem(NI: int, EE: int, NM: int, C: int) -> int:
    """The dynamic shared memory of each block of a C-block cluster
    (compress_body.cuh cluster_smem): its largest rank's, rank 0's at the
    engine's shapes."""
    return max(rank_smem(NI, EE, NM, C, r) for r in range(C))


def fitting_sizes(smem_of, what: str) -> list:
    """The sizes of CLUSTER_SIZES, largest first, whose blocks' shared
    memory (smem_of(C)) fits a block; raises ValueError where none does."""
    fits = [C for C in CLUSTER_SIZES if smem_of(C) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"{what} does not fit in a block's shared memory")
    return fits


def resident_cluster(W: int, fits: list, smem_of, clusters: dict):
    """The Plan of the largest C of `fits` whose W clusters the card holds
    at once (clusters: {C: cudaOccupancyMaxActiveClusters}), or None."""
    for C in fits:
        if W <= clusters.get(C, 0):
            return Plan(C, smem_of(C))
    return None


def _check_sizes(NI: int, EE: int, NM: int) -> None:
    if NI < 1 or 2 * NI >= MAX_STATES:
        raise ValueError(f"compress_round takes 1 to {MAX_STATES // 2 - 1} "
                         f"items, got NI={NI}")
    if EE < 0 or NM < 0:
        raise ValueError(f"compress_round: EE={EE} and NM={NM} must be >= 0")


def compress_plan(W: int, NI: int, EE: int, NM: int,
                  clusters: dict) -> Plan:
    """The cluster a window takes and its blocks' shared memory: the
    largest C of CLUSTER_SIZES whose W clusters the card holds at once
    (`clusters`: {C: the most clusters of C}; on an H100 SXM 30 of 4, 39
    of 3, 66 of 2, 132 of 1: C 4 for a mesh shard's W 8-16 and the crafted
    W 1, 3 for the engine's W 32) and whose blocks fit a block's shared
    memory (each block takes the cluster's largest rank's: 224,656 bytes
    at C 3 and 4 at the engine's first call, NI 1,552, EE 3,872, NM
    1,536, rank 0's, where C 2 does not fit; 170,448 at C 3 at its compact
    calls, NI 528, EE 1,568, rank 1's), else the smallest C that fits, its
    clusters in turns. Raises for NI < 1 or 2 NI >= 2^18 (the packed word
    of the pointer jumping), EE or NM < 0, or a window whose blocks fit at
    no C (NI past 1,618 at EE 4,000)."""
    _check_sizes(NI, EE, NM)

    def smem_of(C):
        return cluster_smem(NI, EE, NM, C)

    fits = fitting_sizes(
        smem_of, f"compress_round: a window of NI={NI} items, EE={EE} edges "
        f"and NM={NM} mers")
    plan = resident_cluster(W, fits, smem_of, clusters)
    return plan or Plan(fits[-1], smem_of(fits[-1]))


def max_clusters(query, smem_of) -> dict:
    """{C: the most clusters of C blocks the current device holds at once,
    query(C, smem_of(C)) (a build's *_max_clusters entry point: its
    kernel's cudaOccupancyMaxActiveClusters)} over CLUSTER_SIZES, 0 where
    the blocks do not fit."""
    out = {}
    for C in CLUSTER_SIZES:
        smem = smem_of(C)
        n = query(C, smem) if smem <= SMEM_LIMIT else 0
        if n < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error "
                               f"{-1 - n}")
        out[C] = n
    return out


def plan_for(W: int, NI: int, EE: int, NM: int, dev, lib=None,
             clusters: dict | None = None) -> Plan:
    """The Plan compress_round's launch on `dev` takes for W windows of
    (NI, EE, NM): compress_plan over the card's clusters (max_clusters of
    `lib`, by default `build()`'s), its smem checked against the build's
    own layout; cached by (lib, device, shape), so that a repeated shape
    costs one dict lookup. `clusters` forces {C: clusters held at once}
    (not cached)."""
    lib = lib or _load()
    key = (lib, dev.index, W, NI, EE, NM)
    cache = clusters is None
    if cache and key in _plans:
        return _plans[key]
    with on_device(dev):
        if cache:
            clusters = max_clusters(lib.compress_max_clusters,
                                    lambda C: cluster_smem(NI, EE, NM, C))
        plan = compress_plan(W, NI, EE, NM, clusters)
        if lib.compress_smem(NI, EE, NM, plan.C) != plan.smem:
            raise RuntimeError("compress_smem disagrees with "
                               "csrc/compress_body.cuh's layout")
    if cache:
        _plans[key] = plan
    return plan


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
    lib.compress_round.argtypes = [vp, vp] + [ci] * 5 + [ll] * 3 + [sz, vp]
    lib.compress_smem.restype = sz
    lib.compress_smem.argtypes = [ci] * 4
    lib.compress_max_clusters.restype = ci
    lib.compress_max_clusters.argtypes = [ci, sz]
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def on_device(dev):
    """The context a launch on `dev` runs in: its CUDA device current, or
    nothing for the CPU tensors of an emulated build (tools/cuda_emu)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def stream(dev):
    """The stream handle a launch on `dev` takes (None for the CPU tensors
    of an emulated build)."""
    return _stream(dev) if dev.type == "cuda" else None


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


def _launch(st: dict, K: int, NI: int, N: int, Dcap: int, lib=None,
            clusters: dict | None = None):
    """Checks, plans, allocates the outputs and launches the kernel of
    `lib` (a `bind`-loaded build; by default `build()`'s). `clusters`
    ({C: the most clusters of C held at once}) is by default the card's
    (plan_for). Returns (outputs in OUTPUTS order, fallback)."""
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    dev = st["alive"].device
    _shapes(st, W, NI, EE, NM)
    _check_sizes(NI, EE, NM)
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
    lib = lib or _load()
    plan = plan_for(W, NI, EE, NM, dev, lib, clusters)
    with on_device(dev):  # the launch goes to the current device
        rc = lib.compress_round(ip, op, W, NI, EE, NM, plan.C, int(N),
                                int(K), int(Dcap), plan.smem, stream(dev))
    if rc != 0:
        raise RuntimeError(f"compress_round launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "compress_round")
    return outs, fallback


def compress_round(st: dict, K: int, NI: int, N: int, Dcap: int = 64):
    """One graph-wide compression pass (gpu.stages.compress_round_plain) of
    the state dict `st`: returns (a new dict with the rewritten keys of
    OUTPUTS, every other key passed through as the same tensor; fallback
    [W] bool). On the card a cluster of compress_plan's C blocks a window."""
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
