"""The device graph engine's component labels, compaction and low-coverage
pass: the hand-written CUDA kernels of `csrc/graphstate.cu` and the
dispatch to their plain versions.

The JAX package runs these functions inside its jitted attempt
(`tpu/stages.py::components`, :73, its label propagation a
`lax.while_loop` at :103; `compact_state`, :406; `low_cov_pass`, :528,
with `item_mincovs`, :382, and `remove_items`, :516); PyTorch would launch
each of their ~60-115 ops from the host, and sync on the propagation's
predicate every round and on compact_state's hold-point. Here each is one
kernel launch per call, with no host sync:

- `components`: one block a window, the plain version's Jacobi rounds in
  shared memory to the window's own fixed point, then the numbering;
- `compact_state`: three blocks a window (items, edges, mers), each with
  the regular items' ranks from a block scan;
- `item_mincovs` and `low_cov_pass`: a thread block cluster of C blocks a
  window (`lowcov_plan`: C 4, so 128 blocks at W 32), each rank a range
  of the mers, items and edges: a lane a mer over its kept positions of
  mer_totq (a wide kept window by the warp), its block's per-item minima
  in shared memory, each item's minimum over the cluster by its owner,
  then (low_cov_pass) the low test and the removal by ranges.

Each wrapper takes tensors on one device and raises, before any work, when
its inputs span two. On the CPU it runs the plain version
(gpu.stages.components_plain, compact_state_plain, item_mincovs_plain,
low_cov_pass_plain: the JAX functions op for op); on a CUDA device it
launches the kernel on that device and raises, before the launch, for
shapes or dtypes the kernel does not take, and after it if the library
cannot be built or the launch is refused. There is no fallback from the
card to the plain version. The kernels read the engine's int64 and bool
tensors as they are (no copy; mer_totq, a slice of the build's mer axis,
through its window stride). Each launch adds one to `LAUNCHES[name]`.

What the kernels assume, as the engine's states hold it (other data gives
wrong answers, never a fault):
- `components`: an alive edge's ends in [0, NI) (the plain scatter's
  indices). The kernel reproduces the plain rounds bit for bit, the
  clamp of an unlabelled item's BIG through item NI - 1 included, so it
  relies on nothing about item NI - 1;
- `compact_state`: the anchors N + 2 Cmax <= NI;
- `low_cov_pass` / `item_mincovs`: K <= 64 (the engine's K <= 63).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import torch

from .._build import build_shared
from . import compress, count_launch, input_device
from .gotoh import NVCC_FLAGS, SMEM_LIMIT, _nvcc, _r16

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "graphstate.cu")
LAUNCHES = {"components": 0, "compact_state": 0, "item_mincovs": 0,
            "low_cov_pass": 0}
BIG = 1 << 30
MAX_K = 64  # a mer row's positions: two a lane (csrc kMaxK)
RANGE_ALIGN = 32  # a rank's range of mers, items or edges: whole warps
NARROW = 8  # kept positions a lane reads itself (csrc kNarrow)
MAX_C = 4  # blocks a low-coverage window's cluster (csrc kMaxC)
MAX_ITEMS = (1 << 30) - 1  # labels and slots in int32 beside BIG

# inputs of each kernel, in its order: (state key, dtype, axis); the axes:
# i [W, NI], i4 [W, NI, 4], e [W, EE], m [W, NM], mK [W, NM, K]
COMPONENTS_INPUTS = (("alive", torch.bool, "i"), ("e_src", torch.int64, "e"),
                     ("e_dst", torch.int64, "e"),
                     ("e_alive", torch.bool, "e"),
                     ("rank", torch.int64, "i"))
COMPACT_INPUTS = (
    ("alive", torch.bool, "i"), ("special", torch.bool, "i"),
    ("rank", torch.int64, "i"), ("merlen", torch.int64, "i"),
    ("n_t", torch.int64, "i"), ("is_tumor", torch.bool, "i"),
    ("is_normal", torch.bool, "i"), ("comp", torch.int64, "i"),
    ("csum", torch.int64, "i4"), ("e_src", torch.int64, "e"),
    ("e_dst", torch.int64, "e"), ("e_dir", torch.int64, "e"),
    ("e_alive", torch.bool, "e"), ("e_okey", torch.int64, "e"),
    ("mer_item", torch.int64, "m"), ("keep_lo", torch.int64, "m"),
    ("keep_hi", torch.int64, "m"))
# the keys compact_state rewrites, in the kernel's order (then over and the
# hold-point flag); item axis NC = NCR + 2 Cmax, edge axis EC = ECR + 4 Cmax
COMPACT_OUTPUTS = (
    ("alive", torch.bool, "i"), ("special", torch.bool, "i"),
    ("rank", torch.int64, "i"), ("merlen", torch.int64, "i"),
    ("n_t", torch.int64, "i"), ("is_tumor", torch.bool, "i"),
    ("is_normal", torch.bool, "i"), ("comp", torch.int64, "i"),
    ("csum", torch.int64, "i4"), ("e_src", torch.int64, "e"),
    ("e_dst", torch.int64, "e"), ("e_dir", torch.int64, "e"),
    ("e_alive", torch.bool, "e"), ("e_okey", torch.int64, "e"),
    ("mer_item", torch.int64, "m"), ("keep_hi", torch.int64, "m"))
MINCOV_INPUTS = (("mer_totq", torch.int64, "mK"),
                 ("mer_tot", torch.int64, "m"),
                 ("keep_lo", torch.int64, "m"), ("keep_hi", torch.int64, "m"),
                 ("mer_item", torch.int64, "m"),
                 ("mer_flip", torch.bool, "m"))
LOWCOV_INPUTS = tuple(x for x in MINCOV_INPUTS if x[0] != "mer_tot") + (
    ("alive", torch.bool, "i"), ("special", torch.bool, "i"),
    ("csum", torch.int64, "i4"), ("merlen", torch.int64, "i"),
    ("e_src", torch.int64, "e"), ("e_dst", torch.int64, "e"),
    ("e_alive", torch.bool, "e"))
# the state keys each function reads (its kernel or its plain version,
# whose item_mincovs also reads mer_tot), for a caller that keeps its inputs
READS = {"compact_state": tuple(k for k, _, _ in COMPACT_INPUTS),
         "item_mincovs": tuple(k for k, _, _ in MINCOV_INPUTS),
         "low_cov_pass": tuple(k for k, _, _ in LOWCOV_INPUTS)
         + ("mer_tot",)}

_lib = None
_lib_lock = threading.Lock()


class LowPlan(NamedTuple):
    """A low-coverage launch: a cluster of C blocks a window, `smem` bytes
    of dynamic shared memory a block; rank r takes the mers [r mers, (r +
    1) mers), the edges [r edges, (r + 1) edges) (low_cov_pass; 0 for
    item_mincovs) and owns the items [r items, (r + 1) items)."""
    C: int
    smem: int
    mers: int
    items: int
    edges: int


def components_smem(NI: int, EE: int) -> int:
    """A components block's dynamic shared memory, as csrc/graphstate.cu's
    comp_layout: three int32 label buffers, the alive edges' int32 ends,
    two int64 and two int32 arrays for the numbering, the alive flags."""
    return 5 * _r16(4 * NI) + 2 * _r16(4 * EE) + 2 * _r16(8 * NI) + _r16(NI)


def compact_smem(NI: int, EE: int) -> int:
    """A compact_state block's: the items' flags and int32 ranks, the
    edges' (compact_layout)."""
    return _r16(NI) + _r16(4 * NI) + _r16(EE) + _r16(4 * EE)


def lowcov_smem(NI: int, low: bool) -> int:
    """An item_mincovs (low False) or low_cov_pass block's: its low flag
    (16 bytes), the items' int64 minima (two arrays for item_mincovs),
    their low flags (low_cov_pass; low_layout)."""
    return 16 + _r16(8 * NI) + (_r16(NI) if low else _r16(8 * NI))


def lowcov_range(n: int, C: int) -> int:
    """A rank's range of n elements over C ranks: n / C rounded up to
    whole warps (RANGE_ALIGN), at least one warp."""
    chunk = max(1, -(-n // C))
    return -(-chunk // RANGE_ALIGN) * RANGE_ALIGN


def _fits(name: str, smem: int, what: str) -> int:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: a window of {what} does not fit in a "
                         f"block's shared memory")
    return smem


def components_plan(NI: int, EE: int) -> int:
    """The bytes of dynamic shared memory a components block takes (88,400
    at the engine's NI 1,552, EE 3,872). Raises for NI < 1 or past the
    int32 labels, EE < 0, or a window that does not fit a block (NI past
    ~5,400 at EE 4,000)."""
    if NI < 1 or NI > MAX_ITEMS or EE < 0:
        raise ValueError(f"components takes 1 to {MAX_ITEMS} items and EE "
                         f">= 0, got NI={NI}, EE={EE}")
    return _fits("components", components_smem(NI, EE),
                 f"NI={NI} items and EE={EE} edges")


def compact_plan(NI: int, EE: int, NM: int, N: int, Cmax: int, NCR: int,
                 ECR: int) -> int:
    """The bytes of dynamic shared memory a compact_state block takes
    (27,120 at the engine's NI 1,552, EE 3,872). Raises for NI < 1, EE or
    NM < 0, NCR < 1, ECR < 0, anchors N + 2 Cmax past NI, or a window that
    does not fit a block (NI + EE past ~46,000)."""
    if NI < 1 or NI > MAX_ITEMS or EE < 0 or NM < 0:
        raise ValueError(f"compact_state: NI={NI}, EE={EE}, NM={NM}")
    if NCR < 1 or ECR < 0 or Cmax < 0 or N < 0 or N + 2 * Cmax > NI:
        raise ValueError(f"compact_state: caps NCR={NCR}, ECR={ECR} and "
                         f"anchors N={N} + 2 Cmax={2 * Cmax} in NI={NI} "
                         "items are not taken")
    return _fits("compact_state", compact_smem(NI, EE),
                 f"NI={NI} items and EE={EE} edges")


def lowcov_plan(NI: int, NM: int, K: int, low: bool, EE: int = 0,
                C: int = MAX_C) -> LowPlan:
    """The cluster an item_mincovs (low False) or low_cov_pass window takes
    and its ranges: C blocks (MAX_C on the card's path; the kernel takes
    any C in [1, MAX_C], which the tests and the emulation force), each
    rank's ranges by lowcov_range (at the engine's compact NI 528, NM
    1,536, EE 1,568 and C 4: 384 mers, 160 items, 416 edges), the shared
    memory a block (8,464 and 4,768 bytes, far under what a cluster of 4
    may take). One ordinary cluster launch, so W has no residency limit.
    Raises for NI < 1, NM or EE < 0, K outside [1, MAX_K], C outside [1,
    MAX_C] or a window whose items do not fit a block's shared memory."""
    name = "low_cov_pass" if low else "item_mincovs"
    if NI < 1 or NI > MAX_ITEMS or NM < 0 or EE < 0:
        raise ValueError(f"{name}: NI={NI}, NM={NM}, EE={EE}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name} takes K 1 to {MAX_K}, got K={K}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{name} takes a cluster of 1 to {MAX_C} blocks, "
                         f"got C={C}")
    smem = _fits(name, lowcov_smem(NI, low), f"NI={NI} items")
    return LowPlan(C, smem, lowcov_range(NM, C), lowcov_range(NI, C),
                   lowcov_range(EE, C) if low else 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> str:
    """Compile csrc/graphstate.cu for sm_90a (if not built yet); returns
    the .so path. Raises _build.BuildError with nvcc's error text."""
    return build_shared(_SRC, "libgraphstate",
                        [_nvcc()] + NVCC_FLAGS + [_SRC])


def bind(path: str) -> ctypes.CDLL:
    """Loads a build of csrc/graphstate.cu and declares its entry points."""
    lib = ctypes.CDLL(path)
    vp, ci, ll, sz = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_size_t)
    lib.components.restype = ci
    lib.components.argtypes = [vp, vp, ci, ci, ci, ll, sz, vp]
    lib.compact_state.restype = ci
    lib.compact_state.argtypes = [vp, vp] + [ci] * 8 + [sz, vp]
    lib.item_mincovs.restype = ci
    lib.item_mincovs.argtypes = [vp, vp] + [ci] * 7 + [ll, sz, vp]
    lib.low_cov_pass.restype = ci
    lib.low_cov_pass.argtypes = [vp, vp] + [ci] * 9 + [ll, ll, sz, vp]
    for f, n in (("components_smem", 2), ("compact_smem", 2),
                 ("lowcov_smem", 2)):
        getattr(lib, f).restype = sz
        getattr(lib, f).argtypes = [ci] * n
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _check(name: str, tensors: dict, spec, shape: dict) -> None:
    """Each input of `spec` in `tensors` has its axis's shape and its
    dtype (a missing optional key is None)."""
    for k, dt, ax in spec:
        t = tensors.get(k)
        if t is None:
            continue
        if tuple(t.shape) != shape[ax]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, the "
                             f"kernel takes {shape[ax]}")
        if t.dtype != dt:
            raise ValueError(f"{name} takes {k} as {dt}, got {t.dtype}")


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _launch(name: str, dev, ins, outs, call, lib=None,
            layout=None) -> None:
    """Launches `call(lib, in pointers, out pointers, stream)` on `dev` (the
    CPU tensors of an emulated build: tools/cuda_emu), `lib` by default
    `build()`'s, after holding its shared-memory layout to the wrapper's
    (`layout`: (smem_fn(lib), the wrapper's bytes)) where one is given."""
    lib = lib or _load()
    with compress.on_device(dev):  # the launch goes to the current device
        if layout is not None and layout[0](lib) != layout[1]:
            raise RuntimeError(f"{name}: the shared-memory plan disagrees "
                               "with csrc/graphstate.cu's layout")
        rc = call(lib, _ptrs(ins), _ptrs(outs), compress.stream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)


def _dict_device(name: str, st: dict, keys) -> torch.device:
    return input_device(name, *[st.get(k) for k in keys])


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def _components_card(alive, e_src, e_dst, e_alive, rank, Cmax):
    """Checks, allocates the outputs and launches the components kernel.
    Returns (comp [W, NI] int64, numcomp [W] int64, over_c [W] bool)."""
    W, NI = alive.shape
    EE = e_src.shape[1]
    ins = dict(zip((k for k, _, _ in COMPONENTS_INPUTS),
                   (alive, e_src, e_dst, e_alive, rank)))
    _check("components", ins, COMPONENTS_INPUTS,
           {"i": (W, NI), "e": (W, EE)})
    smem = components_plan(NI, EE)
    dev = alive.device
    comp = torch.empty((W, NI), dtype=torch.int64, device=dev)
    numcomp = torch.empty((W,), dtype=torch.int64, device=dev)
    over = torch.empty((W,), dtype=torch.bool, device=dev)
    if W:
        _launch("components", dev,
                [ins[k].contiguous() for k, _, _ in COMPONENTS_INPUTS],
                [comp, numcomp, over],
                lambda lib, ip, op, s: lib.components(
                    ip, op, W, NI, EE, int(Cmax), smem, s),
                layout=(lambda lib: lib.components_smem(NI, EE), smem))
    return comp, numcomp, over


def components(alive, e_src, e_dst, e_alive, rank, Cmax):
    """Component labels numbered by least map rank
    (gpu.stages.components_plain): (comp [W, NI] 0 = none, numcomp [W],
    over_c [W]). On the card one block a window (components_plan)."""
    dev = input_device("components", alive, e_src, e_dst, e_alive, rank)
    if dev.type == "cpu":
        from .stages import components_plain

        return components_plain(alive, e_src, e_dst, e_alive, rank, Cmax)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _components_card(alive, e_src, e_dst, e_alive, rank, Cmax)


# ---------------------------------------------------------------------------
# compact_state
# ---------------------------------------------------------------------------

def _compact_card(st: dict, N, NI, Cmax, NCR, ECR):
    """Checks, allocates the outputs and launches the compact_state kernel.
    Returns ({key: output} for COMPACT_OUTPUTS, "comp" only where the
    state has it; over [W]; dead_edge [W], the hold-point: an alive edge
    touches a dead item on a lane within the caps)."""
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    if st["alive"].shape[1] != NI:
        raise ValueError(f"compact_state: alive has {st['alive'].shape[1]} "
                         f"items, NI={NI}")
    _check("compact_state", st, COMPACT_INPUTS,
           {"i": (W, NI), "i4": (W, NI, 4), "e": (W, EE), "m": (W, NM)})
    smem = compact_plan(NI, EE, NM, N, Cmax, NCR, ECR)
    NC, EC = NCR + 2 * Cmax, ECR + 4 * Cmax
    dev = st["alive"].device
    shape = {"i": (W, NC), "i4": (W, NC, 4), "e": (W, EC), "m": (W, NM)}
    has_comp = "comp" in st
    outs = {k: torch.empty(shape[ax], dtype=dt, device=dev)
            for k, dt, ax in COMPACT_OUTPUTS if k != "comp" or has_comp}
    over = torch.empty((W,), dtype=torch.bool, device=dev)
    dead = torch.empty((W,), dtype=torch.bool, device=dev)
    if W:
        ins = [st[k].contiguous() if k in st else None
               for k, _, _ in COMPACT_INPUTS]
        _launch("compact_state", dev, ins,
                [outs.get(k) for k, _, _ in COMPACT_OUTPUTS] + [over, dead],
                lambda lib, ip, op, s: lib.compact_state(
                    ip, op, W, NI, EE, NM, N, Cmax, NCR, ECR, smem, s),
                layout=(lambda lib: lib.compact_smem(NI, EE), smem))
    return outs, over, dead


def compact_state(st: dict, N, NI, Cmax, NCR, ECR):
    """The post-compress survivors in the compact item/edge space
    (gpu.stages.compact_state_plain). Returns (a new dict with the keys of
    COMPACT_OUTPUTS rewritten, every other key passed through as the same
    tensor; over [W]; dead_edge [W], all False on the CPU, whose plain
    version asserts the hold-point itself). On the card three blocks a
    window (compact_plan)."""
    keys = [k for k, _, _ in COMPACT_INPUTS]
    dev = _dict_device("compact_state", st, keys)
    if dev.type == "cpu":
        from .stages import compact_state_plain

        return compact_state_plain(st, N, NI, Cmax, NCR, ECR)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    outs, over, dead = _compact_card(st, N, NI, Cmax, NCR, ECR)
    out = dict(st)
    out.update(outs)
    return out, over, dead


# ---------------------------------------------------------------------------
# item_mincovs / low_cov_pass
# ---------------------------------------------------------------------------

def _totq_rows(totq):
    """mer_totq as the kernels read it: rows of K contiguous int64, any
    stride between windows (the engine's is a slice of the build's mer
    axis: read in place); a copy only for another layout. Returns (tensor,
    window stride in elements)."""
    _, NM, K = totq.shape
    if (totq.stride(2) != 1 and K > 1) or (totq.stride(1) != K and NM > 1):
        totq = totq.contiguous()
    return totq, totq.stride(0)


def _mer_shapes(st: dict, K: int, NI: int, EE: int) -> dict:
    W, NM = st["mer_item"].shape
    return {"i": (W, NI), "i4": (W, NI, 4), "e": (W, EE), "m": (W, NM),
            "mK": (W, NM, K)}


def _mincovs_card(st: dict, K, NI, lib=None, C: int = MAX_C):
    """Checks, plans (a cluster of C blocks a window), allocates the
    outputs and launches the item_mincovs kernel of `lib` (a `bind`-loaded
    build; by default `build()`'s). Returns (mincov, mincov_qv), [W, NI]
    int64."""
    W, NM = st["mer_item"].shape
    _check("item_mincovs", st, MINCOV_INPUTS, _mer_shapes(st, K, NI, 0))
    p = lowcov_plan(NI, NM, K, False, 0, C)  # refuses before the build
    dev = st["mer_item"].device
    mincov = torch.empty((W, NI), dtype=torch.int64, device=dev)
    mincov_qv = torch.empty((W, NI), dtype=torch.int64, device=dev)
    if W:
        totq, ws = _totq_rows(st["mer_totq"])
        _launch(
            "item_mincovs", dev,
            [totq] + [st[k].contiguous() for k, _, _ in MINCOV_INPUTS[1:]],
            [mincov, mincov_qv],
            lambda lib, ip, op, s: lib.item_mincovs(
                ip, op, W, NI, NM, K, p.C, p.mers, p.items, ws, p.smem, s),
            lib, layout=(lambda lib: lib.lowcov_smem(NI, 0), p.smem))
    return mincov, mincov_qv


def item_mincovs(st: dict, K, N, NI):
    """Per-item (mincov, mincov_qv) over the donor structure
    (gpu.stages.item_mincovs_plain). On the card a cluster of MAX_C blocks
    a window."""
    dev = _dict_device("item_mincovs", st, READS["item_mincovs"])
    if dev.type == "cpu":
        from .stages import item_mincovs_plain

        return item_mincovs_plain(st, K, N, NI)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _mincovs_card(st, K, NI)


def _lowcov_card(st: dict, K, NI, low_cov_threshold, thr, lib=None,
                 C: int = MAX_C):
    """Checks, plans (a cluster of C blocks a window), allocates the
    outputs and launches the low_cov_pass kernel of `lib` (by default
    `build()`'s), `thr` [W] float32 the threshold min_cov_ratio * avgcov.
    Returns (alive [W, NI], e_alive [W, EE], low.any [W])."""
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    _check("low_cov_pass", st, LOWCOV_INPUTS, _mer_shapes(st, K, NI, EE))
    if tuple(thr.shape) != (W,) or thr.dtype != torch.float32:
        raise ValueError(f"low_cov_pass takes the threshold as [W] float32, "
                         f"got {tuple(thr.shape)} {thr.dtype}")
    p = lowcov_plan(NI, NM, K, True, EE, C)  # refuses before the build
    dev = st["alive"].device
    alive = torch.empty((W, NI), dtype=torch.bool, device=dev)
    e_alive = torch.empty((W, EE), dtype=torch.bool, device=dev)
    low_any = torch.empty((W,), dtype=torch.bool, device=dev)
    if W:
        totq, ws = _totq_rows(st["mer_totq"])
        _launch(
            "low_cov_pass", dev,
            [totq] + [st[k].contiguous() for k, _, _ in LOWCOV_INPUTS[1:]]
            + [thr.contiguous()], [alive, e_alive, low_any],
            lambda lib, ip, op, s: lib.low_cov_pass(
                ip, op, W, NI, EE, NM, K, p.C, p.mers, p.items, p.edges, ws,
                int(low_cov_threshold), p.smem, s),
            lib, layout=(lambda lib: lib.lowcov_smem(NI, 1), p.smem))
    return alive, e_alive, low_any


def low_cov_pass(st: dict, K, N, NI, low_cov_threshold, min_cov_ratio,
                 avgcov):
    """removeLowCov for every component at once
    (gpu.stages.low_cov_pass_plain): (a new dict with alive and e_alive
    rewritten, every other key passed through; low.any [W]). On the card
    a cluster of MAX_C blocks a window; the float threshold is the plain
    version's own torch expression, min_cov_ratio * avgcov, on
    the card."""
    dev = _dict_device("low_cov_pass", st, READS["low_cov_pass"])
    input_device("low_cov_pass", st["alive"], avgcov)
    if dev.type == "cpu":
        from .stages import low_cov_pass_plain

        return low_cov_pass_plain(st, K, N, NI, low_cov_threshold,
                                  min_cov_ratio, avgcov)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    alive, e_alive, low_any = _lowcov_card(st, K, NI, low_cov_threshold,
                                           min_cov_ratio * avgcov)
    out = dict(st)
    out["alive"] = alive
    out["e_alive"] = e_alive
    return out, low_any
