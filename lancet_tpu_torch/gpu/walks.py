"""The device graph engine's four sequential walks: the hand-written CUDA
kernels of `csrc/walks.cu` and the dispatch to their plain versions.

The JAX package writes each walk as a lockstep `lax.while_loop` or
`fori_loop` over all windows of a chunk; on its device one executable runs
every iteration. In PyTorch that loop would launch every op of its body
from the host, every iteration, and sync on the predicate. Here each walk
is one kernel launch per call, one warp or block per window (or per path
string). The lockstep is an artifact of batching: a window's result
depends on its own lane only, so the per-window walk is exact, overflow
flags included.

- K1 `path_cover` (JAX `tpu/pipeline.py::path_cover`, :310-500): the
  eka/BFS path cover of every component;
- K2 `seq_removal` (`tpu/stages.py::_seq_removal_pass`, :580-622): one
  whole removal pass of removeTips / removeShortLinks (the map-rank slot
  order, the neighbour lists and degrees, the sweep and the removal);
- K3 `almost_repeat_paths` (`tpu/pipeline.py::_is_almost_repeat_paths`,
  :680-717): isAlmostRepeat on the path strings;
- K4 `cycle_dfs` (`tpu/stages.py::has_cycle_seq`, :839-926): the exact
  hasCycleRec replay for the components the cycle screen flags.

K1, K2 and K4 stage each window's graph in shared memory before they walk
(`seq_removal_plan` sizes K2's block); `path_cover_plan` and
`cycle_dfs_plan` pick, from the shapes alone, whether
the staged graph fits there ("smem") or goes to a scratch buffer in device
memory ("global"), and how many of K4's walkers run at once. K3 cuts each
string's (shift, window start) plane into tiles dealt evenly over the
threads of a cluster of blocks; `almost_repeat_plan` picks the cluster,
block and tile sizes from (LP, K).

Each wrapper takes tensors on one device and raises, before any work,
when its inputs span two. On the CPU it runs the plain
version (gpu.pipeline.path_cover_plain, gpu.stages.seq_removal_pass_plain,
gpu.pipeline.almost_repeat_plain, gpu.stages.cycle_dfs_plain: the JAX
loops step for step); on a CUDA device it launches the kernel on that
device and raises
if the library cannot be built or the launch is refused. There is no
fallback from the card to the plain version. Each launch adds one to
`LAUNCHES[name]`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import torch

from .._build import build_shared
from . import count_launch, input_device
from .gotoh import NVCC_FLAGS, SMEM_LIMIT, _nvcc, _r16, _stream

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "walks.cu")
LAUNCHES = {"path_cover": 0, "seq_removal": 0, "almost_repeat_paths": 0,
            "cycle_dfs": 0}

STAGE_THREADS = 256  # K1 and K4 blocks (csrc/walks.cu kStageThreads)

_lib = None
_lib_lock = threading.Lock()


class WalkPlan(NamedTuple):
    mode: str  # "smem" or "global": where the staged graph lives
    smem: int  # bytes of dynamic shared memory a block takes
    walkers: int = 1  # K4: warps that walk components at once


def path_cover_smem(NI: int, D2: int, EE: int, Q: int, PN: int,
                    global_mode: bool) -> int:
    """A K1 block's shared memory, as csrc/walks.cu's path_cover_smem: the
    queue of 16-byte entries, the covered-edge bits, the hop buffer and,
    in the shared mode, the staged slot words (8 bytes a slot) and the
    per-item length deltas."""
    staged = NI * D2 * 8 + _r16(NI * 4)
    return (_r16(Q * 16) + _r16((EE + 31) // 32 * 4) + _r16(PN * 4)
            + (0 if global_mode else staged))


def path_cover_plan(NI: int, D2: int, EE: int, Q: int, PN: int) -> WalkPlan:
    """K1's launch: the staged graph in shared memory where it fits beside
    the queue, else in device memory. Raises for more than 32 adjacency
    slots (a lane each) or a queue of more than 65,535 entries (a queue
    entry packs its parent in 16 bits)."""
    if D2 > 32:
        raise ValueError(f"path_cover takes at most 32 adjacency slots, "
                         f"got {D2}")
    if Q > 65535:
        raise ValueError(f"path_cover takes a queue of at most 65,535 "
                         f"entries, got {Q}")
    for mode in ("smem", "global"):
        smem = path_cover_smem(NI, D2, EE, Q, PN, mode == "global")
        if smem <= SMEM_LIMIT:
            return WalkPlan(mode, smem)
    raise ValueError(f"path_cover: the queue of Q={Q} entries does not fit "
                     f"in a block's shared memory")


def cycle_dfs_smem(NI: int, D2: int, EE: int, Cmax: int, walkers: int,
                   global_mode: bool) -> int:
    """A K4 block's shared memory, as csrc/walks.cu's cycle_dfs_smem: the
    per-item counts, the active list and its length, in the shared mode
    the successor lists (4 bytes a slot), then each walker's stack (4
    bytes an item) and colours (1), which the staging first uses for the
    edges' words."""
    region = max(walkers * (_r16(NI * 4) + _r16(NI)), _r16(EE * 4))
    return (_r16(NI) + _r16((Cmax + 1) * 4)
            + (0 if global_mode else _r16(NI * D2 * 4)) + region)


def cycle_dfs_plan(NI: int, D2: int, EE: int, Cmax: int) -> WalkPlan:
    """K4's launch: the successor lists in shared memory where they fit
    with at least one walker, else in device memory; then as many walkers
    (at most Cmax and the block's 8 warps) as the rest holds. Raises for
    more than 63 adjacency slots or 2**19 items (a stack frame packs the
    slot and the count in 6 bits each and the item in 19)."""
    if D2 > 63 or NI >= 1 << 19:
        raise ValueError(f"cycle_dfs takes at most 63 adjacency slots and "
                         f"2**19 items, got D2={D2}, NI={NI}")
    most = min(Cmax, STAGE_THREADS // 32)
    for mode in ("smem", "global"):
        for walkers in range(most, 0, -1):
            smem = cycle_dfs_smem(NI, D2, EE, Cmax, walkers,
                                  mode == "global")
            if smem <= SMEM_LIMIT:
                return WalkPlan(mode, smem, walkers)
    raise ValueError(f"cycle_dfs: one walker's stack and colours for "
                     f"NI={NI} items do not fit in a block's shared memory")


REMOVAL_MAX_NI = 32767  # K2 packs an edge's two item ids in 16 bits each


def seq_removal_smem(NI: int, EE: int, U: int) -> int:
    """A K2 block's shared memory, as csrc/walks.cu's seq_removal_smem: two
    counters, the live items' keys (8 bytes an item), the edge words (4 an
    edge), the degrees and first and last alive edges (12 an item), the
    slot entries (2 a slot, at most NI) and the item flags (1 an item)."""
    return (16 + _r16(NI * 8) + _r16(EE * 4) + _r16(NI * 12)
            + _r16(min(U, NI) * 2) + _r16(NI))


def seq_removal_plan(NI: int, EE: int, U: int, D2: int) -> WalkPlan:
    """K2's launch: one block a window with its whole state in shared
    memory (17,888 bytes at the engine's NI 528, EE 1,568, U 256: under 48
    KB, so a launch sets no attribute). Raises for more than 32,767 items
    (an edge word packs its two ids in 16 bits), for D2 < 1 or U < 0, or
    for a window beyond a block's shared memory."""
    if not 1 <= NI <= REMOVAL_MAX_NI:
        raise ValueError(f"seq_removal takes 1 to {REMOVAL_MAX_NI} items, "
                         f"got NI={NI}")
    if D2 < 1 or U < 0 or EE < 0:
        raise ValueError(f"seq_removal takes D2 >= 1, U >= 0 and EE >= 0, "
                         f"got D2={D2}, U={U}, EE={EE}")
    smem = seq_removal_smem(NI, EE, U)
    if smem > SMEM_LIMIT:
        raise ValueError(f"seq_removal: a window of NI={NI} items and "
                         f"EE={EE} edges does not fit in a block's shared "
                         f"memory")
    return WalkPlan("smem", smem)


class RepeatPlan(NamedTuple):
    blocks: int  # K3: blocks a path string (a thread block cluster)
    threads: int  # a block's threads
    tile: int  # window starts of one shift a tile (a multiple of 32)
    smem: int  # bytes of dynamic shared memory a block takes


AR_PAD = 128  # K3 reads up to 99 bytes past a string's end (csrc/walks.cu)
AR_MAX_K = 63  # K3 holds a (K+1)-window's mismatch bits in two words


def almost_repeat_smem(LP: int) -> int:
    """A K3 block's shared memory, as csrc/walks.cu's almost_repeat_smem:
    the string's bytes and AR_PAD bytes past them, rounded to 16."""
    return _r16(LP + AR_PAD)


def almost_repeat_plan(LP: int, K: int) -> RepeatPlan:
    """K3's launch for strings of at most LP codes at window K+1: blocks
    of 512 threads, a cluster of 8 a string where a string can pass 512
    codes (a call holds ~2 paths a window, so one block a string leaves
    most SMs idle; of 1, 2 or 4 blocks of 1,024 and 4 or 8 of 512, 8 of
    512 took the least device time summed over the device graph path's
    calls, walks_ab.py), else one; tiles of 64 window starts, 128 for K >
    32, whose windows span a third word of mismatch bits (a longer tile
    spreads that word over more starts). Raises for K outside [0, 63] (a
    window's bits fill at most two 32-bit words) or a string beyond a
    block's shared memory."""
    if not 0 <= K <= AR_MAX_K:
        raise ValueError(f"almost_repeat_paths takes K in [0, {AR_MAX_K}], "
                         f"got {K}")
    smem = almost_repeat_smem(LP)
    if LP < 1 or smem > SMEM_LIMIT - 16:  # 16: the block's hit flag
        raise ValueError(f"almost_repeat_paths: strings of LP={LP} codes do "
                         f"not fit in a block's shared memory")
    return RepeatPlan(8 if LP > 512 else 1, 512, 64 if K <= 32 else 128,
                      smem)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> str:
    """Compile csrc/walks.cu for sm_90a (if not built yet); returns the .so
    path. Raises _build.BuildError with nvcc's error text."""
    return build_shared(_SRC, "libwalks", [_nvcc()] + NVCC_FLAGS + [_SRC])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            sz = ctypes.c_size_t
            for name, n_ptr, n_int, tail in (
                    ("path_cover", 14, 13, [sz, vp]),
                    ("seq_removal", 14, 6, [ctypes.c_longlong, sz, vp]),
                    ("almost_repeat_paths", 3, 7, [sz, vp]),
                    ("cycle_dfs", 8, 7, [sz, vp])):
                fn = getattr(lib, name)
                fn.restype = ci
                fn.argtypes = [vp] * n_ptr + [ci] * n_int + tail
            _lib = lib
        return _lib


def _i32(t):
    return t.to(torch.int32).contiguous()


def _u8(t):
    return t.to(torch.uint8).contiguous()


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)


def _device(name: str, *tensors) -> torch.device:
    """The one device of a walk's input tensors (raises when they span two,
    or for a device that is neither the CPU nor a card)."""
    dev = input_device(name, *tensors)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# K1 path_cover
# ---------------------------------------------------------------------------

def path_cover(adj, e_dst, e_dir, merlen, special, runnable, numcomp,
               reflens, *, K, N, Cmax, dfs_limit, max_indel, Q=512,
               POPMAX=1024, JMAX=8, PN=24):
    """The eka/BFS path cover walk. adj [W, NI, D2] edge ids in okey order
    (-1 empty); e_dst, e_dir [W, EE] (e_dst of the edges adj names in [0,
    NI)); merlen [W, NI]; special [W, NI]; runnable [W, Cmax]; numcomp [W];
    reflens [W, Cmax]. Returns dict sel_edges [W, JMAX, PN], sel_hops,
    sel_comp [W, JMAX], n_sel [W], fallback [W] (queue / pop / path / job
    overflows, unfinished comps). On the card one block a window stages
    its graph (path_cover_plan) and one warp walks it."""
    kw = dict(K=K, N=N, Cmax=Cmax, dfs_limit=dfs_limit, max_indel=max_indel,
              Q=Q, POPMAX=POPMAX, JMAX=JMAX, PN=PN)
    dev = _device("path_cover", adj, e_dst, e_dir, merlen, special, runnable,
                  numcomp, reflens)
    if dev.type == "cpu":
        from .pipeline import path_cover_plain

        return path_cover_plain(adj, e_dst, e_dir, merlen, special, runnable,
                                numcomp, reflens, **kw)
    W, NI, D2 = adj.shape
    EE = e_dst.shape[1]
    pl = path_cover_plan(NI, D2, EE, Q, PN)
    out = dict(
        sel_edges=torch.empty((W, JMAX, PN), dtype=torch.int32, device=dev),
        sel_hops=torch.empty((W, JMAX), dtype=torch.int32, device=dev),
        sel_comp=torch.empty((W, JMAX), dtype=torch.int32, device=dev),
        n_sel=torch.empty((W,), dtype=torch.int32, device=dev),
        fallback=torch.empty((W,), dtype=torch.uint8, device=dev))
    if W == 0:
        return _widen(out)
    ins = (_i32(adj), _i32(e_dst), _i32(e_dir), _i32(merlen), _u8(special),
           _u8(runnable), _i32(numcomp), _i32(reflens))
    stage = (torch.empty(W * (NI * D2 * 8 + _r16(NI * 4)), dtype=torch.uint8,
                         device=dev) if pl.mode == "global" else None)
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = _load().path_cover(
            *[t.data_ptr() for t in ins],
            *[out[k].data_ptr() for k in ("sel_edges", "sel_hops",
                                          "sel_comp", "n_sel", "fallback")],
            None if stage is None else stage.data_ptr(),
            W, NI, D2, EE, K, N, Cmax, min(int(dfs_limit), 2**31 - 1),
            int(max_indel), Q, POPMAX, JMAX, PN, pl.smem, _stream(dev))
    _launched("path_cover", rc)
    return _widen(out)


def _widen(out):
    res = {k: v.to(torch.int64) for k, v in out.items() if k != "fallback"}
    res["fallback"] = out["fallback"].to(torch.bool)
    return res


# ---------------------------------------------------------------------------
# K2 seq_removal
# ---------------------------------------------------------------------------

REMOVAL_KEYS = ("alive", "special", "rank", "e_src", "e_dst", "e_alive")


def _removal_inputs(st, cond):
    """K2's inputs as the kernel reads them: the state's tensors as they are
    (bool, int64; contiguous), then mincov, thr and guard for the links
    mode (None for the tips mode). No copy where the engine's state already
    has these dtypes."""
    def i64(t):
        return t.to(torch.int64).contiguous()

    def b(t):
        return t.to(torch.bool).contiguous()

    ins = (b(st["alive"]), b(st["special"]), i64(st["rank"]), i64(cond[1]),
           i64(st["e_src"]), i64(st["e_dst"]), b(st["e_alive"]))
    links = ((i64(cond[3]), i64(cond[4]), b(cond[5])) if cond[0] == "links"
             else (None, None, None))
    return ins, links


def seq_removal(st, cond, U, D2):
    """One removal pass (see gpu.stages._seq_removal_pass) on the state
    dict `st` (alive, special, rank, e_src, e_dst, e_alive are read); cond
    = ("tips", merlen, max_tip) or ("links", merlen, max_link, mincov, thr,
    guard). Returns (alive [W, NI], e_alive [W, EE], removed_any [W], over
    [W]), all bool. On the card one launch: one block a window stages the
    window (seq_removal_plan), sorts its slots, sweeps and removes."""
    links = cond[0] == "links"
    dev = _device("seq_removal", *[st[k] for k in REMOVAL_KEYS], cond[1],
                  *(cond[3:6] if links else ()))
    if dev.type == "cpu":
        from .stages import seq_removal_pass_plain

        out, removed_any, over = seq_removal_pass_plain(st, cond, U, D2)
        return out["alive"], out["e_alive"], removed_any, over
    W, NI = st["alive"].shape
    EE = st["e_src"].shape[1]
    pl = seq_removal_plan(NI, EE, U, D2)
    outs = (torch.empty((W, NI), dtype=torch.bool, device=dev),
            torch.empty((W, EE), dtype=torch.bool, device=dev),
            torch.empty((W,), dtype=torch.bool, device=dev),
            torch.empty((W,), dtype=torch.bool, device=dev))
    if W == 0:
        return outs
    ins, extra = _removal_inputs(st, cond)
    max_len = max(min(int(cond[2]), 2**63 - 1), -2**63)
    with torch.cuda.device(dev):
        rc = _load().seq_removal(
            *[t.data_ptr() for t in ins],
            *[None if t is None else t.data_ptr() for t in extra],
            *[t.data_ptr() for t in outs], W, NI, EE, U, D2, int(links),
            max_len, pl.smem, _stream(dev))
    _launched("seq_removal", rc)
    return outs


# ---------------------------------------------------------------------------
# K3 almost_repeat_paths
# ---------------------------------------------------------------------------

def almost_repeat(seq, lens, K, max_mismatch):
    """isAlmostRepeat of each path string. seq [W, J, LP] base codes; lens
    [W, J]. Returns [W, J] bool. On the card a cluster of blocks a string
    deals its (shift, window start) tiles over its threads
    (almost_repeat_plan)."""
    dev = _device("almost_repeat_paths", seq, lens)
    if dev.type == "cpu":
        from .pipeline import almost_repeat_plain

        return almost_repeat_plain(seq, lens, K, max_mismatch)
    W, J, LP = seq.shape
    out = torch.empty((W, J), dtype=torch.uint8, device=dev)
    if W * J == 0:
        return out.to(torch.bool)
    pl = almost_repeat_plan(LP, int(K))
    # a budget past any window's K+1 mismatches is one past K+1
    mm = max(min(int(max_mismatch), AR_MAX_K + 1), -1)
    s8 = _u8(seq)
    ln = _i32(lens)
    with torch.cuda.device(dev):
        rc = _load().almost_repeat_paths(s8.data_ptr(), ln.data_ptr(),
                                         out.data_ptr(), W * J, LP, int(K),
                                         mm, pl.blocks, pl.threads, pl.tile,
                                         pl.smem, _stream(dev))
    _launched("almost_repeat_paths", rc)
    return out.to(torch.bool)


# ---------------------------------------------------------------------------
# K4 cycle_dfs
# ---------------------------------------------------------------------------

def cycle_dfs(adj, e_dst, e_dir, alive, special, N, Cmax, lane_mask):
    """The hasCycleRec replay of each flagged component. adj [W, NI, D2]
    edge ids in okey order; e_dst, e_dir [W, EE]; alive, special [W, NI];
    lane_mask [W, Cmax] (None = every component). On the card one block a
    window stages the window's successor lists (cycle_dfs_plan) and its
    warps walk the active components, each with its own stack and colours
    in shared memory. Returns [W, Cmax] bool."""
    dev = _device("cycle_dfs", adj, e_dst, e_dir, alive, special, lane_mask)
    if dev.type == "cpu":
        from .stages import cycle_dfs_plain

        return cycle_dfs_plain(adj, e_dst, e_dir, alive, special, N, Cmax,
                               lane_mask)
    W, NI, D2 = adj.shape
    EE = e_dst.shape[1]
    flags = torch.empty((W, Cmax), dtype=torch.uint8, device=dev)
    if W == 0:
        return flags.to(torch.bool)
    pl = cycle_dfs_plan(NI, D2, EE, Cmax)
    if lane_mask is None:
        lane_mask = torch.ones((W, Cmax), dtype=torch.bool, device=dev)
    ins = (_i32(adj), _i32(e_dst), _i32(e_dir), _u8(alive), _u8(special),
           _u8(lane_mask))
    ent = (torch.empty((W, NI * D2), dtype=torch.int32, device=dev)
           if pl.mode == "global" else None)
    with torch.cuda.device(dev):
        rc = _load().cycle_dfs(*[t.data_ptr() for t in ins],
                               flags.data_ptr(),
                               None if ent is None else ent.data_ptr(), W,
                               NI, D2, EE, N, Cmax, pl.walkers, pl.smem,
                               _stream(dev))
    _launched("cycle_dfs", rc)
    return flags.to(torch.bool)
