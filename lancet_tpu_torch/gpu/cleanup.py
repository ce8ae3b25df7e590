"""The device graph engine's cleanup loops: the hand-written CUDA kernels of
`csrc/cleanup.cu` and the dispatch to their plain versions.

The JAX package runs its cleanup (`tpu/pipeline.py::cleanup`, :103) inside
its jitted attempt: the removeTips fixpoint a `lax.while_loop` (:167) with
`compress_round` under `lax.cond` on a hit (:160) and the verify pass under
`lax.cond` (:182), the removeShortLinks stage and its STR guard under
`lax.cond` on `pre.any()` (:205, :227). PyTorch would read a bool from the
card every round and for the stage's gate, and assemble the guard's strings
in a K-step loop of torch ops. Here each is one kernel launch per call,
with no host read:

- `tip_fixpoint`: one cooperative launch, a thread block cluster of C
  blocks a window (`tip_fixpoint_plan`), the JAX loop over the whole batch
  (a grid barrier a round, the batch's hit from a per-round flag row), the
  removal and compression passes being the bodies of `seq_removal`
  (csrc/removal_body.cuh, on the cluster's rank 0) and `compress_round`
  (csrc/compress_body.cuh, on the whole cluster); the tips mode runs the
  fixpoint and its verify pass, the links mode the links pass and its
  compress under the gate;
- `short_link_strings`: one block a window, the short-link candidates,
  their gate (`pre_any`, a candidate the links pass may kill) and the
  guard's candidate strings.

Each wrapper takes tensors on one device and raises, before any work, when
its inputs span two. On the CPU it runs the plain version
(gpu.pipeline.tip_fixpoint_plain, short_link_stage_plain: the JAX loops
with host bools, op for op); on a CUDA device it launches the kernel on
that device and raises, before the launch, for shapes, dtypes or grids the
kernel does not take (`tip_fixpoint_plan`, `strings_plan`), and after it if
the library cannot be built or the launch is refused. There is no fallback
from the card to the plain version. The kernels read the engine's int64
and bool tensors as they are (no copy). Each launch adds one to
`LAUNCHES[name]`.

The kernels assume what the two bodies assume of the engine's states
(alive edges' endpoints in [0, NI) and directions in [0, 3], alive okeys
>= 0; gpu.compress, gpu.walks): other data gives wrong answers, never a
fault.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .._build import build_shared
from . import compress, count_launch, input_device, walks
from .gotoh import NVCC_FLAGS, SMEM_LIMIT, _nvcc, _r16, _stream

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "cleanup.cu")
LAUNCHES = {"tip_fixpoint": 0, "short_link_strings": 0}

# the state keys tip_fixpoint rewrites, in the kernel's order (those of
# compress_round), and the ones it reads beside them
STATE = compress.OUTPUTS
STATE_KEYS = compress.OUTPUT_KEYS
READS = STATE_KEYS + ("special", "rank")
# short_link_strings' inputs from the state, in the kernel's order (then
# mincov and thr after e_alive, mer_base last)
STRINGS_INPUTS = (("alive", torch.bool, "i"), ("special", torch.bool, "i"),
                  ("merlen", torch.int64, "i"), ("e_src", torch.int64, "e"),
                  ("e_alive", torch.bool, "e"),
                  ("mer_item", torch.int64, "m"),
                  ("mer_flip", torch.bool, "m"),
                  ("mer_pos", torch.int64, "m"),
                  ("keep_lo", torch.int64, "m"),
                  ("keep_hi", torch.int64, "m"),
                  ("mer_base", torch.int64, "mK"))
STRINGS_READS = tuple(k for k, _, _ in STRINGS_INPUTS)

SL_ITEMS = 64  # strings a window (gpu/pipeline.py _SL_ITEMS)
SL_CAP = 64  # bases a string (_SL_CAP)
SL_MAX_K = 64  # a packed write key holds j < 64 in its top bits
SL_MAX_MERS = 1 << 24  # and the mer index in 24 bits

_lib = None
_lib_lock = threading.Lock()
_plans: dict = {}  # (library, device, W, NI, EE, NM, U, D2) -> Plan


def tip_fixpoint_smem(NI: int, EE: int, NM: int, U: int, C: int) -> int:
    """A tip_fixpoint block's dynamic shared memory in a cluster of C
    blocks, as csrc/cleanup.cu's fixpoint_smem: the larger of the
    compression body's (gpu.compress.cluster_smem) and, behind the body's
    head, the removal body's (gpu.walks.seq_removal_smem), one region the
    phases reuse."""
    return max(compress.cluster_smem(NI, EE, NM, C),
               compress.HEAD + walks.seq_removal_smem(NI, EE, U))


def tip_fixpoint_plan(W: int, NI: int, EE: int, NM: int, U: int, D2: int,
                      clusters: dict) -> compress.Plan:
    """The cluster a window takes and its blocks' shared memory (C 3 and
    170,448 bytes at the engine's W 32, NI 528, EE 1,568, NM 1,536, U 256 on
    an H100 SXM; C 4 at a mesh shard's 8-16). Raises for what either body
    refuses (gpu.compress.compress_plan, gpu.walks.seq_removal_plan), for a
    window beyond a block's shared memory, and for more windows than a
    cooperative launch can hold resident at once: `clusters` {C: the most
    clusters of C the card holds at once} (one block an SM, the
    compression body's __launch_bounds__(512, 1) letting it take an SM's
    registers: 30 clusters of 4, 39 of 3, 66 of 2, 132 of 1 on an H100
    SXM); C is the largest of gpu.compress.CLUSTER_SIZES that holds W."""
    walks.seq_removal_plan(NI, EE, U, D2)
    if NI < 1 or 2 * NI >= compress.MAX_STATES or EE < 0 or NM < 0:
        raise ValueError(f"tip_fixpoint: NI={NI}, EE={EE}, NM={NM}")
    def smem_of(C):
        return tip_fixpoint_smem(NI, EE, NM, U, C)

    fits = compress.fitting_sizes(
        smem_of, f"tip_fixpoint: a window of NI={NI} items, EE={EE} edges "
        f"and NM={NM} mers")
    plan = compress.resident_cluster(W, fits, smem_of, clusters)
    if plan is None:
        most = max(clusters.get(C, 0) for C in fits)
        raise ValueError(f"tip_fixpoint: {W} windows cannot be resident at "
                         f"once for a cooperative launch (at most {most} "
                         f"clusters)")
    return plan


def plan_for(W: int, NI: int, EE: int, NM: int, U: int, D2: int, dev,
             lib=None, clusters: dict | None = None) -> compress.Plan:
    """The Plan tip_fixpoint's launch on `dev` takes: tip_fixpoint_plan
    over the card's clusters (gpu.compress.max_clusters of `lib`'s
    tip_fixpoint_max_clusters, by default `build()`'s), its smem checked
    against the build's own layout; cached by (lib, device, shape).
    `clusters` forces {C: clusters held at once} (not cached)."""
    lib = lib or _load()
    key = (lib, dev.index, W, NI, EE, NM, U, D2)
    cache = clusters is None
    if cache and key in _plans:
        return _plans[key]
    with compress.on_device(dev):
        if cache:
            clusters = compress.max_clusters(
                lib.tip_fixpoint_max_clusters,
                lambda C: tip_fixpoint_smem(NI, EE, NM, U, C))
        plan = tip_fixpoint_plan(W, NI, EE, NM, U, D2, clusters)
        if lib.tip_fixpoint_smem(NI, EE, NM, U, plan.C) != plan.smem:
            raise RuntimeError("tip_fixpoint_smem disagrees with "
                               "csrc/cleanup.cu's layout")
    if cache:
        _plans[key] = plan
    return plan


def strings_smem(NI: int) -> int:
    """A short_link_strings block's dynamic shared memory, as
    csrc/cleanup.cu's strings_smem: the initial degrees and the slots
    (int32 an item), the [SL_ITEMS, SL_CAP] cells' packed write keys."""
    return 2 * _r16(4 * NI) + SL_ITEMS * SL_CAP * 4


def strings_plan(NI: int, NM: int, K: int) -> int:
    """The bytes of dynamic shared memory a short_link_strings block takes
    (20,608 at the engine's NI 528). Raises for K outside [1, SL_MAX_K] or
    more than SL_MAX_MERS mers (a cell's write key packs j << 24 | mer),
    NI < 1, or a window beyond a block's shared memory."""
    if not 1 <= K <= SL_MAX_K:
        raise ValueError(f"short_link_strings takes K 1 to {SL_MAX_K}, got "
                         f"K={K}")
    if NI < 1 or not 0 <= NM <= SL_MAX_MERS:
        raise ValueError(f"short_link_strings takes 1 or more items and at "
                         f"most {SL_MAX_MERS} mers, got NI={NI}, NM={NM}")
    smem = strings_smem(NI)
    if smem > SMEM_LIMIT:
        raise ValueError(f"short_link_strings: a window of NI={NI} items "
                         f"does not fit in a block's shared memory")
    return smem


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> str:
    """Compile csrc/cleanup.cu for sm_90a (if not built yet); returns the
    .so path. Raises _build.BuildError with nvcc's error text."""
    return build_shared(_SRC, "libcleanup", [_nvcc()] + NVCC_FLAGS + [_SRC])


def bind(path: str) -> ctypes.CDLL:
    """Loads a build of csrc/cleanup.cu and declares its entry points."""
    lib = ctypes.CDLL(path)
    vp, ci, ll, sz = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_size_t)
    lib.tip_fixpoint.restype = ci
    lib.tip_fixpoint.argtypes = ([vp] * 11 + [ci] * 9 + [ll] * 4
                                 + [sz, vp])
    lib.tip_fixpoint_max_clusters.restype = ci
    lib.tip_fixpoint_max_clusters.argtypes = [ci, sz]
    lib.short_link_strings.restype = ci
    lib.short_link_strings.argtypes = [vp, vp] + [ci] * 5 + [ll, sz, vp]
    lib.tip_fixpoint_smem.restype = sz
    lib.tip_fixpoint_smem.argtypes = [ci] * 5
    lib.short_link_strings_smem.restype = sz
    lib.short_link_strings_smem.argtypes = [ci]
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _check(name: str, t, shape: tuple, dtype) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: an input of shape {tuple(t.shape)}, the "
                         f"kernel takes {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: an input of {t.dtype}, the kernel takes "
                         f"{dtype}")


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _i64(name: str, v) -> int:
    v = int(v)
    if not -2**63 <= v < 2**63:
        raise ValueError(f"{name}: {v} is outside int64")
    return v


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)


# ---------------------------------------------------------------------------
# tip_fixpoint
# ---------------------------------------------------------------------------

def _cond_tensors(cond) -> tuple:
    """The links mode's (mincov, thr, guard, gate); the tips mode's Nones."""
    if cond[0] == "tips":
        return None, None, None, None
    if cond[0] != "links":
        raise ValueError(f"tip_fixpoint: mode {cond[0]!r} is neither 'tips' "
                         "nor 'links'")
    return tuple(cond[2:6])


def tip_fixpoint(st: dict, cond, K: int, N: int, NI: int, U: int, D2: int,
                 rounds: int, fallback, Dcap: int = 64,
                 inplace: bool = False, lib=None, clusters: dict | None = None):
    """The cleanup's removal loop (gpu.pipeline.tip_fixpoint_plain) on the
    state dict `st`: cond ("tips", max_tip) runs the removeTips fixpoint
    of at most `rounds` rounds and its verify pass, cond ("links",
    max_link, mincov [W, NI], thr [W], guard [W, NI], gate [W]) the links
    pass and its compress where any gate lane is set. fallback [W] bool is
    the flag so far. Returns (a new dict with the keys of STATE rewritten,
    every other key passed through as the same tensor; fallback | the
    loop's flags). On the card one cooperative launch, a cluster of
    tip_fixpoint_plan's C blocks a window; `inplace` writes the rewritten
    keys into st's own tensors (contiguous; the caller gives them up), so
    that a links call whose gate is closed copies nothing. The plain
    version returns new tensors either way. `lib` and `clusters` (a build
    of csrc/cleanup.cu and {C: clusters held at once}; by default the
    card's) take the card path on CPU tensors for an emulated build
    (tools/cuda_emu)."""
    extra = _cond_tensors(cond)
    dev = input_device("tip_fixpoint", *[st[k] for k in READS], fallback,
                       *extra)
    if dev.type == "cpu" and lib is None:
        from .pipeline import tip_fixpoint_plain

        return tip_fixpoint_plain(st, cond, K, N, NI, U, D2, rounds,
                                  fallback, Dcap)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    shape = {"i": (W, NI), "i4": (W, NI, 4), "e": (W, EE), "m": (W, NM)}
    for k, dt, ax in STATE + (("special", torch.bool, "i"),
                              ("rank", torch.int64, "i")):
        _check(f"tip_fixpoint ({k})", st[k], shape[ax], dt)
    _check("tip_fixpoint (fallback)", fallback, (W,), torch.bool)
    links = cond[0] == "links"
    if links:
        for t, shp, dt in zip(extra, ((W, NI), (W,), (W, NI), (W,)),
                              (torch.int64, torch.int64, torch.bool,
                               torch.bool)):
            _check("tip_fixpoint (links)", t, shp, dt)
    if int(rounds) < 0:
        raise ValueError(f"tip_fixpoint: rounds={rounds} is below 0")
    walks.seq_removal_plan(NI, EE, U, D2)
    if inplace and not all(st[k].is_contiguous() for k in STATE_KEYS):
        raise ValueError("tip_fixpoint: an in-place call takes contiguous "
                         "state tensors")
    outs = ([st[k] for k in STATE_KEYS] if inplace else
            [torch.empty(shape[ax], dtype=dt, device=dev)
             for _, dt, ax in STATE])
    fb_out = torch.empty((W,), dtype=torch.bool, device=dev)
    out = dict(st)
    out.update(zip(STATE_KEYS, outs))
    if W == 0:
        return out, fb_out
    hits = (None if links else
            torch.empty((max(int(rounds), 1) * W,), dtype=torch.uint8,
                        device=dev))
    ins = [st[k].contiguous() for k in STATE_KEYS]
    side = [st["special"].contiguous(), st["rank"].contiguous()] + [
        None if t is None else t.contiguous() for t in extra]
    max_len = _i64("tip_fixpoint max_len", cond[1])
    lib = lib or _load()
    plan = plan_for(W, NI, EE, NM, U, D2, dev, lib, clusters)
    with compress.on_device(dev):  # the launch goes to the current device
        rc = lib.tip_fixpoint(
            _ptrs(ins), _ptrs(outs), *[None if t is None else t.data_ptr()
                                       for t in side],
            fallback.contiguous().data_ptr(), fb_out.data_ptr(),
            None if hits is None else hits.data_ptr(), W, plan.C, NI, EE,
            NM, U, D2, int(links), int(rounds), max_len, int(N), int(K),
            int(Dcap), plan.smem, compress.stream(dev))
    _launched("tip_fixpoint", rc)
    return out, fb_out


# ---------------------------------------------------------------------------
# short_link_strings
# ---------------------------------------------------------------------------

def short_link_strings(st: dict, mincov, thr, K: int, NI: int,
                       max_link: int) -> dict:
    """The short-link stage's candidates and the STR guard's strings
    (gpu.pipeline.short_link_stage_plain) of the state dict `st`, mincov
    [W, NI] and thr [W] int64: dict seqs [W, SL_ITEMS, SL_CAP], lens and
    slot_item [W, SL_ITEMS] (int64) and pre_any [W] bool. On the card one
    block a window (strings_plan)."""
    dev = input_device("short_link_strings",
                       *[st[k] for k in STRINGS_READS], mincov, thr)
    if dev.type == "cpu":
        from .pipeline import short_link_stage_plain

        return short_link_stage_plain(st, mincov, thr, K, NI, max_link)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    shape = {"i": (W, NI), "e": (W, EE), "m": (W, NM), "mK": (W, NM, K)}
    for k, dt, ax in STRINGS_INPUTS:
        _check(f"short_link_strings ({k})", st[k], shape[ax], dt)
    _check("short_link_strings (mincov)", mincov, (W, NI), torch.int64)
    _check("short_link_strings (thr)", thr, (W,), torch.int64)
    smem = strings_plan(NI, NM, int(K))
    out = dict(
        seqs=torch.empty((W, SL_ITEMS, SL_CAP), dtype=torch.int64,
                         device=dev),
        lens=torch.empty((W, SL_ITEMS), dtype=torch.int64, device=dev),
        slot_item=torch.empty((W, SL_ITEMS), dtype=torch.int64, device=dev),
        pre_any=torch.empty((W,), dtype=torch.bool, device=dev))
    if W == 0:
        return out
    ins = [st[k].contiguous() for k in STRINGS_READS[:5]] + [
        mincov.contiguous(), thr.contiguous()] + [
        st[k].contiguous() for k in STRINGS_READS[5:]]
    with torch.cuda.device(dev):
        lib = _load()
        if lib.short_link_strings_smem(NI) != smem:
            raise RuntimeError("short_link_strings_smem disagrees with "
                               "csrc/cleanup.cu's layout")
        rc = lib.short_link_strings(
            _ptrs(ins), _ptrs(list(out.values())), W, NI, EE, NM, int(K),
            _i64("short_link_strings max_link", max_link), smem,
            _stream(dev))
    _launched("short_link_strings", rc)
    return out
