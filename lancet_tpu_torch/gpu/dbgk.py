"""The device graph engine's build of one k attempt: the hand-written CUDA
kernels of `csrc/dbg.cu` and the dispatch to their plain versions.

The JAX package compiles `tpu/dbg.py::build_k` (:120) into one device
program a k and shape bucket; PyTorch would launch the ~1,000 ops of its
plain version (gpu/dbg.py::build_k_plain) one by one from the host. Here a
build is four stages whose launches `build_plan` fixes from the shapes and
k alone (`BuildPlan.launches`), with no host sync:

- `mer_instances`: the instance table (sort keys, payload, quality bits,
  mate keys); two launches of (window, tile) blocks, the reads a tile
  touches staged as bit strings in shared memory: each tile's count of
  valid instances, then the table, each tile's stream positions from the
  earlier tiles' counts;
- `window_sort`: the stable sort along the window axis of up to four int64
  key words, an LSD radix sort of 8-bit digits over the bits each word's
  declared range takes (`SortPlan`); one launch where a tile of SORT_TILE
  records holds a window, else (window, tile) blocks, two launches a pass;
  six sorts a build;
- `node_tables`: three launches of (window, tile) blocks: each tile of
  BUILD_TILE sorted instances' group starts and head, then the groups;
  after the creation order's window_sort, (window, NODE_SLOTS slots)
  blocks, a warp a node;
- `edge_tables`: five launches: the pair keys; each tile's canonical
  group starts and head, then the groups and rows (after the pair sort);
  the time order, the reference projection and the mate candidates in
  tiles (after the time and mate sorts); the adjacency, a block a window,
  and the flags (after the adjacency sort).

Each wrapper takes tensors on one device and raises, before any work, when
they span two. On the CPU it runs the plain version (gpu.dbg's
mer_instances_plain, window_sort_plain, node_tables_plain,
edge_tables_plain, build_k_plain); on a CUDA device it launches the kernels
on that device and raises, before the launch, for shapes the kernels do
not take (build_plan, sort_plan), and after it if the library cannot be
built or a launch is refused. There is no fallback from the card to the
plain version. Each kernel launch adds one to `LAUNCHES[name]`.

`build_k` on the card composes the four stages' card paths as build_k_plain
composes their plain versions; each allocates its outputs and one int64
workspace for its intermediate tables (the sorts' records and digit
counts, the tiles' counts, the sorted payload and pair keys, the group
and pair tables): at most 37 aten ops a build, none of which syncs the
host.
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
    __file__))), "csrc", "dbg.cu")
LAUNCHES = {"mer_instances": 0, "window_sort": 0, "node_tables": 0,
            "edge_tables": 0}
MAX_K = 63  # three words of 31 bases; quality bits 0..K-1 of one int64
MAX_SORT_KEYS = 4  # the mate sort's NW + 1 at k 63
MAX_SORT_N = 1 << 30  # uint32 record indices and digit counts
SORT_ITEMS = 8  # records a thread (csrc kSortItems)
SORT_TILE = 4096  # records a sort block: 512 threads
INST_THREADS = 256  # csrc kInstThreads
INST_TILE = 2048  # read instances a mer_instances block
REF_TILE = 512  # reference offsets a mer_instances block
TILE_THREADS = 256  # csrc kTileThreads
BUILD_TILE = 2048  # positions a node_tables or edge_tables tile (at most
                   # csrc kTileMax; a multiple of TILE_THREADS)
NODE_SLOTS = 32  # creation slots a node_tables_order block (a multiple of
                 # its 8 warps, up to 256)
NODE_LAUNCHES = (2, 1)  # node_tables' launches by phase (dbg_nodes)
EDGE_LAUNCHES = (1, 2, 1, 1)  # edge_tables' (dbg_edges)
I32_MAX = 2**31 - 1
BIG = 1 << 30
SENT = 1 << 62  # an invalid instance's mer words (gpu/dbg.py SENT)
GENERIC = (-(1 << 63), 64, None)  # a key word of any int64 value

# the kernels' inputs, in the order of csrc/dbg.cu's dbg_instances
INST_INPUTS = (("bases", torch.uint8), ("quals", torch.uint8),
               ("rlen", torch.int32), ("rsample", torch.int8),
               ("rstrand", torch.int8), ("rfrag", torch.int32),
               ("rorder", torch.int8), ("raw", torch.uint8),
               ("rawlen", torch.int32), ("seq_off", torch.int32),
               ("seq_len", torch.int32), ("window_ok", torch.bool))
# node_tables' pointers (dbg_nodes) and edge_tables' (dbg_edges)
NODE_PTRS = ("keys", "pay", "qok", "perm", "order", "rawlen", "totalreadbp",
             "node_key", "gstart", "over_n", "mers", "counts", "mq", "totq",
             "mincov_qv", "exists", "alive", "low", "in_index", "is_tumor",
             "is_normal", "n_nodes", "avgcov", "rawlen_dev", "nid", "spay",
             "tcnt")
EDGE_PTRS = ("pay", "nid", "counts", "in_index", "over_n", "rawlen_dev",
             "window_ok", "fkeys", "fperm", "ckey", "ct", "cperm", "sct",
             "de", "et_key", "eorder", "over_e", "ak_key", "aperm",
             "n_edges", "edge_src", "edge_dst", "edge_dir", "edge_exists",
             "adj", "deg", "nid_proj", "proj_isF", "refcov", "mate_cand",
             "fallback", "ecnt", "nself", "flags")
# node_tables' outputs beside the workspace: (key, dtype, shape), the
# shapes over W, N, K, NW, I
NODE_OUTPUTS = (("counts", torch.int64, "WN4"), ("mq", torch.int32, "WNK4"),
                ("totq", torch.int64, "WNK"), ("mincov_qv", torch.int64, "WN"),
                ("exists", torch.bool, "WN"), ("alive", torch.bool, "WN"),
                ("low", torch.bool, "WN"), ("in_index", torch.bool, "WN"),
                ("is_tumor", torch.bool, "WN"),
                ("is_normal", torch.bool, "WN"),
                ("n_nodes", torch.int64, "W"), ("avgcov", torch.float32, "W"),
                ("rawlen_dev", torch.int64, "W"))
EDGE_OUTPUTS = (("n_edges", torch.int64, "W"),
                ("edge_src", torch.int64, "WE"),
                ("edge_dst", torch.int64, "WE"),
                ("edge_dir", torch.int64, "WE"),
                ("edge_exists", torch.bool, "WE"),
                ("adj", torch.int64, "WND"), ("deg", torch.int64, "WN"),
                ("nid_proj", torch.int64, "WMraw"),
                ("proj_isF", torch.bool, "WMraw"),
                ("refcov", torch.int64, "WLraw4"),
                ("mate_cand", torch.bool, "W"), ("fallback", torch.bool, "W"))

_lib = None
_lib_lock = threading.Lock()


class SortPlan(NamedTuple):
    """One window_sort: NK key words of n elements a window, word c in the
    range words[c] = (lo, bits, sent): lo + [0, 2^bits) or the sentinel
    sent (None: none), which maps to 2^bits (GENERIC: any int64). The
    record's key takes B bits (the words' bits and sentinel bits side by
    side), NL 32-bit lanes (1, 2, 4, 6 or 8); P passes of 8 bits; T tiles
    of `tile` records a window (csrc SortPlan): one launch where T is 1,
    else 2P (the records, then a scatter each pass and a count each pass
    past the first); smem: a scatter or tile block's bytes; scratch: the
    int64 elements of device memory past one tile (two record buffers and
    the digit counts, W windows)."""
    NK: int
    n: int
    words: tuple
    B: int
    NL: int
    P: int
    tile: int
    T: int
    smem: int
    scratch: int
    launches: int


def sort_smem(NL: int, tile: int) -> int:
    """A scatter or tile block's dynamic shared memory: each warp's 256
    digit counts, the window's digit offsets and the tile's digit starts,
    and the tile's records, NL key lanes and an index (csrc
    sort_smem_layout)."""
    return 4 * (tile // (32 * SORT_ITEMS) * 256 + 512 + tile * (NL + 1))


def sort_plan(NK: int, n: int, W: int, words=None) -> SortPlan:
    """The launches of a sort of n elements a window by NK key words, each
    in its declared range (words; None: GENERIC). Raises for NK outside [1,
    MAX_SORT_KEYS], n < 1 or past MAX_SORT_N, W < 1, or a word whose range
    is not 1-64 bits (1-63 with a sentinel)."""
    if not 1 <= NK <= MAX_SORT_KEYS or not 1 <= n <= MAX_SORT_N or W < 1:
        raise ValueError(f"window_sort takes 1 to {MAX_SORT_KEYS} key words "
                         f"and 1 to {MAX_SORT_N} elements in W >= 1 windows, "
                         f"got NK={NK}, n={n}, W={W}")
    words = tuple(words) if words is not None else (GENERIC,) * NK
    if len(words) != NK or any(
            not 1 <= b <= (63 if s is not None else 64)
            for _, b, s in words):
        raise ValueError(f"window_sort: {NK} key words of 1-64 bits (63 "
                         f"with a sentinel) expected, got {words}")
    B = sum(b + (s is not None) for _, b, s in words)
    q = (B + 31) // 32
    NL = q if q <= 2 else 4 if q <= 4 else 6 if q <= 6 else 8
    P = (B + 7) // 8
    tile = SORT_TILE
    T = (n + tile - 1) // tile
    scratch = 0 if T == 1 else (2 * W * (NL + 1) * n + W * T * 256 + 1) // 2
    return SortPlan(NK, n, words, B, NL, P, tile, T, sort_smem(NL, tile),
                    scratch, 1 if T == 1 else 2 * P)


def seq_words(n: int) -> int:
    """32-bit words of a sequence of n bases staged by mer_instances: the
    2-bit codes and two masks, each with two words of padding (csrc
    seq_layout)."""
    nc = (n + 31) // 32
    return 4 * nc + 6


def inst_smem(L: int, Lraw: int, M: int, TQ: int) -> int:
    """A mer_instances block's dynamic shared memory: a read tile's TQ
    stream positions and the reads it touches (each its strings and 5
    int fields), or the window's reference (csrc inst_plan)."""
    return 4 * max(TQ + ((TQ - 1) // M + 2) * (seq_words(L) + 5),
                   seq_words(Lraw))


def edge_smem(N: int, E: int) -> int:
    """An edge_tables_adj block's dynamic shared memory: the first slot
    and count of each source [N + 64], then the sources in the adjacency
    sort's order [E]; int32 (csrc edge_layout). The other node_tables and
    edge_tables kernels take static shared memory only."""
    return 2 * _r16(4 * (N + 64)) + _r16(4 * E)


class BuildPlan(NamedTuple):
    """The shapes of one build and its launches: M read mers a read, Mraw
    ref mers, I = R*M + 3*Mraw instances, IP = R*M mate instances, PU =
    R*M + Mraw pairs a window; mer_instances' TR read tiles of TQ
    instances and TF reference tiles of RQ offsets a window, inst_smem
    bytes a block; node_tables' TN tiles of T sorted instances and NB
    blocks of SL creation slots a window, edge_tables' TPu tiles of T pair
    keys, TE of T rows, TJ of T reference positions and TM of T mate keys
    a window, edge_smem bytes an adjacency block; the six sorts {name:
    SortPlan}; the kernels' launches {name: count}."""
    K: int
    W: int
    R: int
    L: int
    Lraw: int
    N: int
    E: int
    D: int
    NW: int
    M: int
    Mraw: int
    I: int
    IP: int
    PU: int
    TQ: int
    TR: int
    RQ: int
    TF: int
    inst_smem: int
    T: int
    SL: int
    TN: int
    NB: int
    TPu: int
    TE: int
    TJ: int
    TM: int
    edge_smem: int
    sorts: dict
    launches: dict


def _span(lo: int, hi: int, sent) -> tuple:
    """A key word of the values lo..hi and the sentinel sent (> hi)."""
    return (lo, max(1, (hi - lo).bit_length()), sent)


def sort_words(K: int, N: int, I: int) -> dict:
    """Each build sort's key words and their ranges, from K, N and the
    instances I a window (gpu/dbg.py's tables): a mer word of nb bases
    2 nb bits or SENT; the node keys a group's first time (-1 to 2I - 1)
    or BIG; the pair keys ((src NODECAP + dst) 4 + dir, src and dst -1 to
    N - 1) or I32_MAX; the edge times 0 to 2I + 1 or BIG; the sources 0 to
    N + 63 or I32_MAX; the mate keys the mer words and a fragment (any
    int32)."""
    NW = (K + 30) // 31
    mer = tuple((0, 2 * nb, SENT)
                for nb in [K - 31 * (NW - 1)] + [31] * (NW - 1))
    NODECAP = N + 64
    return {"inst": mer,
            "node": (_span(-1, 2 * I, BIG),),
            "pair": (_span(-4 * NODECAP - 4,
                           ((N - 1) * NODECAP + N - 1) * 4 + 3, I32_MAX),),
            "time": (_span(0, 2 * I + 1, BIG),),
            "adj": (_span(0, N + 63, I32_MAX),),
            "mate": mer + ((-(1 << 31), 32, None),)}


def build_plan(K: int, W: int, R: int, L: int, Lraw: int, N: int, E: int,
               D: int) -> BuildPlan:
    """The launches of a build at these shapes. Raises ValueError, before
    any launch, for what the engine never passes: K outside [1, 63], W, R,
    N, E or D below 1, L or Lraw below K, instances whose times reach BIG,
    pair keys past int32 (N past ~23,000), an adjacency block's shared
    memory past the card's (8 (N + 64) + 4 E bytes: E past ~54,000 at N
    1,536), reads or a reference past a mer_instances block's (L past
    ~220,000 or Lraw past ~460,000 bases), or BUILD_TILE and NODE_SLOTS
    outside what the kernels take."""
    if not 1 <= K <= MAX_K:
        raise ValueError(f"build_k takes K 1 to {MAX_K}, got K={K}")
    if min(W, R, N, E, D) < 1 or L < K or Lraw < K:
        raise ValueError(f"build_k takes W, R, N, E, D >= 1 and L, Lraw >= "
                         f"K, got W={W}, R={R}, N={N}, E={E}, D={D}, L={L}, "
                         f"Lraw={Lraw}, K={K}")
    NW = (K + 30) // 31
    M, Mraw = L - K + 1, Lraw - K + 1
    IP = R * M
    I, PU = IP + 3 * Mraw, IP + Mraw
    if 2 * I + 2 >= BIG:
        raise ValueError(f"build_k: {I} instances a window reach the time "
                         "sentinel")
    NODECAP = N + 64
    if ((NODECAP - 1) * NODECAP + NODECAP - 1) * 4 + 3 >= I32_MAX:
        raise ValueError(f"build_k: N={N} takes pair keys past int32")
    if edge_smem(N, E) > SMEM_LIMIT:
        raise ValueError(f"build_k: N={N} and E={E} do not fit an "
                         "adjacency block's shared memory")
    T, SL = BUILD_TILE, NODE_SLOTS
    if (not TILE_THREADS <= T <= 8 * TILE_THREADS or T % TILE_THREADS
            or not 8 <= SL <= 256 or SL % 8):
        raise ValueError(f"build_k: tiles of {T} positions and blocks of "
                         f"{SL} slots: the kernels take multiples of "
                         f"{TILE_THREADS} up to {8 * TILE_THREADS} and of 8 "
                         "up to 256")
    TQ, RQ = INST_TILE, REF_TILE
    smem = inst_smem(L, Lraw, M, TQ)
    if smem > SMEM_LIMIT:
        raise ValueError(f"build_k: reads of L={L} or a reference of "
                         f"Lraw={Lraw} do not fit a mer_instances block")
    words = sort_words(K, N, I)
    sizes = {"inst": I, "node": N, "pair": PU, "time": 2 * E, "adj": E,
             "mate": IP}
    sorts = {k: sort_plan(len(words[k]), n, W, words[k])
             for k, n in sizes.items()}
    launches = {"mer_instances": 2,
                "window_sort": sum(s.launches for s in sorts.values()),
                "node_tables": sum(NODE_LAUNCHES),
                "edge_tables": sum(EDGE_LAUNCHES)}
    return BuildPlan(K, W, R, L, Lraw, N, E, D, NW, M, Mraw, I, IP, PU, TQ,
                     -(-IP // TQ), RQ, -(-Mraw // RQ), smem, T, SL,
                     -(-I // T), -(-N // SL), -(-PU // T), -(-E // T),
                     -(-Lraw // T), -(-IP // T), edge_smem(N, E),
                     sorts, launches)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> str:
    """Compile csrc/dbg.cu for sm_90a (if not built yet); returns the .so
    path. Raises _build.BuildError with nvcc's error text."""
    return build_shared(_SRC, "libdbg", [_nvcc()] + NVCC_FLAGS + [_SRC])


def bind(path: str) -> ctypes.CDLL:
    """Loads a build of csrc/dbg.cu and declares its entry points."""
    lib = ctypes.CDLL(path)
    vp, ci, ll, sz = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_size_t)
    lib.dbg_instances.restype = ci
    lib.dbg_instances.argtypes = [vp, vp, vp] + [ci] * 8 + [sz, vp]
    lib.dbg_inst_plan.restype = ci
    lib.dbg_inst_plan.argtypes = [ci] * 6 + [vp]
    lib.dbg_sort.restype = ci
    lib.dbg_sort.argtypes = ([vp, ll, ll] + [ci] * 3 + [vp] * 4 + [ci]
                             + [vp] * 3)
    lib.dbg_sort_plan.restype = ci
    lib.dbg_sort_plan.argtypes = [ci, vp, vp, ci, ci, ci, vp]
    lib.dbg_nodes.restype = ci
    lib.dbg_nodes.argtypes = [ci, vp] + [ci] * 4 + [ll, ctypes.c_float, ci,
                                                   ci, vp]
    lib.dbg_edges.restype = ci
    lib.dbg_edges.argtypes = [ci, vp] + [ci] * 9 + [sz, vp]
    lib.dbg_table_plan.restype = ci
    lib.dbg_table_plan.argtypes = [ci] * 8 + [vp]
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


class _Card(NamedTuple):
    """A launch target: the library, the stream handle (a ctypes void
    pointer) and the device of the tensors."""
    lib: ctypes.CDLL
    stream: object
    dev: torch.device


def _card(dev: torch.device) -> _Card:
    with torch.cuda.device(dev):
        return _Card(_load(), _stream(dev), dev)


def _ptrs(ps) -> ctypes.Array:
    return (ctypes.c_void_p * len(ps))(*ps)


def _ok(name: str, rc: int, n: int = 1) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    for _ in range(n):
        count_launch(LAUNCHES, name)


def _check_plan(name: str, got, want) -> None:
    if tuple(got) != tuple(want):
        raise RuntimeError(f"{name}: the launch plan {tuple(want)} disagrees "
                           f"with csrc/dbg.cu's {tuple(got)}")


# ---------------------------------------------------------------------------
# launches on pointers (the card's tensors, or a build's workspace)
# ---------------------------------------------------------------------------

def _launch_instances(c: _Card, p: BuildPlan, ins, outs, cnt: int,
                      min_qual_call) -> None:
    """mer_instances' two launches on INST_INPUTS' tensors `ins` into the
    pointers outs (keys, pay, qok, fkeys); cnt: W * TR int32 of scratch."""
    got = (ctypes.c_longlong * 3)()
    rc = c.lib.dbg_inst_plan(p.R, p.L, p.Lraw, p.K, p.TQ, p.RQ, got)
    if rc:
        raise RuntimeError(f"mer_instances: plan refused: CUDA error {rc}")
    _check_plan("mer_instances", got, (p.TR, p.TF, p.inst_smem))
    _ok("mer_instances", c.lib.dbg_instances(
        _ptrs([t.data_ptr() for t in ins]), _ptrs(outs), cnt, p.W, p.R,
        p.L, p.Lraw, p.K, int(min_qual_call), p.TQ, p.RQ, p.inst_smem,
        c.stream), 2)


def _launch_sort(c: _Card, sp: SortPlan, W: int, keys: int, ps: int,
                 wst: int, perm: int, scratch: int | None) -> None:
    """window_sort of keys (key c of window w, element i at keys + 8 (c ps
    + w wst + i)) into perm [W, n] int64; scratch: sp.scratch int64
    elements (None when 0)."""
    NK = sp.NK
    lo = (ctypes.c_longlong * NK)(*[w[0] for w in sp.words])
    bits = (ctypes.c_int * NK)(*[w[1] for w in sp.words])
    sent = (ctypes.c_longlong * NK)(*[w[2] or 0 for w in sp.words])
    has = (ctypes.c_int * NK)(*[w[2] is not None for w in sp.words])
    got = (ctypes.c_longlong * 6)()
    rc = c.lib.dbg_sort_plan(NK, bits, has, W, sp.n, sp.tile, got)
    if rc:
        raise RuntimeError(f"window_sort: plan refused: CUDA error {rc}")
    _check_plan("window_sort", got, (sp.NL, sp.P, sp.T, sp.launches,
                                     sp.scratch, sp.smem))
    _ok("window_sort", c.lib.dbg_sort(
        keys, ps, wst, NK, W, sp.n, lo, bits, sent, has, sp.tile, perm,
        scratch, c.stream), sp.launches)


def _check_tables(c: _Card, p: BuildPlan, name: str) -> None:
    """The library's node_tables and edge_tables blocks against the
    plan's."""
    got = (ctypes.c_longlong * 7)()
    rc = c.lib.dbg_table_plan(p.R, p.L, p.Lraw, p.K, p.N, p.E, p.T, p.SL,
                              got)
    if rc:
        raise RuntimeError(f"{name}: plan refused: CUDA error {rc}")
    _check_plan(name, got, (p.TN, p.NB, p.TPu, p.TE, p.TJ, p.TM,
                            p.edge_smem))


def _launch_nodes(c: _Card, p: BuildPlan, ptrs: dict, phase: int,
                  low_cov_threshold, min_cov_ratio) -> None:
    """node_tables' phase 0 (two launches) or 1 (one)."""
    if phase == 0:
        _check_tables(c, p, "node_tables")
    _ok("node_tables", c.lib.dbg_nodes(
        phase, _ptrs([ptrs.get(k) for k in NODE_PTRS]), p.W, p.I, p.N, p.K,
        int(low_cov_threshold), float(min_cov_ratio), p.T, p.SL, c.stream),
        NODE_LAUNCHES[phase])


def _launch_edges(c: _Card, p: BuildPlan, ptrs: dict, phase: int) -> None:
    """edge_tables' phase 0-3 (EDGE_LAUNCHES[phase] launches)."""
    if phase == 0:
        _check_tables(c, p, "edge_tables")
    _ok("edge_tables", c.lib.dbg_edges(
        phase, _ptrs([ptrs.get(k) for k in EDGE_PTRS]), p.W, p.R, p.L,
        p.Lraw, p.K, p.N, p.E, p.D, p.T, p.edge_smem, c.stream),
        EDGE_LAUNCHES[phase])


def _empty(shapes: dict, spec, dev) -> dict:
    return {k: torch.empty(shapes[ax], dtype=dt, device=dev)
            for k, dt, ax in spec}


def _shapes(p: BuildPlan) -> dict:
    W, N = p.W, p.N
    return {"W": (W,), "WN": (W, N), "WN4": (W, N, 4), "WNK": (W, N, p.K),
            "WNK4": (W, N, p.K, 4), "WE": (W, p.E), "WND": (W, N, p.D),
            "WMraw": (W, p.Mraw), "WLraw4": (W, p.Lraw, 4)}


def _inputs(name: str, tensors) -> list:
    """INST_INPUTS' tensors in their kernel dtypes (no copy where they
    have them already)."""
    out = []
    for (k, dt), t in zip(INST_INPUTS, tensors):
        if t.dim() == 0:
            raise ValueError(f"{name}: {k} must have the window axis")
        out.append(t.to(dt).contiguous())
    return out


def _plan_of(name: str, K, ins, N, E, D, Lraw) -> BuildPlan:
    bases, raw = ins[0], ins[7]
    if bases.dim() != 3 or raw.dim() != 2 or raw.shape[1] != Lraw:
        raise ValueError(f"{name}: bases [W, R, L] and raw [W, Lraw={Lraw}] "
                         f"expected, got {tuple(bases.shape)} and "
                         f"{tuple(raw.shape)}")
    W, R, L = bases.shape
    return build_plan(K, W, R, L, Lraw, N, E, D)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def _build_card(c: _Card, p: BuildPlan, ins, min_qual_call,
                low_cov_threshold, min_cov_ratio, keep=None) -> dict:
    """The launches of a build on `c` (ins: INST_INPUTS' tensors and
    totalreadbp last; p.launches): the four stages' card paths composed
    as build_k_plain composes their plain versions. Returns its dict;
    `keep`, where a dict, gets each sort's keys [NK, W, n] (copies)."""
    from .dbg import BUILD_KEYS

    W, sp = p.W, p.sorts["inst"]
    perm = torch.empty((W, p.I), dtype=torch.int64, device=c.dev)
    # the instance sort's scratch, and before it the instance tiles' counts
    ws = torch.empty(max(sp.scratch, (W * p.TR + 1) // 2),
                     dtype=torch.int64, device=c.dev)
    inst = _instances_card(c, p, ins[:12], min_qual_call, ws.data_ptr())
    _launch_sort(c, sp, W, inst["keys"].data_ptr(), W * p.I, p.I,
                 perm.data_ptr(), ws.data_ptr() if sp.scratch else None)
    nodes = _nodes_card(c, p, inst, perm, ins[8], ins[12],
                        low_cov_threshold, min_cov_ratio, keep)
    out = {**nodes, **_edges_card(c, p, inst, nodes, ins[11], keep)}
    if keep is not None:
        keep["inst"] = inst["keys"].clone()
        keep["mate"] = inst["fkeys"].clone()
    return {k: out[k] for k in BUILD_KEYS}


def build_k(K, bases, quals, rlen, rsample, rstrand, rfrag, rorder, raw,
            rawlen, seq_off, seq_len, totalreadbp, window_ok, *, N, E, D,
            Lraw, min_qual_call, low_cov_threshold, min_cov_ratio):
    """One k attempt's graph build (gpu.dbg.build_k_plain's arguments and
    outputs): the plain version on the CPU, the launches of the four
    kernels on a card (build_plan's BuildPlan.launches), with no host
    sync."""
    args = (bases, quals, rlen, rsample, rstrand, rfrag, rorder, raw,
            rawlen, seq_off, seq_len, window_ok)
    dev = input_device("build_k", *args, totalreadbp)
    if dev.type == "cpu":
        from .dbg import build_k_plain

        return build_k_plain(K, bases, quals, rlen, rsample, rstrand, rfrag,
                             rorder, raw, rawlen, seq_off, seq_len,
                             totalreadbp, window_ok, N=N, E=E, D=D,
                             Lraw=Lraw, min_qual_call=min_qual_call,
                             low_cov_threshold=low_cov_threshold,
                             min_cov_ratio=min_cov_ratio)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p = _plan_of("build_k", K, args, N, E, D, Lraw)
    ins = _inputs("build_k", args) + [totalreadbp.to(torch.int32)
                                      .contiguous()]
    return _build_card(_card(dev), p, ins, min_qual_call, low_cov_threshold,
                       min_cov_ratio)


def build_sort_keys(K, bases, quals, rlen, rsample, rstrand, rfrag, rorder,
                    raw, rawlen, seq_off, seq_len, totalreadbp, window_ok,
                    *, N, E, D, Lraw, min_qual_call, low_cov_threshold,
                    min_cov_ratio) -> dict:
    """The six sorts of one card build_k call, for timing each alone:
    {name: (keys [NK, W, n] int64, its SortPlan)}, the keys copied from a
    build on the card."""
    args = (bases, quals, rlen, rsample, rstrand, rfrag, rorder, raw,
            rawlen, seq_off, seq_len, window_ok)
    dev = input_device("build_sort_keys", *args, totalreadbp)
    if dev.type != "cuda":
        raise ValueError(f"build_sort_keys runs on a card, got {dev}")
    p = _plan_of("build_sort_keys", K, args, N, E, D, Lraw)
    ins = _inputs("build_sort_keys", args) + [totalreadbp.to(torch.int32)
                                              .contiguous()]
    keep: dict = {}
    _build_card(_card(dev), p, ins, min_qual_call, low_cov_threshold,
                min_cov_ratio, keep)
    return {k: (keep[k], sp) for k, sp in p.sorts.items()}


# ---------------------------------------------------------------------------
# the four stages, each on its own (the kernels held against their plain
# versions)
# ---------------------------------------------------------------------------

def _instances_card(c: _Card, p: BuildPlan, ins, min_qual_call,
                    cnt: int) -> dict:
    W = p.W
    out = {"keys": torch.empty((p.NW, W, p.I), dtype=torch.int64,
                               device=c.dev),
           "pay": torch.empty((W, p.I), dtype=torch.int64, device=c.dev),
           "qok": torch.empty((W, p.I), dtype=torch.int64, device=c.dev),
           "fkeys": torch.empty((p.NW + 1, W, p.IP), dtype=torch.int64,
                                device=c.dev)}
    _launch_instances(c, p, ins, [out[k].data_ptr() for k in
                                  ("keys", "pay", "qok", "fkeys")], cnt,
                      min_qual_call)
    return out


def mer_instances(K, bases, quals, rlen, rsample, rstrand, rfrag, rorder,
                  raw, rawlen, seq_off, seq_len, window_ok, *, Lraw,
                  min_qual_call):
    """The instance table (gpu.dbg.mer_instances_plain). On the card two
    launches of (window, tile) blocks (build_plan's TR read tiles and TF
    reference tiles)."""
    args = (bases, quals, rlen, rsample, rstrand, rfrag, rorder, raw,
            rawlen, seq_off, seq_len, window_ok)
    dev = input_device("mer_instances", *args)
    if dev.type == "cpu":
        from .dbg import mer_instances_plain

        return mer_instances_plain(K, *args, Lraw=Lraw,
                                   min_qual_call=min_qual_call)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p = _plan_of("mer_instances", K, args, 1, 1, 1, Lraw)
    cnt = torch.empty((p.W, p.TR), dtype=torch.int32, device=dev)
    return _instances_card(_card(dev), p, _inputs("mer_instances", args),
                           min_qual_call, cnt.data_ptr())


def _sort_card(c: _Card, keys, sp: SortPlan) -> torch.Tensor:
    NK, W, n = keys.shape
    keys = keys.contiguous()
    perm = torch.empty((W, n), dtype=torch.int64, device=c.dev)
    scratch = (torch.empty(sp.scratch, dtype=torch.int64, device=c.dev)
               if sp.scratch else None)
    _launch_sort(c, sp, W, keys.data_ptr(), W * n, n, perm.data_ptr(),
                 None if scratch is None else scratch.data_ptr())
    return perm


def window_sort(keys, plan: SortPlan | None = None):
    """The stable sort permutation [W, n] int64 of keys [NK, W, n] int64
    along the window axis, key 0 the most significant
    (gpu.dbg.window_sort_plain). On the card sort_plan's launches: with
    `plan`, the key words in its declared ranges (a build's sorts,
    BuildPlan.sorts); without, any int64 values (GENERIC words)."""
    dev = input_device("window_sort", keys)
    if dev.type == "cpu":
        from .dbg import window_sort_plain

        return window_sort_plain(keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if keys.dim() != 3 or keys.dtype != torch.int64:
        raise ValueError(f"window_sort takes keys [NK, W, n] int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    NK, W, n = keys.shape
    sp = plan or sort_plan(NK, n, W)
    if (sp.NK, sp.n) != (NK, n):
        raise ValueError(f"window_sort: a plan for NK={sp.NK}, n={sp.n} "
                         f"given keys of NK={NK}, n={n}")
    return _sort_card(_card(dev), keys, sp)


def _inst_plan(name, K, inst, N, E, D, R, L, Lraw) -> BuildPlan:
    W, I = inst["pay"].shape
    p = build_plan(K, W, R, L, Lraw, N, E, D)
    shapes = {"keys": (p.NW, W, p.I), "pay": (W, p.I), "qok": (W, p.I),
              "fkeys": (p.NW + 1, W, p.IP)}
    for k, s in shapes.items():
        t = inst[k]
        if tuple(t.shape) != s or t.dtype != torch.int64:
            raise ValueError(f"{name}: {k} {tuple(t.shape)} {t.dtype}, the "
                             f"kernel takes {s} int64")
    return p


def _carve(ws_sizes) -> tuple[int, dict]:
    """A workspace's int64 elements and each table's offset in them, from
    (name, int64 elements) in order."""
    at, off = {}, 0
    for k, n in ws_sizes:
        at[k] = off
        off += n
    return off, at


def _nodes_card(c: _Card, p: BuildPlan, inst, perm, rawlen, totalreadbp,
                low_cov_threshold, min_cov_ratio, keep=None) -> dict:
    W, N = p.W, p.N
    node = p.sorts["node"]
    # int32 tables take half an int64 an element, rounded up
    total, at = _carve((("node_key", W * N), ("order", W * N),
                        ("spay", W * p.I), ("gstart", (W * (N + 1) + 1) // 2),
                        ("tcnt", (3 * W * p.TN + 1) // 2),
                        ("scratch", node.scratch)))
    ws = torch.empty(total, dtype=torch.int64, device=c.dev)
    base = ws.data_ptr()
    mers = torch.empty((p.NW, W, N), dtype=torch.int64, device=c.dev)
    out = _empty(_shapes(p), NODE_OUTPUTS, c.dev)
    out["nid"] = torch.empty((W, p.I), dtype=torch.int64, device=c.dev)
    out["over_n"] = torch.empty((W,), dtype=torch.bool, device=c.dev)
    inst = {k: inst[k].contiguous() for k in ("keys", "pay", "qok")}
    rawlen = rawlen.to(torch.int32).contiguous()
    totalreadbp = totalreadbp.to(torch.int32).contiguous()
    perm = perm.contiguous()
    ptrs = {k: t.data_ptr() for k, t in out.items()}
    ptrs.update({k: t.data_ptr() for k, t in inst.items()})
    ptrs.update(perm=perm.data_ptr(), rawlen=rawlen.data_ptr(),
                totalreadbp=totalreadbp.data_ptr(), mers=mers.data_ptr())
    ptrs.update({k: base + 8 * at[k] for k in ("node_key", "order", "spay",
                                                "gstart", "tcnt")})
    scratch = base + 8 * at["scratch"] if node.scratch else None
    _launch_nodes(c, p, ptrs, 0, low_cov_threshold, min_cov_ratio)
    _launch_sort(c, node, W, ptrs["node_key"], W * N, N, ptrs["order"],
                 scratch)
    _launch_nodes(c, p, ptrs, 1, low_cov_threshold, min_cov_ratio)
    out["mers_w"] = mers.unbind(0)
    if keep is not None:
        keep["node"] = ws[:W * N].view(1, W, N).clone()
    return out


def node_tables(K, inst, perm, rawlen, totalreadbp, *, N, R, L, Lraw,
                low_cov_threshold, min_cov_ratio):
    """The node tables in creation order and each instance's node
    (gpu.dbg.node_tables_plain; R, L and Lraw give the instance table's
    shape). On the card three launches, a window_sort before the last."""
    dev = input_device("node_tables", inst["keys"], inst["pay"],
                       inst["qok"], perm, rawlen, totalreadbp)
    if dev.type == "cpu":
        from .dbg import node_tables_plain

        return node_tables_plain(K, inst, perm, rawlen, totalreadbp, N=N,
                                 low_cov_threshold=low_cov_threshold,
                                 min_cov_ratio=min_cov_ratio)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p = _inst_plan("node_tables", K, inst, N, 1, 1, R, L, Lraw)
    if tuple(perm.shape) != (p.W, p.I) or perm.dtype != torch.int64:
        raise ValueError(f"node_tables: perm {tuple(perm.shape)} "
                         f"{perm.dtype}, the kernel takes {(p.W, p.I)} int64")
    return _nodes_card(_card(dev), p, inst, perm, rawlen, totalreadbp,
                       low_cov_threshold, min_cov_ratio)


def _edges_card(c: _Card, p: BuildPlan, inst, nodes, window_ok,
                keep=None) -> dict:
    W, E, PU, IP = p.W, p.E, p.PU, p.IP
    sp = {k: v for k, v in p.sorts.items() if k in ("pair", "time", "adj",
                                                     "mate")}
    # int32 tables take half an int64 an element, rounded up
    sizes = (("ckey", W * PU), ("ct", W * PU), ("cperm", W * PU),
             ("sct", W * PU), ("ecnt", (3 * W * p.TPu + 1) // 2),
             ("nself", (W * p.TPu + 1) // 2), ("flags", (W + 1) // 2),
             ("de", 2 * W * E), ("et_key", 2 * W * E),
             ("eorder", 2 * W * E), ("ak_key", W * E), ("aperm", W * E),
             ("over_e", (W + 7) // 8), ("fperm", W * IP),
             ("scratch", max(s.scratch for s in sp.values())))
    total, at = _carve(sizes)
    ws = torch.empty(total, dtype=torch.int64, device=c.dev)
    ptrs = {k: ws.data_ptr() + 8 * off for k, off in at.items()}
    out = _empty(_shapes(p), EDGE_OUTPUTS, c.dev)
    ptrs.update({k: t.data_ptr() for k, t in out.items()})
    held = {"pay": inst["pay"].contiguous(),
            "fkeys": inst["fkeys"].contiguous(),
            "window_ok": window_ok.contiguous()}
    held.update({k: nodes[k].contiguous() for k in
                 ("nid", "counts", "in_index", "over_n", "rawlen_dev")})
    ptrs.update({k: t.data_ptr() for k, t in held.items()})
    scratch = ptrs["scratch"] if sizes[-1][1] else None
    _launch_edges(c, p, ptrs, 0)
    _launch_sort(c, sp["pair"], W, ptrs["ckey"], W * PU, PU, ptrs["cperm"],
                 scratch)
    _launch_edges(c, p, ptrs, 1)
    _launch_sort(c, sp["time"], W, ptrs["et_key"], 2 * W * E, 2 * E,
                 ptrs["eorder"], scratch)
    _launch_sort(c, sp["mate"], W, ptrs["fkeys"], W * IP, IP, ptrs["fperm"],
                 scratch)
    _launch_edges(c, p, ptrs, 2)
    _launch_sort(c, sp["adj"], W, ptrs["ak_key"], W * E, E, ptrs["aperm"],
                 scratch)
    _launch_edges(c, p, ptrs, 3)
    if keep is not None:
        for k, name, n in (("pair", "ckey", PU), ("time", "et_key", 2 * E),
                           ("adj", "ak_key", E)):
            keep[k] = ws[at[name]:at[name] + W * n].view(1, W, n).clone()
    return out


EDGE_NODE_KEYS = ("nid", "counts", "in_index", "over_n", "rawlen_dev")


def edge_tables(K, inst, nodes, window_ok, *, R, L, N, E, D, Lraw):
    """The edge tables, the reference projection, the mate candidates and
    the fallback flags (gpu.dbg.edge_tables_plain). On the card five
    launches in four phases, with a window_sort before each of the last
    three (two before the third)."""
    dev = input_device("edge_tables", inst["pay"], inst["fkeys"], window_ok,
                       *[nodes[k] for k in EDGE_NODE_KEYS])
    if dev.type == "cpu":
        from .dbg import edge_tables_plain

        return edge_tables_plain(K, inst, nodes, window_ok, R=R, L=L, N=N,
                                 E=E, D=D, Lraw=Lraw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p = _inst_plan("edge_tables", K, inst, N, E, D, R, L, Lraw)
    want = {"nid": ((p.W, p.I), torch.int64),
            "counts": ((p.W, N, 4), torch.int64),
            "in_index": ((p.W, N), torch.bool),
            "over_n": ((p.W,), torch.bool),
            "rawlen_dev": ((p.W,), torch.int64)}
    for k, (s, dt) in want.items():
        if tuple(nodes[k].shape) != s or nodes[k].dtype != dt:
            raise ValueError(f"edge_tables: {k} {tuple(nodes[k].shape)} "
                             f"{nodes[k].dtype}, the kernel takes {s} {dt}")
    if tuple(window_ok.shape) != (p.W,) or window_ok.dtype != torch.bool:
        raise ValueError("edge_tables takes window_ok [W] bool")
    return _edges_card(_card(dev), p, inst, nodes, window_ok)
