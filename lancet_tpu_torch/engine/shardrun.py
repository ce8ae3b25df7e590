"""Native batched shard runner glue (lancet_native.cc lsr_*).

One native call per genomic group of windows does the host work in C++
threads: BAM fetch with shared per-chunk caches, active-region triage, the
read-extraction filter chain, the k-loop with the graph, cleanup and the
path cover. Reads never enter Python. Python's role per group: the
device-batched Gotoh alignment of the jobs that need DP (gpu.align_batch),
one lsr_finish call that replays the transcript state machine natively,
and Variant construction from the packed records.

Host and device overlap: while the device aligns group g's DP batch, the
next group's native stage runs in a worker thread (ctypes releases the GIL
during the C++ call). Each group's DP batch is split on the pair axis over
a mesh (parallel.mesh; one entry, the run's device, when the caller gives
none).

LANCET_TPU_GATES (set and non-empty, as in the JAX package) turns on the
eager repeat-gate sweep of every window and k on the device before the
native stage; by default the native k-loop scans lazily, which costs less
on the native runner.
"""

from __future__ import annotations

import concurrent.futures as _cf
import ctypes
import os
import struct
import threading
import time

import numpy as np

from ..gpu.align_batch import batch_align_wait
from ..parallel.mesh import Mesh, mesh_batch_align_async
from .variant import Variant

STATUS_OK = 0

# bytes of BAM the native plane caches per fetch chunk
CACHE_SPAN = 8 << 20
# a run is cut into about GROUPS host/device pipeline groups, each
# spanning at least MIN_GROUP_SPAN bp
GROUPS = 8
MIN_GROUP_SPAN = 64 << 10

_LSR = None
_LSR_LOCK = threading.Lock()


def _lib():
    """The native library with the lsr_* entry points bound. Raises
    native.NativeUnavailable when the plane cannot be built."""
    global _LSR
    with _LSR_LOCK:
        if _LSR is None:
            from ..native import load_library

            lib = load_library()
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.lsr_run.restype = ctypes.c_void_p
            lib.lsr_run.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, i32p, i32p,
                i64p, i64p, u8p, i64p, u8p, u8p, ctypes.c_int, i64p, f64p,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, u8p]
            lib.lsr_x_info.argtypes = [ctypes.c_void_p, u8p, i64p, i64p]
            lib.lsr_x_data.restype = u8p
            lib.lsr_x_data.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.lsx_scan_batch.restype = ctypes.c_void_p
            lib.lsx_scan_batch.argtypes = [
                ctypes.c_int64, i64p, u8p, i64p, u8p, i64p, u8p, i64p,
                i32p, i32p, i64p, u8p, i64p, i32p, i64p]
            lib.lsx_varbuf_size.restype = ctypes.c_long
            lib.lsx_varbuf_size.argtypes = [ctypes.c_void_p]
            lib.lsx_varbuf.restype = u8p
            lib.lsx_varbuf.argtypes = [ctypes.c_void_p]
            lib.lsx_free.argtypes = [ctypes.c_void_p]
            lib.lsr_status.restype = ctypes.c_int
            lib.lsr_status.argtypes = [ctypes.c_void_p]
            lib.lsr_n_jobs.restype = ctypes.c_long
            lib.lsr_n_jobs.argtypes = [ctypes.c_void_p]
            lib.lsr_job_meta.argtypes = [ctypes.c_void_p, i64p]
            lib.lsr_job_path.restype = ctypes.c_char_p
            lib.lsr_job_path.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.lsr_win_out.argtypes = [ctypes.c_void_p, u8p, i64p, f64p,
                                        i64p]
            lib.lsr_finish.argtypes = [ctypes.c_void_p, u8p, i64p, u8p, i64p]
            lib.lsr_varbuf_size.restype = ctypes.c_long
            lib.lsr_varbuf_size.argtypes = [ctypes.c_void_p]
            lib.lsr_varbuf.restype = u8p
            lib.lsr_varbuf.argtypes = [ctypes.c_void_p]
            lib.lsr_free.argtypes = [ctypes.c_void_p]
            lib.lsr_stage_ns.argtypes = [i64p]
            lib.lsr_stage_reset.argtypes = []
            _LSR = lib
        return _LSR


def _blob(strings: list[bytes]):
    off = np.zeros(len(strings) + 1, np.int64)
    np.cumsum([len(s) for s in strings], out=off[1:])
    blob = (np.frombuffer(b"".join(strings), np.uint8) if strings
            else np.zeros(0, np.uint8))
    return blob, off


class ShardRunResult:
    """Per-run native results: per-window Variant lists (constructor-arg
    records), fallback window indices, counters, and trace rows."""

    def __init__(self, variants_by_window, fallback, counters, times, reads):
        self.variants_by_window = variants_by_window
        self.fallback = fallback  # set of window indices needing replay
        self.counters = counters  # np [n_windows, 9]
        self.times = times
        self.reads = reads


def _parse_varbuf(buf: bytes, windows, map_win, variants_by_window,
                  lr_mode: bool = False) -> None:
    """Unpack the packed Var wire format (v1: 128-byte header with HP
    triples + BX set lengths; lancet_native.cc pack_vars) into Variant
    objects."""
    off = 0
    nv = len(buf)
    while off < nv:
        (win, pos, code, prev_ref, prev_alt, _ver, kmer, l_ref, l_alt,
         l_str) = struct.unpack_from("<iqBBBBiiii", buf, off)
        cov = struct.unpack_from("<8i", buf, off + 32)
        hp = struct.unpack_from("<12i", buf, off + 64)
        bl = struct.unpack_from("<4i", buf, off + 112)
        off += 128
        ref = buf[off : off + l_ref].decode("latin-1")
        off += l_ref
        alt = buf[off : off + l_alt].decode("latin-1")
        off += l_alt
        str_tag = buf[off : off + l_str].decode("latin-1")
        off += l_str
        bxs = []
        for q in range(4):
            bxs.append(buf[off : off + bl[q]].decode("latin-1"))
            off += bl[q]
        gwin = map_win(win)
        v = Variant(
            lr_mode=lr_mode, chrom=windows[gwin].chrom, pos=pos,
            ref_str=ref, alt_str=alt,
            rcn=(cov[0], cov[1]), rct=(cov[2], cov[3]),
            acn=(cov[4], cov[5]), act=(cov[6], cov[7]),
            hprn=hp[0:3], hprt=hp[3:6], hpan=hp[6:9], hpat=hp[9:12],
            prev_bp_ref=chr(prev_ref), prev_bp_alt=chr(prev_alt),
            kmer=kmer, str_tag=str_tag, code=chr(code),
            bx_ref_n=bxs[0], bx_ref_t=bxs[1], bx_alt_n=bxs[2],
            bx_alt_t=bxs[3])
        variants_by_window.setdefault(gwin, []).append(v)


_STAGES = ("t_c_fetch", "t_c_triage", "t_c_extract", "t_c_kloop",
           "t_c_scan", "t_c_build", "t_c_refcov", "t_c_mat", "t_c_stages",
           "t_c_eka", "t_c_comps", "t_c_refends", "t_c_cyc", "t_c_compress",
           "t_c_cleanup", "t_c_findrep")


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def _p(a, t):
    return a.ctypes.data_as(t) if a.size else ctypes.cast(None, t)


def _lsr_run(lib, cfg, windows, idxs, inputs, export=False, gates=None):
    """lsr_run on the windows `idxs` (GIL released during the C++ call).
    `inputs` is _run_inputs' tuple; `gates`, if given, is (gate verdicts
    [n, n_k] uint8, exact repeats at max_k [n] uint8) over all n windows,
    from _eager_gates. With `export`, the native plane exports each
    window's post-trim reads (lsr_x_info, lsr_x_data) instead of
    assembling it."""
    refid_t, refid_n, starts, ends, icfg, dcfg, rgs = inputs
    g = np.asarray(idxs, np.int64)
    sub_raw, sub_off = _blob([windows[i].rawseq.encode("latin-1")
                              for i in idxs])
    rt = np.ascontiguousarray(refid_t[g])
    rn = np.ascontiguousarray(refid_n[g])
    st = np.ascontiguousarray(starts[g])
    en = np.ascontiguousarray(ends[g])
    mask = np.ones(len(idxs), np.uint8)
    n_k = 0
    sub_gates = sub_exact = ctypes.cast(None, _U8P)
    if gates is not None:
        n_k = gates[0].shape[1]
        ga = np.ascontiguousarray(gates[0][g].reshape(-1))
        ex = np.ascontiguousarray(gates[1][g])
        sub_gates, sub_exact = _p(ga, _U8P), _p(ex, _U8P)
    return lib.lsr_run(
        cfg.tumor_bam.encode(), cfg.normal_bam.encode(), len(idxs),
        _p(rt, _I32P), _p(rn, _I32P), _p(st, _I64P), _p(en, _I64P),
        _p(sub_raw, _U8P), _p(sub_off, _I64P), sub_gates, sub_exact, n_k,
        _p(icfg, _I64P), _p(dcfg, _F64P), rgs,
        max(1, os.cpu_count() or 1), CACHE_SPAN,
        _p(mask, _U8P) if export else ctypes.cast(None, _U8P))


GATE_CHUNK = 512  # windows a launch of the eager gate sweep


def gates_enabled() -> bool:
    """The eager gate sweep switch, LANCET_TPU_GATES: any non-empty value
    turns it on (the JAX package's test, shardrun.py:511)."""
    return bool(os.environ.get("LANCET_TPU_GATES"))


def _eager_gates(cfg, windows, device):
    """The repeat gates of every window at every k of the ladder on
    `device`, GATE_CHUNK windows a launch: (verdicts [n, n_k] uint8, the
    exact repeat at max_k [n] uint8), as the native plane takes them. An
    error propagates (the JAX package turns the gates off on any error)."""
    from ..gpu.repeats import repeat_gates

    ks = list(range(cfg.min_k, cfg.max_k + 1, 2))
    n, n_k = len(windows), len(ks)
    gates_arr = np.zeros((n, n_k), np.uint8)
    exact_arr = np.zeros(n, np.uint8)
    for i in range(0, n, GATE_CHUNK):
        chunk = windows[i:i + GATE_CHUNK]
        g, e = repeat_gates([w.rawseq for w in chunk], ks, cfg.max_mismatch,
                            with_exact=True, device=device)
        gates_arr[i:i + len(chunk)] = g
        exact_arr[i:i + len(chunk)] = e[:, n_k - 1]
    return gates_arr, exact_arr


def _run_inputs(cfg, windows, tumor, normal):
    """lsr_run's per-window arrays and configuration: (refid_t, refid_n,
    starts, ends, icfg, dcfg, rgs)."""
    tmap = {nm: i for i, (nm, _) in enumerate(tumor.references)}
    nmap = {nm: i for i, (nm, _) in enumerate(normal.references)}
    refid_t = np.array([tmap.get(w.chrom, -1) for w in windows], np.int32)
    refid_n = np.array([nmap.get(w.chrom, -1) for w in windows], np.int32)
    starts = np.array([w.refstart for w in windows], np.int64)
    ends = np.array([w.refend for w in windows], np.int64)
    icfg = np.array([
        cfg.min_k, cfg.max_k, cfg.min_qual_trim, cfg.min_qual_call,
        cfg.min_map_qual, cfg.max_avg_cov, cfg.max_delta_as_xs,
        int(cfg.xa_filter), int(cfg.primary_alignment_only),
        int(cfg.active_regions), cfg.filters.min_alt_cnt_tumor,
        cfg.low_cov_threshold, cfg.max_tip_len, cfg.dfs_limit,
        cfg.max_indel_len, cfg.max_mismatch, cfg.max_unit_len,
        cfg.min_report_units, cfg.min_report_len, cfg.dist_from_str,
        int(cfg.lr_mode)],
        np.int64)
    dcfg = np.array([cfg.min_cov_ratio, float(cfg.cov_threshold)], np.float64)
    rgs = b""
    if cfg.rg_file:
        with open(cfg.rg_file) as f:
            toks = f.read().split()
        if toks:
            rgs = "\n".join(toks).encode()
    return refid_t, refid_n, starts, ends, icfg, dcfg, rgs


def run_shards(cfg, windows, tumor, normal, stats: dict | None = None,
               device="cuda", mesh=None):
    """Run every window natively, with the DP of each group split over
    `mesh` (parallel.mesh.Mesh; one entry, `device`, when None).
    `windows` is the full ordered list (shard-concatenated, lexicographic
    within shard), the VariantDB add order. `tumor`/`normal` are open
    readers (for refid lookup only). Returns a ShardRunResult, or None
    when the native plane reports a failed group."""
    lib = _lib()
    n = len(windows)
    inputs = _run_inputs(cfg, windows, tumor, normal)
    refid_t, starts, ends = inputs[0], inputs[2], inputs[3]
    u8p, i64p, f64p, p = _U8P, _I64P, _F64P, _p
    mesh = Mesh([device]) if mesh is None else mesh

    t0 = time.perf_counter()
    gates = (_eager_gates(cfg, windows, mesh[0])
             if gates_enabled() and n else None)
    t_gates = time.perf_counter() - t0

    # Genomic groups for the host/device pipeline. Groups are genomically
    # contiguous so each lsr_run call keeps the shared-cache locality;
    # output indices are global, so reassembly is order-exact regardless
    # of grouping.
    order = sorted(range(n), key=lambda i: (int(refid_t[i]), int(starts[i])))
    group_span = max(MIN_GROUP_SPAN,
                     (int(ends.max()) - int(starts.min())) // GROUPS + 1
                     if n else MIN_GROUP_SPAN)
    groups: list[list[int]] = []
    for i in order:
        if (groups and int(refid_t[groups[-1][0]]) == int(refid_t[i])
                and int(ends[i]) - int(starts[groups[-1][0]]) <= group_span):
            groups[-1].append(i)
        else:
            groups.append([i])

    class _NativeFailed(Exception):
        pass

    def native_stage(idxs):
        return _lsr_run(lib, cfg, windows, idxs, inputs, gates=gates)

    variants_by_window: dict[int, list] = {}
    fallback: set[int] = set()
    cls = np.zeros((n, 9), np.int64)
    times = np.zeros(n, np.float64)
    reads = np.zeros(n, np.int64)
    tot_jobs = 0
    tot_dp = 0
    t_host = t_dp = t_fin = t_dp_wait = 0.0
    t_dp_prep = t_dp_send = 0.0

    def dispatch_dp(h, idxs):
        """Extract DP pairs and enqueue the device fill without blocking
        (the device computes while the next group's host stage runs)."""
        nonlocal tot_jobs, tot_dp, t_dp, t_dp_prep, t_dp_send
        if lib.lsr_status(h) != STATUS_OK:
            raise _NativeFailed()
        n_jobs = lib.lsr_n_jobs(h)
        meta = np.zeros((n_jobs, 6), np.int64)
        if n_jobs:
            lib.lsr_job_meta(h, p(meta.reshape(-1), i64p))
        dp_idx = np.nonzero(meta[:, 4])[0] if n_jobs else np.zeros(0, int)

        t0 = time.perf_counter()
        pairs = []
        for i in dp_idx:
            w = windows[idxs[int(meta[i, 0])]]
            src, dist = int(meta[i, 1]), int(meta[i, 2])
            pathseq = ctypes.string_at(
                lib.lsr_job_path(h, int(i)), int(meta[i, 3])).decode(
                "latin-1")
            pairs.append((w.rawseq[src : src + dist], pathseq))
        t_mid = time.perf_counter()
        if stats is not None and pairs:
            # real DP pairs, up to 64 over the run, for a DP parity check
            samples = stats.setdefault("dp_samples", [])
            if len(samples) < 64:
                step = max(1, len(pairs) // (64 - len(samples)))
                samples.extend(pairs[::step][: 64 - len(samples)])
        state = mesh_batch_align_async(pairs, mesh)
        t1 = time.perf_counter()
        t_dp_prep += t_mid - t0
        t_dp_send += t1 - t_mid
        t_dp += t1 - t0
        tot_jobs += int(n_jobs)
        tot_dp += len(pairs)
        return state

    def finish(h, idxs, dp_state):
        nonlocal t_dp, t_fin, t_dp_wait
        t0 = time.perf_counter()
        aligned = batch_align_wait(dp_state)
        t_dp_wait += time.perf_counter() - t0
        t_dp += time.perf_counter() - t0

        t0 = time.perf_counter()
        ra_blob, ra_off = _blob([a.encode("latin-1") for a, _ in aligned])
        pa_blob, pa_off = _blob([b.encode("latin-1") for _, b in aligned])
        lib.lsr_finish(h, p(ra_blob, u8p), p(ra_off, i64p), p(pa_blob, u8p),
                       p(pa_off, i64p))

        nv = lib.lsr_varbuf_size(h)
        buf = ctypes.string_at(lib.lsr_varbuf(h), nv) if nv else b""
        _parse_varbuf(buf, windows, lambda wi: idxs[wi],
                      variants_by_window, lr_mode=cfg.lr_mode)

        m = len(idxs)
        gflags = np.zeros(m, np.uint8)
        greads = np.zeros(m, np.int64)
        gtimes = np.zeros(m, np.float64)
        gcls = np.zeros((m, 9), np.int64)
        lib.lsr_win_out(h, p(gflags, u8p), p(greads, i64p), p(gtimes, f64p),
                        p(gcls.reshape(-1), i64p))
        ga = np.asarray(idxs, np.int64)
        cls[ga] = gcls
        times[ga] = gtimes
        reads[ga] = greads
        for li in np.nonzero(gflags)[0]:
            fallback.add(int(idxs[int(li)]))
        t_fin += time.perf_counter() - t0

    handles: list = []
    try:
        lib.lsr_stage_reset()
        t_all = time.perf_counter()
        with _cf.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(native_stage, groups[0]) if groups else None
            pending = []  # (handle, idxs, dp_state): device DP in flight
            for gi in range(len(groups)):
                t0 = time.perf_counter()
                h = fut.result()
                handles.append(h)
                t_host += time.perf_counter() - t0
                if gi + 1 < len(groups):
                    fut = ex.submit(native_stage, groups[gi + 1])
                # enqueue this group's DP; the device drains the queue
                # while later groups' host stages run
                pending.append((h, groups[gi], dispatch_dp(h, groups[gi])))
            for h, idxs, dp_state in pending:
                finish(h, idxs, dp_state)
                handles.remove(h)
                lib.lsr_free(h)
    except _NativeFailed:
        return None
    finally:
        for h in handles:
            lib.lsr_free(h)

    if stats is not None:
        stats["t_gates"] = t_gates
        stats["t_host"] = t_host  # blocked-on-native time (overlap hides it)
        stats["t_pipeline"] = time.perf_counter() - t_all
        stats["t_dp"] = t_dp
        stats["t_dp_wait"] = t_dp_wait
        stats["t_dp_prep"] = t_dp_prep
        stats["t_dp_send"] = t_dp_send
        stats["t_finish"] = t_fin
        stats["n_jobs"] = tot_jobs
        stats["n_dp"] = tot_dp
        stats["n_groups"] = len(groups)
        ns = np.zeros(16, np.int64)
        lib.lsr_stage_ns(p(ns, i64p))
        for k, v in zip(_STAGES, ns):
            stats[k] = float(v) / 1e9
    return ShardRunResult(variants_by_window, fallback, cls, times, reads)


def device_graph_enabled() -> bool:
    """The device graph engine switch, LANCET_TPU_DEVGRAPH (set and not
    "0" turns it on; default off, as in the JAX package)."""
    v = os.environ.get("LANCET_TPU_DEVGRAPH")
    return v is not None and v != "0"


def run_shards_device(cfg, windows, tumor, normal, stats: dict | None = None,
                      device="cuda", mesh=None):
    """Device graph engine run: the native plane fetches, triages and
    extracts and exports the post-trim reads; the device builds, cleans
    and path-covers each exported window's graph (engine.devicepipe); the
    jobs that need DP are aligned on the device; the native scan_batch
    finishes the transcripts. The graph work is sharded on the window axis
    and the DP on the pair axis over `mesh` (one entry, `device`, when
    None). Windows the device hands back (caps, quirk corners, k > 63) are
    replayed through run_shards, fully natively.
    An error of the device engine propagates. Returns a ShardRunResult, or
    None when the native plane reports a failed pass."""
    from .devicepipe import WindowTask, run_device_graph

    lib = _lib()
    mesh = Mesh([device]) if mesh is None else mesh
    n = len(windows)
    u8p, i32p, i64p, f64p, p = _U8P, _I32P, _I64P, _F64P, _p

    lib.lsr_stage_reset()
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    h = _lsr_run(lib, cfg, windows, list(range(n)),
                 _run_inputs(cfg, windows, tumor, normal), export=True)
    if lib.lsr_status(h) != STATUS_OK:
        lib.lsr_free(h)
        return None
    t_host = time.perf_counter() - t0

    # collect the exports + per-window outputs
    exported = np.zeros(n, np.uint8)
    nbytes = np.zeros(n, np.int64)
    xbp = np.zeros(n, np.int64)
    lib.lsr_x_info(h, p(exported, u8p), p(nbytes, i64p), p(xbp, i64p))
    gflags = np.zeros(n, np.uint8)
    reads_n = np.zeros(n, np.int64)
    times = np.zeros(n, np.float64)
    cls = np.zeros((n, 9), np.int64)
    lib.lsr_win_out(h, p(gflags, u8p), p(reads_n, i64p), p(times, f64p),
                    p(cls.reshape(-1), i64p))

    t0 = time.perf_counter()
    tasks = []
    for i in range(n):
        if not exported[i]:
            continue
        buf = ctypes.string_at(lib.lsr_x_data(h, i), int(nbytes[i]))
        reads = []
        off = 0
        while off < len(buf):
            (ln,) = struct.unpack_from("<i", buf, off)
            (frag,) = struct.unpack_from("<i", buf, off + 8)
            reads.append((buf[off + 12:off + 12 + ln],
                          buf[off + 12 + ln:off + 12 + 2 * ln],
                          int(buf[off + 4]), int(buf[off + 5]), int(frag),
                          int(buf[off + 6])))
            off += 12 + 2 * ln
        w = windows[i]
        tasks.append(WindowTask(
            widx=i, reads=reads, rawseq=w.rawseq, totalreadbp=int(xbp[i]),
            refchr=w.chrom, refstart=w.refstart))
    lib.lsr_free(h)
    t_unpack = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_device_graph(tasks, cfg, stats=stats, mesh=mesh)
    t_dev = time.perf_counter() - t0

    # device DP for the jobs that need it
    t0 = time.perf_counter()
    all_jobs = [(t, j) for t in tasks if not t.fallback for j in t.jobs]
    dp_jobs = [(t, j) for t, j in all_jobs if j.needs_dp]
    if stats is not None and dp_jobs:
        # real DP pairs, up to 64, for a DP parity check
        step = max(1, len(dp_jobs) // 64)
        stats["dp_samples"] = [(j.refseq, j.pathseq)
                               for _, j in dp_jobs[::step]][:64]
    aligned = {}
    if dp_jobs:
        out = batch_align_wait(mesh_batch_align_async(
            [(j.refseq, j.pathseq) for _, j in dp_jobs], mesh))
        aligned = {id(j): r for (_, j), r in zip(dp_jobs, out)}
    t_dp = time.perf_counter() - t0

    # native batch transcript finish
    t0 = time.perf_counter()
    variants_by_window: dict[int, list] = {}
    if all_jobs:
        metas = np.zeros((len(all_jobs), 8), np.int64)
        paths, ras, pas, spans = [], [], [], []
        covT_parts, covN_parts = [], []
        cov_off = np.zeros(len(all_jobs) + 1, np.int64)
        rc_blobs = []
        rc_off_of_task: dict[int, int] = {}
        rc_total = 0
        for k, (t, j) in enumerate(all_jobs):
            if id(t) not in rc_off_of_task:
                rc_off_of_task[id(t)] = rc_total
                rc4 = np.concatenate([
                    j.ref_cov_tmr[:, 0], j.ref_cov_tmr[:, 1],
                    j.ref_cov_nml[:, 0], j.ref_cov_nml[:, 1]]).astype(
                        np.int32)
                rc_blobs.append(rc4)
                rc_total += rc4.size
            ra, pa = (aligned[id(j)] if j.needs_dp
                      else (j.refseq, j.pathseq))
            metas[k] = (j.K, j.trim5, t.refstart, 0, 0, len(t.rawseq),
                        t.widx, rc_off_of_task[id(t)])
            paths.append(j.pathseq.encode("latin-1"))
            ras.append(ra.encode("latin-1"))
            pas.append(pa.encode("latin-1"))
            spans.append(np.ascontiguousarray(j.tumor_span.astype(np.uint8)))
            covT_parts.append(np.ascontiguousarray(
                j.covT[:, :4].astype(np.int32)).reshape(-1))
            covN_parts.append(np.ascontiguousarray(
                j.covN[:, :4].astype(np.int32)).reshape(-1))
            cov_off[k + 1] = cov_off[k] + covT_parts[-1].size
        path_blob, path_off = _blob(paths)
        ra_blob, ra_off = _blob(ras)
        pa_blob, pa_off = _blob(pas)
        span_blob, span_off = _blob([s.tobytes() for s in spans])
        covT_blob = np.concatenate(covT_parts)
        covN_blob = np.concatenate(covN_parts)
        rc_blob = np.concatenate(rc_blobs)
        icfg4 = np.array([cfg.max_unit_len, cfg.min_report_units,
                          cfg.min_report_len, cfg.dist_from_str], np.int64)
        hx = lib.lsx_scan_batch(
            len(all_jobs), p(metas.reshape(-1), i64p),
            p(path_blob, u8p), p(path_off, i64p),
            p(ra_blob, u8p), p(ra_off, i64p),
            p(pa_blob, u8p), p(pa_off, i64p),
            p(covT_blob, i32p), p(covN_blob, i32p), p(cov_off, i64p),
            p(span_blob, u8p), p(span_off, i64p),
            p(rc_blob, i32p), p(icfg4, i64p))
        nv = lib.lsx_varbuf_size(hx)
        buf = ctypes.string_at(lib.lsx_varbuf(hx), nv) if nv else b""
        lib.lsx_free(hx)
        _parse_varbuf(buf, windows, lambda wi: wi, variants_by_window)
    t_fin = time.perf_counter() - t0

    # second pass: the device-fallback windows through the native runner
    fb_idx = sorted([t.widx for t in tasks if t.fallback]
                    + [i for i in range(n) if gflags[i]])
    fallback: set[int] = set()
    tot_jobs, tot_dp = len(all_jobs), len(dp_jobs)
    ns = np.zeros(16, np.int64)
    lib.lsr_stage_ns(p(ns, i64p))  # run_shards resets the stage clocks
    if fb_idx:
        st2: dict = {}
        res = run_shards(cfg, [windows[i] for i in fb_idx], tumor, normal,
                         stats=st2, mesh=mesh)
        if res is None:
            return None
        for wi, vs in res.variants_by_window.items():
            variants_by_window.setdefault(fb_idx[wi], []).extend(vs)
        ga = np.asarray(fb_idx, np.int64)
        cls[ga] = res.counters
        times[ga] += res.times
        reads_n[ga] = res.reads
        fallback.update(fb_idx[li] for li in res.fallback)
        tot_jobs += st2["n_jobs"]
        tot_dp += st2["n_dp"]
        ns2 = np.zeros(16, np.int64)
        lib.lsr_stage_ns(p(ns2, i64p))
        ns += ns2

    if stats is not None:
        stats["t_host"] = t_host
        stats["t_pipeline"] = time.perf_counter() - t_all
        stats["t_unpack"] = t_unpack
        stats["t_devgraph"] = t_dev
        stats["t_dp"] = t_dp
        stats["t_finish"] = t_fin
        stats["n_jobs"] = tot_jobs
        stats["n_dp"] = tot_dp
        stats["n_dev_windows"] = len(tasks)
        stats["n_dev_fallback"] = len(fb_idx)
        hist: dict[int, int] = {}
        for t in tasks:
            if t.done:
                hist[t.k_done] = hist.get(t.k_done, 0) + 1
        stats["k_histogram"] = dict(sorted(hist.items()))
        for k, v in zip(_STAGES, ns):
            stats[k] = float(v) / 1e9
    return ShardRunResult(variants_by_window, fallback, cls, times, reads_n)
