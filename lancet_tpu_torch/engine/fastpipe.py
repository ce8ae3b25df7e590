"""Native per-k graph pipeline glue (lancet_native.cc lgp_run).

One call runs the whole per-k window stage in C++ — colored-DBG build,
connected components, source/sink anchoring, cycle gate, unitig
compression, low-cov/tip/short-link cleanup, the graph-path repeat gate,
and the best-new-edge path cover — and returns PathJob records for the
device-batched alignment plus the window-seq trim state (stale-trim quirk
preserved across k). Any native-side inconsistency returns status 3 and the
caller falls back to the Python engine for the window.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .extract import PathJob
from .fastbuild import _add_ref_read, _concat, _gather

STATUS_OK, STATUS_CYCLE, STATUS_REPEAT, STATUS_ERROR = 0, 1, 2, 3

_PIPE = None


def _lib():
    global _PIPE
    if _PIPE is None:
        try:
            from ..native import load_library

            lib = load_library()
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.lgp_run.restype = ctypes.c_void_p
            lib.lgp_run.argtypes = [
                u8p, u8p, ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p,
                i32p, i32p, i64p, u8p, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_int, ctypes.c_double, u8p,
                ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            for nm, rt, extra in (
                    ("lgp_status", ctypes.c_int, ()),
                    ("lgp_trim5", ctypes.c_int, ()),
                    ("lgp_trim3", ctypes.c_int, ()),
                    ("lgp_seq_set", ctypes.c_int, ()),
                    ("lgp_seq_off", ctypes.c_long, ()),
                    ("lgp_seq_len", ctypes.c_long, ()),
                    ("lgp_refcov", i32p, ()),
                    ("lgp_n_jobs", ctypes.c_long, ()),
                    ("lgp_job_len", ctypes.c_long, (ctypes.c_long,)),
                    ("lgp_job_seq", ctypes.c_char_p, (ctypes.c_long,)),
                    ("lgp_job_covT", i32p, (ctypes.c_long,)),
                    ("lgp_job_covN", i32p, (ctypes.c_long,)),
                    ("lgp_job_span", u8p, (ctypes.c_long,)),
                    ("lgp_job_src_off", ctypes.c_long, (ctypes.c_long,)),
                    ("lgp_job_dist", ctypes.c_long, (ctypes.c_long,)),
                    ("lgp_job_trim5", ctypes.c_int, (ctypes.c_long,)),
                    ("lgp_job_needs_dp", ctypes.c_int, (ctypes.c_long,))):
                fn = getattr(lib, nm)
                fn.restype = rt
                fn.argtypes = [ctypes.c_void_p, *extra]
            lib.lgp_free.argtypes = [ctypes.c_void_p]
            _PIPE = lib
        except Exception:
            _PIPE = 0
    return _PIPE


def available() -> bool:
    return bool(_lib())


def run_k_native(graph, refinfo, cfg) -> int | None:
    """One k iteration fully in native code. Returns STATUS_* (OK = break
    the k loop, CYCLE/REPEAT = retry next k) or None when unavailable or on
    a native-side error (caller falls back to the Python engine; graph
    state is restored for the retry)."""
    lib = _lib()
    if not lib:
        return None
    _add_ref_read(graph, refinfo)
    K = graph.K
    tot_bp_before = graph.totalreadbp
    seqs, quals, metas = _gather(graph)
    rawseq = refinfo.rawseq
    avgcov = graph.totalreadbp / len(rawseq)
    if not seqs:
        # no usable reads: zero coverage projections, nothing else
        # (fastbuild no-seqs branch)
        n = len(rawseq)
        refinfo.tumor_coverage = np.zeros((n, 10), np.int32)
        refinfo.normal_coverage = np.zeros((n, 10), np.int32)
        return STATUS_OK

    cat, qcat, starts, read_lens = _concat(seqs, quals, K)
    sample = np.array([m[1] for m in metas], np.int32)
    strand = np.array([m[2] for m in metas], np.int32)
    order = np.array([m[5] for m in metas], np.int32)
    names = [m[4].encode("latin-1") for m in metas]
    name_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(nm) for nm in names], out=name_off[1:])
    name_blob = (np.frombuffer(b"".join(names), np.uint8) if names
                 else np.zeros(0, np.uint8))
    idxseq = np.frombuffer(refinfo.seq.encode("latin-1"), np.uint8)
    raw = np.frombuffer(rawseq.encode("latin-1"), np.uint8)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def p(a, t):
        return a.ctypes.data_as(t)

    h = lib.lgp_run(
        p(cat, u8p), p(qcat, u8p), cat.size, read_lens.size,
        p(starts, i64p), p(read_lens, i32p), p(sample, i32p),
        p(strand, i32p), p(order, i32p), p(name_off, i64p),
        p(name_blob, u8p), K, graph.MIN_QUAL_CALL, float(avgcov),
        int(graph.LOW_COV_THRESHOLD), float(graph.MIN_COV_RATIO),
        p(idxseq, u8p), idxseq.size, p(raw, u8p), raw.size,
        float(graph.COV_THRESHOLD), int(graph.MAX_TIP_LEN),
        int(graph.MAX_LINK_LEN), int(graph.DFS_LIMIT),
        int(graph.MAX_INDEL_LEN), int(graph.MAX_MISMATCH),
        int(cfg.max_unit_len), int(cfg.min_report_units),
        int(cfg.min_report_len), int(cfg.dist_from_str))
    try:
        status = lib.lgp_status(h)
        if status == STATUS_ERROR:
            graph.totalreadbp = tot_bp_before  # python path re-gathers
            return None

        n = len(rawseq)
        rc = np.ctypeslib.as_array(lib.lgp_refcov(h), shape=(4 * n,))
        tumor_cov = np.zeros((n, 10), np.int32)
        normal_cov = np.zeros((n, 10), np.int32)
        tumor_cov[:, 0] = rc[0:n]
        tumor_cov[:, 1] = rc[n : 2 * n]
        normal_cov[:, 0] = rc[2 * n : 3 * n]
        normal_cov[:, 1] = rc[3 * n : 4 * n]
        refinfo.tumor_coverage = tumor_cov
        refinfo.normal_coverage = normal_cov

        refinfo.trim5 = lib.lgp_trim5(h)
        refinfo.trim3 = lib.lgp_trim3(h)
        if lib.lgp_seq_set(h):
            off = lib.lgp_seq_off(h)
            refinfo.seq = rawseq[off : off + lib.lgp_seq_len(h)]

        n_jobs = lib.lgp_n_jobs(h)
        for i in range(n_jobs):
            L = lib.lgp_job_len(h, i)
            pathseq = ctypes.string_at(lib.lgp_job_seq(h, i), L).decode(
                "latin-1")
            covT = np.zeros((L, 10), np.int32)
            covN = np.zeros((L, 10), np.int32)
            if L:
                covT[:, :4] = np.ctypeslib.as_array(
                    lib.lgp_job_covT(h, i), shape=(L, 4))
                covN[:, :4] = np.ctypeslib.as_array(
                    lib.lgp_job_covN(h, i), shape=(L, 4))
            span = np.ctypeslib.as_array(
                lib.lgp_job_span(h, i), shape=(L + 1,)).astype(bool)
            src = lib.lgp_job_src_off(h, i)
            dist = lib.lgp_job_dist(h, i)
            job = PathJob(
                refchr=refinfo.refchr, refstart=refinfo.refstart,
                trim5=lib.lgp_job_trim5(h, i),
                refseq=rawseq[src : src + dist], pathseq=pathseq, K=K,
                covN=covN, covT=covT, tumor_span=span,
                ref_cov_nml=normal_cov, ref_cov_tmr=tumor_cov,
                needs_dp=bool(lib.lgp_job_needs_dp(h, i)), lr_mode=False,
                bx_graph_tmr=graph.bx_table_tmr,
                bx_graph_nml=graph.bx_table_nml,
                bx_ref_tmr=refinfo.bx_table_tmr,
                bx_ref_nml=refinfo.bx_table_nml)
            if graph.path_sink is not None:
                graph.path_sink(job)
            else:
                from .align import global_align_aff
                from .extract import finish_path

                if job.needs_dp:
                    ra, pa = global_align_aff(job.refseq, job.pathseq)
                else:
                    ra, pa = job.refseq, job.pathseq
                finish_path(job, ra, pa, graph.cfg, graph.vdb)
        return status
    finally:
        lib.lgp_free(h)
