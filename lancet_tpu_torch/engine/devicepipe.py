"""The device graph engine's top level: batches windows through the per-k
assembly pipeline on the device (gpu.dbg + gpu.pipeline) and assembles
PathJobs.

Takes the place of the native C++ k-loop for the common case: the colored
DBG build, cleanup and path cover run on the device as fixed-shape batched
work; windows that exceed the shape caps or hit the reference's irregular
corners (mate-overlap dedup, k > 63, compress loop-backs, map-rehash
hazards) are replayed natively, exactly. The JAX package's
`engine/devicepipe.py`, without its compile cache and stack-limit raise.

The window axis of each chunk is split over a mesh (parallel.mesh; one
entry, inline, when the caller gives none): the build runs through
shard_build_k and the attempt tail through shard_windows, one host thread
a shard; the rank round trip and the job finish stay on the main thread
for the whole chunk, and the repeat gates run unsharded on the mesh's
first device. Only the main thread writes `stats`.

Reference flow: Microassembler.cc:73-249 (processGraph k-retry loop).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import (Mesh, Sharded, gather, shard_build_k,
                             shard_windows)
from .extract import PathJob

_BASES = np.frombuffer(b"ACGTN", np.uint8)


@dataclass
class WindowTask:
    """One window's inputs + evolving per-k state."""

    widx: int  # caller's window index
    reads: list  # [(seq, qual, sample, strand, frag, order)] post-trim
    rawseq: str
    totalreadbp: int
    refchr: str = ""
    refstart: int = 0
    # evolving trim state (stale-trim quirk: the k's index uses the
    # previous attempt's trim)
    seq_off: int = 0
    seq_len: int = 0
    done: bool = False
    fallback: bool = False
    jobs: list | None = None  # emitted PathJobs (in order)
    k_done: int = 0
    min_bucket: int = 0  # shape-bucket floor (raised by cap promotion)

    def __post_init__(self):
        self.seq_len = len(self.rawseq)
        self.jobs = []


# shape buckets (R, L, N, E); Lraw and W are fixed per run. A cap overflow
# promotes the window to the next bucket at the same k.
_BUCKETS = (
    (48, 160, 1536, 3840),
    (192, 160, 1536, 3840),
    (512, 112, 4096, 10240),
    (768, 160, 4096, 10240),
)
_CMAX = 8
_D = 12
# assemble shape tiers (ascending): the graph-size shapes the attempt tail
# runs at after slice-to-fit, whatever bucket sized the build
_TIERS = ((1536, 3840),)
W_DEFAULT = 32  # windows per chunk; tails of <= 8 run at W 8 (one shard)


def _cfg_scalars(cfg, K):
    return dict(cov_threshold=float(cfg.cov_threshold),
                low_cov_threshold=int(cfg.low_cov_threshold),
                min_cov_ratio=float(cfg.min_cov_ratio),
                max_tip_len=int(cfg.max_tip_len),
                max_link_len=int(cfg.max_link_len(K)),
                max_unit_len=int(cfg.max_unit_len),
                min_report_units=int(cfg.min_report_units),
                min_report_len=int(cfg.min_report_len),
                dist_from_str=int(cfg.dist_from_str))


def _bucket_for(task, Lraw):
    if len(task.rawseq) > Lraw:
        return None
    need_r = len(task.reads)
    need_l = max((len(s) for s, *_ in task.reads), default=0)
    for bi, (R, L, N, E) in enumerate(_BUCKETS):
        if need_r <= R and need_l <= L:
            return bi
    return None


def run_device_graph(tasks: list[WindowTask], cfg, stats: dict | None = None,
                     W: int = W_DEFAULT, Lraw: int = 1152,
                     device="cuda", mesh=None) -> None:
    """Process tasks in place, sharded over `mesh` (one entry, `device`,
    when None): fills .jobs/.done/.fallback per window. Callers align and
    finish the jobs in task order. W is rounded down to a multiple of the
    mesh's size (at least one window a shard), and stats["mesh_counters"]
    sums the tails' counters (numcomp, n_sel, fallback).

    One k at a time (the reference's retry ladder, Microassembler.cc:
    109-235): windows the repeat gate passes are packed into chunks of W
    across bucket boundaries, built, ranked on the host and assembled; a
    window that overflows its bucket's node/edge caps is promoted to the
    next bucket at the same k. Chunk i+1's build is dispatched before
    chunk i's host work (rank round trip, job finish) runs; on a one-entry
    mesh it is only queued, so the two overlap."""
    from ..gpu.repeats import repeat_gates

    mesh = Mesh([device]) if mesh is None else mesh
    ndev = len(mesh)
    W = max(ndev, W // ndev * ndev)  # splits evenly on the window axis
    # packed mers carry k <= 63 (the native rank kernel's 128-bit limit);
    # windows still cycling past 63 replay natively
    ks = [k for k in range(cfg.min_k, cfg.max_k + 1, 2) if k <= 63]

    causes = None
    if stats is not None:
        causes = stats.setdefault("dev_fallback_causes", {})

    def _cause(key, n=1):
        if causes is not None and n:
            causes[key] = causes.get(key, 0) + n

    pending: list[WindowTask] = []
    for t in tasks:
        bi = _bucket_for(t, Lraw)
        if bi is None:
            t.fallback = True
            _cause("shape_screen")
        else:
            t.min_bucket = bi
            pending.append(t)

    n_attempts = 0
    for K in ks:
        if not pending:
            break
        # reference-repeat gate for this k (Microassembler.cc:118-131):
        # gated windows skip to the next k
        gates = repeat_gates([t.rawseq for t in pending], [K],
                             cfg.max_mismatch, device=mesh[0])[:, 0]
        attempt = [t for t, g in zip(pending, gates) if not g]
        next_pending = [t for t, g in zip(pending, gates) if g]
        while attempt:  # promotion rounds (bounded by len(_BUCKETS))
            attempt.sort(key=lambda t: t.min_bucket)
            promoted: list[WindowTask] = []
            inflight = None
            for lo in range(0, len(attempt), W):
                chunk = attempt[lo:lo + W]
                Wc = 8 if ndev == 1 and len(chunk) <= 8 <= W else W
                # smallest bucket over every member's floor that fits the
                # chunk's read count and length (L is not monotone)
                bi_floor = max(t.min_bucket for t in chunk)
                need_r = max(len(t.reads) for t in chunk)
                need_l = max((len(s) for t in chunk for s, *_ in t.reads),
                             default=0)
                bi = next(i for i in range(bi_floor, len(_BUCKETS))
                          if _BUCKETS[i][0] >= need_r
                          and _BUCKETS[i][1] >= need_l)
                n_attempts += 1
                st = _dispatch_chunk(chunk, cfg, K, Wc, bi, Lraw, mesh, stats)
                if inflight is not None:
                    _complete_chunk(inflight, cfg, K, stats, promoted,
                                    next_pending, mesh)
                inflight = st
            if inflight is not None:
                _complete_chunk(inflight, cfg, K, stats, promoted,
                                next_pending, mesh)
            attempt = promoted
        pending = next_pending
    for t in pending:
        t.fallback = True  # ran out of device ks (k > 63): native ladder
    _cause("k_gt_63", len(pending))
    if stats is not None:
        stats["n_dev_attempts"] = stats.get("n_dev_attempts", 0) + n_attempts


def _dispatch_chunk(chunk, cfg, K, W, bi, Lraw, mesh, stats=None):
    """Pack one chunk and build it, shard by shard over `mesh` (one entry:
    queued on the device). Returns the in-flight state consumed by
    _complete_chunk, with the builds as a list of per-shard dicts."""
    from ..gpu.pack import WindowBatch, pack_chunk

    R, L, N, E = _BUCKETS[bi]
    t0 = time.perf_counter()
    batch = WindowBatch(W, R, L, Lraw)
    pack_chunk(batch, chunk)
    host = (batch.bases, batch.quals, batch.rlen, batch.rsample,
            batch.rstrand, batch.rfrag, batch.rorder, batch.raw, batch.rawlen,
            batch.seq_off, batch.seq_len, batch.totalreadbp, batch.window_ok)
    bs = shard_build_k(mesh, K, (N, E, _D, Lraw, cfg.min_qual_call,
                                 cfg.low_cov_threshold,
                                 cfg.min_cov_ratio))(*host)
    if stats is not None:
        stats["t_dg_pack"] = stats.get("t_dg_pack", 0.0) \
            + (time.perf_counter() - t0)
    return dict(chunk=chunk, batch=batch, bs=bs, bi=bi, W=W)


def _complete_chunk(st_if, cfg, K, stats, promoted, retry, mesh):
    """Finish an in-flight chunk: rank round trip, assemble, classify.
    Shape-cap overflows go to `promoted` (same k, next bucket); cycle and
    repeat aborts go to `retry` (next k); semantic corners mark .fallback
    for the native replay. Every field is fetched to the host over the
    chunk's shards, in shard order."""
    chunk, batch, bs = st_if["chunk"], st_if["batch"], st_if["bs"]
    bi, W = st_if["bi"], st_if["W"]
    R, L, N, E = _BUCKETS[bi]

    def mark(key, t0):
        t1 = time.perf_counter()
        if stats is not None:
            stats[key] = stats.get(key, 0.0) + (t1 - t0)
        return t1

    # host round trip: creation-order packed mers -> map-order ranks
    t0 = time.perf_counter()
    n_nodes, n_edges, b_fallback, mate_cand = (
        gather([b[k] for b in bs])
        for k in ("n_nodes", "n_edges", "fallback", "mate_cand"))
    window_ok = np.asarray(batch.window_ok)
    # slice-to-fit: when every live lane's graph fits a smaller tier the
    # attempt tail runs at those shapes (node/edge tables are dense in
    # creation order)
    live = window_ok & ~b_fallback
    Nc, Ec = N, E
    if live.any():
        nn_max = int(n_nodes[live].max())
        ne_max = int(n_edges[live].max())
        for tn, te in _TIERS:
            if tn < N and te < E and nn_max <= tn and ne_max <= te:
                Nc, Ec = tn, te
                break
    mers_w = [gather([b["mers_w"][i][:, :Nc] for b in bs])
              for i in range(len(bs[0]["mers_w"]))]
    t0 = mark("t_dg_build", t0)  # build + the fetch of the mer tables
    ranks, rank_bad = _map_ranks_batch(mers_w, n_nodes, window_ok, K, W, Nc)
    t0 = mark("t_dg_ranks", t0)

    tA = time.perf_counter()
    statics = (K, N, E, Nc, Ec, _cfg_scalars(cfg, K),
               int(cfg.dfs_limit) or (1 << 30), int(cfg.max_indel_len),
               int(cfg.max_mismatch))
    outs, counters = shard_windows(
        lambda b, r, raw: _assemble(b, r, raw, *statics), mesh)(
            Sharded(bs), ranks, batch.raw)
    if stats is not None:
        mc = stats.setdefault("mesh_counters", {})
        for k, v in zip(("numcomp", "n_sel", "fallback"), counters.tolist()):
            mc[k] = mc.get(k, 0) + v
    tB = time.perf_counter()
    # fetch the small fields, then only the used [:, :jmax, :lmax] corner
    # of the [W, JMAX, LP] job tensors
    big = ("pathseq", "covT", "covN", "span")
    res = {k: gather([o[k] for o in outs]) for k in outs[0] if k not in big}
    tC = time.perf_counter()
    ok_lane = window_ok & ~b_fallback & ~mate_cand & ~rank_bad \
        & ~res["fallback"]
    nsel = np.where(ok_lane, res["n_sel"], 0)
    jmax = int(nsel.max()) if len(nsel) else 0
    if jmax > 0:
        JMAX, LP = outs[0]["pathseq"].shape[1], outs[0]["pathseq"].shape[2]
        jm = min(JMAX, -(-jmax // 2) * 2)
        jcols = np.arange(JMAX)[None, :jm]
        lp_used = np.where(jcols < nsel[:, None], res["lp"][:, :jm], 0)
        lm = min(LP, -(-max(int(lp_used.max()), 1) // 256) * 256)
        for k2 in big:
            lw = lm + 1 if k2 == "span" else lm
            res[k2] = gather([o[k2][:, :jm, :lw] for o in outs])
    if stats is not None:
        tD = time.perf_counter()
        stats["t_dg_a_dispatch"] = stats.get("t_dg_a_dispatch", 0.0) \
            + (tB - tA)
        stats["t_dg_a_exec"] = stats.get("t_dg_a_exec", 0.0) + (tC - tB)
        stats["t_dg_a_fetch"] = stats.get("t_dg_a_fetch", 0.0) + (tD - tC)
    t0 = mark("t_dg_assemble", t0)

    # node/edge/degree cap overflow (not the mate-overlap corner): the next
    # bucket's caps may fit -- promote instead of losing the window
    shape_over = b_fallback & ~mate_cand
    last_bucket = bi + 1 >= len(_BUCKETS)
    causes = (stats.setdefault("dev_fallback_causes", {})
              if stats is not None else None)

    def _cause(key):
        if causes is not None:
            causes[key] = causes.get(key, 0) + 1

    for w, t in enumerate(chunk):
        if not window_ok[w] or rank_bad[w] or mate_cand[w]:
            t.fallback = True
            _cause("mate_overlap" if mate_cand[w] else
                   "rank_rehash" if rank_bad[w] else "non_acgt")
            continue
        if res["fallback"][w]:
            if shape_over[w] and not last_bucket:
                t.min_bucket = bi + 1
                promoted.append(t)
            else:
                t.fallback = True
                _cause("shape_caps" if shape_over[w] else "pipeline_caps")
            continue
        _finish_window(t, w, res, K, cfg)
        if not t.done:
            retry.append(t)
    mark("t_dg_finish", t0)


def _map_ranks_batch(mers_w, n_nodes, window_ok, K, W, N):
    """Creation-order packed mers -> libstdc++ map-order ranks plus
    rehash-headroom flags for the whole chunk in one native call
    (lancet_native.cc lmo_ranks_batch; no Python strings, and no Python
    fallback: the call is required). A window whose slack cannot absorb the
    fake source/sink inserts (Graph.cc:2156-2227) is flagged rank_bad
    (iteration order could change with a rehash) and replays natively."""
    from ..gpu.pack import words_to_128
    from ..native import lmo_ranks_batch

    ranks = np.full((W, N), 1 << 28, np.int32)
    rank_bad = np.zeros(W, bool)
    ok = np.asarray(window_ok, bool)
    nn = np.where(ok, np.minimum(n_nodes, N), 0).astype(np.int64)
    if not nn.any():
        return ranks, rank_bad
    mask = np.arange(N)[None, :] < nn[:, None]
    offs = np.zeros(W + 1, np.int64)
    np.cumsum(nn, out=offs[1:])
    hi64, lo64 = words_to_128(mers_w, K)
    flat_r, slack = lmo_ranks_batch(hi64[mask], lo64[mask], offs, K)
    ranks[mask] = flat_r
    rank_bad = ok & (nn > 0) & (slack < 2 * _CMAX)
    return ranks, rank_bad


def slice_to_fit(b, N, Nc, Ec):
    """The build's tables cut to the tier (Nc, Ec) (unchanged when Nc ==
    N): node and edge tables are dense in creation order."""
    if Nc >= N:
        return b
    b = dict(b)
    for key in ("counts", "totq", "mq", "alive", "is_tumor", "is_normal"):
        b[key] = b[key][:, :Nc]
    b["mers_w"] = tuple(m[:, :Nc] for m in b["mers_w"])
    for key in ("edge_src", "edge_dst", "edge_dir", "edge_exists"):
        b[key] = b[key][:, :Ec]
    # dead lanes may project node ids past the tier; live lanes have all
    # ids < n_nodes <= Nc
    b["nid_proj"] = torch.where(b["nid_proj"] < Nc, b["nid_proj"], -1)
    return b


def _assemble(b, ranks, raw, K, N, E, Nc, Ec, cfg_s, dfs_limit, max_indel,
              max_mismatch):
    """The attempt's tail: stages + path cover + materialize, at the
    slice-to-fit shapes (Nc, Ec) <= (N, E). All of its tensors lie on one
    device (a shard's under a mesh)."""
    from ..gpu import pipeline

    b = slice_to_fit(b, N, Nc, Ec)
    st, res = pipeline.run_attempt(b, ranks.to(torch.int64), K, Nc, Ec,
                                   _CMAX, cfg_s)
    # run_attempt returns the COMPACT state: regular items in [0, NCR),
    # anchors at NCR+2c / NCR+2c+1
    NCR = pipeline.NCR_DEFAULT
    NIc = NCR + 2 * _CMAX
    paths = pipeline.path_cover(st, res, K, NCR, NIc, _CMAX,
                                res["ends"]["dist"], dfs_limit, max_indel)
    out = pipeline.materialize_jobs(st, b, paths, res, K, Nc, NIc, _CMAX, raw,
                                    max_mismatch)
    out["cyc1"] = res["cyc1"]
    out["cyc2"] = res["cyc2"]
    out["anchored"] = res["ends"]["anchored"]
    out["numcomp"] = res["numcomp"]
    out["asrc"] = res["ends"]["src_pos"]
    out["adist"] = res["ends"]["dist"]
    out["fallback"] = res["fallback"] | out["fallback"]
    out["refcov"] = b["refcov"]
    return out


def _finish_window(t: WindowTask, w: int, res, K, cfg):
    """Replay the per-component abort logic and emit PathJobs."""
    numcomp = int(res["numcomp"][w])
    n_sel = int(res["n_sel"][w])
    sel_comp = res["sel_comp"][w]
    raw_n = len(t.rawseq)
    refcov = res["refcov"][w][:raw_n]
    tumor_cov = np.zeros((raw_n, 10), np.int32)
    normal_cov = np.zeros((raw_n, 10), np.int32)
    tumor_cov[:, 0] = refcov[:, 0]
    tumor_cov[:, 1] = refcov[:, 1]
    normal_cov[:, 0] = refcov[:, 2]
    normal_cov[:, 1] = refcov[:, 3]

    abort_comp = 0  # 0 = none
    for c in range(1, min(numcomp, _CMAX) + 1):
        if not bool(res["anchored"][w][c - 1]):
            continue
        if bool(res["cyc1"][w][c - 1]) or bool(res["cyc2"][w][c - 1]):
            abort_comp = c
            break
        # repeat gate: a selected path of this comp with is_rep
        if any(int(sel_comp[j]) == c and bool(res["is_rep"][w][j])
               for j in range(n_sel)):
            abort_comp = c
            break

    emit_before = abort_comp if abort_comp else min(numcomp, _CMAX) + 1

    # trim state: the last anchored comp among the processed ones
    last_anch = 0
    processed = abort_comp if abort_comp else min(numcomp, _CMAX)
    for c in range(1, processed + 1):
        if bool(res["anchored"][w][c - 1]):
            last_anch = c
    if last_anch:
        t.seq_off = int(res["asrc"][w][last_anch - 1])
        t.seq_len = int(res["adist"][w][last_anch - 1])

    for j in range(n_sel):
        c = int(sel_comp[j])
        if c >= emit_before:
            continue
        lp = int(res["lp"][w][j])
        seq = _BASES[np.clip(res["pathseq"][w][j][:lp], 0, 4)].tobytes()
        covT = np.zeros((lp, 10), np.int32)
        covN = np.zeros((lp, 10), np.int32)
        covT[:, :4] = res["covT"][w][j][:lp]
        covN[:, :4] = res["covN"][w][j][:lp]
        src = int(res["src_pos"][w][j])
        dist = int(res["dist"][w][j])
        t.jobs.append(PathJob(
            refchr=t.refchr, refstart=t.refstart,
            trim5=int(res["trim5"][w][j]),
            refseq=t.rawseq[src:src + dist],
            pathseq=seq.decode("latin-1"), K=K,
            covN=covN, covT=covT,
            tumor_span=res["span"][w][j][:lp + 1].copy(),
            ref_cov_nml=normal_cov, ref_cov_tmr=tumor_cov,
            needs_dp=bool(res["needs_dp"][w][j]), lr_mode=False))

    t.done = not abort_comp
    t.k_done = K if t.done else 0
