"""Vectorized colored-DBG construction (hot loop #1, SURVEY.md §3).

Replaces the per-character `load_sequence` stream (Graph.cc:119-349) with
numpy array passes over all reads at once, producing *identical* end state:

- canonical mers via row-wise lexicographic min against the revcomp
- per-node coverage counters, per-base min-quality counts (canonical
  orientation), status colors, tumor/normal flags
- edge lists ordered by first-occurrence time in the reference's exact
  visit stream (BFS path enumeration order depends on this)
- reference-window mer coverage table updates (last-write == final totals)
- the mate-overlap dedup quirk (std::binary_search over unsorted,
  push-ordered name vectors) replayed exactly, but only for candidate
  visits (zero cost for unpaired reads)
- node materialization only for nodes surviving the low-coverage prune,
  inserted into the libstdc++-order map in first-occurrence order

The semantics are defined by `Graph.load_sequence` (the oracle); equality
is asserted by tests/test_fastbuild.py and the golden corpus.
"""

from __future__ import annotations

import numpy as np

from ..cpp import std_binary_search
from .mer import F, R
from .node import FF, FR, RF, RR, FWD, REV, NML, TMR, Edge, Node
from .graph import REF_LABEL

_COMP = np.zeros(256, np.uint8)
for a, b in zip(b"ACGTacgtNn", b"TGCAtgcaNn"):
    _COMP[a] = b

_DIR_TABLE = {  # (u_ori_is_F, v_ori_is_F) -> (fdir, rdir)
    (True, True): (FF, RR),
    (True, False): (FR, FR),
    (False, True): (RF, RF),
    (False, False): (RR, FF),
}

# 4-bit injective codes for the 16 BAM sequence symbols (mer dedup packs
# mers into uint64 words; order need not be lexicographic — only identity
# grouping matters)
_NIB = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NIB[_c] = _i
for _i, _c in enumerate(b"acmgrsvtwyhkdbn"):  # lowercase aliases distinct
    _NIB[_c] = 255  # force fallback; lowercase shouldn't reach mers


def _unique_mers(mer_rows: np.ndarray, K: int):
    """(n_nodes, node_ids[int32], rep_idx[int]) — group identical mer rows.

    Fast path packs each K-byte row into ceil(K/16) uint64 words (4-bit
    codes) and groups with integer sort — far faster than np.unique over a
    structured K-byte dtype (generic memcmp sort). Falls back to the
    structured unique when a row contains a byte outside the 16-symbol
    alphabet."""
    n = mer_rows.shape[0]
    codes = _NIB[mer_rows]
    if not (codes != 255).all():
        view = mer_rows.view([("", np.uint8)] * K).ravel()
        _, rep_idx, inv = np.unique(view, return_index=True,
                                    return_inverse=True)
        return rep_idx.shape[0], inv.astype(np.int32), rep_idx
    W = (K + 15) // 16
    packed = np.zeros((n, W), np.uint64)
    c64 = codes.astype(np.uint64)
    for j in range(K):
        w = j >> 4
        packed[:, w] = (packed[:, w] << np.uint64(4)) | c64[:, j]
    if W == 1:
        _, rep_idx, inv = np.unique(packed[:, 0], return_index=True,
                                    return_inverse=True)
        return rep_idx.shape[0], inv.astype(np.int32), rep_idx
    order = np.lexsort(tuple(packed[:, w] for w in range(W - 1, -1, -1)))
    sp = packed[order]
    newgrp = np.empty(n, bool)
    newgrp[0] = True
    np.any(sp[1:] != sp[:-1], axis=1, out=newgrp[1:])
    grp = np.cumsum(newgrp) - 1
    inv = np.empty(n, np.int64)
    inv[order] = grp
    rep_idx = order[newgrp]
    return int(grp[-1]) + 1, inv.astype(np.int32), rep_idx


def _sliding(arr: np.ndarray, k: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(arr, k)


def _add_ref_read(graph, refinfo) -> None:
    graph.ref = refinfo
    if not graph.is_ref_added:
        qv = "K" * len(refinfo.rawseq)
        graph.add_read("ref", refinfo.hdr, refinfo.rawseq, qv, "R",
                       REF_LABEL, FWD, 0, "null", 0)
        graph.is_ref_added = True


def _gather(graph):
    """Post-trim read views + metadata; accumulates graph.totalreadbp."""
    K = graph.K
    seqs = []
    quals = []
    metas = []  # (readid, sample, strand, is_ref, name, mate_order)
    for i, info in enumerate(graph.readid2info):
        if info.isjunk:
            continue
        ln = len(info.seq)
        t5, t3 = info.trm5, info.trm3
        s = info.seq[t5 : ln - t3] if (t5 or t3) else info.seq
        q = info.qv[t5 : ln - t3] if (t5 or t3) else info.qv
        if info.label != REF_LABEL:
            graph.totalreadbp += len(s)
        if len(s) - K <= 0:
            continue
        seqs.append(np.frombuffer(s.encode("latin-1"), np.uint8))
        quals.append(np.frombuffer(q.encode("latin-1"), np.uint8))
        metas.append((i, info.label, info.strand, info.label == REF_LABEL,
                      info.readname, info.mate_order))
    return seqs, quals, metas


def _concat(seqs, quals, K):
    """Concatenated read/qual stream joined with (K+1)-wide 0xFF/0 gaps
    (gap bytes never match and never pass quality, so cross-read windows
    self-mask)."""
    GAP = K + 1
    read_lens = np.array([s.size for s in seqs], np.int32)
    reads_n = len(seqs)
    tot = int(read_lens.sum()) + GAP * reads_n
    cat = np.full(tot, 0xFF, np.uint8)
    qcat = np.zeros(tot, np.uint8)
    starts = np.zeros(reads_n, np.int64)
    off = 0
    for ridx, (s, q) in enumerate(zip(seqs, quals)):
        starts[ridx] = off
        cat[off : off + s.size] = s
        qcat[off : off + s.size] = q
        off += s.size + GAP
    return cat, qcat, starts, read_lens


def build_graph_native(graph, refinfo) -> bool:
    """C++ kernel path (native/lancet_native.cc lgb_build): same end state
    as build_graph_fast; returns False when the native toolchain is
    unavailable so the caller can fall back to the numpy path."""
    assert not graph.LR_MODE
    try:
        from ..native import dbg_build, load_library

        load_library()
    except Exception:
        return False

    _add_ref_read(graph, refinfo)
    K = graph.K
    minq = graph.MIN_QUAL_CALL
    seqs, quals, metas = _gather(graph)
    if not seqs:
        refinfo.compute_coverage(TMR)
        refinfo.compute_coverage(NML)
        return True

    cat, qcat, starts, read_lens = _concat(seqs, quals, K)
    sample = np.array([m[1] for m in metas], np.int32)
    strand = np.array([m[2] for m in metas], np.int32)
    order = np.array([m[5] for m in metas], np.int32)
    names = [m[4].encode("latin-1") for m in metas]
    name_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(nm) for nm in names], out=name_off[1:])
    name_blob = np.frombuffer(b"".join(names), np.uint8) if names else \
        np.zeros(0, np.uint8)

    avgcov = graph.totalreadbp / len(refinfo.rawseq)
    refseq = np.frombuffer(refinfo.seq.encode("latin-1"), np.uint8)
    res = dbg_build(cat, qcat, starts, read_lens, sample, strand, order,
                    name_off, name_blob, K, minq, avgcov,
                    graph.LOW_COV_THRESHOLD, graph.MIN_COV_RATIO, refseq)

    # ---- materialize (same end state as the numpy tail) -------------------
    n_nodes = res["n_nodes"]
    blob = res["mers"].tobytes()
    mer_strings = [blob[i * K : (i + 1) * K].decode("latin-1")
                   for i in range(n_nodes)]
    flags = res["flags"]
    low = (flags & 8) != 0
    in_ref = (flags & 4) != 0
    cov = res["cov"]
    fwd_t, rev_t, fwd_n, rev_n = (cov[:, 0], cov[:, 1], cov[:, 2],
                                  cov[:, 3])
    mq = res["mq"]  # [4, n, K]: t fwd, t rev, n fwd, n rev

    refinfo.index_mers()
    for sample_id, fwd_c, rev_c, fbit, rbit, table in (
            (TMR, fwd_t, rev_t, 16, 32, refinfo.mertable_tmr),
            (NML, fwd_n, rev_n, 64, 128, refinfo.mertable_nml)):
        seen_f = (flags & fbit) != 0
        seen_r = (flags & rbit) != 0
        for nid in np.nonzero(in_ref & (seen_f | seen_r))[0]:
            row = table[mer_strings[nid]]
            if seen_f[nid]:
                row[0] = fwd_c[nid]
            if seen_r[nid]:
                row[1] = rev_c[nid]
    refinfo.compute_coverage(TMR)
    refinfo.compute_coverage(NML)

    # map insertion order = node creation order (native ids are
    # first-occurrence order, which equals argsort(first_time))
    nodes = graph.nodes
    for s in mer_strings:
        nodes[s] = None
    for nid in np.nonzero(low)[0]:
        del nodes[mer_strings[nid]]

    surv_ids = np.nonzero(~low)[0]
    ns = surv_ids.size
    cd_t_all = np.zeros((ns, K, 10), np.int32)
    cd_n_all = np.zeros((ns, K, 10), np.int32)
    cd_t_all[:, :, 0] = fwd_t[surv_ids, None]
    cd_t_all[:, :, 1] = rev_t[surv_ids, None]
    cd_t_all[:, :, 2] = mq[0][surv_ids]
    cd_t_all[:, :, 3] = mq[1][surv_ids]
    cd_n_all[:, :, 0] = fwd_n[surv_ids, None]
    cd_n_all[:, :, 1] = rev_n[surv_ids, None]
    cd_n_all[:, :, 2] = mq[2][surv_ids]
    cd_n_all[:, :, 3] = mq[3][surv_ids]
    is_tumor = (flags & 1) != 0
    is_normal = (flags & 2) != 0
    node_objs = _materialize_nodes(
        graph, mer_strings, surv_ids, K, minq, fwd_t, rev_t, fwd_n, rev_n,
        is_tumor, is_normal, in_ref, res["tot_cov"], res["mincov_qv"],
        cd_t_all, cd_n_all)

    dirs = (FF, FR, RF, RR)
    esrc, edst, edir = res["esrc"], res["edst"], res["edir"]
    for ei in range(esrc.size):
        e = Edge(mer_strings[int(edst[ei])], dirs[int(edir[ei])])
        node_objs[int(esrc[ei])].edges.append(e)

    for node in node_objs.values():
        nodes[node.nodeid] = node
    return True


def _materialize_nodes(graph, mer_strings, surv_ids, K, minq, fwd_t, rev_t,
                       fwd_n, rev_n, is_tumor, is_normal, touch_ref,
                       mincov_all, mincov_qv, cd_t_all, cd_n_all):
    """Node objects for surviving node ids (shared by numpy/native paths)."""
    node_objs: dict[int, Node] = {}
    for si in range(surv_ids.size):
        nid = int(surv_ids[si])
        node = Node.__new__(Node)
        node.nodeid = mer_strings[nid]
        node.K = K
        node.str_m = node.nodeid
        node.cov_tmr_fwd = float(fwd_t[nid])
        node.cov_tmr_rev = float(rev_t[nid])
        node.cov_nml_fwd = float(fwd_n[nid])
        node.cov_nml_rev = float(rev_n[nid])
        node.is_ref = False
        node.is_tumor = bool(is_tumor[nid])
        node.is_normal = bool(is_normal[nid])
        node.is_source = False
        node.is_sink = False
        node.dead = False
        node.component = 0
        node.touch_ref = bool(touch_ref[nid])
        node.on_ref_path = 0
        node.color = 0
        node.min_qual = minq
        node.mincov = int(mincov_all[nid])
        node.mincov_qv = int(mincov_qv[nid])
        if node.is_tumor and node.is_normal:
            status = b"B"
        elif node.is_tumor:
            status = b"T"
        elif node.is_normal:
            status = b"N"
        else:
            status = b"E"
        node.cov_status = bytearray(status * K)
        node.cov_distr_tmr = cd_t_all[si]
        node.cov_distr_nml = cd_n_all[si]
        node.edges = []
        node.reads = set()
        node.bx_tmr_fwd = set()
        node.bx_tmr_rev = set()
        node.bx_nml_fwd = set()
        node.bx_nml_rev = set()
        node.hpset_tmr = [0, 0, 0]
        node.hpset_nml = [0, 0, 0]
        node.mate1_name = []
        node.mate2_name = []
        node.readstarts = []
        node_objs[nid] = node
    return node_objs


def build_graph_fast(graph, refinfo) -> None:
    """Equivalent of Graph.buildgraph (fast path; no LR mode)."""
    assert not graph.LR_MODE
    _add_ref_read(graph, refinfo)

    K = graph.K
    minq = graph.MIN_QUAL_CALL

    seqs, quals, metas = _gather(graph)

    if not seqs:
        refinfo.compute_coverage(TMR)
        refinfo.compute_coverage(NML)
        return

    cat, qcat, starts, read_lens = _concat(seqs, quals, K)
    reads_n = len(seqs)
    tot = cat.size

    n_per_read = read_lens - K + 1  # mers per read (all >= 2 here)
    n_mers = int(n_per_read.sum())
    # global concatenated offset of each mer
    read_of = np.repeat(np.arange(reads_n, dtype=np.int32), n_per_read)
    pos_of = (np.arange(n_mers, dtype=np.int32)
              - np.repeat((np.cumsum(n_per_read) - n_per_read).astype(np.int32),
                          n_per_read))
    cat_off = starts[read_of] + pos_of

    Mrows_all = _sliding(cat, K)
    RCrows_all = _sliding(_COMP[cat][::-1], K)[::-1]
    Mrows = Mrows_all[cat_off]
    RCrows = RCrows_all[cat_off]
    neq = Mrows != RCrows
    anyneq = neq.any(axis=1)
    first = neq.argmax(axis=1)
    rows_idx = np.arange(n_mers)
    isF = anyneq & (Mrows[rows_idx, first] < RCrows[rows_idx, first])
    mer_rows = np.where(isF[:, None], Mrows, RCrows)
    Qrows = _sliding(qcat, K)[cat_off]
    q_rows = np.where(isF[:, None], Qrows, Qrows[:, ::-1])
    ori_f = isF

    # per-pair quality gate: whole (K+1)-base window >= minq (gap bytes
    # are 0 -> always below threshold -> cross-read windows self-mask)
    below = (qcat < minq).astype(np.int32)
    cb = np.concatenate([[0], np.cumsum(below)])
    win_ok_all = (cb[K + 1 :] - cb[: -(K + 1)]) == 0
    pairq = np.zeros(n_mers, bool)
    inb = cat_off < win_ok_all.size
    pairq[inb] = win_ok_all[cat_off[inb]]

    # ---- unique nodes ----------------------------------------------------
    n_nodes, node_ids, rep_idx = _unique_mers(mer_rows, K)
    blob = mer_rows[rep_idx].tobytes()
    mer_strings = [blob[i * K : (i + 1) * K].decode("latin-1")
                   for i in range(n_nodes)]

    meta_sample = np.array([m[1] for m in metas], np.int32)
    meta_strand = np.array([m[2] for m in metas], np.int32)
    meta_isref = np.array([m[3] for m in metas], bool)
    meta_order = np.array([m[5] for m in metas], np.int32)

    samp = meta_sample[read_of]
    strand = meta_strand[read_of]
    isref = meta_isref[read_of]
    order = meta_order[read_of]

    read_nmers = n_per_read

    # stream/pair bookkeeping: pair p exists at positions pos < nmers-1
    is_last = pos_of == (read_nmers[read_of] - 1)

    # ---- creation (first-occurrence) times -------------------------------
    # events: as u of pair at (stream) time 2*g, as v of pair (pos-1) at
    # 2*(g-1)+1 where g = global pair index == global mer index here
    g = np.arange(n_mers, dtype=np.int64)
    tu = 2 * g
    tv = 2 * (g - 1) + 1
    t_created = np.where(pos_of == 0, tu, np.minimum(tu, tv))
    t_created = np.where(is_last, tv, t_created)  # last mer: only a v event
    first_time = np.full(n_nodes, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_time, node_ids, t_created)

    # ---- mate-overlap dedup (quirk replay, candidates only) --------------
    # a coverage visit of mer m by read r (order o in {1,2}) is skipped iff
    # std::binary_search over the other-order push list (at that time)
    # finds r's name. Candidates: nodes where both orders pushed the same
    # fragment name.
    skip_visit = np.zeros(n_mers, bool)
    paired_mask = (order > 0) & ~isref
    if paired_mask.any():
        _replay_mate_dedup(graph, metas, node_ids, read_of, pos_of, order,
                           is_last, skip_visit, read_nmers)

    # ---- coverage counters ----------------------------------------------
    cov_visit = ~isref & ~skip_visit
    sel = cov_visit
    fwd_t = np.bincount(node_ids[sel & (samp == TMR) & (strand == FWD)], minlength=n_nodes)
    rev_t = np.bincount(node_ids[sel & (samp == TMR) & (strand == REV)], minlength=n_nodes)
    fwd_n = np.bincount(node_ids[sel & (samp == NML) & (strand == FWD)], minlength=n_nodes)
    rev_n = np.bincount(node_ids[sel & (samp == NML) & (strand == REV)], minlength=n_nodes)

    # per-base minqv counts: [n_nodes, K] per (sample, strand)
    qok = q_rows >= minq

    def base_counts(mask):
        out = np.zeros((n_nodes, K), np.int32)
        if mask.any():
            np.add.at(out, node_ids[mask], qok[mask].astype(np.int32))
        return out

    mqf_t = base_counts(sel & (samp == TMR) & (strand == FWD))
    mqr_t = base_counts(sel & (samp == TMR) & (strand == REV))
    mqf_n = base_counts(sel & (samp == NML) & (strand == FWD))
    mqr_n = base_counts(sel & (samp == NML) & (strand == REV))

    # ---- flags / status --------------------------------------------------
    nml_visit = samp == NML  # unconditional (incl. dedup-skipped visits)
    is_normal = np.zeros(n_nodes, bool)
    is_normal[node_ids[nml_visit]] = True

    # tumor: node gets T when it participates in a quality-clean pair
    # (as u of pair pos, or as v of pair pos-1)
    pair_ok = pairq & (samp == TMR) & ~is_last
    t_nodes = np.zeros(n_nodes, bool)
    if pair_ok.any():
        idx = np.nonzero(pair_ok)[0]
        t_nodes[node_ids[idx]] = True              # u side
        t_nodes[node_ids[idx + 1]] = True          # v side (next mer)
    is_tumor = t_nodes

    # ---- edges -----------------------------------------------------------
    # pair p: u=node_ids[p], v=node_ids[p+1] with dirs from orientations
    pair_sel = ~is_last
    pu = node_ids[pair_sel]
    pidx = np.nonzero(pair_sel)[0]
    pv = node_ids[pidx + 1]
    uF = ori_f[pair_sel]
    vF = ori_f[pidx + 1]
    # dir codes: FF=0 FR=1 RF=2 RR=3
    fdir_code = np.where(uF, np.where(vF, 0, 1), np.where(vF, 2, 3))
    rdir_code = np.where(uF, np.where(vF, 3, 1), np.where(vF, 2, 0))
    tu_pair = 2 * pidx.astype(np.int64)
    tv_pair = tu_pair + 1

    # unique directed (src, dst, dir) with min time
    src = np.concatenate([pu, pv])
    dst = np.concatenate([pv, pu])
    dcode = np.concatenate([fdir_code, rdir_code])
    etime = np.concatenate([tu_pair, tv_pair])
    ekey = (src.astype(np.int64) * n_nodes + dst) * 4 + dcode
    ukey, einv = np.unique(ekey, return_inverse=True)
    emintime = np.full(ukey.shape[0], np.iinfo(np.int64).max, np.int64)
    np.minimum.at(emintime, einv, etime)
    esrc = (ukey // 4) // n_nodes
    edst = (ukey // 4) % n_nodes
    edir = ukey % 4
    eorder = np.lexsort((emintime,))  # stable by time

    # ---- reference mer coverage table ------------------------------------
    refinfo.index_mers()
    mer_in_ref = np.array([m in refinfo.mertable_nml for m in mer_strings])
    for sample, fwd_c, rev_c, table in (
            (TMR, fwd_t, rev_t, refinfo.mertable_tmr),
            (NML, fwd_n, rev_n, refinfo.mertable_nml)):
        seen_f = np.zeros(n_nodes, bool)
        seen_f[node_ids[sel & (samp == sample) & (strand == FWD)]] = True
        seen_r = np.zeros(n_nodes, bool)
        seen_r[node_ids[sel & (samp == sample) & (strand == REV)]] = True
        for nid in np.nonzero(mer_in_ref & (seen_f | seen_r))[0]:
            row = table[mer_strings[nid]]
            if seen_f[nid]:
                row[0] = fwd_c[nid]
            if seen_r[nid]:
                row[1] = rev_c[nid]
    refinfo.compute_coverage(TMR)
    refinfo.compute_coverage(NML)

    # ---- prune decision (removeLowCov semantics, compid 0) ---------------
    # mark_ref_nodes + removeLowCov(False, 0) are fused here: touch_ref is
    # a pure lookup at k-mer stage and component is 0 for all nodes.
    tot_q = mqf_t + mqr_t + mqf_n + mqr_n  # [n_nodes, K]
    mincov_qv = tot_q.min(axis=1)
    tot_cov = fwd_t + rev_t + fwd_n + rev_n
    mincov_all = tot_cov  # fwd/rev broadcast -> per-base total == node total
    avgcov = graph.totalreadbp / len(refinfo.rawseq)
    low = ((mincov_qv <= graph.LOW_COV_THRESHOLD)
           | (mincov_qv <= graph.MIN_COV_RATIO * avgcov)
           | (((fwd_t + rev_t) == 1) & ((fwd_n + rev_n) == 1)))

    # ---- materialize survivors ------------------------------------------
    # map insertion order = node creation order in the visit stream
    create_order = np.argsort(first_time, kind="stable")
    nodes = graph.nodes
    for nid in create_order:
        nodes[mer_strings[nid]] = None
    for nid in np.nonzero(low)[0]:
        del nodes[mer_strings[nid]]

    # adjacency restricted to survivors
    surv = ~low
    edge_keep = surv[esrc] & surv[edst]

    dirs = (FF, FR, RF, RR)
    surv_ids = np.nonzero(surv)[0]
    ns = surv_ids.size
    # bulk per-base coverage blocks; nodes keep views (never mutated
    # in place after build — compress reassigns whole arrays)
    cd_t_all = np.zeros((ns, K, 10), np.int32)
    cd_n_all = np.zeros((ns, K, 10), np.int32)
    cd_t_all[:, :, 0] = fwd_t[surv_ids, None]
    cd_t_all[:, :, 1] = rev_t[surv_ids, None]
    cd_t_all[:, :, 2] = mqf_t[surv_ids]
    cd_t_all[:, :, 3] = mqr_t[surv_ids]
    cd_n_all[:, :, 0] = fwd_n[surv_ids, None]
    cd_n_all[:, :, 1] = rev_n[surv_ids, None]
    cd_n_all[:, :, 2] = mqf_n[surv_ids]
    cd_n_all[:, :, 3] = mqr_n[surv_ids]
    node_objs = _materialize_nodes(
        graph, mer_strings, surv_ids, K, minq, fwd_t, rev_t, fwd_n, rev_n,
        is_tumor, is_normal, mer_in_ref, mincov_all, mincov_qv,
        cd_t_all, cd_n_all)

    for ei in eorder:
        if not edge_keep[ei]:
            continue
        s_id = int(esrc[ei])
        e = Edge(mer_strings[int(edst[ei])], dirs[int(edir[ei])])
        node_objs[s_id].edges.append(e)

    for nid, node in node_objs.items():
        nodes[node.nodeid] = node


def _replay_mate_dedup(graph, metas, node_ids, read_of, pos_of, order,
                       is_last, skip_visit, read_nmers) -> None:
    """Exact replay of hasOverlappingMate for candidate nodes.

    Per pair (u = mer i, v = mer i+1) the reference executes, in order:
    push(u, name, order); push(v, name, order); [pos==0] probe(u);
    probe(v) — probes run std::binary_search over the OTHER mate-order's
    push-ordered (unsorted) list (Graph.cc:232-317, Node.cc:638-671).
    Each mer gets exactly one coverage probe: at its u-event when pos==0,
    else at its v-event of the previous pair.

    Only nodes where both mate orders pushed a shared fragment name can
    ever probe true; the replay runs just for those (zero cost for
    unpaired libraries)."""
    names = [m[4] for m in metas]
    by_node: dict[int, list[int]] = {}
    cand = set()
    seen = ({}, {})  # order 1, order 2 -> node -> set(names)
    for i in range(node_ids.shape[0]):
        o = int(order[i])
        if o == 0:
            continue
        nid = int(node_ids[i])
        nm = names[read_of[i]]
        by_node.setdefault(nid, []).append(i)
        seen[o - 1].setdefault(nid, set()).add(nm)
        if nm in seen[2 - o].get(nid, ()):
            cand.add(nid)

    for nid in cand:
        # event timeline for this node: (time, kind, mer_idx)
        # kind 0 = push, 1 = probe
        events: list[tuple[int, int, int]] = []
        for i in by_node[nid]:
            p = int(pos_of[i])
            if not bool(is_last[i]):
                events.append((4 * i, 0, i))           # push as u of pair i
            if p > 0:
                events.append((4 * (i - 1) + 1, 0, i))  # push as v of prev pair
            if p == 0:
                events.append((4 * i + 2, 1, i))        # probe at u-event
            else:
                events.append((4 * (i - 1) + 3, 1, i))  # probe at v-event
        events.sort()
        mate1: list[str] = []
        mate2: list[str] = []
        for _, kind, i in events:
            o = int(order[i])
            nm = names[read_of[i]]
            if kind == 0:
                (mate1 if o == 1 else mate2).append(nm)
            else:
                other = mate2 if o == 1 else mate1
                if std_binary_search(other, nm):
                    skip_visit[i] = True
