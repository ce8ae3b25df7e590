"""Device per-k assembly pipeline in PyTorch ops: from gpu.dbg.build_k's
node/edge tables and the host map-order ranks, through the cleanup stages
(gpu.stages) and the path cover, to PathJob tensors. The JAX package's
`tpu/pipeline.py`, function for function.

Per k attempt: components -> per-comp anchoring/clip/wiring -> cycle gate
#1 -> compress -> removeLowCov(true) -> compress -> removeTips fixpoint ->
removeShortLinks (STR-guarded) -> cycle gate #2 -> best-new-edge path
cover (bounded BFS frontier) -> path/coverage materialization
(ref: Microassembler.cc:73-249 processGraph).

Two functions are sequential walks: `path_cover` (the eka/BFS cover) and
`_is_almost_repeat_paths` (isAlmostRepeat on the path strings). On a CUDA
tensor each launches its hand-written kernel (gpu.walks: K1 `path_cover`,
K3 `almost_repeat_paths`); on the CPU it runs its plain version here
(`path_cover_plain`, `almost_repeat_plain`), the JAX lockstep loop step
for step. The cleanup's loops (the removeTips fixpoint and the short-link
stage under its gate) run on the card as gpu.cleanup's kernels, with no
host read; their plain versions here (`tip_fixpoint_plain`,
`short_link_stage_plain`, and `cleanup_plain` for the whole cleanup) turn
`lax.cond` into a host `if` on a device predicate.
"""

from __future__ import annotations

import torch

from . import stages
from .dbg import nwords
from .stages import BIG, _ar, _take, destbit, startbit

# compact-state caps (stages.compact_state): regular items / edges the
# post-compress graph may hold before the lane replays natively
NCR_DEFAULT = 512
ECR_DEFAULT = 1536

# unitig string cap and candidates per window of the short-link STR guard
_SL_CAP = 64
_SL_ITEMS = 64


def _extend_items(b, ranks, W, N, Cmax, K):
    """Build tables -> item/edge/mer state dict (item axis NI)."""
    NI = N + 2 * Cmax
    pad = NI - N
    dev = b["alive"].device

    def ext(a, fill):
        z = torch.full((W, pad) + tuple(a.shape[2:]), fill, dtype=a.dtype,
                       device=dev)
        return torch.cat([a, z], dim=1)

    counts = b["counts"]
    st = dict(
        alive=ext(b["alive"], False),
        special=torch.zeros((W, NI), dtype=torch.bool, device=dev),
        rank=ext(ranks, 1 << 28) if ranks.shape[1] == N else ranks,
        merlen=ext(b["alive"].to(torch.int64), 0),
        csum=ext(counts, 0),
        n_t=ext((b["is_tumor"] & ~b["is_normal"]).to(torch.int64), 0),
        is_tumor=ext(b["is_tumor"], False),
        is_normal=ext(b["is_normal"], False),
        mer_item=_ar(N, dev)[None].expand(W, N).clone(),
        mer_flip=torch.zeros((W, N), dtype=torch.bool, device=dev),
        mer_pos=torch.zeros((W, N), dtype=torch.int64, device=dev),
        keep_lo=torch.zeros((W, N), dtype=torch.int64, device=dev),
        mer_tot=counts.sum(dim=-1),
        mer_totq=b["totq"],
        mer_base=_mer_bases(b["mers_w"], K),
    )
    return st, NI


def _mer_bases(words, K):
    """gpu.dbg's packed words -> [W, N, K] canonical base codes."""
    NW = nwords(K)
    outs = []
    for j in range(K):
        q = K - 1 - j
        outs.append((words[NW - 1 - q // 31] >> (2 * (q % 31))) & 3)
    return torch.stack(outs, dim=-1)


def _extend_edges(st, b, W, E, N, Cmax, K):
    EE = E + 4 * Cmax
    pad = EE - E
    dev = b["alive"].device

    def ext(a, fill):
        return torch.cat([a, torch.full((W, pad), fill, dtype=a.dtype,
                                        device=dev)], dim=1)

    alive_n = b["alive"]
    es, ed = b["edge_src"], b["edge_dst"]
    ea = (b["edge_exists"]
          & _take(alive_n, torch.clamp(es, 0, N - 1))
          & _take(alive_n, torch.clamp(ed, 0, N - 1)))
    st["e_src"] = ext(torch.where(ea, es, 0), 0)
    st["e_dst"] = ext(torch.where(ea, ed, 0), 0)
    st["e_dir"] = ext(b["edge_dir"], 0)
    st["e_alive"] = ext(ea, False)
    st["e_okey"] = ext(_ar(E, dev)[None].expand(W, E), BIG)
    st["keep_hi"] = torch.full((W, N), K, dtype=torch.int64, device=dev)
    return st, EE


def cleanup(st, K, N, NI, cfg_s, avgcov, U=256, D2=24, TIP_ROUNDS=6,
            pre_fb=None):
    """lowcov(true) -> compress -> tips fixpoint -> short links -> compress
    (ref: Microassembler.cc:184-198). Returns (st, fallback). `st` is
    already compressed once (run_attempt's compress #1, shared with the
    cycle screen); `pre_fb` is that compress's fallback.

    On a CUDA tensor eight launches and no host read: low_cov_pass,
    compress_round, tip_fixpoint (the tips fixpoint and its verify pass),
    item_mincovs, short_link_strings (the short-link candidates, their gate
    and the STR guard's strings), tandem_at, the guard's scatter (torch
    ops) and tip_fixpoint (the links stage under the gate, in place on the
    tips fixpoint's fresh outputs); gpu.cleanup holds the two loops'
    kernels. On the CPU each stage and loop runs its plain version.
    cleanup_plain is the same cleanup with host bools."""
    from . import cleanup as loops

    st, _ = stages.low_cov_pass(st, K, N, NI, cfg_s["low_cov_threshold"],
                                cfg_s["min_cov_ratio"], avgcov)
    st, fb = stages.compress_round(st, K, NI, N)
    fallback = fb if pre_fb is None else fb | pre_fb
    st, fallback = loops.tip_fixpoint(st, ("tips", cfg_s["max_tip_len"]), K,
                                      N, NI, U, D2, TIP_ROUNDS, fallback)
    mincov, _ = stages.item_mincovs(st, K, N, NI)
    thr = torch.floor(torch.sqrt(avgcov)).to(torch.int64)
    max_link = cfg_s["max_link_len"]
    strings = loops.short_link_strings(st, mincov, thr, K, NI, max_link)
    guard = _short_link_str_guard(
        st, None, K, N, NI, cfg_s["max_unit_len"],
        cfg_s["min_report_units"], cfg_s["min_report_len"],
        cfg_s["dist_from_str"], strings=strings)
    return loops.tip_fixpoint(
        st, ("links", max_link, mincov, thr, guard, strings["pre_any"]), K,
        N, NI, U, D2, TIP_ROUNDS, fallback, inplace=True)


def cleanup_plain(st, K, N, NI, cfg_s, avgcov, U=256, D2=24, TIP_ROUNDS=6,
                  pre_fb=None):
    """cleanup as the JAX composition with host bools: the tips rounds and
    the short-link stage's gate read the card (a bool a round, one for the
    gate), and the stages dispatch as ever (kernels on a CUDA tensor, plain
    versions on the CPU)."""
    W = st["alive"].shape[0]
    dev = st["alive"].device
    fallback = torch.zeros((W,), dtype=torch.bool, device=dev)
    if pre_fb is not None:
        fallback |= pre_fb

    st, _ = stages.low_cov_pass(st, K, N, NI, cfg_s["low_cov_threshold"],
                                cfg_s["min_cov_ratio"], avgcov)
    st, fb = stages.compress_round(st, K, NI, N)
    fallback |= fb

    # removeTips fixpoint (Graph.cc:2885-2926)
    st, fallback = _tips_rounds(st, cfg_s["max_tip_len"], K, N, NI, U, D2,
                                TIP_ROUNDS, fallback, stages._seq_removal_pass,
                                stages.compress_round)

    # removeShortLinks (Graph.cc:2833-2880)
    mincov, _ = stages.item_mincovs(st, K, N, NI)
    thr = torch.floor(torch.sqrt(avgcov)).to(torch.int64)
    max_link = cfg_s["max_link_len"]
    cand, pre = _short_link_pre(st, mincov, thr, NI, max_link)
    # a kill needs initial degree >= 2 (the sweep only decrements) with
    # mincov <= thr: with no such item the whole stage is a no-op
    if bool(pre.any()):
        guard = _short_link_str_guard(
            st, cand, K, N, NI, cfg_s["max_unit_len"],
            cfg_s["min_report_units"], cfg_s["min_report_len"],
            cfg_s["dist_from_str"])
        st, fallback = _links_round(
            st, (max_link, mincov, thr, guard), K, N, NI, U, D2, fallback,
            stages._seq_removal_pass, stages.compress_round)
    return st, fallback


def _tips_rounds(st, max_tip, K, N, NI, U, D2, rounds, fallback, removal,
                 compress):
    """The removeTips fixpoint with `removal` (a removal pass's function)
    and `compress` (compress_round's): a removal-free round ends it (the
    graph is then compressed already); a hit compresses; after a last round
    that hit, one more pass must remove nothing (its state not kept).
    Returns (st, fallback)."""
    r, last_hit = 0, True
    while r < rounds and (r == 0 or last_hit):
        st, removed_any, over = removal(st, ("tips", st["merlen"], max_tip),
                                        U, D2)
        fallback = fallback | over
        last_hit = bool(removed_any.any())
        if last_hit:
            st, fb = compress(st, K, NI, N)
            fallback = fallback | fb
        r += 1
    # non-convergence check (a last round that removed nothing was that
    # check already)
    if last_hit:
        _, removed_any, over = removal(st, ("tips", st["merlen"], max_tip),
                                       U, D2)
        fallback = fallback | removed_any | over
    return st, fallback


def _links_round(st, links, K, N, NI, U, D2, fallback, removal, compress):
    """The removeShortLinks pass and its compress; links = (max_link,
    mincov, thr, guard). Returns (st, fallback)."""
    max_link, mincov, thr, guard = links
    st, _, over = removal(
        st, ("links", st["merlen"], max_link, mincov, thr, guard), U, D2)
    st, fb = compress(st, K, NI, N)
    return st, fallback | over | fb


def _short_link_pre(st, mincov, thr, NI, max_link):
    """The short-link candidates (alive, not special, 0 < merlen <
    max_link) and pre: a candidate of initial degree >= 2 with mincov <=
    thr, the only items the links pass can kill. Returns (cand, pre), [W,
    NI] bool."""
    W = st["alive"].shape[0]
    merlen = st["merlen"]
    cand = (st["alive"] & ~st["special"] & (merlen < max_link)
            & (merlen > 0))
    deg0 = stages.scatter_add(
        NI + 1, torch.where(st["e_alive"], st["e_src"], NI),
        st["e_alive"].to(torch.int64), W)[:, :NI]
    return cand, cand & (deg0 >= 2) & (mincov <= thr[:, None])


def tip_fixpoint_plain(st, cond, K, N, NI, U, D2, rounds, fallback, Dcap=64):
    """The plain version of the tip_fixpoint kernel (gpu.cleanup): cond
    ("tips", max_tip) runs the tips fixpoint and its verify pass, cond
    ("links", max_link, mincov, thr, guard, gate) the links pass and its
    compress where gate [W] has a set lane; both with the removal pass's
    and compress_round's plain versions, reading the card for each round's
    hit and for the gate. Returns (st, fallback | the passes' flags)."""
    def compress(s, K_, NI_, N_):
        return stages.compress_round_plain(s, K_, NI_, N_, Dcap)

    if cond[0] == "tips":
        return _tips_rounds(st, cond[1], K, N, NI, U, D2, rounds, fallback,
                            stages.seq_removal_pass_plain, compress)
    if not bool(cond[5].any()):
        return dict(st), fallback.clone()
    return _links_round(st, cond[1:5], K, N, NI, U, D2, fallback,
                        stages.seq_removal_pass_plain, compress)


def run_attempt(b, ranks, K, N, E, Cmax, cfg_s, NCR=NCR_DEFAULT,
                ECR=ECR_DEFAULT):
    """One k attempt past the build: components through cycle gate #2.

    b = build_k outputs; ranks [W, N] host map-order ranks. Returns (st,
    res): st is the COMPACT post-cleanup state (item axis NCR + 2*Cmax,
    anchors at slots NCR+2c/NCR+2c+1: pass N=NCR to path_cover), res the
    per-comp flags and anchor data. Lanes whose post-compress survivor
    counts exceed the compact caps are folded into res["fallback"]."""
    W = b["alive"].shape[0]
    st, NI = _extend_items(b, ranks, W, N, Cmax, K)
    st, EE = _extend_edges(st, b, W, E, N, Cmax, K)

    comp, numcomp, over_c = stages.components(
        st["alive"], st["e_src"], st["e_dst"], st["e_alive"], st["rank"],
        Cmax)
    ends = stages.ref_ends(
        b["nid_proj"], b["proj_isF"], b["rawlen_dev"], K, comp,
        st["alive"], st["csum"], st["merlen"], cfg_s["cov_threshold"], Cmax)
    (st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"], st["e_okey"],
     st["special"], st["alive"], comp) = stages.wire_anchors(
        ends, N, Cmax, st["e_src"], st["e_dst"], st["e_dir"],
        st["e_alive"], st["e_okey"], st["special"], st["alive"], comp)
    st["comp"] = comp

    # source and sink anchored at the same node: the compress tandem dance
    # that follows is not replicated -- rare; route to native
    same_anchor = (ends["anchored"]
                   & (ends["src_nid"] == ends["snk_nid"])).any(dim=1)

    # cycle gates: the parallel screen proves the common case clean on a
    # compressed copy (compression keeps walk cycles and dual-orientation
    # reach); that copy IS cleanup's compress #1, computed once
    st_c1, fb_c1 = stages.compress_round(dict(st), K, NI, N)
    st_cp, over_cp, dead_cp = stages.compact_state(st_c1, N, NI, Cmax, NCR,
                                                   ECR)
    NIc = NCR + 2 * Cmax
    scr1 = stages.cycle_screen(
        st_cp["e_src"], st_cp["e_dst"], st_cp["e_dir"], st_cp["e_alive"],
        st_cp["alive"], st_cp["special"], st_cp["comp"], NCR, NIc,
        Cmax) | (fb_c1 | over_cp)[:, None]
    cyc1, over_p1 = stages.has_cycle_seq(
        st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"], st["e_okey"],
        st["alive"], st["special"], N, NI, Cmax, lane_mask=scr1)

    avgcov = b["avgcov"]
    st, fb_clean = cleanup(st_cp, K, N, NIc, cfg_s, avgcov, pre_fb=fb_c1)

    scr2 = stages.cycle_screen(
        st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"], st["alive"],
        st["special"], st["comp"], NCR, NIc, Cmax)
    cyc2, over_p2 = stages.has_cycle_seq(
        st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"], st["e_okey"],
        st["alive"], st["special"], NCR, NIc, Cmax, D2=24, lane_mask=scr2)

    fallback = (b["fallback"] | over_c | over_p1 | over_p2 | fb_clean
                | over_cp | same_anchor)
    res = dict(cyc1=cyc1, cyc2=cyc2, ends=ends, numcomp=numcomp,
               fallback=fallback)
    res["dead_edge"] = dead_cp  # compact_state's hold-point
    return st, res


def path_cover(st, res, K, N, NI, Cmax, reflens, dfs_limit, max_indel,
               Q=512, POPMAX=1024, JMAX=8, PN=24, D2=24):
    """Best-new-edge path cover (ref: Graph.cc:1299-1501 bfs/eka). Per
    window, components are walked in order; each eka round re-runs the BFS
    with the live covered-edge set, keeps the first-found best-scoring
    complete path and marks its edges. The adjacency table is torch ops;
    the walk is the `path_cover` kernel on a CUDA tensor (gpu.walks), else
    path_cover_plain.

    Returns dict: sel_edges [W, JMAX, PN] (edge ids, source-first),
    sel_hops, sel_comp [W, JMAX], n_sel [W], fallback [W]."""
    from . import walks

    ends = res["ends"]
    runnable = ends["anchored"] & ~res["cyc1"] & ~res["cyc2"]  # [W, Cmax]
    adj, over_d = stages.okey_adjacency(
        st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"], st["e_okey"],
        NI, D2)
    out = walks.path_cover(adj, st["e_dst"], st["e_dir"], st["merlen"],
                           st["special"], runnable, res["numcomp"], reflens,
                           K=K, N=N, Cmax=Cmax, dfs_limit=dfs_limit,
                           max_indel=max_indel, Q=Q, POPMAX=POPMAX,
                           JMAX=JMAX, PN=PN)
    out["fallback"] = out["fallback"] | over_d
    return out


def path_cover_plain(adj, e_dst, e_dir, merlen, special, runnable, numcomp,
                     reflens, *, K, N, Cmax, dfs_limit, max_indel, Q, POPMAX,
                     JMAX, PN, counts=None):
    """The path cover walk's plain version, the JAX lockstep loops step
    for step: OUTER rounds of (comp advance | eka round), each a BFS of at
    most POPMAX lockstep pops over a Q-entry queue, then the parent walk
    of the best entry. Returns the dict of path_cover (fallback without
    the adjacency overflow). With a `counts` dict, adds the pops of all
    lanes to counts["pops"] and those of each window to
    counts["lanes"]["pops"] [W], and marks the input elements the walk
    reads (stages.touch: "adj_rows", "e_dir", "e_dst", and "nodes" for
    merlen and special)."""
    W, NI, D2 = adj.shape
    EE = e_dst.shape[1]
    dev = adj.device
    i64 = torch.int64
    wrow = _ar(W, dev)
    w2 = wrow[:, None]
    sb_all = startbit(e_dir)
    db_all = destbit(e_dir)

    def full(shape, v, dtype=i64):
        return torch.full(shape, v, dtype=dtype, device=dev)

    sel_edges = full((W, JMAX, PN), -1)
    sel_hops = full((W, JMAX), 0)
    sel_comp = full((W, JMAX), 0)
    n_sel = full((W,), 0)
    covered = full((W, EE), False, torch.bool)
    fallback = full((W,), False, torch.bool)
    c_w = full((W,), 1)
    for _ in range(Cmax + JMAX + 2):
        in_range = c_w <= numcomp
        cidx = torch.clamp(c_w - 1, 0, Cmax - 1)
        lane_on = in_range & runnable[wrow, cidx]

        # ---- one eka round of BFS for all lanes ----
        src_item = N + 2 * (c_w - 1)
        sink_item = src_item + 1
        reflen = reflens[wrow, cidx]
        # queue arrays carry one drop slot at Q
        qi = full((W, Q + 1), 0)
        qi[:, 0] = src_item
        qd = full((W, Q + 1), 0)
        qp = full((W, Q + 1), -1)
        qe = full((W, Q + 1), -1)
        ql = full((W, Q + 1), 0)
        ql[:, 0] = K
        qf = full((W, Q + 1), False, torch.bool)
        qf[:, 0] = True
        qs = full((W, Q + 1), 0)
        head = full((W,), 0)
        tail = full((W,), 1)
        visits = full((W,), 0)
        bi = full((W,), -1)
        bs = full((W,), 0)
        over_q = full((W,), False, torch.bool)
        on = lane_on.clone()
        pops = 0
        while pops < POPMAX and bool((on & (head < tail)).any()):
            act = on & (head < tail)
            visits = visits + act.to(i64)
            lim = act & (visits > dfs_limit)
            on = on & ~lim
            act = act & ~lim
            if counts is not None:
                counts["pops"] = counts.get("pops", 0) + int(act.sum())
                counts.setdefault("lanes", {}).setdefault(
                    "pops", torch.zeros(W, dtype=i64, device=dev)).add_(act)
            hs = torch.clamp(head, 0, Q - 1)
            it, dr, ln = qi[wrow, hs], qd[wrow, hs], ql[wrow, hs]
            fl, sc = qf[wrow, hs], qs[wrow, hs]
            at_sink = act & (it == sink_item) & ~fl
            better = at_sink & ((bi < 0) | (sc > bs))
            bi = torch.where(better, head, bi)
            bs = torch.where(better, sc, bs)
            expand = act & ~at_sink & ~(ln > reflen + max_indel)
            e = adj[wrow, torch.clamp(it, 0, NI - 1), :]  # [W, D2]
            es = torch.clamp(e, 0, EE - 1)
            okc = (expand[:, None] & (e >= 0)
                   & (sb_all[w2, es] == dr[:, None]))
            dst = e_dst[w2, es]
            dsts = torch.clamp(dst, 0, NI - 1)
            nlen = ln[:, None] + torch.where(special[w2, dsts], 1 - K,
                                             merlen[w2, dsts])
            cov_e = covered[w2, es]
            pos = torch.cumsum(okc.to(i64), dim=1) - okc.to(i64)
            tgt = tail[:, None] + pos
            wr = okc & (tgt < Q)
            over_q |= (okc & (tgt >= Q)).any(dim=1)
            tgt_w = torch.where(wr, tgt, Q)
            qi[w2, tgt_w] = dst
            qd[w2, tgt_w] = db_all[w2, es]
            qp[w2, tgt_w] = head[:, None].expand(W, D2)
            qe[w2, tgt_w] = e
            ql[w2, tgt_w] = nlen
            qf[w2, tgt_w] = fl[:, None] & cov_e
            qs[w2, tgt_w] = sc[:, None] + (~cov_e).to(i64)
            if counts is not None:
                stages.touch(counts, "adj_rows", NI,
                             torch.clamp(it, 0, NI - 1)[:, None],
                             expand[:, None])
                stages.touch(counts, "e_dir", EE, es,
                             expand[:, None] & (e >= 0))
                stages.touch(counts, "e_dst", EE, es, wr)
                stages.touch(counts, "nodes", NI, dsts, wr)
            tail = tail + wr.sum(dim=1)
            head = head + act.to(i64)
            pops += 1
        # POPMAX hit with work left = unfaithful enumeration -> fallback
        over_q |= on & (head < tail)

        fallback |= over_q
        has = lane_on & (bi >= 0) & ~over_q
        # walk parents of the best entry, marking covered and recording
        cur = torch.where(has, bi, -1)
        hopbuf = full((W, PN), -1)
        nh = full((W,), 0)
        for p in range(PN):
            cs = torch.clamp(cur, 0, Q - 1)
            e = qe[wrow, cs]
            oke = (cur >= 0) & (e >= 0)
            ce = torch.clamp(e, 0, EE - 1)
            covered[wrow, ce] = covered[wrow, ce] | oke
            hopbuf[:, p] = torch.where(oke, e, -1)
            nh = nh + oke.to(i64)
            cur = torch.where(oke, qp[wrow, cs], -1)
        fallback |= cur >= 0  # path longer than PN
        over_j = has & (n_sel >= JMAX)
        fallback |= over_j
        slot = torch.clamp(n_sel, 0, JMAX - 1)
        put = has & ~over_j
        # reverse hop order (the walk collected sink-first)
        src_pos = nh[:, None] - 1 - _ar(PN, dev)[None, :]
        rbuf = torch.where(src_pos >= 0,
                           _take(hopbuf, torch.clamp(src_pos, 0, PN - 1)), -1)
        sel_edges[wrow, slot] = torch.where(put[:, None], rbuf,
                                            sel_edges[wrow, slot])
        sel_hops[wrow, slot] = torch.where(put, nh, sel_hops[wrow, slot])
        sel_comp[wrow, slot] = torch.where(put, c_w, sel_comp[wrow, slot])
        n_sel = n_sel + put.to(i64)
        # no path (or a skipped comp) -> advance to the next comp
        c_w = torch.where(lane_on & has, c_w, c_w + 1)
    # windows still mid-walk after OUTER rounds: over budget
    fallback |= c_w <= numcomp
    return dict(sel_edges=sel_edges, sel_hops=sel_hops, sel_comp=sel_comp,
                n_sel=n_sel, fallback=fallback)


def _donor_tables(st, K, N, NI, US, LU):
    """Per-unitig base->donor maps, packed: [W, US, LU] records (mer id <<
    13 | flip << 12 | pos + 8, -1 = none), slot_of_item [W, NI] (-1 =
    not alive / over cap), the overflow flag and the bad_pos flag [W]. One
    scatter of each mer's record at its donor interval's START, then a
    last-valid forward fill along the base axis (the intervals partition
    each unitig's bases)."""
    W = st["alive"].shape[0]
    dev = st["alive"].device
    alive = st["alive"] & ~st["special"]
    key = torch.where(alive, _ar(NI, dev)[None], BIG)
    order = torch.argsort(key, dim=1, stable=True)[:, :US]
    n_alive = alive.sum(dim=1)
    slot_ok = _ar(US, dev)[None] < n_alive[:, None]
    over = n_alive > US
    # item NI-1 is an anchor (never a regular item): rejected slots write
    # their -1 there
    slot_of_item = torch.full((W, NI), -1, dtype=torch.int64, device=dev)
    slot_of_item.scatter_(1, torch.where(slot_ok, order, NI - 1),
                          torch.where(slot_ok, _ar(US, dev)[None], -1))
    mi = torch.clamp(st["mer_item"], 0, NI - 1)
    mslot = _take(slot_of_item, mi)
    klo, khi = st["keep_lo"], st["keep_hi"]
    flip, pos = st["mer_flip"], st["mer_pos"]
    NM = mi.shape[1]
    midx = _ar(NM, dev)[None].expand(W, NM)
    keep = (khi > klo) & (mslot >= 0)
    start = pos + klo  # first donated base in unitig coords
    over_lu = (keep & (pos + khi > LU)).any(dim=1)
    wr = keep & (start < LU)
    # hold-point: the packed record's pos field is pos + 8 in 12 bits; a
    # written pos below -8 would corrupt the flip and id bits (lanes that
    # have one are returned in bad_pos; materialize_jobs asserts)
    assert NM <= 4096 and LU + 8 < 4096
    bad_pos = (wr & (pos < -8)).any(dim=1)
    rec = (midx << 13) | (flip.to(torch.int64) << 12) | (pos + 8)
    # one record per (slot, base) start: the donor intervals partition the
    # unitig, so the amax only names the winner explicitly
    starts = torch.full((W, (US + 1) * LU), -1, dtype=torch.int64,
                        device=dev)
    flat = (torch.where(wr, mslot, US) * LU
            + torch.clamp(start, 0, LU - 1))
    starts.scatter_reduce_(1, flat, torch.where(wr, rec, -1), "amax")
    starts = starts.reshape(W, US + 1, LU)[:, :US]
    # last-valid forward fill along the base axis
    last = torch.cummax(torch.where(starts >= 0, _ar(LU, dev), -1),
                        dim=2).values
    filled = torch.where(last >= 0,
                         torch.gather(starts, 2, torch.clamp(last, min=0)),
                         -1)
    return filled, slot_of_item, over | over_lu, bad_pos


def materialize_jobs(st, b, paths, res, K, N, NI, Cmax, raw, max_mismatch,
                     LP=1728, US=96, LU=1536, PN=24):
    """Selected paths -> job tensors: pathseq codes, covT/covN [LP,4],
    tumor_span [LP+1], needs_dp, is_rep (ref Graph.cc:686-730,
    util.cc:317-360), per-path comp and the comp's trim data."""
    W, JMAX, _ = paths["sel_edges"].shape
    dev = raw.device
    donor_packed, slot_of_item, over_dt, bad_pos = _donor_tables(
        st, K, N, NI, US, LU)
    fallback = paths["fallback"] | over_dt

    e_dst, e_dir = st["e_dst"], st["e_dir"]
    merlen, special = st["merlen"], st["special"]
    wrow3 = _ar(W, dev)[:, None, None]
    hops = paths["sel_edges"]  # [W, J, PN]
    hsafe = torch.clamp(hops, 0, e_dst.shape[1] - 1)
    hvalid = hops >= 0
    nd = torch.where(hvalid, e_dst[wrow3, hsafe], 0)  # node per hop
    nori = torch.where(hvalid, destbit(e_dir[wrow3, hsafe]), 0)
    nds = torch.clamp(nd, 0, NI - 1)
    nspec = special[wrow3, nds] | ~hvalid
    Lh = torch.where(nspec, 0, merlen[wrow3, nds] + K - 1)
    first_ns = (~nspec) & (torch.cumsum((~nspec).to(torch.int64), dim=2) == 1)
    contrib = torch.where(nspec, 0, torch.where(first_ns, Lh, Lh - (K - 1)))
    cum = torch.cumsum(contrib, dim=2)  # [W, J, PN]
    Lp = cum[:, :, -1]
    fallback = fallback | (Lp > LP).any(dim=1)

    p = _ar(LP, dev)[None, None, :]
    # hidx[p] = #hops with cum <= p: (h+1) scattered at cum[h] (max wins)
    # and forward-filled with a running max
    hop1 = _ar(PN, dev)[None, None, :].expand(W, JMAX, PN) + 1
    hseed = torch.zeros((W, JMAX, LP + 1), dtype=torch.int64, device=dev)
    hseed.scatter_reduce_(2, torch.where(cum < LP, cum, LP), hop1, "amax")
    hidx = torch.cummax(hseed[:, :, :LP], dim=2).values
    hclip = torch.clamp(hidx, 0, PN - 1)
    cumbefore = torch.where(
        hidx > 0, torch.gather(cum, 2, torch.clamp(hidx - 1, 0, PN - 1)), 0)
    nd_p = torch.gather(nd, 2, hclip)
    ori_p = torch.gather(nori, 2, hclip)
    first_p = torch.gather(first_ns, 2, hclip)
    Lh_p = torch.gather(Lh, 2, hclip)
    off = p - cumbefore + torch.where(first_p, 0, K - 1)
    uidx = torch.where(ori_p == 1, Lh_p - 1 - off, off)
    slot_p = slot_of_item[wrow3, torch.clamp(nd_p, 0, NI - 1)]
    pvalid = (p < Lp[:, :, None]) & (slot_p >= 0)
    ls = torch.clamp(slot_p, 0, US - 1)
    lu = torch.clamp(uidx, 0, LU - 1)
    fp = donor_packed[wrow3, ls, lu]
    dm = torch.where(fp >= 0, fp >> 13, -1)
    dfl = ((fp >> 12) & 1) == 1
    dpos = (fp & 0xFFF) - 8
    dci = torch.where(dfl, K - 1 - (lu - dpos), lu - dpos)
    dm_ok = pvalid & (dm >= 0)
    dms = torch.clamp(dm, 0, N - 1)
    dcis = torch.clamp(dci, 0, K - 1)
    # hold-points, on the lanes whose jobs are used: no donor pos below -8
    # (_donor_tables), and the forward fill never bridges a gap between
    # donor intervals (every path base lies in its donor mer's kept
    # interval)
    inmer = lu - dpos
    gap = dm_ok & ((inmer < st["keep_lo"][wrow3, dms])
                   | (inmer >= st["keep_hi"][wrow3, dms]))
    # and compact_state's (stages.compact_state: no alive edge of a lane
    # within the caps touches a dead item; a result without the flag, as
    # the JAX engine's, folds it into fallback); one sync for all
    used = ~(fallback | res["fallback"])
    dead = res.get("dead_edge", torch.zeros_like(used))
    bad = torch.stack([(used & bad_pos).any(),
                       (used & gap.any(dim=2).any(dim=1)).any(),
                       dead.any()]).tolist()
    assert not bad[0], "a donor pos below -8"
    assert not bad[1], "a path base fell between donor intervals"
    assert not bad[2], "an alive edge touches a dead item"
    ch = st["mer_base"][wrow3, dms, dcis]
    comp_flip = (dfl & (dm >= 0)) ^ (ori_p == 1)
    pathseq = torch.where(dm_ok, torch.where(comp_flip, ch ^ 3, ch), 4)
    cnt_g = torch.where(dm_ok[..., None], b["counts"][wrow3, dms], 0)
    mq_g = torch.where(dm_ok[..., None],
                       b["mq"][wrow3, dms, dcis].to(torch.int64), 0)
    covT = torch.stack([cnt_g[..., 0], cnt_g[..., 1],
                        mq_g[..., 0], mq_g[..., 1]], dim=-1)
    covN = torch.stack([cnt_g[..., 2], cnt_g[..., 3],
                        mq_g[..., 2], mq_g[..., 3]], dim=-1)

    # tumor_span [W, J, LP+1]: is_T of the node holding each position
    isT_item = (5 * st["n_t"]) > (4 * torch.clamp(merlen, min=1))
    isT = isT_item[wrow3, nds] & ~nspec
    hspan = torch.cat([torch.zeros((W, JMAX, 1), dtype=torch.int64,
                                   device=dev), hidx], dim=2)
    ps = _ar(LP + 1, dev)[None, None, :]
    span = (torch.gather(isT, 2, torch.clamp(hspan, 0, PN - 1))
            & (hspan < PN) & (ps <= Lp[:, :, None]))

    # needs_dp: hamming vs the comp's trimmed ref slice
    comp_j = paths["sel_comp"]  # [W, J] 1-based
    ends = res["ends"]
    cj = torch.clamp(comp_j - 1, 0, Cmax - 1)
    src_pos = _take(ends["src_pos"], cj)
    dist = _take(ends["dist"], cj)
    rp = torch.clamp(src_pos[:, :, None] + p, 0, raw.shape[1] - 1)
    refch = raw.to(torch.int64)[wrow3, rp]
    mis = ((refch != pathseq) & (p < dist[:, :, None])).sum(dim=2)
    needs_dp = (Lp != dist) | (mis > 5)

    is_rep = _is_almost_repeat_paths(pathseq, Lp, K, max_mismatch, LP)
    return dict(pathseq=pathseq, lp=Lp, covT=covT, covN=covN, span=span,
                needs_dp=needs_dp, is_rep=is_rep, trim5=src_pos,
                src_pos=src_pos, dist=dist, n_sel=paths["n_sel"],
                sel_comp=comp_j, fallback=fallback)


def _is_almost_repeat_paths(seq, lens, K, max_mismatch, LP):
    """isAlmostRepeat on path strings (ref: util.cc:317-360): any two
    (K+1)-windows at offsets p < p+d (both <= L-K-1) with <= max_mismatch
    mismatches. The `almost_repeat_paths` kernel on a CUDA tensor
    (gpu.walks), else almost_repeat_plain. Returns [W, J] bool."""
    from . import walks

    return walks.almost_repeat(seq, lens, K, max_mismatch)


def almost_repeat_plain(seq, lens, K, max_mismatch):
    """The plain version, the JAX loop step for step: a loop over the
    shift d with [B, LP] mismatch prefix sums, index-unique pad codes so
    that padding never matches."""
    W, J, LP = seq.shape
    dev = seq.device
    B = W * J
    s = seq.reshape(B, LP).to(torch.int64)
    ln = lens.reshape(B)
    posi = _ar(LP, dev)[None, :]
    eff = torch.where(posi < ln[:, None], s, 50 + posi % 37)
    w = K + 1
    maxp = ln - K - 1  # both pattern and candidate offsets bounded
    hit = torch.zeros((B,), dtype=torch.bool, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    pidx = _ar(LP - w + 1, dev)[None, :]
    d_hi = min(max(int(maxp.max()) + 1, 1), LP) if B else 1
    for d in range(1, d_hi):
        mneq = (torch.roll(eff, -d, dims=1) != eff).to(torch.int64)
        csp = torch.cat([zero, torch.cumsum(mneq, dim=1)], dim=1)
        sums = csp[:, w:] - csp[:, :-w]  # mismatches over window p..p+K
        valid = ((pidx <= maxp[:, None] - d) & (pidx <= maxp[:, None])
                 & (d <= maxp[:, None]))
        hit |= (valid & (sums <= max_mismatch)).any(dim=1)
    return hit.reshape(W, J)


def short_link_strings_plain(st, cand, K, NI):
    """The STR guard's candidate strings: the first _SL_ITEMS candidates
    (`cand` [W, NI]) by item index, each unitig's bases from its mers' kept
    positions (a flipped mer's complemented), at most _SL_CAP of them.
    Returns dict seqs [W, _SL_ITEMS, _SL_CAP] (99 where no base lands),
    lens [W, _SL_ITEMS] (merlen + K - 1, 0 on an empty slot) and slot_item
    [W, _SL_ITEMS] (the candidate's item, -1 on an empty slot), int64."""
    W = cand.shape[0]
    dev = cand.device
    S, C = _SL_ITEMS, _SL_CAP
    key = torch.where(cand, _ar(NI, dev)[None], BIG)
    order = torch.argsort(key, dim=1, stable=True)[:, :S]
    slot_ok = _ar(S, dev)[None] < cand.sum(dim=1)[:, None]
    # item NI-1 is an anchor, never a candidate
    slot_of_item = torch.full((W, NI), -1, dtype=torch.int64, device=dev)
    slot_of_item.scatter_(1, torch.where(slot_ok, order, NI - 1),
                          torch.where(slot_ok, _ar(S, dev)[None], -1))

    # candidate unitig bases [W, S, C]; slot S drops
    seqs = torch.full((W, (S + 1) * C), 99, dtype=torch.int64, device=dev)
    mi = torch.clamp(st["mer_item"], 0, NI - 1)
    mslot = _take(slot_of_item, mi)  # [W, N]
    base = st["mer_base"]
    klo, khi = st["keep_lo"], st["keep_hi"]
    flip, pos = st["mer_flip"], st["mer_pos"]
    NM = mi.shape[1]
    midx = _ar(NM, dev)[None].expand(W, NM)
    for j in range(K):
        keep = (j >= klo) & (j < khi) & (mslot >= 0)
        ci = torch.where(flip, K - 1 - j, j)
        bj = torch.gather(base, 2,
                          torch.clamp(ci, 0, K - 1)[:, :, None])[..., 0]
        bj = torch.where(flip, bj ^ 3, bj)
        flat = (torch.where(keep, mslot, S) * C
                + torch.clamp(pos + j, 0, C - 1))
        # positions clipped to C-1 can meet: the last mer (in index
        # order) wins, as the JAX scatter applies its updates in order
        win = torch.full((W, (S + 1) * C), -1, dtype=torch.int64, device=dev)
        win.scatter_reduce_(1, flat, torch.where(keep, midx, -1), "amax")
        hit = win >= 0
        seqs = torch.where(hit, torch.gather(bj, 1, torch.clamp(win, min=0)),
                           seqs)
    seqs = seqs.reshape(W, S + 1, C)[:, :S]
    item_len = st["merlen"] + K - 1
    lens = torch.where(slot_ok, _take(item_len, torch.clamp(order, 0, NI - 1)),
                       0)
    return dict(seqs=seqs, lens=lens,
                slot_item=torch.where(slot_ok, order, -1))


def short_link_stage_plain(st, mincov, thr, K, NI, max_link):
    """The plain version of the short_link_strings kernel (gpu.cleanup):
    the candidates and pre (_short_link_pre), then their strings
    (short_link_strings_plain). Returns the strings' dict with pre_any [W]
    (a candidate the links pass may kill)."""
    cand, pre = _short_link_pre(st, mincov, thr, NI, max_link)
    out = short_link_strings_plain(st, cand, K, NI)
    out["pre_any"] = pre.any(dim=1)
    return out


def _short_link_str_guard(st, cand, K, N, NI, max_unit_len,
                          min_report_units, min_report_len, dist_from_str,
                          strings=None):
    """Per-item STR-guard flags: find_tandems(str, ..., K-1) reported a
    tandem near position K-1 (Graph.cc:2863-2870). Up to _SL_ITEMS
    candidates per window are probed, each at most _SL_CAP bases: the
    strings of `strings` (a short_link_strings result), else
    short_link_strings_plain's of `cand`; then the tandem_at probe and the
    scatter of its verdicts to the items."""
    if strings is None:
        strings = short_link_strings_plain(st, cand, K, NI)
    seqs, lens, slot_item = (strings["seqs"], strings["lens"],
                             strings["slot_item"])
    W, S, C = seqs.shape
    ans = stages.tandem_at(seqs.reshape(W * S, C), lens.reshape(W * S), K - 1,
                           max_unit_len, min_report_units, min_report_len,
                           dist_from_str).reshape(W, S)
    ok = slot_item >= 0
    return stages.scatter_max(
        NI, 0, torch.where(ok, slot_item, NI - 1),
        (ok & ans).to(torch.int64), W) > 0
