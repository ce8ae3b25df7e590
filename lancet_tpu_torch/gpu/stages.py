"""Graph cleanup stages of the device graph engine, in PyTorch ops, over
gpu.dbg.build_k's node and edge tables: connected components, source/sink
anchoring with CLIP_REF_ENDS, the cycle gate (a parallel screen and the
exact replay of the reference's node-coloured DFS), unitig compression by
pointer jumping over mutual-buddy chains with donor-interval bookkeeping,
and the removal sweeps (ref: src/Graph.cc:2028-2336, :593-681, :2486-2732,
:2790-2926). The JAX package's `tpu/stages.py`, function for function.

State layout (all [W, ...]; item axis NI = N + 2*Cmax where slots N+2c and
N+2c+1 are component c+1's fake source and sink):

- items: alive, special, rank (libstdc++ map-order rank from the host),
  comp, merlen, csum [NI, 4] (summed per-mer counts), n_t (count of
  status-'T' mers), is_tumor/is_normal;
- edges: e_src, e_dst, e_dir (FF=0 FR=1 RF=2 RR=3), e_alive, e_okey
  (per-source list order);
- mers (the build's node axis [N]): mer_item, mer_flip, mer_pos, keep_lo,
  keep_hi (the kept donor interval within the mer's K bases).

Nine functions are hand-written kernels on a CUDA tensor and their plain
versions here on the CPU: `_seq_removal_pass` (the map-rank order removal
sweep with the slot order, neighbour lists and removal around it; gpu.walks
K2 `seq_removal`, the whole pass in one launch), `has_cycle_seq` (the
hasCycleRec replay; K4 `cycle_dfs`), `tandem_at` and `cycle_screen`
(gpu.screens), `compress_round` (gpu.compress: edge renorm, links,
pointer jumping and the chain merge in one launch), and `components`,
`compact_state`, `item_mincovs` and `low_cov_pass` (gpu.graphstate: the
label fixpoint and numbering, the compaction, the per-item minima and the
low-coverage removal, one launch each). Their plain versions
(`seq_removal_pass_plain`, `cycle_dfs_plain`, `tandem_at_plain`,
`cycle_screen_plain`, `compress_round_plain` with its `edge_renorm`,
`links` and `chain_jump`, `components_plain`, `compact_state_plain`,
`item_mincovs_plain`, `low_cov_pass_plain`) are the JAX functions step for
step; `components_plain` runs the JAX `while_loop` as a host loop, syncing
on a predicate computed on the device each round. Every other function is
torch ops on the tensors' device.

Scatters: JAX's `.at[].set(..., mode="drop")` becomes a write into one
padding slot that is sliced off; where two writes could meet in one live
slot the winner is made explicit.
"""

from __future__ import annotations

import torch

from .dbg import cummax

BIG = 1 << 30

# okey packing for single-key edge sorts: real okeys are edge creation
# indices (< E <= 10240) or Dcap-augmented renorm slots (< 192); the two
# anchor sentinels BIG-2/BIG-1 map to the top two codes
_OKB = 14
_OKMAX = (1 << _OKB) - 1


def _ar(n, dev):
    return torch.arange(n, dtype=torch.int64, device=dev)


def _wid(W, n, dev):
    return _ar(W, dev)[:, None].expand(W, n)


def _take(a, idx):
    return torch.gather(a, 1, idx)


def _newrun(k):
    out = torch.ones_like(k, dtype=torch.bool)
    out[:, 1:] = k[:, 1:] != k[:, :-1]
    return out


def _pack_src_okey(e_src, e_okey, e_alive, NI):
    """[W, EE] one key ordering (alive, src, okey), dead rows last."""
    ok2 = torch.where(e_okey >= BIG - 2,
                      torch.clamp(e_okey - (BIG - 2) + (_OKMAX - 1),
                                  max=_OKMAX),
                      torch.clamp(e_okey, max=_OKMAX - 2))
    return torch.where(e_alive, (e_src << _OKB) | ok2, NI << _OKB)


def startbit(d):
    return d >> 1


def destbit(d):
    return d & 1


def fliplink(d):
    """(a,b) -> (!b,!a) (ref: Edge.hh:103-111)."""
    return ((d & 1) ^ 1) * 2 + ((d >> 1) ^ 1)


def scatter_min(n, fill, idx, vals, W):
    out = torch.full((W, n), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(1, idx, vals, "amin", include_self=True)


def scatter_max(n, fill, idx, vals, W):
    out = torch.full((W, n), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(1, idx, vals, "amax", include_self=True)


def scatter_add(n, idx, vals, W):
    out = torch.zeros((W, n), dtype=vals.dtype, device=vals.device)
    return out.scatter_add_(1, idx, vals)


def touch(counts, key, n, idx, m):
    """Counts, in the [W, n] map counts[key], the reads of column idx of
    each window's row of an input where m holds: a walk's plain version
    records which input elements the walk reads (its bound's bytes)."""
    W = m.shape[0]
    t = counts.setdefault(key, torch.zeros((W, n), dtype=torch.int64,
                                           device=m.device))
    t.scatter_add_(1, idx.expand(m.shape).reshape(W, -1),
                   m.reshape(W, -1).to(torch.int64))


# ---------------------------------------------------------------------------
# connected components (ref: Graph.cc:2252-2336)
# ---------------------------------------------------------------------------

def components(alive, e_src, e_dst, e_alive, rank, Cmax):
    """Component labels (see components_plain). The `components` wrapper
    (gpu.graphstate): on a CUDA tensor one kernel launch (plus its outputs'
    allocation, and no host sync), else components_plain. Returns (comp
    [W, NI] 0=none, numcomp [W], over_c [W])."""
    from . import graphstate

    return graphstate.components(alive, e_src, e_dst, e_alive, rank, Cmax)


def components_plain(alive, e_src, e_dst, e_alive, rank, Cmax):
    """Labels connected components over alive items and numbers them 1..
    by ascending min map-rank. Returns (comp [W, NI] 0=none, numcomp [W],
    over_c [W])."""
    W, NI = alive.shape
    dev = alive.device
    idx = _ar(NI, dev)[None].expand(W, NI)
    label = torch.where(alive, idx, BIG)
    ea = e_alive
    es = torch.where(ea, e_src, 0)
    ed = torch.where(ea, e_dst, 0)
    cs = torch.clamp(e_src, 0, NI - 1)
    cd = torch.clamp(e_dst, 0, NI - 1)

    def body(label):
        m = torch.minimum(_take(label, cs), _take(label, cd))
        m = torch.where(ea, m, BIG)
        new = label.clone().scatter_reduce_(1, es, m, "amin")
        new.scatter_reduce_(1, ed, m, "amin")
        for _ in range(3):  # pointer jumping, 3 jumps a round
            new = torch.minimum(new, _take(new, torch.clamp(new, 0, NI - 1)))
        return new

    label = body(label)
    while True:
        new = body(label)
        changed = bool((new != label).any())
        label = new
        if not changed:
            break

    lab = torch.clamp(label, 0, NI - 1)
    lab_minrank = scatter_min(NI, BIG, lab, torch.where(alive, rank, BIG), W)
    is_root = alive & (label == idx)
    root_key = torch.where(is_root, lab_minrank, BIG)
    order = torch.argsort(root_key, dim=1, stable=True)
    comp_of_root = torch.zeros((W, NI), dtype=torch.int64,
                               device=dev).scatter_(
        1, order, _ar(NI, dev)[None].expand(W, NI) + 1)
    comp = torch.where(alive, _take(comp_of_root, lab), 0)
    numcomp = is_root.sum(dim=1)
    return comp, numcomp, numcomp > Cmax


# ---------------------------------------------------------------------------
# source/sink anchoring (ref: Graph.cc:2028-2228)
# ---------------------------------------------------------------------------

def ref_ends(nid_proj, proj_isF, rawlen, K, comp, alive, csum, merlen,
             cov_threshold, Cmax):
    """Per-component anchor scan over the rawseq mers. Returns per
    (window, comp 0..Cmax-1): anchored, src_pos/snk_pos, src_nid/snk_nid,
    src_ori/snk_ori (True=F), trim5, dist, trim3."""
    W, Mraw = nid_proj.shape
    dev = nid_proj.device
    roff = _ar(Mraw, dev)[None].expand(W, Mraw)
    valid = (nid_proj >= 0) & (roff <= rawlen[:, None] - K)
    safe = torch.clamp(nid_proj, 0, alive.shape[1] - 1)
    tot = csum.sum(dim=-1)
    nd_ok = alive & (tot >= cov_threshold)
    q = valid & _take(nd_ok, safe)
    pcomp = torch.where(q, _take(comp, safe), 0)
    cols = {k: [] for k in ("anchored", "src_pos", "snk_pos", "src_nid",
                            "snk_nid", "src_ori", "snk_ori")}
    for c in range(1, Cmax + 1):
        mc = q & (pcomp == c)
        has = mc.any(dim=1)
        # first / last True position (argmax of a bool: the first max)
        src_pos = torch.where(mc, roff, Mraw).min(dim=1).values
        src_pos = torch.where(has, src_pos, 0)
        snk_pos = torch.where(mc, roff, -1).max(dim=1).values
        snk_pos = torch.where(has, snk_pos, Mraw - 1)
        src_nid = _take(nid_proj, src_pos[:, None])[:, 0]
        snk_nid = _take(nid_proj, snk_pos[:, None])[:, 0]
        amb_src = (mc & (nid_proj == src_nid[:, None])).sum(dim=1) >= 2
        amb_snk = (mc & (nid_proj == snk_nid[:, None])).sum(dim=1) >= 2
        cols["anchored"].append(has & ~amb_src & ~amb_snk)
        cols["src_pos"].append(src_pos)
        cols["snk_pos"].append(snk_pos)
        cols["src_nid"].append(src_nid)
        cols["snk_nid"].append(snk_nid)
        cols["src_ori"].append(_take(proj_isF, src_pos[:, None])[:, 0])
        cols["snk_ori"].append(_take(proj_isF, snk_pos[:, None])[:, 0])
    out = {k: torch.stack(v, dim=1) for k, v in cols.items()}
    out["trim5"] = out["src_pos"]
    out["dist"] = out["snk_pos"] - out["src_pos"] + K
    out["trim3"] = rawlen[:, None] - out["snk_pos"] - K
    return out


def wire_anchors(ends, N, Cmax, e_src, e_dst, e_dir, e_alive, e_okey,
                 special, alive, comp):
    """CLIP_REF_ENDS + fake source/sink wiring (ref: Graph.cc:2156-2227).

    Edge rows E..E+4*Cmax-1 (pre-padded dead) become, per comp c:
    [fake_src->anchor, anchor->fake_src, fake_snk->anchor,
    anchor->fake_snk]. Returns updated edge arrays + item arrays (new
    tensors; the inputs are not changed)."""
    W, EE = e_src.shape
    E = EE - 4 * Cmax
    anch = ends["anchored"]
    e_src, e_dst, e_dir = e_src.clone(), e_dst.clone(), e_dir.clone()
    e_alive, e_okey = e_alive.clone(), e_okey.clone()
    special, alive, comp = special.clone(), alive.clone(), comp.clone()

    def wire(row, on, s, d, dr, okey):
        e_src[:, row] = torch.where(on, s, e_src[:, row])
        e_dst[:, row] = torch.where(on, d, e_dst[:, row])
        e_dir[:, row] = torch.where(on, dr, e_dir[:, row])
        e_alive[:, row] = on | e_alive[:, row]
        e_okey[:, row] = okey

    def clip(on, node, sb_clip, db_clip):
        sb = startbit(e_dir)
        db = destbit(e_dir)
        kill = (on[:, None] & e_alive
                & (((e_src == node[:, None]) & (sb == sb_clip[:, None])
                    & (e_dst != node[:, None]))
                   | ((e_dst == node[:, None]) & (e_src != node[:, None])
                      & (db == db_clip[:, None]))))
        e_alive.logical_and_(~kill)

    for c in range(Cmax):
        on = anch[:, c]
        sn = ends["src_nid"][:, c]
        so = ends["src_ori"][:, c]  # True = F
        kn = ends["snk_nid"][:, c]
        ko = ends["snk_ori"][:, c]
        # source clip (Graph.cc:2165-2191); bits F=0, R=1
        clip(on, sn, so.to(torch.int64), (~so).to(torch.int64))
        fs = N + 2 * c
        sdir = torch.where(so, 0, 1)  # FF / FR
        wire(E + 4 * c, on, fs, sn, sdir, 0)
        wire(E + 4 * c + 1, on, sn, fs, fliplink(sdir), BIG - 2)
        special[:, fs] |= on
        alive[:, fs] |= on
        comp[:, fs] = torch.where(on, c + 1, comp[:, fs])
        # sink clip AFTER source wiring (the fresh fake edges are fair game
        # when source_node == sink_node, exactly like the reference)
        clip(on, kn, (~ko).to(torch.int64), ko.to(torch.int64))
        fk = N + 2 * c + 1
        kdir = torch.where(ko, 3, 0)  # RR / FF
        wire(E + 4 * c + 2, on, fk, kn, kdir, 0)
        wire(E + 4 * c + 3, on, kn, fk, fliplink(kdir), BIG - 1)
        special[:, fk] |= on
        alive[:, fk] |= on
        comp[:, fk] = torch.where(on, c + 1, comp[:, fk])
    return e_src, e_dst, e_dir, e_alive, e_okey, special, alive, comp


# ---------------------------------------------------------------------------
# buddy / chain machinery (ref: Node.cc:235-266 getBuddy)
# ---------------------------------------------------------------------------

def edge_renorm(e_src, e_okey, e_alive, NI):
    """Dense per-source okey ranks (stable in current okey order)."""
    W, EE = e_src.shape
    dev = e_src.device
    eidx = _ar(EE, dev)[None].expand(W, EE)
    k1, perm = torch.sort(_pack_src_okey(e_src, e_okey, e_alive, NI), dim=1,
                          stable=True)
    slot = eidx - cummax(torch.where(_newrun(k1 >> _OKB), eidx, 0))
    out = torch.zeros((W, EE), dtype=torch.int64, device=dev).scatter_(
        1, perm, slot)
    return torch.where(e_alive, out, BIG)


def links(e_src, e_dst, e_dir, e_alive, e_okey, alive, special, NI):
    """Mutual-buddy chain links: per (item, bit) lnk_valid [W,NI,2],
    lnk_to (dst item), lnk_bit (continuation bit), tandem [W,NI], cnt
    [W,NI,2] (alive out-degree per direction)."""
    W, EE = e_src.shape
    dev = e_src.device
    sb = startbit(e_dir)
    seg = torch.where(e_alive, e_src * 2 + sb, NI * 2)
    cnt = scatter_add(NI * 2 + 1, seg, e_alive.to(torch.int64),
                      W)[:, :-1].reshape(W, NI, 2)
    # only cnt==1 segments are read, where the min IS the single edge
    pk = scatter_min(NI * 2 + 1, BIG, seg,
                     torch.where(e_alive, e_dst * 2 + destbit(e_dir), BIG),
                     W)[:, :-1]
    one_dst = torch.where(pk == BIG, BIG, pk >> 1).reshape(W, NI, 2)
    one_db = torch.where(pk == BIG, BIG, pk & 1).reshape(W, NI, 2)
    loop = e_alive & (e_src == e_dst)
    tandem = scatter_max(NI, 0, torch.where(loop, e_src, NI - 1),
                         loop.to(torch.int64), W) > 0
    uniq = cnt == 1
    v, b = one_dst, one_db
    idx = _ar(NI, dev)[None, :, None].expand(W, NI, 2)
    base = (uniq & (v != idx) & alive[:, :, None]
            & ~special[:, :, None] & ~tandem[:, :, None])
    vsafe = torch.clamp(v, 0, NI - 1).reshape(W, NI * 2)
    base = (base & ~_take(special, vsafe).reshape(W, NI, 2)
            & ~_take(tandem, vsafe).reshape(W, NI, 2))
    # mutuality: v's unique edge in dir (!b) points back to u
    gi = torch.clamp(vsafe * 2 + torch.clamp(1 - b, 0, 1).reshape(W, NI * 2),
                     0, NI * 2 - 1)
    back_uniq = _take(cnt.reshape(W, NI * 2), gi).reshape(W, NI, 2) == 1
    back_dst = _take(one_dst.reshape(W, NI * 2), gi).reshape(W, NI, 2)
    valid = base & back_uniq & (back_dst == idx)
    return {"lnk_valid": valid, "lnk_to": torch.where(valid, v, idx),
            "lnk_bit": torch.where(valid, b, 0), "tandem": tandem,
            "cnt": cnt}


def chain_jump(lnk, NI, rounds=None):
    """Pointer jumping over the link state graph (state = item*2+bit) with
    (nxt, dist) packed into one integer. Returns end_state [W, 2NI], dist
    [W, 2NI], cyc [W] (an unterminated chain is a mutual-buddy cycle ->
    window fallback)."""
    W = lnk["lnk_valid"].shape[0]
    dev = lnk["lnk_valid"].device
    S = NI * 2
    if rounds is None:
        rounds = max(2, int(NI + 8).bit_length())
    DBITS = 13
    assert S < (1 << (31 - DBITS)), "state id overflows the packed word"
    DCAP = min(NI + 8, (1 << DBITS) - 1)
    DMASK = (1 << DBITS) - 1
    valid = lnk["lnk_valid"].reshape(W, S)
    to = (lnk["lnk_to"] * 2 + lnk["lnk_bit"]).reshape(W, S)
    sid = _ar(S, dev)[None].expand(W, S)
    p = (torch.where(valid, to, sid) << DBITS) | valid.to(torch.int64)
    for _ in range(rounds):
        q = _take(p, p >> DBITS)
        d2 = torch.clamp((p & DMASK) + (q & DMASK), max=DCAP)
        p2 = (q & ~DMASK) | d2
        changed = bool((p2 != p).any())
        p = p2
        if not changed:
            break
    nxt = p >> DBITS
    dist = p & DMASK
    return nxt, dist, (dist > NI - 1).any(dim=1)


# ---------------------------------------------------------------------------
# cleanup sweeps (ref: Graph.cc:2790-2926)
# ---------------------------------------------------------------------------

def item_mincovs(st, K, N, NI):
    """Per-item (mincov, mincov_qv) (see item_mincovs_plain). The
    `item_mincovs` wrapper (gpu.graphstate): on a CUDA tensor one kernel
    launch (plus its outputs' allocation, and no host sync), else
    item_mincovs_plain."""
    from . import graphstate

    return graphstate.item_mincovs(st, K, N, NI)


def item_mincovs_plain(st, K, N, NI):
    """Per-item (mincov, mincov_qv) over the donor structure: a fully
    trimmed mer no longer donates bases (Node.cc:600-615)."""
    totq = st["mer_totq"]  # [W, N, K]
    tot = st["mer_tot"]  # [W, N]
    klo, khi = st["keep_lo"], st["keep_hi"]
    flip = st["mer_flip"]
    W = tot.shape[0]
    clo = torch.where(flip, K - khi, klo)
    chi = torch.where(flip, K - klo, khi)
    j = _ar(K, tot.device)[None, None, :]
    inside = (j >= clo[:, :, None]) & (j < chi[:, :, None])
    mq_min = torch.where(inside, totq, BIG).min(dim=-1).values
    width = khi - klo
    mi = torch.where(width > 0, torch.clamp(st["mer_item"], 0, NI - 1),
                     NI - 1)
    mincov = scatter_min(NI, BIG, mi, torch.where(width > 0, tot, BIG), W)
    mincov_qv = scatter_min(NI, BIG, mi, torch.where(width > 0, mq_min, BIG),
                            W)
    return mincov, mincov_qv


def compact_state(st, N, NI, Cmax, NCR, ECR):
    """The compact item/edge space (see compact_state_plain). The
    `compact_state` wrapper (gpu.graphstate): on a CUDA tensor one kernel
    launch (plus its outputs' allocation, and no host sync), else
    compact_state_plain. Returns (compact_st, over [W], dead_edge [W]):
    dead_edge flags the hold-point (an alive edge touches a dead item on a
    lane within the caps) for the caller to assert at a sync it makes; the
    plain version asserts it itself and returns it all False."""
    from . import graphstate

    return graphstate.compact_state(st, N, NI, Cmax, NCR, ECR)


def compact_state_plain(st, N, NI, Cmax, NCR, ECR):
    """Gather the post-compress survivors into a compact item/edge space:
    regular items packed in id order into slots [0, NCR), the fake
    anchors at the fixed slots NCR+2c / NCR+2c+1, edges packed into
    ECR+4*Cmax rows; mers of dead items get an empty donor interval.
    Returns (compact_st, over [W], dead_edge [W]); `over` lanes replay
    natively. The hold-point (no alive edge of a lane within the caps
    touches a dead item) is asserted here, so dead_edge is all False."""
    W = st["alive"].shape[0]
    dev = st["alive"].device
    NC = NCR + 2 * Cmax
    EC = ECR + 4 * Cmax
    alive, special = st["alive"], st["special"]
    idx = _ar(NI, dev)[None].expand(W, NI)

    reg = alive & ~special
    pos = torch.cumsum(reg.to(torch.int64), dim=1) - 1
    n_reg = reg.sum(dim=1)
    # hold-point: an alive edge whose endpoint does not fit the compact
    # space gets no -1 id below (every alive edge's endpoints are alive),
    # so overflow is caught by this count alone
    over = n_reg > NCR
    new_of = torch.where(reg, torch.clamp(pos, max=NCR - 1), -1)
    anchors = N + _ar(2 * Cmax, dev)
    new_of[:, anchors] = NCR + _ar(2 * Cmax, dev)

    # inverse: compact slot -> old item (NI = dead); slot NC is the drop
    old_of = torch.full((W, NC + 1), NI, dtype=torch.int64, device=dev)
    old_of.scatter_(1, torch.where(reg & (pos < NCR), pos, NC), idx)
    old_of = old_of[:, :NC]
    old_of[:, NCR:] = anchors

    live_o = old_of < NI
    safe = torch.clamp(old_of, 0, NI - 1)

    def g_item(a, fill):
        return torch.where(live_o, _take(a, safe), fill)

    out = dict(st)
    out["alive"] = g_item(alive, False)
    out["special"] = g_item(special, False)
    out["rank"] = g_item(st["rank"], BIG)
    out["merlen"] = g_item(st["merlen"], 0)
    out["n_t"] = g_item(st["n_t"], 0)
    out["is_tumor"] = g_item(st["is_tumor"], False)
    out["is_normal"] = g_item(st["is_normal"], False)
    if "comp" in st:
        out["comp"] = g_item(st["comp"], 0)
    csum_g = torch.gather(st["csum"], 1, safe[:, :, None].expand(W, NC, 4))
    out["csum"] = torch.where(live_o[:, :, None], csum_g, 0)

    ea = st["e_alive"]
    EEo = ea.shape[1]
    epos = torch.cumsum(ea.to(torch.int64), dim=1) - 1
    over = over | (ea.sum(dim=1) > EC)
    eold_of = torch.full((W, EC + 1), EEo, dtype=torch.int64, device=dev)
    eold_of.scatter_(1, torch.where(ea & (epos < EC), epos, EC),
                     _ar(EEo, dev)[None].expand(W, EEo))
    eold_of = eold_of[:, :EC]
    e_alive_c = eold_of < EEo
    esafe = torch.clamp(eold_of, 0, EEo - 1)

    def g_edge(a, fill):
        return torch.where(e_alive_c, _take(a, esafe), fill)

    e_src_o = g_edge(st["e_src"], 0)
    e_dst_o = g_edge(st["e_dst"], 0)
    ns = _take(new_of, torch.clamp(e_src_o, 0, NI - 1))
    nd = _take(new_of, torch.clamp(e_dst_o, 0, NI - 1))
    assert not bool(((e_alive_c & ((ns < 0) | (nd < 0))).any(dim=1)
                     & ~over).any()), "an alive edge touches a dead item"
    out["e_src"] = torch.where(e_alive_c, torch.clamp(ns, 0, NC - 1), 0)
    out["e_dst"] = torch.where(e_alive_c, torch.clamp(nd, 0, NC - 1), 0)
    out["e_dir"] = g_edge(st["e_dir"], 0)
    out["e_alive"] = e_alive_c
    out["e_okey"] = g_edge(st["e_okey"], BIG)

    nm = _take(new_of, torch.clamp(st["mer_item"], 0, NI - 1))
    dead_mer = nm < 0
    out["mer_item"] = torch.where(dead_mer, NCR, nm)  # anchor slot: inert
    out["keep_lo"] = st["keep_lo"]
    out["keep_hi"] = torch.where(dead_mer, st["keep_lo"], st["keep_hi"])
    return out, over, torch.zeros_like(over)


def remove_items(st, removed):
    """Kill items + every edge touching them (remove_node semantics)."""
    NI = st["alive"].shape[1]
    gone = (_take(removed, torch.clamp(st["e_src"], 0, NI - 1))
            | _take(removed, torch.clamp(st["e_dst"], 0, NI - 1)))
    out = dict(st)
    out["alive"] = st["alive"] & ~removed
    out["e_alive"] = st["e_alive"] & ~gone
    return out


def low_cov_pass(st, K, N, NI, low_cov_threshold, min_cov_ratio, avgcov):
    """removeLowCov for every component (see low_cov_pass_plain). The
    `low_cov_pass` wrapper (gpu.graphstate): on a CUDA tensor one kernel
    launch (plus the threshold's product and its outputs' allocation, and
    no host sync), else low_cov_pass_plain. Returns (updated st: alive and
    e_alive new, every other key passed through; low.any [W])."""
    from . import graphstate

    return graphstate.low_cov_pass(st, K, N, NI, low_cov_threshold,
                                   min_cov_ratio, avgcov)


def low_cov_pass_plain(st, K, N, NI, low_cov_threshold, min_cov_ratio,
                       avgcov):
    """removeLowCov(true, c) for every component at once
    (Graph.cc:2790-2827), with the exact rational csum/merlen for the
    coverage==1 tests."""
    _, mincov_qv = item_mincovs_plain(st, K, N, NI)
    csum, merlen = st["csum"], st["merlen"]
    tot_t = csum[..., 0] + csum[..., 1]
    tot_n = csum[..., 2] + csum[..., 3]
    low = (st["alive"] & ~st["special"]
           & ((mincov_qv <= low_cov_threshold)
              | (mincov_qv.to(torch.float32)
                 <= min_cov_ratio * avgcov[:, None])
              | ((tot_t == merlen) & (tot_n == merlen) & (merlen > 0))))
    return remove_items(st, low), low.any(dim=1)


def _rank_slots(st, U):
    """Alive non-special items in map-rank order -> [W, U] (id or -1)."""
    alive = st["alive"] & ~st["special"]
    key = torch.where(alive, st["rank"], BIG)
    order = torch.argsort(key, dim=1, stable=True)[:, :U]
    n = alive.sum(dim=1)
    slot_ok = _ar(order.shape[1], key.device)[None, :] < n[:, None]
    return torch.where(slot_ok, order, -1), n > U


def _nbr_table(st, NI, D2):
    """[W, NI, D2] alive-edge dst per item (any order: only used for
    degree decrements) + deg [W, NI] + overflow flag."""
    e_src, e_dst, e_alive = st["e_src"], st["e_dst"], st["e_alive"]
    W, EE = e_src.shape
    dev = e_src.device
    eidx = _ar(EE, dev)[None].expand(W, EE)
    k1, perm = torch.sort(torch.where(e_alive, e_src, BIG), dim=1,
                          stable=True)
    slot = eidx - cummax(torch.where(_newrun(k1), eidx, 0))
    ea = _take(e_alive, perm)
    over = torch.where(ea, slot + 1, 0).max(dim=1).values > D2
    nbr = torch.full((W, NI + 1, D2), -1, dtype=torch.int64, device=dev)
    srcs = torch.where(ea & (slot < D2), k1, NI)
    nbr[_wid(W, EE, dev), srcs, torch.clamp(slot, max=D2 - 1)] = \
        _take(e_dst, perm)
    dg = scatter_add(NI + 1, torch.where(e_alive, e_src, NI),
                     e_alive.to(torch.int64), W)[:, :NI]
    return nbr[:, :NI], dg, over


def seq_removal_plain(slots, nbr, deg, kill_fn):
    """The removal sweep's plain version, the JAX lockstep `while_loop`
    step for step: slot i of every lane at once. `kill_fn(items, deg)`
    -> bool [W]. Returns removed [W, NI] bool."""
    W, U = slots.shape
    NI = deg.shape[1]
    dev = slots.device
    wrow = _ar(W, dev)
    removed = torch.zeros((W, NI), dtype=torch.bool, device=dev)
    deg = deg.clone()
    max_slots = int(torch.clamp((slots >= 0).sum(dim=1), max=U).max()) \
        if W else 0
    for i in range(max_slots):
        it = slots[:, min(i, U - 1)]
        safe = torch.clamp(it, 0, NI - 1)
        on = (it >= 0) & ~removed[wrow, safe]
        d = deg[wrow, safe]
        kill = on & kill_fn(safe, d)
        nb = nbr[wrow, safe, :]  # [W, D2]
        nbs = torch.clamp(nb, 0, NI - 1)
        ok = (kill[:, None] & (nb >= 0) & (nb != safe[:, None])
              & ~_take(removed, nbs))
        deg.scatter_add_(1, torch.where(ok, nb, NI - 1),
                         torch.where(ok, -1, 0))
        removed[wrow, safe] = removed[wrow, safe] | kill
    return removed


def seq_removal_pass_plain(st, cond, U, D2):
    """The removal pass's plain version (see _seq_removal_pass), the JAX
    function's composition: the slot order, the neighbour table and
    degrees, the lockstep sweep, the removal. Returns (updated st,
    removed_any [W], over [W])."""
    NI = st["alive"].shape[1]
    slots, over = _rank_slots(st, U)
    nbr, deg, over2 = _nbr_table(st, NI, D2)
    removed = seq_removal_plain(slots, nbr, deg, removal_kill_fn(cond))
    return remove_items(st, removed), removed.any(dim=1), over | over2


def _seq_removal_pass(st, cond, U, D2):
    """One sequential map-rank-order sweep: remove items satisfying the
    condition, updating neighbour degrees as the reference's in-place edge
    surgery does (removeTips/removeShortLinks iterate the live map).

    `cond` is ("tips", merlen, max_tip) or ("links", merlen, max_link,
    mincov, thr, guard): the two conditions of cleanup. The pass is the
    `seq_removal` wrapper (gpu.walks): on a CUDA tensor one kernel launch
    (plus its outputs' allocation, and no host sync), else
    seq_removal_pass_plain. Returns (updated st: alive and e_alive new,
    every other key passed through; removed_any [W], over [W])."""
    from . import walks

    alive, e_alive, removed_any, over = walks.seq_removal(st, cond, U, D2)
    out = dict(st)
    out["alive"] = alive
    out["e_alive"] = e_alive
    return out, removed_any, over


def removal_kill_fn(cond):
    """The kill predicate of a removal condition (see _seq_removal_pass)
    as a function of (items [W], live degree [W])."""
    mode, merlen = cond[0], cond[1]
    rows = _ar(merlen.shape[0], merlen.device)
    if mode == "tips":
        max_tip = cond[2]

        def kill(items, deg):
            return (deg <= 1) & (merlen[rows, items] < max_tip)
        return kill
    max_link, mincov, thr, guard = cond[2:]

    def kill(items, deg):
        return ((deg >= 2) & (merlen[rows, items] < max_link)
                & (mincov[rows, items] <= thr) & ~guard[rows, items])
    return kill


# ---------------------------------------------------------------------------
# findTandems position probe (ref: util.cc:574-758) for the short-link STR
# guard: is position K-1 within dist_from_str of a reported tandem?
# ---------------------------------------------------------------------------

def tandem_at(seqs, lens, pos, max_unit_len, min_report_units,
              min_report_len, dist_from_str):
    """Whether `pos` lies within dist_from_str of a reported tandem of each
    string (see tandem_at_plain): seqs [B, L] codes, lens [B]; returns [B]
    bool. The `tandem_at` wrapper (gpu.screens): on a CUDA tensor one
    kernel launch (plus its output's allocation, and no host sync), else
    tandem_at_plain."""
    from . import screens

    return screens.tandem_at(seqs, lens, pos, max_unit_len,
                             min_report_units, min_report_len,
                             dist_from_str)


def tandem_at_plain(seqs, lens, pos, max_unit_len, min_report_units,
                    min_report_len, dist_from_str):
    """Exact findTandems replay asking only whether `pos` lies within
    dist_from_str of a reported tandem (ref: util.cc:574-758, mirrored by
    engine.seqs.find_tandems incl. the offset-(-1) sentinel quirk).

    seqs [B, L] codes (invalid >= 4), lens [B], pos an int. A sequential
    loop over i: callers pass short strings."""
    B, L = seqs.shape
    dev = seqs.device
    posi = _ar(L, dev)[None, :]
    eff = torch.where(posi < lens[:, None], seqs.to(torch.int64),
                      100 + (posi % 50))
    rows = _ar(B, dev)

    def gb(i):
        """base at i ([B] or int), index-unique sentinels out of range."""
        if not torch.is_tensor(i):
            i = torch.full((B,), i, dtype=torch.int64, device=dev)
        v = eff[rows, torch.clamp(i, 0, L - 1)]
        return torch.where((i >= 0) & (i < L), v, 300 + torch.abs(i) % 97)

    csm = {}
    for ml in range(1, max_unit_len):
        mis = torch.ones((B, L), dtype=torch.int64, device=dev)
        mis[:, :L - ml] = (eff[:, :L - ml] != eff[:, ml:]).to(torch.int64)
        csm[ml] = torch.cat([torch.zeros((B, 1), dtype=torch.int64,
                                         device=dev),
                             torch.cumsum(mis, dim=1)], dim=1)

    def mis_range(ml, a, b):
        """# of ml-mismatches over positions [a, b) (b<=a -> 0)."""
        s = (csm[ml][rows, torch.clamp(b, 0, L)]
             - csm[ml][rows, torch.clamp(a, 0, L)])
        return torch.where(b > a, s, 0)

    offs = torch.zeros((B, max_unit_len + 1, max_unit_len), dtype=torch.int64,
                       device=dev)
    for m in range(1, max_unit_len + 1):
        for p in range(m):
            offs[:, m, p] = p
    ans = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(L):
        for m in range(1, max_unit_len + 1):
            p = i % m
            offset = offs[:, m, p].clone()
            j = torch.zeros((B,), dtype=torch.int64, device=dev)
            still = torch.ones((B,), dtype=torch.bool, device=dev)
            for jj in range(m):
                okj = still & (i + jj < lens) & (gb(i + jj) == gb(offset + jj))
                j = j + okj.to(torch.int64)
                still = okj
            brk = (j != m) | (i + j + 1 == lens)
            report = brk & (gb(offset - 1) != gb(offset + m - 1))
            units_ok = (torch.div(i - offset, m, rounding_mode="floor")
                        >= min_report_units) & ((i - offset) >= min_report_len)
            prim = torch.ones((B,), dtype=torch.bool, device=dev)
            for ml in range(1, m):
                units = torch.div(i - offset + j, ml, rounding_mode="floor")
                prim &= ~(mis_range(ml, offset,
                                    offset + units * ml - ml) == 0)
            hit = report & units_ok & prim & (i < lens)
            inrange = ((pos >= offset - dist_from_str)
                       & (pos <= i + j + dist_from_str))
            ans |= hit & inrange
            # the offset table advances only on a break
            offs[:, m, p] = torch.where(brk & (i < lens), i, offset)
    return ans


# ---------------------------------------------------------------------------
# cycle gate (ref: Graph.cc:593-681): the reference colours NODES, not
# node-direction states; a GREY hit in either orientation reports a cycle
# and a BLACK node is skipped even when re-reached in the other direction.
# ---------------------------------------------------------------------------

def okey_adjacency(e_src, e_dst, e_dir, e_alive, e_okey, NI, D2):
    """[W, NI, D2] edge ids per source in edge-list (okey) order."""
    W, EE = e_src.shape
    dev = e_src.device
    eidx = _ar(EE, dev)[None].expand(W, EE)
    k1p, perm = torch.sort(_pack_src_okey(e_src, e_okey, e_alive, NI),
                           dim=1, stable=True)
    k1 = k1p >> _OKB
    slot = eidx - cummax(torch.where(_newrun(k1), eidx, 0))
    ea = _take(e_alive, perm)
    over = torch.where(ea, slot + 1, 0).max(dim=1).values > D2
    adj = torch.full((W, NI + 1, D2), -1, dtype=torch.int64, device=dev)
    adj[_wid(W, EE, dev), torch.where(ea & (slot < D2), k1, NI),
        torch.clamp(slot, max=D2 - 1)] = perm
    return adj[:, :NI], over


def cycle_screen(e_src, e_dst, e_dir, e_alive, alive, special, comp,
                 N, NI, Cmax, T=32):
    """The conservative cycle screen, may_cycle [W, Cmax] (see
    cycle_screen_plain). The `cycle_screen` wrapper (gpu.screens): on a
    CUDA tensor one kernel launch (plus its output's allocation, and no
    host sync), else cycle_screen_plain."""
    from . import screens

    return screens.cycle_screen(e_src, e_dst, e_dir, e_alive, alive, special,
                                comp, N, NI, Cmax, T)


def cycle_screen_plain(e_src, e_dst, e_dir, e_alive, alive, special, comp,
                       N, NI, Cmax, T=32):
    """Conservative parallel screen for the node-coloured cycle DFS:
    may_cycle [W, Cmax]. False PROVES has_cycle_seq reports no cycle for
    that component: its reachable walk digraph is acyclic (a Kahn peel
    drains in <= T layers) and no non-special node is reachable in both
    orientations. True sends the component to the exact replay."""
    W, EE = e_src.shape
    dev = e_src.device
    NS = 2 * NI
    sb = startbit(e_dir)
    db = destbit(e_dir)
    srcs = torch.clamp(e_src, 0, NI - 1)
    dsts = torch.clamp(e_dst, 0, NI - 1)
    eact = (e_alive & _take(alive, srcs) & _take(alive, dsts)
            & ~_take(special, dsts))
    s_state = srcs * 2 + sb
    d_state = dsts * 2 + db

    reach = torch.zeros((W, NS), dtype=torch.bool, device=dev)
    for c in range(Cmax):
        item = N + 2 * c
        on = alive[:, item]
        reach[:, 2 * item] |= on
        reach[:, 2 * item + 1] |= on

    r_unconv = torch.ones((W,), dtype=torch.bool, device=dev)
    for _ in range(T):
        if not bool(r_unconv.any()):
            break
        m = _take(reach, s_state) & eact
        new = scatter_max(NS, 0, d_state, m.to(torch.int64), W) > 0
        new |= reach
        r_unconv = (new != reach).any(dim=1)
        reach = new

    # Kahn peel of the non-special walk digraph (edges out of special
    # sources excluded: a special is never entered)
    nonspec = ~torch.repeat_interleave(special, 2, dim=1)
    live = nonspec & torch.repeat_interleave(alive, 2, dim=1)
    eact_p = eact & ~_take(special, srcs)
    indeg = scatter_add(NS, d_state, eact_p.to(torch.int64), W)
    for _ in range(T):
        f = live & (indeg == 0)
        fsrc = _take(f, s_state) & eact_p
        indeg = indeg.scatter_add(1, d_state, -fsrc.to(torch.int64))
        live = live & ~f
        if not bool(f.any()):
            break
    leftover = live

    reach2 = reach.reshape(W, NI, 2)
    dual = reach2[:, :, 0] & reach2[:, :, 1] & alive & ~special
    left_item = (leftover & reach).reshape(W, NI, 2).any(dim=2)
    flag_item = (left_item | dual) & alive & ~special
    flag_item = flag_item | r_unconv[:, None]
    may = scatter_max(Cmax + 2, 0, torch.clamp(comp, 0, Cmax + 1),
                      (flag_item & (comp > 0)).to(torch.int64), W) > 0
    return may[:, 1:Cmax + 1]


def cycle_dfs_plain(adj, e_dst, e_dir, alive, special, N, Cmax, lane_mask,
                    counts=None):
    """The hasCycleRec replay's plain version, the JAX lockstep
    `while_loop` step for step: per component c, two rooted searches
    (source, F) then (source, R) sharing node colours. Returns [W, Cmax]
    bool. With a `counts` dict, adds the DFS steps of all lanes to
    counts["steps"] and those of each (window, component) to
    counts["lanes"]["steps"] [W, Cmax], and marks the input elements the
    walk reads (stages.touch: "adj", "e_dir", "e_dst", "special"): the
    steps the replay needs, so none of a second search after the first
    found a cycle (the lockstep loop runs it and ORs the verdicts; the
    kernels stop)."""
    W, NI, D2 = adj.shape
    EE = e_dst.shape[1]
    dev = adj.device
    sb_all = startbit(e_dir)
    db_all = destbit(e_dir)
    wrow = _ar(W, dev)
    SD = NI + 2  # stack bound: each node pushed at most once per call
    flags = []
    for c in range(Cmax):
        src_item = N + 2 * c
        active0 = alive[:, src_item]
        if lane_mask is not None:
            active0 = active0 & lane_mask[:, c]
        color = torch.zeros((W, NI), dtype=torch.int64, device=dev)
        cyc_any = torch.zeros((W,), dtype=torch.bool, device=dev)
        for d0 in (0, 1):
            s_node = torch.zeros((W, SD), dtype=torch.int64, device=dev)
            s_node[:, 0] = src_item
            s_dir = torch.full((W, SD), d0, dtype=torch.int64, device=dev)
            s_ei = torch.zeros((W, SD), dtype=torch.int64, device=dev)
            sp = active0.to(torch.int64)
            color[:, src_item] = torch.where(active0, 1, color[:, src_item])
            cyc = torch.zeros((W,), dtype=torch.bool, device=dev)
            while bool(((sp > 0) & ~cyc).any()):
                act = (sp > 0) & ~cyc
                tp = torch.clamp(sp - 1, 0, SD - 1)
                nd = s_node[wrow, tp]
                dr = s_dir[wrow, tp]
                ei = s_ei[wrow, tp]
                nds = torch.clamp(nd, 0, NI - 1)
                if counts is not None:
                    need = act & ~cyc_any
                    counts["steps"] = counts.get("steps", 0) + int(need.sum())
                    counts.setdefault("lanes", {}).setdefault(
                        "steps", torch.zeros((W, Cmax), dtype=torch.int64,
                                             device=dev))[:, c] += need
                    touch(counts, "adj", NI * D2,
                          (nds * D2 + torch.clamp(ei, 0, D2 - 1))[:, None],
                          (need & (ei < D2))[:, None])
                e = adj[wrow, nds, torch.clamp(ei, 0, D2 - 1)]
                exhausted = act & ((ei >= D2) | (e < 0))
                color[wrow, nds] = torch.where(exhausted, 2, color[wrow, nds])
                sp = sp - exhausted.to(torch.int64)
                step = act & ~exhausted
                s_ei[wrow, tp] = torch.where(step, ei + 1, s_ei[wrow, tp])
                es = torch.clamp(e, 0, EE - 1)
                match = step & (sb_all[wrow, es] == dr)
                v = e_dst[wrow, es]
                vs = torch.clamp(v, 0, NI - 1)
                if counts is not None:
                    touch(counts, "e_dir", EE, es[:, None],
                          (step & ~cyc_any)[:, None])
                    touch(counts, "e_dst", EE, es[:, None],
                          (match & ~cyc_any)[:, None])
                    touch(counts, "special", NI, vs[:, None],
                          (match & ~cyc_any)[:, None])
                probe = match & ~special[wrow, vs]
                vcol = color[wrow, vs]
                cyc = cyc | (probe & (vcol == 1))
                push = probe & (vcol == 0) & ~cyc
                color[wrow, vs] = torch.where(push, 1, color[wrow, vs])
                ns = torch.clamp(sp, 0, SD - 1)
                s_node[wrow, ns] = torch.where(push, v, s_node[wrow, ns])
                s_dir[wrow, ns] = torch.where(push, db_all[wrow, es],
                                              s_dir[wrow, ns])
                s_ei[wrow, ns] = torch.where(push, 0, s_ei[wrow, ns])
                sp = sp + push.to(torch.int64)
            cyc_any |= cyc
        flags.append(cyc_any & active0)
    return torch.stack(flags, dim=1)


def has_cycle_seq(e_src, e_dst, e_dir, e_alive, e_okey, alive, special,
                  N, NI, Cmax, D2=16, lane_mask=None):
    """Per-comp cycle flags [W, Cmax] by an exact replay of hasCycleRec's
    iterative DFS: two rooted searches (source, F) then (source, R)
    sharing node colours, a GREY hit in any orientation is a cycle,
    specials are skipped; only the components `lane_mask` flags walk. On a
    CUDA tensor the walk is the `cycle_dfs` kernel (gpu.walks), else
    cycle_dfs_plain. Returns (flags, adjacency overflow [W])."""
    from . import walks

    adj, over_d = okey_adjacency(e_src, e_dst, e_dir, e_alive, e_okey,
                                 NI, D2)
    return walks.cycle_dfs(adj, e_dst, e_dir, alive, special, N, Cmax,
                           lane_mask), over_d


def compress_round(st, K, NI, N, Dcap=64):
    """One graph-wide compression pass (see compress_round_plain). The
    `compress_round` wrapper (gpu.compress): on a CUDA tensor one kernel
    launch (plus its outputs' allocation, and no host sync), else
    compress_round_plain. Returns (updated st, fallback [W])."""
    from . import compress

    return compress.compress_round(st, K, NI, N, Dcap)


def compress_round_plain(st, K, NI, N, Dcap=64):
    """One graph-wide compression pass (ref: Graph.cc:2486-2732): merge
    every mutual-buddy chain into its lowest-map-rank member, rewiring
    edges with the orientation algebra; per-mer donor intervals lose K-1
    entries at each junction on the absorbed side. Returns the updated
    state and a per-window fallback flag (mutual-buddy cycles and
    mid-compress self-loops, which the native engine replays)."""
    alive, special = st["alive"], st["special"]
    rank = st["rank"]
    e_src, e_dst = st["e_src"], st["e_dst"]
    e_dir, e_alive, e_okey = st["e_dir"], st["e_alive"], st["e_okey"]
    W = alive.shape[0]
    dev = alive.device
    idx = _ar(NI, dev)[None].expand(W, NI)

    e_okey = edge_renorm(e_src, e_okey, e_alive, NI)
    lnk = links(e_src, e_dst, e_dir, e_alive, e_okey, alive, special, NI)
    end_state, dist, chain_cyc = chain_jump(lnk, NI)
    fallback = chain_cyc

    endF = end_state.reshape(W, NI, 2)[:, :, 0] // 2
    endR = end_state.reshape(W, NI, 2)[:, :, 1] // 2
    distF = dist.reshape(W, NI, 2)[:, :, 0]
    distR = dist.reshape(W, NI, 2)[:, :, 1]
    label = torch.minimum(endF, endR)
    t_hi = torch.maximum(endF, endR)
    a_u = torch.where(endF == t_hi, 0, 1)
    a_u = torch.where(endF == endR, 0, a_u)
    d_lo = torch.where(endF == t_hi, distR, distF)

    # survivor = min map-rank member of the chain (ranks capped to N)
    lab = torch.clamp(label, 0, NI - 1)
    combo = torch.where(alive, torch.clamp(rank, max=N) * NI + idx, BIG)
    cmin = scatter_min(NI, BIG, lab, combo, W)
    s_item = torch.where(alive, _take(cmin, lab) % NI, idx)
    s_safe = torch.clamp(s_item, 0, NI - 1)
    a_s = _take(a_u, s_safe)
    flip = ((a_u ^ a_s) == 1) & alive

    chain_items = scatter_max(NI, 0, lab, torch.where(alive, d_lo + 1, 0), W)
    n_items = _take(chain_items, lab)
    pos_u = torch.where(a_s == 0, d_lo, n_items - 1 - d_lo)
    pos_s = _take(pos_u, s_safe)

    # mer offset of each item within its new unitig: sort items by
    # (label, pos_u), run-prefix-sum merlen
    merlen = st["merlen"]
    ipk = torch.where(alive, (label << 13) | torch.clamp(pos_u, max=8191),
                      NI << 13)
    k1, perm = torch.sort(ipk, dim=1, stable=True)
    k1 = k1 >> 13
    ml_sorted = _take(merlen, perm)
    csum_ml = torch.cumsum(ml_sorted, dim=1)
    run_base = cummax(torch.where(_newrun(k1), csum_ml - ml_sorted, 0))
    start_off = torch.zeros((W, NI), dtype=torch.int64, device=dev).scatter_(
        1, perm, csum_ml - ml_sorted - run_base)

    # ---- mer-level composition -------------------------------------------
    mi = torch.clamp(st["mer_item"], 0, NI - 1)
    u_flip = _take(flip, mi)
    u_start = _take(start_off, mi)
    u_ml = _take(merlen, mi)
    mer_pos = st["mer_pos"]
    new_pos = u_start + torch.where(u_flip, u_ml - 1 - mer_pos, mer_pos)
    new_flip = st["mer_flip"] ^ u_flip
    klo, khi = st["keep_lo"], st["keep_hi"]
    klo2 = torch.where(u_flip, K - khi, klo)
    khi2 = torch.where(u_flip, K - klo, khi)

    # junction trims: absorbed members lose K-1 donor entries at their
    # survivor-facing end, in new-unitig coordinates
    u_sitem = _take(s_item, mi)
    is_member = u_sitem != mi
    facing_low = _take(pos_u, mi) > _take(pos_s, mi)
    width = khi2 - klo2
    NM = mi.shape[1]
    mpk = torch.where(is_member, (mi << 13) | torch.clamp(new_pos, max=8191),
                      NI << 13)
    mk1, mperm = torch.sort(mpk, dim=1, stable=True)
    mk1 = mk1 >> 13
    wsort = _take(width, mperm)
    cw = torch.cumsum(wsort, dim=1)
    mbase = cummax(torch.where(_newrun(mk1), cw - wsort, 0))
    mtot = scatter_add(NI, torch.where(is_member, mi, NI - 1),
                       torch.where(is_member, width, 0), W)
    before = torch.zeros((W, NM), dtype=torch.int64, device=dev).scatter_(
        1, mperm, cw - wsort - mbase)
    after = _take(mtot, mi) - before - width
    cut_lo = torch.minimum(torch.clamp(K - 1 - before, min=0), width)
    cut_hi = torch.minimum(torch.clamp(K - 1 - after, min=0), width)
    klo3 = torch.where(is_member & facing_low, klo2 + cut_lo, klo2)
    khi3 = torch.where(is_member & ~facing_low, khi2 - cut_hi, khi2)

    # ---- edge updates ------------------------------------------------------
    lv = lnk["lnk_valid"].reshape(W, NI * 2)
    sb = startbit(e_dir)
    db = destbit(e_dir)
    consumed = e_alive & _take(lv, torch.clamp(e_src * 2 + sb, 0, NI * 2 - 1))
    es = torch.clamp(e_src, 0, NI - 1)
    ed = torch.clamp(e_dst, 0, NI - 1)
    nsb = sb ^ _take(flip, es).to(torch.int64)
    ndb = db ^ _take(flip, ed).to(torch.int64)
    nsrc = _take(s_item, es)
    ndst = _take(s_item, ed)
    ne_alive = e_alive & ~consumed
    loopback = ne_alive & (nsrc == ndst) & (e_src != e_dst)
    fallback = fallback | loopback.any(dim=1)
    moved = ne_alive & (nsrc != e_src)
    side_F = _take(pos_u, es) > _take(pos_s, es)
    nokey = torch.where(moved, Dcap * torch.where(side_F, 1, 2) + e_okey,
                        e_okey)

    # ---- item aggregate updates: 8 lanes, one scatter-add + one gather ---
    n_alive = alive & (s_item == idx)
    vals = torch.cat(
        [merlen[..., None], st["csum"], st["n_t"][..., None],
         st["is_tumor"].to(torch.int64)[..., None],
         st["is_normal"].to(torch.int64)[..., None]], dim=-1)  # [W,NI,8]
    tgt = torch.where(alive, lab, NI - 1)[..., None].expand(W, NI, 8)
    acc = torch.zeros((W, NI, 8), dtype=torch.int64, device=dev).scatter_add_(
        1, tgt, torch.where(alive[..., None], vals, 0))
    summed = torch.gather(acc, 1, lab[..., None].expand(W, NI, 8))

    out = dict(st)
    out.update(
        alive=n_alive,
        merlen=torch.where(n_alive, summed[..., 0], 0),
        csum=torch.where(n_alive[..., None], summed[..., 1:5], 0),
        n_t=torch.where(n_alive, summed[..., 5], 0),
        is_tumor=n_alive & (summed[..., 6] > 0),
        is_normal=n_alive & (summed[..., 7] > 0),
        e_src=torch.where(ne_alive, nsrc, 0),
        e_dst=torch.where(ne_alive, ndst, 0),
        e_dir=torch.where(ne_alive, nsb * 2 + ndb, 0),
        e_alive=ne_alive, e_okey=nokey,
        mer_item=_take(s_item, mi),
        mer_flip=new_flip, mer_pos=new_pos,
        keep_lo=klo3, keep_hi=khi3)
    return out, fallback
