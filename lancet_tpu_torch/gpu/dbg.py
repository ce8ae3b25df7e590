"""Batched colored de Bruijn graph (DBG) build for one k, in PyTorch ops.

The JAX package's `tpu/dbg.py::build_k` over a window batch axis [W, ...]:
mer instances from the padded read tensors, canonical packed mers, a stable
sort and unique into nodes in creation order, segment-summed coverage and
quality per class, the canonical-pair edge dedup, the fused markRefNodes +
removeLowCov prune, the reference coverage projection and the per-window
fallback flags (ref: src/Graph.cc:119-589, :2233-2248, :2790-2827;
src/Ref.cc:173-250).

Mers are packed 2 bits a base (A=0 C=1 G=2 T=3) into int64 words of 31
bases, most significant word first, the LAST word full: word i of NW =
ceil(K/31) covers bases [K-31*(NW-i), K-31*(NW-1-i)) (clipped at 0), first
base most significant. Every word is below 2^62, so signed order equals
base order, and the word tuple orders lexicographically (torch has no
shifts, compares or gathers on uint32/uint64; the JAX package packs uint32
words instead). k = 63 takes 3 words. `pack.words_to_128` gives the
(hi64, lo64) halves the native rank kernel reads.

Integer tensors are int64 throughout; the arithmetic is the JAX package's
int32 arithmetic, which never overflows at the engine's shapes.

The build is four stages, each the plain version of a kernel of
csrc/dbg.cu (gpu/dbgk.py): mer_instances_plain (the instance table),
window_sort_plain (every stable sort of the build), node_tables_plain and
edge_tables_plain; build_k_plain composes them. build_k runs build_k_plain
on the CPU and the kernels on a card.
"""

from __future__ import annotations

import torch

from .pack import S_NML, S_REF, S_TMR

I32_MAX = 2**31 - 1
BIG = 1 << 30
SENT = 1 << 62  # above every packed word: invalid instances sort last


def fliplink(d):
    """Edge reversal (ref: Edge.hh:103-111): FF<->RR, FR/RF fixed."""
    return ((d & 1) ^ 1) * 2 + ((d >> 1) ^ 1)


def nwords(K: int) -> int:
    """int64 words of 31 bases for a k-mer."""
    return (K + 30) // 31


def _pack_mers(bases, K):
    """[..., L] base codes -> (fwd_words, rc_words, valid) packed k-mers at
    every offset m in [0, L-K]; valid = all K bases < 4."""
    L = bases.shape[-1]
    M = L - K + 1
    NW = nwords(K)
    b = bases.to(torch.int64)
    shape = bases.shape[:-1] + (M,)
    fw = [torch.zeros(shape, dtype=torch.int64, device=b.device)
          for _ in range(NW)]
    rw = [torch.zeros(shape, dtype=torch.int64, device=b.device)
          for _ in range(NW)]
    bad = torch.zeros(shape, dtype=torch.bool, device=b.device)
    for j in range(K):
        bj = b[..., j:j + M]
        bad |= bj >= 4
        bjc = bj & 3
        q = K - 1 - j  # base j's distance from the mer's last base
        fw[NW - 1 - q // 31] |= bjc << (2 * (q % 31))
        # the reverse complement holds comp(b_j) at distance j from its end
        rw[NW - 1 - j // 31] |= (bjc ^ 3) << (2 * (j % 31))
    return fw, rw, ~bad


def lex_less(aw, bw):
    """Word-tuple comparison (most significant word first) ==
    lexicographic base comparison."""
    lt = torch.zeros_like(aw[0], dtype=torch.bool)
    eq = torch.ones_like(aw[0], dtype=torch.bool)
    for a, b in zip(aw, bw):
        lt |= eq & (a < b)
        eq &= a == b
    return lt


def words_eq_adjacent(words):
    """[..., I] word list -> mask of positions where row i equals row i-1
    along the last axis."""
    eq = None
    for wd in words:
        e = wd[..., 1:] == wd[..., :-1]
        eq = e if eq is None else (eq & e)
    return eq


def lexsort(keys, dim: int = 1):
    """Stable sort permutation along `dim` by several keys, the first the
    most significant: `jax.lax.sort(keys, num_keys, is_stable=True)`, as
    a chain of stable sorts from the least significant key."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else torch.gather(k, dim, perm)
        o = torch.sort(kk, dim=dim, stable=True).indices
        perm = o if perm is None else torch.gather(perm, dim, o)
    return perm


def cummax(x, dim: int = 1):
    return torch.cummax(x, dim=dim).values


def seg_sum(vals, seg, nseg):
    """Segment sum of `vals` [n, ...] by `seg` [n] into [nseg, ...]."""
    out = torch.zeros((nseg,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)


def seg_min(vals, seg, nseg, init):
    """Segment min of `vals` [n, ...] by `seg` [n] into [nseg, ...]; empty
    segments hold `init` (the JAX segment_min identity where it matters)."""
    out = torch.full((nseg,) + tuple(vals.shape[1:]), init, dtype=vals.dtype,
                     device=vals.device)
    idx = seg.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, "amin", include_self=True)


# ---------------------------------------------------------------------------
# the build's four stages, each the plain version of a kernel of
# csrc/dbg.cu (gpu/dbgk.py): mer_instances, window_sort, node_tables,
# edge_tables
# ---------------------------------------------------------------------------

# mer_instances' payload, one int64 an instance: bits 0-31 the time of a
# read or ref-read instance as int32 (BIG for every other instance), then
# one bit a flag, and bits 48-55 the mate order of a paired read instance
P_VALID, P_READ, P_IDX, P_STRAND, P_TFLAG, P_ISF, P_PAIR = range(32, 39)
P_TMR, P_NML, P_REF = 40, 41, 42  # the instance's sample
P_ORDER = 48


def pay_bit(pay, b):
    return ((pay >> b) & 1).to(torch.bool)


def pay_time(pay):
    """The int32 time of bits 0-31, sign-extended."""
    t = pay & 0xFFFFFFFF
    return t - ((t >> 31) << 32)


def mer_instances_plain(K, bases, quals, rlen, rsample, rstrand, rfrag,
                        rorder, raw, rawlen, seq_off, seq_len, window_ok,
                        *, Lraw, min_qual_call):
    """The instance table of a window batch: the read mers [R*M], the
    ref pseudo-read's, the projection's and the index's [Mraw each], in
    that order along I = R*M + 3*Mraw. Returns {"keys": [NW, W, I] int64
    sort words (SENT where invalid), "pay": [W, I] int64 payload (the
    P_* bits), "qok": [W, I] int64 per-base quality bits of a read
    instance's canonical mer (0 elsewhere), "fkeys": [NW+1, W, R*M] int64
    mate-overlap sort words (SENT where unpaired) and fragment
    (I32_MAX)}."""
    dev = bases.device
    W, R, L = bases.shape
    M = L - K + 1
    Mraw = Lraw - K + 1
    i64 = torch.int64

    def zeros(*shape, dtype=i64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v, dtype=i64):
        return torch.full(shape, v, dtype=dtype, device=dev)

    def ar(n):
        return torch.arange(n, dtype=i64, device=dev)

    rlen = rlen.to(i64)
    rawlen = rawlen.to(i64)
    seq_off = seq_off.to(i64)
    seq_len = seq_len.to(i64)

    # ---- read-mer instances ---------------------------------------------
    NW = nwords(K)
    fw, rw, bvalid = _pack_mers(bases, K)  # [W, R, M] per word
    isF = lex_less(fw, rw)
    mw = [torch.where(isF, fw[i], rw[i]) for i in range(NW)]

    n_mers = torch.clamp(rlen - K + 1, min=0)
    use_read = (rlen - K) > 0  # reads with a single mer are skipped
    moff = ar(M)[None, None, :]
    inst_valid = use_read[:, :, None] & (moff < n_mers[:, :, None]) & bvalid

    # per-pair quality gate: all K+1 quals >= minq
    qbad = (quals < min_qual_call).to(i64)
    cq = torch.cat([zeros(W, R, 1), torch.cumsum(qbad, dim=-1)], dim=-1)
    MP = L - K
    pairq = (cq[..., K + 1:K + 1 + MP] - cq[..., :MP]) == 0
    pairq = torch.cat([pairq, zeros(W, R, M - MP, dtype=torch.bool)], -1)

    # per-base qual-ok of the canonical-oriented mer, bit j of one int64
    qge = (quals >= min_qual_call).to(i64)
    qok_f = zeros(W, R, M)
    qok_r = zeros(W, R, M)
    for j in range(K):
        col = qge[..., j:j + M]
        qok_f |= col << j
        qok_r |= col << (K - 1 - j)
    qok_bits = torch.where(isF, qok_f, qok_r)

    # stream position of each instance within the window; the ref
    # pseudo-read comes last
    flat_valid = inst_valid.reshape(W, R * M)
    g = (torch.cumsum(flat_valid.to(i64), dim=1) - 1).reshape(W, R, M)
    pos0 = moff == 0
    is_last = moff == (n_mers[:, :, None] - 1)
    t_read = 2 * g - (~pos0).to(i64)
    n_read_inst = flat_valid.sum(dim=1)

    # ---- ref-read / proj / index instances -------------------------------
    p_fw, p_rw, p_ok = _pack_mers(raw, K)  # [W, Mraw] per word
    p_isF = lex_less(p_fw, p_rw)
    p_w = [torch.where(p_isF, p_fw[i], p_rw[i]) for i in range(NW)]
    roff = ar(Mraw)[None, :]
    ref_nmers = torch.clamp(rawlen - K + 1, min=0)
    ref_use = (rawlen - K) > 0
    ref_valid = (roff < ref_nmers[:, None]) & p_ok & ref_use[:, None]
    ref_g = n_read_inst[:, None] + roff
    ref_pos0 = roff == 0
    ref_last = roff == (ref_nmers[:, None] - 1)
    t_ref = 2 * ref_g - (~ref_pos0).to(i64)
    proj_valid = (roff < (rawlen[:, None] - K + 1)) & p_ok
    idx_pos = seq_off[:, None] + roff
    idx_valid = (roff < (seq_len[:, None] - K)) & (idx_pos < Mraw)
    ip = torch.clamp(idx_pos, 0, Mraw - 1)
    i_w = [torch.gather(p_w[i], 1, ip) for i in range(NW)]
    idx_valid = idx_valid & torch.gather(p_ok, 1, ip)

    # ---- combined instance table: read, ref-read, proj, index parts ------
    def cat(a_read, a_ref, a_proj, a_idx):
        return torch.cat([a_read.reshape(W, R * M), a_ref, a_proj, a_idx],
                         dim=1)

    okW = window_ok[:, None]
    zero_b = zeros(W, Mraw, dtype=torch.bool)
    zero_i = zeros(W, Mraw)
    a_w = [cat(mw[i], p_w[i], p_w[i], i_w[i]) for i in range(NW)]
    a_valid = cat(inst_valid, ref_valid, proj_valid, idx_valid) & okW
    a_isread = cat(inst_valid, ref_valid, zero_b, zero_b) & okW
    a_isidx = cat(zeros(W, R, M, dtype=torch.bool), zero_b, zero_b,
                  idx_valid) & okW
    a_time = cat(t_read, t_ref, full((W, Mraw), BIG), full((W, Mraw), BIG))
    samp = rsample.to(i64)[:, :, None].expand(W, R, M)
    a_samp = cat(samp, full((W, Mraw), S_REF), full((W, Mraw), 7),
                 full((W, Mraw), 7))
    strd = (rstrand != 0)[:, :, None].expand(W, R, M)
    a_strand = cat(strd, zero_b, zero_b, zero_b)
    a_qok = cat(qok_bits, zero_i, zero_i, zero_i)
    pair_ok = pairq & (samp == S_TMR) & ~is_last & inst_valid
    prev_pair_ok = torch.cat([zeros(W, R, 1, dtype=torch.bool),
                              pair_ok[:, :, :-1]], dim=2)
    a_tflag = cat(pair_ok | prev_pair_ok, zero_b, zero_b, zero_b)
    a_isF = cat(isF, p_isF, p_isF, zero_b)
    # the u side of an adjacent pair: read mer m and m+1, ref mer r, r+1
    a_pair = cat(inst_valid & ~is_last, ref_valid & ~ref_last, zero_b,
                 zero_b) & okW

    # ---- mate-overlap keys -------------------------------------------------
    IP = R * M
    frag = rfrag.to(i64)[:, :, None].expand(W, R, M).reshape(W, IP)
    order_r = rorder.to(i64)[:, :, None].expand(W, R, M).reshape(W, IP)
    paired = (order_r > 0) & flat_valid
    fkey_w = [torch.where(paired, mw[i].reshape(W, IP), SENT)
              for i in range(NW)]
    fkey_fr = torch.where(paired, frag, I32_MAX)
    fo = torch.where(paired, order_r, 0)

    tm = torch.where(a_isread, a_time, BIG) & 0xFFFFFFFF
    flags = ((a_valid, P_VALID), (a_isread, P_READ), (a_isidx, P_IDX),
             (a_strand, P_STRAND), (a_tflag, P_TFLAG), (a_isF, P_ISF),
             (a_pair, P_PAIR), (a_samp == S_TMR, P_TMR),
             (a_samp == S_NML, P_NML), (a_samp == S_REF, P_REF))
    pay = tm
    for f, b in flags:
        pay = pay | (f.to(i64) << b)
    pay = pay | (torch.cat([fo, zeros(W, 3 * Mraw)], dim=1) << P_ORDER)
    keys = torch.stack([torch.where(a_valid, a_w[i], SENT)
                        for i in range(NW)])
    return {"keys": keys, "pay": pay, "qok": a_qok,
            "fkeys": torch.stack(fkey_w + [fkey_fr])}


def window_sort_plain(keys):
    """The stable sort permutation [W, n] int64 of keys [NK, W, n] along
    the window axis, key 0 the most significant (lexsort)."""
    return lexsort(list(keys))


def node_tables_plain(K, inst, perm, rawlen, totalreadbp, *, N,
                      low_cov_threshold, min_cov_ratio):
    """The node tables in creation order from the instance table and its
    sort permutation `perm` [W, I]: the groups of equal mers (at most N a
    window), their per-class counts and quality counts, flags, the
    creation order (a window_sort of each group's first read time), and
    the fused markRefNodes + removeLowCov prune. Also "nid" [W, I], each
    instance's node in creation order (-1 invalid or past N), and
    "over_n" [W]."""
    keys, pay, qok = inst["keys"], inst["pay"], inst["qok"]
    dev = perm.device
    NW = keys.shape[0]
    W, I = perm.shape
    i64 = torch.int64

    def ar(n):
        return torch.arange(n, dtype=i64, device=dev)

    rawlen = rawlen.to(i64)
    wid = ar(W)[:, None].expand(W, I)

    def gather(a):
        return torch.gather(a, 1, perm)

    s_w = [gather(keys[i]) for i in range(NW)]
    s_pay = gather(pay)
    s_valid = pay_bit(s_pay, P_VALID)
    s_isread = pay_bit(s_pay, P_READ)
    s_isidx = pay_bit(s_pay, P_IDX)
    s_strand = pay_bit(s_pay, P_STRAND)
    s_tflag = pay_bit(s_pay, P_TFLAG)
    s_tmr = pay_bit(s_pay, P_TMR)
    s_time = pay_time(s_pay)  # BIG where not a read instance
    s_qok = gather(qok)

    # group boundaries per window
    newg = torch.ones((W, I), dtype=torch.bool, device=dev)
    newg[:, 1:] = ~words_eq_adjacent(s_w)
    newg &= s_valid
    gid_in_w = torch.cumsum(newg.to(i64), dim=1) - 1
    n_groups = torch.where(s_valid, gid_in_w + 1, 0).max(dim=1).values
    over_n = n_groups > N

    # segment aggregates over [W, N+1]; slot N is the dump segment
    NS = N + 1
    seg = torch.where(s_valid, torch.clamp(gid_in_w, max=N), N)
    seg_full = (wid * NS + seg).reshape(-1)

    is_cov = s_isread & ~pay_bit(s_pay, P_REF)
    cls = torch.where(s_tmr, 0, 2) + s_strand.to(i64)
    seg4 = torch.where(is_cov & (gid_in_w < N) & s_valid,
                       gid_in_w * 4 + cls, 4 * N)
    seg4_full = (wid * (4 * N + 1) + seg4).reshape(-1)
    cnt4 = seg_sum(torch.ones(W * I, dtype=i64, device=dev), seg4_full,
                   W * (4 * N + 1)).reshape(W, 4 * N + 1)
    cnt4 = cnt4[:, :4 * N].reshape(W, N, 4)

    # per-base qual-ok counts [W, N, 4, K]
    qbase = ((s_qok[:, :, None] >> ar(K)) & 1).to(torch.int32)
    mq4 = seg_sum(qbase.reshape(W * I, K), seg4_full, W * (4 * N + 1))
    mq4 = mq4.reshape(W, 4 * N + 1, K)[:, :4 * N].reshape(W, N, 4, K)

    any4 = seg_sum(torch.stack(
        [s_isread, s_isidx, s_isread & pay_bit(s_pay, P_NML), s_tflag],
        dim=-1).to(torch.int32).reshape(W * I, 4), seg_full,
        W * NS).reshape(W, NS, 4)[:, :N] > 0
    has_node, in_index, is_normal, is_tumor = (
        any4[..., 0], any4[..., 1], any4[..., 2], any4[..., 3])

    first_time = seg_min(s_time.reshape(-1), seg_full, W * NS,
                         I32_MAX).reshape(W, NS)[:, :N]
    gw_min = seg_min(torch.stack(s_w, dim=-1).reshape(W * I, NW), seg_full,
                     W * NS, SENT).reshape(W, NS, NW)[:, :N]
    # groups without instances read as all-T mers, as the JAX build's
    # empty segments (uint32 max words) do
    for i, n in enumerate([K - 31 * (NW - 1)] + [31] * (NW - 1)):
        gw_min[..., i] = torch.where(gw_min[..., i] == SENT,
                                     (1 << (2 * n)) - 1, gw_min[..., i])

    # ---- creation order --------------------------------------------------
    node_key = torch.where(has_node, first_time, BIG)
    order = window_sort_plain(node_key[None])  # crea -> group
    crea_of_group = torch.zeros((W, N), dtype=i64, device=dev).scatter_(
        1, order, ar(N)[None, :].expand(W, N))
    n_nodes = has_node.sum(dim=1)

    def to_crea(a):
        idx = order.reshape((W, N) + (1,) * (a.dim() - 2)).expand(a.shape)
        return torch.gather(a, 1, idx)

    g_w = to_crea(gw_min)
    mers_w = tuple(g_w[..., i] for i in range(NW))
    counts = to_crea(cnt4)  # [W, N, 4]: tmr fwd, tmr rev, nml fwd, nml rev
    mq = to_crea(mq4).permute(0, 1, 3, 2)  # [W, N, K, 4]
    n_exists = to_crea(has_node)

    # ---- prune (fused markRefNodes + removeLowCov(False, 0)) ------------
    totq = mq.sum(dim=-1).to(i64)  # [W, N, K]
    mincov_qv = torch.where(n_exists, totq.min(dim=-1).values, 0)
    tot_t = counts[..., 0] + counts[..., 1]
    tot_n = counts[..., 2] + counts[..., 3]
    avgcov = totalreadbp.to(torch.float32) / torch.clamp(
        rawlen.to(torch.float32), min=1.0)
    low = ((mincov_qv <= low_cov_threshold)
           | (mincov_qv.to(torch.float32)
              <= min_cov_ratio * avgcov[:, None])
           | ((tot_t == 1) & (tot_n == 1)))

    # each instance's node: the creation slot of its group
    crea_inst = torch.gather(crea_of_group, 1,
                             torch.clamp(gid_in_w, 0, N - 1))
    crea_inst = torch.where(s_valid & (gid_in_w < N), crea_inst, -1)
    nid = torch.full((W, I), -1, dtype=i64, device=dev).scatter_(
        1, perm, crea_inst)
    return {
        "mers_w": mers_w, "counts": counts, "mq": mq, "totq": totq,
        "mincov_qv": mincov_qv, "exists": n_exists,
        "alive": n_exists & ~low, "low": low,
        "in_index": to_crea(in_index), "is_tumor": to_crea(is_tumor),
        "is_normal": to_crea(is_normal), "n_nodes": n_nodes,
        "avgcov": avgcov, "rawlen_dev": rawlen, "nid": nid,
        "over_n": over_n}


def edge_tables_plain(K, inst, nodes, window_ok, *, R, L, N, E, D, Lraw):
    """The edge tables from the instance table and the node tables: the
    canonical pairs of adjacent read and ref-read mers deduplicated with
    their two first-occurrence times (a window_sort of the pair keys), the
    directed rows in time order truncated to E (a window_sort of the
    times), the per-node out-edge adjacency (a window_sort of the
    sources), the reference coverage projection, the mate-overlap
    candidates (a window_sort of the mate keys) and the fallback flags."""
    pay, nid, fkeys = inst["pay"], nodes["nid"], inst["fkeys"]
    counts, n_in_index = nodes["counts"], nodes["in_index"]
    rawlen = nodes["rawlen_dev"]
    dev = pay.device
    W = pay.shape[0]
    M = L - K + 1
    Mraw = Lraw - K + 1
    NW = fkeys.shape[0] - 1
    i64 = torch.int64

    def zeros(*shape, dtype=i64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v, dtype=i64):
        return torch.full(shape, v, dtype=dtype, device=dev)

    def ar(n):
        return torch.arange(n, dtype=i64, device=dev)

    RM = R * M
    isF = pay_bit(pay, P_ISF)
    nid_read = nid[:, :RM].reshape(W, R, M)
    nid_ref = nid[:, RM:RM + Mraw]
    nid_proj = nid[:, RM + Mraw:RM + 2 * Mraw]
    p_isF = isF[:, RM:RM + Mraw]

    # the pair u -> v at time 2p, v -> u at 2p + 1: p the u instance's
    # stream position (its time plus one past a read's first mer)
    moff = ar(M)[None, None, :].expand(W, R, M).reshape(W, RM)
    roff = ar(Mraw)[None, :]
    t_u = pay_time(pay[:, :RM + Mraw]) + (
        torch.cat([moff, roff.expand(W, Mraw)], dim=1) > 0).to(i64)

    u = nid_read.reshape(W, RM)
    v = torch.cat([nid_read[:, :, 1:], full((W, R, 1), -1)],
                  dim=2).reshape(W, RM)
    uF = isF[:, :RM]
    isF_read = uF.reshape(W, R, M)
    vF = torch.cat([isF_read[:, :, 1:], zeros(W, R, 1, dtype=torch.bool)],
                   dim=2).reshape(W, RM)
    rv = torch.cat([nid_ref[:, 1:], full((W, 1), -1)], dim=1)
    rvF = torch.cat([p_isF[:, 1:], zeros(W, 1, dtype=torch.bool)], dim=1)

    PU = RM + Mraw
    pu_src = torch.cat([u, nid_ref], dim=1)
    pu_dst = torch.cat([v, rv], dim=1)
    pu_uF = torch.cat([uF, p_isF], dim=1)
    pu_vF = torch.cat([vF, rvF], dim=1)
    pu_m = pay_bit(pay[:, :PU], P_PAIR)
    fdir = (1 - pu_uF.to(i64)) * 2 + (1 - pu_vF.to(i64))
    rdir = fliplink(fdir)

    # dedup the canonical form of each pair (the lexicographic min of the
    # directed triple and its twin), carrying two time lanes, then emit
    # the two directed rows per canonical group
    use_tw = (pu_dst < pu_src) | ((pu_dst == pu_src) & (rdir < fdir))
    ck_s = torch.where(use_tw, pu_dst, pu_src)
    ck_d = torch.where(use_tw, pu_src, pu_dst)
    ck_r = torch.where(use_tw, rdir, fdir)
    NODECAP = N + 64
    ckey = torch.where(pu_m, (ck_s * NODECAP + ck_d) * 4 + ck_r, I32_MAX)
    tA = torch.where(pu_m & ~use_tw, t_u, BIG)
    tB = torch.where(pu_m & use_tw, t_u, BIG)
    cperm = window_sort_plain(ckey[None])
    ck = torch.gather(ckey, 1, cperm)
    sA = torch.gather(tA, 1, cperm)
    sB = torch.gather(tB, 1, cperm)
    enew = torch.ones((W, PU), dtype=torch.bool, device=dev)
    enew[:, 1:] = ck[:, 1:] != ck[:, :-1]
    ev = ck != I32_MAX
    enew &= ev
    egid = torch.cumsum(enew.to(i64), dim=1) - 1
    n_canon = torch.where(ev, egid + 1, 0).max(dim=1).values
    EC = E
    wid_p = ar(W)[:, None].expand(W, PU)
    eseg = (wid_p * (EC + 1)
            + torch.where(ev, torch.clamp(egid, max=EC), EC)).reshape(-1)
    emin = seg_min(torch.stack([ck, sA, sB], dim=-1).reshape(W * PU, 3),
                   eseg, W * (EC + 1), I32_MAX).reshape(W, EC + 1, 3)[:, :EC]
    g_ck, g_tA, g_tB = emin[..., 0], emin[..., 1], emin[..., 2]
    g_exists = g_ck != I32_MAX
    g_dir = torch.where(g_exists, g_ck % 4, 0)
    g_dst = torch.where(g_exists, (g_ck // 4) % NODECAP, 0)
    g_srcn = torch.where(g_exists, g_ck // (4 * NODECAP), 0)
    t_canon = torch.minimum(g_tA, torch.clamp(g_tB, max=BIG - 1) + 1)
    t_twin = torch.minimum(g_tB, torch.clamp(g_tA, max=BIG - 1) + 1)
    # palindromic self-loops (src==dst, dir FR/RF) are their own twin
    selftw = g_exists & (g_srcn == g_dst) & ((g_dir == 1) | (g_dir == 2))

    def cat2(a, b):
        return torch.cat([a, b], dim=1)

    de_src = cat2(g_srcn, g_dst)
    de_dst = cat2(g_dst, g_srcn)
    de_dir = cat2(g_dir, fliplink(g_dir))
    de_time = cat2(t_canon, t_twin)
    de_exists = cat2(g_exists, g_exists & ~selftw)
    n_edges = 2 * torch.clamp(n_canon, max=EC) - selftw.sum(dim=1)
    over_e = (n_edges > E) | (n_canon > EC)

    # order the directed rows by first-occurrence time, truncate to E
    et_key = torch.where(de_exists, de_time, BIG)
    eorder = window_sort_plain(et_key[None])[:, :E]
    ex_o = torch.gather(de_exists, 1, eorder)

    def e_to_time_order(a, fill):
        return torch.where(ex_o, torch.gather(a, 1, eorder), fill)

    edge_src = e_to_time_order(de_src, -1)
    edge_dst = e_to_time_order(de_dst, -1)
    edge_dir = e_to_time_order(de_dir, 0)
    edge_exists = edge_src >= 0

    # ---- per-node out-edge adjacency (time-ordered slots) ----------------
    ak_key = torch.where(edge_exists, edge_src, I32_MAX)
    aperm = window_sort_plain(ak_key[None])
    ak1 = torch.gather(ak_key, 1, aperm)
    aidx = ar(E)[None, :].expand(W, E)
    anew = torch.ones((W, E), dtype=torch.bool, device=dev)
    anew[:, 1:] = ak1[:, 1:] != ak1[:, :-1]
    slot = aidx - cummax(torch.where(anew, aidx, 0))
    a_exists = torch.gather(edge_exists, 1, aperm)
    over_d = torch.where(a_exists, slot + 1, 0).max(dim=1).values > D
    wid_a = ar(W)[:, None].expand(W, E)
    NS = N + 1
    # a source past N (the twin of a pair whose two mers are past N, in
    # an over_n window) is dropped from adj, and counts in deg where its
    # segment id wid * NS + src falls, as the JAX build's scatter and
    # segment_sum with their out-of-range ids dropped
    srcs = torch.where(a_exists & (slot < D) & (ak1 < N), ak1, N)
    adj = torch.full((W, N + 1, D), -1, dtype=i64, device=dev)
    adj[wid_a, srcs, torch.clamp(slot, max=D - 1)] = aperm
    adj = adj[:, :N]
    dseg = wid_a * NS + torch.where(a_exists, ak1, N)
    dseg = torch.where(dseg < W * NS, dseg, W * NS)
    deg = seg_sum(a_exists.to(i64).reshape(-1), dseg.reshape(-1),
                  W * NS + 1)[:W * NS].reshape(W, NS)[:, :N]

    # ---- reference coverage projection (Ref.cc:173-250) -----------------
    safe = torch.clamp(nid_proj, 0, N - 1)

    def proj_val(c):
        val = torch.where(n_in_index & (counts[..., c] > 0), counts[..., c], 0)
        return torch.where(nid_proj >= 0, torch.gather(val, 1, safe), 0)

    pvals = torch.stack([proj_val(c) for c in range(4)], dim=-1)
    n_proj = torch.clamp(rawlen - K, min=0)
    pvalid = roff < n_proj[:, None]
    refcov = torch.zeros((W, Lraw, 4), dtype=i64, device=dev)
    # mer i covers base i+K-1; mer 0 covers bases 0..K-1
    refcov[:, K - 1:, :] = torch.where(pvalid[:, :, None], pvals,
                                       0)[:, :Lraw - K + 1, :]
    first_row = torch.where((n_proj > 0)[:, None], pvals[:, 0, :], 0)
    refcov[:, :K - 1, :] = first_row[:, None, :]

    # ---- mate-overlap candidates -----------------------------------------
    # a run of (mer, fragment) holding both mate orders of one fragment
    # makes the window a hasOverlappingMate candidate (Graph.cc:232-317)
    fperm = window_sort_plain(fkeys)
    fo = (pay[:, :RM] >> P_ORDER) & 0xFF
    ff = torch.gather(fkeys[NW], 1, fperm)
    ford = torch.gather(fo, 1, fperm)
    same = (words_eq_adjacent([torch.gather(fkeys[i], 1, fperm)
                               for i in range(NW)])
            & (ff[:, 1:] == ff[:, :-1]) & (ff[:, 1:] != I32_MAX))
    cand = (same & (ford[:, 1:] != ford[:, :-1]) & (ford[:, 1:] > 0)
            & (ford[:, :-1] > 0))
    mate_cand = cand.any(dim=1) & window_ok

    fallback = (nodes["over_n"] | over_e | over_d | mate_cand) & window_ok
    return {"n_edges": n_edges, "edge_src": edge_src, "edge_dst": edge_dst,
            "edge_dir": edge_dir, "edge_exists": edge_exists, "adj": adj,
            "deg": deg, "nid_proj": nid_proj, "proj_isF": p_isF,
            "refcov": refcov, "mate_cand": mate_cand, "fallback": fallback}


# the keys of a build's output, in the JAX build_k's order
BUILD_KEYS = ("mers_w", "counts", "mq", "totq", "mincov_qv", "exists",
              "alive", "low", "in_index", "is_tumor", "is_normal", "n_nodes",
              "n_edges", "edge_src", "edge_dst", "edge_dir", "edge_exists",
              "adj", "deg", "nid_proj", "proj_isF", "refcov", "avgcov",
              "rawlen_dev", "mate_cand", "fallback")


def build_k_plain(K, bases, quals, rlen, rsample, rstrand, rfrag, rorder,
                  raw, rawlen, seq_off, seq_len, totalreadbp, window_ok,
                  *, N, E, D, Lraw, min_qual_call,
                  low_cov_threshold, min_cov_ratio):
    """One k attempt's graph build for a window batch (tensors on one
    device, as pack.WindowBatch lays them out), in PyTorch ops: the four
    stages' plain versions, mer_instances_plain, window_sort_plain,
    node_tables_plain and edge_tables_plain.

    Returns a dict of node/edge tables in creation order plus refcov and
    the per-window fallback flags, keyed as the JAX build_k's (BUILD_KEYS);
    "mers_w" is the tuple of int64 words of this module's packing."""
    _, R, L = bases.shape
    inst = mer_instances_plain(K, bases, quals, rlen, rsample, rstrand,
                               rfrag, rorder, raw, rawlen, seq_off, seq_len,
                               window_ok, Lraw=Lraw,
                               min_qual_call=min_qual_call)
    perm = window_sort_plain(inst["keys"])
    nodes = node_tables_plain(K, inst, perm, rawlen, totalreadbp, N=N,
                              low_cov_threshold=low_cov_threshold,
                              min_cov_ratio=min_cov_ratio)
    edges = edge_tables_plain(K, inst, nodes, window_ok, R=R, L=L, N=N, E=E,
                              D=D, Lraw=Lraw)
    out = {**nodes, **edges}
    return {k: out[k] for k in BUILD_KEYS}


def build_k(K, bases, quals, rlen, rsample, rstrand, rfrag, rorder,
            raw, rawlen, seq_off, seq_len, totalreadbp, window_ok,
            *, N, E, D, Lraw, min_qual_call,
            low_cov_threshold, min_cov_ratio):
    """One k attempt's graph build (build_k_plain's arguments and
    outputs): the plain stages on the CPU, the kernels of csrc/dbg.cu on a
    card (gpu.dbgk.build_k)."""
    from .dbgk import build_k as build

    return build(K, bases, quals, rlen, rsample, rstrand, rfrag, rorder,
                 raw, rawlen, seq_off, seq_len, totalreadbp, window_ok,
                 N=N, E=E, D=D, Lraw=Lraw, min_qual_call=min_qual_call,
                 low_cov_threshold=low_cov_threshold,
                 min_cov_ratio=min_cov_ratio)
