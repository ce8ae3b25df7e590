"""The device graph engine's cleanup loops (`lancet_tpu_torch.gpu.cleanup`,
`csrc/cleanup.cu`) and the cleanup around them on the CPU, against the JAX
package.

- `pipeline.short_link_strings_plain` (the STR guard's string assembly)
  with the guard's probe and scatter bit-equal to the JAX
  `_short_link_str_guard` on every crafted batch of `gpu.cleanupcases`
  (the strings and lengths the JAX function hands its probe, and the
  guard), at the cleanup's input and after its tips fixpoint;
- the port's `cleanup` on the CPU (the card's composition, its two loops
  run by their plain versions) and `cleanup_plain` (the composition with
  host bools) bit-equal to the JAX `cleanup` (jitted) on every batch, the
  state and the fallback, with and without pre_fb (mer_pos on the mers of
  alive items: the JAX item sorts are unstable, which leaves the order of
  dead items, and their mers' positions, open);
- the batch-wide loop: run window by window, the cleanup differs (an extra
  compress renumbers okeys), so the kernel keeps the batch's hit;
- a numpy replay of the `short_link_strings` kernel (the chunked scan of
  the candidates, the packed (j, mer) write keys, the gather) bit-equal to
  its plain version;
- the plans and their refusals, the dispatch on the CPU, and the build's
  cache key over the headers a source includes.

The `cuda` test holds each kernel and the cleanup bit-equal to their plain
versions on every batch on the card, dtypes too, one launch a call and no
host sync.
"""

import functools

import numpy as np
import pytest
import torch

from lancet_tpu_torch import _build
from lancet_tpu_torch.gpu import cleanup as ck
from lancet_tpu_torch.gpu import cleanupcases as cl
from lancet_tpu_torch.gpu import pipeline as tpl
from lancet_tpu_torch.gpu import stages, walks

torch.set_num_threads(1)

BATCHES = ("engine", "w1")


@functools.lru_cache(maxsize=None)
def _batch(tag):
    return dict((n, (a, K)) for n, a, K in cl.batches())[tag]


def _jax_state(arrs):
    import jax.numpy as jnp

    out = {}
    for k, v in arrs.items():
        if v.dtype == bool:
            out[k] = jnp.asarray(v)
        else:
            out[k] = jnp.asarray(v.astype(
                np.int8 if k in ("e_dir", "mer_base") else np.int32))
    return out


def _eq(want, got, what):
    a = np.asarray(want)
    b = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = a != b.astype(a.dtype)
    assert not bad.any(), (what, np.argwhere(bad)[:5])


def _cand(st, max_link):
    merlen = st["merlen"]
    return (st["alive"] & ~st["special"] & (merlen < max_link)
            & (merlen > 0))


def _after_tips(arrs, K):
    """The batch's state after the cleanup's low-coverage pass, compress
    and tips fixpoint (the short-link stage's input), on the CPU."""
    st, K, N, NI, cfg, avg = cl.inputs(arrs, K)
    st, _ = stages.low_cov_pass(st, K, N, NI, cfg["low_cov_threshold"],
                                cfg["min_cov_ratio"], avg)
    st, fb = stages.compress_round(st, K, NI, N)
    st, _ = tpl.tip_fixpoint_plain(st, ("tips", cfg["max_tip_len"]), K, N,
                                   NI, cl.U, cl.D2, cl.TIP_ROUNDS, fb)
    return st


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["input", "after_tips"])
@pytest.mark.parametrize("tag", BATCHES)
def test_short_link_strings_and_guard_equal_jax(tag, stage, monkeypatch):
    """The candidates' strings and lengths (what the JAX guard hands
    tandem_at) and the guard, eagerly in JAX, against the port's."""
    import lancet_tpu.tpu.pipeline as jpl

    arrs, K = _batch(tag)
    if stage == "after_tips":
        st = _after_tips(arrs, K)
        arrs = {k: v.numpy() for k, v in st.items()}
    else:
        st = cl.to_torch(arrs)
    NI = arrs["alive"].shape[1]
    N = NI - 2 * cl.CMAX
    cfg = cl.cfg_s(K)
    probed = []
    real = jpl.stages.tandem_at

    def spy(seqs, lens, *a):
        probed.append((np.asarray(seqs), np.asarray(lens)))
        return real(seqs, lens, *a)

    monkeypatch.setattr(jpl.stages, "tandem_at", spy)
    jst = _jax_state(arrs)
    jcand = _cand(jst, cfg["max_link_len"])
    args = (K, N, NI, cfg["max_unit_len"], cfg["min_report_units"],
            cfg["min_report_len"], cfg["dist_from_str"])
    want = jpl._short_link_str_guard(jst, jcand, *args)
    cand = _cand(st, cfg["max_link_len"])
    strings = tpl.short_link_strings_plain(st, cand, K, NI)
    W = cand.shape[0]
    _eq(probed[0][0], strings["seqs"].reshape(W * tpl._SL_ITEMS, -1),
        f"{tag} seqs")
    _eq(probed[0][1], strings["lens"].reshape(-1), f"{tag} lens")
    got = tpl._short_link_str_guard(st, cand, *args)
    _eq(want, got, f"{tag} guard")
    if tag == "engine" and stage == "input":
        _, names, _ = cl.engine_batch()
        n_cand = cand.sum(dim=1)
        assert int(n_cand[names.index("many_cands")]) > tpl._SL_ITEMS
        assert bool(got[names.index("links")].any())  # the repeat kept
        # clamped positions met in the colliding window's string
        assert (strings["slot_item"] >= 0).any()


@functools.lru_cache(maxsize=None)
def _jax_cleanup(tag, with_pre_fb):
    import jax

    import lancet_tpu.tpu.pipeline as jpl

    arrs, K = _batch(tag)
    NI = arrs["alive"].shape[1]
    N = NI - 2 * cl.CMAX
    W = arrs["alive"].shape[0]
    avg = np.full((W,), cl.AVGCOV, np.float32)
    pre = (np.arange(W) % 3 == 1) if with_pre_fb else None
    fn = jax.jit(lambda s, a, p: jpl.cleanup(
        s, K, N, NI, cl.cfg_s(K), a, U=cl.U, D2=cl.D2,
        TIP_ROUNDS=cl.TIP_ROUNDS, pre_fb=p))
    st, fb = fn(_jax_state(arrs), avg, pre)
    return jax.tree_util.tree_map(np.asarray, st), np.asarray(fb), pre


@pytest.mark.parametrize("with_pre_fb", [False, True])
@pytest.mark.parametrize("tag", BATCHES)
def test_cleanup_equals_jax(tag, with_pre_fb):
    """The port's cleanup on the CPU (the card's composition with its
    loops' plain versions) and cleanup_plain (host bools) against the JAX
    cleanup, jitted: every key of the state and the fallback."""
    arrs, K = _batch(tag)
    jst, jfb, pre = _jax_cleanup(tag, with_pre_fb)
    args = cl.inputs(arrs, K)
    kw = dict(U=cl.U, D2=cl.D2, TIP_ROUNDS=cl.TIP_ROUNDS,
              pre_fb=None if pre is None else torch.from_numpy(pre))
    for fn in (tpl.cleanup, tpl.cleanup_plain):
        st, fb = fn(*args, **kw)
        _eq(jfb, fb, f"{tag} {fn.__name__} fallback")
        for k in jst:
            if k != "mer_pos":
                _eq(jst[k], st[k], f"{tag} {fn.__name__} {k}")
        # the JAX item sorts are unstable: the order of items of one key
        # (every dead item) is open there, and the mer_pos of their mers
        # with it; compared on the mers of alive items
        NI = st["alive"].shape[1]
        live = torch.gather(st["alive"], 1,
                            st["mer_item"].clamp(0, NI - 1)).numpy()
        assert live.any()
        _eq(jst["mer_pos"][live], st["mer_pos"].numpy()[live],
            f"{tag} {fn.__name__} mer_pos")
    if tag == "engine":
        _, names, _ = cl.engine_batch()
        fell = {n for n, f in zip(names, jfb.tolist()) if f}
        # the tree ran every round and its verify pass still removed; the
        # cycle's compress fell back; the overflows set over
        assert {"deep_tree", "compress_fb", "over_u", "over_d2"} <= fell
        assert "bubble" not in fell and "links" not in fell or with_pre_fb


def test_batch_loop_is_not_a_per_window_loop():
    """Window by window, the cleanup runs a window's compress only on its
    own hits: a converged window's okeys come out renumbered otherwise, so
    the loop's hit is the batch's (as JAX's lax.cond over the batch)."""
    arrs, K = _batch("engine")
    _, names, _ = cl.engine_batch()
    st, K_, N, NI, cfg, avg = cl.inputs(arrs, K)
    out, fb = tpl.cleanup_plain(st, K, N, NI, cfg, avg)
    differ = []
    for w, name in enumerate(names):
        sw = {k: v[w:w + 1] for k, v in st.items()}
        o1, f1 = tpl.cleanup_plain(sw, K, N, NI, cfg, avg[w:w + 1])
        assert bool(f1) == bool(fb[w]), name
        if any(not torch.equal(o1[k], out[k][w:w + 1]) for k in o1):
            differ.append(name)
    assert differ and set(differ) <= {"seeded0", "seeded1"}, differ


def test_loops_plain_versions():
    """tip_fixpoint_plain: rounds 0 runs the verify pass alone; the links
    mode with no gate lane set returns the state and fallback unchanged.
    short_link_stage_plain: pre_any is a candidate of initial degree >= 2
    with mincov <= thr."""
    arrs, K = _batch("engine")
    st, K, N, NI, cfg, avg = cl.inputs(arrs, K)
    W = st["alive"].shape[0]
    fb0 = torch.zeros(W, dtype=torch.bool)
    out, fb = tpl.tip_fixpoint_plain(st, ("tips", cfg["max_tip_len"]), K, N,
                                     NI, cl.U, cl.D2, 0, fb0)
    for k in st:
        assert torch.equal(out[k], st[k]), k
    _, removed, over = stages.seq_removal_pass_plain(
        st, ("tips", st["merlen"], cfg["max_tip_len"]), cl.U, cl.D2)
    assert torch.equal(fb, removed | over)
    mincov, _ = stages.item_mincovs_plain(st, K, N, NI)
    thr = torch.full((W,), 5, dtype=torch.int64)
    links = ("links", cfg["max_link_len"], mincov, thr,
             torch.zeros_like(st["alive"]), torch.zeros(W, dtype=torch.bool))
    out, fb = tpl.tip_fixpoint_plain(st, links, K, N, NI, cl.U, cl.D2, 6,
                                     fb0 | True)
    assert bool(fb.all())
    for k in st:
        assert torch.equal(out[k], st[k]), k
    sl = tpl.short_link_stage_plain(st, mincov, thr, K, NI,
                                    cfg["max_link_len"])
    _, pre = tpl._short_link_pre(st, mincov, thr, NI, cfg["max_link_len"])
    assert torch.equal(sl["pre_any"], pre.any(dim=1))
    _, names, _ = cl.engine_batch()
    assert bool(sl["pre_any"][names.index("links")])
    assert not bool(sl["pre_any"][names.index("over_u")])


# ---------------------------------------------------------------------------
# the short_link_strings kernel, replayed in numpy
# ---------------------------------------------------------------------------

def _replay_strings(st, mincov, thr, K, NI, max_link, threads=256):
    """csrc/cleanup.cu's short_link_strings block by block: the degrees,
    the candidates in contiguous chunks a thread and their slots by an
    exclusive scan of the chunks' counts, the packed (j << 24 | mer) keys'
    max per cell, then each cell's base."""
    S, C = ck.SL_ITEMS, ck.SL_CAP
    a = {k: v.numpy() for k, v in st.items()}
    W = a["alive"].shape[0]
    NM = a["mer_item"].shape[1]
    seqs = np.full((W, S, C), 99, np.int64)
    lens = np.zeros((W, S), np.int64)
    slot_item = np.full((W, S), -1, np.int64)
    pre_any = np.zeros(W, bool)
    mc, th = mincov.numpy(), thr.numpy()
    for w in range(W):
        deg0 = np.zeros(NI, np.int64)
        for e in np.nonzero(a["e_alive"][w])[0]:
            s = a["e_src"][w, e]
            if 0 <= s < NI:
                deg0[s] += 1
        ml = a["merlen"][w]
        cand = (a["alive"][w] & ~a["special"][w] & (ml < max_link)
                & (ml > 0))
        chunk = -(-NI // threads)
        counts = [int(cand[t * chunk:(t + 1) * chunk].sum())
                  for t in range(threads)]
        base = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot_of = np.full(NI, -1, np.int64)
        for t in range(threads):
            b = int(base[t])
            for i in range(min(t * chunk, NI), min((t + 1) * chunk, NI)):
                if cand[i]:
                    slot_of[i] = b if b < S else -1
                    b += 1
        pre_any[w] = (cand & (deg0 >= 2) & (mc[w] <= th[w])).any()
        for i in np.nonzero(slot_of >= 0)[0]:
            slot_item[w, slot_of[i]] = i
            lens[w, slot_of[i]] = ml[i] + K - 1
        key = np.full(S * C, -1, np.int64)
        for m in range(NM):
            mi = int(np.clip(a["mer_item"][w, m], 0, NI - 1))
            s = slot_of[mi]
            if s < 0:
                continue
            lo, hi = a["keep_lo"][w, m], a["keep_hi"][w, m]
            for j in range(max(lo, 0), min(hi, K)):
                t = int(np.clip(a["mer_pos"][w, m] + j, 0, C - 1))
                key[s * C + t] = max(key[s * C + t], (j << 24) | m)
        for c in np.nonzero(key >= 0)[0]:
            m, j = key[c] & ((1 << 24) - 1), key[c] >> 24
            fl = a["mer_flip"][w, m]
            b = a["mer_base"][w, m, K - 1 - j if fl else j]
            seqs[w, c // C, c % C] = b ^ 3 if fl else b
    return dict(seqs=seqs, lens=lens, slot_item=slot_item, pre_any=pre_any)


@pytest.mark.parametrize("stage", ["input", "after_tips"])
@pytest.mark.parametrize("tag", BATCHES)
def test_strings_replay_equals_plain(tag, stage):
    arrs, K = _batch(tag)
    st = _after_tips(arrs, K) if stage == "after_tips" else cl.to_torch(arrs)
    NI = st["alive"].shape[1]
    N = NI - 2 * cl.CMAX
    mincov, _ = stages.item_mincovs_plain(st, K, N, NI)
    thr = torch.full((st["alive"].shape[0],), 5, dtype=torch.int64)
    max_link = cl.cfg_s(K)["max_link_len"]
    want = tpl.short_link_stage_plain(st, mincov, thr, K, NI, max_link)
    got = _replay_strings(st, mincov, thr, K, NI, max_link)
    for k in want:
        _eq(got[k], want[k], f"{tag} {stage} {k}")


def test_replay_meets_clamped_writes():
    """The colliding window: positions past the cap and below 0 meet, and
    the cell keeps the write of the largest (j, mer)."""
    arrs, K = _batch("engine")
    _, names, _ = cl.engine_batch()
    w = names.index("colliding")
    st = {k: v[w:w + 1] for k, v in cl.to_torch(arrs).items()}
    NI = st["alive"].shape[1]
    cand = _cand(st, cl.cfg_s(K)["max_link_len"])
    out = tpl.short_link_strings_plain(st, cand, K, NI)
    q = int(arrs["mer_item"][w][arrs["mer_pos"][w] == 60][0])
    s = int((out["slot_item"][0] == q).nonzero()[0, 0])
    row = out["seqs"][0, s]
    assert int(row[tpl._SL_CAP - 1]) != 99 and int(row[0]) != 99
    # by hand: cell 0 takes the largest (j, mer) over the writes clipped
    # to 0 (the mers at -3 and -7 and the mer at 0 with j = 0)
    a = {k: v.numpy()[0] for k, v in st.items()}
    best = (-1, -1)
    for m in np.nonzero(a["mer_item"] == q)[0]:
        for j in range(max(a["keep_lo"][m], 0), min(a["keep_hi"][m], K)):
            if a["mer_pos"][m] + j <= 0:
                best = max(best, (j, m))
    j, m = best
    fl = a["mer_flip"][m]
    b = a["mer_base"][m, K - 1 - j if fl else j]
    assert int(row[0]) == (b ^ 3 if fl else b)


# ---------------------------------------------------------------------------
# plans, dispatch, build
# ---------------------------------------------------------------------------

# the most clusters of C blocks an H100 SXM holds at once at tip_fixpoint's
# 512 threads and one block an SM (tools/cluster_probe.py)
H100_CLUSTERS = {4: 30, 3: 39, 2: 66, 1: 132}


def test_plans():
    """tip_fixpoint_plan: the cluster size it picks by W (C 4 up to W 30,
    3 up to 39, 2 up to 66, 1 up to 132, every window's cluster resident at
    once for the cooperative launch), the blocks' shared memory (the
    compression body's, larger than the removal body's behind the head),
    and its refusals, more windows than the card holds among them;
    strings_plan and its refusals."""
    NI, EE, NM = cl.ENGINE_COMPACT
    plan = ck.tip_fixpoint_plan(32, NI, EE, NM, cl.U, cl.D2, H100_CLUSTERS)
    assert plan == (3, 170448)
    assert ck.tip_fixpoint_smem(NI, EE, NM, cl.U, 3) == 170448
    for W, C in ((1, 4), (8, 4), (16, 4), (30, 4), (31, 3), (32, 3),
                 (33, 3), (34, 3), (39, 3), (40, 2), (66, 2), (67, 1),
                 (132, 1)):
        assert ck.tip_fixpoint_plan(W, NI, EE, NM, cl.U, cl.D2,
                                    H100_CLUSTERS).C == C, W
    # the compression body's layout is the larger one
    for shape in ((4, 4000, 0, 256), (528, 1568, 1536, 256), (1, 0, 0, 9)):
        for C in (1, 2, 3, 4):
            assert ck.tip_fixpoint_smem(*shape, C) >= 64 + (
                walks.seq_removal_smem(shape[0], shape[1], shape[3]))
    for bad in (dict(W=133), dict(W=33, clusters={4: 8, 3: 8, 2: 16,
                                                  1: 32}),
                dict(W=31, clusters={4: 30}), dict(NI=32768), dict(D2=0),
                dict(NI=2000, EE=4000), dict(U=-1)):
        kw = dict(W=32, NI=NI, EE=EE, NM=NM, U=cl.U, D2=cl.D2,
                  clusters=H100_CLUSTERS)
        kw.update(bad)
        with pytest.raises(ValueError):
            ck.tip_fixpoint_plan(**kw)
    with pytest.raises(ValueError, match="resident"):
        ck.tip_fixpoint_plan(133, NI, EE, NM, cl.U, cl.D2, H100_CLUSTERS)
    assert ck.strings_plan(NI, NM, 21) == 20608
    assert ck.strings_plan(NI, NM, 64) == 20608
    for bad in (dict(K=65), dict(K=0), dict(NM=(1 << 24) + 1), dict(NI=0),
                dict(NI=60000)):
        kw = dict(NI=NI, NM=NM, K=21)
        kw.update(bad)
        with pytest.raises(ValueError):
            ck.strings_plan(**kw)


class _Occupancy:
    """A stand-in for a build of csrc/cleanup.cu's plan entry points: the
    clusters of each C held at once, the layout's smem (`skew` bytes off),
    and a count of its occupancy queries."""

    def __init__(self, clusters: dict, skew: int = 0):
        self.clusters, self.skew, self.queries = clusters, skew, 0

    def tip_fixpoint_max_clusters(self, C, smem):
        self.queries += 1
        return self.clusters[C]

    def tip_fixpoint_smem(self, NI, EE, NM, U, C):
        return ck.tip_fixpoint_smem(NI, EE, NM, U, C) + self.skew


def test_plan_for_caches_by_shape():
    """cleanup.plan_for: tip_fixpoint_plan over the build's occupancy,
    queried once a shape (U and D2 part of it); a forced `clusters`
    neither queries nor enters the cache; a disagreeing layout and a
    refused W raise and leave nothing cached."""
    cpu = torch.device("cpu")
    lib = _Occupancy(H100_CLUSTERS)
    NI, EE, NM = cl.ENGINE_COMPACT
    args = (NI, EE, NM, cl.U, cl.D2, cpu, lib)
    assert ck.plan_for(32, *args) == (3, 170448)
    asked = lib.queries
    assert asked == len(ck.compress.CLUSTER_SIZES)
    for _ in range(3):
        assert ck.plan_for(32, *args) == (3, 170448)
    assert lib.queries == asked
    assert ck.plan_for(8, *args).C == 4
    assert ck.plan_for(32, NI, EE, NM, cl.U, cl.D2 + 1, cpu, lib).C == 3
    assert lib.queries == 3 * asked
    assert ck.plan_for(32, *args, {4: 0, 3: 0, 2: 40, 1: 0}).C == 2
    assert lib.queries == 3 * asked
    bad = _Occupancy(H100_CLUSTERS, skew=16)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="disagrees"):
            ck.plan_for(32, NI, EE, NM, cl.U, cl.D2, cpu, bad)
    assert bad.queries == 2 * asked
    for _ in range(2):
        with pytest.raises(ValueError, match="resident"):
            ck.plan_for(133, *args)
    assert lib.queries == 3 * asked + 2 * asked


def test_cpu_runs_the_plain_versions():
    """On the CPU each wrapper is its plain version (no launch), the keys it
    does not rewrite passed through as the same tensors."""
    arrs, K = _batch("w1")
    st, K, N, NI, cfg, avg = cl.inputs(arrs, K)
    before = dict(ck.LAUNCHES)
    fb0 = torch.zeros(1, dtype=torch.bool)
    out, fb = ck.tip_fixpoint(st, ("tips", cfg["max_tip_len"]), K, N, NI,
                              cl.U, cl.D2, cl.TIP_ROUNDS, fb0)
    want, wfb = tpl.tip_fixpoint_plain(st, ("tips", cfg["max_tip_len"]), K,
                                       N, NI, cl.U, cl.D2, cl.TIP_ROUNDS,
                                       fb0)
    assert torch.equal(fb, wfb) and bool(fb[0])
    for k in want:
        assert torch.equal(out[k], want[k]), k
    for k in ("special", "rank", "comp", "mer_base", "mer_totq"):
        assert out[k] is st[k], k
    mincov, _ = stages.item_mincovs(out, K, N, NI)
    thr = torch.full((1,), 5, dtype=torch.int64)
    sl = ck.short_link_strings(out, mincov, thr, K, NI, cfg["max_link_len"])
    want = tpl.short_link_stage_plain(out, mincov, thr, K, NI,
                                      cfg["max_link_len"])
    assert set(sl) == {"seqs", "lens", "slot_item", "pre_any"}
    for k in want:
        assert torch.equal(sl[k], want[k]), k
    # an in-place links call: the plain version's result, new tensors
    links = ("links", cfg["max_link_len"], mincov, thr,
             torch.zeros_like(out["alive"]), sl["pre_any"] | True)
    held = {k: out[k].clone() for k in ck.STATE_KEYS}
    got, gfb = ck.tip_fixpoint(out, links, K, N, NI, cl.U, cl.D2,
                               cl.TIP_ROUNDS, fb0, inplace=True)
    want, wfb = tpl.tip_fixpoint_plain(out, links, K, N, NI, cl.U, cl.D2,
                                       cl.TIP_ROUNDS, fb0)
    assert torch.equal(gfb, wfb)
    for k in ck.STATE_KEYS:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(out[k], held[k]), k
    assert ck.LAUNCHES == before


def test_wrappers_refuse_mixed_devices():
    arrs, K = _batch("w1")
    st, K, N, NI, cfg, avg = cl.inputs(arrs, K)
    fb0 = torch.zeros(1, dtype=torch.bool)
    meta = dict(st, rank=torch.empty(st["rank"].shape, device="meta"))
    with pytest.raises(ValueError, match="one device"):
        ck.tip_fixpoint(meta, ("tips", 11), K, N, NI, cl.U, cl.D2, 6, fb0)
    thr = torch.full((1,), 5, dtype=torch.int64)
    mincov = torch.zeros((1, NI), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="one device"):
        ck.short_link_strings(st, mincov, thr, K, NI, 10)
    on_meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
               for k, v in st.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        ck.tip_fixpoint(on_meta, ("tips", 11), K, N, NI, cl.U, cl.D2, 6,
                        fb0.to("meta"))
    with pytest.raises(ValueError, match="neither"):
        ck.tip_fixpoint(st, ("walls", 11), K, N, NI, cl.U, cl.D2, 6, fb0)


def test_build_key_covers_included_headers(tmp_path):
    """Editing a header a source includes with quotes (directly or through
    another header) changes the build's cache key; editing a file it does
    not include, or a system include, does not."""
    src = tmp_path / "k.cu"
    (tmp_path / "sub").mkdir()
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n'
                   '  #  include "missing.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n')
    (tmp_path / "sub" / "b.cuh").write_text(
        '#pragma once\n#include "../a.cuh"\ninline int g() { return 1; }\n')
    (tmp_path / "other.cuh").write_text("int h();\n")
    cmd = ["nvcc", "-O3", str(src)]
    k0 = _build.cache_key(str(src), cmd)
    (tmp_path / "other.cuh").write_text("int h2();\n")
    assert _build.cache_key(str(src), cmd) == k0
    (tmp_path / "sub" / "b.cuh").write_text(
        '#pragma once\n#include "../a.cuh"\ninline int g() { return 2; }\n')
    k1 = _build.cache_key(str(src), cmd)
    assert k1 != k0
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n'
                                    '// edited\n')
    k2 = _build.cache_key(str(src), cmd)
    assert k2 not in (k0, k1)
    assert _build.cache_key(str(src), cmd + ["-G"]) != k2
    # the package's kernels: each header of cleanup.cu is in its key
    import lancet_tpu_torch.gpu.cleanup as mod

    with open(mod._SRC) as f:
        assert '#include "compress_body.cuh"' in f.read()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The cleanup on the card (its eight launches, the two loops' kernels
    one launch each) bit-equal to cleanup_plain on every batch, dtypes too,
    with no host sync; each loop's kernel bit-equal to its plain version on
    the cleanup's own inputs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for tag in BATCHES:
        arrs, K = _batch(tag)
        args = cl.inputs(arrs, K, "cuda")
        before = dict(ck.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, fb = tpl.cleanup(*args, U=cl.U, D2=cl.D2,
                                 TIP_ROUNDS=cl.TIP_ROUNDS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert ck.LAUNCHES["tip_fixpoint"] == before["tip_fixpoint"] + 2
        assert (ck.LAUNCHES["short_link_strings"]
                == before["short_link_strings"] + 1)
        wst, wfb = tpl.cleanup_plain(*args, U=cl.U, D2=cl.D2,
                                     TIP_ROUNDS=cl.TIP_ROUNDS)
        assert fb.dtype == wfb.dtype and torch.equal(fb, wfb), tag
        assert set(st) == set(wst)
        for k in wst:
            assert st[k].dtype == wst[k].dtype, (tag, k)
            assert torch.equal(st[k], wst[k]), (tag, k)
        # each kernel against its plain version, on the card
        st0, K, N, NI, cfg, avg = args
        W = st0["alive"].shape[0]
        fb0 = torch.zeros(W, dtype=torch.bool, device="cuda")
        cond = ("tips", cfg["max_tip_len"])
        got = ck.tip_fixpoint(st0, cond, K, N, NI, cl.U, cl.D2, 6, fb0)
        want = tpl.tip_fixpoint_plain(st0, cond, K, N, NI, cl.U, cl.D2, 6,
                                      fb0)
        assert torch.equal(got[1], want[1])
        for k in ck.STATE_KEYS:
            assert torch.equal(got[0][k], want[0][k]), (tag, k)
        mincov, _ = stages.item_mincovs(st0, K, N, NI)
        thr = torch.full((W,), 5, dtype=torch.int64, device="cuda")
        got = ck.short_link_strings(st0, mincov, thr, K, NI,
                                    cfg["max_link_len"])
        want = tpl.short_link_stage_plain(st0, mincov, thr, K, NI,
                                          cfg["max_link_len"])
        for k in want:
            assert got[k].dtype == want[k].dtype, (tag, k)
            assert torch.equal(got[k], want[k]), (tag, k)
        # the links mode in place, its gate open and closed: the plain
        # version's state, written into the given tensors
        for gate in (got["pre_any"] | True, got["pre_any"] & False):
            links = ("links", cfg["max_link_len"], mincov, thr,
                     torch.zeros_like(st0["alive"]), gate)
            own = {k: v.clone() for k, v in st0.items()}
            res, rfb = ck.tip_fixpoint(own, links, K, N, NI, cl.U, cl.D2, 6,
                                       fb0, inplace=True)
            want = tpl.tip_fixpoint_plain(st0, links, K, N, NI, cl.U, cl.D2,
                                          6, fb0)
            assert torch.equal(rfb, want[1]), tag
            for k in ck.STATE_KEYS:
                assert res[k] is own[k], (tag, k)
                assert torch.equal(res[k], want[0][k]), (tag, k)
