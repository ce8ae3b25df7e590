"""The device graph engine's component labels, compaction and low-coverage
pass (`lancet_tpu_torch.gpu.graphstate`, `csrc/graphstate.cu`) on the CPU,
against the JAX package.

- `stages.components_plain`, `compact_state_plain`, `item_mincovs_plain`
  and `low_cov_pass_plain` bit-equal to the JAX `components`,
  `compact_state`, `item_mincovs` and `low_cov_pass` (`lancet_tpu.tpu.
  stages`, int32 and int8 inputs) on every window of
  `gpu.statecases`' batches at the small shape and the engine's (NI 1,552
  / EE 3,872 / NM 1,536 for the first two, the compact NI 528 / EE 1,568
  for the others), each window reaching its corner (ties broken by root
  index, dead endpoints that bridge, numcomp past Cmax, regular items past
  NCR and edges past EC, dead mers, flipped and trimmed kept intervals,
  widths 0 and below, coverage 1, mincov_qv on the float threshold, also
  past 2^24);
- a numpy replay of each kernel's schedule (the label rounds to each
  window's own fixed point and the numbering by counting over the roots;
  the compaction's scans and scatters in three parts; the low-coverage
  kernels on a cluster of C blocks a window, at each C: the ranks'
  ranges, a lane's reads of a narrow kept window and a warp's of a wide
  one, each rank's per-item minima merged by the items' owners, the
  removal by ranges) bit-equal to the plain version on every batch, W 1,
  an empty window and the cluster ranges' corners (`statecases.
  ranges_batch`, K 63 and 64, also against the JAX package) included;
- compact_state's hold-point: the plain version asserts on a lane within
  the caps whose alive edge touches a dead item, and the replay flags it;
- the plans on the engine's shapes and their refusals, the low-coverage
  launch's arguments from its plan and its check of the build's layout;
  the dispatch on the
  CPU (the plain version, no launch, the other keys passed through as the
  same tensors) and the refusal of mixed devices and dtypes.

The `cuda` test holds each kernel bit-equal to its plain version on every
batch on the card, dtypes too, one launch a call, the low-coverage kernels
also at each cluster size of `compress.CLUSTER_SIZES`.
"""

import functools

import numpy as np
import pytest
import torch

from lancet_tpu_torch.gpu import compress
from lancet_tpu_torch.gpu import graphstate as gs
from lancet_tpu_torch.gpu import stages
from lancet_tpu_torch.gpu import statecases as sc

torch.set_num_threads(1)

BIG = 1 << 30
CMAX = sc.CMAX
CLUSTER_SIZES = compress.CLUSTER_SIZES


@functools.lru_cache(maxsize=None)
def _batches():
    return sc.batches()


def _jax_state(arrs):
    import jax.numpy as jnp

    return {k: jnp.asarray(v if v.dtype in (bool, np.float32) else
                           v.astype(np.int8 if k == "e_dir" else np.int32))
            for k, v in arrs.items()}


def _eq(got, want, what):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = np.argwhere(g != w.astype(g.dtype))
    assert not len(bad), f"{what} differs at {bad[:5].tolist()}"


def _shape(tag):
    return {"small": (sc.SMALL, sc.SMALL_CAPS, sc.K_SMALL, 12, 22, 32),
            "engine": (None, (sc.NCR, sc.ECR), sc.K_ENGINE, 11, 21, 31)}[tag]


# ---------------------------------------------------------------------------
# the numpy replays of the kernels
# ---------------------------------------------------------------------------

def replay_components(a, Cmax=CMAX):
    """csrc/graphstate.cu's components_kernel, window by window: the
    plain version's rounds (relax, three jumps) to the window's own fixed
    point, then each root's place by counting over the roots. Returns
    (outputs, rounds a window)."""
    W, NI = a["alive"].shape
    idx = np.arange(NI)
    out = {"comp": np.zeros((W, NI), np.int64),
           "numcomp": np.zeros(W, np.int64), "over": np.zeros(W, bool)}
    rounds = []
    for w in range(W):
        al, ea = a["alive"][w], a["e_alive"][w]
        lab = np.where(al, idx, BIG)
        es = np.clip(a["e_src"][w][ea], 0, NI - 1)
        ed = np.clip(a["e_dst"][w][ea], 0, NI - 1)
        n = 0
        while True:
            n += 1
            nxt = lab.copy()
            m = np.minimum(lab[es], lab[ed])
            np.minimum.at(nxt, es, m)
            np.minimum.at(nxt, ed, m)
            for _ in range(3):
                nxt = np.minimum(nxt, nxt[np.clip(nxt, 0, NI - 1)])
            changed = (nxt != lab).any()
            lab = nxt
            if not changed:
                break
        rounds.append(n)
        mr = np.full(NI, BIG, np.int64)
        np.minimum.at(mr, np.clip(lab[al], 0, NI - 1), a["rank"][w][al])
        roots = np.nonzero(al & (lab == idx))[0]
        keys = mr[roots]
        cr = np.zeros(NI, np.int64)
        for r, key in zip(roots, keys):
            lt = int(((keys < key) | ((keys == key) & (roots < r))).sum())
            below = int((roots < r).sum())
            cr[r] = lt + (r - below if key == BIG else 0) + 1
        out["comp"][w] = np.where(al, cr[np.clip(lab, 0, NI - 1)], 0)
        out["numcomp"][w] = len(roots)
        out["over"][w] = len(roots) > Cmax
    return out, rounds


def replay_compact(a, caps, Cmax=CMAX):
    """compact_kernel, window by window: the regular items' exclusive
    ranks, the items' scatter with the fills and the anchors' fixed slots
    (part 0), new_of and the mers (part 2), the edges' ranks and scatter,
    over and the hold-point flag (part 1)."""
    NCR, ECR = caps
    W, NI = a["alive"].shape
    EE, NM = a["e_src"].shape[1], a["mer_item"].shape[1]
    N = NI - 2 * Cmax
    NC, EC = NCR + 2 * Cmax, ECR + 4 * Cmax
    fills = {"alive": False, "special": False, "rank": BIG, "merlen": 0,
             "n_t": 0, "is_tumor": False, "is_normal": False, "comp": 0}
    ikeys = [k for k in fills if k in a]
    out = {k: np.zeros((W, NC), a[k].dtype) for k in ikeys}
    out["csum"] = np.zeros((W, NC, 4), np.int64)
    ekeys = ("e_src", "e_dst", "e_dir", "e_alive", "e_okey")
    for k in ekeys:
        out[k] = np.zeros((W, EC), a[k].dtype)
    out["mer_item"] = np.zeros((W, NM), np.int64)
    out["keep_lo"] = a["keep_lo"]  # passed through
    out["keep_hi"] = np.zeros((W, NM), np.int64)
    out["over"] = np.zeros(W, bool)
    out["dead_edge"] = np.zeros(W, bool)
    for w in range(W):
        reg = a["alive"][w] & ~a["special"][w]
        pos = np.cumsum(reg) - reg  # exclusive
        n_reg = int(reg.sum())

        def put(i, j):
            for k in ikeys:
                out[k][w, j] = fills[k] if i < 0 else a[k][w, i]
            out["csum"][w, j] = 0 if i < 0 else a["csum"][w, i]
        for i in np.nonzero(reg & (pos < NCR))[0]:
            put(i, pos[i])
        for j in range(min(n_reg, NCR), NCR):
            put(-1, j)
        for c in range(2 * Cmax):
            put(N + c, NCR + c)
        new_of = np.where(reg, np.minimum(pos, NCR - 1), -1)
        new_of[N:N + 2 * Cmax] = NCR + np.arange(2 * Cmax)
        nm = new_of[np.clip(a["mer_item"][w], 0, NI - 1)]
        out["mer_item"][w] = np.where(nm < 0, NCR, nm)
        out["keep_hi"][w] = np.where(nm < 0, a["keep_lo"][w],
                                     a["keep_hi"][w])
        ea = a["e_alive"][w]
        epos = np.cumsum(ea) - ea
        n_e = int(ea.sum())
        over = n_reg > NCR or n_e > EC
        dead = False
        for e in np.nonzero(ea & (epos < EC))[0]:
            j = epos[e]
            ns = new_of[np.clip(a["e_src"][w, e], 0, NI - 1)]
            nd = new_of[np.clip(a["e_dst"][w, e], 0, NI - 1)]
            dead |= bool(ns < 0 or nd < 0)
            out["e_src"][w, j] = np.clip(ns, 0, NC - 1)
            out["e_dst"][w, j] = np.clip(nd, 0, NC - 1)
            out["e_dir"][w, j] = a["e_dir"][w, e]
            out["e_alive"][w, j] = True
            out["e_okey"][w, j] = a["e_okey"][w, e]
        for j in range(min(n_e, EC), EC):
            out["e_okey"][w, j] = BIG
        out["over"][w] = over
        out["dead_edge"][w] = dead and not over
    return out


def replay_lowcov(a, K, C, params=None, avgcov=None):
    """lowcov_kernel's schedule, window by window, on a cluster of C blocks
    (gs.lowcov_plan's ranges): rank r's warps take its range of the mers
    32 at a time, a lane a mer; a kept window of at most NARROW positions
    is read by its lane (position clo + u for u < width), a wider one by
    the warp (lane j reads positions j and j + 32 inside it, the minimum
    over the lanes); a mer of width > 0 donates its minimum (BIG outside
    the kept window) and its mer_tot into rank r's own per-item minima;
    each item's owner takes the minimum over the C ranks' copies; then
    (with `params`) the owner's low test (the threshold the torch product,
    mincov_qv rounded to float32), each rank's range of the edges cleared
    by its ends' owners' flags, low.any the OR of the ranks' flags.
    Returns (mincov, mincov_qv) without `params`, else (alive, e_alive,
    any)."""
    W, NM = a["mer_item"].shape
    NI, EE = a["alive"].shape[1], a["e_src"].shape[1]
    low_pass = params is not None
    p = gs.lowcov_plan(NI, NM, K, low_pass, EE, C)
    qv = np.full((W, C, NI), BIG, np.int64)
    mc = np.full((W, C, NI), BIG, np.int64)
    paths = np.zeros((W, NM), np.int64)  # 1 a lane's reads, 2 a warp's
    j = np.arange(K)
    for r in range(C):
        m = np.arange(min(r * p.mers, NM), min((r + 1) * p.mers, NM))
        lo, hi = a["keep_lo"][:, m], a["keep_hi"][:, m]
        f = a["mer_flip"][:, m]
        on = hi - lo > 0
        clo = np.clip(np.where(f, K - hi, lo), 0, K)[..., None]
        chi = np.clip(np.where(f, K - lo, hi), 0, K)[..., None]
        wd = np.where(on[..., None], chi - clo, 0)
        narrow = wd <= gs.NARROW
        # a lane reads clo + u for u < width; a warp's lane l reads l and
        # l + 32 inside the window
        reads = np.where(narrow, (j >= clo) & (j < clo + wd),
                         (j >= clo) & (j < chi) & (j < 64))
        x = np.minimum(np.where(reads, a["mer_totq"][:, m], BIG).min(-1),
                       BIG)
        paths[:, m] += np.where(narrow[..., 0], 1, 2)
        mi = np.clip(a["mer_item"][:, m], 0, NI - 1)
        for w in range(W):
            np.minimum.at(qv[w, r], mi[w][on[w]], x[w][on[w]])
            np.minimum.at(mc[w, r], mi[w][on[w]], a["mer_tot"][w, m][on[w]])
    assert ((paths == 1) | (paths == 2)).all()  # each mer once
    owner = np.arange(NI) // p.items
    assert owner.max() < C
    # each owner's items, over the C copies
    q = qv.min(axis=1)
    c = mc.min(axis=1)
    if not low_pass:
        return {"mincov": c, "mincov_qv": q}
    lct, ratio = params
    thr = (ratio * torch.from_numpy(avgcov)).numpy()
    cs = a["csum"]
    tt, tn = cs[..., 0] + cs[..., 1], cs[..., 2] + cs[..., 3]
    ml = a["merlen"]
    low = (a["alive"] & ~a["special"]
           & ((q <= lct) | (q.astype(np.float32) <= thr[:, None])
              | ((tt == ml) & (tn == ml) & (ml > 0))))
    flags = np.zeros((W, C, NI), bool)  # each rank's flags, its items'
    for r in range(C):
        flags[:, r, owner == r] = low[:, owner == r]
    e_alive = np.zeros_like(a["e_alive"])
    rows = np.arange(W)[:, None]
    for r in range(C):
        e = np.arange(min(r * p.edges, EE), min((r + 1) * p.edges, EE))
        u = np.clip(a["e_src"][:, e], 0, NI - 1)
        d = np.clip(a["e_dst"][:, e], 0, NI - 1)
        gone = flags[rows, owner[u], u] | flags[rows, owner[d], d]
        e_alive[:, e] = a["e_alive"][:, e] & ~gone
    return {"alive": a["alive"] & ~low, "e_alive": e_alive,
            "any": flags.any(axis=(1, 2))}


def _plain(func, arrs, params):
    return {k: v.numpy() for k, v in
            sc.run(func, arrs, params, plain=True).items()}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["small", "engine"])
def test_components_plain_equals_jax(tag):
    """components_plain bit-equal to the JAX components on every crafted
    window; the windows reach their corners."""
    from lancet_tpu.tpu import stages as jst

    shape, _, _, seed, _, _ = _shape(tag)
    arrs, names = sc.components_batch(shape or sc.ENGINE_FIRST, seed=seed)
    j = _jax_state(arrs)
    want = jst.components(j["alive"], j["e_src"], j["e_dst"], j["e_alive"],
                          j["rank"], CMAX)
    got = _plain("components", arrs, {})
    for k, w in zip(("comp", "numcomp", "over"), want):
        _eq(got[k], w, k)
    row = {n: i for i, n in enumerate(names)}
    comp = got["comp"]
    # ties: least rank 7 three times, numbered by root index 5, 10, 20
    r = row["ties"]
    assert comp[r, [5, 10, 20, 40]].tolist() == [1, 2, 3, 4]
    assert comp[r, 30] == 1 and comp[r, 12] == 2 and comp[r, 21] == 3
    # dead endpoints bridge: 40 ~ 42 through 41, 50 ~ 53 through 51, 52
    r = row["dead_bridge"]
    assert comp[r, 40] == comp[r, 42] > 0 and comp[r, 50] == comp[r, 53] > 0
    assert comp[r, 41] == 0 and got["numcomp"][r] == 3
    # the clamp through item NI - 1 joins 30 to 0's component, as in JAX
    r = row["last_labelled"]
    assert comp[r, 0] == comp[r, 30] == 1 and got["numcomp"][r] == 1
    r = row["many"]
    assert got["numcomp"][r] == 40 and got["over"][r]
    assert got["numcomp"][row["chain"]] == 1
    assert got["numcomp"][row["nothing_alive"]] == 0
    # a root key of BIG sorts among the other items by index
    r = row["big_rank"]
    assert comp[r, 14] == 1 and comp[r, 1] < comp[r, 2] < comp[r, 3]
    _, rounds = replay_components(arrs)
    assert rounds[row["chain"]] >= 4


@pytest.mark.parametrize("tag", ["small", "engine"])
def test_compact_plain_equals_jax(tag):
    """compact_state_plain bit-equal to the JAX compact_state on every
    crafted window (over included: no lane within the caps has an alive
    edge on a dead item, where JAX folds that into over)."""
    from lancet_tpu.tpu import stages as jst

    shape, caps, K, _, seed, _ = _shape(tag)
    shape = shape or sc.ENGINE_FIRST
    arrs, names = sc.compact_batch(shape, caps, K, seed=seed)
    NI = shape[0]
    jo, jover = jst.compact_state(_jax_state(arrs), NI - 2 * CMAX, NI, CMAX,
                                  *caps)
    got = _plain("compact_state", arrs, {"caps": caps})
    _eq(got["over"], jover, "over")
    for k in sc.COMPACT_KEYS:
        _eq(got[k], jo[k], k)
    row = {n: i for i, n in enumerate(names)}
    over = got["over"]
    assert over[row["reg_over"]] and over[row["edge_over"]]
    assert not over[row["exact_caps"]] and not over[row["mixed"]]
    assert got["e_alive"][row["exact_caps"]].all()
    assert (got["mer_item"][row["dead_mers"]] == caps[0]).all()
    r = row["anchor_regular"]  # the anchor N + 3 in both slots
    NCR = caps[0]
    assert got["rank"][r, NCR + 3] in got["rank"][r, :NCR]


@pytest.mark.parametrize("tag", ["small", "engine"])
def test_lowcov_plain_equals_jax(tag):
    """item_mincovs_plain and low_cov_pass_plain (each parameter set)
    bit-equal to the JAX functions on every crafted window; the float
    threshold's windows decide as the rounding says."""
    from lancet_tpu.tpu import stages as jst

    shape, _, K, _, _, seed = _shape(tag)
    shape = shape or sc.ENGINE_COMPACT
    arrs, names, avg = sc.lowcov_batch(shape, K, seed=seed)
    NI = shape[0]
    N = NI - 2 * CMAX
    j = _jax_state(arrs)
    got = _plain("item_mincovs", arrs, {"K": K})
    for k, w in zip(("mincov", "mincov_qv"), jst.item_mincovs(j, K, N, NI)):
        _eq(got[k], w, k)
    row = {n: i for i, n in enumerate(names)}
    for p in sc.LOWCOV_PARAMS:
        params = {"K": K, "avgcov": avg, "params": p}
        jo, jany = jst.low_cov_pass(j, K, N, NI, *p, np.asarray(avg))
        got = _plain("low_cov_pass", arrs, params)
        _eq(got["any"], jany, "any")
        _eq(got["alive"], jo["alive"], "alive")
        _eq(got["e_alive"], jo["e_alive"], "e_alive")
        if p == (0, 1.0):  # thr 2^24: 2^24 + 1 rounds down onto it
            r = row["thr_2p24"]
            assert (~got["alive"][r, :5]).tolist() == [True, True, True,
                                                       False, False]
        if p == (0, 0.01):  # thr 25.000002 and 1.0
            r = row["thr_25"]
            assert (~got["alive"][r, :5]).tolist() == [True, True, True,
                                                       False, False]
            r = row["thr_1"]
            assert (~got["alive"][r, :4]).tolist() == [True, True, False,
                                                       False]
    r = row["coverage_one"]
    assert (~got["alive"][r, 0:60:3]).all() and got["alive"][r, 1]


# ---------------------------------------------------------------------------
# the kernels' schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("func", ["components", "compact_state",
                                  "item_mincovs", "low_cov_pass"])
def test_replay_equals_plain(func):
    """The numpy replay of each kernel bit-equal to the plain version on
    every batch of its function (the engine's and the small shape, W 1,
    the empty window, each parameter set)."""
    n = 0
    for name, f, arrs, params in _batches():
        if f != func:
            continue
        want = _plain(func, arrs, params)
        if func == "components":
            got = replay_components(arrs)[0]
        elif func == "compact_state":
            got = replay_compact(arrs, params["caps"])
            assert not got["dead_edge"].any(), name
        elif func == "item_mincovs":
            got = replay_lowcov(arrs, params["K"], CLUSTER_SIZES[0])
        else:
            got = replay_lowcov(arrs, params["K"], CLUSTER_SIZES[0],
                                params["params"], params["avgcov"])
        for k in want:
            _eq(got[k], want[k], f"{name} {func} {k}")
        n += 1
    assert n >= 4


@pytest.mark.parametrize("C", CLUSTER_SIZES)
@pytest.mark.parametrize("func", ["item_mincovs", "low_cov_pass"])
def test_lowcov_replay_at_each_cluster_size(func, C):
    """The low-coverage kernels' schedule on a cluster of C blocks a window
    bit-equal to the plain version on every batch: the ranges cut the
    every_rank item's donors and edges at each C, the widths' windows take
    the lane's and the warp's reads, NM 1,001 and EE 705 leave partial
    warps and ranges."""
    n = 0
    for name, f, arrs, params in _batches():
        if f != func:
            continue
        want = _plain(func, arrs, params)
        got = replay_lowcov(arrs, params["K"], C, params.get("params"),
                            params.get("avgcov"))
        for k in want:
            _eq(got[k], want[k], f"{name} {func} C {C} {k}")
        n += 1
    assert n >= 9


@pytest.mark.parametrize("K", sc.RANGE_KS)
def test_lowcov_ranges_plain_equals_jax(K):
    """The cluster ranges' batch (K 63 and 64, NM 1,001, EE 705):
    item_mincovs_plain and low_cov_pass_plain bit-equal to the JAX
    functions; the every_rank item's minima come from the last and a
    middle rank's mers and it is removed with every edge on it; each
    crafted width's item takes its window's far end."""
    from lancet_tpu.tpu import stages as jst

    arrs, names, avg = sc.ranges_batch(K)
    NI, EE, NM = sc.RANGES
    N = NI - 2 * CMAX
    j = _jax_state(arrs)
    got = _plain("item_mincovs", arrs, {"K": K})
    for k, w in zip(("mincov", "mincov_qv"), jst.item_mincovs(j, K, N, NI)):
        _eq(got[k], w, k)
    row = {n: i for i, n in enumerate(names)}
    r = row["every_rank"]
    assert got["mincov_qv"][r, sc.HUB] == 7 and got["mincov"][r, sc.HUB] == 50
    r = row["widths"]  # 18 windows of width > 0 (widths 1 to K, clamped)
    assert got["mincov_qv"][r, 22:40].tolist() == list(range(202, 220))
    assert got["mincov"][r, 22:40].tolist() == list(range(12, 30))
    assert (got["mincov"][r, [20, 21, 40]] > 1000).all()  # width <= 0
    for p in sc.LOWCOV_PARAMS:
        jo, jany = jst.low_cov_pass(j, K, N, NI, *p, np.asarray(avg))
        got = _plain("low_cov_pass", arrs,
                     {"K": K, "avgcov": avg, "params": p})
        _eq(got["any"], jany, "any")
        _eq(got["alive"], jo["alive"], "alive")
        _eq(got["e_alive"], jo["e_alive"], "e_alive")
        r = row["every_rank"]
        hub = ((arrs["e_src"][r] == sc.HUB) | (arrs["e_dst"][r] == sc.HUB))
        assert not got["alive"][r, sc.HUB] and not got["e_alive"][r][hub].any()
        assert not got["any"][row["empty"]]


def test_dead_edge_hold_point():
    """A lane within the caps whose alive edge touches a dead item: the
    plain version asserts, the replay flags that lane alone; on the CPU the
    dispatch is the plain version."""
    arrs = sc.dead_edge_batch()
    with pytest.raises(AssertionError, match="dead item"):
        sc.run("compact_state", arrs, {"caps": sc.SMALL_CAPS}, plain=True)
    with pytest.raises(AssertionError, match="dead item"):
        sc.run("compact_state", arrs, {"caps": sc.SMALL_CAPS})
    got = replay_compact(arrs, sc.SMALL_CAPS)
    assert got["dead_edge"].tolist() == [True, False]
    assert not got["over"].any()


# ---------------------------------------------------------------------------
# the plans and the wrappers
# ---------------------------------------------------------------------------

def test_plans():
    """The plans on the engine's shapes; their refusals."""
    assert gs.components_plan(1552, 3872) == 88400
    assert gs.compact_plan(1552, 3872, 1536, 1536, 8, 512, 1536) == 27120
    # the engine's compact shape: C 4, a rank 384 mers, 160 items, 416
    # edges; a block its flag, the minima and (low_cov_pass) the flags
    assert gs.lowcov_plan(528, 1536, 41, False) == (4, 8464, 384, 160, 0)
    assert gs.lowcov_plan(528, 1536, 41, True, 1568) == (4, 4768, 384, 160,
                                                         416)
    assert gs.lowcov_plan(528, 1536, 64, True, 1568).smem == 4768
    # C as asked (4 by default); ranges of whole warps, NM 1,001 at C 3
    assert gs.lowcov_plan(272, 1001, 63, True, 705, 3) == (3, 2464, 352,
                                                           96, 256)
    assert gs.lowcov_plan(1, 0, 1, True, 0, 1) == (1, 48, 32, 32, 32)
    for C in (0, 5):
        with pytest.raises(ValueError, match="cluster"):
            gs.lowcov_plan(528, 1536, 41, True, 1568, C)
    with pytest.raises(ValueError):
        gs.lowcov_plan(528, 1536, 41, True, -1)
    for bad in ((0, 10), (10, -1), (6000, 4000)):
        with pytest.raises(ValueError):
            gs.components_plan(*bad)
    for bad in ((1552, 3872, 1536, 1540, 8, 512, 1536),
                (1552, 3872, 1536, 1536, 8, 0, 1536),
                (1552, 3872, -1, 1536, 8, 512, 1536),
                (30000, 30000, 1536, 1536, 8, 512, 1536)):
        with pytest.raises(ValueError):
            gs.compact_plan(*bad)
    for K in (0, 65):
        with pytest.raises(ValueError, match="K"):
            gs.lowcov_plan(528, 1536, K, True)
    with pytest.raises(ValueError, match="shared memory"):
        gs.lowcov_plan(30000, 10, 41, False)


class _Recorder:
    """A stand-in build for the low-coverage wrappers: its lowcov_smem
    (`skew` bytes off the wrapper's layout) and entry points that record
    their scalar arguments and launch nothing."""

    def __init__(self, skew=0):
        self.skew, self.calls = skew, []

    def lowcov_smem(self, NI, low):
        return gs.lowcov_smem(NI, bool(low)) + self.skew

    def item_mincovs(self, ins, outs, *scalars):
        self.calls.append(("item_mincovs",) + scalars[:-1])
        return 0

    def low_cov_pass(self, ins, outs, *scalars):
        self.calls.append(("low_cov_pass",) + scalars[:-1])
        return 0


@pytest.mark.parametrize("C", CLUSTER_SIZES)
def test_lowcov_launch_takes_its_plan(C):
    """The low-coverage wrappers launch with their plan's cluster, ranges
    and shared memory (C 4 unless asked, W 2 at the engine's compact
    shape, K 41 and the window stride of mer_totq, here a slice of a
    wider mer axis), count one launch each, and raise before any launch
    when the build's layout disagrees with theirs."""
    W, NI, EE, NM, K = 2, 528, 1568, 1536, 41
    rng = np.random.default_rng(5)
    st = {"mer_totq": torch.from_numpy(
        rng.integers(0, 9, (W, NM + 64, K)))[:, :NM],
        "mer_tot": torch.zeros((W, NM), dtype=torch.int64),
        "keep_lo": torch.zeros((W, NM), dtype=torch.int64),
        "keep_hi": torch.ones((W, NM), dtype=torch.int64),
        "mer_item": torch.zeros((W, NM), dtype=torch.int64),
        "mer_flip": torch.zeros((W, NM), dtype=torch.bool),
        "alive": torch.ones((W, NI), dtype=torch.bool),
        "special": torch.zeros((W, NI), dtype=torch.bool),
        "csum": torch.zeros((W, NI, 4), dtype=torch.int64),
        "merlen": torch.zeros((W, NI), dtype=torch.int64),
        "e_src": torch.zeros((W, EE), dtype=torch.int64),
        "e_dst": torch.zeros((W, EE), dtype=torch.int64),
        "e_alive": torch.zeros((W, EE), dtype=torch.bool)}
    thr = torch.ones(W, dtype=torch.float32)
    kw = {} if C == gs.MAX_C else {"C": C}
    lib = _Recorder()
    before = dict(gs.LAUNCHES)
    gs._mincovs_card(st, K, NI, lib=lib, **kw)
    gs._lowcov_card(st, K, NI, 3, thr, lib=lib, **kw)
    m, lo = (gs.lowcov_plan(NI, NM, K, False, 0, C),
             gs.lowcov_plan(NI, NM, K, True, EE, C))
    ws = (NM + 64) * K
    assert lib.calls == [
        ("item_mincovs", W, NI, NM, K, C, m.mers, m.items, ws, m.smem),
        ("low_cov_pass", W, NI, EE, NM, K, C, lo.mers, lo.items, lo.edges,
         ws, 3, lo.smem)]
    for f in ("item_mincovs", "low_cov_pass"):
        assert gs.LAUNCHES[f] == before[f] + 1
    bad = _Recorder(skew=16)
    with pytest.raises(RuntimeError, match="disagrees"):
        gs._mincovs_card(st, K, NI, lib=bad, **kw)
    with pytest.raises(RuntimeError, match="disagrees"):
        gs._lowcov_card(st, K, NI, 3, thr, lib=bad, **kw)
    assert bad.calls == []


def test_cpu_runs_the_plain_versions():
    """On the CPU each stages function is its plain version: equal
    outputs, the other keys passed through as the same tensors, no
    launch, compact_state's hold-point flag all False."""
    gs.reset_launches()
    for name, func, arrs, params in sc.edge_batches():
        got = sc.run(func, arrs, params)
        want = sc.run(func, arrs, params, plain=True)
        assert set(got) == set(want), (name, func)
        for k in want:
            _eq(got[k].numpy(), want[k].numpy(), f"{name} {func} {k}")
    arrs = sc.edge_batches()[1][2]
    st = sc.to_torch(arrs)
    out, over, dead = stages.compact_state(st, 256, 272, CMAX,
                                           *sc.SMALL_CAPS)
    assert dead.dtype == torch.bool and dead.shape == over.shape
    assert not dead.any() and out["mer_totq"] is st["mer_totq"]
    assert out["keep_lo"] is st["keep_lo"]
    out, _ = stages.low_cov_pass(st, sc.K_SMALL, 256, 272, 1, 0.01,
                                 torch.ones(1))
    assert out["csum"] is st["csum"] and out["comp"] is st["comp"]
    assert gs.LAUNCHES == dict.fromkeys(gs.LAUNCHES, 0)


def test_wrappers_refuse_mixed_devices_and_dtypes():
    """Inputs on two devices raise before any work; the card path's checks
    refuse other shapes and dtypes."""
    arrs = sc.edge_batches()[1][2]
    st = sc.to_torch(arrs)
    with pytest.raises(ValueError, match="one device"):
        stages.components(st["alive"], st["e_src"].to("meta"), st["e_dst"],
                          st["e_alive"], st["rank"], CMAX)
    bad = dict(st, keep_hi=st["keep_hi"].to("meta"))
    with pytest.raises(ValueError, match="one device"):
        stages.compact_state(bad, 256, 272, CMAX, *sc.SMALL_CAPS)
    with pytest.raises(ValueError, match="one device"):
        stages.item_mincovs(bad, sc.K_SMALL, 256, 272)
    with pytest.raises(ValueError, match="one device"):
        stages.low_cov_pass(st, sc.K_SMALL, 256, 272, 1, 0.01,
                            torch.ones(1, device="meta"))
    W, NI = st["alive"].shape
    shapes = {"i": (W, NI), "i4": (W, NI, 4), "e": (W, 704), "m": (W, 256),
              "mK": (W, 256, sc.K_SMALL)}
    gs._check("compact_state", st, gs.COMPACT_INPUTS, shapes)
    gs._check("low_cov_pass", st, gs.LOWCOV_INPUTS, shapes)
    with pytest.raises(ValueError, match="e_dir"):
        gs._check("compact_state", dict(st, e_dir=st["e_dir"].int()),
                  gs.COMPACT_INPUTS, shapes)
    with pytest.raises(ValueError, match="mer_totq"):
        gs._check("low_cov_pass", dict(st, mer_totq=st["mer_totq"][..., 1:]),
                  gs.LOWCOV_INPUTS, shapes)
    with pytest.raises(ValueError, match="rank"):
        gs._check("components", {"rank": st["rank"][:, 1:]},
                  gs.COMPONENTS_INPUTS, shapes)


def test_totq_rows_read_slices_in_place():
    """mer_totq sliced on its mer axis (the engine's slice_to_fit) goes to
    the kernels in place with its window stride; another layout is
    copied."""
    wide = torch.arange(3 * 10 * 5).reshape(3, 10, 5)
    t, ws = gs._totq_rows(wide[:, :7])
    assert t.data_ptr() == wide.data_ptr() and ws == 50
    cols = wide.transpose(1, 2).contiguous().transpose(1, 2)
    t, ws = gs._totq_rows(cols[:, :4])  # positions strided: copied
    assert t.is_contiguous() and ws == 20
    t, ws = gs._totq_rows(wide[:, :, :3])
    assert t.is_contiguous() and ws == 30


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each kernel on the card bit-equal to its plain version on every
    batch, dtypes too, one launch a call; compact_state's hold-point flag
    set on the dead-edge lane alone."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for name, func, arrs, params in _batches():
        before = gs.LAUNCHES[func]
        got = sc.run(func, arrs, params, "cuda")
        assert gs.LAUNCHES[func] == before + 1, (name, func)
        want = sc.run(func, arrs, params, plain=True)
        assert set(got) == set(want), (name, func)
        runs = [("plan", got)]
        if func in ("item_mincovs", "low_cov_pass"):  # and at every C
            st = sc.state(arrs, params, "cuda")
            K, NI = params["K"], arrs["alive"].shape[1]
            for C in CLUSTER_SIZES:
                if func == "item_mincovs":
                    out = gs._mincovs_card(st, K, NI, C=C)
                    keys = ("mincov", "mincov_qv")
                else:
                    lct, ratio = params["params"]
                    thr = ratio * torch.from_numpy(params["avgcov"]).cuda()
                    out = gs._lowcov_card(st, K, NI, lct, thr, C=C)
                    keys = ("alive", "e_alive", "any")
                runs.append((f"C {C}", {k: v.cpu()
                                        for k, v in zip(keys, out)}))
        for how, res in runs:
            for k in want:
                assert res[k].dtype == want[k].dtype, (name, func, how, k)
                _eq(res[k].numpy(), want[k].numpy(),
                    f"{name} {func} {how} {k}")
    got = sc.run("compact_state", sc.dead_edge_batch(),
                 {"caps": sc.SMALL_CAPS}, "cuda")
    assert got["dead_edge"].tolist() == [True, False]
