"""The port's device graph engine, function by function, against the JAX
package on the CPU: bit-equal integer outputs.

- `gpu.dbg.build_k` at k 11, 31, 33, 61 and 63 (the int64 word
  boundaries: 1, 2 and 3 words of 31 bases) against `tpu.dbg.build_k`;
- `run_attempt`, `path_cover` and `materialize_jobs` against the values the
  JAX device engine computed inside its own jitted attempt, captured with
  `jax.debug.callback` during its one run in this file (one scenario,
  every chunk and k); the same run holds the port's PathJobs and
  device-graph stats equal to the JAX engine's;
- the four plain walks (the CPU versions of the CUDA kernels K1-K4) on
  seeded synthetic graphs built to hit their corners: queue (Q) and pop
  (POPMAX) overflow, a path longer than PN, a directed cycle, a node
  reached in both orientations, chained tips, near-repeat strings; and
  cleanup's tips rounds ending in the verify sweep.

The `cuda` test holds the four kernels bit-equal to the plain versions on
the card; run it there with
    pytest --noconftest -m cuda tests/test_torch_graphwalks.py
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lancet_tpu_torch.gpu import dbg as tdbg  # noqa: E402
from lancet_tpu_torch.gpu import pack as tpack  # noqa: E402
from lancet_tpu_torch.gpu import pipeline as tpl  # noqa: E402
from lancet_tpu_torch.gpu import stages as tst  # noqa: E402
from lancet_tpu_torch.gpu import walkcases, walks  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

_BATCH = ("bases", "quals", "rlen", "rsample", "rstrand", "rfrag", "rorder",
          "raw", "rawlen", "seq_off", "seq_len", "totalreadbp", "window_ok")


def to_t(x):
    """numpy (or a dict/tuple of them) -> torch: bool stays bool, floats
    float32, integers int64 (the port's integer type)."""
    if isinstance(x, dict):
        return {k: to_t(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_t(v) for v in x)
    a = np.asarray(x)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    if a.dtype.kind == "f":
        return torch.from_numpy(a.astype(np.float32))
    return torch.from_numpy(a.astype(np.int64))


def assert_equal(want, got, name=""):
    """JAX numpy values == port tensors, key by key, bit for bit."""
    if isinstance(want, dict):
        assert set(want) <= set(got), (name, set(want) - set(got))
        for k in want:
            assert_equal(want[k], got[k], f"{name}.{k}")
        return
    a = np.asarray(want)
    b = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    bad = a != b.astype(a.dtype)
    assert not bad.any(), (name, np.argwhere(bad)[:5])


# ---------------------------------------------------------------------------
# one run of the JAX device engine, with its attempt's values captured
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    import jax

    import lancet_tpu.engine.devicepipe as jdp
    import lancet_tpu.tpu.pipeline as jpl
    import lancet_tpu.tpu.stages as jstages
    from goldengen import scenario
    from helpers import write_pair
    from lancet_tpu.config import Config as JaxConfig
    from lancet_tpu.runner import run as jax_run
    from lancet_tpu_torch.config import Config
    from lancet_tpu_torch.engine import devicepipe
    from lancet_tpu_torch.runner import run as port_run

    mp = pytest.MonkeyPatch()
    rec = {"chunks": [], "compact": [], "attempt": [], "paths": [],
           "jobs": []}

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    def after(real, key):
        def f(*a, **k):
            out = real(*a, **k)
            jax.debug.callback(lambda o: rec[key].append(np_tree(o)), out)
            return out
        return f

    # a fresh executable cache, so that the attempt is traced with the
    # callbacks below
    mp.setattr(jdp, "_ASSEMBLE_CACHE", {})
    mp.setattr(jstages, "compact_state", after(jstages.compact_state,
                                               "compact"))
    mp.setattr(jpl, "run_attempt", after(jpl.run_attempt, "attempt"))
    mp.setattr(jpl, "path_cover", after(jpl.path_cover, "paths"))
    mp.setattr(jpl, "materialize_jobs", after(jpl.materialize_jobs, "jobs"))
    real_assemble = jdp._assemble

    def assemble(b, ranks, K, N, E, Nc, Ec, raw, cfg_s, dfs_limit,
                 max_indel, max_mismatch, mesh):
        rec["chunks"].append(dict(
            K=K, N=N, E=E, Nc=Nc, Ec=Ec, ranks=np.asarray(ranks),
            raw=np.asarray(raw), cfg_s=dict(cfg_s), dfs_limit=dfs_limit,
            max_indel=max_indel, max_mismatch=max_mismatch))
        return real_assemble(b, ranks, K, N, E, Nc, Ec, raw, cfg_s,
                             dfs_limit, max_indel, max_mismatch, mesh)
    mp.setattr(jdp, "_assemble", assemble)
    real_dispatch = jdp._dispatch_chunk

    def dispatch(chunk, cfg, K, W, bi, Lraw, mesh, stats=None):
        out = real_dispatch(chunk, cfg, K, W, bi, Lraw, mesh, stats)
        rec.setdefault("batches", []).append(
            (K, bi, {s: getattr(out["batch"], s).copy() for s in _BATCH}))
        return out
    mp.setattr(jdp, "_dispatch_chunk", dispatch)

    seen = {}

    def keep(mod, key):
        real = mod.run_device_graph

        def run_device_graph(tasks, *a, **k):
            real(tasks, *a, **k)
            seen[key] = [(t.widx, t.done, t.fallback, t.k_done,
                          [_job_tuple(j) for j in t.jobs]) for t in tasks]
        mp.setattr(mod, "run_device_graph", run_device_graph)

    keep(jdp, "jax")
    keep(devicepipe, "port")
    mp.setenv("LANCET_TPU_DEVGRAPH", "1")
    refseq, tumor, normal, region = scenario("somatic_snv", 1)
    ref, t, n = write_pair(str(tmp_path_factory.mktemp("scn")), refseq,
                           "chr1", tumor, normal)
    d = dict(tumor_bam=t, normal_bam=n, ref_fasta=ref, region=region)
    out = {"rec": rec, "seen": seen, "cfg": Config(**d)}
    try:
        for key, fn in (("jax", lambda s: jax_run(
                JaxConfig(**d), command_line="t", date="D\n", engine="tpu",
                stats=s)), ("port", lambda s: port_run(
                    Config(**d), command_line="t", date="D\n",
                    device="cpu", stats=s))):
            stats: dict = {}
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                vcf = fn(stats)
            out[key] = (vcf, err.getvalue(), stats)
    finally:
        mp.undo()
    return out


def _job_tuple(j):
    return (j.refchr, j.refstart, j.trim5, j.refseq, j.pathseq, j.K,
            j.needs_dp, j.lr_mode, j.covN.tolist(), j.covT.tolist(),
            np.asarray(j.tumor_span, bool).tolist(), j.ref_cov_nml.tolist(),
            j.ref_cov_tmr.tolist())


def test_jobs_and_stats_equal_jax(engines):
    """The port's device graph engine and the JAX one on one scenario:
    the same VCF and summary, the same PathJobs per window (every field)
    and task outcomes, and the same device-graph stats and DP samples."""
    jvcf, jerr, jstats = engines["jax"]
    pvcf, perr, pstats = engines["port"]
    assert (pvcf, perr) == (jvcf, jerr)
    assert engines["seen"]["port"] == engines["seen"]["jax"]
    assert any(jobs for *_, jobs in engines["seen"]["port"])
    for key in ("n_dev_windows", "n_dev_fallback", "dev_fallback_causes",
                "k_histogram", "n_jobs", "n_dp", "n_dev_attempts"):
        assert pstats[key] == jstats[key], key
    # the DP pairs sampled for a parity check, list for list
    assert pstats.get("dp_samples") == jstats.get("dp_samples")
    assert len(engines["rec"]["jobs"]) == len(engines["rec"]["chunks"]) >= 1


def _port_build(engines, i):
    """The port's build + slice-to-fit of captured chunk i, with its
    captured arguments."""
    from lancet_tpu_torch.engine.devicepipe import _D, slice_to_fit

    rec, cfg = engines["rec"], engines["cfg"]
    K, _, arrs = rec["batches"][i]
    c = rec["chunks"][i]
    b = tdbg.build_k(K, *[torch.from_numpy(arrs[s]) for s in _BATCH],
                     N=c["N"], E=c["E"], D=_D, Lraw=arrs["raw"].shape[1],
                     min_qual_call=cfg.min_qual_call,
                     low_cov_threshold=cfg.low_cov_threshold,
                     min_cov_ratio=cfg.min_cov_ratio)
    return slice_to_fit(b, c["N"], c["Nc"], c["Ec"]), c


def test_run_attempt_equals_jax(engines):
    rec = engines["rec"]
    for i, c in enumerate(rec["chunks"]):
        b, c = _port_build(engines, i)
        st, res = tpl.run_attempt(b, torch.from_numpy(c["ranks"].astype(
                                      "int64")),
                                  c["K"], c["Nc"], c["Ec"], 8, c["cfg_s"])
        jst, jres = rec["attempt"][i]
        assert_equal(jres, res, "res")
        assert_equal(jst, st, "st")
        cst, cover = rec["compact"][i]
        assert cst["alive"].shape[1] == tpl.NCR_DEFAULT + 16


def test_path_cover_equals_jax(engines):
    """path_cover on the JAX attempt's own state (so that it is held
    alone), default caps."""
    rec = engines["rec"]
    for i, c in enumerate(rec["chunks"]):
        jst, jres = rec["attempt"][i]
        st, res = to_t(jst), to_t(jres)
        NCR = tpl.NCR_DEFAULT
        paths = tpl.path_cover(st, res, c["K"], NCR, NCR + 16, 8,
                               res["ends"]["dist"], c["dfs_limit"],
                               c["max_indel"])
        assert_equal(rec["paths"][i], paths, "paths")
        assert int(paths["n_sel"].sum()) > 0


def test_materialize_jobs_equals_jax(engines):
    rec = engines["rec"]
    for i, c in enumerate(rec["chunks"]):
        b, c = _port_build(engines, i)
        jst, jres = rec["attempt"][i]
        NIc = tpl.NCR_DEFAULT + 16
        jobs = tpl.materialize_jobs(
            to_t(jst), b, to_t(rec["paths"][i]), to_t(jres), c["K"], c["Nc"],
            NIc, 8, torch.from_numpy(np.array(c["raw"])), c["max_mismatch"])
        assert_equal(rec["jobs"][i], jobs, "jobs")


def test_tips_rounds_and_verify_sweep_equal_jax(engines):
    """cleanup with one tips round: a round that removes tips is followed
    by the verify sweep (fallback if it still removes); JAX's cleanup and
    the port's on the JAX compact state of every captured chunk."""
    import jax

    import lancet_tpu.tpu.pipeline as jpl

    rec = engines["rec"]
    sweeps = []
    # the removal passes of the port's cleanup on the CPU: the plain
    # version under tip_fixpoint's
    real = tst.seq_removal_pass_plain

    def counted(*a, **k):
        sweeps[-1] += 1
        return real(*a, **k)

    NCR = tpl.NCR_DEFAULT
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tst, "seq_removal_pass_plain", counted)
        for i, c in enumerate(rec["chunks"]):
            cst, _ = rec["compact"][i]
            avgcov = _avgcov(engines, i)
            jst, jfb = jax.jit(lambda s, a: jpl.cleanup(
                s, c["K"], NCR, NCR + 16, c["cfg_s"], a, TIP_ROUNDS=1))(
                    cst, avgcov)
            sweeps.append(0)
            st, fb = tpl.cleanup(to_t(cst), c["K"], NCR, NCR + 16,
                                 c["cfg_s"], torch.from_numpy(avgcov),
                                 TIP_ROUNDS=1)
            assert_equal(np.asarray(jfb), fb, "fallback")
            assert_equal(jax_np(jst), st, "st")
    # a round that removed tips, then the verify sweep
    assert max(sweeps) >= 2, sweeps


def _avgcov(engines, i):
    K, _, arrs = engines["rec"]["batches"][i]
    return (arrs["totalreadbp"].astype(np.float32)
            / np.maximum(arrs["rawlen"].astype(np.float32), 1.0))


# ---------------------------------------------------------------------------
# build_k at the word boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [11, 31, 33, 61, 63])
def test_build_k_equals_jax(engines, K):
    """Node and edge tables, ranks and fallback flags of one chunk: the
    port's build (int64 words of 31 bases) and the JAX build (uint32
    words), the mers compared as 128-bit values."""
    from lancet_tpu.engine.devicepipe import _map_ranks_batch as jranks
    from lancet_tpu.tpu import dbg as jdbg
    from lancet_tpu_torch.engine.devicepipe import _map_ranks_batch

    cfg = engines["cfg"]
    _, _, arrs = engines["rec"]["batches"][0]
    W = 4  # the chunk's two windows and two padding lanes
    arrs = {s: a[:W] for s, a in arrs.items()}
    N, E = 1536, 3840
    kw = dict(N=N, E=E, D=12, Lraw=arrs["raw"].shape[1],
              min_qual_call=cfg.min_qual_call,
              low_cov_threshold=cfg.low_cov_threshold,
              min_cov_ratio=cfg.min_cov_ratio)
    jo = jdbg.build_k(K, *[arrs[s] for s in _BATCH], **kw)
    po = tdbg.build_k(K, *[torch.from_numpy(arrs[s]) for s in _BATCH], **kw)
    for key in jo:
        if key not in ("mers_w", "mers_hi", "mers_lo"):
            assert_equal(np.asarray(jo[key]), po[key], key)
    nn = np.asarray(jo["n_nodes"])
    assert (nn[:2] > 500).all() and not nn[2:].any()
    jw = [np.asarray(x).astype(np.uint64) for x in jo["mers_w"]]
    zero = np.zeros_like(jw[0])
    jlo = jw[0] | ((jw[1] if len(jw) > 1 else zero) << np.uint64(32))
    jhi = ((jw[2] if len(jw) > 2 else zero)
           | ((jw[3] if len(jw) > 3 else zero) << np.uint64(32)))
    phi, plo = tpack.words_to_128([m.numpy() for m in po["mers_w"]], K)
    live = np.arange(N)[None, :] < nn[:, None]
    assert (jhi[live] == phi[live]).all() and (jlo[live] == plo[live]).all()
    # the rank round trip: 128-bit halves -> native map-order ranks
    want = jranks([np.asarray(x) for x in jo["mers_w"]], nn,
                  arrs["window_ok"], K, W, N)
    got = _map_ranks_batch([m.numpy() for m in po["mers_w"]], nn,
                           arrs["window_ok"], K, W, N)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1],
                                                              got[1])
    mers = tpack.unpack_mers_words(phi[0][:nn[0]], plo[0][:nn[0]], K)
    r, _ = tpack.map_ranks(mers)
    assert np.array_equal(r, got[0][0][:nn[0]])


# ---------------------------------------------------------------------------
# the plain walks on synthetic graphs
# ---------------------------------------------------------------------------

def _dag_lane(rng, N, n_nodes, width, extra):
    """A layered DAG over items 0..n_nodes-1 from component 1's source
    anchor N to its sink anchor N+1: (src, dst, dir) edges, all FF."""
    layers = [list(range(i, min(i + width, n_nodes)))
              for i in range(0, n_nodes, width)]
    edges = [(N, v, 0) for v in layers[0]]
    for a, b in zip(layers, layers[1:]):
        for u in a:
            for v in b:
                if rng.random() < extra:
                    edges.append((u, v, 0))
        for v in b:  # every node reached
            edges.append((a[rng.integers(len(a))], v, 0))
    edges += [(u, N + 1, 0) for u in layers[-1]]
    return edges


def _graph(lanes, N, Cmax, EE):
    """Edge lists per lane -> (e_src, e_dst, e_dir, e_alive, e_okey)
    numpy [W, EE] with okey = creation index (anchor edges first)."""
    W = len(lanes)
    e = np.zeros((5, W, EE), np.int64)
    e[4] = 1 << 30
    for w, edges in enumerate(lanes):
        for i, (s, d, r) in enumerate(edges):
            e[:, w, i] = (s, d, r, 1, i)
    return e[0], e[1], e[2], e[3].astype(bool), e[4]


def test_path_cover_plain_overflows_equal_jax():
    """Small Q, POPMAX and PN so that lanes overflow the queue, run out of
    pops and find paths longer than PN; JAX's lockstep path_cover and the
    port's plain walk on the same state."""
    import jax.numpy as jnp

    import lancet_tpu.tpu.pipeline as jpl

    rng = np.random.default_rng(5)
    N, Cmax, K, EE = 40, 2, 11, 400
    NI = N + 2 * Cmax
    lanes = [_dag_lane(rng, N, 8, 2, 0.0),    # fits
             _dag_lane(rng, N, 36, 6, 0.9),   # queue overflow
             _dag_lane(rng, N, 30, 1, 0.0),   # a 31-hop chain: > PN
             _dag_lane(rng, N, 24, 4, 0.6)]   # pop limit
    W = len(lanes)
    e_src, e_dst, e_dir, e_alive, e_okey = _graph(lanes, N, Cmax, EE)
    alive = np.zeros((W, NI), bool)
    alive[:, :N] = True
    alive[:, N:N + 2] = True
    special = np.zeros((W, NI), bool)
    special[:, N:] = True
    merlen = rng.integers(1, 4, (W, NI)).astype(np.int64)
    st = dict(e_src=e_src, e_dst=e_dst, e_dir=e_dir, e_alive=e_alive,
              e_okey=e_okey, merlen=merlen, special=special, alive=alive)
    ends = dict(anchored=np.ones((W, Cmax), bool),
                dist=np.full((W, Cmax), 10_000, np.int64),
                src_pos=np.zeros((W, Cmax), np.int64))
    res = dict(ends=ends, cyc1=np.zeros((W, Cmax), bool),
               cyc2=np.zeros((W, Cmax), bool),
               numcomp=np.ones(W, np.int64))
    caps = dict(Q=48, POPMAX=40, JMAX=3, PN=12, D2=24)
    jout = jpl.path_cover({k: jnp.asarray(v) for k, v in st.items()},
                          jax_tree(res), K, N, NI, Cmax,
                          jnp.asarray(ends["dist"]), 1 << 30, 10_000,
                          **caps)
    pout = tpl.path_cover(to_t(st), to_t(res), K, N, NI, Cmax,
                          to_t(ends["dist"]), 1 << 30, 10_000, **caps)
    assert_equal(jax_np(jout), pout, "paths")
    fb = pout["fallback"].numpy()
    assert not fb[0] and fb[1] and fb[2] and fb[3], fb
    assert int(pout["n_sel"][0]) >= 1


def jax_tree(t):
    import jax.numpy as jnp

    if isinstance(t, dict):
        return {k: jax_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(jax_tree(v) for v in t)
    return jnp.asarray(t)


def jax_np(t):
    import jax

    return jax.tree_util.tree_map(np.asarray, t)


def test_cycle_dfs_plain_equals_jax():
    """A directed cycle, a node reached in both orientations, an acyclic
    lane and a masked-out lane: the screen's flags and the exact replay's
    verdicts, JAX against the port."""
    import lancet_tpu.tpu.stages as jstages

    N, Cmax, EE = 12, 2, 64
    NI = N + 2 * Cmax
    src, snk = N, N + 1
    FF, FR, RF = 0, 1, 2
    lanes = [
        [(src, 0, FF), (0, 1, FF), (1, 2, FF), (2, snk, FF)],  # acyclic
        [(src, 0, FF), (0, 1, FF), (1, 2, FF), (2, 0, FF),
         (2, snk, FF)],  # 0 -> 1 -> 2 -> 0
        [(src, 0, FF), (0, 1, FR), (1, 2, RF), (2, 1, FF),
         (1, snk, FF)],  # 1 reached as R then as F
        [(src, 0, FF), (0, 1, FF), (1, 0, FF), (1, snk, FF)],  # masked
    ]
    W = len(lanes)
    e_src, e_dst, e_dir, e_alive, e_okey = _graph(lanes, N, Cmax, EE)
    alive = np.zeros((W, NI), bool)
    alive[:, :3] = True
    alive[:, N:N + 2] = True
    special = np.zeros((W, NI), bool)
    special[:, N:] = True
    comp = np.where(alive, 1, 0)
    args = (e_src, e_dst, e_dir, e_alive)
    jscr = np.asarray(jstages.cycle_screen(*jax_tree(args),
                                           *jax_tree((alive, special, comp)),
                                           N, NI, Cmax))
    pscr = tst.cycle_screen(*to_t(args), *to_t((alive, special, comp)), N,
                            NI, Cmax)
    assert_equal(jscr, pscr, "screen")
    assert list(jscr[:, 0]) == [False, True, True, True]
    mask = jscr.copy()
    mask[3] = False
    jcyc, jover = jstages.has_cycle_seq(
        *jax_tree(args + (e_okey, alive, special)), N, NI, Cmax,
        lane_mask=jax_tree(mask))
    pcyc, pover = tst.has_cycle_seq(*to_t(args + (e_okey, alive, special)),
                                    N, NI, Cmax, lane_mask=to_t(mask))
    assert_equal(np.asarray(jcyc), pcyc, "cyc")
    assert_equal(np.asarray(jover), pover, "over")
    assert list(np.asarray(jcyc)[:, 0]) == [False, True, True, False]


@pytest.mark.parametrize("mode", ["tips", "links"])
def test_seq_removal_plain_equals_jax(mode):
    """The map-rank-order sweep on random graphs with chained tips (a
    removal lowers a neighbour's degree within the same sweep), in both
    conditions, JAX against the port; also the slot and neighbour tables'
    overflow flags (U, D2)."""
    import jax.numpy as jnp

    import lancet_tpu.tpu.stages as jstages

    rng = np.random.default_rng(11)
    W, NI, EE, U, D2 = 4, 48, 160, 32, 6
    e_src = rng.integers(0, NI - 4, (W, EE))
    e_dst = rng.integers(0, NI - 4, (W, EE))
    e_alive = rng.random((W, EE)) < np.array([0.2, 0.35, 0.5, 0.9])[:, None]
    st = dict(alive=rng.random((W, NI)) < np.array(
        [0.5, 0.6, 0.95, 0.95])[:, None],
              special=np.zeros((W, NI), bool),
              rank=np.stack([rng.permutation(NI) for _ in range(W)]),
              e_src=e_src, e_dst=e_dst, e_alive=e_alive)
    st["special"][:, NI - 4:] = True
    merlen = rng.integers(1, 9, (W, NI))
    mincov = rng.integers(0, 6, (W, NI))
    thr = np.array([2, 3, 4, 5])
    guard = rng.random((W, NI)) < 0.2
    if mode == "tips":
        def jcond(items, deg):
            ml = jnp.take_along_axis(jnp.asarray(merlen), items[:, None],
                                     1)[:, 0]
            return (deg <= 1) & (ml < 6)
        cond = ("tips", to_t(merlen), 6)
    else:
        def jcond(items, deg):
            take = lambda a: jnp.take_along_axis(  # noqa: E731
                jnp.asarray(a), items[:, None], 1)[:, 0]
            return ((deg >= 2) & (take(merlen) < 6)
                    & (take(mincov) <= jnp.asarray(thr)) & ~take(guard))
        cond = ("links", to_t(merlen), 6, to_t(mincov), to_t(thr),
                to_t(guard))
    jst, jany, jover = jstages._seq_removal_pass(jax_tree(st), jcond, U, D2)
    pst, pany, pover = tst._seq_removal_pass(to_t(st), cond, U, D2)
    assert_equal(jax_np(jst), pst, "st")
    assert_equal(np.asarray(jany), pany, "any")
    assert_equal(np.asarray(jover), pover, "over")
    assert np.asarray(jany).any() and np.asarray(jover).any()
    assert not np.asarray(jover).all()


def test_almost_repeat_plain_equals_jax():
    """Random path strings with planted exact and near repeats at several
    shifts, short strings (no offset), and empty slots."""
    import jax.numpy as jnp

    import lancet_tpu.tpu.pipeline as jpl

    rng = np.random.default_rng(3)
    W, J, LP, K = 3, 4, 160, 11
    seq = rng.integers(0, 4, (W, J, LP)).astype(np.int8)
    lens = rng.integers(60, LP, (W, J))
    lens[0, 0], lens[0, 1], lens[2, 3] = 0, K + 1, K + 2
    for w, j, src, dst, nmis in ((1, 0, 10, 40, 0), (1, 1, 5, 90, 2),
                                 (1, 2, 3, 30, 3), (2, 0, 20, 21, 1)):
        seq[w, j, dst:dst + K + 1] = seq[w, j, src:src + K + 1]
        for q in rng.choice(K + 1, nmis, replace=False):
            seq[w, j, dst + q] = (seq[w, j, dst + q] + 1) % 4
    seq[2, 1, :] = 4  # an all-N string
    for mm in (0, 2):
        want = np.asarray(jpl._is_almost_repeat_paths(
            jnp.asarray(seq), jnp.asarray(lens), K, mm, LP))
        got = tpl._is_almost_repeat_paths(torch.from_numpy(seq),
                                          torch.from_numpy(lens), K, mm, LP)
        assert_equal(want, got, f"is_rep mm={mm}")
        assert want[1].any() and not want[0, :2].any()


def test_plain_walks_mark_the_elements_they_read():
    """The reads path_cover_plain and cycle_dfs_plain record (the bytes
    of the kernels' bounds): on the chain src -> 0 -> 1 -> 2 -> sink with
    an R-oriented edge src -> 3, counted by hand; a lane with no active
    component reads nothing; the outputs do not change."""
    N, Cmax, D2, EE = 4, 1, 4, 8
    NI = N + 2 * Cmax
    src, snk = N, N + 1
    edges = [(src, 0, 0), (0, 1, 0), (1, 2, 0), (2, snk, 0), (src, 3, 2)]
    adj = torch.full((2, NI, D2), -1, dtype=torch.int64)
    e_dst = torch.zeros((2, EE), dtype=torch.int64)
    e_dir = torch.zeros((2, EE), dtype=torch.int64)
    fill = {}
    for i, (s, d, r) in enumerate(edges):
        adj[:, s, fill.get(s, 0)] = i
        fill[s] = fill.get(s, 0) + 1
        e_dst[:, i], e_dir[:, i] = d, r
    special = torch.zeros((2, NI), dtype=torch.bool)
    special[:, N:] = True
    alive = torch.ones((2, NI), dtype=torch.bool)
    merlen = torch.ones((2, NI), dtype=torch.int64)
    on = torch.tensor([[True], [False]])

    def seen(counts):
        return {k: (v > 0).sum(dim=1).tolist() for k, v in counts.items()
                if torch.is_tensor(v)}

    kw = dict(K=11, N=N, Cmax=Cmax, dfs_limit=1 << 30, max_indel=100, Q=16,
              POPMAX=32, JMAX=4, PN=8)
    pc_args = (adj, e_dst, e_dir, merlen, special, on,
               on[:, 0].to(torch.int64), torch.full((2, Cmax), 100))
    counts: dict = {}
    got = tpl.path_cover_plain(*pc_args, **kw, counts=counts)
    want = tpl.path_cover_plain(*pc_args, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # BFS rows src, 0, 1, 2, and the sink's once the first path covers
    # every edge (the entry reached over covered edges only is expanded);
    # both src edges' dirs; the F chain's dsts
    assert (counts["adj_rows"][0] > 0).tolist() == [True] * 3 + [False,
                                                                True, True]
    assert seen(counts) == {"adj_rows": [5, 0], "e_dir": [5, 0],
                            "e_dst": [4, 0], "nodes": [4, 0]}
    assert counts["pops"] > 0

    dfs_args = (adj, e_dst, e_dir, alive, special, N, Cmax, on)
    counts = {}
    got = tst.cycle_dfs_plain(*dfs_args, counts=counts)
    assert torch.equal(got, tst.cycle_dfs_plain(*dfs_args))
    assert not got.any()
    # adjacency slots: src 0-2, nodes 0-2 slots 0-1, node 3 slot 0; the R
    # search follows src -> 3 too; specials read at 0, 1, 2, 3 and sink
    assert seen(counts) == {"adj": [10, 0], "e_dir": [5, 0],
                            "e_dst": [5, 0], "special": [5, 0]}


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1-K4 bit-equal to their plain versions on synthetic inputs (K2 in
    both modes, with sources past D2), and on the crafted cases of
    gpu.walkcases (each staging mode, K3's word and tile edges, the
    removal pass's corners included)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    W, NI, D2, EE, U = 6, 64, 16, 256, 48
    adj = torch.from_numpy(rng.integers(-1, EE, (W, NI, D2)))
    e_dst = torch.from_numpy(rng.integers(0, NI, (W, EE)))
    e_dir = torch.from_numpy(rng.integers(0, 4, (W, EE)))
    alive = torch.from_numpy(rng.random((W, NI)) < 0.9)
    special = torch.zeros((W, NI), dtype=torch.bool)
    special[:, NI - 8:] = True
    mask = torch.from_numpy(rng.random((W, 4)) < 0.7)
    want = walks.cycle_dfs(adj, e_dst, e_dir, alive, special, NI - 8, 4,
                           mask)
    got = walks.cycle_dfs(*[t.to(dev) for t in (adj, e_dst, e_dir, alive,
                                                special)], NI - 8, 4,
                          mask.to(dev))
    assert torch.equal(got.cpu(), want)
    merlen = torch.from_numpy(rng.integers(1, 9, (W, NI)))
    st = dict(alive=alive, special=special,
              rank=torch.from_numpy(np.stack([rng.permutation(NI)
                                              for _ in range(W)])),
              e_src=torch.from_numpy(rng.integers(0, NI, (W, EE))),
              e_dst=e_dst,
              e_alive=torch.from_numpy(rng.random((W, EE)) < 0.3))
    for cond in (("tips", merlen, 6),
                 ("links", merlen, 6, merlen % 4, torch.full((W,), 2),
                  merlen > 7)):
        want = walks.seq_removal(st, cond, U, 6)
        got = walks.seq_removal(
            {k: v.to(dev) for k, v in st.items()},
            tuple(c.to(dev) if torch.is_tensor(c) else c for c in cond),
            U, 6)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), cond[0]
    seq = torch.from_numpy(rng.integers(0, 4, (W, 4, 200)))
    lens = torch.from_numpy(rng.integers(0, 200, (W, 4)))
    want = walks.almost_repeat(seq, lens, 11, 3)
    got = walks.almost_repeat(seq.to(dev), lens.to(dev), 11, 3)
    assert torch.equal(got.cpu(), want)
    runnable = torch.ones((W, 4), dtype=torch.bool)
    numcomp = torch.full((W,), 4)
    reflens = torch.full((W, 4), 500)
    kw = dict(K=11, N=NI - 8, Cmax=4, dfs_limit=1 << 30, max_indel=500,
              Q=64, POPMAX=80, JMAX=4, PN=8)
    adj24 = torch.from_numpy(rng.integers(-1, EE, (W, NI, 24)))
    want = walks.path_cover(adj24, e_dst, e_dir, merlen, special, runnable,
                            numcomp, reflens, **kw)
    got = walks.path_cover(*[t.to(dev) for t in (
        adj24, e_dst, e_dir, merlen, special, runnable, numcomp, reflens)],
        **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k

    for name, c in walkcases.cycle_cases().items():
        before = walks.LAUNCHES["cycle_dfs"]
        got = walkcases.run_cycle(c, dev)
        torch.cuda.synchronize()
        assert walks.LAUNCHES["cycle_dfs"] == before + 1
        want = walkcases.run_cycle(c)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), name
    for name, c in walkcases.path_cover_cases().items():
        before = walks.LAUNCHES["path_cover"]
        got = walkcases.run_cover(c, dev)
        torch.cuda.synchronize()
        assert walks.LAUNCHES["path_cover"] == before + 1
        want = walkcases.run_cover(c)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (name, k)
    for name, c in walkcases.almost_repeat_cases().items():
        before = walks.LAUNCHES["almost_repeat_paths"]
        got = walkcases.run_almost_repeat(c, dev)
        torch.cuda.synchronize()
        assert walks.LAUNCHES["almost_repeat_paths"] == before + 1
        assert torch.equal(got.cpu(), walkcases.run_almost_repeat(c)), name
    for name, c in walkcases.removal_cases().items():
        before = walks.LAUNCHES["seq_removal"]
        got = walkcases.run_removal(c, dev)
        torch.cuda.synchronize()
        assert walks.LAUNCHES["seq_removal"] == before + 1
        for g, w in zip(got, walkcases.run_removal(c)):
            assert torch.equal(g.cpu(), w), name


def test_pack_equals_jax():
    """pack_chunk of the port against the JAX pack_chunk, and pack_window
    against pack_chunk on the lanes that fit, on seeded reads: an N in one
    window's sequence, a read over the length cap and too many reads, each
    flagged as overflow."""
    from lancet_tpu.engine.devicepipe import WindowTask as JaxTask
    from lancet_tpu.tpu import pack as jpack
    from lancet_tpu_torch.engine.devicepipe import WindowTask

    rng = np.random.default_rng(8)

    def read(n, label, strand, frag, order):
        seq = rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes()
        qual = rng.integers(33, 75, n).astype(np.uint8).tobytes()
        return (seq, qual, label, strand, frag, order)

    raws = ["".join(rng.choice(list("ACGT"), 90)) for _ in range(5)]
    raws[2] = raws[2][:40] + "N" + raws[2][41:]
    reads = [[read(int(rng.integers(20, 30)), (4, 5)[i % 2], 1 + i % 2,
                   i // 2 if w % 2 else -1, (1 + i % 2) if w % 2 else 0)
              for i in range(int(rng.integers(2, 6)))] for w in range(5)]
    reads[3].append(read(40, 4, 1, -1, 0))  # longer than L
    reads[4] += [read(25, 5, 2, -1, 0) for _ in range(4)]  # more than R
    W, R, L, Lraw = 6, 7, 32, 96
    jb = jpack.WindowBatch(W, R, L, Lraw)
    jpack.pack_chunk(jb, [JaxTask(widx=w, reads=r, rawseq=s, totalreadbp=7)
                          for w, (r, s) in enumerate(zip(reads, raws))])
    tb = tpack.WindowBatch(W, R, L, Lraw)
    tpack.pack_chunk(tb, [WindowTask(widx=w, reads=r, rawseq=s,
                                     totalreadbp=7)
                          for w, (r, s) in enumerate(zip(reads, raws))])
    wb = tpack.WindowBatch(W, R, L, Lraw)
    for w, (r, s) in enumerate(zip(reads, raws)):
        tpack.pack_window(wb, w, r, s, 0, len(s), 7)
    ok = ~tb.overflow  # pack_window leaves an overflowing lane part-filled
    for name in tpack.WindowBatch.__slots__[:-4]:
        assert np.array_equal(getattr(jb, name), getattr(tb, name)), name
        assert np.array_equal(getattr(wb, name)[ok], getattr(tb, name)[ok])
    assert list(tb.overflow) == [False, False, True, True, True, False]
    assert list(wb.overflow) == list(tb.overflow)
