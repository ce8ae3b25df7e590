"""The crafted walk cases of `lancet_tpu_torch.gpu.walkcases` against the
JAX package on the CPU, and the two launch plans of the walks that stage a
window's graph in shared memory.

- `has_cycle_seq` (the plain `cycle_dfs` walk): an item reached in both
  orientations where the slot order decides the verdict, a walk as deep as
  every regular item, the largest bucket (NI 4,112, the global mode), and
  several active components in one window;
- `path_cover` (the plain walk): equal-score paths (the FIFO's order picks
  the first found), queue overflow, the POPMAX and dfs_limit stops, a path
  longer than PN, and a window whose staged graph takes the global mode;
- `walks.cycle_dfs_plan` and `walks.path_cover_plan` on the device graph
  engine's shapes and at the byte boundaries;
- `almost_repeat_plain` (isAlmostRepeat on path strings): hits at the
  largest shift and the last start, mismatch budgets at, past and below
  their limits, N and odd codes, strings of the engine's full LP 1,728,
  and hits at the edges of the kernel's words and tiles, up to K 63; and
  `walks.almost_repeat_plan`;
- the removal pass (`seq_removal_pass_plain` and the port's
  `_seq_removal_pass`) against the JAX `_seq_removal_pass`: chained tips,
  rank ties, more live items than slots, a source past D2 edges,
  self-loops, duplicate edges, edges to dead items and anchors, empty
  windows, W 1, the links mode's guard, the engine's cleanup shape; a
  numpy replay of the K2 kernel's own steps (its keys, slot entries, the
  sweep 32 slots at a time with each kill's edge scan) against the plain
  version on those cases and on seeded random graphs; `walks.
  seq_removal_plan`; and the K2 wrapper's inputs taken with no copy.

The `cuda` test of tests/test_torch_graphwalks.py holds the kernels
bit-equal to the plain versions on every case on the card.
"""

import functools

import numpy as np
import pytest
import torch

from lancet_tpu_torch.gpu import walkcases, walks

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

CYCLE = walkcases.cycle_cases()
COVER = walkcases.path_cover_cases()
REPEAT = walkcases.almost_repeat_cases()
REMOVAL = walkcases.removal_cases()


@pytest.mark.parametrize("name", sorted(CYCLE))
def test_cycle_case_equals_jax(name):
    import jax.numpy as jnp

    import lancet_tpu.tpu.stages as jstages

    c = CYCLE[name]
    jcyc, jover = jstages.has_cycle_seq(
        *[jnp.asarray(c[k]) for k in walkcases.CYCLE_ARGS], c["N"],
        c["NI"], c["Cmax"], D2=c["D2"],
        lane_mask=jnp.asarray(c["lane_mask"]))
    pcyc, pover = walkcases.run_cycle(c)
    assert np.array_equal(np.asarray(jcyc), pcyc.numpy())
    assert np.array_equal(np.asarray(jover), pover.numpy())
    assert not pover.any()
    if c["expect"] is not None:
        assert np.array_equal(pcyc.numpy(), c["expect"]), pcyc
    else:
        assert pcyc[1].any() and not pcyc[0].any()
    EE = c["e_src"].shape[1]
    mode = "global" if name == "largest_bucket" else "smem"
    assert walks.cycle_dfs_plan(c["NI"], c["D2"], EE, c["Cmax"]).mode == mode


@pytest.mark.parametrize("name", sorted(COVER))
def test_path_cover_case_equals_jax(name):
    import jax
    import jax.numpy as jnp

    import lancet_tpu.tpu.pipeline as jpl

    c = COVER[name]
    jout = jpl.path_cover(jax.tree_util.tree_map(jnp.asarray, c["st"]),
                          jax.tree_util.tree_map(jnp.asarray, c["res"]),
                          c["K"], c["N"], c["NI"], c["Cmax"],
                          jnp.asarray(c["reflens"]), c["dfs_limit"],
                          c["max_indel"], **c["caps"])
    pout = walkcases.run_cover(c)
    assert set(jout) == set(pout)
    for k in jout:
        assert np.array_equal(np.asarray(jout[k]),
                              pout[k].numpy().astype(np.asarray(
                                  jout[k]).dtype)), k
    assert pout["fallback"].tolist() == c["expect_fallback"]
    assert int(pout["n_sel"].sum()) > 0
    EE = c["st"]["e_src"].shape[1]
    cp = c["caps"]
    mode = "global" if name == "global_mode" else "smem"
    assert walks.path_cover_plan(c["NI"], cp["D2"], EE, cp["Q"],
                                 cp["PN"]).mode == mode


def test_fifo_ties_pick_the_first_found():
    """Of equal-score paths, the first one the BFS reaches (the earlier
    adjacency slot) is selected, then the one over uncovered edges."""
    c = COVER["fifo_ties"]
    out = walkcases.run_cover(c)
    e_dst = c["st"]["e_dst"]
    hops = out["sel_hops"].numpy()
    firsts = [[int(e_dst[w, out["sel_edges"][w, j, 0]])
               for j in range(int(out["n_sel"][w]))] for w in range(2)]
    assert firsts == [[0, 1, 3, 4], [5, 6, 7, 8]]
    assert out["sel_comp"][0, :4].tolist() == [1, 1, 2, 2]
    assert hops[0, :4].tolist() == [3, 3, 2, 2]


@pytest.mark.parametrize("shape,mode,walkers", [
    ((1552, 16, 3872, 8), "smem", 8),     # cyc1 at the first bucket
    ((528, 24, 1568, 8), "smem", 8),      # cyc2 on the compact state
    ((4112, 16, 10272, 8), "global", 8),  # cyc1 at the largest bucket
    ((2500, 16, 6000, 8), "smem", 5),     # lists fit, 5 walkers beside
    ((60, 8, 200, 3), "smem", 3),         # at most Cmax walkers
])
def test_cycle_dfs_plan(shape, mode, walkers):
    NI, D2, EE, Cmax = shape
    pl = walks.cycle_dfs_plan(NI, D2, EE, Cmax)
    assert (pl.mode, pl.walkers) == (mode, walkers)
    assert pl.smem == walks.cycle_dfs_smem(NI, D2, EE, Cmax, walkers,
                                           mode == "global")
    assert pl.smem <= walks.SMEM_LIMIT
    if mode == "smem" and walkers < min(Cmax, 8):
        assert walks.cycle_dfs_smem(NI, D2, EE, Cmax, walkers + 1,
                                    False) > walks.SMEM_LIMIT
    if mode == "global":
        assert walks.cycle_dfs_smem(NI, D2, EE, Cmax, 1,
                                    False) > walks.SMEM_LIMIT
    # the staging's edge words share their space with the stacks
    assert walks.cycle_dfs_smem(NI, D2, 10**5, Cmax, walkers,
                                mode == "global") >= 4 * 10**5


def test_walk_plans_refuse_what_the_kernels_do_not_take():
    # a stack frame packs the slot in 6 bits and the item in 19; a lane
    # expands each of path_cover's slots; a queue entry packs its parent
    # in 16 bits
    with pytest.raises(ValueError):
        walks.cycle_dfs_plan(528, 64, 1568, 8)
    with pytest.raises(ValueError):
        walks.cycle_dfs_plan(1 << 19, 1, 1568, 1)
    with pytest.raises(ValueError):
        walks.path_cover_plan(528, 33, 1568, 512, 24)
    with pytest.raises(ValueError):
        walks.path_cover_plan(528, 24, 1568, 65536, 24)
    assert walks.cycle_dfs_plan(528, 63, 1568, 8).mode == "smem"
    # one walker's stack and colours beyond a block's shared memory
    with pytest.raises(ValueError):
        walks.cycle_dfs_plan(60_000, 16, 1568, 8)
    # the removal pass: an edge word packs two item ids in 16 bits; at
    # least one neighbour slot; a window beyond a block's shared memory
    for shape in ((32768, 1568, 256, 24), (0, 1568, 256, 24),
                  (528, 1568, 256, 0), (528, 1568, -1, 24),
                  (528, 60_000, 256, 24), (20_000, 1568, 256, 24)):
        with pytest.raises(ValueError):
            walks.seq_removal_plan(*shape)
    assert walks.seq_removal_plan(10_000, 0, 0, 64).mode == "smem"


def test_path_cover_plan():
    # the device graph engine's compact state: NI 528, D2 24, EE 1,568
    pl = walks.path_cover_plan(528, 24, 1568, 512, 24)
    assert pl.mode == "smem"
    # queue 512 x 16, covered bits 49 words (208 bytes with the 16-byte
    # rounding), hops 24 x 4, slot words 528 x 24 x 8, deltas 528 x 4
    assert pl.smem == 512 * 16 + 208 + 96 + 528 * 24 * 8 + 528 * 4
    # the boundary follows the bytes: the most items that fit in shared
    # memory take it, one more does not
    NI = 528
    while walks.path_cover_smem(NI + 1, 24, 1568, 512, 24,
                                False) <= walks.SMEM_LIMIT:
        NI += 1
    assert walks.path_cover_plan(NI, 24, 1568, 512, 24).mode == "smem"
    glob = walks.path_cover_plan(NI + 1, 24, 1568, 512, 24)
    assert glob.mode == "global"
    assert glob.smem == walks.path_cover_smem(NI + 1, 24, 1568, 512, 24,
                                              True)
    with pytest.raises(ValueError):
        walks.path_cover_plan(528, 24, 1568, 16_000, 24)


@functools.cache
def _jax_almost_repeat():
    """The JAX `_is_almost_repeat_paths`, jitted as the JAX engine runs it
    (K and LP static), so that cases of one shape and K share a compile."""
    import jax

    import lancet_tpu.tpu.pipeline as jpl

    return jax.jit(jpl._is_almost_repeat_paths, static_argnums=(2, 4))


@pytest.mark.parametrize("name", sorted(REPEAT))
def test_almost_repeat_case_equals_jax(name):
    import jax.numpy as jnp

    c = REPEAT[name]
    LP = c["seq"].shape[2]
    want = np.asarray(_jax_almost_repeat()(
        jnp.asarray(c["seq"]), jnp.asarray(c["lens"]), c["K"],
        jnp.int32(c["mm"]), LP))
    got = walkcases.run_almost_repeat(c).numpy()
    assert np.array_equal(want, got), (want, got)
    assert np.array_equal(got, c["expect"]), got


@pytest.mark.parametrize("LP,K,plan", [
    (1728, 11, (8, 512, 64)),   # the engine's strings at its first k
    (1728, 63, (8, 512, 128)),  # its last k: a window spans two words
    (512, 32, (1, 512, 64)),    # the last K whose windows fit two words
    (513, 33, (8, 512, 128)),
    (40, 0, (1, 512, 64)),
])
def test_almost_repeat_plan(LP, K, plan):
    pl = walks.almost_repeat_plan(LP, K)
    assert (pl.blocks, pl.threads, pl.tile) == plan
    # the string and the 99 bytes a tile may read past it, zeroed
    assert pl.smem == walks.almost_repeat_smem(LP) >= LP + 99
    assert pl.smem % 16 == 0 and pl.smem <= walks.SMEM_LIMIT


def test_almost_repeat_plan_refuses_what_the_kernel_does_not_take():
    # a window's K+1 mismatch bits fill at most two 32-bit words; the
    # string and its pad must fit in a block's shared memory
    for K in (-1, 64):
        with pytest.raises(ValueError):
            walks.almost_repeat_plan(1728, K)
    with pytest.raises(ValueError):
        walks.almost_repeat_plan(walks.SMEM_LIMIT, 11)
    with pytest.raises(ValueError):
        walks.almost_repeat_plan(0, 11)


# ---------------------------------------------------------------------------
# the removal pass (K2)
# ---------------------------------------------------------------------------

def _jax_removal_cond(c):
    """The JAX cleanup's condition function for a removal case."""
    import jax.numpy as jnp

    def take(a, items):
        return jnp.take_along_axis(jnp.asarray(a), items[:, None], 1)[:, 0]

    merlen, max_len = c["st"]["merlen"], c["max_len"]
    if c["mode"] == "tips":
        return lambda items, deg: (deg <= 1) & (take(merlen, items)
                                                < max_len)
    return lambda items, deg: ((deg >= 2) & (take(merlen, items) < max_len)
                               & (take(c["mincov"], items)
                                  <= jnp.asarray(c["thr"]))
                               & ~take(c["guard"], items))


@pytest.mark.parametrize("name", sorted(REMOVAL))
def test_removal_case_equals_jax(name):
    """seq_removal_pass_plain and the port's _seq_removal_pass (on the CPU,
    through the K2 wrapper) against the JAX _seq_removal_pass, bit for
    bit (tolerance 0): alive, e_alive, removed_any and over; every other
    state key passed through; and the items removed by hand."""
    import jax.numpy as jnp

    import lancet_tpu.tpu.stages as jstages
    from lancet_tpu_torch.gpu import stages

    c = REMOVAL[name]
    jst, jany, jover = jstages._seq_removal_pass(
        {k: jnp.asarray(v) for k, v in c["st"].items()},
        _jax_removal_cond(c), c["U"], c["D2"])
    want = (np.asarray(jst["alive"]), np.asarray(jst["e_alive"]),
            np.asarray(jany), np.asarray(jover))
    st = {k: torch.from_numpy(v.copy()) for k, v in c["st"].items()}
    pst, pany, pover = stages.seq_removal_pass_plain(
        st, walkcases.removal_cond(c), c["U"], c["D2"])
    plain = (pst["alive"], pst["e_alive"], pany, pover)
    for got in (plain, walkcases.run_removal(c)):
        for w, g in zip(want, got):
            assert np.array_equal(w, g.numpy())
    for k in ("rank", "merlen", "e_src", "e_dst", "special"):
        assert pst[k] is st[k]
    removed = [sorted(np.flatnonzero(c["st"]["alive"][w]
                                     & ~want[0][w]).tolist())
               for w in range(want[0].shape[0])]
    if "expect_removed" in c:
        assert removed == [sorted(r) for r in c["expect_removed"]]
    if "expect_over" in c:
        assert want[3].tolist() == c["expect_over"]
    assert want[2].tolist() == [bool(r) for r in removed]


_DEAD_EDGE = 0xFFFFFFFF


def removal_replay(c, seed=0):
    """csrc/walks.cu K2, window by window, in numpy: the staged flags (bit
    0 alive, bit 1 removed, bit 2 the static test), degrees, first and
    last alive edges and edge words (the atomics in a shuffled order), the
    live keys appended in a shuffled order, each live item's slot as the
    count of keys below its own, the slot entries (-1 where the static
    test fails), the one-warp sweep 32 slots at a time
    with each kill's scan of its edge words 32 at a time (the first D2 of
    its own by ballot and popc), then the removal. Returns (alive,
    e_alive, removed_any, over) as numpy."""
    rng = np.random.default_rng(seed)
    st = c["st"]
    W, NI = st["alive"].shape
    EE = st["e_src"].shape[1]
    U, D2, tips = c["U"], c["D2"], c["mode"] == "tips"
    out = (np.zeros((W, NI), bool), np.zeros((W, EE), bool),
           np.zeros(W, bool), np.zeros(W, bool))
    for w in range(W):
        cand = st["merlen"][w] < c["max_len"]
        if not tips:
            cand &= (c["mincov"][w] <= c["thr"][w]) & ~c["guard"][w]
        flag = st["alive"][w] * (1 + 4 * cand)
        deg = np.zeros(NI, np.int64)
        first = np.full(NI, 2**31 - 1)
        last = np.full(NI, -1)
        live = [i for i in range(NI) if flag[i] and not st["special"][w, i]]
        keys = [int(st["rank"][w, i]) * 65536 + i
                for i in rng.permutation(live)]
        ew = np.full(EE, _DEAD_EDGE, np.int64)
        for e in rng.permutation(EE):
            if st["e_alive"][w, e]:
                s = int(np.clip(st["e_src"][w, e], 0, NI - 1))
                d = int(np.clip(st["e_dst"][w, e], 0, NI - 1))
                deg[s] += 1
                first[s] = min(first[s], e)
                last[s] = max(last[s], e)
                ew[e] = s << 16 | d
        n = len(keys)
        ns = min(n, U)
        deg_over = bool((deg > D2).any())  # before the sweep lowers any
        slot = np.full(min(U, NI), -2)
        for kk in keys:
            pos = sum(k < kk for k in keys)
            if pos < ns:
                it = kk & 0xFFFF
                slot[pos] = it if flag[it] & 4 else -1
        assert (slot[:ns] != -2).all()  # the slots < ns are all written
        removed_any = False
        for b in range(0, ns, 32):
            for it in slot[b:b + 32]:
                if it < 0:
                    continue
                d = deg[it]
                if not (flag[it] & 3 == 1 and (d <= 1 if tips else d >= 2)):
                    continue
                taken, lo, hi = 0, first[it], last[it]
                while lo <= hi and taken < D2:
                    mine = [e for e in range(lo, min(lo + 32, hi + 1))
                            if ew[e] >> 16 == it]
                    for r, e in enumerate(mine):
                        nb = ew[e] & 0xFFFF
                        if taken + r < D2 and nb != it and not flag[nb] & 2:
                            deg[nb] -= 1
                    taken += len(mine)
                    lo += 32
                flag[it] |= 2
                removed_any = True
        out[0][w] = flag & 3 == 1
        out[1][w] = [v != _DEAD_EDGE and not flag[v >> 16] & 2
                     and not flag[v & 0xFFFF] & 2 for v in ew]
        out[2][w] = removed_any
        out[3][w] = n > U or deg_over
    return out


def _random_removal_case(seed, mode):
    """A seeded random state as tests/test_torch_graphwalks.py's
    test_seq_removal_plain_equals_jax builds it: W 4, NI 48, EE 160, U 32,
    D2 6, rising edge and item densities, the last four items anchors."""
    rng = np.random.default_rng(seed)
    W, NI, EE = 4, 48, 160
    st = dict(alive=rng.random((W, NI)) < np.array(
        [0.5, 0.6, 0.95, 0.95])[:, None],
              special=np.zeros((W, NI), bool),
              rank=np.stack([rng.permutation(NI) for _ in range(W)]),
              merlen=rng.integers(1, 9, (W, NI)),
              e_src=rng.integers(0, NI - 4, (W, EE)),
              e_dst=rng.integers(0, NI - 4, (W, EE)),
              e_alive=rng.random((W, EE)) < np.array(
                  [0.2, 0.35, 0.5, 0.9])[:, None])
    st["special"][:, NI - 4:] = True
    return dict(st=st, mode=mode, max_len=6,
                mincov=rng.integers(0, 6, (W, NI)),
                thr=np.array([2, 3, 4, 5]),
                guard=rng.random((W, NI)) < 0.2, U=32, D2=6)


@pytest.mark.parametrize("name", sorted(REMOVAL) + [
    f"random_{m}_{s}" for m in ("tips", "links") for s in (11, 12, 13)])
def test_removal_replay_equals_plain(name):
    """The K2 kernel's own steps (removal_replay) give
    seq_removal_pass_plain's outputs bit for bit, whatever the order of
    its atomics."""
    from lancet_tpu_torch.gpu import stages

    if name.startswith("random_"):
        _, mode, seed = name.split("_")
        c = _random_removal_case(int(seed), mode)
    else:
        c = REMOVAL[name]
    st = {k: torch.from_numpy(np.asarray(v).copy())
          for k, v in c["st"].items()}
    pst, pany, pover = stages.seq_removal_pass_plain(
        st, walkcases.removal_cond(c), c["U"], c["D2"])
    want = (pst["alive"], pst["e_alive"], pany, pover)
    for seed in (0, 1):
        got = removal_replay(c, seed)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())


def test_seq_removal_plan():
    # the engine's cleanup shape: NI 528, EE 1,568, U 256
    pl = walks.seq_removal_plan(528, 1568, 256, 24)
    # counters 16, keys 528 x 8, edge words 1,568 x 4, degree / first /
    # last 528 x 12, slots 256 x 2, flags 528 (rounded up to 16): under 48
    # KB, so a launch sets no attribute
    assert pl.smem == 16 + 4224 + 6272 + 6336 + 512 + 528 == 17888
    assert pl.smem == walks.seq_removal_smem(528, 1568, 256)
    # slots past NI take no room; D2 takes none
    assert (walks.seq_removal_smem(528, 1568, 10**6)
            == walks.seq_removal_smem(528, 1568, 528))
    assert walks.seq_removal_plan(528, 1568, 256, 64) == pl
    # the boundary follows the bytes: the most edges that fit, then one
    # more, at the engine's items
    EE = 1568
    while walks.seq_removal_smem(528, EE + 4, 256) <= walks.SMEM_LIMIT:
        EE += 4
    assert walks.seq_removal_plan(528, EE, 256, 24).smem <= walks.SMEM_LIMIT
    with pytest.raises(ValueError):
        walks.seq_removal_plan(528, EE + 4, 256, 24)


def test_removal_inputs_copy_nothing():
    """The K2 wrapper hands the engine's state to the kernel as it is: its
    tensors, already bool and int64, pass with no aten op (no conversion
    and no copy); other dtypes are converted."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    c = REMOVAL["links_guard"]
    st = {k: torch.from_numpy(v.copy()) for k, v in c["st"].items()}
    cond = walkcases.removal_cond(c)
    with Count():
        ins, extra = walks._removal_inputs(st, cond)
    assert Count.n == 0
    assert all(a is b for a, b in zip(ins, (
        st["alive"], st["special"], st["rank"], cond[1], st["e_src"],
        st["e_dst"], st["e_alive"])))
    assert all(a is b for a, b in zip(extra, cond[3:]))
    st["rank"] = st["rank"].to(torch.int32)
    ins, _ = walks._removal_inputs(st, ("tips",) + cond[1:3])
    assert ins[2].dtype == torch.int64
