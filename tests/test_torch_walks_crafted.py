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
  `walks.almost_repeat_plan`.

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
