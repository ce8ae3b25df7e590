"""The port's Gotoh fill and traceback against the JAX package's.

The plain PyTorch versions (`gpu.gotoh.dp_fill_plain`, `traceback_plain`)
must equal the JAX lax.scan fill `_dp_fill`, the Pallas kernel
`pallas_dp_fill` (interpret mode), and the on-device traceback of
`_dp_and_traceback`, bit for bit on every cell the traceback can read; the
port's `batch_align(device="cpu")` must equal the JAX `batch_align` and the
oracle `global_align_aff`. `gotoh.plan` must pick the shared-memory mode
exactly where the codes fit, keep its plans for N <= 8,192, and plan the
strip mode beyond (S of 8,193 bases aligned by the port equal to the JAX
package's alignment). The `cuda` tests hold the fused kernel `gotoh_align`,
in all three modes, against the plain versions on a card and skip without
one.

The JAX side is imported inside the tests that use it, so the `cuda` test
also runs where JAX is not installed:
    pytest --noconftest -m cuda tests/test_torch_align.py
"""

import random

import numpy as np
import pytest
import torch

from lancet_tpu_torch.gpu import align_batch as tab
from lancet_tpu_torch.gpu import gotoh

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)


def _random_pairs(rng, n_pairs, edits=True):
    """The pair sets of tests/test_tpu_align.py."""
    pairs = []
    for _ in range(n_pairs):
        n = rng.randint(30, 250)
        S = "".join(rng.choice("ACGT") for _ in range(n))
        if edits:
            T = list(S)
            for _ in range(rng.randint(1, 5)):
                op = rng.choice("sid")
                p = rng.randint(5, len(T) - 5)
                if op == "s":
                    T[p] = rng.choice("ACGT")
                elif op == "i":
                    T.insert(p, rng.choice("ACGT"))
                else:
                    del T[p]
            T = "".join(T)
        else:
            T = "".join(rng.choice("ACGT") for _ in range(rng.randint(30, 250)))
        pairs.append((S, T))
    return pairs


PAIR_SETS = {
    "edit_seed7": lambda: _random_pairs(random.Random(7), 24, edits=True),
    "divergent_seed8": lambda: _random_pairs(random.Random(8), 12,
                                             edits=False),
    "mixed_lengths": lambda: [("ACGT", "ACGT"),
                              ("A" * 200, "A" * 190 + "C" * 10),
                              ("ACGTACGTAC", "ACG")],
    "length_one": lambda: [("A", "A"), ("A", "C"), ("A", "CA"), ("CA", "A"),
                           ("G", "ACGTT"), ("ACGTT", "T"), ("C", "C")],
    # where the tie rules and the forced gaps decide the ops: homopolymer
    # runs of unequal length, tandem repeats shifted by one unit, identical
    # strings, and pairs whose best alignment is all gaps
    "repeats_ties": lambda: [("A" * 10, "A" * 7), ("CCCCCGGGG", "CCCGGGGGGG"),
                             ("T" * 20, "T" * 23), ("G" * 3, "G" * 12),
                             ("AC" * 6, "CA" * 6),
                             ("ACG" * 5, "CGA" * 5),
                             ("AGTT" * 4 + "C", "GTTA" * 4 + "C"),
                             ("ACGTTGCA", "ACGTTGCA"),
                             ("GATTACA" * 5, "GATTACA" * 5),
                             ("A" * 20, "C" * 20), ("A" * 25, "C" * 30)],
}


def _tensors(pairs):
    S, T, n_len, m_len, N, M = tab._pack(pairs)
    return (S, T, n_len, m_len, N, M,
            tuple(torch.from_numpy(a) for a in (S, T, n_len, m_len)))


def _interior(n_len, m_len, N, M):
    """Mask [D, P, N+1] of the cells the traceback can read:
    1 <= i <= n and 1 <= j <= m of each pair."""
    i = np.arange(N + 1)[None, None, :]
    j = np.arange(2, N + M + 1)[:, None, None] - i
    return ((i >= 1) & (i <= n_len[None, :, None]) & (j >= 1)
            & (j <= m_len[None, :, None]))


@pytest.mark.parametrize("name", sorted(PAIR_SETS))
def test_fill_plain_matches_jax_scan_fill(name):
    import jax.numpy as jnp

    from lancet_tpu.tpu import align_batch as jab

    S, T, n_len, m_len, N, M, ts = _tensors(PAIR_SETS[name]())
    want = np.asarray(jab._dp_fill(jnp.asarray(S), jnp.asarray(T),
                                   jnp.asarray(n_len), jnp.asarray(m_len),
                                   N, M))
    got = gotoh.dp_fill_plain(*ts, N, M).numpy()
    assert got.shape == want.shape == (N + M - 1, len(n_len), N + 1)
    mask = _interior(n_len, m_len, N, M)
    assert np.array_equal(got[mask], want[mask])


def test_fill_plain_matches_pallas_interpret():
    import jax.numpy as jnp

    from lancet_tpu.tpu.pallas_gotoh import PB, make_tr2, pallas_dp_fill

    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(PB):
        s = "".join(rng.choice(list("ACGT"), int(rng.integers(5, 60))))
        t = list(s)
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, len(t)))
            t[p] = rng.choice(list("ACGT"))
        if rng.random() < 0.3:
            t = list(rng.choice(list("ACGT"), int(rng.integers(5, 60))))
        pairs.append((s, "".join(t)))
    N = M = 64
    P = len(pairs)
    S = np.zeros((P, N + 1), np.uint8)
    T = np.zeros((P, M + 1), np.uint8)
    for p, (s, t) in enumerate(pairs):
        S[p, 1 : len(s) + 1] = np.frombuffer(s.encode(), np.uint8)
        T[p, 1 : len(t) + 1] = np.frombuffer(t.encode(), np.uint8)
    n_len = np.array([len(s) for s, _ in pairs], np.int32)
    m_len = np.array([len(t) for _, t in pairs], np.int32)
    want = np.asarray(pallas_dp_fill(jnp.asarray(S),
                                     make_tr2(jnp.asarray(T), N, M), N, M,
                                     interpret=True))[:, :, : N + 1]
    got = gotoh.dp_fill_plain(*(torch.from_numpy(a) for a in
                                (S, T, n_len, m_len)), N, M).numpy()
    mask = _interior(n_len, m_len, N, M)
    assert np.array_equal(got[mask], want[mask])


@pytest.mark.parametrize("name", sorted(PAIR_SETS))
def test_traceback_plain_matches_jax(name):
    import jax.numpy as jnp

    from lancet_tpu.tpu import align_batch as jab

    S, T, n_len, m_len, N, M, ts = _tensors(PAIR_SETS[name]())
    ops_j, cnt_j = jab._dp_and_traceback(
        jnp.asarray(S), jnp.asarray(T), jnp.asarray(n_len),
        jnp.asarray(m_len), N, M, False)
    tbs = gotoh.dp_fill_plain(*ts, N, M)
    ops, cnt = gotoh.traceback_plain(tbs, ts[2], ts[3], N, M)
    assert ops.dtype == torch.uint8 and cnt.dtype == torch.int32
    assert np.array_equal(ops.numpy(), np.asarray(ops_j))
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_j))


@pytest.mark.parametrize("name", sorted(PAIR_SETS))
def test_batch_align_cpu_matches_jax_and_oracle(name):
    from lancet_tpu.engine.align import global_align_aff
    from lancet_tpu.tpu.align_batch import batch_align as jax_batch_align

    pairs = PAIR_SETS[name]()
    before = dict(gotoh.LAUNCHES)
    got = tab.batch_align(pairs, device="cpu")
    assert gotoh.LAUNCHES == before  # CPU tensors take the plain versions
    assert got == jax_batch_align(pairs)
    assert got == [global_align_aff(s, t) for s, t in pairs]


def test_batch_align_empty_strings():
    from lancet_tpu.engine.align import global_align_aff

    pairs = [("", "ACG"), ("ACG", ""), ("", "A"), ("AC", "AC")]
    got = tab.batch_align(pairs, device="cpu")
    assert got == [global_align_aff(s, t) for s, t in pairs]


def test_plan_picks_mode_by_bytes():
    pl = gotoh.plan(585, 591)  # the main path's widest DP group
    assert pl.mode == "smem" and pl.smem <= gotoh.SMEM_LIMIT
    assert pl.threads % 32 == 0 and pl.threads * pl.rows_per_thread >= 585
    big = gotoh.plan(1100, 1100)  # a larger --window-size
    assert big.mode == "global"
    assert gotoh.smem_bytes(1100, 1100, big.rows_per_thread, big.threads,
                            False) > gotoh.SMEM_LIMIT
    assert big.smem == gotoh.smem_bytes(1100, 1100, big.rows_per_thread,
                                        big.threads, True)
    # the boundary follows the byte count: the widest M whose codes fit at
    # N = 585 takes shared memory, one column more does not
    M = 591
    while gotoh.smem_bytes(585, M + 1, pl.rows_per_thread, pl.threads,
                           False) <= gotoh.SMEM_LIMIT:
        M += 1
    assert gotoh.plan(585, M).mode == "smem"
    assert gotoh.plan(585, M + 1).mode == "global"
    # a 4-bit code per cell: 585 rows of ceil(591 / 8) words
    assert pl.smem >= 585 * 74 * 4


# plans of the N <= 8,192 the main path uses (its DP groups span 569-591
# bp) and of the global mode, as they were before the strip mode
PINNED_PLANS = {(569, 591): ("smem", 5, 128, 173568),
                (585, 591): ("smem", 5, 128, 178032),
                (591, 591): ("smem", 5, 128, 180992),
                (1100, 1100): ("global", 10, 128, 6400),
                (8192, 600): ("global", 32, 256, 16592)}


def test_plan_strips_beyond_one_block():
    for (N, M), want in PINNED_PLANS.items():
        assert tuple(gotoh.plan(N, M)) == want, (N, M)
    for N in (8_193, 20_000):
        for M in (1, 50, 591):
            pl = gotoh.plan(N, M)
            assert pl == ("strips", 32, 256, gotoh.strip_smem_bytes())
            assert pl.smem <= gotoh.SMEM_LIMIT
    assert gotoh.plan(gotoh.STRIP_ROWS, 50).mode == "global"
    # a global-mode block whose staged T and ops overflow shared memory
    M = 8192
    while gotoh.smem_bytes(300, M, 4, 96, True) <= gotoh.SMEM_LIMIT:
        M += 8192
    assert gotoh.plan(300, M).mode == "strips"
    # every pair's codes, then one (M, X) row of M+1 entries a pair
    assert (gotoh.strip_scratch_words(3, 20_000, 50)
            == 3 * 20_000 * 7 + 2 * 3 * 51)


def test_long_reference_equals_jax():
    """One S of 8,193 bases (beyond a block's rows: the strip mode on a
    card) against T of 1 and 50 bases: the port's batch_align on the CPU
    equals the JAX package's."""
    from lancet_tpu.tpu import align_batch as jab

    rng = random.Random(81)
    s = "".join(rng.choice("ACGT") for _ in range(8_193))
    pairs = [(s, "".join(rng.choice("ACGT") for _ in range(m)))
             for m in (1, 50)]
    assert gotoh.plan(8_193, 50).mode == "strips"
    got = tab.batch_align(pairs, device="cpu")
    assert got == jab.batch_align(pairs)
    assert all(a.replace("-", "") == s for a, _ in got)


def _padded(pairs, N, M):
    """The batch of `pairs` padded to widths N, M (padding never changes a
    result), as tensors."""
    S, T, n_len, m_len, N0, M0 = tab._pack(pairs)
    S = np.pad(S, ((0, 0), (0, N - N0)))
    T = np.pad(T, ((0, 0), (0, M - M0)))
    return tuple(torch.from_numpy(a) for a in (S, T, n_len, m_len))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    rng = random.Random(5)
    large = []  # related pairs of 900-1,100 bp
    for _ in range(6):
        s = "".join(rng.choice("ACGT") for _ in range(rng.randint(900, 1100)))
        t = list(s)
        for _ in range(rng.randint(1, 12)):
            p = rng.randint(0, len(t) - 1)
            t[p] = rng.choice("ACGT") if rng.random() < 0.5 else ""
        large.append((s, "".join(t)))
    pairs = (PAIR_SETS["repeats_ties"]() + PAIR_SETS["length_one"]()
             + PAIR_SETS["edit_seed7"]() + PAIR_SETS["divergent_seed8"]()
             + [("", "ACGT"), ("ACGT", ""), ("", "")] + large)
    small = [pr for pr in pairs if max(map(len, pr)) <= 250]
    for group, N, M, mode in ((small, 250, 250, "smem"),
                              (pairs, 1100, 1100, "global")):
        assert gotoh.plan(N, M).mode == mode
        S, T, n_len, m_len = (a.to(dev) for a in _padded(group, N, M))
        before = gotoh.LAUNCHES["gotoh_align_" + mode]
        ops, cnt = gotoh.align(S, T, n_len, m_len, N, M)
        torch.cuda.synchronize()
        assert gotoh.LAUNCHES["gotoh_align_" + mode] == before + 1
        tb_p = gotoh.dp_fill_plain(S, T, n_len, m_len, N, M)
        ops_p, cnt_p = gotoh.traceback_plain(tb_p, n_len, m_len, N, M)
        assert torch.equal(ops, ops_p), mode
        assert torch.equal(cnt, cnt_p), mode
    assert (tab.batch_align(pairs, device="cuda")
            == tab.batch_align(pairs, device="cpu"))


def _long_pairs():
    """Pairs whose S exceeds a block's 8,192 rows: random S of 8,193 and
    20,000 bases against short random T, and S of 9,000 and 16,500 bases
    against edited copies (the path crosses the strips' edges)."""
    rng = random.Random(6)
    pairs = []
    for n, m in ((8_193, 1), (8_193, 50), (20_000, 7), (20_000, 50)):
        pairs.append(("".join(rng.choice("ACGT") for _ in range(n)),
                      "".join(rng.choice("ACGT") for _ in range(m))))
    for n in (9_000, 16_500):
        s = "".join(rng.choice("ACGT") for _ in range(n))
        t = list(s)
        for _ in range(20):
            p = rng.randrange(len(t))
            t[p] = rng.choice("ACGT") if rng.random() < 0.5 else ""
        pairs.append((s, "".join(t)))
    return pairs


@pytest.mark.cuda
def test_strips_match_plain_on_card():
    """The strip mode on the card equals traceback_plain there, for S of
    8,193 and 20,000 bases, in one batch and each S alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    pairs = _long_pairs()
    groups = [pairs[:2], pairs[2:4], pairs]
    for group in groups:
        S, T, n_len, m_len, N, M = tab._pack(group)
        assert gotoh.plan(N, M).mode == "strips"
        S, T, n_len, m_len = (torch.from_numpy(a).to(dev)
                              for a in (S, T, n_len, m_len))
        before = gotoh.LAUNCHES["gotoh_align_strips"]
        ops, cnt = gotoh.align(S, T, n_len, m_len, N, M)
        torch.cuda.synchronize()
        assert gotoh.LAUNCHES["gotoh_align_strips"] == before + 1
        tb_p = gotoh.dp_fill_plain(S, T, n_len, m_len, N, M)
        ops_p, cnt_p = gotoh.traceback_plain(tb_p, n_len, m_len, N, M)
        del tb_p
        assert torch.equal(ops, ops_p), N
        assert torch.equal(cnt, cnt_p), N
