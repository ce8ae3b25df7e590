"""The port's Gotoh fill and traceback against the JAX package's.

The plain PyTorch versions (`gpu.gotoh.dp_fill_plain`, `traceback_plain`)
must equal the JAX lax.scan fill `_dp_fill`, the Pallas kernel
`pallas_dp_fill` (interpret mode), and the on-device traceback of
`_dp_and_traceback`, bit for bit on every cell the traceback can read; the
port's `batch_align(device="cpu")` must equal the JAX `batch_align` and the
oracle `global_align_aff`. `gotoh.plan` must pick the shared-memory mode
exactly where the codes fit. The `cuda` test holds the fused kernel
`gotoh_align`, in both modes, against the plain versions on a card and
skips without one.

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
