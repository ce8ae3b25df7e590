"""The port's repeat gates against the JAX package's.

`gpu.repeats.gates_plain` and the port's `repeat_gates(device="cpu")` must
equal `lancet_tpu.tpu.repeats.repeat_gates` (JAX on the CPU) bit for bit,
in both the gates and the exact rows, on seeded adversarial windows
(`corpus.repeat_windows`: lengths 0-600, random sequence and tandem
repeats with substitutions and N), for max_mismatch 0-3, the default ks
and a list with even and non-consecutive k. The `cuda` test holds the
kernel `repeat_gates` of csrc/repeats.cu against `gates_plain` on a card
and skips without one.

The JAX side is imported inside the tests that use it, so the `cuda` test
also runs where JAX is not installed:
    pytest --noconftest -m cuda tests/test_torch_repeats.py
"""

import numpy as np
import pytest
import torch

from lancet_tpu_torch import corpus
from lancet_tpu_torch.gpu import repeats

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

DEFAULT_KS = list(range(11, 102, 2))  # Config min_k..max_k, step 2
ODD_KS = [31, 4, 6, 7, 12, 10, 64, 0]  # even, non-consecutive, unsorted


def _jax_gates(windows, ks, mm):
    from lancet_tpu.tpu.repeats import repeat_gates

    return repeat_gates(windows, ks, mm, with_exact=True)


def _plain(windows, ks, mm):
    seq, lens = repeats.pack(windows)
    g, e = repeats.gates_plain(torch.from_numpy(seq), torch.from_numpy(lens),
                               tuple(ks), mm)
    return g.numpy(), e.numpy()


@pytest.mark.parametrize("ks,mm", [(DEFAULT_KS, 0), (DEFAULT_KS, 1),
                                   (DEFAULT_KS, 2), (DEFAULT_KS, 3),
                                   (ODD_KS, 2)])
def test_gates_equal_jax(ks, mm):
    windows = corpus.repeat_windows()
    jg, je = _jax_gates(windows, ks, mm)
    pg, pe = _plain(windows, ks, mm)
    cg, ce = repeats.repeat_gates(windows, ks, mm, with_exact=True,
                                  device="cpu")
    assert pg.dtype == cg.dtype == np.bool_ and pg.shape == jg.shape
    np.testing.assert_array_equal(pg, jg)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(cg, jg)
    np.testing.assert_array_equal(ce, je)
    # the set exercises both verdicts: exact repeats, and with a mismatch
    # budget near repeats that are not exact
    assert je.any() and not jg.all()
    assert (jg & ~je).any() == (mm > 0)


def test_gates_edges():
    ks = [0, 1, 2, 11]
    g, e = repeats.repeat_gates(["", "A", "AA", "AAA", "ACGT"], ks, 2,
                                with_exact=True, device="cpu")
    assert not g[0].any() and not e[0].any()  # length 0: never gated
    assert not g[1].any()
    jg, je = _jax_gates(["", "A", "AA", "AAA", "ACGT"], ks, 2)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(e, je)
    empty = repeats.repeat_gates([], ks, 2, device="cpu")
    assert empty.shape == (0, 4)
    with pytest.raises(ValueError, match=">= 0"):
        repeats.repeat_gates(["ACGT"], [-1], 2, device="cpu")


def test_plan_threads_balances_pairs():
    assert repeats.plan_threads(600) == 160  # 300 pairs in 2 rounds
    for L in (1, 2, 12, 64, 599, 600, 1100, 5000):
        t = repeats.plan_threads(L)
        assert t % 32 == 0 and 32 <= t <= repeats.MAX_THREADS
        rounds = -(-max(1, L // 2) // t)
        assert rounds == -(-max(1, L // 2) // repeats.MAX_THREADS)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    windows = corpus.repeat_windows() + ["", "A", "AA", "ACGT"]
    seq, lens = repeats.pack(windows)
    seq_d = torch.from_numpy(seq).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    for ks in (DEFAULT_KS, ODD_KS):
        for mm in (-1, 0, 1, 2, 3, 7, 8, 40):
            before = repeats.LAUNCHES["repeat_gates"]
            g, e = repeats.gates(seq_d, lens_d, ks, mm)
            torch.cuda.synchronize()
            assert repeats.LAUNCHES["repeat_gates"] == before + 1
            pg, pe = repeats.gates_plain(seq_d, lens_d, tuple(ks), mm)
            assert torch.equal(g, pg), (ks, mm)
            assert torch.equal(e, pe), (ks, mm)
