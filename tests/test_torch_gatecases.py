"""The crafted repeat-gate cases of `gpu/gatecases.py` against the JAX
package.

On every case (repeats at the kernel's tile edges, at the end of a tile's
halo and at both region ends of a shift; mismatch budgets -1 to 40; k
lists with 0, 64, 101, duplicates and unsorted, and widest windows that
take each count of mismatch words and the plain scan; window lengths 0 to
~9,000), `gpu.repeats.gates_plain` must equal the JAX package's gates bit
for bit in both the gates and the exact rows (tolerance 0). The JAX side
is `lancet_tpu.tpu.repeats.gates_impl`, jitted as `repeat_gates` jits it,
on the case's own [W, L] batch: `repeat_gates` only pads the batch to W
256 and L a multiple of 128 with rows of length 0 (never gated) and
masked columns, which would make the ~9,000-base case take hours on the
CPU. The `cuda` test holds the kernel against `gates_plain` on every case
and skips without a card:
    pytest --noconftest -m cuda tests/test_torch_gatecases.py
"""

import numpy as np
import pytest
import torch

from lancet_tpu_torch.gpu import gatecases, repeats

torch.set_num_threads(1)  # see tests/test_torch_repeats.py

CASES = gatecases.gate_cases()


def _jax(c):
    import jax.numpy as jnp

    from lancet_tpu.tpu.repeats import _gates

    seq, lens = repeats.pack(c["windows"])
    g, e = _gates(jnp.asarray(seq), jnp.asarray(lens), tuple(c["ks"]),
                  c["mm"])
    return np.asarray(g), np.asarray(e)


@pytest.mark.parametrize("name", sorted(CASES))
def test_crafted_case_plain_equals_jax(name):
    c = CASES[name]
    jg, je = _jax(c)
    pg, pe = gatecases.run_case(c)
    assert pg.shape == (len(c["windows"]), len(c["ks"]))
    np.testing.assert_array_equal(pg.numpy(), jg)
    np.testing.assert_array_equal(pe.numpy(), je)


def test_crafted_cases_cover_the_contract():
    lengths = {len(w) for c in CASES.values() for w in c["windows"]}
    assert {0, 1, 2, 63, 64, 65, 600}.issubset(lengths)
    assert max(lengths) >= 8999
    assert {c["mm"] for c in CASES.values()}.issuperset(
        gatecases.MISMATCHES)
    ks = [c["ks"] for c in CASES.values()]
    assert any(0 in k and 64 in k and 101 in k for k in ks)
    assert any(len(set(k)) < len(k) for k in ks)
    assert any(k != sorted(k) for k in ks)
    # every count of words a thread holds, and the plain scan
    plans = {repeats.gates_plan(len(c["windows"]),
                                max(map(len, c["windows"])), c["ks"],
                                c["mm"]).words for c in CASES.values()}
    assert plans == {0, 2, 3, 4, 5}


@pytest.mark.cuda
def test_kernel_matches_plain_on_crafted_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for name, c in CASES.items():
        g, e = gatecases.run_case(c, dev)
        torch.cuda.synchronize()
        pg, pe = gatecases.run_case(c)
        assert torch.equal(g.cpu(), pg), name
        assert torch.equal(e.cpu(), pe), name
