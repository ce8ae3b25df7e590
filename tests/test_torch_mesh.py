"""The port's mesh (lancet_tpu_torch.parallel.mesh) against the JAX
package's, on the CPU.

A mesh of repeated "cpu" entries stands in for the JAX tests' 8 virtual
CPU devices (tests/conftest.py): each entry is one shard, run in a host
thread of its own. The sharded DP must give the alignments of the JAX
`mesh_batch_align_async` and of the unsharded `batch_align`; a sharded
step must give the unsharded outputs and the summed counters; and
`runner.run` under a mesh, on the native path, the device graph path and
with LANCET_TPU_GATES=1, must give the JAX runner's VCF byte for byte.
Every kernel wrapper refuses inputs that lie on two devices. The `cuda`
tests skip without a card; they import nothing of JAX, so they also run
where JAX is not installed (their cross-device checks need two cards):
    pytest --noconftest -m cuda tests/test_torch_mesh.py
"""

import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_align import PAIR_SETS  # noqa: E402

from lancet_tpu_torch import runner as trunner  # noqa: E402
from lancet_tpu_torch.config import Config  # noqa: E402
from lancet_tpu_torch.engine import devicepipe  # noqa: E402
from lancet_tpu_torch.gpu import align_batch as tab  # noqa: E402
from lancet_tpu_torch.gpu import gotoh, repeats, walks  # noqa: E402
from lancet_tpu_torch.parallel import mesh as tmesh  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

ALL_PAIRS = [p for make in PAIR_SETS.values() for p in make()]


def _cpu_mesh(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_dp_equals_jax_and_unsharded(n):
    """The pair sets of test_torch_align.py (the tie pairs among them)
    split over n shards: the alignments equal the JAX mesh DP on n
    virtual devices and the unsharded batch_align. The port does not pad
    the pair axis; the JAX function pads 57 pairs to 64."""
    from lancet_tpu.parallel.mesh import make_mesh as jax_mesh
    from lancet_tpu.parallel.mesh import mesh_batch_align_async as jax_dp
    from lancet_tpu.tpu.align_batch import batch_align_wait as jax_wait

    state = tmesh.mesh_batch_align_async(ALL_PAIRS, _cpu_mesh(n))
    assert len(state) == n  # one dispatch a non-empty shard
    got = tab.batch_align_wait(state)
    assert got == tab.batch_align(ALL_PAIRS, "cpu")
    assert got == jax_wait(jax_dp(ALL_PAIRS, jax_mesh(n)))
    # fewer pairs than shards: the empty shards dispatch nothing
    few = ALL_PAIRS[:3]
    state = tmesh.mesh_batch_align_async(few, _cpu_mesh(n))
    assert len(state) == min(n, 3)
    assert tab.batch_align_wait(state) == tab.batch_align(few, "cpu")
    assert tmesh.mesh_batch_align_async([], _cpu_mesh(n)) is None


def _toy_impl(x, y, w):
    """A batched step with a fixpoint loop that exits on its own shard's
    windows: halve every value >= 4 until none is left."""
    x = x.clone()
    steps = torch.zeros(x.shape[0], dtype=torch.int64)
    while bool((x >= 4).any()):
        hot = x >= 4
        x = torch.where(hot, x // 2, x)
        steps += hot.any(1)
    return {"x": x, "numcomp": steps, "n_sel": (y > 0).sum(1),
            "fallback": y[:, 0] < 0, "w": w * 2}


@pytest.mark.parametrize("n", [1, 2, 8])
def test_shard_windows_equals_unsharded(n):
    rng = np.random.default_rng(5)
    W = 16
    x = rng.integers(0, 1 << rng.integers(1, 20, size=(W, 1)), size=(W, 6))
    y = rng.integers(-3, 4, size=(W, 3))
    w = rng.integers(0, 9, size=(W,))
    want = _toy_impl(*(torch.from_numpy(a) for a in (x, y, w)))
    outs, counters = tmesh.shard_windows(_toy_impl, _cpu_mesh(n))(x, y, w)
    assert isinstance(outs, tmesh.Sharded) and len(outs) == n
    for k, v in want.items():
        got = tmesh.gather([o[k] for o in outs])
        assert np.array_equal(got, v.numpy()), k
    assert counters.dtype == torch.int32 and counters.shape == (3,)
    assert counters.tolist() == [int(want["numcomp"].sum()),
                                 int(want["n_sel"].sum()),
                                 int(want["fallback"].sum())]
    # a Sharded argument goes to its shards as it is
    xs = tmesh.Sharded(torch.from_numpy(p) for p in np.split(x, n))
    outs2, counters2 = tmesh.shard_windows(_toy_impl, _cpu_mesh(n))(
        xs, y, w)
    assert np.array_equal(tmesh.gather([o["x"] for o in outs2]),
                          want["x"].numpy())
    assert counters2.tolist() == counters.tolist()
    if n > 1:
        with pytest.raises(ValueError, match="equal shards"):
            tmesh.shard_windows(_toy_impl, _cpu_mesh(n))(
                x[:n + 1], y[:n + 1], w[:n + 1])
        with pytest.raises(ValueError, match="window axes differ"):
            tmesh.shard_windows(_toy_impl, _cpu_mesh(n))(x[:n], y, w)
    # a tensor is not cut: it comes already sharded, or not at all
    with pytest.raises(TypeError, match="Sharded"):
        tmesh.shard_windows(_toy_impl, _cpu_mesh(n))(torch.from_numpy(x),
                                                      y, w)


def test_shard_threads_stress():
    """More shard threads than cores, switching every microsecond: every
    shard's output lands in its slot and no launch count is lost."""
    from lancet_tpu_torch.gpu import count_launch

    table = {"k": 0}

    def impl(x):
        for _ in range(200):
            count_launch(table, "k")
        return {"x": x * 3, "numcomp": x[:, 0], "n_sel": x[:, 1],
                "fallback": x[:, 2] > 5}

    n = 4 * (os.cpu_count() or 2)
    x = np.arange(n * 2 * 3).reshape(n * 2, 3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs, counters = tmesh.shard_windows(impl, _cpu_mesh(n))(x)
    finally:
        sys.setswitchinterval(old)
    assert np.array_equal(tmesh.gather([o["x"] for o in outs]), x * 3)
    assert table["k"] == 200 * n
    assert counters.tolist() == [int(x[:, 0].sum()), int(x[:, 1].sum()),
                                 int((x[:, 2] > 5).sum())]


def test_make_mesh_arguments():
    m = tmesh.make_mesh(devices=["cpu", "cpu"])
    assert isinstance(m, tuple) and m == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=[])
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The mixed corpus of tests/test_shardrun.py and the JAX native
    runner's VCF and summary on it."""
    from test_shardrun import _mixed_corpus

    from lancet_tpu.config import Config as JaxConfig
    from lancet_tpu.runner import run as jax_run

    d = tmp_path_factory.mktemp("mesh")
    chrom_len = _mixed_corpus(d, seed=21, chrom_len=9000)
    jcfg = JaxConfig(tumor_bam=f"{d}/tumor.bam", normal_bam=f"{d}/normal.bam",
                     ref_fasta=f"{d}/ref.fa",
                     region=f"chr1:300-{chrom_len - 300}", num_threads=3)
    vcf, err = _captured(lambda: jax_run(jcfg, command_line="t",
                                         date="D\n", engine="tpu"))
    assert sum(1 for ln in vcf.splitlines() if not ln.startswith("#")) > 0
    return dataclasses.asdict(jcfg), vcf, err


def _captured(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn()
    return out, err.getvalue()


def _port(d, **kw):
    return _captured(lambda: trunner.run(
        Config.from_dict(d), command_line="t", date="D\n", device="cpu",
        **kw))


@pytest.mark.parametrize("n", [2, 8])
def test_runner_mesh_equals_jax(corpus, n, monkeypatch):
    d, want, want_err = corpus
    monkeypatch.delenv("LANCET_TPU_DEVGRAPH", raising=False)
    monkeypatch.delenv("LANCET_TPU_GATES", raising=False)
    calls = []
    real = tmesh.mesh_batch_align_async

    def spy(pairs, mesh):
        calls.append(len(mesh))
        return real(pairs, mesh)

    monkeypatch.setattr("lancet_tpu_torch.engine.shardrun."
                        "mesh_batch_align_async", spy)
    assert _port(d, mesh=_cpu_mesh(n)) == (want, want_err)
    assert calls and set(calls) == {n}


def test_devgraph_mesh_invariant(corpus, monkeypatch):
    """The device graph engine with its windows sharded over 8 and over 1
    entries, unsharded, and the native path: one VCF. The mesh counters
    equal the sums over the unsharded run's attempt outputs."""
    d, want, want_err = corpus
    monkeypatch.delenv("LANCET_TPU_GATES", raising=False)
    monkeypatch.setenv("LANCET_TPU_DEVGRAPH", "1")
    sums = {"numcomp": 0, "n_sel": 0, "fallback": 0}
    real = devicepipe._assemble

    def summed(*a, **k):
        out = real(*a, **k)
        for key in sums:
            sums[key] += int(out[key].to(torch.int64).sum())
        return out

    monkeypatch.setattr(devicepipe, "_assemble", summed)
    st: dict = {}
    assert _port(d, stats=st) == (want, want_err)
    monkeypatch.setattr(devicepipe, "_assemble", real)
    assert st["n_dev_windows"] > 0 and sums["numcomp"] > 0
    for n in (8, 1):
        st_n: dict = {}
        assert _port(d, mesh=_cpu_mesh(n), stats=st_n) == (want, want_err)
        assert st_n["mesh_counters"] == sums
        for key in ("n_dev_windows", "dev_fallback_causes", "k_histogram"):
            assert st_n[key] == st[key], key


def test_gates_switch_equals_jax(corpus, monkeypatch):
    """LANCET_TPU_GATES=1: the eager gate sweep feeds the native k-loop;
    the VCF is the JAX runner's under the same variable."""
    from lancet_tpu.config import Config as JaxConfig
    from lancet_tpu.config import Filters as JaxFilters
    from lancet_tpu.runner import run as jax_run

    d, _, _ = corpus
    monkeypatch.delenv("LANCET_TPU_DEVGRAPH", raising=False)
    monkeypatch.setenv("LANCET_TPU_GATES", "1")
    want = _captured(lambda: jax_run(
        JaxConfig(**dict(d, filters=JaxFilters(**d["filters"]))),
        command_line="t", date="D\n", engine="tpu"))
    calls = []
    real = repeats.repeat_gates

    def spy(windows, ks, *a, **k):
        calls.append((len(windows), len(ks), str(k["device"])))
        return real(windows, ks, *a, **k)

    monkeypatch.setattr(repeats, "repeat_gates", spy)
    st: dict = {}
    assert _port(d, stats=st) == want
    assert st["t_gates"] > 0
    assert calls and all(c[1] == 46 and c[2] == "cpu" for c in calls)


def _walk_inputs():
    """Small, well-formed inputs of the four walks."""
    W, NI, D2, EE, C = 2, 8, 4, 6, 2
    i32 = torch.int32
    adj = torch.full((W, NI, D2), -1, dtype=i32)
    e = torch.zeros((W, EE), dtype=i32)
    node = torch.zeros((W, NI), dtype=i32)
    flag = torch.zeros((W, NI), dtype=torch.bool)
    comp = torch.zeros((W, C), dtype=torch.bool)
    return dict(
        path_cover=lambda t: walks.path_cover(
            adj, t(e), e, node, flag, comp, torch.zeros(W, dtype=i32),
            torch.zeros((W, C), dtype=i32), K=11, N=NI - 2 * C, Cmax=C,
            dfs_limit=10, max_indel=5),
        seq_removal=lambda t: walks.seq_removal(
            dict(alive=flag, special=flag, rank=node.long(),
                 e_src=e.long(), e_dst=e.long(),
                 e_alive=t(torch.zeros((W, EE), dtype=torch.bool))),
            ("tips", node.long(), 5), NI, D2),
        almost_repeat=lambda t: walks.almost_repeat(
            torch.zeros((W, 2, 16), dtype=torch.uint8),
            t(torch.zeros((W, 2), dtype=i32)), 5, 2),
        cycle_dfs=lambda t: walks.cycle_dfs(
            adj, e, e, flag, t(flag), NI - 2 * C, C, comp),
        gotoh_align=lambda t: gotoh.align(
            torch.zeros((2, 5), dtype=torch.uint8),
            t(torch.zeros((2, 4), dtype=torch.uint8)),
            torch.zeros(2, dtype=i32), torch.zeros(2, dtype=i32), 4, 3),
        repeat_gates=lambda t: repeats.gates(
            torch.zeros((2, 8), dtype=torch.uint8),
            t(torch.zeros(2, dtype=i32)), (3, 5), 1),
    )


@pytest.mark.parametrize("name", ["gotoh_align", "repeat_gates",
                                  "path_cover", "seq_removal",
                                  "almost_repeat", "cycle_dfs"])
def test_wrappers_refuse_mixed_devices(name):
    """A kernel launches on its inputs' device, so a wrapper refuses,
    before any work, inputs that lie on two devices: here one input on
    the meta device beside CPU tensors. The same inputs all on the CPU
    run the plain version."""
    call = _walk_inputs()[name]
    call(lambda x: x)  # all on the CPU: runs

    def meta(x):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")

    with pytest.raises(ValueError, match="is on meta|lie on cpu and meta"):
        call(meta)


@pytest.mark.cuda
def test_card_mesh_dp_and_guard():
    """On a card: the DP split over four entries of cuda:0 equals the
    unsharded DP, one launch a shard; with two cards, kernels on cuda:1's
    tensors launch there while cuda:0 is current."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    want = tab.batch_align(ALL_PAIRS, "cpu")
    gotoh.reset_launches()
    got = tab.batch_align_wait(tmesh.mesh_batch_align_async(
        ALL_PAIRS, tmesh.make_mesh(devices=["cuda:0"] * 4)))
    assert got == want
    assert sum(gotoh.LAUNCHES.values()) == 4
    if torch.cuda.device_count() < 2:
        return
    seq, lens = repeats.pack([a + b for a, b in ALL_PAIRS])
    ks = (11, 13, 21, 31)
    plain = repeats.gates_plain(torch.from_numpy(seq),
                                torch.from_numpy(lens), ks, 2)
    with torch.cuda.device(0):
        assert tab.batch_align(ALL_PAIRS, "cuda:1") == want
        got = tab.batch_align_wait(tmesh.mesh_batch_align_async(
            ALL_PAIRS, tmesh.make_mesh(2)))
        g, e = repeats.gates(torch.from_numpy(seq).to("cuda:1"),
                             torch.from_numpy(lens).to("cuda:1"), ks, 2)
    assert got == want
    assert torch.equal(g.cpu(), plain[0]) and torch.equal(e.cpu(), plain[1])


@pytest.mark.cuda
def test_card_runs_over_meshes_and_cards(tmp_path, monkeypatch):
    """On a card, a 40 kb prefix of the default corpus on the native and
    the device graph paths: the VCF over every card and over two entries
    of cuda:0 is the unsharded run's; with two cards, so is a run on
    cuda:1 while cuda:0 is current (every kernel of both paths launches
    from the main thread there)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from lancet_tpu_torch import corpus

    region = corpus.write_default_corpus(str(tmp_path), 40000)
    cfg = Config(tumor_bam=f"{tmp_path}/tumor.bam",
                 normal_bam=f"{tmp_path}/normal.bam",
                 ref_fasta=f"{tmp_path}/ref.fa", region=region,
                 num_threads=4)

    def run(**kw):
        return _captured(lambda: trunner.run(cfg, command_line="t",
                                             date="D\n", **kw))

    for graph in ("0", "1"):
        monkeypatch.setenv("LANCET_TPU_DEVGRAPH", graph)
        want = run(device="cuda:0")
        assert any(ln and ln[0] != "#" for ln in want[0].splitlines())
        for mesh in (tmesh.make_mesh(),
                     tmesh.make_mesh(devices=["cuda:0"] * 2)):
            assert run(device="cuda:0", mesh=mesh) == want
        if torch.cuda.device_count() > 1:
            with torch.cuda.device(0):
                assert run(device="cuda:1") == want
