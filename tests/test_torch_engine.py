"""The port's per-window engine and its paths against the JAX package, on
the CPU.

Each run of `lancet_tpu_torch.runner.run(..., device="cpu")` must give a
VCF and a stderr summary byte-equal to `lancet_tpu.runner.run` with the
matching engine ("batched" is the JAX package's "tpu"), both Configs built
from one dict: the oracle engine; the batched per-window engine
(LANCET_TPU_NO_SHARDRUN=1); the two-phase process pool, also with a worker
killed (LANCET_TPU_TEST_KILL_SHARD); kmer recovery; print_graph with its
DOT files; and native fallback windows replayed on the per-window engine.
"""

import contextlib
import dataclasses
import io
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from goldengen import scenario  # noqa: E402
from helpers import write_pair  # noqa: E402
from test_shardrun import _mixed_corpus  # noqa: E402

from lancet_tpu.config import Config as JaxConfig  # noqa: E402
from lancet_tpu.config import Filters as JaxFilters  # noqa: E402
from lancet_tpu.runner import run as jax_run  # noqa: E402
from lancet_tpu_torch import runner as torch_runner  # noqa: E402
from lancet_tpu_torch.config import Config  # noqa: E402
from lancet_tpu_torch.engine import shardrun  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)


def _captured(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        vcf = fn()
    return vcf, err.getvalue()


def _port(d: dict, engine="batched", stats=None, **kw):
    return _captured(lambda: torch_runner.run(
        Config.from_dict(d), command_line="t", date="D\n", device="cpu",
        engine=engine, stats=stats, **kw))


def _jax(d: dict, engine="batched", **kw):
    cfg = JaxConfig(**dict(d, filters=JaxFilters(**d["filters"])))
    return _captured(lambda: jax_run(
        cfg, command_line="t", date="D\n",
        engine="tpu" if engine == "batched" else engine, **kw))


def _scenario(tmp_path, name, seed, **kw):
    refseq, tumor, normal, region = scenario(name, seed)
    write_pair(str(tmp_path), refseq, "chr1", tumor, normal)
    return dataclasses.asdict(JaxConfig(
        tumor_bam=f"{tmp_path}/tumor.bam", normal_bam=f"{tmp_path}/normal.bam",
        ref_fasta=f"{tmp_path}/ref.fa", region=region, **kw))


def _records(vcf):
    return [ln for ln in vcf.splitlines() if ln and ln[0] != "#"]


def test_oracle_engine_equals_jax(tmp_path):
    d = _scenario(tmp_path, "somatic_del", 1)
    port = _port(d, engine="oracle")
    assert port == _jax(d, engine="oracle")
    assert _records(port[0])


def test_batched_per_window_engine_equals_jax(tmp_path, monkeypatch):
    chrom_len = _mixed_corpus(tmp_path, seed=9, chrom_len=9000)
    d = dataclasses.asdict(JaxConfig(
        tumor_bam=f"{tmp_path}/tumor.bam", normal_bam=f"{tmp_path}/normal.bam",
        ref_fasta=f"{tmp_path}/ref.fa", region=f"chr1:300-{chrom_len - 300}",
        num_threads=3))
    monkeypatch.setenv("LANCET_TPU_NO_SHARDRUN", "1")
    calls = []
    monkeypatch.setattr(shardrun, "run_shards",
                        lambda *a, **k: calls.append(a))
    stats: dict = {}
    port = _port(d, stats=stats)
    assert not calls, "the native shard runner ran"
    assert "n_fallback" not in stats
    assert port == _jax(d)
    assert len(_records(port[0])) >= 3


@pytest.mark.parametrize("name,kill", [("two_snvs", False),
                                       ("two_snvs", True),
                                       ("somatic_del", False)])
def test_two_phase_process_pool_equals_jax(tmp_path, monkeypatch, name,
                                           kill):
    d = _scenario(tmp_path, name, 1, num_threads=2)
    monkeypatch.setenv("LANCET_TPU_NO_SHARDRUN", "1")
    if kill:
        monkeypatch.setenv("LANCET_TPU_TEST_KILL_SHARD", "1")
    stats: dict = {}
    port = _port(d, stats=stats, processes=True)
    jax = _jax(d, processes=True)
    if kill:
        # a killed worker can break the whole pool, so each package may
        # count one or both shards as dead in its warning line
        def strip(run):
            return run[0], [ln for ln in run[1].splitlines()
                            if not ln.startswith("WARNING: ")]
        assert strip(port) == strip(jax)
    else:
        assert port == jax
    assert _records(port[0])
    assert {"t_gates", "t_host", "t_dp", "t_finish", "n_jobs",
            "n_dp"} <= set(stats)
    assert stats["n_jobs"] >= 1
    # the deletion's paths need the parent's batched DP
    assert (stats["n_dp"] >= 1) == (name == "somatic_del")
    if kill:
        assert stats.get("n_dead_workers", 0) >= 1
        assert "worker(s) died" in port[1]
        monkeypatch.delenv("LANCET_TPU_TEST_KILL_SHARD")
        assert port[0] == _port(d, processes=True)[0]
    else:
        assert "n_dead_workers" not in stats


def test_kmer_recovery_equals_jax(tmp_path):
    d = _scenario(tmp_path, "somatic_snv", 2, kmer_recovery=True)
    port = _port(d)
    assert port == _jax(d)
    assert _records(port[0])


def test_print_graph_dot_files_equal_jax(tmp_path, monkeypatch):
    d = _scenario(tmp_path, "somatic_snv", 0, print_graph=True)
    out = {}
    for name, fn in (("port", _port), ("jax", _jax)):
        wd = tmp_path / name
        wd.mkdir()
        monkeypatch.chdir(wd)
        out[name] = fn(d)
    assert out["port"] == out["jax"]
    port_dots = sorted(os.listdir(tmp_path / "port"))
    assert port_dots and all(f.endswith(".dot") for f in port_dots)
    assert port_dots == sorted(os.listdir(tmp_path / "jax"))
    for f in port_dots:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def test_native_fallback_windows_replay(tmp_path, monkeypatch):
    chrom_len = _mixed_corpus(tmp_path, seed=9, chrom_len=6000)
    d = dataclasses.asdict(JaxConfig(
        tumor_bam=f"{tmp_path}/tumor.bam", normal_bam=f"{tmp_path}/normal.bam",
        ref_fasta=f"{tmp_path}/ref.fa", region=f"chr1:300-{chrom_len - 300}",
        num_threads=2))
    plain_stats: dict = {}
    plain = _port(d, stats=plain_stats)
    assert plain_stats["n_fallback"] == 0
    run_shards = shardrun.run_shards
    forced = []

    def forcing(*a, **k):
        res = run_shards(*a, **k)
        # two windows that carry variants, so the replay has work to match
        idx = sorted(res.variants_by_window)[:2]
        assert len(idx) == 2
        res.fallback.update(idx)
        forced.extend(idx)
        return res

    monkeypatch.setattr(shardrun, "run_shards", forcing)
    stats: dict = {}
    vcf, err = _port(d, stats=stats)
    assert forced and stats["n_fallback"] == 2
    assert vcf == plain[0] and _records(vcf)
    warn = ("WARNING: 2 windows replayed on the python engine (native "
            "shard runner fallback)\n")
    assert err == warn + plain[1]
