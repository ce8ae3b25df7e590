"""The JAX benchmark's hard and linked-reads corpora through the port, on
the CPU, against the JAX package.

- `corpus.hard_corpus` and `corpus.lr_corpus` write the same files as
  `bench.build_hard_corpus` and `bench.build_lr_corpus`;
- on the whole of each corpus, `lancet_tpu_torch.runner.run(device="cpu")`
  gives a VCF and a stderr summary byte-equal to
  `lancet_tpu.runner.run(engine="tpu")`, with the benchmark's record count
  (183 and 29) and KMERSIZE histogram, and on the hard corpus the same
  `stats["dp_samples"]`;
- the port's device graph engine (LANCET_TPU_DEVGRAPH=1) on the hard
  corpus's first seven sites (one of each family) equals the JAX native
  runner and replays windows for both causes, k past 63 and the
  pipeline's caps;
- LR through the two-phase process pool on 60 windows equals the JAX
  package's two-phase pool.
"""

import collections
import contextlib
import io
import os
import re
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench  # noqa: E402
from lancet_tpu.config import Config as JaxConfig  # noqa: E402
from lancet_tpu.io.bgzf import read_bgzf  # noqa: E402
from lancet_tpu.runner import run as jax_run  # noqa: E402
from lancet_tpu_torch import corpus  # noqa: E402
from lancet_tpu_torch import runner as torch_runner  # noqa: E402
from lancet_tpu_torch.config import Config  # noqa: E402
from lancet_tpu_torch.engine import devicepipe  # noqa: E402
from lancet_tpu_torch.corpus import READ_LEN  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

GENERATORS = {"hard": (corpus.hard_corpus, "build_hard_corpus", "HARD_DIR"),
              "lr": (corpus.lr_corpus, "build_lr_corpus", "LR_DIR")}
# the JAX benchmark's record counts on these corpora (BENCH_r05.json,
# where the reference binary matched every record), the hard corpus's
# KMERSIZE histogram from the same file, the LR corpus's from a run of
# both packages on the CPU
RECORDS = {"hard": 183, "lr": 29}
KMERSIZE = {"hard": {11: 10, 13: 113, 15: 17, 25: 4, 27: 15, 29: 5, 31: 6,
                     37: 5, 39: 5, 41: 3},
            "lr": {13: 24, 15: 5}}
HARD_STRETCH = "chr1:300-14300"  # the first seven sites, 141 windows
LR_STRETCH = "chr1:300-6300"  # 60 windows


def _captured(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        vcf = fn()
    return vcf, err.getvalue()


def _records(vcf):
    return [ln for ln in vcf.splitlines() if ln and ln[0] != "#"]


def _kmersizes(vcf):
    return dict(sorted(collections.Counter(
        int(re.search(r"KMERSIZE=(\d+)", r).group(1))
        for r in _records(vcf)).items()))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{name: (directory, region)}: each corpus written once."""
    out = {}
    for name, (gen, _, _) in GENERATORS.items():
        d = str(tmp_path_factory.mktemp(name))
        refseq, tumor, normal, region = gen()
        corpus.write_pair(d, refseq, "chr1", tumor, normal)
        out[name] = (d, region)
    return out


def _dict(corpora, name, region=None, **kw):
    d, full = corpora[name]
    return dict(tumor_bam=f"{d}/tumor.bam", normal_bam=f"{d}/normal.bam",
                ref_fasta=f"{d}/ref.fa", region=region or full,
                lr_mode=name == "lr", **kw)


def _port(d, stats=None, **kw):
    return _captured(lambda: torch_runner.run(
        Config(**d), command_line="t", date="D\n", device="cpu",
        stats=stats, **kw))


def _jax(d, stats=None, **kw):
    return _captured(lambda: jax_run(JaxConfig(**d), command_line="t",
                                     date="D\n", engine="tpu", stats=stats,
                                     **kw))


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_equals_bench(corpora, tmp_path, monkeypatch, name):
    """The port's generator writes the JAX benchmark's corpus: the same
    FASTA, and BAMs whose decompressed header and records are the same
    bytes, so that every record decodes the same."""
    _, build, attr = GENERATORS[name]
    monkeypatch.setattr(bench, attr, str(tmp_path))
    getattr(bench, build)()
    got = corpora[name][0]
    with open(f"{got}/ref.fa", "rb") as a, open(f"{tmp_path}/ref.fa",
                                                "rb") as b:
        assert a.read() == b.read()
    for bam in ("tumor.bam", "normal.bam"):
        data = read_bgzf(f"{got}/{bam}")
        assert data == read_bgzf(f"{tmp_path}/{bam}")
        assert len(data) > 10_000 * READ_LEN


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_whole_corpus_equals_jax(corpora, monkeypatch, name):
    """The whole corpus on the main path (8 threads): the port's VCF and
    summary byte-equal to the JAX package's, with the benchmark's records;
    the DP pairs sampled for the parity check equal the JAX run's."""
    monkeypatch.delenv("LANCET_TPU_DEVGRAPH", raising=False)
    d = _dict(corpora, name, num_threads=8)
    pstats: dict = {}
    jstats: dict = {}
    port = _port(d, pstats)
    assert port == _jax(d, jstats)
    assert len(_records(port[0])) == RECORDS[name]
    assert _kmersizes(port[0]) == KMERSIZE[name]
    assert pstats.get("dp_samples") == jstats.get("dp_samples")
    assert pstats["n_dp"] == jstats["n_dp"]
    if name == "hard":
        assert pstats["n_dp"] == 201 and len(pstats["dp_samples"]) == 64
    else:  # LR gives no path that needs the DP
        assert pstats["n_dp"] == 0 and "dp_samples" not in pstats


def test_devgraph_hard_stretch_equals_jax_native(corpora, monkeypatch):
    """The port's device graph engine on the hard corpus's first seven
    sites: the VCF and summary of the JAX native runner, with windows
    handed back to the native ladder both past k 63 and at the
    pipeline's caps; its DP samples are the device path's pairs."""
    d = _dict(corpora, "hard", HARD_STRETCH, num_threads=8)
    monkeypatch.delenv("LANCET_TPU_DEVGRAPH", raising=False)
    want = _jax(d)
    monkeypatch.setenv("LANCET_TPU_DEVGRAPH", "1")
    real = devicepipe.run_device_graph
    dp_jobs = []

    def kept(tasks, *a, **k):
        real(tasks, *a, **k)
        dp_jobs.extend(j for t in tasks if not t.fallback for j in t.jobs
                       if j.needs_dp)

    monkeypatch.setattr(devicepipe, "run_device_graph", kept)
    stats: dict = {}
    assert _port(d, stats) == want
    # the DP samples as the JAX device-graph runner takes them
    # (lancet_tpu/engine/shardrun.py:264-271)
    step = max(1, len(dp_jobs) // 64)
    assert dp_jobs and stats["dp_samples"] == [
        (j.refseq, j.pathseq) for j in dp_jobs[::step]][:64]
    causes = stats["dev_fallback_causes"]
    assert causes.get("k_gt_63", 0) > 0 and causes.get("pipeline_caps", 0) > 0
    assert "shape_caps" not in causes
    assert stats["n_dev_windows"] > 0
    assert max(stats["k_histogram"]) > 31


def test_lr_two_phase_pool_equals_jax(corpora, monkeypatch):
    """LR mode (BX and HP tags) through the two-phase process pool, the
    native runner off, on 60 windows: equal to the JAX package's pool."""
    d = _dict(corpora, "lr", LR_STRETCH, num_threads=2)
    monkeypatch.setenv("LANCET_TPU_NO_SHARDRUN", "1")
    stats: dict = {}
    port = _port(d, stats, processes=True)
    assert port == _jax(d, processes=True)
    assert _records(port[0])
    assert stats["t_gates"] > 0 and "n_dead_workers" not in stats
