"""The port end to end on the CPU against the JAX package.

`lancet_tpu_torch.runner.run(cfg, device="cpu")` must give a VCF and a
stderr summary byte-equal to `lancet_tpu.runner.run(cfg, engine="tpu")`,
with both Configs built from one dict (the port's through
`Config.from_dict`).
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from goldengen import scenario  # noqa: E402
from helpers import make_read, make_reference, tiled_reads, write_pair  # noqa: E402
from test_shardrun import _mixed_corpus  # noqa: E402

from lancet_tpu.config import Config as JaxConfig  # noqa: E402
from lancet_tpu.config import Filters as JaxFilters  # noqa: E402
from lancet_tpu.runner import run as jax_run  # noqa: E402
from lancet_tpu_torch import runner as torch_runner  # noqa: E402
from lancet_tpu_torch.config import Config  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _captured(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        vcf = fn()
    return vcf, err.getvalue()


def _jax_cfg(d: dict) -> JaxConfig:
    return JaxConfig(**dict(d, filters=JaxFilters(**d["filters"])))


def _both(d: dict):
    """(port, jax) results of one run as (vcf, stderr)."""
    port = _captured(lambda: torch_runner.run(
        Config.from_dict(d), command_line="t", date="D\n", device="cpu"))
    jax = _captured(lambda: jax_run(_jax_cfg(d), command_line="t",
                                    date="D\n", engine="tpu"))
    return port, jax


def _cfg_dict(tmp_path, region, **kw):
    return dataclasses.asdict(JaxConfig(
        tumor_bam=f"{tmp_path}/tumor.bam", normal_bam=f"{tmp_path}/normal.bam",
        ref_fasta=f"{tmp_path}/ref.fa", region=region, **kw))


def _snv(tmp_path):
    refseq = make_reference(1400, seed=11)
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[refseq[700]]
    write_pair(str(tmp_path), refseq, "chr1",
               tiled_reads(refseq, 450, 950, 100, 5, "t", {700: alt}, 0.5),
               tiled_reads(refseq, 450, 950, 100, 5, "n"))
    return "chr1:650-750"


def _identical(tmp_path):
    refseq = make_reference(1400, seed=12)
    write_pair(str(tmp_path), refseq, "chr1",
               tiled_reads(refseq, 450, 950, 100, 5, "t"),
               tiled_reads(refseq, 450, 950, 100, 5, "n"))
    return "chr1:650-750"


def _insertion(tmp_path):
    """tests/test_e2e.py::test_somatic_insertion_called's reads."""
    refseq = make_reference(1400, seed=13)
    pos, ins = 700, "TTCG"
    mutseq = refseq[:pos] + ins + refseq[pos:]
    tumor = []
    for i, start in enumerate(range(450, 860, 5)):
        al = make_read(f"ti{i}", refseq, start, 100, 0x10 if i % 2 else 0)
        if i % 2 == 0 and start + 100 > pos - 10:
            al.seq = mutseq[start : start + 100]
            if start < pos and start + 100 > pos + 10:
                ml = pos - start
                al.cigar = [("M", ml), ("I", len(ins)),
                            ("M", 100 - ml - len(ins))]
                al.tags["MD"] = ("Z", str(100 - len(ins)))
        tumor.append(al)
    write_pair(str(tmp_path), refseq, "chr1", tumor,
               tiled_reads(refseq, 450, 950, 100, 5, "n"))
    return "chr1:650-750"


def _lr_snv(tmp_path):
    refseq, tumor, normal, region = scenario("lr_snv", 0)
    write_pair(str(tmp_path), refseq, "chr1", tumor, normal)
    return region


@pytest.mark.parametrize("case,kw", [
    ("snv", {}), ("insertion", {}), ("identical", {}),
    ("lr_snv", {"lr_mode": True}),
])
def test_scenario_equals_jax(tmp_path, case, kw):
    region = {"snv": _snv, "insertion": _insertion, "identical": _identical,
              "lr_snv": _lr_snv}[case](tmp_path)
    port, jax = _both(_cfg_dict(tmp_path, region, **kw))
    assert port == jax
    if case in ("snv", "insertion", "lr_snv"):
        assert any(ln and ln[0] != "#" for ln in port[0].splitlines())


@pytest.mark.parametrize("threads", [1, 3])
def test_mixed_corpus_equals_jax(tmp_path, threads):
    chrom_len = _mixed_corpus(tmp_path, seed=9, chrom_len=9000)
    port, jax = _both(_cfg_dict(tmp_path, f"chr1:300-{chrom_len - 300}",
                                num_threads=threads))
    assert port == jax
    assert sum(1 for ln in port[0].splitlines() if ln[0] != "#") >= 3


def test_resume_dir_chunked_equals_jax(tmp_path, monkeypatch):
    chrom_len = _mixed_corpus(tmp_path, seed=9, chrom_len=6000)
    d = _cfg_dict(tmp_path, f"chr1:300-{chrom_len - 300}", num_threads=2)
    monkeypatch.setattr(torch_runner, "RESUME_CHUNK", 7)
    monkeypatch.setenv("LANCET_TPU_RESUME_CHUNK", "7")
    port_d = dict(d, resume_dir=str(tmp_path / "resume_port"))
    port = _captured(lambda: torch_runner.run(
        Config.from_dict(port_d), command_line="t", date="D\n",
        device="cpu"))
    jax_d = dict(d, resume_dir=str(tmp_path / "resume_jax"))
    jax = _captured(lambda: jax_run(_jax_cfg(jax_d), command_line="t",
                                    date="D\n", engine="tpu"))
    assert port == jax
    logs = sorted(os.listdir(tmp_path / "resume_port"))
    assert logs == ["shard0000.jsonl", "shard0001.jsonl"]
    with open(tmp_path / "resume_port" / logs[0]) as f:
        assert len(f.readlines()) > 1  # more than one chunked round
    # a second run replays every window from the logs
    again = _captured(lambda: torch_runner.run(
        Config.from_dict(port_d), command_line="t", date="D\n",
        device="cpu"))
    assert again[0] == port[0]


def test_cli_cpu_records_equal_jax(tmp_path):
    region = _snv(tmp_path)
    out = tmp_path / "port.vcf"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "lancet_tpu_torch.cli", "--device", "cpu",
         "-t", f"{tmp_path}/tumor.bam", "-n", f"{tmp_path}/normal.bam",
         "-r", f"{tmp_path}/ref.fa", "-p", region, "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    _, jax = _both(_cfg_dict(tmp_path, region))
    assert r.stderr == jax[1]

    def records(v):
        return [ln for ln in v.splitlines() if ln and ln[0] != "#"]

    got = records(out.read_text())
    assert got and got == records(jax[0])
