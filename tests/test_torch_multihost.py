"""The port's fan-out over processes (lancet_tpu_torch.parallel.multihost)
on the CPU: two gloo processes over window shards give the VCF of the JAX
package's single-process run, on the native path and with the device graph
engine over a per-process mesh; the in-process shard partition merges to
the full run; the byte gather carries payloads of unequal length.

The worker processes import neither JAX nor the JAX package. The test
kills every worker still running after LIMIT_S seconds, so a dead peer
cannot hang the suite.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lancet_tpu_torch import runner as trunner  # noqa: E402
from lancet_tpu_torch.config import Config  # noqa: E402
from lancet_tpu_torch.engine.vardb import VariantDB  # noqa: E402
from lancet_tpu_torch.io import open_bam  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 300  # a worker's whole run

_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from lancet_tpu_torch.config import Config
from lancet_tpu_torch.parallel.mesh import make_mesh
from lancet_tpu_torch.parallel.multihost import (init_distributed,
                                                 run_multihost, shutdown)

rank, nproc, port, cfg, mesh_n, out = sys.argv[1:]
rank, nproc, mesh_n = int(rank), int(nproc), int(mesh_n)
init_distributed("127.0.0.1:" + port, nproc, rank)
try:
    stats = {}
    mesh = make_mesh(devices=["cpu"] * mesh_n) if mesh_n else None
    vcf = run_multihost(Config.from_dict(json.loads(cfg)), command_line="mh",
                        date="D\n", device="cpu", mesh=mesh, stats=stats)
    assert (vcf is not None) == (rank == 0)
    if os.environ.get("LANCET_TPU_DEVGRAPH") == "1":
        assert stats["n_dev_windows"] > 0, "device graph engine idle"
        assert stats["mesh_counters"]["numcomp"] > 0
    if rank == 0:
        open(out, "w").write(vcf)
finally:
    shutdown()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "lancet_tpu")]
assert not bad, bad
"""

_GATHER = r"""
import sys
from lancet_tpu_torch.parallel.multihost import (_allgather_bytes,
                                                 init_distributed, shutdown)

rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
blobs = [b"", b"abc", bytes(range(256)) * 3]
init_distributed("127.0.0.1:" + port, nproc, rank)
try:
    got = _allgather_bytes(blobs[rank])
    assert got == blobs[:nproc], [len(b) for b in got]
finally:
    shutdown()
"""


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _run_workers(script: str, nproc: int, extra=(), env_set=None) -> None:
    """`script` in nproc processes (rank, nproc, port, *extra); every one
    must exit 0 within LIMIT_S. Kills the rest on the first failure or at
    the limit."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "LANCET_TPU_DEVGRAPH",
                        "LANCET_TPU_GATES")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **(env_set or {}))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r),
         str(nproc), port, *extra], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(nproc)]
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=LIMIT_S)
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _corpus(tmp_path, seed):
    from test_shardrun import _mixed_corpus

    from lancet_tpu.config import Config as JaxConfig

    chrom_len = _mixed_corpus(tmp_path, seed=seed, chrom_len=9000)
    return dataclasses.asdict(JaxConfig(
        tumor_bam=f"{tmp_path}/tumor.bam", normal_bam=f"{tmp_path}/normal.bam",
        ref_fasta=f"{tmp_path}/ref.fa", region=f"chr1:300-{chrom_len - 300}",
        num_threads=3))


def _jax_vcf(d: dict) -> str:
    from lancet_tpu.config import Config as JaxConfig
    from lancet_tpu.config import Filters as JaxFilters
    from lancet_tpu.runner import run as jax_run

    cfg = JaxConfig(**dict(d, filters=JaxFilters(**d["filters"])))
    with contextlib.redirect_stderr(io.StringIO()):
        vcf = jax_run(cfg, command_line="mh", date="D\n", engine="tpu")
    assert sum(1 for ln in vcf.splitlines() if not ln.startswith("#")) > 0
    return vcf


def _two_process_vcf(tmp_path, d: dict, mesh_n: int, env_set=None) -> str:
    out = str(tmp_path / "mh.vcf")
    _run_workers(_WORKER, 2, (json.dumps(d), str(mesh_n), out), env_set)
    with open(out) as f:
        return f.read()


def test_two_process_vcf_matches_jax_single(tmp_path):
    d = _corpus(tmp_path, seed=31)
    assert _two_process_vcf(tmp_path, d, 0) == _jax_vcf(d)


def test_two_process_devgraph_mesh_matches_jax_single(tmp_path):
    """Each process runs the device graph engine on its shards over a mesh
    of two host entries."""
    d = _corpus(tmp_path, seed=37)
    got = _two_process_vcf(tmp_path, d, 2, {"LANCET_TPU_DEVGRAPH": "1"})
    assert got == _jax_vcf(d)


def test_shard_filter_collect_partition(tmp_path, monkeypatch):
    """In one process: the two halves' shard DBs, merged in global shard
    order, give the full run's VCF (the invariant the fan-out rests on);
    a collecting run returns no VCF."""
    monkeypatch.delenv("LANCET_TPU_DEVGRAPH", raising=False)
    d = _corpus(tmp_path, seed=33)
    cfg = Config.from_dict(d)
    with contextlib.redirect_stderr(io.StringIO()):
        want = trunner.run(cfg, command_line="mh", date="D\n", device="cpu")
        parts = []
        for p in range(2):
            collect: dict = {}
            assert trunner.run(cfg, command_line="mh", date="D\n",
                               device="cpu", collect=collect,
                               shard_filter=lambda si, p=p: si % 2 == p) == ""
            assert [si % 2 for si, _ in collect["shard_dbs"]] == [p] * len(
                collect["shard_dbs"])
            parts.extend(collect["shard_dbs"])
    assert sorted(si for si, _ in parts) == list(range(cfg.num_threads))
    merged = VariantDB(cfg.lr_mode)
    for _, db in sorted(parts, key=lambda t: t[0]):
        vdb = VariantDB(cfg.lr_mode)
        vdb.db = db
        merged.merge_from(vdb)
    got = merged.to_vcf(trunner.LANCET_VERSION, cfg.ref_fasta, "D\n",
                        cfg.filters, open_bam(cfg.normal_bam).sample_name(),
                        open_bam(cfg.tumor_bam).sample_name(), "mh")
    assert got == want == _jax_vcf(d)


def test_allgather_bytes_unequal_lengths():
    """Three processes gather payloads of 0, 3 and 768 bytes; alone, the
    gather is the payload itself."""
    from lancet_tpu_torch.parallel.multihost import _allgather_bytes

    assert _allgather_bytes(b"xyz") == [b"xyz"]
    _run_workers(_GATHER, 3)
