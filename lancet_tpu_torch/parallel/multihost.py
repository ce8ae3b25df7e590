"""The fan-out over processes: torch.distributed processes over window
shards.

The reference scales past one machine with a qsub fan-out, one lancet job
per region chunk and a VCF merge script (README.md:70-88). Here N
processes (one per host, or one per card of a host) join one
torch.distributed group; every process computes the same global shard list,
runs the whole pipeline (the native plane and its own device or mesh) on
the shards `si % N == rank`, and the pickled per-shard variant DBs are
gathered to every process. Process 0 merges them in global shard order,
the order of a single-process run (Lancet.cc:938-959), so the VCF does not
depend on the process count.

The gather moves host bytes, so it runs on gloo, as the JAX package's
`process_allgather` gathers host arrays. No collective of the compute path
crosses processes: each process's devices work on its own shards.

Each process opens its own BAM and FASTA readers and reads only the file
regions its shards cover (the BAI index makes those reads local seeks).
"""

from __future__ import annotations

import datetime
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

# how long a process waits for the others (joining the group, each
# collective) before it raises: a dead peer must not hang the rest
TIMEOUT_S = 600


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join the process group: gloo over TCP, process 0 serving the store at
    `coordinator` ("host:port"). Raises after TIMEOUT_S seconds if the
    others do not come."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def shutdown() -> None:
    """Leave the process group (nothing to do outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_bytes(blob: bytes) -> list[bytes]:
    """One bytes payload per process, gathered to every process in rank
    order. The lengths are gathered first, so that the payload travels as
    a uint8 tensor of one width on every process."""
    _, n = _world()
    if n == 1:
        return [blob]
    ln = torch.tensor([len(blob)], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, ln)
    lens = [int(t) for t in lens]
    width = max(1, max(lens))
    buf = torch.zeros(width, dtype=torch.uint8)
    buf[:len(blob)] = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    bufs = [torch.empty(width, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [b[:k].numpy().tobytes() for b, k in zip(bufs, lens)]


def run_multihost(cfg, command_line: str = "lancet-tpu",
                  date: str | None = None, device="cuda", mesh=None,
                  stats: dict | None = None,
                  engine: str = "batched") -> str | None:
    """Run the caller over every process of the group (after
    init_distributed; alone, it is runner.run). Returns the VCF text on
    process 0 and None on the others. `device`, `mesh`, `stats` and
    `engine` are this process's, as for runner.run."""
    from ..engine.vardb import VariantDB
    from ..io import open_bam
    from ..runner import LANCET_VERSION, run

    p, n = _world()
    collect: dict = {}
    run(cfg, command_line=command_line, date=date, device=device, mesh=mesh,
        stats=stats, engine=engine, shard_filter=lambda si: si % n == p,
        collect=collect)

    blobs = _allgather_bytes(pickle.dumps(collect["shard_dbs"], protocol=4))
    if p != 0:
        return None
    shard_dbs = sorted((s for b in blobs for s in pickle.loads(b)),
                       key=lambda t: t[0])
    merged = VariantDB(cfg.lr_mode)
    for _, db in shard_dbs:
        vdb = VariantDB(cfg.lr_mode)
        vdb.db = db
        merged.merge_from(vdb)
    if date is None:
        date = time.asctime() + "\n"
    tumor = open_bam(cfg.tumor_bam)
    normal = open_bam(cfg.normal_bam)
    return merged.to_vcf(LANCET_VERSION, cfg.ref_fasta, date, cfg.filters,
                         normal.sample_name(), tumor.sample_name(),
                         command_line)
