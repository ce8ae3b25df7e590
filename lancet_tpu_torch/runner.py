"""End-to-end run orchestration (ref: src/Lancet.cc main).

Generates the windows, shards them round-robin (reference thread
semantics), processes each shard and merges the shard variant DBs in shard
order, then renders the VCF. Three ways through the windows, as in the
JAX package's runner:

- the native shard runner (engine "batched" without kmer_recovery or
  print_graph, unless LANCET_TPU_NO_SHARDRUN is set): the host work in the
  native C++ plane and the Gotoh DP on `device`; a window the native plane
  hands back is replayed on the per-window engine. With
  LANCET_TPU_DEVGRAPH=1 (not in LR mode) the graph build, cleanup and path
  cover of each exported window run on `device` instead (the device graph
  engine, engine.shardrun.run_shards_device);
- the two-phase process pool (`processes=True`, num_threads > 1): the
  parent computes the repeat gates on `device`, workers do the host work,
  the parent aligns every deferred path job in one batch and finishes
  them in shard order;
- the per-window engine, shard after shard, in this process.

A `mesh` (parallel.mesh) reaches only the native shard runner: it splits
each DP group on the pair axis, and the device graph engine's windows, over
its devices. `shard_filter` and `collect` serve the multi-process fan-out
(parallel.multihost): every process computes the same global shard list,
keeps the shards the filter selects, and hands back per-shard VariantDBs
for a merge in global shard order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from .config import Config, print_configuration
from .engine.micro import Microassembler, ShardCounters
from .engine.vardb import VariantDB
from .gpu import resolve_device
from .io import open_bam, open_fasta
from .windows import generate_windows, shard_windows

LANCET_VERSION = "1.1.0, October 18 2019"  # reference version string emulated

# windows per shard and round with --resume-dir on the native shard runner;
# each round ends with an fsync'd append to every shard's log
RESUME_CHUNK = 256

ENGINES = ("batched", "oracle")


def _print_summary(counters, num_windows: int) -> None:
    """End-of-run region-class counters to stderr
    (ref: Lancet.cc:930-970)."""

    def tot(field):
        return sum(getattr(c, field) for c in counters)

    skip = tot("num_skip")
    pct = 100.0 * skip / num_windows if num_windows else 0.0
    err = sys.stderr
    print(f"Total # of skipped windows: {skip} ({pct:g}%)", file=err)
    print(f"- # of windows with SNVs only: {tot('num_snv_only')}", file=err)
    print(f"- # of windows with indels only: {tot('num_indel_only')}",
          file=err)
    print(f"- # of windows with softclips only: {tot('num_softclip_only')}",
          file=err)
    print("- # of windows with indels or softclips: "
          f"{tot('num_indel_or_softclip')}", file=err)
    print(f"- # of windows with SNVs or indels: {tot('num_snv_or_indel')}",
          file=err)
    print("- # of windows with SNVs or softclips: "
          f"{tot('num_snv_or_softclip')}", file=err)
    print("- # of windows with SNVs or indels or softclips: "
          f"{tot('num_snv_or_indel_or_softclip')}", file=err)


def _run_shard(cfg, tumor_path, normal_path, shard, engine, shard_idx=0,
               resume_state=None, gates=None, defer=False, test_kill=False):
    """Process-pool worker: open its own readers (share-nothing) and
    return (VariantDB, window_times, counters, path_jobs).

    Two-phase mode (defer=True with the parent's gates): the worker is
    pure host code with no device (device=None: reaching repeat_gates or
    batch_align raises), and returns its deferred PathJobs for the parent
    to align on the device and finish, so N workers fill the host's cores
    while one process owns the card. A pool worker asserts that it holds
    no CUDA context. Otherwise (the oracle engine, or --resume-dir, where
    workers flush their own jobs) the worker runs on device="cpu": the
    batched engine then computes its gates and DP with the plain PyTorch
    versions on the host."""
    import multiprocessing as _mp

    in_pool = _mp.parent_process() is not None
    if test_kill and in_pool:
        os._exit(1)  # failure-injection hook: simulate a died worker
    if defer and in_pool:
        import torch

        assert not torch.cuda.is_initialized(), \
            "a two-phase worker must not initialise CUDA"
    tumor = open_bam(tumor_path)
    normal = open_bam(normal_path)
    ma = Microassembler(cfg, readers=(tumor, normal), engine=engine,
                        device=None if defer else "cpu")
    if gates is not None:
        ma.precomputed_gates = gates
    ma.defer_flush = defer
    _process_shard(ma, cfg, shard, shard_idx, resume_state)
    return ma.vdb, ma.window_times, ma.counters, (ma.path_jobs if defer
                                                  else [])


def _process_shard(ma, cfg, shard, shard_idx, resume_state) -> None:
    """Run one shard with optional resume logging / window tracing."""
    trace = bool(cfg.trace_file)
    if cfg.resume_dir:
        from .checkpoint import ShardLog, shard_log_path

        done, replay = (resume_state if resume_state is not None
                        else (set(), []))
        for v in replay:
            ma.vdb.add_var(v)
        log = ShardLog(shard_log_path(cfg.resume_dir, shard_idx))
        try:
            ma.process_windows(shard, skip_names=done,
                               chunk_cb=log.append_chunk, trace=trace)
        finally:
            log.close()
    else:
        ma.process_windows(shard, chunk_cb=None, trace=trace)


def _regions(cfg: Config) -> list[str]:
    regions = []
    if cfg.bed_file:
        with open(cfg.bed_file) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                toks = line.rstrip("\n").split("\t")
                if len(toks) < 3:
                    continue
                sp = int(toks[1]) - cfg.padding
                if sp < 1:
                    sp = 1
                ep = int(toks[2]) + cfg.padding
                # NOTE: loadRefs pads again -> BED rows get 2x padding,
                # replicating the reference (Lancet.cc:345-352)
                regions.append(f"{toks[0]}:{sp}-{ep}")
    if cfg.region:
        regions.append(cfg.region)
    return regions


def _accumulate(stats: dict, rs: dict) -> None:
    """Add one round's stats into the run's: numbers sum, and so do the
    counts of a dict (k_histogram, dev_fallback_causes) key by key."""
    for k, v in rs.items():
        if isinstance(v, float):
            stats[k] = stats.get(k, 0.0) + v
        elif isinstance(v, int):
            stats[k] = stats.get(k, 0) + v
        elif isinstance(v, dict):
            h = stats.setdefault(k, {})
            for kk, vv in v.items():
                h[kk] = h.get(kk, 0) + vv
        else:
            stats[k] = v


def _run_native(cfg, cfg_eff, shards, shard_ids, resume_state, tumor,
                normal, dev, stats, all_times, mesh=None):
    """The native shard runner over every shard (`shard_ids` their global
    indices, which name their resume logs); returns (per-shard VariantDBs,
    counters), or None when the native plane reports a failed group (the
    caller then runs the per-window engine)."""
    from .engine.shardrun import (device_graph_enabled, run_shards,
                                  run_shards_device)

    # the device graph engine carries no BX/HP payloads: LR runs stay on
    # the native plane
    run_fn = (run_shards_device if device_graph_enabled() and not cfg.lr_mode
              else run_shards)

    # per-shard window lists; with --resume-dir the run is split into
    # chunked rounds, each followed by an fsync'd per-shard log append
    # (windows + their variant records), so a crash resumes mid-run
    shard_wins = [sorted(shard, key=lambda w: w.name) for shard in shards]
    shard_vdbs = [VariantDB(cfg.lr_mode) for _ in shards]
    logs = None
    chunk = None
    todo = shard_wins
    if cfg.resume_dir:
        from .checkpoint import ShardLog, shard_log_path

        for i, (_, replay) in enumerate(resume_state):
            for v in replay:
                shard_vdbs[i].add_var(v)
        logs = [ShardLog(shard_log_path(cfg.resume_dir, i))
                for i in shard_ids]
        todo = [[w for w in sw if w.name not in resume_state[i][0]]
                for i, sw in enumerate(shard_wins)]
        chunk = RESUME_CHUNK

    ctr = ShardCounters()
    fb_ma = None
    trace = bool(cfg.trace_file)
    n_fallback = 0
    n_rounds = (1 if chunk is None else
                max([(len(t) + chunk - 1) // chunk for t in todo] or [1])
                or 1)
    try:
        for rnd in range(n_rounds):
            ordered = []
            shard_of = []
            for si, t in enumerate(todo):
                sub = t if chunk is None else t[rnd * chunk:(rnd + 1) * chunk]
                ordered.extend(sub)
                shard_of.extend([si] * len(sub))
            if not ordered:
                continue
            rstats: dict = {}
            res = run_fn(cfg_eff, ordered, tumor, normal, stats=rstats,
                         device=dev, mesh=mesh)
            if res is None:
                return None
            _accumulate(stats, rstats)
            pos = 0
            for si in range(len(shards)):
                vdb = shard_vdbs[si]
                win_names: list = []
                if logs is not None:
                    vdb.record_sink = []
                while pos < len(ordered) and shard_of[pos] == si:
                    w = ordered[pos]
                    if pos in res.fallback:
                        # the native per-k pipeline threw: replay the
                        # window on the per-window engine, same device
                        if fb_ma is None:
                            fb_ma = Microassembler(cfg_eff,
                                                   readers=(tumor, normal),
                                                   engine="batched",
                                                   device=dev)
                        fb_ma.vdb = vdb
                        r0 = fb_ma.counters.total_reads
                        t0 = time.perf_counter()
                        fb_ma.process_window(w)
                        fb_ma.flush_path_jobs()
                        if trace:
                            all_times.append(
                                (w.name, (time.perf_counter() - t0) * 1e3,
                                 fb_ma.counters.total_reads - r0))
                    else:
                        for v in res.variants_by_window.get(pos, ()):
                            vdb.add_var(v)
                        c = res.counters[pos]
                        ctr.num_skip += int(c[0])
                        ctr.num_snv_only += int(c[1])
                        ctr.num_indel_only += int(c[2])
                        ctr.num_softclip_only += int(c[3])
                        ctr.num_indel_or_softclip += int(c[4])
                        ctr.num_snv_or_indel += int(c[5])
                        ctr.num_snv_or_softclip += int(c[6])
                        ctr.num_snv_or_indel_or_softclip += int(c[7])
                        ctr.total_reads += int(res.reads[pos])
                        ctr.windows_done += int(c[8])
                        if trace:
                            all_times.append((w.name, float(res.times[pos]),
                                              int(res.reads[pos])))
                    win_names.append(w.name)
                    pos += 1
                if logs is not None:
                    if win_names:
                        logs[si].append_chunk(win_names, vdb.record_sink)
                    vdb.record_sink = None
            n_fallback += len(res.fallback)
            if res.fallback:
                print(f"WARNING: {len(res.fallback)} windows replayed on "
                      "the python engine (native shard runner fallback)",
                      file=sys.stderr)
    finally:
        if logs is not None:
            for lg in logs:
                lg.close()
    # surface native->python replays: a silent 100%-fallback regression
    # must look like an error, not a perf mystery
    stats["n_fallback"] = n_fallback
    counters = ([fb_ma.counters] if fb_ma is not None else []) + [ctr]
    return shard_vdbs, counters


def _run_pool(cfg, cfg_eff, engine, windows, shards, shard_ids, resume_state,
              dev, stats):
    """Share-nothing shard workers in a process pool (reference pthread
    model, Lancet.cc:844-928; `shard_ids` the shards' global indices, which
    name their resume logs); returns per-shard (VariantDB, window_times,
    counters). Shard DBs merge in shard order, so the result does not
    depend on the process count."""
    import concurrent.futures as cf
    import multiprocessing as mp

    # two-phase: the parent precomputes the repeat gates on the device,
    # workers do pure-host graph work, the parent aligns all deferred jobs
    # on the device and finishes them in shard order (the add order of the
    # single-process run). Resume logging needs in-worker flushes, so it
    # takes self-contained workers.
    defer = engine == "batched" and not cfg.resume_dir
    gates_by_shard = [None] * len(shards)
    if defer:
        t0 = time.perf_counter()
        planner = Microassembler(cfg_eff, readers=None, engine=engine,
                                 device=dev)
        planner._precompute_gates(sorted(windows, key=lambda w: w.name))
        for i, shard in enumerate(shards):
            names = {w.name for w in shard}
            gates_by_shard[i] = (
                {n: g for n, g in planner._gates.items() if n in names},
                planner._gate_kidx)
        stats["t_gates"] = time.perf_counter() - t0

    # forkserver: the server boots once via exec (it inherits no CUDA
    # context: never plain-fork a process with a live device runtime) and
    # each worker forks from it in milliseconds. Preload the worker's
    # import graph into the server; none of it initialises CUDA.
    try:
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(
            ["lancet_tpu_torch.runner", "lancet_tpu_torch.engine.micro",
             "lancet_tpu_torch.io.bam", "lancet_tpu_torch.native"])
    except (ValueError, AttributeError):
        ctx = mp.get_context("spawn")

    # workers beyond the cores only add fork + pickle + context switch
    # overhead; the shard count stays num_threads (result-identical)
    n_workers = max(1, min(cfg.num_threads, os.cpu_count() or 8))
    t0 = time.perf_counter()
    kill_env = os.environ.get("LANCET_TPU_TEST_KILL_SHARD")
    with cf.ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx) as ex:
        futs = [ex.submit(_run_shard, cfg_eff, cfg.tumor_bam, cfg.normal_bam,
                          shard, engine, shard_ids[i], resume_state[i],
                          gates_by_shard[i], defer,
                          kill_env is not None and int(kill_env) == i)
                for i, shard in enumerate(shards)]
        results = []
        dead: list[int] = []
        for i, fut in enumerate(futs):
            try:
                results.append(fut.result())
            except Exception:
                # worker died (OOM/segv/kill): its shard is re-run in the
                # parent below; the share-nothing shard model makes the
                # replay result-identical
                dead.append(i)
                results.append(None)
    if dead:
        print(f"WARNING: {len(dead)} worker(s) died; re-running "
              f"{sum(len(shards[i]) for i in dead)} windows in-parent",
              file=sys.stderr)
        for i in dead:
            results[i] = _run_shard(cfg_eff, cfg.tumor_bam, cfg.normal_bam,
                                    shards[i], engine, shard_ids[i],
                                    resume_state[i],
                                    gates_by_shard[i], defer)
        stats["n_dead_workers"] = len(dead)
    stats["t_host"] = time.perf_counter() - t0
    if not defer:
        return [(vdb, times, ctr) for vdb, times, ctr, _ in results]

    from .engine.extract import finish_path
    from .gpu.align_batch import batch_align

    all_jobs = [j for (_, _, _, jobs) in results for j in jobs]
    dp_jobs = [j for j in all_jobs if j.needs_dp]
    stats["n_jobs"] = len(all_jobs)
    stats["n_dp"] = len(dp_jobs)
    aligned = {}
    t0 = time.perf_counter()
    if dp_jobs:
        out = batch_align([(j.refseq, j.pathseq) for j in dp_jobs], dev)
        aligned = {id(j): r for j, r in zip(dp_jobs, out)}
    stats["t_dp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for vdb, _, _, jobs in results:
        for j in jobs:
            ra, pa = (aligned[id(j)] if j.needs_dp
                      else (j.refseq, j.pathseq))
            finish_path(j, ra, pa, cfg_eff, vdb)
    stats["t_finish"] = time.perf_counter() - t0
    return [(vdb, times, ctr) for vdb, times, ctr, _ in results]


def run(cfg: Config, command_line: str = "lancet-tpu", date: str | None = None,
        processes: bool = False, stats: dict | None = None,
        device="cuda", engine: str = "batched", mesh=None,
        shard_filter=None, collect: dict | None = None) -> str:
    """Run the caller; returns the VCF text.

    engine "batched" runs the repeat gates and the Gotoh DP on `device`
    ("cuda" or "cpu"; asking for "cuda" with no card raises); "oracle" is
    pure host work (global_align_aff and host repeat scans) and ignores
    `device`. `processes=True` fans shards out to a process pool (the
    two-phase path for the batched engine). `stats`, if given, is filled
    with per-stage wall seconds and counts. `mesh` (parallel.mesh.Mesh)
    shards the native shard runner's device work over its devices.
    `shard_filter(global_shard_idx) -> bool` keeps a subset of the shards;
    `collect`, if given, receives the per-shard variant DBs as
    collect["shard_dbs"] = [(global_shard_idx, VariantDB.db), ...] in
    place of the merge, and the run returns "" (the caller merges in
    global shard order, as parallel.multihost does across processes)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    dev = resolve_device(device) if engine == "batched" else None
    if stats is None:
        stats = {}
    t_start = time.perf_counter()
    fasta = open_fasta(cfg.ref_fasta)
    tumor = open_bam(cfg.tumor_bam)
    normal = open_bam(cfg.normal_bam)

    # MD-tag availability check disables active regions like the reference
    # (Lancet.cc:817-825): probe the first record of each BAM.
    cfg_eff = cfg
    if cfg.active_regions:
        def first_has_md(rdr):
            al = rdr.first_record()
            return True if al is None else "MD" in al.tags
        if not (first_has_md(tumor) or first_has_md(normal)):
            cfg_eff = dataclasses.replace(cfg, active_regions=False)

    windows = generate_windows(fasta, _regions(cfg), fasta.lengths,
                               cfg.window_size, cfg.padding)
    shards = shard_windows(windows, cfg.num_threads)
    # the multi-process fan-out: the same global shard list in every
    # process, this process's subset kept (README.md:70-88 of the
    # reference: a qsub job per region chunk and a merge)
    shard_ids = list(range(len(shards)))
    if shard_filter is not None:
        shard_ids = [i for i in shard_ids if shard_filter(i)]
        shards = [shards[i] for i in shard_ids]
        windows = [w for s in shards for w in s]

    if cfg.print_config_file:
        # reference writes config.txt in the working directory
        # (Lancet.cc:829-834, 118-185)
        with open("config.txt", "w") as f:
            f.write(print_configuration(cfg_eff))

    resume_state = [None] * len(shards)
    if cfg.resume_dir:
        from .checkpoint import load_resume_state

        os.makedirs(cfg.resume_dir, exist_ok=True)
        resume_state = load_resume_state(cfg.resume_dir, shard_ids)

    all_times: list = []
    native = None  # (per-shard VariantDBs in shard order, counters)
    if (engine == "batched" and not cfg.kmer_recovery and not cfg.print_graph
            and not os.environ.get("LANCET_TPU_NO_SHARDRUN")):
        native = _run_native(cfg, cfg_eff, shards, shard_ids, resume_state,
                             tumor, normal, dev, stats, all_times, mesh)
    if native is not None:
        per_shard, counters = native
    elif cfg.num_threads > 1 and processes:
        per_shard, counters = [], []
        for vdb, times, ctr in _run_pool(cfg, cfg_eff, engine, windows,
                                         shards, shard_ids, resume_state,
                                         dev, stats):
            per_shard.append(vdb)
            all_times.extend(times)
            counters.append(ctr)
    else:
        per_shard, counters = [], []
        for i, shard in enumerate(shards):
            ma = Microassembler(cfg_eff, readers=(tumor, normal),
                                engine=engine, device=dev)
            _process_shard(ma, cfg_eff, shard, shard_ids[i], resume_state[i])
            per_shard.append(ma.vdb)
            all_times.extend(ma.window_times)
            counters.append(ma.counters)

    if cfg.trace_file:
        with open(cfg.trace_file, "w") as f:
            for name, ms, nreads in all_times:
                f.write(json.dumps({"window": name, "ms": round(ms, 3),
                                    "reads": nreads}) + "\n")

    _print_summary(counters, len(windows))

    stats["t_total"] = time.perf_counter() - t_start
    stats["n_windows"] = len(windows)

    if collect is not None:
        collect.setdefault("shard_dbs", []).extend(
            (si, vdb.db) for si, vdb in zip(shard_ids, per_shard))
        collect["lr_mode"] = cfg.lr_mode
        return ""

    merged = VariantDB(cfg.lr_mode)
    for vdb in per_shard:
        merged.merge_from(vdb)
    if date is None:
        date = time.asctime() + "\n"
    t0 = time.perf_counter()
    vcf = merged.to_vcf(LANCET_VERSION, cfg.ref_fasta, date, cfg.filters,
                        normal.sample_name(), tumor.sample_name(),
                        command_line)
    # FET/SB Fisher scoring + filters + text render, per PASS candidate
    stats["t_render"] = time.perf_counter() - t0
    return vcf
