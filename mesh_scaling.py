#!/usr/bin/env python3
"""Times of lancet_tpu_torch's mesh over the cards of one machine.

    python3 mesh_scaling.py

Uses every visible card (run it on a machine with four to see the mesh
over four cards; on one card it times entries of cuda:0 only). Prints one
JSON line a case and a summary line last; exits non-zero on a failure.

  1. device: the cards' names and power limits (nvidia-smi);
  2. main: the default corpus (5,195 windows, 8 threads) unsharded and over
     make_mesh() (every card), alternating in the order AB_ORDER: t_total,
     windows/s and the DP's send and wait time of every run; every VCF equal
     to the first unsharded run's;
  3. devgraph: the device graph engine (LANCET_TPU_DEVGRAPH=1) on
     chr1:300-120000 (1,198 windows), unsharded, over make_mesh(2) and
     make_mesh(4) where the cards are there, over 4 entries of cuda:0, and
     over the largest mesh with W scaled to 32 windows a shard; the cases in
     order, then reversed. Per run: t_devgraph and its t_dg_* parts, and the
     shard calls' clocks: the calls of gpu.dbg.build_k and of the attempt
     tail (devicepipe._assemble), each with its thread's CPU seconds
     (time.thread_time) and its wall seconds, summed over shards. The VCF,
     summary and device-graph stats equal the unsharded run's;
  4. profile: one more devgraph run of the unsharded case and of the
     largest mesh under torch.profiler: the CUDA runtime calls the host made
     (kernel launches, copies, synchronizations), counted over every thread,
     and each card's busy milliseconds (the sum of its kernel and copy
     intervals).
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

AB_ORDER = ("off", "on", "on", "off", "off", "on")  # off: unsharded
W_DEFAULT = 32
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync",
                 "cudaStreamSynchronize", "cudaEventSynchronize",
                 "cudaDeviceSynchronize", "cudaEventRecord",
                 "cudaStreamWaitEvent")


@contextlib.contextmanager
def shard_clock(acc: dict):
    """While active: add every build_k and attempt-tail call's thread CPU
    seconds, wall seconds and count into `acc` (shard threads included)."""
    from lancet_tpu_torch.engine import devicepipe
    from lancet_tpu_torch.gpu import dbg

    lock = threading.Lock()
    real = {"build": (dbg, "build_k"), "tail": (devicepipe, "_assemble")}
    saved = {k: getattr(m, n) for k, (m, n) in real.items()}

    def timed(key, fn):
        @functools.wraps(fn)
        def f(*a, **k):
            c0, w0 = time.thread_time(), time.perf_counter()
            out = fn(*a, **k)
            c, w = time.thread_time() - c0, time.perf_counter() - w0
            with lock:
                for suffix, v in (("_cpu", c), ("_wall", w), ("_calls", 1)):
                    acc[key + suffix] = acc.get(key + suffix, 0) + v
            return out
        return f

    for key, (m, n) in real.items():
        setattr(m, n, timed(key, saved[key]))
    try:
        yield
    finally:
        for key, (m, n) in real.items():
            setattr(m, n, saved[key])


@contextlib.contextmanager
def chunk_width(W: int):
    """While active: the device graph engine packs W windows a chunk."""
    from lancet_tpu_torch.engine import devicepipe

    real = devicepipe.run_device_graph
    devicepipe.run_device_graph = functools.partial(real, W=W)
    try:
        yield
    finally:
        devicepipe.run_device_graph = real


def runtime_profile(fn) -> dict:
    """fn() under torch.profiler: CUDA runtime calls by name over every
    thread, and each card's busy ms (kernel and copy intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    calls = {k: 0 for k in RUNTIME_CALLS}
    busy: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) \
                + e.time_range.elapsed_us() / 1e3
        elif e.name in calls:
            calls[e.name] += 1
    return {"runtime_calls": calls,
            "busy_ms_by_card": {str(k): v for k, v in sorted(busy.items())}}


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from lancet_tpu_torch import corpus
    from lancet_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    smi = cs.nvidia_smi()
    cs.emit({"phase": "device", "count": count, "nvidia_smi": smi,
             "torch": torch.__version__})
    secs, _, _ = cs.build_all()
    workdir = os.path.join(HERE, "build", "smoke_corpus")
    region = corpus.write_default_corpus(workdir)
    cs.emit({"phase": "build", "seconds": secs})

    # 2. main path, unsharded against every card
    every = make_mesh()
    vcf0 = None
    runs = {"off": [], "on": []}
    for arm in AB_ORDER:
        st: dict = {}
        v, _ = cs.run_captured(workdir, region, st, device="cuda",
                               mesh=every if arm == "on" else None)
        vcf0 = v if vcf0 is None else vcf0
        if v != vcf0:
            raise AssertionError(f"main path {arm}: the VCF differs")
        runs[arm].append({k: st[k] for k in ("t_total", "t_dp_send",
                                             "t_dp_wait")})
    cs.emit({"phase": "main", "mesh": [str(d) for d in every],
             "order": list(AB_ORDER), "runs": runs,
             **{f"median_t_total_{a}": statistics.median(
                 r["t_total"] for r in runs[a]) for a in runs},
             "n_windows": st["n_windows"]})

    # 3. the device graph region
    big = make_mesh(min(count, 4)) if count > 1 else \
        make_mesh(devices=["cuda:0"] * 4)
    cases = [("unsharded", None, W_DEFAULT)]
    cases += [(f"cards_{n}", make_mesh(n), W_DEFAULT) for n in (2, 4)
              if n <= count]
    cases += [("cuda0_x4", make_mesh(devices=["cuda:0"] * 4), W_DEFAULT),
              (f"{'cards' if count > 1 else 'cuda0_x'}{len(big)}_W"
               f"{W_DEFAULT * len(big)}", big, W_DEFAULT * len(big))]
    st_ref: dict = {}
    vcf_g, summ_g = cs.run_devgraph(workdir, cs.DEVGRAPH_REGION, st_ref)
    keys = ("t_total", "t_devgraph", "t_dg_pack", "t_dg_build",
            "t_dg_ranks", "t_dg_assemble", "t_dg_finish", "n_dev_attempts")
    same_keys = ("n_dev_windows", "dev_fallback_causes", "k_histogram")
    res: dict = {name: [] for name, _, _ in cases}
    for name, mesh, W in cases + cases[::-1]:
        st, acc = {}, {}
        with shard_clock(acc), chunk_width(W):
            v, summ = cs.run_devgraph(workdir, cs.DEVGRAPH_REGION, st,
                                      mesh=mesh)
        if v != vcf_g or summ != summ_g or any(st[k] != st_ref[k]
                                               for k in same_keys):
            raise AssertionError(f"devgraph {name}: differs from the "
                                 "unsharded run")
        res[name].append({**{k: st[k] for k in keys}, "shard_calls": acc})
    for name, mesh, W in cases:
        t = [r["t_devgraph"] for r in res[name]]
        cs.emit({"phase": "devgraph", "case": name, "region":
                 cs.DEVGRAPH_REGION, "mesh": [str(d) for d in mesh]
                 if mesh else None, "W": W, "runs": res[name],
                 "t_devgraph": t, "ratio_to_unsharded": statistics.median(t)
                 / statistics.median(r["t_devgraph"]
                                     for r in res["unsharded"])})

    # 4. profiles: unsharded and the largest mesh
    for name, mesh in (("unsharded", None), (f"mesh_{len(big)}", big)):
        st = {}
        prof = runtime_profile(lambda: cs.run_devgraph(
            workdir, cs.DEVGRAPH_REGION, st, mesh=mesh))
        cs.emit({"phase": "profile", "case": name, "mesh": [str(d) for d in
                                                           mesh]
                 if mesh else None, "t_devgraph_profiled": st["t_devgraph"],
                 **prof})
    cs.emit({"phase": "summary", "ok": True, "cards": count,
             "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
