#!/usr/bin/env python3
"""What compress_round's time is made of, on one card.

    python3 compress_split.py

Captures the compress_round call with the most alive items at each item
axis (the engine's un-compacted NI 1,552 and compact NI 528, as
chip_smoke.py keeps them) of device-graph case 1 and of the hard corpus's
device graph run, then on each:

- the plain version (gpu/stages.py::compress_round_plain) on the card,
  stage by stage, in turns (the whole call, then edge_renorm, links and
  chain_jump on the call's own inputs, PLAIN_TURNS times): each stage's
  host time (perf_counter around the call and a synchronize), its device
  time and device events (torch.profiler), and the aten ops it dispatches;
  the merge, the mers, the edges and the aggregates are the whole call less
  the three;
- the kernel (csrc/compress.cu) built with -DCOMPRESS_STAMPS into build/
  (`stamped()`), which writes each block's clock64() at its start and at
  the end of each of its steps (PHASES: rank 0's links, jumping, merge,
  the items' order, their aggregates' gather, scan, start_off and the
  item outputs; a worker's edge keys, the edges' owner's slots, the edge
  outputs, the mers' keys, the mers' owner's order by counting and kept
  intervals, the mers' new_pos (mer_out), and the owner's sort where
  counting cannot order (mer_check); every rank's end; every
  rank's exit from the cluster's first barrier and from the one after
  start_off, sync0 and sync4), at the
  plan's cluster size: for each rank, per step the cycles since the
  rank's previous stamp (a barrier's wait counts in the step after it;
  clock64 is an SM's own counter, so ranks are not compared stamp to
  stamp), of the median and of the slowest window, in microseconds at
  the SM's maximum clock (nvidia-smi), and the rank's cycles from start
  to end; its outputs held equal to the plain version's; the kernel's
  own device time (torch.profiler, chip_smoke.device_ms), the library's
  build and the stamped one;
- the stamped kernel's SASS (cuobjdump) cut at its clock reads: for each
  stretch between two reads, in code order, the count of its local
  memory, shared memory, global memory, shuffle, atomic and barrier
  instructions (a stretch the phases share, such as the aggregates' pass
  for each lane count, appears once for each copy the compiler made).

Prints one JSON line a call, the card's name and power limit, and a last
line {"ok": true}; exits non-zero on a mismatch or without a card.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PLAIN_TURNS = 5
# csrc/compress_body.cuh's Phase, after kStart
PHASES = ("links", "jump", "merge", "item_order", "item_gather",
          "item_scan", "item_start_off", "item_out", "mer_keys",
          "mer_order", "mer_check", "mer_out", "edge_keys", "edge_slots",
          "edge_out", "end", "sync0", "sync4")
MAX_C = 4  # ranks a window's stamps hold (kMaxC)


def _device(fn) -> dict:
    """One call of fn under torch.profiler: the device time (ms) and count
    of its device events, from the profile's raw events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return {"device_ms": sum(ev) / 1e6, "device_events": len(ev)}


def _host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def plain_split(args, kw) -> dict:
    """The plain version's stages on the card, in turns."""
    import chip_smoke as cs
    from lancet_tpu_torch.gpu import stages

    st, K, NI, N = args[:4]
    stage = {
        "whole": lambda: cs.compress_plain(*args, **kw),
        "edge_renorm": lambda: stages.edge_renorm(
            st["e_src"], st["e_okey"], st["e_alive"], NI),
        "links": lambda: stages.links(
            st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
            st["e_okey"], st["alive"], st["special"], NI),
    }
    lnk = stage["links"]()
    stage["chain_jump"] = lambda: stages.chain_jump(lnk, NI)
    host = {k: [] for k in stage}
    for _ in range(PLAIN_TURNS):
        for k, fn in stage.items():
            host[k].append(_host_ms(fn))
    out = {}
    for k, fn in stage.items():
        out[k] = {"host_ms": statistics.median(host[k]),
                  "host_ms_spread": [min(host[k]), max(host[k])],
                  "aten_ops": cs.aten_ops(fn), **_device(fn)}
    rest = {m: out["whole"][m] - sum(out[k][m] for k in (
        "edge_renorm", "links", "chain_jump"))
        for m in ("host_ms", "aten_ops", "device_ms", "device_events")}
    out["merge_mers_edges_aggregates"] = rest
    return out


def stamped():
    """csrc/compress.cu built with -DCOMPRESS_STAMPS into build/: (its
    path, the library loaded, with compress_set_stamps and
    compress_phases declared)."""
    import ctypes

    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu import compress
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    so = build_shared(compress._SRC, "libcompress_stamps",
                      [_nvcc()] + NVCC_FLAGS + ["-DCOMPRESS_STAMPS",
                                                compress._SRC])
    lib = compress.bind(so)
    lib.compress_set_stamps.restype = None
    lib.compress_set_stamps.argtypes = [ctypes.c_void_p]
    lib.compress_phases.restype = ctypes.c_int
    return so, lib


def kernel_split(args, kw, clock_hz: float, lib) -> dict:
    """The kernel's steps by its blocks' clock64() stamps (`lib`, the
    stamped build), rank by rank."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import compress

    st, K, NI, N = args[:4]
    Dcap = kw.get("Dcap", args[4] if len(args) > 4 else 64)
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    plan = compress.plan_for(W, NI, EE, NM, st["alive"].device, lib)
    stamps = torch.zeros((W, MAX_C, lib.compress_phases()),
                         dtype=torch.int64, device="cuda")
    lib.compress_set_stamps(stamps.data_ptr())
    outs, fb = compress._launch(st, K, NI, N, Dcap, lib=lib)
    torch.cuda.synchronize()
    got = ({k: o for k, o in zip(compress.OUTPUT_KEYS, outs)}, fb)
    bad = cs.dtype_mismatches(got, cs.compress_plain(*args, **kw))
    sv = stamps.cpu().tolist()
    ranks = {}
    for r in range(plan.C):
        steps: dict = {}
        tot = []
        for w in range(W):
            row = sv[w][r]
            ran = sorted((t, j) for j, t in enumerate(row) if j and t)
            prev = row[0]
            for t, j in ran:
                steps.setdefault(PHASES[j - 1], []).append(t - prev)
                prev = t
            tot.append(row[1 + PHASES.index("end")] - row[0])
        ranks[r] = {
            "steps": {n: {"median_cycles": statistics.median(c),
                          "max_cycles": max(c),
                          "median_us": statistics.median(c) / clock_hz
                          * 1e6} for n, c in steps.items()},
            "cycles": {"median": statistics.median(tot), "max": max(tot)}}
    return {"mismatches": bad, "cluster": plan.C, "ranks": ranks,
            "device_ms": cs.device_ms(
                lambda: compress.compress_round(*args, **kw),
                "compress_kernel"),
            "stamped_device_ms": cs.device_ms(
                lambda: compress._launch(st, K, NI, N, Dcap, lib=lib),
                "compress_kernel")}


SASS_OPS = ("LDL", "STL", "LDS", "STS", "LDG", "STG", "SHFL", "ATOMS",
            "BAR")


def sass_stretches(so: str) -> list:
    """The stamped build's (`so`) SASS instruction counts between clock
    reads."""
    import shutil
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return [{"not_measured": "no cuobjdump"}]
    text = subprocess.run([tool, "-sass", so],
                          capture_output=True, text=True).stdout
    body, on = [], False
    for ln in text.splitlines():
        if "Function :" in ln:
            on = "compress_kernel" in ln
        elif on:
            body.append(ln)
    out, cur = [], {}
    for ln in body:
        if "SR_CLOCKLO" in ln:
            out.append(cur)
            cur = {}
            continue
        op = ln.split("*/")[1].strip() if "*/" in ln else ""
        for name in SASS_OPS:
            if op.split(" ")[0].lstrip("@!P0123456789 ").startswith(name) \
                    or f" {name}" in op[:40]:
                cur[name] = cur.get(name, 0) + 1
                break
        if op:
            cur["all"] = cur.get("all", 0) + 1
    out.append(cur)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: compress_split.py needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lancet_tpu_torch import corpus

    clock_hz, clock_txt = cs.sm_clock_hz()
    so, lib = stamped()
    workdir = os.path.join(HERE, "build", "smoke_corpus")
    corpus.write_default_corpus(workdir)
    hdir = os.path.join(HERE, "build", "smoke_hard")
    os.makedirs(hdir, exist_ok=True)
    refseq, tumor, normal, hregion = corpus.hard_corpus()
    corpus.write_pair(hdir, refseq, "chr1", tumor, normal)
    ok = True
    for case, wd, region in (("devgraph_case_1", workdir,
                              cs.DEVGRAPH_REGION), ("hard", hdir, hregion)):
        kept: dict = {}
        with cs.instrument_devgraph(kept, None):
            cs.run_devgraph(wd, region, {})
        torch.cuda.synchronize()
        for key in sorted(k for k in kept if k.startswith("compress_round")):
            _, args, kw = kept[key]
            acc = cs.compress_accounting(args)
            ks = kernel_split(args, kw, clock_hz, lib)
            ok &= ks["mismatches"] == 0
            print(json.dumps({
                "case": case, "call": key, "W": acc["W"], "NI": acc["NI"],
                "EE": acc["EE"], "NM": acc["NM"],
                "rounds_max": acc["chain_units"], "bytes": acc["bytes"],
                "sm_clock_max": clock_txt, "plain": plain_split(args, kw),
                "kernel": ks}), flush=True)
    print(json.dumps({"sass_stretches": sass_stretches(so)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
