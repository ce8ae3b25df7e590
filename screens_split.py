#!/usr/bin/env python3
"""What the screens' device time is made of, on one card.

    python3 screens_split.py [--parent DIR]

Captures the tandem_at and cycle_screen call with the most work (as
chip_smoke.py keeps it) of device-graph cases 1 and 2 and of the hard
corpus's device graph run, then:

- this tree's csrc/screens.cu, copied under build/screens_split/ with
  clock64() stamps at each phase's end (text insertions at fixed anchors of
  the source; the script fails if an anchor is gone), launched once on
  each call: per block of cycle_screen the cycles of the item pass, the
  edge pass, the rounds (and their count and the list's length) and the
  flags; per probed string (warp) of tandem_at the cycles of its lens
  load, its staging, its prefix sums, its unit lengths' passes and the
  vote. It prints the median over the blocks or strings and the slowest.
- this tree's cycle_screen copied to stage only, each window split over
  k = 1, 2 and 4 blocks (a block stages every k-th batch of the window's
  edges and items into its own shared memory and returns): the device
  time of the staging on k SMs a window, the most a thread block cluster
  a window could save there (a cluster would still merge the parts into
  one SM's list).
- with --parent DIR (DIR holding a parent commit's
  lancet_tpu_torch/csrc/screens.cu, from git archive; the anchors are
  those of the screens' first designs, a thread a string and a block a
  window with two loops in turn), copied with one phase cut each (the kernel
  returning at once, after its staging, after staging and prefix sums, or
  without a loop), each copy timed by its own device time (torch.profiler)
  in turns on the same calls; the phases' times are the differences.

The copies' outputs are not the screens' (the stamped copy is, the cut
ones are not): the copies are measurement only, never loaded by the port.
Prints one JSON line a call and copy, the card's name and power limit, and
a last line {"ok": true}; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "screens_split")

# the stamped copy: a device pointer to a buffer of int64 (set once by
# set_dbg), cycle_screen's blocks at [0, 512) 8 a block, tandem_at's
# probed strings at [512, 1024) 8 a string (a slot taken by an atomic at
# 1024)
GLOBALS = r'''
__device__ long long* g_dbg;
__global__ void set_dbg_k(long long* p) { g_dbg = p; }
extern "C" int set_dbg(void* p, void* stream) {
  set_dbg_k<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(p));
  return static_cast<int>(cudaGetLastError());
}
'''
STAMPS = (
    ("#include <cstdint>\n", "#include <cstdint>\n" + GLOBALS),
    # cycle_screen
    ("  const size_t we = static_cast<size_t>(blockIdx.x) * EE;\n",
     "  const size_t we = static_cast<size_t>(blockIdx.x) * EE;\n"
     "  long long t0 = clock64();\n  int n_rounds = 0;\n"),
    ("slot_of(comp[wi + v]));\n  __syncthreads();\n",
     "slot_of(comp[wi + v]));\n  __syncthreads();\n"
     "  long long t1 = clock64();\n"),
    ("at_r] = word;\n    }\n  }\n  __syncthreads();\n",
     "at_r] = word;\n    }\n  }\n  __syncthreads();\n"
     "  long long t2 = clock64();\n"),
    ("      int ch = step(w, kind, k);\n",
     "      int ch = step(w, kind, k);\n      ++n_rounds;\n"),
    ("      if (!sync_or(R, ch)) break;\n    }\n  }\n  __syncthreads();\n",
     "      if (!sync_or(R, ch)) break;\n    }\n  }\n  __syncthreads();\n"
     "  long long t3 = clock64();\n"),
    ("        flagged[c + 1] || (unconv && present[c + 1]);\n}",
     "        flagged[c + 1] || (unconv && present[c + 1]);\n"
     "  long long t4 = clock64();\n"
     "  if (tid == 0 && blockIdx.x < 64) {\n"
     "    long long* q = g_dbg + blockIdx.x * 8;\n"
     "    q[0] = t1 - t0; q[1] = t2 - t1; q[2] = t3 - t2; q[3] = t4 - t3;\n"
     "    q[4] = n_rounds; q[5] = nl; q[6] = R; q[7] = t4 - t0;\n  }\n}"),
    # tandem_at
    ("  const long long n = lens[row];\n",
     "  long long t0 = clock64();\n  const long long n = lens[row];\n"),
    ("    return;\n  }\n  // g[x]: the base at x",
     "    return;\n  }\n  long long t1 = clock64();\n"
     "  // g[x]: the base at x"),
    ("                    : static_cast<int64_t>(100 + x % 50);\n"
     "  __syncwarp();\n",
     "                    : static_cast<int64_t>(100 + x % 50);\n"
     "  __syncwarp();\n  long long t2 = clock64();\n"),
    ("      before[ml - 1] += __popc(bits);\n    }\n  }\n  __syncwarp();\n",
     "      before[ml - 1] += __popc(bits);\n    }\n  }\n  __syncwarp();\n"
     "  long long t3 = clock64();\n"),
    ("  const bool ans = __any_sync(kFull, hit);\n"
     "  if (lane == 0) out[row] = ans;\n",
     "  long long t4 = clock64();\n"
     "  const bool ans = __any_sync(kFull, hit);\n"
     "  if (lane == 0) out[row] = ans;\n"
     "  long long t5 = clock64();\n"
     "  if (lane == 0) {\n"
     "    const unsigned long long slot = atomicAdd(\n"
     "        reinterpret_cast<unsigned long long*>(g_dbg + 1024), 1ull);\n"
     "    if (slot < 64) {\n"
     "      long long* q = g_dbg + 512 + slot * 8;\n"
     "      q[0] = t1 - t0; q[1] = t2 - t1; q[2] = t3 - t2; q[3] = t4 - t3;\n"
     "      q[4] = t5 - t4; q[5] = n; q[6] = row; q[7] = t5 - t0;\n"
     "    }\n  }\n"),
)
STAMP_COLS = {
    "cycle_screen": ("items", "edges", "rounds", "flags", "n_rounds",
                     "list_edges", "round_threads", "total"),
    "tandem_at": ("lens", "stage", "prefix", "unit_lengths", "vote", "n",
                  "row", "total")}

# the parent's copies with one phase cut (anchors of the first designs'
# csrc/screens.cu): {screen: {copy: [(text, replacement)]}}
CUTS = {
    "cycle_screen": {
        "launch_only": [("  const int NS = 2 * NI;\n  unsigned char* p = "
                         "smem;", "  if (blockDim.x) return;\n  const int "
                         "NS = 2 * NI;\n  unsigned char* p = smem;")],
        "staging": [("  // reach: Jacobi rounds, ra the old buffer",
                     "  if (blockDim.x) {\n    if (tid < Cmax)\n"
                     "      out[blockIdx.x * static_cast<size_t>(Cmax) + tid]"
                     " =\n          (ew[0] ^ ef[0] ^ indeg[0] ^ live[0]) & 1;"
                     "\n    return;\n  }\n"
                     "  // reach: Jacobi rounds, ra the old buffer")],
        "staging_reach_flags": [
            ("  for (int r = 0; r < T; ++r) {\n    int any = 0;",
             "  for (int r = 0; r < 0; ++r) {\n    int any = 0;")],
        "staging_peel_flags": [
            ("for (int r = 0; r < T && unconv; ++r) {",
             "for (int r = 0; r < 0 && unconv; ++r) {")],
        "no_comp_read": [("    const int64_t c = comp[wi + v];",
                          "    const int64_t c = (v & 7) + 1;")]},
    "tandem_at": {
        "launch_only": [("  const int S = tandem_stride(L);\n  int64_t* eff",
                         "  if (blockDim.x) return;\n"
                         "  const int S = tandem_stride(L);\n  int64_t* eff")],
        "staging": [("  if (r >= rows) return;  // no barrier below\n",
                     "  if (r >= rows) return;  // no barrier below\n"
                     "  if (blockDim.x) {\n    out[r0 + r] = eff[r * S] & 1;"
                     "\n    return;\n  }\n")],
        "staging_prefix": [
            ("  const int last = n < L ? static_cast<int>(n) : L;",
             "  const int last = (kMl > 0 && cs[L] == -7) ? 1 : 0;")],
        "staging_scan": [
            ("  for (int ml = 1; ml < MU; ++ml) {\n    int* c = cs",
             "  for (int ml = 1; ml < 1; ++ml) {\n    int* c = cs")]},
}
KERNELS = {"tandem_at": "tandem_kernel", "cycle_screen": "cycle_screen_kernel"}
SPLITS = (1, 2, 4)  # blocks a window of the staging-only copies


def split_staging(k: int):
    """The text edits of the staging-only copy with k blocks a window."""
    return (
        ("__global__ void __launch_bounds__(kScreenThreads) cycle_screen_"
         "kernel(", f"constexpr int kSplit = {k};\n\n__global__ void "
         "__launch_bounds__(kScreenThreads) cycle_screen_kernel("),
        ("  const size_t wi = static_cast<size_t>(blockIdx.x) * NI;\n"
         "  const size_t we = static_cast<size_t>(blockIdx.x) * EE;\n",
         "  const int part = blockIdx.x % kSplit, win = blockIdx.x / kSplit;\n"
         "  const size_t wi = static_cast<size_t>(win) * NI;\n"
         "  const size_t we = static_cast<size_t>(win) * EE;\n"),
        ("  uint32_t word = load(tid);\n"
         "  const uint8_t f0 = tid < NI ? flags(tid) : 0;\n"
         "  const uint16_t c0 = slot_of(tid < NI ? comp[wi + tid] : 0);\n",
         "  const int v0 = part * nt + tid;\n"
         "  uint32_t word = load(v0);\n"
         "  const uint8_t f0 = v0 < NI ? flags(v0) : 0;\n"
         "  const uint16_t c0 = slot_of(v0 < NI ? comp[wi + v0] : 0);\n"),
        ("  if (tid < NI) item(tid, f0, c0);\n"
         "  for (int v = tid + nt; v < NI; v += nt)\n",
         "  if (v0 < NI) item(v0, f0, c0);\n"
         "  for (int v = v0 + kSplit * nt; v < NI; v += kSplit * nt)\n"),
        ("  for (int base = 0; base < EE; base += nt) {  // the same trips a "
         "warp\n    if (base > 0) word = load(base + tid);\n",
         "  for (int base = part * nt; base < EE; base += kSplit * nt) {\n"
         "    if (base > part * nt) word = load(base + tid);\n"),
        ("at_r] = word;\n    }\n  }\n  __syncthreads();\n",
         "at_r] = word;\n    }\n  }\n  __syncthreads();\n"
         "  if (blockDim.x) {\n    if (tid == 0 && part == 0 && Cmax > 0)\n"
         "      out[win * static_cast<size_t>(Cmax)] = count[0] & 1;\n"
         "    return;\n  }\n"),
        ("cycle_screen_kernel<<<W, kScreenThreads, smem,",
         "cycle_screen_kernel<<<W * kSplit, kScreenThreads, smem,"))


def _edit(src: str, subs) -> str:
    for a, b in subs:
        if src.count(a) != 1:
            raise SystemExit(f"screens_split.py: anchor not found once in "
                             f"the source: {a[:60]!r}")
        src = src.replace(a, b)
    return src


def _build(name: str, src: str) -> ctypes.CDLL:
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(OUT, f"{name}.so")
    r = subprocess.run([_nvcc()] + NVCC_FLAGS + [path, "-o", so],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll, sz = ctypes.c_longlong, ctypes.c_size_t
    lib.tandem_at.restype = lib.cycle_screen.restype = ci
    lib.tandem_at.argtypes = [vp] * 3 + [ci] * 3 + [ll] * 4 + [sz, vp]
    lib.cycle_screen.argtypes = [vp] * 8 + [ci] * 6 + [sz, vp]
    return lib


def capture() -> dict:
    """{case: {screen: (args, kw)}}: each run's screen call with the most
    work, its inputs on the card."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch import corpus

    workdir = os.path.join(HERE, "build", "smoke_corpus")
    corpus.write_default_corpus(workdir)
    advdir = os.path.join(HERE, "build", "smoke_adversarial")
    os.makedirs(advdir, exist_ok=True)
    refseq, tumor, normal, adv_region = corpus.adversarial_corpus()
    corpus.write_pair(advdir, refseq, "chr1", tumor, normal)
    hdir = os.path.join(HERE, "build", "smoke_hard")
    os.makedirs(hdir, exist_ok=True)
    refseq, tumor, normal, hregion = corpus.hard_corpus()
    corpus.write_pair(hdir, refseq, "chr1", tumor, normal)
    out = {}
    for case, wd, region, threads in (
            ("devgraph_case_1", workdir, cs.DEVGRAPH_REGION, 8),
            ("devgraph_case_2", advdir, adv_region, 2),
            ("hard", hdir, hregion, 8)):
        kept: dict = {}
        with cs.instrument_devgraph(kept, None):
            cs.run_devgraph(wd, region, {}, num_threads=threads)
        torch.cuda.synchronize()
        out[case] = {n: (kept[n][1], kept[n][2]) for n in KERNELS
                     if n in kept}
    return out


def stamped(calls: dict, src: str) -> list:
    """The stamped copy of this tree's kernels on each captured call."""
    import torch

    import chip_smoke as cs
    from walks_ab import _screen_launchers

    lib = _build("stamped", _edit(src, STAMPS))
    lib.set_dbg.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dbg = torch.zeros(1025, dtype=torch.int64, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if lib.set_dbg(dbg.data_ptr(), stream) != 0:
        raise RuntimeError("set_dbg failed")
    clock = cs.sm_clock_hz()[0]
    lines = []
    for case, mine in calls.items():
        for name, (args, kw) in mine.items():
            new = _screen_launchers(name, args, kw, None, this_lib=lib)[1]
            new()
            torch.cuda.synchronize()
            dbg.zero_()
            new()
            torch.cuda.synchronize()
            h = dbg.cpu().tolist()
            if name == "cycle_screen":
                rows = [h[8 * w:8 * w + 8]
                        for w in range(min(args[0].shape[0], 64))]
            else:
                rows = [h[512 + 8 * k:520 + 8 * k]
                        for k in range(min(h[1024], 64))]
            cols = STAMP_COLS[name]
            lines.append({
                "split": name, "case": case, "source": "this tree, stamped",
                "units": "cycles", "sm_clock_hz": clock,
                "blocks_or_strings": len(rows),
                "median": {c: statistics.median(r[i] for r in rows)
                           for i, c in enumerate(cols)} if rows else None,
                "slowest": dict(zip(cols, max(rows, key=lambda r: r[-1])))
                if rows else None})
    return lines


def staging_splits(calls: dict, src: str) -> list:
    """This tree's cycle_screen staging alone, a window over k blocks, the
    copies timed in turns by their own device time."""
    import chip_smoke as cs
    from walks_ab import _screen_launchers

    libs = {k: _build(f"staging_split{k}", _edit(src, split_staging(k)))
            for k in SPLITS}
    lines = []
    for case, mine in calls.items():
        if "cycle_screen" not in mine:
            continue
        args, kw = mine["cycle_screen"]
        fns = {k: _screen_launchers("cycle_screen", args, kw, None,
                                    this_lib=lib)[1]
               for k, lib in libs.items()}
        times: dict = {k: [] for k in SPLITS}
        order = list(SPLITS)
        for turn in range(4):
            for k in (order if turn % 2 == 0 else order[::-1]):
                times[k].append(cs.device_ms(fns[k], KERNELS["cycle_screen"],
                                             20))
        lines.append({"split": "cycle_screen", "case": case,
                      "source": "this tree, staging only, k blocks a window",
                      "device_ms": {str(k): statistics.median(t)
                                    for k, t in times.items()}})
    return lines


def cuts(calls: dict, parent: str) -> list:
    """The parent's kernels with one phase cut each, timed in turns."""
    import chip_smoke as cs
    from walks_ab import _screen_launchers

    with open(os.path.join(os.path.abspath(parent), "lancet_tpu_torch",
                           "csrc", "screens.cu")) as f:
        src = f.read()
    libs = {"parent": _build("parent", src)}
    for name, copies in CUTS.items():
        for copy, subs in copies.items():
            libs[f"{name}/{copy}"] = _build(f"{name}_{copy}",
                                            _edit(src, subs))
    lines = []
    for case, mine in calls.items():
        for name, (args, kw) in mine.items():
            arms = ["parent"] + [f"{name}/{c}" for c in CUTS[name]]
            fns = {a: _screen_launchers(name, args, kw, libs[a])[0]
                   for a in arms}
            times: dict = {a: [] for a in arms}
            for turn in range(4):
                for a in (arms if turn % 2 == 0 else arms[::-1]):
                    times[a].append(cs.device_ms(fns[a], KERNELS[name], 20))
            lines.append({"split": name, "case": case,
                          "source": "parent, one phase cut a copy",
                          "device_ms": {a: statistics.median(t)
                                        for a, t in times.items()}})
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a directory holding a parent commit's "
                                     "lancet_tpu_torch/csrc/screens.cu")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: screens_split.py needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    calls = capture()
    with open(os.path.join(HERE, "lancet_tpu_torch", "csrc",
                           "screens.cu")) as f:
        src = f.read()
    lines = stamped(calls, src) + staging_splits(calls, src)
    if a.parent:
        lines += cuts(calls, a.parent)
    for line in lines:
        print(json.dumps(line), flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
