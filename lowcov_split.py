#!/usr/bin/env python3
"""What low_cov_pass' and item_mincovs' time is made of, on one card.

    python3 lowcov_split.py

Captures the low_cov_pass and item_mincovs calls with the most donating
mers x K of device-graph case 1 and of the hard corpus's device graph run
(chip_smoke.instrument_devgraph keeps them), then launches each through
csrc/graphstate.cu built with -DLOWCOV_STAMPS into build/ (`stamped()`),
whose blocks write their clock64() at their start and at the end of each
step (PHASES: the first items' and edges' loads issued and the minima
filled; the mers; the first cluster barrier; the owners' minima and low
test; the second barrier and the edges, low_cov_pass only; the last
barrier). A step that ends a loop ends on a __syncthreads in that build,
so that it counts the block's slowest warp. For each rank, per step, the
cycles since the rank's previous stamp (a barrier's wait is the step
named after it; clock64 is an SM's own counter, so ranks are not
compared stamp to stamp) of the median window and of the slowest, in
microseconds at the SM's maximum clock (nvidia-smi); the outputs held
equal to the plain version's, dtypes too; the kernel's own device time
(torch.profiler, chip_smoke.device_ms) in the usual build and the
stamped one; and the mers the call donates from, those whose kept
window is wider than graphstate.NARROW (read by a warp), and the widest.

Prints one JSON line a call, the card's name and power limit, and a last
line {"ok": true}; exits non-zero on a mismatch or without a card.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# csrc/graphstate.cu's LowPhase, after kLowStart
PHASES = ("init", "mers", "sync1", "owners", "sync2", "edges", "end")
NAMES = ("low_cov_pass", "item_mincovs")


def stamped():
    """csrc/graphstate.cu built with -DLOWCOV_STAMPS into build/: the
    library loaded, with lowcov_set_stamps and lowcov_phases declared."""
    import ctypes

    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu import graphstate as gs
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    so = build_shared(gs._SRC, "libgraphstate_stamps",
                      [_nvcc()] + NVCC_FLAGS + ["-DLOWCOV_STAMPS", gs._SRC])
    lib = gs.bind(so)
    lib.lowcov_set_stamps.restype = None
    lib.lowcov_set_stamps.argtypes = [ctypes.c_void_p]
    lib.lowcov_phases.restype = ctypes.c_int
    if lib.lowcov_phases() != len(PHASES) + 1:
        raise RuntimeError("lowcov_split.PHASES disagrees with "
                           "csrc/graphstate.cu's LowPhase")
    return lib


def _through(lib, fn):
    """fn() with graphstate's wrappers launching `lib`'s kernels."""
    from lancet_tpu_torch.gpu import graphstate as gs

    gs._load()
    saved, gs._lib = gs._lib, lib
    try:
        return fn()
    finally:
        gs._lib = saved


def _mers(args) -> dict:
    """The call's donating mers, those wider than NARROW, the widest."""
    import torch

    from lancet_tpu_torch.gpu import graphstate as gs

    st, K = args[0], int(args[1])
    lo, hi, f = st["keep_lo"], st["keep_hi"], st["mer_flip"]
    clo = torch.where(f, K - hi, lo).clamp(0, K)
    chi = torch.where(f, K - lo, hi).clamp(0, K)
    wd = torch.where(hi - lo > 0, chi - clo, torch.zeros_like(lo))
    return {"donating": int((hi - lo > 0).sum()),
            "wide": int((wd > gs.NARROW).sum()), "widest": int(wd.max())}


def split(name: str, args, kw, clock_hz: float, lib) -> dict:
    """The kernel's steps by its blocks' clock64() stamps, rank by rank."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import graphstate as gs

    st, K, NI = args[0], int(args[1]), int(args[3])
    W, NM = st["mer_item"].shape
    low = name == "low_cov_pass"
    EE = st["e_src"].shape[1] if low else 0
    plan = gs.lowcov_plan(NI, NM, K, low, EE)
    stamps = torch.zeros((W, gs.MAX_C, lib.lowcov_phases()),
                         dtype=torch.int64, device="cuda")
    lib.lowcov_set_stamps(stamps.data_ptr())

    def call():
        return getattr(gs, name)(*args, **kw)

    got = cs._walk_out(name, _through(lib, call))
    torch.cuda.synchronize()
    bad = cs.dtype_mismatches(got, cs.graphstate_plain(name, args, kw))
    sv = stamps.cpu().tolist()
    ranks = {}
    for r in range(plan.C):
        steps: dict = {}
        tot = []
        for w in range(W):
            row = sv[w][r]
            prev = row[0]
            for j, t in enumerate(row[1:], 1):
                if t:
                    steps.setdefault(PHASES[j - 1], []).append(t - prev)
                    prev = t
            tot.append(row[-1] - row[0])
        ranks[r] = {
            "steps": {n: {"median_cycles": statistics.median(c),
                          "max_cycles": max(c),
                          "median_us": statistics.median(c) / clock_hz
                          * 1e6} for n, c in steps.items()},
            "cycles": {"median": statistics.median(tot), "max": max(tot)}}
    return {"mismatches": bad, "cluster": plan.C, "ranks": ranks,
            "device_ms": cs.device_ms(call, "lowcov_kernel"),
            "stamped_device_ms": cs.device_ms(
                lambda: _through(lib, call), "lowcov_kernel")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: lowcov_split.py needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lancet_tpu_torch import corpus

    clock_hz, clock_txt = cs.sm_clock_hz()
    lib = stamped()
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
        for name in NAMES:
            _, args, kw = kept[name]
            st = args[0]
            ks = split(name, args, kw, clock_hz, lib)
            ok &= ks["mismatches"] == 0
            print(json.dumps({
                "case": case, "call": name, "W": st["mer_item"].shape[0],
                "NI": int(args[3]), "NM": st["mer_item"].shape[1],
                "EE": st["e_src"].shape[1] if "e_src" in st else 0,
                "K": int(args[1]), "mers": _mers(args),
                "sm_clock_max": clock_txt, "kernel": ks}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
