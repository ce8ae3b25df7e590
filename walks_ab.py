#!/usr/bin/env python3
"""A/B of the staged walk kernels against a parent commit's, on one card.

    mkdir -p build/parent
    git archive <parent commit> lancet_tpu_torch/csrc/walks.cu \\
        | tar -x -C build/parent
    python3 walks_ab.py --parent build/parent

Captures every path_cover and cycle_dfs call of chip_smoke.py's two
device-graph cases (the JAX bench's region and the adversarial windows),
builds the parent's csrc/walks.cu beside this tree's, holds the two
kernels bit-equal on every call, and times both, in turns (parent, this,
this, parent, ...), on the largest call of each walk (the call chip_smoke
times), over all of them, and on each crafted case of gpu/walkcases.py:
the kernel's own device time
(torch.profiler's CUDA activity) and CUDA events around back-to-back
launches (which also see the host's time between launches). The parent's
entry points are those of csrc/walks.cu before its kernels staged the
graph: path_cover(13 pointers, 13 ints, stream) and cycle_dfs(7 pointers,
6 ints, stream). Prints one JSON line a walk, the card's name and power
limit, and a last line {"ok": true}; exits non-zero on a mismatch or
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = 8  # timing turns a version, alternating
PER_TURN = 20  # launches a turn


def _build_parent(parent: str) -> ctypes.CDLL:
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    src = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "csrc",
                       "walks.cu")
    lib = ctypes.CDLL(build_shared(src, "libwalks_parent",
                                   [_nvcc()] + NVCC_FLAGS + [src]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.path_cover.restype = lib.cycle_dfs.restype = ci
    lib.path_cover.argtypes = [vp] * 13 + [ci] * 13 + [vp]
    lib.cycle_dfs.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    return lib


def _launchers(name: str, args, kw: dict, parent_lib):
    """(parent launch, this launch, outputs of each) on prepared int32/byte
    inputs and preallocated outputs: only the kernel's launch is timed."""
    import torch

    from lancet_tpu_torch.gpu import walks

    dev = args[0].device
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    lib = walks._load()

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    if name == "path_cover":
        ins = [walks._i32(t) for t in args[:4]] + [
            walks._u8(args[4]), walks._u8(args[5]), walks._i32(args[6]),
            walks._i32(args[7])]
        W, NI, D2 = args[0].shape
        EE = args[1].shape[1]
        J, PN, Q = kw["JMAX"], kw["PN"], kw["Q"]
        ints = [W, NI, D2, EE, kw["K"], kw["N"], kw["Cmax"],
                min(int(kw["dfs_limit"]), 2**31 - 1), int(kw["max_indel"]),
                Q, kw["POPMAX"], J, PN]
        pl = walks.path_cover_plan(NI, D2, EE, Q, PN)
        stage = (torch.empty(W * (NI * D2 * 8 + walks._r16(NI * 4)),
                             dtype=torch.uint8, device=dev)
                 if pl.mode == "global" else None)

        def outs():
            return [torch.empty(s, dtype=torch.int32, device=dev)
                    for s in ((W, J, PN), (W, J), (W, J), (W,))] + [
                torch.empty((W,), dtype=torch.uint8, device=dev)]

        o_par, o_new = outs(), outs()
        p_in = [t.data_ptr() for t in ins]

        def par():
            check(parent_lib.path_cover(
                *p_in, *[t.data_ptr() for t in o_par], *ints, stream))

        def new():
            check(lib.path_cover(
                *p_in, *[t.data_ptr() for t in o_new],
                None if stage is None else stage.data_ptr(), *ints, pl.smem,
                stream))
    else:
        adj, e_dst, e_dir, alive, special, N, Cmax, mask = args
        W, NI, D2 = adj.shape
        EE = e_dst.shape[1]
        if mask is None:
            mask = torch.ones((W, Cmax), dtype=torch.bool, device=dev)
        ins = [walks._i32(adj), walks._i32(e_dst), walks._i32(e_dir),
               walks._u8(alive), walks._u8(special), walks._u8(mask)]
        pl = walks.cycle_dfs_plan(NI, D2, EE, Cmax)
        ent = (torch.empty((W, NI * D2), dtype=torch.int32, device=dev)
               if pl.mode == "global" else None)
        o_par = [torch.empty((W, Cmax), dtype=torch.uint8, device=dev)]
        o_new = [torch.empty((W, Cmax), dtype=torch.uint8, device=dev)]
        p_in = [t.data_ptr() for t in ins]

        def par():
            check(parent_lib.cycle_dfs(*p_in, o_par[0].data_ptr(), W, NI, D2,
                                       EE, N, Cmax, stream))

        def new():
            check(lib.cycle_dfs(*p_in, o_new[0].data_ptr(),
                                None if ent is None else ent.data_ptr(), W,
                                NI, D2, EE, N, Cmax, pl.walkers, pl.smem,
                                stream))
    # the launches hold raw pointers: keep the int32/byte inputs alive
    par.inputs = new.inputs = ins
    return par, new, o_par, o_new, pl


def _spread(ts):
    """chip_smoke.spread of the readings the profiler gave (None where it
    recorded no kernel), with the count of those it missed."""
    import chip_smoke as cs

    got = [t for t in ts if t is not None]
    return dict(cs.spread(got), missed=len(ts) - len(got)) if got else None


def _compare(par, new, o_par, o_new) -> int:
    import torch

    par()
    new()
    torch.cuda.synchronize()
    return sum(int((a != b).sum()) for a, b in zip(o_par, o_new))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding the parent's "
                         "lancet_tpu_torch/csrc/walks.cu")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: walks_ab.py needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lancet_tpu_torch import corpus

    parent_lib = _build_parent(a.parent)
    workdir = os.path.join(HERE, "build", "smoke_corpus")
    corpus.write_default_corpus(workdir)
    advdir = os.path.join(HERE, "build", "smoke_adversarial")
    os.makedirs(advdir, exist_ok=True)
    refseq, tumor, normal, adv_region = corpus.adversarial_corpus()
    corpus.write_pair(advdir, refseq, "chr1", tumor, normal)
    kept: dict = {}
    calls: list = []
    with cs.instrument_devgraph(kept, None, calls):
        cs.run_devgraph(workdir, cs.DEVGRAPH_REGION, {})
        cs.run_devgraph(advdir, adv_region, {}, num_threads=2)
    torch.cuda.synchronize()

    # the crafted cases of gpu/walkcases.py, each call captured the same way
    from lancet_tpu_torch.gpu import walkcases

    crafted: list = []
    with cs.instrument_devgraph(None, None, crafted):
        for case, c in walkcases.cycle_cases().items():
            walkcases.run_cycle(c, "cuda")
            crafted[-1] = crafted[-1] + (case,)
        for case, c in walkcases.path_cover_cases().items():
            walkcases.run_cover(c, "cuda")
            crafted[-1] = crafted[-1] + (case,)
    torch.cuda.synchronize()

    ok = True
    for name, args, kw, _, case in crafted:
        par, new, o_par, o_new, pl = _launchers(name, args, kw, parent_lib)
        mism = _compare(par, new, o_par, o_new)
        dev = {"parent": [], "this": []}
        for turn in range(4):
            order = (("parent", par), ("this", new))
            for ver, fn in (order if turn % 2 == 0 else order[::-1]):
                dev[ver].append(cs.device_ms(fn, cs._KERNEL_NAMES[name], 5))
        print(json.dumps({"walk": name, "crafted_case": case,
                          "shape": list(args[0].shape), "mismatches": mism,
                          "plan": pl._asdict(),
                          "device_ms": {v: _spread(t)
                                        for v, t in dev.items()}}),
              flush=True)
        ok &= mism == 0
    for name in ("path_cover", "cycle_dfs"):
        kernel = cs._KERNEL_NAMES[name]
        mine = [(c[1], c[2]) for c in calls if c[0] == name]
        largest = (kept[name][1], kept[name][2])
        mism = 0
        total = {"parent": [], "this": []}
        for args, kw in mine:
            par, new, o_par, o_new, _ = _launchers(name, args, kw,
                                                   parent_lib)
            mism += _compare(par, new, o_par, o_new) > 0
            for ver, fn in (("parent", par), ("this", new)):
                total[ver].append(cs.device_ms(fn, kernel, 3))
        par, new, o_par, o_new, pl = _launchers(name, *largest, parent_lib)
        mism_largest = _compare(par, new, o_par, o_new)
        dev = {"parent": [], "this": []}
        ev = {"parent": [], "this": []}
        for turn in range(TURNS):
            order = (("parent", par), ("this", new))
            for ver, fn in (order if turn % 2 == 0 else order[::-1]):
                dev[ver].append(cs.device_ms(fn, kernel, PER_TURN))
                ev[ver].extend(cs.cuda_times(fn, 1, PER_TURN))
        line = {
            "walk": name, "calls": len(mine), "calls_mismatched": mism,
            "largest_shape": list(largest[0][0].shape),
            "largest_mismatches": mism_largest, "plan": pl._asdict(),
            "device_ms_largest": {v: _spread(t) for v, t in dev.items()},
            "event_ms_largest": {v: cs.spread(t) for v, t in ev.items()},
            "device_ms_all_calls": {
                v: {"sum": sum(t for t in ts if t is not None),
                    "missed": sum(t is None for t in ts)}
                for v, ts in total.items()},
            "source": "torch.profiler CUDA activity; CUDA events"}
        print(json.dumps(line), flush=True)
        ok &= mism == 0 and mism_largest == 0
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
