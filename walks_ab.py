#!/usr/bin/env python3
"""A/B of three walk kernels against a parent commit's, on one card.

    mkdir -p build/parent
    git archive <parent commit> lancet_tpu_torch/csrc/walks.cu \\
        | tar -x -C build/parent
    python3 walks_ab.py --parent build/parent

Captures every path_cover, almost_repeat_paths and cycle_dfs call of
chip_smoke.py's two device-graph cases (the JAX bench's region and the
adversarial windows), builds the parent's csrc/walks.cu beside this
tree's, holds the two kernels bit-equal on every call, and times both, in
turns (parent, this, this, parent, ...), on the largest call of each walk
(the call chip_smoke times), over all of them, and on each crafted case of
gpu/walkcases.py: the kernel's own device time (torch.profiler's CUDA
activity) and CUDA events around back-to-back launches (which also see the
host's time between launches). The parent's entry points are
path_cover(14 pointers, 13 ints, size_t, stream), cycle_dfs(8 pointers, 7
ints, size_t, stream) and almost_repeat_paths(3 pointers, 4 ints, stream),
the last that of csrc/walks.cu before K3 dealt tiles over a block (its
first design, one thread a shift). It also times, by device time, every
repeat_gates and seq_removal launch of the same two cases (this tree's
kernels only): the sums over their launches and the largest call with its
shape. Prints one JSON line a walk or kernel, the card's name and power
limit, and a last line {"ok": true}; exits non-zero on a mismatch or
without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = 8  # timing turns a version, alternating
PER_TURN = 20  # launches a turn
# K3 also launched at other (blocks a string, threads a block) than its
# plan's (8, 512), on every captured call: one block of 1,024 a string is
# its design before the cluster
K3_SHAPES = ((1, 1024), (2, 1024), (4, 1024), (4, 512))


def _build_parent(parent: str) -> ctypes.CDLL:
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    src = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "csrc",
                       "walks.cu")
    lib = ctypes.CDLL(build_shared(src, "libwalks_parent",
                                   [_nvcc()] + NVCC_FLAGS + [src]))
    vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.path_cover.restype = lib.cycle_dfs.restype = ci
    lib.almost_repeat_paths.restype = ci
    lib.path_cover.argtypes = [vp] * 14 + [ci] * 13 + [sz, vp]
    lib.cycle_dfs.argtypes = [vp] * 8 + [ci] * 7 + [sz, vp]
    lib.almost_repeat_paths.argtypes = [vp] * 3 + [ci] * 4 + [vp]
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
                *p_in, *[t.data_ptr() for t in o_par],
                None if stage is None else stage.data_ptr(), *ints, pl.smem,
                stream))

        def new():
            check(lib.path_cover(
                *p_in, *[t.data_ptr() for t in o_new],
                None if stage is None else stage.data_ptr(), *ints, pl.smem,
                stream))
    elif name == "almost_repeat":
        seq, lens, K, mm = args[0], args[1], int(args[2]), int(args[3])
        W, J, LP = seq.shape
        ins = [walks._u8(seq), walks._i32(lens)]
        pl = walks.almost_repeat_plan(LP, K)
        mm_new = max(min(mm, walks.AR_MAX_K + 1), -1)
        o_par = [torch.empty((W, J), dtype=torch.uint8, device=dev)]
        o_new = [torch.empty((W, J), dtype=torch.uint8, device=dev)]
        p_in = [t.data_ptr() for t in ins]

        def par():
            check(parent_lib.almost_repeat_paths(
                *p_in, o_par[0].data_ptr(), W * J, LP, K, mm, stream))

        def new(blocks=pl.blocks, threads=pl.threads):
            check(lib.almost_repeat_paths(
                *p_in, o_new[0].data_ptr(), W * J, LP, K, mm_new, blocks,
                threads, pl.tile, pl.smem, stream))
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
            check(parent_lib.cycle_dfs(*p_in, o_par[0].data_ptr(),
                                       None if ent is None else
                                       ent.data_ptr(), W, NI, D2, EE, N,
                                       Cmax, pl.walkers, pl.smem, stream))

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


@contextlib.contextmanager
def capture_gates_and_removals(gates: list, removals: list):
    """While active: append (windows, ks, max_mismatch) of every
    repeat_gates call to `gates` and a copy of the inputs of every card
    call of walks.seq_removal to `removals`."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import repeats, walks

    real_g, real_s = repeats.repeat_gates, walks.seq_removal

    def gate(windows, ks, max_mismatch, *a, **k):
        gates.append((list(windows), list(ks), int(max_mismatch)))
        return real_g(windows, ks, max_mismatch, *a, **k)

    def removal(*a, **k):
        if a[0].is_cuda:
            removals.append(cs._tree(list(a), lambda t: t.clone()
                                     if torch.is_tensor(t) else t))
        return real_s(*a, **k)

    repeats.repeat_gates, walks.seq_removal = gate, removal
    try:
        yield
    finally:
        repeats.repeat_gates, walks.seq_removal = real_g, real_s


def time_gates_and_removals(gates: list, removals: list) -> list:
    """Device time (ms, 3 launches each) of every captured repeat_gates
    and seq_removal call: the sum over the calls and the largest call
    (repeat_gates: the most position-steps; seq_removal: the most rank
    slots) with its shape and, for repeat_gates, its bound at
    chip_smoke's hand count of operations."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import repeats, walks

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * cs.ISSUE_LANES_PER_SM_CLK * cs.sm_clock_hz()[0]
    rows = []
    for windows, ks, mm in gates:
        seq, lens = repeats.pack(windows)
        seq_d, lens_d = (torch.from_numpy(a).to(dev) for a in (seq, lens))
        ms = cs.device_ms(lambda: repeats.gates(seq_d, lens_d, ks, mm),
                          "repeat_gates_kernel", 3)
        steps = int(sum(int(n) * (int(n) - 1) // 2 for n in lens))
        nbytes = seq.size + 4 * len(lens) + 4 * len(ks) + 2 * len(lens) * len(
            ks)
        rows.append({"W": seq.shape[0], "L": seq.shape[1], "nk": len(ks),
                     "position_steps": steps, "device_ms": ms,
                     "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S,
                                     cs.GATE_OPS_PER_STEP * steps / rate)
                     * 1e3})
    out = []
    if rows:
        big = max(rows, key=lambda r: r["position_steps"])
        out.append({"kernel": "repeat_gates", "calls": len(rows),
                    "device_ms_sum": sum(r["device_ms"] or 0 for r in rows),
                    "missed": sum(r["device_ms"] is None for r in rows),
                    "bound_ms_sum": sum(r["bound_ms"] for r in rows),
                    "largest": big,
                    "source": "torch.profiler CUDA activity"})
    rrows = []
    for args in removals:
        ms = cs.device_ms(lambda: walks.seq_removal(*args),
                          "seq_removal_kernel", 3)
        rrows.append({"shape": list(args[1].shape),
                      "slots": int((args[0] >= 0).sum()), "device_ms": ms})
    if rrows:
        out.append({"kernel": "seq_removal", "calls": len(rrows),
                    "device_ms_sum": sum(r["device_ms"] or 0
                                         for r in rrows),
                    "missed": sum(r["device_ms"] is None for r in rrows),
                    "largest": max(rrows, key=lambda r: r["slots"]),
                    "source": "torch.profiler CUDA activity"})
    return out


def _compare(par, new, o_par, o_new) -> int:
    import torch

    par()
    new()
    torch.cuda.synchronize()
    return sum(int((a != b).sum()) for a, b in zip(o_par, o_new))


def _kernel(name: str) -> str:
    """The CUDA kernel a captured walk call launches (both trees' kernels
    carry the same names)."""
    import chip_smoke as cs

    return cs._KERNEL_NAMES[cs._WALKS[name]]


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
    gates: list = []
    removals: list = []
    with capture_gates_and_removals(gates, removals), \
            cs.instrument_devgraph(kept, None, calls):
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
        for case, c in walkcases.almost_repeat_cases().items():
            walkcases.run_almost_repeat(c, "cuda")
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
                dev[ver].append(cs.device_ms(fn, _kernel(name), 5))
        print(json.dumps({"walk": name, "crafted_case": case,
                          "shape": list(args[0].shape), "mismatches": mism,
                          "plan": pl._asdict(),
                          "device_ms": {v: _spread(t)
                                        for v, t in dev.items()}}),
              flush=True)
        ok &= mism == 0
    for name in ("path_cover", "almost_repeat", "cycle_dfs"):
        kernel = _kernel(name)
        mine = [(c[1], c[2]) for c in calls if c[0] == name]
        largest = (kept[name][1], kept[name][2])
        mism = 0
        one = name == "almost_repeat"

        def arms(par, new):
            out = [("parent", par), ("this", new)]
            if one:
                out += [(f"blocks{b}_threads{t}",
                         lambda b=b, t=t: new(b, t)) for b, t in K3_SHAPES]
            return out

        total: dict = {}
        for args, kw in mine:
            par, new, o_par, o_new, _ = _launchers(name, args, kw,
                                                   parent_lib)
            for ver, fn in arms(par, new):
                if ver != "parent":
                    mism += _compare(par, fn, o_par, o_new) > 0
                total.setdefault(ver, []).append(cs.device_ms(fn, kernel,
                                                              3))
        par, new, o_par, o_new, pl = _launchers(name, *largest, parent_lib)
        mism_largest = _compare(par, new, o_par, o_new)
        dev = {k: [] for k in total}
        ev = {k: [] for k in total}
        for turn in range(TURNS):
            order = arms(par, new)
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
        if one:  # the largest call's strings: lengths and verdicts
            lens = largest[0][1].reshape(-1)
            line["largest_strings"] = {
                "K": int(largest[0][2]), "nonempty": int((lens > 0).sum()),
                "lens": sorted(lens[lens > 0].tolist(), reverse=True),
                "hits": int(o_new[0].sum())}
        print(json.dumps(line), flush=True)
        ok &= mism == 0 and mism_largest == 0
    for line in time_gates_and_removals(gates, removals):
        print(json.dumps(line), flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
