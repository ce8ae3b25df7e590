#!/usr/bin/env python3
"""A/B of three walk kernels and the repeat gates against a parent
commit's, on one card.

    mkdir -p build/parent
    git archive <parent commit> lancet_tpu_torch/csrc/walks.cu \\
        lancet_tpu_torch/csrc/repeats.cu | tar -x -C build/parent
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
seq_removal launch of the same two cases (this tree's kernel only): the
sum over its launches and the largest call with its shape. Prints one
JSON line a walk or kernel, the card's name and power limit, and a last
line {"ok": true}; exits non-zero on a mismatch or without a card.
`--only walks` or `--only gates` times one half (the parent directory then
needs only that half's source).

The repeat gates: the parent's csrc/repeats.cu (repeat_gates(5 pointers,
5 ints, stream), one block a window of plan_threads' threads: its first
design) is built beside this tree's, and the two kernels are held bit-equal
and timed by their own device time, in turns, on every repeat_gates call
of the two device-graph cases, of the eager sweep (the main path with
LANCET_TPU_GATES=1 on the default corpus) and of the two-phase path (all
5,195 default-corpus windows at the 46 ks of the k ladder): per path the
sum over the calls and the largest call (with CUDA events too and the
card's bounds), and each crafted case of gpu/gatecases.py; the largest
device-graph call and the two-phase call also at the GATE_SHAPES launches.
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
# repeat_gates also launched at other (blocks a window, threads a block,
# tile) than its plan's
GATE_SHAPES = ((1, 128, 320), (1, 256, 320), (2, 320, 320), (4, 256, 64),
               (8, 512, 64))


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


def _build_parent_gates(parent: str) -> ctypes.CDLL:
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    src = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "csrc",
                       "repeats.cu")
    lib = ctypes.CDLL(build_shared(src, "librepeats_parent",
                                   [_nvcc()] + NVCC_FLAGS + [src]))
    lib.repeat_gates.restype = ctypes.c_int
    lib.repeat_gates.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p])
    return lib


def _parent_threads(L: int) -> int:
    """The parent's block size (its gpu/repeats.py::plan_threads): the L //
    2 shift pairs in the fewest rounds of at most 256 threads."""
    pairs = max(1, L // 2)
    rounds = -(-pairs // 256)
    return (-(-pairs // rounds) + 31) // 32 * 32


def _gate_launchers(windows, ks, mm: int, parent_lib):
    """(parent launch, this launch, outputs of each, plan, work counters,
    position steps, bound) of one repeat_gates call on prepared card
    inputs: only the kernel's launch is timed."""
    import torch

    from lancet_tpu_torch.gpu import repeats

    dev = torch.device("cuda", 0)
    seq, lens = repeats.pack(windows)
    seq_d, lens_d = (torch.from_numpy(a).to(dev) for a in (seq, lens))
    W, L = seq.shape
    ks = tuple(int(k) for k in ks)
    ks_d = torch.tensor(ks, dtype=torch.int32, device=dev)
    o_par = [torch.zeros((W, len(ks)), dtype=torch.bool, device=dev)
             for _ in range(2)]
    o_new = [torch.zeros_like(o_par[0]) for _ in range(2)]
    pl = repeats.gates_plan(W, L, ks, mm)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def par():
        rc = parent_lib.repeat_gates(
            seq_d.data_ptr(), lens_d.data_ptr(), ks_d.data_ptr(),
            o_par[0].data_ptr(), o_par[1].data_ptr(), W, L, len(ks), mm,
            _parent_threads(L), stream)
        if rc != 0:
            raise RuntimeError(f"parent repeat_gates failed: CUDA error {rc}")

    def new(plan=pl):
        repeats.launch(seq_d, lens_d, ks, mm, plan, *o_new)

    work = torch.zeros(3, dtype=torch.int64, device=dev)
    repeats.launch(seq_d, lens_d, ks, mm, pl, *o_new, work)
    steps = int(sum(int(n) * (int(n) - 1) // 2 for n in lens))
    new.inputs = (seq_d, lens_d, ks_d)
    return par, new, o_par, o_new, pl, work.tolist(), steps


def _gate_rate() -> dict:
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import repeats

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sass, _ = cs.sass_gate_counts(repeats.build())
    return {"int_ops_per_s": sms * cs.ISSUE_LANES_PER_SM_CLK
            * cs.sm_clock_hz()[0],
            "gate_ops_per_word": min(cs.GATE_OPS_PER_WORD,
                                     sass["W5"]["bytes"]["arith"])
            if sass else cs.GATE_OPS_PER_WORD,
            "gate_ops_per_plane_word": min(cs.GATE_OPS_PER_PLANE_WORD,
                                          sass["W5"]["planes"]["arith"])
            if sass else cs.GATE_OPS_PER_PLANE_WORD}


def gates_ab(paths: dict, crafted: dict, parent_lib) -> tuple[list, bool]:
    """The repeat-gate A/B: for each path's captured calls [(windows, ks,
    mm)], every call bit-equal between the parent's kernel and this
    tree's and timed by device time (3 launches each, the order alternating
    from call to call), and the largest call (the most position steps) in
    TURNS alternating turns of PER_TURN launches, by device time and by
    CUDA events, with its bounds (chip_smoke.gate_bound), at this tree's
    plan and, on the device-graph and two-phase paths, at GATE_SHAPES;
    then each crafted case in 4 turns. On the device-graph path every call
    is also timed at GATE_SHAPES (the sums per shape). Returns (JSON
    lines, all equal)."""
    import torch

    import chip_smoke as cs

    rate = _gate_rate()
    kernel = "repeat_gates_kernel"
    lines, ok = [], True
    for path, calls in paths.items():
        total = {"parent": [], "this": []}
        mism = 0
        big, big_steps = None, -1
        for i, (w, ks, mm) in enumerate(calls):
            par, new, o_par, o_new, pl, _, steps = _gate_launchers(
                w, ks, mm, parent_lib)
            mism += _compare(par, new, o_par, o_new) > 0
            order = [("parent", par), ("this", new)]
            if path == "devgraph":
                order += [(f"blocks{b}_threads{t}_tile{g}",
                           lambda p=pl._replace(blocks=b, threads=t,
                                                tile=g): new(p))
                          for b, t, g in GATE_SHAPES]
            for ver, fn in (order if i % 2 == 0 else order[::-1]):
                if ver not in ("parent", "this"):
                    mism += _compare(par, fn, o_par, o_new) > 0
                total.setdefault(ver, []).append(
                    cs.device_ms(fn, kernel, 3))
            if steps > big_steps:
                big, big_steps = (w, ks, mm), steps
        par, new, o_par, o_new, pl, work, steps = _gate_launchers(
            *big, parent_lib)
        mism_big = _compare(par, new, o_par, o_new)
        arms = [("parent", par), ("this", new)]
        if path in ("devgraph", "two_phase"):
            arms += [(f"blocks{b}_threads{t}_tile{g}",
                      lambda p=pl._replace(blocks=b, threads=t, tile=g):
                      new(p)) for b, t, g in GATE_SHAPES]
        dev = {k: [] for k, _ in arms}
        ev = {k: [] for k, _ in arms}
        for turn in range(TURNS):
            for ver, fn in (arms if turn % 2 == 0 else arms[::-1]):
                dev[ver].append(cs.device_ms(fn, kernel, PER_TURN))
                ev[ver].extend(cs.cuda_times(fn, 1, PER_TURN))
        W, L = o_new[0].shape[0], max(1, max(map(len, big[0])))
        bound = cs.gate_bound(W, L, len(big[1]), steps, work, pl, rate)
        lines.append({
            "kernel": "repeat_gates", "path": path, "calls": len(calls),
            "calls_mismatched": mism,
            "device_ms_all_calls": {
                v: {"sum": sum(t for t in ts if t is not None),
                    "missed": sum(t is None for t in ts)}
                for v, ts in total.items()},
            "largest": {"W": W, "L": L, "nk": len(big[1]),
                        "max_mismatch": big[2], "position_steps": steps,
                        "mismatches": mism_big, "plan": pl._asdict(),
                        "words": work[0], "tests": work[1],
                        "plane_words": work[2],
                        "bound_ms": {k: bound[k] for k in
                                     ("bytes", "operations",
                                      "plan_operations")}},
            "device_ms_largest": {v: _spread(t) for v, t in dev.items()},
            "event_ms_largest": {v: cs.spread(t) for v, t in ev.items()},
            "source": "torch.profiler CUDA activity; CUDA events"})
        ok &= mism == 0 and mism_big == 0
    for name, c in crafted.items():
        par, new, o_par, o_new, pl, _, _ = _gate_launchers(
            c["windows"], c["ks"], c["mm"], parent_lib)
        mism = _compare(par, new, o_par, o_new)
        dev = {"parent": [], "this": []}
        for turn in range(4):
            order = (("parent", par), ("this", new))
            for ver, fn in (order if turn % 2 == 0 else order[::-1]):
                dev[ver].append(cs.device_ms(fn, kernel, 5))
        lines.append({"kernel": "repeat_gates", "crafted_case": name,
                      "shape": list(o_new[0].shape), "mismatches": mism,
                      "plan": pl._asdict(),
                      "device_ms": {v: _spread(t) for v, t in dev.items()}})
        ok &= mism == 0
    torch.cuda.synchronize()
    return lines, ok


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
def capture_removals(removals: list):
    """While active: append a copy of the inputs of every card call of
    walks.seq_removal to `removals`."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import walks

    real = walks.seq_removal

    def removal(*a, **k):
        if a[0].is_cuda:
            removals.append(cs._tree(list(a), lambda t: t.clone()
                                     if torch.is_tensor(t) else t))
        return real(*a, **k)

    walks.seq_removal = removal
    try:
        yield
    finally:
        walks.seq_removal = real


def time_removals(removals: list) -> list:
    """Device time (ms, 3 launches each) of every captured seq_removal
    call (this tree's kernel only): the sum over the calls and the largest
    call (the most rank slots)."""
    import chip_smoke as cs
    from lancet_tpu_torch.gpu import walks

    rrows = []
    for args in removals:
        ms = cs.device_ms(lambda: walks.seq_removal(*args),
                          "seq_removal_kernel", 3)
        rrows.append({"shape": list(args[1].shape),
                      "slots": int((args[0] >= 0).sum()), "device_ms": ms})
    if not rrows:
        return []
    return [{"kernel": "seq_removal", "calls": len(rrows),
             "device_ms_sum": sum(r["device_ms"] or 0 for r in rrows),
             "missed": sum(r["device_ms"] is None for r in rrows),
             "largest": max(rrows, key=lambda r: r["slots"]),
             "source": "torch.profiler CUDA activity"}]


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
                         "lancet_tpu_torch/csrc/walks.cu and "
                         "lancet_tpu_torch/csrc/repeats.cu")
    ap.add_argument("--only", choices=("walks", "gates"),
                    help="time only the walks or only the repeat gates")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: walks_ab.py needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lancet_tpu_torch import corpus

    parent_lib = None if a.only == "gates" else _build_parent(a.parent)
    parent_gates = None if a.only == "walks" else _build_parent_gates(
        a.parent)
    workdir = os.path.join(HERE, "build", "smoke_corpus")
    region = corpus.write_default_corpus(workdir)
    advdir = os.path.join(HERE, "build", "smoke_adversarial")
    os.makedirs(advdir, exist_ok=True)
    refseq, tumor, normal, adv_region = corpus.adversarial_corpus()
    corpus.write_pair(advdir, refseq, "chr1", tumor, normal)
    kept: dict = {}
    calls: list = []
    gates: list = []
    removals: list = []
    with cs.capture_gates(gates), capture_removals(removals), \
            cs.instrument_devgraph(kept, None, calls):
        cs.run_devgraph(workdir, cs.DEVGRAPH_REGION, {})
        cs.run_devgraph(advdir, adv_region, {}, num_threads=2)
    torch.cuda.synchronize()

    ok = True
    if a.only != "gates":
        # the crafted cases of gpu/walkcases.py, each call captured the
        # same way
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
        for line in time_removals(removals):
            print(json.dumps(line), flush=True)
    if a.only != "walks":
        # the repeat gates: the device-graph calls above, the eager sweep's
        # chunks and the two-phase call
        from lancet_tpu_torch.config import Config
        from lancet_tpu_torch.gpu import gatecases

        sweep: list = []
        os.environ["LANCET_TPU_GATES"] = "1"
        try:
            with cs.capture_gates(sweep):
                cs.run_captured(workdir, region, {}, device="cuda")
        finally:
            del os.environ["LANCET_TPU_GATES"]
        cfg = Config()
        ks = list(range(cfg.min_k, cfg.max_k + 1, 2))
        two_phase = [(cs.default_windows(workdir, region), ks,
                      cfg.max_mismatch)]
        glines, gok = gates_ab({"devgraph": gates, "gates_sweep": sweep,
                                "two_phase": two_phase},
                               gatecases.gate_cases(), parent_gates)
        for line in glines:
            print(json.dumps(line), flush=True)
        ok &= gok
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
