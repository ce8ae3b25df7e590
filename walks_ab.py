#!/usr/bin/env python3
"""A/B of the walk kernels, the removal pass and the repeat gates against
a parent commit's, on one card.

    mkdir -p build/parent
    git archive <parent commit> lancet_tpu_torch/csrc | tar -x -C build/parent
    python3 walks_ab.py --parent build/parent [--only walks|removal|gates]
    python3 walks_ab.py --only screens [--parent build/parent]
    python3 walks_ab.py --only compress [--parent build/parent]
    python3 walks_ab.py --only graphstate [--parent build/parent] [--turns N]
    python3 walks_ab.py --only cleanup [--parent build/parent] [--turns N]
    python3 walks_ab.py --only build [--parent build/parent] [--turns N]
    python3 walks_ab.py --only bodies --parent build/parent

Walks: captures every path_cover, almost_repeat_paths and cycle_dfs call of
chip_smoke.py's two device-graph cases (the JAX bench's region and the
adversarial windows), builds the parent's csrc/walks.cu beside this
tree's, holds the two kernels bit-equal on every call, and times both, in
turns (parent, this, this, parent, ...), on the largest call of each walk
(the call chip_smoke times), over all of them, and on each crafted case of
gpu/walkcases.py: the kernel's own device time (torch.profiler's CUDA
activity) and CUDA events around back-to-back launches (which also see the
host's time between launches). The parent's entry points are
path_cover(14 pointers, 13 ints, size_t, stream), cycle_dfs(8 pointers, 7
ints, size_t, stream), almost_repeat_paths(3 pointers, 7 ints, size_t,
stream) and seq_removal(8 pointers, 6 ints, stream): those of
csrc/walks.cu before K2 ran the whole removal pass.

The removal pass (`--only removal`): captures every card call of
stages._seq_removal_pass in the same two cases and runs each as two
versions, in turns: the parent's pass (this tree's _rank_slots,
_nbr_table and remove_items, as torch ops, around the parent's K2 sweep
behind its own int32 wrapper, as the parent commit ran it) and this
tree's (one K2 launch); both held bit-equal to each other and to
seq_removal_pass_plain on every call. Per version: the device time of
all of a pass's device events and their count (torch.profiler), the K2
kernel's own device time, the aten ops a pass dispatches
(TorchDispatchMode), and the host's time to issue a pass and to finish it
(perf_counter, before and after a synchronize), summed over the calls and
on the largest call (the most live items), with this tree's byte bound
and chain floor on it (chip_smoke.removal_accounting, the smem_chase
latency). Then device-graph case 1 end to end with each version patched
in, in turns (parent, this, this, parent, parent, this): t_dg_assemble,
t_total and windows/s, the VCF equal, and one profiled run each for the
card's busy share and device events.

Prints one JSON line a walk, pass or kernel, the card's name and power
limit, and a last line {"ok": true}; exits non-zero on a mismatch or
without a card. `--only` times one part (the parent directory then needs
only that part's source: walks.cu for walks and removal).

The screens (`--only screens`), the compression pass (`--only
compress`, stages.compress_round against compress_round_plain) or the
graphstate functions (`--only graphstate`: stages.components,
compact_state, low_cov_pass and item_mincovs against their plain
versions), without a parent: device-graph case 1
and the hard corpus's device graph run (corpus.hard_corpus, 1,995
windows), each with the part's functions (stages.tandem_at and
stages.cycle_screen; stages.compress_round; the four graphstate functions)
patched to their plain versions (run on the card, op by op) and with the
kernels of csrc/screens.cu, csrc/compress.cu or csrc/graphstate.cu, in
turns (plain, kernel, kernel, plain): per run
t_dg_a_dispatch, t_dg_assemble, t_devgraph, t_total and windows/s, with
each version's spread; every VCF equal; then per version one instrumented
run (the calls and aten ops of the counted functions,
chip_smoke.instrument_devgraph) and one profiled run (the card's busy
share and device events, chip_smoke.profile_devgraph). With `--parent`
(the parent's csrc/screens.cu; its entry points tandem_at(3 pointers, 3
ints, 4 long longs, size_t, stream) and cycle_screen(8 pointers, 6 ints,
size_t, stream), with its own shared-memory plans): captures every
tandem_at and cycle_screen call of device-graph cases 1 and 2 and of the
hard corpus's device graph run, holds the parent's kernel and this tree's
bit-equal on each and on the crafted batches of gpu/screencases.py (at
TANDEM_PARAMS and SCREEN_ROUNDS), and times the two in turns (parent,
this, this, parent) by their own device time (torch.profiler): summed
over each run's calls and, in TURNS turns of PER_TURN launches, on the
call with the most work (with CUDA events, the bound and the chain floor
of chip_smoke.screen_accounting).

The cleanup (`--only cleanup`, without a parent): first, for device-graph
case 1 and the hard corpus's device graph run, every card call of
gpu/pipeline.py::cleanup of one run, run again as cleanup_plain (the
composition with host bools: a bool read a tips round and for the
short-link gate, the strings a K-step loop of torch ops) and as the card's
eight launches (pipeline.cleanup), bit-equal on every call: per version the
aten ops, hand-kernel launches and host syncs of the calls
(set_sync_debug_mode("warn")), their device events and device time
(torch.profiler) and the host's time to finish them, in turns (plain,
kernel, kernel, plain), and the host syncs of the first SYNC_ATTEMPTS
attempt tails (devicepipe._assemble) with each version (cleanup_calls_ab);
then the end-to-end turns of the other parts with pipeline.cleanup patched
to cleanup_plain.

The compression pass and the tips fixpoint against the parent's
(`--only compress --parent` and `--only cleanup --parent`; the parent's
csrc/compress.cu, csrc/cleanup.cu and the headers they include, from `git
archive <parent> lancet_tpu_torch/csrc`, built beside this tree's and
driven through their own entry points: compress_round(2 pointers, 4 ints,
3 long longs, size_t, stream) with compress_smem(3 ints), tip_fixpoint(11
pointers, 8 ints, 4 long longs, size_t, stream) with tip_fixpoint_smem(4
ints), one block a window): every card compress_round (or tip_fixpoint)
call of device-graph case 1 and of the hard corpus's device graph run,
launched as both, bit-equal (an in-place links call each on its own copy
of the inputs), the device time summed over the calls (torch.profiler,
3 launches each), and in TURNS turns of PER_TURN launches, alternating,
on the largest call of each item axis (NI 1,552 and 528; tip_fixpoint:
of each mode), with this tree's cluster size and the blocks of its grid
from the profiler's records (kernels_ab). With --only cleanup both cases
then run end to end with the parent's compress_round and tip_fixpoint
against this tree's, in turns (`--turns` runs each, as plain_ab runs the
other parts).

The low-coverage kernels against the parent's (`--only graphstate
--parent`; the parent's csrc/graphstate.cu, from `git archive <parent>
lancet_tpu_torch/csrc`, built beside this tree's and driven through its
own entry points, one block a window): every card low_cov_pass and
item_mincovs call of device-graph case 1 and of the hard corpus's device
graph run, launched as both, bit-equal, the device time summed over the
calls and, in TURNS turns of PER_TURN launches, alternating, on each
function's largest call, with this tree's cluster size and grid from the
profiler (kernels_ab); then both cases end to end with the parent's two
kernels against this tree's, in turns (`--turns` runs each).

The build (`--only build`, without a parent): device-graph case 1 and
the hard corpus's device graph run with gpu/dbg.py::build_k patched to
build_k_plain (its ~1,000 torch ops launched from the host) and with the
launches of csrc/dbg.cu, in turns (plain, kernel, kernel,
plain), as plain_ab runs the other parts, with t_dg_pack and its three
parts (chip_smoke.pack_split: pack_chunk, the H2D copy, build_k's
dispatch) beside each run's keys. With `--parent` (the parent's
csrc/dbg.cu and gpu/dbgk.py, from `git archive <parent>
lancet_tpu_torch/csrc/dbg.cu lancet_tpu_torch/gpu/dbgk.py`): the parent's
build against this tree's instead (build_calls_ab): on the largest card
build_k call of each case both bit-equal to build_k_plain and each
stage's kernels timed by their device time in turns (this tree's
node_tables and edge_tables kernel by kernel), and each of the six sorts
alone (each tree's window_sort with its build plan); then both end to end in turns (parent, this, this, parent) as
plain_ab runs the other parts: t_dg_build, windows/s, the device events
and busy share of a profiled run.

The moved bodies (`--only bodies`, the parent's csrc/walks.cu and
csrc/compress.cu, from `git archive <parent> lancet_tpu_torch/csrc`):
every seq_removal and compress_round call of device-graph case 1 run with
cleanup_plain, launched as the parent's kernels and this tree's (whose
bodies are csrc/removal_body.cuh and csrc/compress_body.cuh), bit-equal
and timed in turns by their own device time (bodies_ab).

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
    lib.almost_repeat_paths.restype = lib.seq_removal.restype = ci
    lib.path_cover.argtypes = [vp] * 14 + [ci] * 13 + [sz, vp]
    lib.cycle_dfs.argtypes = [vp] * 8 + [ci] * 7 + [sz, vp]
    lib.almost_repeat_paths.argtypes = [vp] * 3 + [ci] * 7 + [sz, vp]
    lib.seq_removal.argtypes = [vp] * 8 + [ci] * 6 + [vp]
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


def _build_parent_screens(parent: str) -> ctypes.CDLL:
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    src = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "csrc",
                       "screens.cu")
    lib = ctypes.CDLL(build_shared(src, "libscreens_parent",
                                   [_nvcc()] + NVCC_FLAGS + [src]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll, sz = ctypes.c_longlong, ctypes.c_size_t
    lib.tandem_at.restype = lib.cycle_screen.restype = ci
    lib.tandem_at.argtypes = [vp] * 3 + [ci] * 3 + [ll] * 4 + [sz, vp]
    lib.cycle_screen.argtypes = [vp] * 8 + [ci] * 6 + [sz, vp]
    return lib


def _parent_screen_smem(name: str, *shape) -> int:
    """The parent's shared-memory plans (its gpu/screens.py): tandem_at 32
    strings a block of one thread each (L, unit length), cycle_screen one
    block a window of byte arrays over the states (NI, EE, Cmax)."""
    from lancet_tpu_torch.gpu.gotoh import _r16

    if name == "tandem_at":
        L, mu = shape
        return _r16(32 * (L | 1) * 8) + _r16(32 * max(mu - 1, 0) * (L + 1)
                                             * 4)
    NI, EE, Cmax = shape
    return (_r16(EE * 4) + _r16(EE) + 2 * _r16(NI) + 4 * _r16(2 * NI)
            + _r16(8 * NI) + _r16(Cmax + 2))


def _screen_launchers(name: str, args, kw: dict, parent_lib, this_lib=None):
    """(parent launch, this launch, outputs of each) of one screen call on
    its inputs on the card, converted once: only the kernel's launch is
    timed. The parent's launch takes the parent's shared-memory plans, this
    tree's this tree's plans, on this tree's library or `this_lib`."""
    import torch

    from lancet_tpu_torch.gpu import screens

    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    lib = this_lib or screens._load()

    def check(who, rc):
        if rc != 0:
            raise RuntimeError(f"{who} {name} failed: CUDA error {rc}")

    if name == "tandem_at":
        seqs, lens, pos, mu, units, length, dist = list(args) + [
            kw[k] for k in ("max_unit_len", "min_report_units",
                            "min_report_len", "dist_from_str")
            if k in kw]
        s, n = (t.to(dev, torch.int64).contiguous() for t in (seqs, lens))
        B, L = s.shape
        mu = max(int(mu), 0)
        o_par = [torch.zeros(B, dtype=torch.bool, device=dev)]
        o_new = [torch.zeros_like(o_par[0])]
        rest = (int(pos), int(units), int(length), int(dist))

        def launch(who, f, out, smem):
            check(who, f(s.data_ptr(), n.data_ptr(), out.data_ptr(), B, L,
                         mu, *rest, smem, stream))

        def par():
            launch("parent", parent_lib.tandem_at, o_par[0],
                   _parent_screen_smem(name, L, mu))

        def new():
            launch("this", lib.tandem_at, o_new[0], screens.tandem_plan(L,
                                                                        mu))
        return par, new, o_par, o_new
    a = list(args) + [kw.get("T", 32)] if len(args) < 11 else list(args)
    ins = [t.to(dev, torch.int64).contiguous() for t in a[:3]] + [
        t.to(dev, torch.bool).contiguous() for t in a[3:6]] + [
        a[6].to(dev, torch.int64).contiguous()]
    N, NI, Cmax, T = (int(x) for x in a[7:11])
    W, EE = ins[0].shape
    T = max(min(T, 2**31 - 1), -1)
    o_par = [torch.zeros((W, Cmax), dtype=torch.bool, device=dev)]
    o_new = [torch.zeros_like(o_par[0])]
    ptrs = [t.data_ptr() for t in ins]

    def launch(who, f, out, smem):
        check(who, f(*ptrs, out.data_ptr(), W, NI, EE, N, Cmax, T, smem,
                     stream))

    def par():
        launch("parent", parent_lib.cycle_screen, o_par[0],
               _parent_screen_smem(name, NI, EE, Cmax))

    def new():
        launch("this", lib.cycle_screen, o_new[0],
               screens.cycle_screen_plan(NI, EE, N, Cmax))
    return par, new, o_par, o_new


def screens_parent_ab(parent_lib) -> tuple[list, bool]:
    """The screens' A/B against the parent's kernels: every captured card
    call of devgraph cases 1 and 2 and of the hard corpus's device graph
    run, and the crafted batches, bit-equal between the two and timed in
    turns (see the module docstring). Returns (JSON lines, all equal)."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch import corpus
    from lancet_tpu_torch.gpu import screencases as sc

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
    chase = cs.smem_latency_ns()
    rate = {"int_ops_per_s": torch.cuda.get_device_properties(
        0).multi_processor_count * cs.ISSUE_LANES_PER_SM_CLK
        * cs.sm_clock_hz()[0]}
    kernels = {"tandem_at": "tandem_kernel",
               "cycle_screen": "cycle_screen_kernel"}
    lines, ok = [], True
    for case, wd, region, threads in (
            ("devgraph_case_1", workdir, cs.DEVGRAPH_REGION, 8),
            ("devgraph_case_2", advdir, adv_region, 2),
            ("hard", hdir, hregion, 8)):
        calls: list = []
        with cs.instrument_devgraph(None, None, calls):
            cs.run_devgraph(wd, region, {}, num_threads=threads)
        torch.cuda.synchronize()
        for name, kernel in kernels.items():
            mine = [(c[1], c[2]) for c in calls if c[0] == name]
            if not mine:
                continue
            total = {"parent": [], "this": []}
            mism = 0
            for i, (args, kw) in enumerate(mine):
                par, new, o_par, o_new = _screen_launchers(name, args, kw,
                                                           parent_lib)
                mism += _compare(par, new, o_par, o_new) > 0
                order = [("parent", par), ("this", new)]
                for ver, fn in (order if i % 2 == 0 else order[::-1]):
                    total[ver].append(cs.device_ms(fn, kernel, 3))
            args, kw = max(mine, key=lambda c: cs._walk_work(name, c[0]))
            par, new, o_par, o_new = _screen_launchers(name, args, kw,
                                                       parent_lib)
            mism_big = _compare(par, new, o_par, o_new)
            dev = {"parent": [], "this": []}
            ev = {"parent": [], "this": []}
            for turn in range(TURNS):
                order = (("parent", par), ("this", new))
                for ver, fn in (order if turn % 2 == 0 else order[::-1]):
                    dev[ver].append(cs.device_ms(fn, kernel, PER_TURN))
                    ev[ver].extend(cs.cuda_times(fn, 1, PER_TURN))
            acc = cs.screen_accounting(name, list(args) + (
                [kw["T"]] if "T" in kw else []))
            lines.append({
                "kernel": name, "path": case, "calls": len(mine),
                "calls_mismatched": mism,
                "device_ms_all_calls": {
                    v: {"sum": sum(t for t in ts if t is not None),
                        "missed": sum(t is None for t in ts)}
                    for v, ts in total.items()},
                "largest": {"shape": list(args[0].shape),
                            "work": cs._walk_work(name, args),
                            "mismatches": mism_big},
                "device_ms_largest": {v: _spread(t) for v, t in dev.items()},
                "event_ms_largest": {v: cs.spread(t) for v, t in ev.items()},
                "bound_ms": {"bytes": acc["bytes"] / cs.HBM_BYTES_PER_S
                             * 1e3, "operations": acc["int_ops"]
                             / rate["int_ops_per_s"] * 1e3},
                "chain_units": acc["chain_units"],
                "chain_floor_ms": acc["chain_units"] * cs.SCREEN_CHAIN_LOADS
                * chase["ns_per_load"] / 1e6,
                "source": "torch.profiler CUDA activity; CUDA events"})
            ok &= mism == 0 and mism_big == 0
    # the crafted batches
    seqs, lens, _ = sc.tandem_batch()
    arrs, _, sN, sNI, sC = sc.screen_batch()
    crafted = [("tandem_at", [sc.to_torch(seqs), sc.to_torch(lens), *p], {},
                f"pos{p[0]}_mu{p[1]}") for p in sc.TANDEM_PARAMS]
    crafted += [("cycle_screen", [sc.to_torch(arrs[k]) for k in
                                  sc.SCREEN_ARGS] + [sN, sNI, sC, T], {},
                 f"T{T}") for T in sc.SCREEN_ROUNDS]
    for name, args, kw, label in crafted:
        par, new, o_par, o_new = _screen_launchers(name, args, kw,
                                                   parent_lib)
        mism = _compare(par, new, o_par, o_new)
        dev = {"parent": [], "this": []}
        for turn in range(4):
            order = (("parent", par), ("this", new))
            for ver, fn in (order if turn % 2 == 0 else order[::-1]):
                dev[ver].append(cs.device_ms(fn, kernels[name], 5))
        lines.append({"kernel": name, "crafted_case": label,
                      "shape": list(args[0].shape), "mismatches": mism,
                      "device_ms": {v: _spread(t) for v, t in dev.items()}})
        ok &= mism == 0
    lines.append({"smem_latency": chase})
    torch.cuda.synchronize()
    return lines, ok


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
                *p_in, o_par[0].data_ptr(), W * J, LP, K, mm_new, pl.blocks,
                pl.threads, pl.tile, pl.smem, stream))

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
def capture_passes(passes: list):
    """While active: append a copy of the arguments (st reduced to the keys
    the pass reads, cond, U, D2) of every card call of
    stages._seq_removal_pass to `passes`."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import stages, walks

    real = stages._seq_removal_pass

    def f(st, cond, U, D2):
        if st["alive"].is_cuda:
            passes.append(cs._tree(
                [{k: st[k] for k in walks.REMOVAL_KEYS}, cond, U, D2],
                lambda t: t.clone() if torch.is_tensor(t) else t))
        return real(st, cond, U, D2)

    stages._seq_removal_pass = f
    try:
        yield
    finally:
        stages._seq_removal_pass = real


def parent_pass(lib):
    """The parent commit's _seq_removal_pass on the card: this tree's
    _rank_slots, _nbr_table and remove_items around the parent's K2 sweep
    (slots [W, U], neighbours [W, NI, D2], degrees; int32 and byte
    inputs), with the parent's wrapper's conversions."""
    import torch

    from lancet_tpu_torch.gpu import gotoh, stages, walks

    def sweep(slots, nbr, deg, cond):
        dev = slots.device
        W, U = slots.shape
        NI, D2 = nbr.shape[1], nbr.shape[2]
        removed = torch.empty((W, NI), dtype=torch.uint8, device=dev)
        merlen = walks._i32(cond[1])
        mode, max_len = (0 if cond[0] == "tips" else 1), int(cond[2])
        mincov, thr, guard = ((merlen,) * 3 if mode == 0 else
                              (walks._i32(cond[3]), walks._i32(cond[4]),
                               walks._u8(cond[5])))
        ins = (walks._i32(slots), walks._i32(nbr), walks._i32(deg), merlen,
               mincov, guard, thr)
        with torch.cuda.device(dev):
            rc = lib.seq_removal(*[t.data_ptr() for t in ins],
                                 removed.data_ptr(), W, U, NI, D2, mode,
                                 max_len, gotoh._stream(dev))
        if rc != 0:
            raise RuntimeError(f"parent seq_removal failed: CUDA error {rc}")
        return removed.to(torch.bool)

    def run(st, cond, U, D2):
        NI = st["alive"].shape[1]
        slots, over = stages._rank_slots(st, U)
        nbr, deg, over2 = stages._nbr_table(st, NI, D2)
        removed = sweep(slots, nbr, deg, cond)
        return (stages.remove_items(st, removed), removed.any(dim=1),
                over | over2)

    return run


def _outputs(res):
    """A pass's (st, removed_any, over) as (alive, e_alive, removed_any,
    over)."""
    st, removed_any, over = res
    return st["alive"], st["e_alive"], removed_any, over


def _pass_profile(fn, n: int) -> dict:
    """torch.profiler over n calls of a pass: the device time of all its
    device events a call, their count a call, and the K2 kernel's own
    device time a call (ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"device_ms": sum(e.time_range.elapsed_us() for e in ev) / n / 1e3,
            "device_events": len(ev) / n,
            "kernel_ms": sum(e.time_range.elapsed_us() for e in ev
                             if "seq_removal_kernel" in e.name) / n / 1e3}


def _host_ms(fn, reps: int) -> dict:
    """Median host ms to issue one call of fn (it returns) and to finish
    it (a synchronize after), each from an idle card."""
    import statistics
    import time

    import torch

    issue, done = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append((t1 - t0) * 1e3)
        done.append((t2 - t0) * 1e3)
    return {"issue_ms": statistics.median(issue),
            "done_ms": statistics.median(done)}


def removal_ab(passes: list, parent_lib) -> tuple[list, bool]:
    """The pass-level A/B on every captured call: the parent's pass and
    this tree's, bit-equal to each other and to seq_removal_pass_plain,
    each profiled (3 calls), counted and timed on the host, the order
    alternating from call to call; then the largest call in TURNS turns
    of PER_TURN calls. Returns (JSON lines, all equal)."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import stages

    par = parent_pass(parent_lib)
    versions = {"parent": par, "this": stages._seq_removal_pass}
    keys = ("device_ms", "device_events", "kernel_ms")
    total = {v: dict.fromkeys(keys + ("aten_ops", "issue_ms", "done_ms"),
                              0.0) for v in versions}
    mism = 0
    big, big_live = None, -1
    for i, args in enumerate(passes):
        want = cs.removal_plain(*args)
        order = list(versions.items())
        for ver, fn in (order if i % 2 == 0 else order[::-1]):
            got = _outputs(fn(*args))
            torch.cuda.synchronize()
            mism += cs._mismatches(got, want) > 0
            t = total[ver]
            for k, v in _pass_profile(lambda: fn(*args), 3).items():
                t[k] += v
            t["aten_ops"] += cs.aten_ops(lambda: fn(*args))
            for k, v in _host_ms(lambda: fn(*args), 5).items():
                t[k] += v
        live = int((args[0]["alive"] & ~args[0]["special"]).sum())
        if live > big_live:
            big, big_live = args, live
    n = max(len(passes), 1)
    lines = [{"pass": "seq_removal", "calls": len(passes),
              "calls_mismatched": mism,
              "sum_over_calls": total,
              "per_call": {v: {k: x / n for k, x in t.items()}
                           for v, t in total.items()},
              "source": "torch.profiler CUDA activity; TorchDispatchMode; "
                        "perf_counter"}]
    dev = {v: [] for v in versions}
    host = {v: [] for v in versions}
    for turn in range(TURNS):
        order = list(versions.items())
        for ver, fn in (order if turn % 2 == 0 else order[::-1]):
            dev[ver].append(_pass_profile(lambda: fn(*big), PER_TURN))
            host[ver].append(_host_ms(lambda: fn(*big), PER_TURN))
    got = cs.removal_plain(*big)
    acc = cs.removal_accounting(*big, got[0])
    chase = cs.smem_latency_ns()
    lines.append({
        "pass": "seq_removal", "largest": {
            "W": big[0]["alive"].shape[0], "NI": big[0]["alive"].shape[1],
            "EE": big[0]["e_src"].shape[1], "U": big[2], "D2": big[3],
            "mode": big[1][0], **acc},
        "device": {v: {k: cs.spread([d[k] for d in ds]) for k in keys}
                   for v, ds in dev.items()},
        "host": {v: {k: cs.spread([h[k] for h in hs])
                     for k in ("issue_ms", "done_ms")}
                 for v, hs in host.items()},
        "aten_ops": {v: cs.aten_ops(lambda: fn(*big))
                     for v, fn in versions.items()},
        "bound_ms": {"bytes": acc["bytes"] / cs.HBM_BYTES_PER_S * 1e3},
        "chain_floor_ms": acc["chain"] * cs.WALK_CHAIN_LOADS["seq_removal"]
        * chase["ns_per_load"] / 1e6, "smem_ns_per_load": chase["ns_per_load"],
        "source": "torch.profiler CUDA activity; perf_counter"})
    return lines, mism == 0


def removal_e2e(parent_lib, workdir: str) -> tuple[dict, bool]:
    """Device-graph case 1 with the parent's pass and with this tree's
    patched in, in turns (parent, this, this, parent, parent, this):
    t_dg_assemble, t_total and windows/s, each VCF equal to the first;
    then one profiled run each (chip_smoke.profile_devgraph: the card's
    busy share and device events)."""
    import chip_smoke as cs
    from lancet_tpu_torch.gpu import stages

    real = stages._seq_removal_pass
    versions = {"parent": parent_pass(parent_lib), "this": real}
    runs = {v: [] for v in versions}
    vcfs = set()
    busy = {}
    try:
        for ver in ("parent", "this", "this", "parent", "parent", "this"):
            stages._seq_removal_pass = versions[ver]
            st: dict = {}
            vcf, _ = cs.run_devgraph(workdir, cs.DEVGRAPH_REGION, st)
            vcfs.add(vcf)
            runs[ver].append({k: st[k] for k in (
                "t_total", "t_devgraph", "t_dg_assemble", "t_dg_a_dispatch",
                "n_windows")} | {"windows_per_s": st["n_windows"]
                                 / st["t_total"]})
        for ver, fn in versions.items():
            stages._seq_removal_pass = fn
            busy[ver] = cs.profile_devgraph(
                workdir, cs.DEVGRAPH_REGION,
                sum(r["t_total"] for r in runs[ver]) / len(runs[ver]))
    finally:
        stages._seq_removal_pass = real
    return {"pass": "seq_removal", "case": "devgraph_case_1",
            "region": cs.DEVGRAPH_REGION, "runs": runs, "device_busy": busy,
            "vcf_equal": len(vcfs) == 1}, len(vcfs) == 1


SCREEN_KEYS = ("t_total", "t_devgraph", "t_dg_assemble", "t_dg_a_dispatch",
               "t_dg_a_exec", "n_windows")
# the functions each part's A/B patches to its plain version (of
# gpu/stages.py; the cleanup's of gpu/pipeline.py)
PLAIN_AB = {"screens": ("tandem_at", "cycle_screen"),
            "compress": ("compress_round",),
            "graphstate": ("components", "compact_state", "low_cov_pass",
                           "item_mincovs"),
            "lowcov": ("low_cov_pass", "item_mincovs"),
            "cleanup": ("cleanup",), "build": ("build_k",),
            "clusters": ("compress.compress_round", "cleanup.tip_fixpoint")}
PLAIN_AB_MODULE = {"cleanup": "pipeline", "build": "dbg"}
# the build's runs also report t_dg_pack and its parts
BUILD_KEYS = ("t_dg_pack", "t_dg_build", "t_dg_a_dispatch")
# attempts of each case whose whole tail (devicepipe._assemble) is run
# again to count its host syncs
SYNC_ATTEMPTS = 2


def plain_ab(part: str, case: str, workdir: str, region: str,
             versions: dict | None = None,
             turns: int = 2) -> tuple[dict, bool]:
    """Device-graph runs of `region` after one warm-up run: with the part's
    functions (PLAIN_AB) patched to their plain versions, run on the card
    op by op, and with their kernels, in turns (plain, kernel, kernel,
    plain, repeated: `turns` runs each, an even count); then one
    instrumented and one profiled run each. `versions` ({name: the
    functions}, two of them) replaces plain and kernel. Returns (JSON
    line, every VCF equal)."""
    import importlib

    import chip_smoke as cs

    def target(n):  # "module.name" or a name of the part's module
        m, _, n = n.rpartition(".")
        m = m or PLAIN_AB_MODULE.get(part, "stages")
        return importlib.import_module(f"lancet_tpu_torch.gpu.{m}"), n

    targets = [target(n) for n in PLAIN_AB[part]]
    names = tuple(n for _, n in targets)
    real = tuple(getattr(m, n) for m, n in targets)
    versions = versions or {"plain": tuple(getattr(m, f"{n}_plain")
                                           for m, n in targets),
                            "kernel": real}
    first, second = versions
    order = [first, second, second, first] * max(turns // 2, 1)

    def use(fns):
        for (m, n), f in zip(targets, fns):
            setattr(m, n, f)

    runs = {v: [] for v in versions}
    ops = {}
    busy = {}
    vcfs = set()
    keys = SCREEN_KEYS + (BUILD_KEYS if part == "build" else ())
    try:
        vcfs.add(cs.run_devgraph(workdir, region, {})[0])  # warm-up
        for ver in order:
            use(versions[ver])
            st: dict = {}
            split: dict = {}
            with (cs.pack_split(split) if part == "build"
                  else contextlib.nullcontext()):
                vcf, _ = cs.run_devgraph(workdir, region, st)
            vcfs.add(vcf)
            runs[ver].append({k: st[k] for k in keys}
                             | {"windows_per_s": st["n_windows"]
                                / st["t_total"]}
                             | ({"t_dg_pack_split": split} if split
                                else {}))
        for ver, fns in versions.items():
            use(fns)
            ops[ver] = {}
            with cs.instrument_devgraph(None, ops[ver]):
                vcf, _ = cs.run_devgraph(workdir, region, {})
            vcfs.add(vcf)
            for c in ops[ver].values():
                c["per_call"] = c["aten_ops"] / max(c["calls"], 1)
            busy[ver] = cs.profile_devgraph(
                workdir, region,
                sum(r["t_total"] for r in runs[ver]) / len(runs[ver]))
    finally:
        use(real)
    spread = {v: {k: cs.spread([r[k] for r in rs])
                  for k in (*SCREEN_KEYS[:-1], "windows_per_s",
                            *keys[len(SCREEN_KEYS):])}
              for v, rs in runs.items()}
    if part == "build":
        for v, rs in runs.items():
            spread[v]["t_build_k"] = cs.spread(
                [r["t_dg_pack_split"]["t_build_k"] for r in rs])
    return {part: case, "region": region, "order": order,
            "runs": runs, "spread": spread,
            "counted_functions": {v: {n: o[n] for n in names if n in o}
                                  for v, o in ops.items()},
            "device_busy": busy, "vcf_equal": len(vcfs) == 1,
            "source": "perf_counter stats of runner.run; TorchDispatchMode; "
                      "torch.profiler CUDA activity"}, len(vcfs) == 1


@contextlib.contextmanager
def capture_cleanups(calls: list, attempts: list):
    """While active: a copy of the inputs of every card call of
    gpu/pipeline.py::cleanup (`calls`: (args, kwargs)) and of the first
    SYNC_ATTEMPTS attempt tails (devicepipe._assemble, `attempts`)."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.engine import devicepipe
    from lancet_tpu_torch.gpu import pipeline

    real_c, real_a = pipeline.cleanup, devicepipe._assemble

    def copy(x):
        return cs._tree(x, lambda t: t.clone() if torch.is_tensor(t) else t)

    def cleanup(*a, **k):
        if a[0]["alive"].is_cuda:
            calls.append((copy(a), copy(k)))
        return real_c(*a, **k)

    def assemble(*a, **k):
        if len(attempts) < SYNC_ATTEMPTS:
            attempts.append((copy(a), copy(k)))
        return real_a(*a, **k)

    pipeline.cleanup, devicepipe._assemble = cleanup, assemble
    try:
        yield
    finally:
        pipeline.cleanup, devicepipe._assemble = real_c, real_a


def _syncs(fn) -> int:
    """The host syncs one call of fn makes: the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in got)


def cleanup_calls_ab(case: str, workdir: str, region: str) -> tuple:
    """Every card call of the cleanup in one devgraph run of `region`, as
    cleanup_plain (host bools; its stages' kernels) and as the cleanup's
    eight launches, bit-equal on each call; per version, summed over the
    calls and per call: aten ops (TorchDispatchMode), hand-kernel launches
    (the wrappers' counts), host syncs (set_sync_debug_mode("warn")),
    device events and their device time (torch.profiler, in turns:
    plain, kernel, kernel, plain) and the host's time to run a call to its
    end (perf_counter around a call and a synchronize, in the same
    turns); then the host syncs of SYNC_ATTEMPTS whole attempt tails
    (devicepipe._assemble) with each version. Returns (JSON line, ok)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from lancet_tpu_torch.engine import devicepipe
    from lancet_tpu_torch.gpu import pipeline

    calls: list = []
    attempts: list = []
    with capture_cleanups(calls, attempts):
        cs.run_devgraph(workdir, region, {})
    torch.cuda.synchronize()
    versions = {"plain": pipeline.cleanup_plain,
                "kernel": pipeline.cleanup}

    def run_all(fn):
        return [fn(*a, **k) for a, k in calls]

    outs = {v: run_all(f) for v, f in versions.items()}
    torch.cuda.synchronize()
    mism = sum(cs.dtype_mismatches(cs._walk_out("cleanup", g),
                                   cs._walk_out("cleanup", w)) > 0
               for g, w in zip(outs["kernel"], outs["plain"]))
    per = {}
    for ver, fn in versions.items():
        before = cs.launch_counts()
        run_all(fn)
        torch.cuda.synchronize()
        after = cs.launch_counts()
        per[ver] = {
            "aten_ops": sum(cs.aten_ops(lambda a=a, k=k: fn(*a, **k))
                            for a, k in calls),
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "host_syncs": sum(_syncs(lambda a=a, k=k: fn(*a, **k))
                              for a, k in calls),
            "device_ms": [], "device_events": [], "host_ms": []}
    for ver in ("plain", "kernel", "kernel", "plain"):
        fn = versions[ver]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_all(fn)
            torch.cuda.synchronize()
        ev = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
        per[ver]["device_ms"].append(sum(ev) / 1e6)
        per[ver]["device_events"].append(len(ev))
        t0 = time.perf_counter()
        for a, k in calls:
            fn(*a, **k)
            torch.cuda.synchronize()
        per[ver]["host_ms"].append((time.perf_counter() - t0) * 1e3)
    n = max(len(calls), 1)
    for p in per.values():
        p["aten_ops_per_call"] = p["aten_ops"] / n
        p["launches_per_call"] = {k: v / n for k, v in p["launches"].items()}
        p["host_syncs_per_call"] = p["host_syncs"] / n
    # whole attempt tails: the cleanup's syncs beside the rest's
    real = pipeline.cleanup
    syncs = {}
    try:
        for ver, fn in (("plain", pipeline.cleanup_plain),
                        ("kernel", real)):
            pipeline.cleanup = fn
            syncs[ver] = [_syncs(lambda a=a, k=k: devicepipe._assemble(
                *a, **k)) for a, k in attempts]
    finally:
        pipeline.cleanup = real
    ok = mism == 0 and bool(calls)
    return {"cleanup_calls": case, "region": region, "calls": len(calls),
            "calls_mismatched": mism, "order": ["plain", "kernel", "kernel",
                                                "plain"],
            "versions": per, "host_syncs_per_attempt": syncs,
            "source": "TorchDispatchMode; the wrappers' launch counts; "
                      "torch.cuda.set_sync_debug_mode('warn'); "
                      "torch.profiler CUDA activity; perf_counter"}, ok


def _load_parent_dbgk(parent: str):
    """The parent's gpu/dbgk.py as a module of this package
    (lancet_tpu_torch.gpu._dbgk_parent), which builds the parent's
    csrc/dbg.cu beside it (both from `git archive <parent>
    lancet_tpu_torch/csrc/dbg.cu lancet_tpu_torch/gpu/dbgk.py`)."""
    import importlib.util

    path = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "gpu",
                        "dbgk.py")
    spec = importlib.util.spec_from_file_location(
        "lancet_tpu_torch.gpu._dbgk_parent", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BUILD_STAGES = ("mer_instances", "window_sort", "node_tables",
                "edge_tables")


def build_calls_ab(pmod, case: str, workdir: str,
                   region: str) -> tuple[dict, bool]:
    """build_call_ab on the largest card build_k call of one device-graph
    run of `region` (chip_smoke.instrument_devgraph's)."""
    import torch

    import chip_smoke as cs

    kept: dict = {}
    with cs.instrument_devgraph(kept, None):
        cs.run_devgraph(workdir, region, {})
    _, args, kw = kept["build_k"][:3]
    torch.cuda.synchronize()
    line, ok = build_call_ab(pmod, args, kw)
    return {"build_ab": case, "region": region, **line}, ok


def build_call_ab(pmod, args, kw) -> tuple[dict, bool]:
    """One build_k call built by the parent's kernels (pmod.build_k) and by
    this tree's, both held bit-equal (dtypes too) to build_k_plain; then in
    turns (parent, this; this, parent; ...), TURNS turns, the device time
    of each stage's kernels (their names hold the stage's in both trees;
    a profile counts where it holds each launch) and of the whole call
    (torch.profiler), and each of the six sorts alone on its keys (each
    tree's window_sort with its tree's build plan), every sort held equal
    to window_sort_plain; and this tree's node_tables and edge_tables kernels
    one by one (chip_smoke._BUILD_KERNELS), with each stage's device time
    a launch in both trees."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import dbg, dbgk

    want = dbg.build_k_plain(*args, **kw)
    fns = {"parent": lambda: pmod.build_k(*args, **kw),
           "this": lambda: dbgk.build_k(*args, **kw)}
    mism = {v: cs.dtype_mismatches(f(), want) for v, f in fns.items()}
    del want
    W, R, L = args[1].shape
    shape = (args[0], W, R, L, kw["Lraw"], kw["N"], kw["E"], kw["D"])
    plan, pplan = dbgk.build_plan(*shape), pmod.build_plan(*shape)
    # each stage's launches a call, by each tree's plan
    launches = {"parent": pplan.launches, "this": plan.launches}
    sorts = dbgk.build_sort_keys(*args, **kw)
    sort_fns = {
        name: {"parent": (lambda k=k, sp=pplan.sorts[name]:
                          pmod.window_sort(k, plan=sp)),
               "this": (lambda k=k, sp=sp: dbgk.window_sort(k, plan=sp))}
        for name, (k, sp) in sorts.items()}
    for name, (k, _) in sorts.items():
        w = dbg.window_sort_plain(k)
        for v, f in sort_fns[name].items():
            mism[f"{v}/{name}_sort"] = int(not torch.equal(f(), w))
    tables = ("node_tables", "edge_tables")
    kernels = {k: 1 for s in tables for k in cs._BUILD_KERNELS[s]}
    kdev = {k: [] for k in kernels}
    sort_launches = {name: {"parent": pplan.sorts[name].launches,
                            "this": sp.launches}
                     for name, (_, sp) in sorts.items()}
    dev = {v: {s: [] for s in (*BUILD_STAGES, "all")} for v in fns}
    sdev = {name: {v: [] for v in fns} for name in sorts}
    for turn in range(TURNS):
        order = ("parent", "this") if turn % 2 == 0 else ("this", "parent")
        for v in order:
            got = cs.device_ms_by_kernel(fns[v], list(BUILD_STAGES),
                                         launches=launches[v])
            for s, t in got.items():
                dev[v][s].append(t)
            if v == "this":
                got = cs.device_ms_by_kernel(fns[v], list(kernels),
                                             launches=kernels)
                for k in kernels:
                    kdev[k].append(got[k])
            for name, f in sort_fns.items():
                sdev[name][v].append(cs.device_ms_by_kernel(
                    f[v], ["window_sort"], launches={
                        "window_sort": sort_launches[name][v]})
                    ["window_sort"])
    return {"largest": {"K": args[0], "W": W, "R": R, "L": L,
                        "N": kw["N"], "E": kw["E"]},
            "mismatches": mism,
            "device_ms": {v: {s: _spread(t) for s, t in d.items()}
                          for v, d in dev.items()},
            "sort_device_ms": {name: {v: _spread(t) for v, t in d.items()}
                               for name, d in sdev.items()},
            "launches": launches,
            "kernel_device_ms": {k: _spread(t) for k, t in kdev.items()},
            "device_ms_per_launch": {
                v: {s: (None if not dev[v][s] or None in dev[v][s] else
                        _spread([t / launches[v][s] for t in dev[v][s]]))
                    for s in tables} for v in fns},
            "order": "turns of (parent, this) and (this, parent)",
            "source": "torch.profiler CUDA activity"}, not any(mism.values())


def _build_parent_bodies(parent: str) -> dict:
    """The parent's csrc/walks.cu and csrc/compress.cu, built beside this
    tree's and bound with this tree's seq_removal and compress_round entry
    points (whose signatures the split into csrc/removal_body.cuh and
    csrc/compress_body.cuh left as they were)."""
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu import compress
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    csrc = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "csrc")
    libs = {}
    for stem in ("walks", "compress"):
        src = os.path.join(csrc, f"{stem}.cu")
        libs[stem] = build_shared(src, f"lib{stem}_parent",
                                  [_nvcc()] + NVCC_FLAGS + [src])
    walks = ctypes.CDLL(libs["walks"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    walks.seq_removal.restype = ci
    walks.seq_removal.argtypes = ([vp] * 14 + [ci] * 6
                                  + [ctypes.c_longlong, ctypes.c_size_t, vp])
    return {"seq_removal": walks, "compress_round": compress.bind(
        libs["compress"])}


def bodies_ab(parent: str, workdir: str) -> tuple[list, bool]:
    """The two kernels whose bodies moved into headers, against the
    parent's: every seq_removal and compress_round call of device-graph
    case 1 with the cleanup's plain composition (cleanup_plain, whose
    removal passes and compressions launch these kernels), each launched
    as the parent's build and this tree's, the outputs bit-equal, and
    timed by their own device time (torch.profiler) in turns (parent,
    this, this, parent): summed over the calls (3 launches each) and on
    the largest call in TURNS turns of PER_TURN launches."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import compress, pipeline, walks

    libs = _build_parent_bodies(parent)
    calls: list = []
    real = pipeline.cleanup
    pipeline.cleanup = pipeline.cleanup_plain
    try:
        with cs.instrument_devgraph(None, None, calls):
            cs.run_devgraph(workdir, cs.DEVGRAPH_REGION, {})
    finally:
        pipeline.cleanup = real
    torch.cuda.synchronize()

    def launchers(name, args, kw):
        if name == "seq_removal":
            def run(lib):
                def f():
                    saved = walks._lib
                    walks._lib = lib
                    try:
                        return walks.seq_removal(*args, **kw)
                    finally:
                        walks._lib = saved
                return f
            return run(libs[name]), run(walks._load())

        def run(lib):
            def f():
                outs, fb = compress._launch(*args, **kw, lib=lib)
                return (*outs, fb)
            return f
        return run(libs[name]), run(compress._load())

    lines, ok = [], True
    for name, kernel in (("seq_removal", "seq_removal_kernel"),
                         ("compress_round", "compress_kernel")):
        mine = [(a, k) for n, a, k, _, _ in calls if n == name]
        if name == "compress_round":  # the wrapper's inputs as _launch's
            mine = [(a[:4], {"Dcap": a[4] if len(a) > 4 else
                             k.get("Dcap", 64)}) for a, k in mine]
        mism, total = 0, {"parent": [], "this": []}
        largest, work = None, -1
        for args, kw in mine:
            par, new = launchers(name, args, kw)
            a, b = par(), new()
            torch.cuda.synchronize()
            mism += cs._mismatches(b, a) > 0
            for ver, fn in (("parent", par), ("this", new)):
                total[ver].append(cs.device_ms(fn, kernel, 3))
            w = int(args[0]["alive"].sum())
            if w > work:
                largest, work = (args, kw), w
        dev = {"parent": [], "this": []}
        if largest is not None:
            par, new = launchers(name, *largest)
            for turn in range(TURNS):
                order = (("parent", par), ("this", new))
                for ver, fn in (order if turn % 2 == 0 else order[::-1]):
                    dev[ver].append(cs.device_ms(fn, kernel, PER_TURN))
        lines.append({
            "body_ab": name, "calls": len(mine), "calls_mismatched": mism,
            "largest_alive_items": work,
            "device_ms_largest": {v: _spread(t) for v, t in dev.items()},
            "device_ms_all_calls": {
                v: {"sum": sum(t for t in ts if t is not None),
                    "missed": sum(t is None for t in ts)}
                for v, ts in total.items()},
            "source": "torch.profiler CUDA activity"})
        ok &= mism == 0 and bool(mine)
    return lines, ok


def _build_parent_kernels(parent: str) -> dict:
    """The parent's csrc/compress.cu and csrc/cleanup.cu (and the headers
    beside them), built beside this tree's, their entry points as the
    parent declared them."""
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    csrc = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "csrc")
    libs = {}
    vp, ci, ll, sz = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_size_t)
    for stem in ("compress", "cleanup"):
        src = os.path.join(csrc, f"{stem}.cu")
        libs[stem] = ctypes.CDLL(build_shared(
            src, f"lib{stem}_parent", [_nvcc()] + NVCC_FLAGS + [src]))
    c, f = libs["compress"], libs["cleanup"]
    c.compress_round.restype = ci
    c.compress_round.argtypes = [vp, vp] + [ci] * 4 + [ll] * 3 + [sz, vp]
    c.compress_smem.restype = sz
    c.compress_smem.argtypes = [ci] * 3
    f.tip_fixpoint.restype = ci
    f.tip_fixpoint.argtypes = [vp] * 11 + [ci] * 8 + [ll] * 4 + [sz, vp]
    f.tip_fixpoint_smem.restype = sz
    f.tip_fixpoint_smem.argtypes = [ci] * 4
    return libs


def parent_compress_round(lib, st, K, NI, N, Dcap=64):
    """compress.compress_round's result from the parent's kernel (one
    block a window)."""
    import torch

    from lancet_tpu_torch.gpu import compress

    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    dev = st["alive"].device
    shape = {"i": (W, NI), "i4": (W, NI, 4), "e": (W, EE), "m": (W, NM)}
    outs = [torch.empty(shape[ax], dtype=dt, device=dev)
            for _, dt, ax in compress.OUTPUTS]
    fb = torch.empty((W,), dtype=torch.bool, device=dev)
    ins = [st[k].contiguous() for k in compress.INPUT_KEYS]
    ip = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    op = (ctypes.c_void_p * (len(outs) + 1))(
        *[t.data_ptr() for t in outs], fb.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.compress_round(ip, op, W, NI, EE, NM, int(N), int(K),
                                int(Dcap), lib.compress_smem(NI, EE, NM),
                                compress.stream(dev))
    if rc != 0:
        raise RuntimeError(f"the parent's compress_round: CUDA error {rc}")
    out = dict(st)
    out.update(zip(compress.OUTPUT_KEYS, outs))
    return out, fb


def parent_tip_fixpoint(lib, st, cond, K, N, NI, U, D2, rounds, fallback,
                        Dcap=64, inplace=False):
    """cleanup.tip_fixpoint's result from the parent's kernel (one
    cooperative launch, one block a window)."""
    import torch

    from lancet_tpu_torch.gpu import cleanup, compress

    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    dev = st["alive"].device
    shape = {"i": (W, NI), "i4": (W, NI, 4), "e": (W, EE), "m": (W, NM)}
    extra = cleanup._cond_tensors(cond)
    links = cond[0] == "links"
    outs = ([st[k] for k in cleanup.STATE_KEYS] if inplace else
            [torch.empty(shape[ax], dtype=dt, device=dev)
             for _, dt, ax in cleanup.STATE])
    fb_out = torch.empty((W,), dtype=torch.bool, device=dev)
    hits = (None if links else
            torch.empty((max(int(rounds), 1) * W,), dtype=torch.uint8,
                        device=dev))
    ins = [st[k].contiguous() for k in cleanup.STATE_KEYS]
    side = [st["special"].contiguous(), st["rank"].contiguous()] + [
        None if t is None else t.contiguous() for t in extra]
    with torch.cuda.device(dev):
        rc = lib.tip_fixpoint(
            cleanup._ptrs(ins), cleanup._ptrs(outs),
            *[None if t is None else t.data_ptr() for t in side],
            fallback.contiguous().data_ptr(), fb_out.data_ptr(),
            None if hits is None else hits.data_ptr(), W, NI, EE, NM, U, D2,
            int(links), int(rounds), int(cond[1]), int(N), int(K),
            int(Dcap), lib.tip_fixpoint_smem(NI, EE, NM, U),
            compress.stream(dev))
    if rc != 0:
        raise RuntimeError(f"the parent's tip_fixpoint: CUDA error {rc}")
    out = dict(st)
    out.update(zip(cleanup.STATE_KEYS, outs))
    return out, fb_out


def _build_parent_graphstate(parent: str) -> ctypes.CDLL:
    """The parent's csrc/graphstate.cu built beside this tree's, its
    low-coverage entry points as the parent declared them (one block a
    window): item_mincovs(2 pointers, 4 ints, long long, size_t, stream),
    low_cov_pass(2 pointers, 5 ints, 2 long longs, size_t, stream),
    lowcov_smem(2 ints)."""
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    src = os.path.join(os.path.abspath(parent), "lancet_tpu_torch", "csrc",
                       "graphstate.cu")
    lib = ctypes.CDLL(build_shared(src, "libgraphstate_parent",
                                   [_nvcc()] + NVCC_FLAGS + [src]))
    vp, ci, ll, sz = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_size_t)
    lib.item_mincovs.restype = ci
    lib.item_mincovs.argtypes = [vp, vp] + [ci] * 4 + [ll, sz, vp]
    lib.low_cov_pass.restype = ci
    lib.low_cov_pass.argtypes = [vp, vp] + [ci] * 5 + [ll, ll, sz, vp]
    lib.lowcov_smem.restype = sz
    lib.lowcov_smem.argtypes = [ci, ci]
    return lib


def parent_item_mincovs(lib, st, K, N, NI):
    """graphstate.item_mincovs' result from the parent's kernel."""
    import torch

    from lancet_tpu_torch.gpu import compress, graphstate as gs

    W, NM = st["mer_item"].shape
    dev = st["mer_item"].device
    mincov = torch.empty((W, NI), dtype=torch.int64, device=dev)
    mincov_qv = torch.empty((W, NI), dtype=torch.int64, device=dev)
    totq, ws = gs._totq_rows(st["mer_totq"])
    ins = [totq] + [st[k].contiguous() for k, _, _ in gs.MINCOV_INPUTS[1:]]
    with torch.cuda.device(dev):
        rc = lib.item_mincovs(gs._ptrs(ins), gs._ptrs([mincov, mincov_qv]),
                              W, NI, NM, int(K), ws, lib.lowcov_smem(NI, 0),
                              compress.stream(dev))
    if rc != 0:
        raise RuntimeError(f"the parent's item_mincovs: CUDA error {rc}")
    return mincov, mincov_qv


def parent_low_cov_pass(lib, st, K, N, NI, low_cov_threshold, min_cov_ratio,
                        avgcov):
    """graphstate.low_cov_pass' result from the parent's kernel."""
    import torch

    from lancet_tpu_torch.gpu import compress, graphstate as gs

    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    dev = st["alive"].device
    thr = (min_cov_ratio * avgcov).contiguous()
    alive = torch.empty((W, NI), dtype=torch.bool, device=dev)
    e_alive = torch.empty((W, EE), dtype=torch.bool, device=dev)
    low_any = torch.empty((W,), dtype=torch.bool, device=dev)
    totq, ws = gs._totq_rows(st["mer_totq"])
    ins = ([totq] + [st[k].contiguous() for k, _, _ in gs.LOWCOV_INPUTS[1:]]
           + [thr])
    with torch.cuda.device(dev):
        rc = lib.low_cov_pass(gs._ptrs(ins), gs._ptrs([alive, e_alive,
                                                        low_any]),
                              W, NI, EE, NM, int(K), ws,
                              int(low_cov_threshold), lib.lowcov_smem(NI, 1),
                              compress.stream(dev))
    if rc != 0:
        raise RuntimeError(f"the parent's low_cov_pass: CUDA error {rc}")
    out = dict(st)
    out["alive"] = alive
    out["e_alive"] = e_alive
    return out, low_any


# the kernel each A/B times, by this tree's wrapper; its parent's version
# (its library's key in `libs`, the function); what a call's work counts
_AB_KERNELS = {"compress_round": "compress_kernel",
               "tip_fixpoint": "tip_fixpoint_kernel",
               "low_cov_pass": "lowcov_kernel",
               "item_mincovs": "lowcov_kernel"}
_AB_PARENT = {"compress_round": ("compress", parent_compress_round),
              "tip_fixpoint": ("cleanup", parent_tip_fixpoint),
              "low_cov_pass": ("graphstate", parent_low_cov_pass),
              "item_mincovs": ("graphstate", parent_item_mincovs)}
_AB_WORK = {"compress_round": "alive_items", "tip_fixpoint": "alive_items",
            "low_cov_pass": "donating_mers_x_K",
            "item_mincovs": "donating_mers_x_K"}


def kernels_ab(names, libs: dict, case: str, workdir: str,
               region: str) -> tuple[list, bool]:
    """Every card call of each of `names` (compress_round, tip_fixpoint,
    low_cov_pass, item_mincovs) of one device-graph run of `region`,
    launched as the parent's kernel and as this tree's, bit-equal (dtypes
    too; an in-place call each on a copy of its inputs as captured), the
    device time summed over the calls (3 launches each), and on the
    largest call of each item axis (compress_round), mode (tip_fixpoint)
    or function in TURNS turns of PER_TURN launches, alternating (parent,
    this; this, parent; ...), with this tree's cluster size and its grid's
    blocks from the profiler's records. Returns (JSON lines, every call
    equal)."""
    import torch

    import chip_smoke as cs

    calls: list = []
    with cs.instrument_devgraph(None, None, calls):
        cs.run_devgraph(workdir, region, {})
    torch.cuda.synchronize()
    lines, ok = [], True
    for name in names:
        more, eq = _kernel_calls_ab(name, libs, case, calls)
        lines += more
        ok &= eq
    return lines, ok


def _shape(name: str, args) -> tuple:
    """(W, NI, EE, NM) of a captured call (item_mincovs' state holds
    neither items nor edges: NI its argument, EE 0)."""
    st = args[0]
    W, NM = st["mer_item"].shape
    if name == "item_mincovs":
        return W, args[3], 0, NM
    return W, st["alive"].shape[1], st["e_src"].shape[1], NM


def _plan(name: str, args):
    """This tree's plan for a captured call of `name` (its cluster size)."""
    from lancet_tpu_torch.gpu import cleanup, compress, graphstate

    W, NI, EE, NM = _shape(name, args)
    on = args[0]["mer_item"].device
    if name == "compress_round":
        return compress.plan_for(W, NI, EE, NM, on)
    if name == "tip_fixpoint":
        return cleanup.plan_for(W, NI, EE, NM, args[5], args[6], on)
    return graphstate.lowcov_plan(NI, NM, args[1], name == "low_cov_pass",
                                  EE)


def _kernel_calls_ab(name: str, libs: dict, case: str,
                     calls: list) -> tuple[list, bool]:
    """kernels_ab on the captured calls of one function."""
    import torch

    import chip_smoke as cs
    from lancet_tpu_torch.gpu import cleanup, compress, graphstate

    mine = [(a, k) for n, a, k, _, _ in calls if n == name]
    kernel = _AB_KERNELS[name]
    lib_key, parent_fn = _AB_PARENT[name]
    this_fn = {"compress_round": compress.compress_round,
               "tip_fixpoint": cleanup.tip_fixpoint,
               "low_cov_pass": graphstate.low_cov_pass,
               "item_mincovs": graphstate.item_mincovs}[name]

    def launchers(args, kw):
        fresh = lambda: [cs._tree(x, lambda t: t.clone() if torch.is_tensor(t)
                                  else t) for x in args]
        if name != "tip_fixpoint":
            def par():
                return parent_fn(libs[lib_key], *args, **kw)

            def new():
                return this_fn(*args, **kw)
            return par, new, par, new
        inplace = kw.get("inplace", False)
        pa, na = fresh(), fresh()  # the timed calls' own copies

        def par(a=pa):
            return parent_fn(libs[lib_key], *a, **kw)

        def new(a=na):
            return this_fn(*a, **kw)

        def par_check():
            return parent_fn(libs[lib_key], *fresh(), **kw)

        def new_check():
            return this_fn(*fresh(), **kw)
        return ((par_check, new_check, par, new) if inplace
                else (par, new, par, new))

    def out(res):
        return cs._walk_out(name, res)

    mism, total = 0, {"parent": [], "this": []}
    largest: dict = {}
    for args, kw in mine:
        pc, nc, par, new = launchers(args, kw)
        a, b = out(pc()), out(nc())
        torch.cuda.synchronize()
        mism += cs.dtype_mismatches(b, a) > 0
        for ver, fn in (("parent", par), ("this", new)):
            total[ver].append(cs.device_ms(fn, kernel, 3))
        key = cs._kept_key(name, args)
        work = cs._walk_work(name, args)
        if key not in largest or largest[key][0] < work:
            largest[key] = (work, args, kw)
    lines = []
    for key, (work, args, kw) in sorted(largest.items()):
        _, _, par, new = launchers(args, kw)
        dev = {"parent": [], "this": []}
        for turn in range(TURNS):
            order = (("parent", par), ("this", new))
            for ver, fn in (order if turn % 2 == 0 else order[::-1]):
                dev[ver].append(cs.device_ms(fn, kernel, PER_TURN))
        W, NI, EE, NM = _shape(name, args)
        lines.append({
            "kernel_ab": key, "case": case, "W": W, "NI": NI, "EE": EE,
            "NM": NM, _AB_WORK[name]: work,
            **({"K": int(args[1])} if name in cs._LOWCOV else {}),
            **cs.cluster_grid(new, kernel, W, _plan(name, args)),
            "device_ms": {v: _spread(t) for v, t in dev.items()},
            "source": "torch.profiler CUDA activity"})
    lines.append({
        "kernel_ab": name, "case": case, "calls": len(mine),
        "calls_mismatched": mism,
        "device_ms_all_calls": {
            v: {"sum": sum(t for t in ts if t is not None),
                "missed": sum(t is None for t in ts)}
            for v, ts in total.items()},
        "source": "torch.profiler CUDA activity"})
    return lines, mism == 0 and bool(mine)


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
    ap.add_argument("--parent",
                    help="a directory holding the parent's "
                         "lancet_tpu_torch/csrc/walks.cu, "
                         "lancet_tpu_torch/csrc/repeats.cu and "
                         "lancet_tpu_torch/csrc/screens.cu (with --only "
                         "screens, compress, cleanup or graphstate: that "
                         "part's sources, the kernels' A/B)")
    ap.add_argument("--only", choices=("walks", "removal", "gates",
                                       "screens", "compress", "graphstate",
                                       "cleanup", "build", "bodies"),
                    help="time only the walks, the removal pass, the "
                         "repeat gates, the screens, the compression "
                         "pass, the graphstate functions, the cleanup or "
                         "the build")
    ap.add_argument("--turns", type=int, default=2,
                    help="end-to-end runs of each version in the "
                         "device-graph A/B (--only screens, compress, "
                         "graphstate, cleanup or build), in turns (A, B, "
                         "B, A, ...): an even count")
    a = ap.parse_args()
    if a.only not in PLAIN_AB and not a.parent:
        ap.error("--parent is needed unless --only screens, compress, "
                 "graphstate, cleanup or build")
    if a.turns < 2 or a.turns % 2:
        ap.error("--turns takes an even count of at least 2")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: walks_ab.py needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lancet_tpu_torch import corpus

    if a.only == "bodies":
        workdir = os.path.join(HERE, "build", "smoke_corpus")
        corpus.write_default_corpus(workdir)
        lines, ok = bodies_ab(a.parent, workdir)
        for line in lines:
            print(json.dumps(line), flush=True)
        print(cs.nvidia_smi(), flush=True)
        print(json.dumps({"ok": ok}), flush=True)
        return 0 if ok else 1
    if a.only == "screens" and a.parent:
        lines, ok = screens_parent_ab(_build_parent_screens(a.parent))
        for line in lines:
            print(json.dumps(line), flush=True)
        print(cs.nvidia_smi(), flush=True)
        print(json.dumps({"ok": ok}), flush=True)
        return 0 if ok else 1
    if a.only in ("compress", "cleanup", "graphstate") and a.parent:
        import functools

        from lancet_tpu_torch.gpu import cleanup, compress, stages

        libs = (_build_parent_kernels(a.parent) if a.only != "graphstate"
                else {"graphstate": _build_parent_graphstate(a.parent)})
        workdir = os.path.join(HERE, "build", "smoke_corpus")
        corpus.write_default_corpus(workdir)
        hdir = os.path.join(HERE, "build", "smoke_hard")
        os.makedirs(hdir, exist_ok=True)
        refseq, tumor, normal, hregion = corpus.hard_corpus()
        corpus.write_pair(hdir, refseq, "chr1", tumor, normal)
        names = {"compress": ("compress_round",),
                 "cleanup": ("tip_fixpoint",),
                 "graphstate": ("low_cov_pass", "item_mincovs")}[a.only]
        ok = True
        for case, wd, region in (("devgraph_case_1", workdir,
                                  cs.DEVGRAPH_REGION),
                                 ("hard", hdir, hregion)):
            lines, eq = kernels_ab(names, libs, case, wd, region)
            for line in lines:
                print(json.dumps(line), flush=True)
            ok &= eq
            if a.only == "graphstate":
                lib = libs["graphstate"]
                line, eq = plain_ab(
                    "lowcov", case, wd, region,
                    {"parent": (functools.partial(parent_low_cov_pass, lib),
                                functools.partial(parent_item_mincovs, lib)),
                     "this": (stages.low_cov_pass, stages.item_mincovs)},
                    a.turns)
                print(json.dumps(line), flush=True)
                ok &= eq
            if a.only == "cleanup":
                line, eq = plain_ab(
                    "clusters", case, wd, region,
                    {"parent": (functools.partial(parent_compress_round,
                                                  libs["compress"]),
                                functools.partial(parent_tip_fixpoint,
                                                  libs["cleanup"])),
                     "this": (compress.compress_round,
                              cleanup.tip_fixpoint)}, a.turns)
                print(json.dumps(line), flush=True)
                ok &= eq
        print(cs.nvidia_smi(), flush=True)
        print(json.dumps({"ok": ok}), flush=True)
        return 0 if ok else 1
    if a.only == "build" and a.parent:
        from lancet_tpu_torch.gpu import dbg

        pmod = _load_parent_dbgk(a.parent)
        workdir = os.path.join(HERE, "build", "smoke_corpus")
        corpus.write_default_corpus(workdir)
        hdir = os.path.join(HERE, "build", "smoke_hard")
        os.makedirs(hdir, exist_ok=True)
        refseq, tumor, normal, hregion = corpus.hard_corpus()
        corpus.write_pair(hdir, refseq, "chr1", tumor, normal)
        ok = True
        for case, wd, region in (("devgraph_case_1", workdir,
                                  cs.DEVGRAPH_REGION),
                                 ("hard", hdir, hregion)):
            line, eq = build_calls_ab(pmod, case, wd, region)
            print(json.dumps(line), flush=True)
            ok &= eq
            line, eq = plain_ab("build", case, wd, region,
                                {"parent": (pmod.build_k,),
                                 "this": (dbg.build_k,)}, a.turns)
            print(json.dumps(line), flush=True)
            ok &= eq
        print(cs.nvidia_smi(), flush=True)
        print(json.dumps({"ok": ok}), flush=True)
        return 0 if ok else 1
    if a.only in PLAIN_AB:
        workdir = os.path.join(HERE, "build", "smoke_corpus")
        corpus.write_default_corpus(workdir)
        hdir = os.path.join(HERE, "build", "smoke_hard")
        os.makedirs(hdir, exist_ok=True)
        refseq, tumor, normal, hregion = corpus.hard_corpus()
        corpus.write_pair(hdir, refseq, "chr1", tumor, normal)
        ok = True
        for case, wd, region in (("devgraph_case_1", workdir,
                                  cs.DEVGRAPH_REGION),
                                 ("hard", hdir, hregion)):
            if a.only == "cleanup":
                line, eq = cleanup_calls_ab(case, wd, region)
                print(json.dumps(line), flush=True)
                ok &= eq
            line, eq = plain_ab(a.only, case, wd, region, turns=a.turns)
            print(json.dumps(line), flush=True)
            ok &= eq
        print(cs.nvidia_smi(), flush=True)
        print(json.dumps({"ok": ok}), flush=True)
        return 0 if ok else 1
    parent_lib = None if a.only == "gates" else _build_parent(a.parent)
    parent_gates = (_build_parent_gates(a.parent)
                    if a.only in (None, "gates") else None)
    workdir = os.path.join(HERE, "build", "smoke_corpus")
    region = corpus.write_default_corpus(workdir)
    advdir = os.path.join(HERE, "build", "smoke_adversarial")
    os.makedirs(advdir, exist_ok=True)
    refseq, tumor, normal, adv_region = corpus.adversarial_corpus()
    corpus.write_pair(advdir, refseq, "chr1", tumor, normal)
    kept: dict = {}
    calls: list = []
    gates: list = []
    passes: list = []
    with cs.capture_gates(gates), capture_passes(passes), \
            cs.instrument_devgraph(kept, None, calls):
        cs.run_devgraph(workdir, cs.DEVGRAPH_REGION, {})
        cs.run_devgraph(advdir, adv_region, {}, num_threads=2)
    torch.cuda.synchronize()

    ok = True
    if a.only in (None, "removal"):
        lines, rok = removal_ab(passes, parent_lib)
        for line in lines:
            print(json.dumps(line), flush=True)
        line, eok = removal_e2e(parent_lib, workdir)
        print(json.dumps(line), flush=True)
        ok &= rok and eok
    if a.only in (None, "walks"):
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
    if a.only in (None, "gates"):
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
