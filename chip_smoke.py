#!/usr/bin/env python3
"""Smoke run of lancet_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name and count, and nvidia-smi's name and power
     limit;
  2. build: the native C++ plane (g++) and the eight CUDA kernel libraries
     (nvcc, sm_90a: csrc/gotoh.cu, csrc/repeats.cu, csrc/walks.cu,
     csrc/screens.cu, csrc/compress.cu, csrc/graphstate.cu,
     csrc/cleanup.cu, csrc/dbg.cu), built side by side
     from the sources in the checkout; the SASS instruction counts per
     cell of the fused Gotoh kernel's fill loop and per step of its
     traceback loop, for each instantiation, with the DPX opcodes the fill
     loop holds, and the toolkit headers that declare __vibmax_s32; the
     SASS counts per word of the repeat-gate kernel's two word loops;
  3. gates, one line per case: the kernel repeat_gates held bit-equal to
     the plain PyTorch version gates_plain on the card, on all 5,195
     default-corpus windows (the two-phase path's call: timed with CUDA
     events and by its own device time beside the plain version and the
     card's bounds), on the adversarial windows of
     tests/test_torch_repeats.py for several ks lists and max_mismatch,
     and on every crafted case of gpu/gatecases.py, each also at the
     GATE_FORCED (blocks, threads, tile) launches;
  4. main path: the default corpus (520 kb, 5,195 windows) through
     runner.run(device="cuda") with 8 threads, the Gotoh kernel's launch
     counts (one shared-memory-mode launch per DP group), then the runs
     with device="cuda" and device="cpu" over CPU_COMPARE_REGION (401 of
     its windows); those two VCFs must be byte-equal. Every DP group the
     first cuda run dispatched is kept. Then the main path at
     --window-size 9,000 (long_window), on cuda, and on cuda and cpu over
     a part of the region (LONG_CPU_REGIONS) with equal VCFs,
     on a region of the default corpus (whose reads are tiled in 2 kb
     segments, so no DP pair there reaches 2 kb) and on
     corpus.long_window_corpus (reads tiled over 10 kb), whose DP pairs
     pass 8,192 bases and take gotoh_align's strip mode; the largest N
     that reached gotoh_align is printed;
  5. engine_path: the same corpus through the two-phase process pool,
     runner.run(processes=True, engine="batched", device="cuda") with the
     native shard runner off and 8 workers; its VCF and stderr summary
     must equal the main path's, no worker may die, and both kernels must
     launch;
  6. fallback: a 400-window part of the corpus with two native windows
     forced into the replay, which runs them on the per-window engine on
     the card; the VCF must equal the unforced run's;
  7. devgraph, two cases, the device graph engine (LANCET_TPU_DEVGRAPH=1,
     device="cuda"): case 1 the JAX bench's device-graph region
     chr1:300-120000 (1,198 windows, 8 threads), its VCF and summary equal
     to the native main path's on the region and its device-graph stats
     equal to the JAX package's there; case 2 the adversarial windows of
     corpus.adversarial_corpus (STR runs, near repeats, homopolymers, dense
     hets, internal tandem duplications whose cycles reach the exact cycle
     replay), its VCF equal to the native path's; the four walk kernels
     (csrc/walks.cu) and the two screens (csrc/screens.cu: cycle_screen on
     both cases, tandem_at on case 2) must launch, gotoh_align and
     repeat_gates too on case 1; every path_cover, seq_removal (the whole
     removal pass: seq_removal_pass_plain), almost_repeat_paths, cycle_dfs,
     tandem_at and cycle_screen launch of case 1's second run, of case 2
     and of phase mesh (b) is held bit-equal to the plain version on its
     own inputs; a removal pass of case 2 takes at most
     REMOVAL_MAX_ATEN_OPS aten ops on the card (its launch and its
     outputs' allocation), a screen call SCREEN_MAX_ATEN_OPS; every
     repeat_gates call of case
     1's second run and of case 2 is held against gates_plain, and the one
     with the most (shift, position) pairs timed with its bounds (a gates
     line); the calls and aten ops of the _OP_COUNTED functions of both
     cases' instrumented runs; then one kernels line per walk: the call
     with the most work of the two cases, its outputs bit-equal to the
     plain version on the card, timed beside it, the card's bound and the
     walk's chain floor (its longest serial chain of steps times the
     latency of a dependent shared-memory load, measured here); and one
     kernels line per screen: its call with the most work, bit-equal to
     the plain version on the card, timed beside it (CUDA events, its own
     device time), its aten ops a call and the plain version's, the
     card's bound on this data and the screen's chain floor
     (screen_accounting); every compress_round call of both cases (and of
     phase mesh (b)) held bit-equal, dtypes too, to compress_round_plain on
     the card, at most COMPRESS_MAX_ATEN_OPS aten ops a call, and one
     kernels line for its largest call at each item axis (NI 1,552 and
     528) with the plain version's time, the byte bound, the chain floor
     (compress_accounting: the slowest window's jumping rounds), the
     blocks of its grid and its cluster size, blocks / W, from the
     profiler's records (cluster_grid, which fails the phase unless they
     are W whole clusters of the wrapper's plan's size);
     every components, compact_state, low_cov_pass and item_mincovs call
     of both cases (and of phase mesh (b)) held bit-equal, dtypes too, to
     its plain version on the card and run again under
     torch.cuda.set_sync_debug_mode("error") (one launch, no host sync), at
     most GRAPHSTATE_MAX_ATEN_OPS aten ops a call, and one kernels line for
     each one's largest call with the plain version's time and the bound
     on this data (graphstate_accounting); every cleanup call of both
     cases (and of phase mesh (b)) held bit-equal, dtypes too, to
     cleanup_plain on its inputs on the card (the composition with host
     bools, whose stages launch their own kernels: each of those calls,
     the removal pass's K2 among them, held against its plain version in
     turn, the largest kept for its kernels line) and run again under
     set_sync_debug_mode("error") with its eight launches; every
     tip_fixpoint and short_link_strings call held against its plain
     version, and one kernels line for the largest tips-mode, links-mode
     and strings call with the plain version's time and the bound on this
     data (cleanup_accounting; tip_fixpoint's cluster size and grid, as
     compress_round's), at most CLEANUP_MAX_ATEN_OPS a call;
     every build_k call of both cases (and of phase mesh (b)) held
     bit-equal, dtypes too, to build_k_plain on its inputs on the card and
     run again under set_sync_debug_mode("error") with the launches of
     csrc/dbg.cu its plan fixes (dbgk.build_plan's launches), at most
     BUILD_MAX_ATEN_OPS aten ops a call, and one kernels line for each of
     mer_instances, window_sort, node_tables and edge_tables on the
     largest call, each on its own inputs (the plain stages before it),
     with the plain version's time, the bound on this data
     (build_accounting) and, for window_sort, one stable torch.sort of a
     key word at the same shape; on that call also each of the build's
     six sorts alone (build_sorts_case: its device time beside its bound,
     one stable torch.sort of its keys where it has one key word, the
     plain lexsort chain where more) and the whole build's device time;
     case 1's timed run also splits t_dg_pack
     into pack_chunk, the H2D copy and build_k's dispatch (pack_split);
  7b. hard: the JAX benchmark's hard corpus (corpus.hard_corpus, 1,995
     windows, 8 threads): the main path on cuda (and on cuda and cpu over
     HARD_CPU_REGION, ~600 of its windows, with equal VCFs and summaries),
     BENCH_r05's 183 records and KMERSIZE histogram, its 201 DP
     pairs through gotoh_align; the device graph engine on the same
     region, timed, then instrumented, then profiled: its VCF and summary
     equal to the main path's, its stats equal to HARD_DEVGRAPH_STATS
     (windows replayed past k 63 and at the pipeline's caps, each with its
     site's family), every walk, screen and repeat_gates call held
     bit-equal to its plain version, the aten ops of the _OP_COUNTED
     functions (at most SCREEN_MAX_ATEN_OPS a screen call,
     COMPRESS_MAX_ATEN_OPS a compress_round call, GRAPHSTATE_MAX_ATEN_OPS
     a graphstate call, each graphstate call also free of host syncs; each
     cleanup call against cleanup_plain as in phase 7, each build_k call
     against build_k_plain), t_dg_pack split as in phase 7, and one
     kernels line per walk, screen, graphstate function, cleanup loop and
     build kernel on its largest call there, and per item axis for
     compress_round;
  7c. lr: the JAX benchmark's linked-reads corpus (corpus.lr_corpus, 595
     windows, lr_mode): the main path on cuda and cpu, then with
     LANCET_TPU_DEVGRAPH=1 (the runner keeps LR on the native path: no
     walk kernel launches), then the two-phase process pool with the
     native runner off (every repeat_gates call held against
     gates_plain); every VCF equal, 29 records;
  7d. dp_parity, one line per run: gotoh_align against its plain
     versions on the DP pairs the run sampled (stats["dp_samples"]: the
     default corpus's main path, the hard corpus's main path and device
     graph run), every op and count equal;
  8. mesh, one line per case: (a) the main path with make_mesh() (every
     card) and with a 4-entry mesh over cuda:0 (and, with two cards or
     more, make_mesh(2) over distinct cards), each VCF and summary equal to
     the unsharded main path's, one gotoh_align launch for each non-empty
     shard of each DP group; (b) device-graph case 1 over meshes of 1, 2
     and 4 entries of cuda:0, each VCF, summary, n_dev_windows and
     dev_fallback_causes equal to the unsharded devgraph run's and its
     mesh_counters equal to the sums over that run's attempt outputs, with
     t_devgraph beside the unsharded one (whether shard threads overlap
     on one card); (c) two processes
     started by this script (gloo, each on cuda:{rank % card count}) run
     parallel.multihost.run_multihost on the default corpus: process 0's
     VCF equals the main path's, both exit 0 within their limit, and no
     process of theirs is left; (d) the main path with LANCET_TPU_GATES=1
     against the main path without it, alternating (GATES_AB): every VCF
     equals the main path's and repeat_gates launched in every run with
     the sweep; every chunk of the first run with the sweep is held
     against gates_plain (a gates line);
  9. kernels, one line per case: the fused kernel gotoh_align on each kept
     group's own pairs, on the tie-heavy pairs of tests/test_torch_align.py,
     on one seeded group of 132 related pairs of ~1,100 bp whose codes
     do not fit in shared memory (global mode), and on S of 8,193 to
     20,000 bases (long_ref, the strip mode); its ops and counts held
     bit-equal to the plain PyTorch versions run on the card, and timed
     with CUDA events beside the plain versions and the card's bound;
     path_cover, cycle_dfs, almost_repeat_paths and seq_removal on the
     crafted cases of gpu/walkcases.py (each staging mode; K3's word and
     tile edges; the removal pass's chained kills, ties, overflows and
     empty windows, one launch each), and tandem_at and cycle_screen on
     the batches of gpu/screencases.py (at its TANDEM_PARAMS and
     SCREEN_ROUNDS), compress_round on the batches of
     gpu/compresscases.py (also at each cluster size its plan takes where
     it is forced to), and components, compact_state, item_mincovs and
     low_cov_pass on the batches of gpu/statecases.py (under
     set_sync_debug_mode("error"); compact_state's hold-point flag on
     dead_edge_batch's first lane alone; the low-coverage kernels also at
     each cluster size, forced), one launch each, held bit-equal
     to the plain versions; the cleanup on the batches of
     gpu/cleanupcases.py, free of host syncs with its eight launches,
     bit-equal (dtypes too) to cleanup_plain (and tip_fixpoint's tips call
     at each cluster size, bit-equal to tip_fixpoint_plain); and build_k on the crafted
     windows of gpu/buildcases.py at every bucket's shape (the hub at
     HUB_D), free of host syncs with its plan's launches, bit-equal
     (dtypes too) to build_k_plain.
Then the kernels' summary line, nvidia-smi's line, and last the device
line. Every path's launch counts are set to 0 just before it runs and read
just after. Any failure exits non-zero before the last line. Without a
CUDA device, or without the package beside this script, it exits non-zero
and prints no result. (`--mh-worker ...` runs one process of case (c); the
script starts those itself.)
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
# Integer issue rate: an SM issues at most 4 warp instructions a clock, 128
# lanes, whatever the mix of INT32-pipe (64 lanes) and IMAD-on-FMA-pipe (64
# lanes) instructions, so SMs x 128 x SM clock bounds any integer work.
ISSUE_LANES_PER_SM_CLK = 128
# Integer operations the function needs, derived by hand with Hopper's
# DPX instructions (csrc/gotoh.cu): per interior cell 17 (X 2: an add and
# an add-and-max; the bit "X opened" 2; Y 3: an add, an add-and-max, a
# mask; the substitution 3: compare, select, add; M 1: a three-way max;
# M's tag 3: two adds, a three-way max; the 4-bit code 3 funnel shifts);
# per traceback step 10 (the code word's address 2, its load, the nibble's
# extract 2, the state machine's tests 2, the moves of i, j and the flag
# 2, the op store). The bound takes the smaller of these and the SASS
# count.
FILL_OPS_PER_CELL = 17
TRACE_OPS_PER_STEP = 10
# Integer operations of the repeat-gate function a (shift, position) pair
# at max_mismatch 2, by hand: the byte compare, the three selects of a
# mismatch ring, and two add-and-max (the zero run and the stretch); kept
# as a function-level count so that the repeat_gates row of PERF.md stays
# comparable from one design to the next.
GATE_OPS_PER_STEP = 6
# The redesigned kernel's own count of what a batch needs under its plan
# (csrc/repeats.cu, whose work counters give the words and tests of a
# launch): 72 a mismatch word of 32 positions built from bytes (9 a 4
# positions, as K3's WALK_OPS: the shifted word's load and funnel shift,
# the xor, the carry-free byte test's and, add and or-and, the gathering
# multiply and shift, the insert), 10 one built from the two bit planes of
# a window of A, C, G and T (3 paired loads, 3 address operations, 2
# funnel shifts, 2 xor-or), 4 a window test (a funnel shift, the mask, the
# popcount, the compare); a position of the plain scan GATE_OPS_PER_STEP.
# Each word count is the smaller of this and the SASS count of its word
# loop.
GATE_OPS_PER_WORD = 72
GATE_OPS_PER_PLANE_WORD = 10
GATE_OPS_PER_TEST = 4
GATE_ODD_KS = [31, 4, 6, 7, 12, 10, 64, 0]  # tests/test_torch_repeats.py
GATE_MISMATCHES = (-1, 0, 1, 2, 3, 8, 40)
# the crafted cases are also launched at other (blocks, threads, tile) than
# their plan's: the two-phase path's (1, 128, 1,024), the device graph
# path's (2, 320, 128), a small batch's (8, 512, 32) and odd ones
GATE_FORCED = ((1, 128, 1024), (2, 320, 128), (8, 512, 32), (1, 32, 64),
               (3, 1024, 256))
FALLBACK_REGION = "chr1:300-40300"  # 400 windows of the default corpus
MESH_ON_ONE_CARD = 4  # entries of cuda:0 in the main path's mesh case
DEVGRAPH_MESHES = (1, 2, 4)  # entries of cuda:0, device-graph cases
MH_PROCESSES = 2
MH_LIMIT_S = 300  # a fan-out process's whole run
# the main path without and with LANCET_TPU_GATES, alternating
GATES_AB = ("off", "on", "on", "off", "off", "on")
# the JAX package's device-graph region of the default corpus (bench.py:377,
# 1,198 windows) and its device-graph stats there: BENCH_r05.json
# "devgraph", confirmed by a run of the JAX package on the CPU
DEVGRAPH_REGION = "chr1:300-120000"
DEVGRAPH_STATS = {"n_dev_windows": 357, "n_dev_fallback": 0,
                  "dev_fallback_causes": {},
                  "k_histogram": {11: 15, 13: 231, 15: 99, 17: 10, 19: 2}}
# the JAX benchmark's hard corpus (corpus.hard_corpus, chr1:300-199700,
# 1,995 windows) on the main path: its records and KMERSIZE histogram
# (BENCH_r05.json "hard", where the reference binary matched all 183) and
# DP pairs (the port's and the JAX package's runs on the CPU)
HARD_RECORDS = 183
HARD_KMERSIZE = {11: 10, 13: 113, 15: 17, 25: 4, 27: 15, 29: 5, 31: 6,
                 37: 5, 39: 5, 41: 3}
HARD_DP_PAIRS = 201
# the device graph engine on the whole hard corpus: the port's run with
# device="cpu" (the JAX device engine does not finish this corpus on a
# CPU; its VCF equals the native path's, which tier-1 ties to the JAX
# package)
HARD_DEVGRAPH_STATS = {
    "n_dev_windows": 568, "n_dev_fallback": 115,
    "dev_fallback_causes": {"pipeline_caps": 55, "k_gt_63": 60},
    "k_histogram": {11: 7, 13: 164, 15: 42, 17: 6, 21: 2, 25: 21, 27: 79,
                    29: 30, 31: 30, 33: 1, 35: 1, 37: 22, 39: 29, 41: 19}}
LR_RECORDS = 29  # the LR corpus (corpus.lr_corpus): BENCH_r05.json "lr"
# Integer operations of the four walks per unit of work, by hand
# (csrc/walks.cu), as lower bounds: path_cover 10 per BFS pop (the queue
# entry's one 16-byte load and its three field extracts, the sink and best
# tests, the expand test, the lane's slot-word load, head and tail);
# seq_removal 8 per swept slot (the entry's ballot and shuffle, its
# degree and flag loads, the tests); cycle_dfs 6 per DFS step (the successor
# entry's load, its start-bit test, the colour and count loads, the colour
# test, the end test; a push or pop of a packed frame besides);
# almost_repeat_paths 2 per (shift, position) mismatch bit a no-hit string
# needs (4 positions a word: the shifted word's load and funnel shift, the
# xor, the carry-free byte test's and, add and or-and, the gathering
# multiply and shift, the insert: 9 for 4; the window tests besides).
WALK_OPS = {"path_cover": 10, "seq_removal": 8, "cycle_dfs": 6,
            "almost_repeat_paths": 2}
# Dependent shared-memory loads on a walk's serial chain per unit of work,
# for its chain floor: path_cover 3 a pop (the queue entry, the slot word,
# then the covered bit and the length delta), cycle_dfs 2 a step (the
# successor entry, then its destination's colour and count side by side;
# steps up to the first cycle a component finds), seq_removal 1 a slot
# (its degree and flag side by side; the slot's item comes by a shuffle)
# and REMOVAL_KILL_LOADS more a kill (the item's first and last edge, an
# edge word, the neighbour's flag before its atomic),
# almost_repeat_paths 1 a 32-position mismatch word of its busiest thread
# (the word's shared loads issue together, then its ~80 integer
# instructions and the window tests: a loose floor).
WALK_CHAIN_LOADS = {"path_cover": 3, "seq_removal": 1, "cycle_dfs": 2,
                    "almost_repeat_paths": 1}
REMOVAL_KILL_LOADS = 3
# aten ops of one removal pass on the card: the kernel's four outputs, one
# allocation each (the launch itself goes through ctypes), one op to spare
REMOVAL_MAX_ATEN_OPS = 5
CHASE_STEPS = (1 << 20, 1 << 22)  # the shared-memory latency probe
LONG_WINDOW = 9000  # --window-size of phase long_window (> 8,192)
LONG_DEFAULT_REGION = "chr1:20000-29000"  # 7 windows at LONG_WINDOW
# The device='cpu' comparisons of the main path, of long_window and of the
# hard corpus's main path run on a part of the region (the cuda run again
# over the same part beside it), which keeps chip_smoke.py inside its time
# limit: 401 of the default corpus's 5,195 windows, 2 of long_window's 7
# default-corpus windows and 1 of the long corpus's 4 (whose DP pairs
# still pass 8,192 bases), ~600 of the hard corpus's 1,995
CPU_COMPARE_REGION = "chr1:300-40300"
HARD_CPU_REGION = "chr1:300-60300"
LONG_CPU_REGIONS = {"default_region": "chr1:20250-28750",
                    "long_corpus": "chr1:500-8800"}
WALK_PLAIN_REPS = 2  # the plain walks loop on the host: seconds a call
KERNEL_REPS = (5, 10)  # batches x launches per batch, per case
# the plain versions of gotoh_align and repeat_gates run once, the
# check's call, which is also their time (~3-9 s a call, long_ref's
# 30-60 s); more calls only sharpened a yardstick, and cost ~75 s of the
# script's limit on a slow host
PLAIN_REPS = 1
LONG_PLAIN_REPS = 1
LARGE_GROUP = (132, 1000, 1100, 3)  # pairs, min and max length, seed
# the repeats_ties pairs of tests/test_torch_align.py: homopolymer runs of
# unequal length, tandem repeats shifted by one unit, identical strings,
# and pairs whose best alignment is all gaps
TIE_PAIRS = [("A" * 10, "A" * 7), ("CCCCCGGGG", "CCCGGGGGGG"),
             ("T" * 20, "T" * 23), ("G" * 3, "G" * 12), ("AC" * 6, "CA" * 6),
             ("ACG" * 5, "CGA" * 5), ("AGTT" * 4 + "C", "GTTA" * 4 + "C"),
             ("ACGTTGCA", "ACGTTGCA"), ("GATTACA" * 5, "GATTACA" * 5),
             ("A" * 20, "C" * 20), ("A" * 25, "C" * 30)]


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; every line but the last (the device line) carries
    the script's wall seconds so far (t_wall_s), for its time budget."""
    if "ok" not in obj:
        obj = {**obj, "t_wall_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip()


def sm_clock_hz() -> tuple[float, str]:
    """The card's maximum SM clock as nvidia-smi reports it (e.g.
    "1980 MHz"), and that text."""
    txt = nvidia_smi("clocks.max.sm").splitlines()[0].strip()
    return float(txt.split()[0]) * 1e6, txt


_MEMORY_OPS = ("LD", "LDG", "LDS", "LDC", "LDL", "LDSM", "ST", "STG", "STS",
               "STL", "ATOM", "ATOMS", "ATOMG", "RED", "LDGSTS", "ULDC")
_CONTROL_OPS = ("BRA", "BRX", "JMP", "BAR", "BSSY", "BSYNC", "EXIT", "RET",
                "CALL", "NOP", "WARPSYNC", "YIELD", "BMOV", "BREAK", "KILL",
                "MEMBAR", "DEPBAR", "ERRBAR")


def _sass_functions(so: str):
    """{mangled name: [instruction tokens]} from cuobjdump's SASS of the
    built library, or (None, the reason)."""
    from lancet_tpu_torch.gpu import gotoh

    cuobjdump = os.path.join(os.path.dirname(gotoh._nvcc()), "cuobjdump")
    try:
        r = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                           text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"cuobjdump: {e}"
    if r.returncode != 0:
        return None, f"cuobjdump rc {r.returncode}: {r.stderr[-300:]}"
    funcs = {}
    for func in re.split(r"\n\s*Function : ", r.stdout)[1:]:
        ops = []
        for line in func.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+([^;]*);", line)
            if m:
                toks = m.group(2).split()
                ops.append((int(m.group(1), 16),
                            toks[1:] if toks[0].startswith("@") else toks))
        funcs[func.split("\n", 1)[0].strip()] = ops
    return funcs, None


def _inner_loops(ops):
    """The innermost loops of a function: instruction lists between a
    backward branch's target and the branch."""
    at = {addr: k for k, (addr, _) in enumerate(ops)}
    loops = []
    for k, (_, toks) in enumerate(ops):
        m = re.search(r"\b0x([0-9a-f]+)$", " ".join(toks))
        if toks[0].startswith("BRA") and m:
            tgt = at.get(int(m.group(1), 16))
            if tgt is not None and tgt <= k:
                loops.append((tgt, k))
    return [[t for _, t in ops[s : e + 1]] for s, e in loops
            if not any(o != (s, e) and s <= o[0] and o[1] <= e
                       for o in loops)]


def _classify(body):
    cnt = {"arith": 0, "uniform": 0, "memory": 0, "control": 0}
    for toks in body:
        base = toks[0].split(".")[0]
        if base in _MEMORY_OPS:
            cnt["memory"] += 1
        elif base in _CONTROL_OPS:
            cnt["control"] += 1
        elif base.startswith("U"):
            cnt["uniform"] += 1
        else:
            cnt["arith"] += 1
    return cnt


def sass_loop_counts(so: str):
    """Static SASS counts of gotoh_align's two hot loops, per instantiation
    ("R8/smem": 8 rows a thread, codes in shared memory; "R32/strips" the
    strip mode). The fill loop is
    the innermost loop that shuffles (SHFL); one step of it shuffles two
    values (M and X of the row above) and computes R cells, so its counts
    are divided by R x half its SHFL count. The traceback loop is the
    innermost loop that
    stores op bytes (STS.U8 to shared memory; STG.E.U8 to device memory in
    the strip mode) and loads a code word (a
    32-bit LDS or LDG); its counts are divided by its op stores. Branches a
    cell or step skips are counted too. Also the DPX and other V* integer
    opcodes of the fill loop. Returns ({key: counts}, None), or (None, the
    reason) where cuobjdump or a loop is missing."""
    funcs, why = _sass_functions(so)
    if funcs is None:
        return None, why
    out = {}
    for name, ops in funcs.items():
        m = re.search(r"gotoh_align_kernelILi(\d+)ELb([01])ELb([01])E",
                      name)
        if not m:
            continue
        R = int(m.group(1))
        mode = ("strips" if m.group(3) == "1" else
                "global" if m.group(2) == "1" else "smem")
        key = f"R{R}/{mode}"
        op_store = "STG.E.U8" if mode == "strips" else "STS.U8"
        res = {}
        for body in _inner_loops(ops):
            bases = [t[0] for t in body]
            if any(b.startswith("SHFL") for b in bases):
                steps = sum(1 for b in bases if b.startswith("SHFL")) // 2
                if steps:
                    c = _classify(body)
                    res["fill_per_cell"] = {k: v / (R * steps)
                                            for k, v in c.items()}
                    res["fill_steps_per_iteration"] = steps
                    v_ops = sorted({b for b in bases if b.startswith("VI")})
                    res["fill_v_opcodes"] = {
                        o: sum(1 for b in bases if b == o) for o in v_ops}
            elif any(b.startswith(op_store) for b in bases) and any(
                    b.split(".")[0] in ("LDS", "LDG") and ".U8" not in b
                    for b in bases):
                steps = sum(1 for b in bases if b.startswith(op_store))
                c = _classify(body)
                res["trace_per_step"] = {k: v / steps for k, v in c.items()}
        if "fill_per_cell" not in res or "trace_per_step" not in res:
            return None, f"{key}: a hot loop was not found in the SASS"
        out[key] = res
    if not out:
        return None, "gotoh_align_kernel: not in the SASS"
    return out, None


_LDS_BYTES = {"LDS.U8": 1, "LDS.S8": 1, "LDS.U16": 2, "LDS": 4, "LDS.64": 8,
              "LDS.128": 16}


def _loops(ops):
    """Every loop of a function: (first, last) instruction indices of a
    backward branch's target and the branch."""
    at = {addr: k for k, (addr, _) in enumerate(ops)}
    loops = []
    for k, (_, toks) in enumerate(ops):
        m = re.search(r"\b0x([0-9a-f]+)$", " ".join(toks))
        if toks[0].startswith("BRA") and m:
            tgt = at.get(int(m.group(1), 16))
            if tgt is not None and tgt <= k:
                loops.append((tgt, k))
    return loops


def sass_gate_counts(so: str):
    """Static SASS counts of repeat_gates' two word loops, per
    instantiation ("W2" to "W5": the mismatch words a thread holds): a
    loop that holds the chunk's test loops (POPC) and slides in one new
    word, built from bytes ("bytes": two 16-byte shared loads, LDS.128) or
    from bit planes ("planes": 8-byte shared loads, LDS.64, only); its
    instructions outside the loops it holds, a word an iteration. Returns
    ({key: {bytes, planes}}, None), or (None, the reason)."""
    funcs, why = _sass_functions(so)
    if funcs is None:
        return None, why
    out = {}
    for name, ops in funcs.items():
        m = re.search(r"repeat_gates_kernelILi(\d+)EE", name)
        if not m or m.group(1) == "0":  # 0: the plain scan
            continue
        key = f"W{m.group(1)}"
        loops = _loops(ops)
        found = {}
        for lo, hi in loops:
            inner = [o for o in loops if o != (lo, hi) and lo <= o[0]
                     and o[1] <= hi]
            if not any(t[0] == "POPC" for a, b in inner
                       for _, t in ops[a:b + 1]):
                continue
            body = [ops[k][1] for k in range(lo, hi + 1)
                    if not any(a <= k <= b for a, b in inner)]
            lds = [t[0] for t in body if t[0].startswith("LDS")]
            kind = ("bytes" if "LDS.128" in lds else
                    "planes" if "LDS.64" in lds else None)
            if kind and (kind not in found or hi - lo < found[kind][0]):
                found[kind] = (hi - lo, _classify(body))
        if set(found) != {"bytes", "planes"}:
            return None, f"{key}: a word loop was not found in the SASS"
        out[key] = {k: v[1] for k, v in found.items()}
    if "W2" not in out or "W5" not in out:
        return None, "repeat_gates_kernel<2> or <5>: not in the SASS"
    return out, None


def dpx_headers() -> list[str]:
    """The CUDA toolkit's headers that declare __vibmax_s32."""
    from torch.utils.cpp_extension import CUDA_HOME

    inc = os.path.join(CUDA_HOME or "/usr/local/cuda", "include")
    found = []
    for root, _, files in os.walk(inc):
        for f in files:
            if f.endswith((".h", ".hpp")):
                path = os.path.join(root, f)
                with open(path, errors="replace") as fh:
                    if "__vibmax_s32" in fh.read():
                        found.append(os.path.relpath(path, inc))
    return sorted(found)


def build_all():
    """Build the native plane and the kernel library concurrently; returns
    ({name: seconds}, {name: library}, ptxas lines). Raises with the
    compiler's error text."""
    from lancet_tpu_torch import native
    from lancet_tpu_torch.gpu import (cleanup, compress, dbgk, gotoh,
                                      graphstate, repeats, screens, walks)

    secs, libs, errs = {}, {}, {}

    def one(name, fn):
        t0 = time.perf_counter()
        try:
            libs[name] = os.path.relpath(fn(), HERE)
            secs[name] = time.perf_counter() - t0
        except Exception as e:  # reported below, with the compiler's text
            errs[name] = e

    ts = [threading.Thread(target=one, args=a)
          for a in (("native", native.build), ("gotoh_cu", gotoh.build),
                    ("repeats_cu", repeats.build), ("walks_cu", walks.build),
                    ("screens_cu", screens.build),
                    ("compress_cu", compress.build),
                    ("graphstate_cu", graphstate.build),
                    ("cleanup_cu", cleanup.build), ("dbg_cu", dbgk.build))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        for name, e in errs.items():
            print(f"build of {name} failed:\n{e}", file=sys.stderr)
        raise RuntimeError(f"build failed: {sorted(errs)}")
    ptxas = {}
    for name in ("gotoh_cu", "repeats_cu", "walks_cu", "screens_cu",
                 "compress_cu", "graphstate_cu", "cleanup_cu", "dbg_cu"):
        with open(os.path.join(HERE, libs[name]) + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f
                           if "registers" in ln or "spill" in ln]
    return secs, libs, ptxas


def cuda_times(fn, batches: int, per_batch: int = 1) -> list[float]:
    """ms per call of `fn`, one reading per batch of `per_batch` calls,
    between CUDA events on the current stream."""
    import torch

    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / per_batch)
    return out


def timed_call(fn):
    """(fn's result, its ms between CUDA events on the current stream)."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def device_ms(fn, kernel: str, n: int = 20):
    """The mean device time (ms) of the kernels whose name holds `kernel`
    over n calls of `fn`, from torch.profiler's CUDA activity (the
    profile's raw events: the event tree of `prof.events()` missed a short
    kernel in three profiles of one call): the kernel alone, without the
    host's launch and allocation time between kernels that CUDA events
    around a call also see. None where the profiler records no such
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that missed the kernel is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ts = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and kernel in e.name()]
        if ts:
            return sum(ts) / len(ts) / 1e6
    return None


def spread(ts: list[float]) -> dict:
    return {"median": statistics.median(ts), "min": min(ts), "max": max(ts),
            "n": len(ts)}


def large_group():
    """One seeded group of related pairs whose codes do not fit in shared
    memory: LARGE_GROUP pairs of S 1,000-1,100 bp, T with 1-12 edits."""
    import random

    P, lo, hi, seed = LARGE_GROUP
    rng = random.Random(seed)
    pairs = []
    for _ in range(P):
        s = "".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi)))
        t = list(s)
        for _ in range(rng.randint(1, 12)):
            k = rng.randrange(len(t))
            t[k] = rng.choice("ACGT") if rng.random() < 0.5 else ""
        pairs.append((s, "".join(t)))
    return pairs


def long_pairs():
    """Pairs beyond a block's 8,192 rows (the strip mode): seeded random S
    of 8,193 and 20,000 bases against short random T, and S of 9,000 bases
    against an edited copy (its path crosses the strips' edge)."""
    import random

    rng = random.Random(6)
    pairs = [("".join(rng.choice("ACGT") for _ in range(n)),
              "".join(rng.choice("ACGT") for _ in range(m)))
             for n, m in ((8_193, 1), (8_193, 50), (20_000, 7),
                          (20_000, 50))]
    s = "".join(rng.choice("ACGT") for _ in range(9_000))
    t = list(s)
    for _ in range(20):
        k = rng.randrange(len(t))
        t[k] = rng.choice("ACGT") if rng.random() < 0.5 else ""
    return pairs + [(s, "".join(t))]


def kernel_phase(pairs, rate: dict, plain_reps: int = PLAIN_REPS) -> dict:
    """gotoh_align on one group of pairs: its ops and counts bit-equal to
    the plain versions on the card, then timed beside them (CUDA events
    around the wrapper, and the kernel's own device time) and the card's
    bound."""
    import torch

    from lancet_tpu_torch.gpu import gotoh
    from lancet_tpu_torch.gpu.align_batch import _pack

    dev = torch.device("cuda", 0)
    S, T, n_len, m_len, N, M = _pack(pairs)
    P = len(pairs)
    pl = gotoh.plan(N, M)
    key = f"R{pl.rows_per_thread}/{pl.mode}"
    S, T, n_d, m_d = (torch.from_numpy(a).to(dev) for a in (S, T, n_len,
                                                              m_len))

    def plain():
        return gotoh.traceback_plain(gotoh.dp_fill_plain(S, T, n_d, m_d, N,
                                                         M), n_d, m_d, N, M)

    ops, cnt = gotoh.align(S, T, n_d, m_d, N, M)
    (ops_p, cnt_p), first_ms = timed_call(plain)
    err = max(int((ops.int() - ops_p.int()).abs().max()),
              int((cnt - cnt_p).abs().max()))
    if err:
        raise AssertionError(f"P={P} N={N} M={M} ({pl.mode}): gotoh_align "
                             f"disagrees with its plain version ({err})")
    del ops_p, cnt_p

    ms = spread(cuda_times(lambda: gotoh.align(S, T, n_d, m_d, N, M),
                           *KERNEL_REPS))
    dev_ms = device_ms(lambda: gotoh.align(S, T, n_d, m_d, N, M),
                       "gotoh_align_kernel")
    plain_ms = spread([first_ms] + cuda_times(plain, plain_reps - 1))

    cells = int((n_len.astype("int64") * m_len).sum())
    steps = int(cnt.sum())
    # read each pair's characters and lengths once; write ops and counts
    nbytes = int(n_len.sum() + m_len.sum()) + 8 * P + P * (N + M) + 4 * P
    per = rate["per_instantiation"][key]
    nops = per["fill_ops_per_cell"] * cells + per["trace_ops_per_step"] * steps
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / rate["int_ops_per_s"] * 1e3}
    return {
        "P": P, "N": N, "M": M, "mode": pl.mode, "instantiation": key,
        "threads": pl.threads, "smem": pl.smem,
        "n_range": [int(n_len.min()), int(n_len.max())],
        "m_range": [int(m_len.min()), int(m_len.max())],
        "cells": cells, "trace_steps": steps,
        "tolerance": 0,  # bit-equal on every op and count
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms, "bound": bound,
        "cells_per_s": cells / (ms["median"] / 1e3),
        "bytes": nbytes, "int_ops": nops,
    }


def gate_bound(W: int, L: int, nk: int, steps: int, work, plan,
               rate: dict) -> dict:
    """The card's least time (ms) for a repeat_gates call: its bytes (the
    windows, lengths and ks read once, both rows written once) over the
    memory rate, and its integer operations over the issue rate, counted
    twice: at the function-level GATE_OPS_PER_STEP a (shift, position)
    pair (the row's count since the first design), and as what these
    inputs need under the kernel's plan (its words and window tests, from
    the kernel's own counters)."""
    nbytes = W * L + 4 * W + 4 * nk + 2 * W * nk
    words, tests, plane_words = (int(v) for v in work)
    if plan.words:
        plan_ops = (rate["gate_ops_per_word"] * words
                    + rate["gate_ops_per_plane_word"] * plane_words
                    + GATE_OPS_PER_TEST * tests)
    else:  # the plain scan counts positions
        plan_ops = GATE_OPS_PER_STEP * words
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": GATE_OPS_PER_STEP * steps / rate["int_ops_per_s"]
            * 1e3,
            "plan_operations": plan_ops / rate["int_ops_per_s"] * 1e3,
            "nbytes": nbytes, "words": words, "plane_words": plane_words,
            "tests": tests, "plan_int_ops": plan_ops}


def gates_case(windows, ks, mm: int, rate: dict, timed: bool,
               forced=()) -> dict:
    """repeat_gates on one batch of windows: its gates and exact rows
    bit-equal to gates_plain on the card, at gates_plan's launch and at
    each (blocks, threads, tile) of `forced`; with `timed`, timed beside
    it (CUDA events around the wrapper, and the kernel's own device time)
    with the card's bound."""
    import torch

    from lancet_tpu_torch.gpu import repeats

    dev = torch.device("cuda", 0)
    seq, lens = repeats.pack(windows)
    seq_d, lens_d = (torch.from_numpy(a).to(dev) for a in (seq, lens))
    work = torch.zeros(3, dtype=torch.int64, device=dev)
    g, e = repeats.gates(seq_d, lens_d, ks, mm, work)
    (pg, pe), first_ms = timed_call(
        lambda: repeats.gates_plain(seq_d, lens_d, tuple(ks), mm))
    # verdicts that differ (0 or 1 each); the kernel must agree on all
    err = max(int((g != pg).sum()), int((e != pe).sum()))
    W, L = seq.shape
    pl = repeats.gates_plan(W, L, ks, mm)
    for b, t, tile in forced:
        g2, e2 = torch.zeros_like(g), torch.zeros_like(e)
        repeats.launch(seq_d, lens_d, tuple(ks), mm,
                       pl._replace(blocks=b, threads=t, tile=tile), g2, e2)
        torch.cuda.synchronize()
        err = max(err, int((g2 != pg).sum()), int((e2 != pe).sum()))
    if err:
        raise AssertionError(f"W={len(windows)} mm={mm} ks={ks}: "
                             f"repeat_gates disagrees with gates_plain on "
                             f"{err} verdicts")
    steps = int(sum(int(n) * (int(n) - 1) // 2 for n in lens))
    out = {"W": W, "L": L, "nk": len(ks), "max_mismatch": mm,
           "plan": pl._asdict(), "forced_plans": len(forced),
           "position_steps": steps, "gated": int(g.sum()),
           "exact": int(e.sum()), "tolerance": 0, "max_abs_err": err}
    if not timed:
        return out
    ms = spread(cuda_times(lambda: repeats.gates(seq_d, lens_d, ks, mm),
                           *KERNEL_REPS))
    dms = [device_ms(lambda: repeats.gates(seq_d, lens_d, ks, mm),
                     "repeat_gates_kernel", 10) for _ in range(3)]
    plain_ms = spread([first_ms] + cuda_times(
        lambda: repeats.gates_plain(seq_d, lens_d, tuple(ks), mm),
        PLAIN_REPS - 1))
    bound = gate_bound(W, L, len(ks), steps, work.tolist(), pl, rate)
    return {**out, "ms": ms, "plain_ms": plain_ms,
            "device_ms": spread([d for d in dms if d is not None])
            if any(d is not None for d in dms) else None,
            "bound": {k: bound[k] for k in ("bytes", "operations",
                                            "plan_operations")},
            "bytes": bound["nbytes"], "int_ops": GATE_OPS_PER_STEP * steps,
            "plan_int_ops": bound["plan_int_ops"], "words": bound["words"],
            "plane_words": bound["plane_words"], "tests": bound["tests"],
            "steps_per_s": steps / (ms["median"] / 1e3)}


@contextlib.contextmanager
def capture_gates(calls: list):
    """While active: append (windows, ks, max_mismatch) of every
    repeat_gates call (the device graph path's k rounds, the eager sweep's
    chunks) to `calls`."""
    from lancet_tpu_torch.gpu import repeats

    real = repeats.repeat_gates

    def gate(windows, ks, max_mismatch, *a, **k):
        calls.append((list(windows), list(ks), int(max_mismatch)))
        return real(windows, ks, max_mismatch, *a, **k)

    repeats.repeat_gates = gate
    try:
        yield
    finally:
        repeats.repeat_gates = real


def check_gate_calls(calls: list, case: str, rate: dict) -> dict:
    """Each captured repeat_gates call held bit-equal to gates_plain on
    the card; the call with the most (shift, position) pairs timed with
    its bound. Raises on a mismatch."""
    if not calls:
        raise AssertionError(f"{case}: no repeat_gates call was captured")
    res = [gates_case(w, ks, mm, rate, timed=False) for w, ks, mm in calls]
    big = max(range(len(calls)), key=lambda i: res[i]["position_steps"])
    return {"calls": len(calls),
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "shapes": [[r["W"], r["L"], r["nk"]] for r in res],
            "largest": gates_case(*calls[big], rate, timed=True)}


def default_windows(workdir: str, region: str) -> list[str]:
    """The reference sequence of every default-corpus window."""
    from lancet_tpu_torch.config import Config
    from lancet_tpu_torch.io import open_fasta
    from lancet_tpu_torch.windows import generate_windows

    cfg = Config()
    fa = open_fasta(os.path.join(workdir, "ref.fa"))
    return [w.rawseq for w in generate_windows(fa, [region], fa.lengths,
                                               cfg.window_size, cfg.padding)]


def launch_counts() -> dict:
    from lancet_tpu_torch.gpu import (cleanup, compress, dbgk, gotoh,
                                      graphstate, repeats, screens, walks)

    return {**gotoh.LAUNCHES, **repeats.LAUNCHES, **walks.LAUNCHES,
            **screens.LAUNCHES, **compress.LAUNCHES, **graphstate.LAUNCHES,
            **cleanup.LAUNCHES, **dbgk.LAUNCHES}


def reset_counts() -> None:
    from lancet_tpu_torch.gpu import (cleanup, compress, dbgk, gotoh,
                                      graphstate, repeats, screens, walks)

    gotoh.reset_launches()
    repeats.reset_launches()
    walks.reset_launches()
    screens.reset_launches()
    compress.reset_launches()
    graphstate.reset_launches()
    cleanup.reset_launches()
    dbgk.reset_launches()


def vcf_records(vcf: str) -> list[str]:
    return [ln for ln in vcf.splitlines() if ln and ln[0] != "#"]


def kmersizes(vcf: str) -> dict:
    """{KMERSIZE: records} of a VCF."""
    hist: dict = {}
    for rec in vcf_records(vcf):
        k = int(re.search(r"KMERSIZE=(\d+)", rec).group(1))
        hist[k] = hist.get(k, 0) + 1
    return dict(sorted(hist.items()))


def run_captured(workdir: str, region: str, stats: dict, num_threads=8,
                 window_size: int | None = None, lr_mode: bool = False,
                 **kw):
    """runner.run on the corpus (8 threads, the default window size and LR
    mode off unless given); returns (VCF, stderr)."""
    from lancet_tpu_torch.config import Config
    from lancet_tpu_torch.runner import run

    cfg = Config(tumor_bam=os.path.join(workdir, "tumor.bam"),
                 normal_bam=os.path.join(workdir, "normal.bam"),
                 ref_fasta=os.path.join(workdir, "ref.fa"), region=region,
                 num_threads=num_threads, lr_mode=lr_mode,
                 **({} if window_size is None
                    else {"window_size": window_size}))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        vcf = run(cfg, command_line="chip_smoke", date="SMOKE\n",
                  stats=stats, **kw)
    return vcf, err.getvalue()


def run_engine_path(workdir: str, region: str, stats: dict, **kw):
    """The two-phase process pool on the card, the native runner off."""
    os.environ["LANCET_TPU_NO_SHARDRUN"] = "1"
    try:
        return run_captured(workdir, region, stats, processes=True,
                            engine="batched", device="cuda", **kw)
    finally:
        del os.environ["LANCET_TPU_NO_SHARDRUN"]


def stop_pool_servers() -> None:
    """Stop the forkserver and the resource tracker that the process pool
    started, so that no process of this script outlives it."""
    import multiprocessing.forkserver as fs
    import multiprocessing.resource_tracker as rt

    for server in (fs._forkserver, rt._resource_tracker):
        server._stop()


def run_forced_fallback(workdir: str, region: str, stats: dict,
                        forced: list):
    """The main path on `region` with the first two windows that hold an
    indel handed back by the native runner, so that the runner replays
    them on the per-window engine on the card (their paths need the DP)."""
    from lancet_tpu_torch.engine import shardrun

    orig = shardrun.run_shards

    def forcing(*a, **k):
        res = orig(*a, **k)
        idx = [wi for wi in sorted(res.variants_by_window)
               if any(v.type in "ID" for v in res.variants_by_window[wi])]
        res.fallback.update(idx[:2])
        forced.extend(idx[:2])
        return res

    shardrun.run_shards = forcing
    try:
        return run_captured(workdir, region, stats, device="cuda")
    finally:
        shardrun.run_shards = orig


def run_main_path(device: str, workdir: str, region: str, stats: dict,
                  groups: list | None = None, **kw):
    """runner.run on the corpus; with `groups`, every pair list the DP
    dispatch hands to batch_align_async is appended to it."""
    from lancet_tpu_torch.gpu import align_batch

    dispatch = align_batch.batch_align_async

    def keep(pairs, device):
        groups.append(list(pairs))
        return dispatch(pairs, device)

    if groups is not None:
        align_batch.batch_align_async = keep
    try:
        return run_captured(workdir, region, stats, device=device, **kw)
    finally:
        align_batch.batch_align_async = dispatch


def long_window_case(case: str, workdir: str, region: str) -> dict:
    """The main path at --window-size LONG_WINDOW on cuda (its launch
    counts set to 0 just before and read just after), then on cuda and cpu
    over the part LONG_CPU_REGIONS[case] of the region: equal VCFs and
    summaries; returns the line it emits."""
    st: dict = {}
    st_cc: dict = {}
    st_cpu: dict = {}
    groups: list = []
    reset_counts()
    vcf, summary = run_main_path("cuda", workdir, region, st, groups,
                                 window_size=LONG_WINDOW)
    launches = launch_counts()
    cpu_region = LONG_CPU_REGIONS[case]
    vcf_cc, summary_cc = run_main_path("cuda", workdir, cpu_region, st_cc,
                                       window_size=LONG_WINDOW)
    vcf_cpu, summary_cpu = run_main_path("cpu", workdir, cpu_region, st_cpu,
                                         window_size=LONG_WINDOW)
    line = {"phase": "long_window", "case": case, "region": region,
            "window_size": LONG_WINDOW, "n_windows": st["n_windows"],
            "n_dp": st["n_dp"], "dp_groups": [len(g) for g in groups],
            "largest_N": max((len(a) for g in groups for a, _ in g),
                             default=0),
            "largest_M": max((len(b) for g in groups for _, b in g),
                             default=0),
            "launches": launches, "t_total": st["t_total"],
            "cpu_region": cpu_region, "cpu_region_windows": st_cc[
                "n_windows"], "t_total_cpu": st_cpu["t_total"],
            "t_total_cuda_cpu_region": st_cc["t_total"],
            "vcf_records": len(vcf_records(vcf)),
            "cpu_region_vcf_records": len(vcf_records(vcf_cc)),
            "vcf_equal_cpu": vcf_cc == vcf_cpu,
            "summary_equal_cpu": summary_cc == summary_cpu}
    emit(line)
    if vcf_cc != vcf_cpu or summary_cc != summary_cpu:
        raise AssertionError(f"long_window {case}: device='cuda' and "
                             "device='cpu' runs differ")
    if line["vcf_records"] == 0 or st["n_dp"] == 0:
        raise AssertionError(f"long_window {case}: {line['vcf_records']} "
                             f"records from {st['n_dp']} DP pairs")
    return line


_WALKS = {"path_cover": "path_cover", "seq_removal": "seq_removal",
          "almost_repeat": "almost_repeat_paths", "cycle_dfs": "cycle_dfs"}
# the CUDA kernel (csrc/walks.cu) each walk's wrapper launches
_KERNEL_NAMES = {"path_cover": "path_cover_kernel",
                 "seq_removal": "seq_removal_kernel",
                 "almost_repeat_paths": "almost_repeat_kernel",
                 "cycle_dfs": "cycle_dfs_kernel"}
_WALK_SOURCES = {"path_cover": "lancet_tpu/tpu/pipeline.py:310",
                 "seq_removal": "lancet_tpu/tpu/stages.py:580",
                 "almost_repeat_paths": "lancet_tpu/tpu/pipeline.py:680",
                 "cycle_dfs": "lancet_tpu/tpu/stages.py:839"}
# the two screens of csrc/screens.cu (their wrappers in gpu/screens.py),
# captured and held every call like the walks, their kernels and the JAX
# functions they replace
_SCREENS = ("tandem_at", "cycle_screen")
_SCREEN_KERNELS = {"tandem_at": "tandem_kernel",
                   "cycle_screen": "cycle_screen_kernel"}
_SCREEN_SOURCES = {"tandem_at": "lancet_tpu/tpu/stages.py:630",
                   "cycle_screen": "lancet_tpu/tpu/stages.py:750"}
# aten ops of one screen call on the card: the output's allocation (the
# launch goes through ctypes; int64 and bool inputs are read as they are),
# one op to spare
SCREEN_MAX_ATEN_OPS = 2
# Integer operations of tandem_at, by hand (csrc/screens.cu), as lower
# bounds: a position of a string below min(lens, L) and unit length m
# takes 3m + 2 (the match run's two shared loads and compare-and a base,
# the break test; the report, units and primitivity tests of a break come
# on top); a string with lens > 0 takes 3 a (position, ml < max_unit_len)
# for its prefix sums. cycle_screen: 6 an edge to stage (its four loads,
# the pack, the flags' test), 5 an active edge each round of its window
# (two label loads and their tests, the store or the decrement), 8 an
# item (its loads, the labels, the flag tests).
TANDEM_OPS_RUN = 3
TANDEM_OPS_STEP = 2
TANDEM_OPS_PREFIX = 3
SCREEN_OPS = {"stage_edge": 6, "round_edge": 5, "item": 8}
# A screen's chain floor: its longest serial chain x SCREEN_CHAIN_LOADS
# dependent shared loads x the smem_chase latency. tandem_at: a position
# of the longest probed string (a unit length's break test reads the
# codes, then the ballot's offset feeds the hit test's loads); cycle_screen:
# a round of the slowest window, max(reach rounds, peel rounds) (a source
# label, then the destination's label or its in-degree).
SCREEN_CHAIN_LOADS = 2
# the compression pass of csrc/compress.cu (its wrapper in gpu/compress.py):
# every card call held against compress_round_plain, the largest call of
# each item axis (the engine's un-compacted NI 1,552 and compact NI 528)
# timed
_COMPRESS = "compress_round"
_COMPRESS_SOURCE = "lancet_tpu/tpu/stages.py:928"
# aten ops of one compress_round call on the card: its 17 outputs'
# allocations (the launch itself goes through ctypes), one to spare
COMPRESS_MAX_ATEN_OPS = 18
# Integer operations of the function, by hand, as lower bounds: an item 24
# (its two states' count tests and links, its label, survivor, flip and
# pos_u, its eight aggregates), an edge 16 (its state's count, the renorm
# key and slot, the rewiring's gathers, selects and okey), a mer 16
# (new_pos, the flips, the kept interval and its trims), a state 4 a round
# of the jumping (the word, the word it points at, the add-and-min, the
# compare).
COMPRESS_OPS = {"item": 24, "edge": 16, "mer": 16, "state_round": 4}
# its chain floor: the slowest window's jumping rounds x one dependent
# shared load (the word the last round's word points at)
COMPRESS_CHAIN_LOADS = 1
# functions of the device graph engine (gpu/stages.py, gpu/dbg.py's build_k
# and gpu/pipeline.py's cleanup and STR guard) whose calls and aten ops
# (about one kernel launch each) are counted: the torch-op functions of the
# build, run_attempt and cleanup, and the kernels' wrappers (a launch and
# its outputs' allocation). A count includes the calls it makes to the
# others: compress_round's plain version holds its links and chain_jump,
# low_cov_pass's its item_mincovs, cleanup every stage of its own.
_OP_COUNTED = ("tandem_at", "cycle_screen", "compress_round",
               "_seq_removal_pass", "components", "chain_jump",
               "low_cov_pass", "compact_state", "item_mincovs", "links",
               "build_k", "cleanup", "_short_link_str_guard",
               "_extend_items", "_extend_edges", "ref_ends", "wire_anchors",
               "okey_adjacency", "_donor_tables", "materialize_jobs")
_PIPELINE_COUNTED = ("cleanup", "_short_link_str_guard", "_extend_items",
                     "_extend_edges", "_donor_tables", "materialize_jobs")
# the cleanup's two loops of csrc/cleanup.cu (their wrappers in
# gpu/cleanup.py): every card call held against its plain version, dtypes
# too; every card call of the cleanup (gpu/pipeline.py::cleanup: its eight
# launches) held against cleanup_plain on its inputs, and run again under
# torch.cuda.set_sync_debug_mode("error"); the largest call of each timed
_CLEANUP = ("tip_fixpoint", "short_link_strings")
_CLEANUP_SOURCES = {"tip_fixpoint": "lancet_tpu/tpu/pipeline.py:167",
                    "short_link_strings": "lancet_tpu/tpu/pipeline.py:726"}
_CLEANUP_ALSO = {"tip_fixpoint": "lancet_tpu/tpu/pipeline.py:182, :227",
                 "short_link_strings": "lancet_tpu/tpu/pipeline.py:195-215"}
_CLEANUP_KERNELS = {"tip_fixpoint": "tip_fixpoint_kernel",
                    "short_link_strings": "short_link_strings_kernel"}
# aten ops of one call on the card: its outputs' allocations (tip_fixpoint
# 16 state keys, the fallback and its flag rows; short_link_strings 4)
CLEANUP_MAX_ATEN_OPS = {"tip_fixpoint": 18, "short_link_strings": 4}
# hand-kernel launches of one cleanup call on the card: low_cov_pass,
# compress_round, tip_fixpoint twice, item_mincovs, short_link_strings and
# tandem_at
CLEANUP_LAUNCHES = {"low_cov_pass": 1, "compress_round": 1,
                    "tip_fixpoint": 2, "item_mincovs": 1,
                    "short_link_strings": 1, "tandem_at": 1}
# Integer operations of short_link_strings, by hand, as lower bounds: an
# item 6 (its flags, merlen, degree and the candidate and pre tests), an
# alive edge 2 (its source's degree), a kept base of a candidate's mer 4
# (its position, clamp, key and atomic max), a cell 4 (its key, the base's
# load, the complement, the store). tip_fixpoint: each compression round's
# COMPRESS_OPS and each removal pass's 4 an item and 4 an edge (its staging).
STRINGS_OPS = {"item": 6, "edge": 2, "position": 4, "cell": 4}
REMOVAL_PASS_OPS = {"item": 4, "edge": 4}
# the kernels the device graph path launches, cases 1 and 2 together (the
# removal pass's K2 runs there inside tip_fixpoint, as its body)
_DEVGRAPH_KERNELS = ("path_cover", "almost_repeat_paths", "cycle_dfs",
                     "tandem_at", "cycle_screen", "compress_round",
                     "components", "compact_state", "low_cov_pass",
                     "item_mincovs", "tip_fixpoint", "short_link_strings",
                     "mer_instances", "window_sort", "node_tables",
                     "edge_tables")
# the component labels, compaction and low-coverage pass of
# csrc/graphstate.cu (their wrappers in gpu/graphstate.py): every card call
# held against its plain version, dtypes too, one launch and no host sync
# a call, the largest call of each timed
_GRAPHSTATE = ("components", "compact_state", "low_cov_pass",
               "item_mincovs")
_GRAPHSTATE_SOURCES = {"components": "lancet_tpu/tpu/stages.py:73",
                       "compact_state": "lancet_tpu/tpu/stages.py:406",
                       "low_cov_pass": "lancet_tpu/tpu/stages.py:528",
                       "item_mincovs": "lancet_tpu/tpu/stages.py:382"}
# the low-coverage kernels: a cluster of graphstate.lowcov_plan(...).C blocks
# a window, the kernels lines' grid checked against it (cluster_grid)
_LOWCOV = ("low_cov_pass", "item_mincovs")
_GRAPHSTATE_KERNELS = {"components": "components_kernel",
                       "compact_state": "compact_kernel",
                       "low_cov_pass": "lowcov_kernel",
                       "item_mincovs": "lowcov_kernel"}
# aten ops of one call on the card: its outputs' allocations (components
# 3, compact_state 18 with comp, item_mincovs 2) and low_cov_pass's
# threshold product beside its 3; the launch goes through ctypes
GRAPHSTATE_MAX_ATEN_OPS = {"components": 3, "compact_state": 18,
                           "low_cov_pass": 4, "item_mincovs": 2}
# Integer operations of each function, by hand, as lower bounds:
# components 4 an alive edge (two label loads, the min, two mins) and 6 an
# item (its label, the numbering and output), each once, the least any
# schedule does (the kernel's rounds repeat them); compact_state 4 an item
# (its flag and scan), 4 an edge, 3 a mer; a kept totq position 2 (the
# load and the min), 12 a donating mer, 10 an item and 4 an edge
# (low_cov_pass's test and removal).
GRAPHSTATE_OPS = {"comp_edge": 4, "comp_item": 6, "compact_item": 4,
                  "compact_edge": 4, "compact_mer": 3, "low_pos": 2,
                  "low_mer": 12, "low_item": 10, "low_edge": 4}
# the build of csrc/dbg.cu (its wrappers in gpu/dbgk.py): every card
# build_k call of the devgraph, hard and mesh (b) runs held bit-equal,
# dtypes too, to build_k_plain on its inputs on the card and run again
# under torch.cuda.set_sync_debug_mode("error") with the launches its plan
# fixes (dbgk.build_plan(...).launches); the four kernels timed on the
# largest call, each by the device time of all of its kernels
_BUILD = ("mer_instances", "window_sort", "node_tables", "edge_tables")
_BUILD_SOURCE = "lancet_tpu/tpu/dbg.py:120"
_BUILD_ALSO = {"mer_instances": "lancet_tpu/tpu/dbg.py:54, :152-235",
               "window_sort": "lancet_tpu/tpu/dbg.py:264, :367, :461, :501, "
                              ":518, :575",
               "node_tables": "lancet_tpu/tpu/dbg.py:239-327",
               "edge_tables": "lancet_tpu/tpu/dbg.py:329-478"}
_BUILD_KERNELS = {
    "mer_instances": ("mer_instances_count", "mer_instances_write"),
    "window_sort": ("window_sort_keys", "window_sort_count",
                    "window_sort_scatter", "window_sort_tile"),
    "node_tables": ("node_tables_count", "node_tables_groups",
                    "node_tables_order"),
    "edge_tables": ("edge_tables_pairs", "edge_tables_count",
                    "edge_tables_groups", "edge_tables_order",
                    "edge_tables_adj")}
# aten ops of one build_k call on the card: its stages' allocations (the
# instance table's 4, the instance sort's permutation and workspace (its
# records and the instance tiles' counts), the node tables' 16 and
# workspace, the mers' unbind, the edge tables' 12 and workspace): 37;
# the launches go through ctypes; one op to spare
BUILD_MAX_ATEN_OPS = 38
# Integer operations of each kernel's function, by hand, as lower bounds:
# mer_instances 3 a base of an instance's mer (the load, the forward and
# reverse shift-or) and 2 a quality (the compare, the bit); window_sort 2
# a record a pass of 8 bits of its declared key (the digit and its rank);
# node_tables 4 an instance (its group's boundary
# test, its first time, its class count and node) and 2 a quality bit;
# edge_tables 12 a pair (its ends, the canonical key) and 8 a row (the
# time order, the adjacency slot).
BUILD_OPS = {"base": 3, "qual": 2, "digit": 2, "instance": 4,
             "qbit": 2, "pair": 12, "row": 8}


def _tree(x, fn):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(y, fn) for y in x)
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def _on_card(args) -> bool:
    """Whether a walk call's first tensor (in a removal pass: its state's
    alive) lies on a card."""
    a = args[0]
    return (a["alive"] if isinstance(a, dict) else a).is_cuda


def _walk_args(name: str, args: list) -> list:
    """A walk call's arguments as kept: a removal pass's, compression
    pass's, graphstate function's or cleanup loop's state reduced to the
    keys it reads (the cleanup's whole)."""
    from lancet_tpu_torch.gpu import cleanup, compress, graphstate, walks

    if name == "seq_removal":
        keys = walks.REMOVAL_KEYS
    elif name == _COMPRESS:
        keys = compress.INPUT_KEYS
    elif name in graphstate.READS:
        keys = graphstate.READS[name]
    elif name == "tip_fixpoint":
        keys = cleanup.READS
    elif name == "short_link_strings":
        keys = cleanup.STRINGS_READS
    else:
        return args
    return [{k: args[0][k] for k in keys if k in args[0]}] + list(args[1:])


def _walk_out(name: str, out):
    """A walk call's outputs as kept: a compression pass's rewritten keys
    and fallback; compact_state's rewritten keys, over and hold-point flag
    (all False from a plain version, which asserts); low_cov_pass's alive,
    e_alive and low.any; tip_fixpoint's and the cleanup's rewritten state
    keys (those of compress_round) and fallback."""
    from lancet_tpu_torch.gpu import compress, graphstate

    if name in (_COMPRESS, "tip_fixpoint", "cleanup"):
        return {k: out[0][k] for k in compress.OUTPUT_KEYS}, out[1]
    if name == "compact_state":
        return ({k: out[0][k] for k, _, _ in graphstate.COMPACT_OUTPUTS
                 if k in out[0]}, out[1], out[2])
    if name == "low_cov_pass":
        return out[0]["alive"], out[0]["e_alive"], out[1]
    return out


def _kept_key(name: str, args) -> str:
    """The key a walk's largest call is kept under: compress_round's by
    its item axis, tip_fixpoint's by its mode."""
    if name == _COMPRESS:
        return f"{name}/NI{args[2]}"
    return f"{name}/{args[1][0]}" if name == "tip_fixpoint" else name


def _walk_work(name: str, args) -> int:
    """How much work a walk call holds (the call kept is the largest)."""
    import torch

    if name == "cycle_dfs":
        _, _, _, alive, _, N, Cmax, mask = args
        src = alive[:, N + 2 * torch.arange(Cmax, device=alive.device)]
        return int((mask & src).sum()) if mask is not None else 0
    if name == "seq_removal":  # live items
        return int((args[0]["alive"] & ~args[0]["special"]).sum())
    if name == "almost_repeat":
        return int(args[1].clamp(min=0).sum())
    if name == "tandem_at":  # the strings probed
        return int((args[1] > 0).sum())
    if name == "cycle_screen":  # alive items
        return int(args[4].sum())
    if name in (_COMPRESS, "compact_state", "tip_fixpoint", "cleanup"):
        return int(args[0]["alive"].sum())  # alive items
    if name == "short_link_strings":  # short-link candidates
        st = args[0]
        return int((st["alive"] & ~st["special"] & (st["merlen"] > 0)
                    & (st["merlen"] < args[5])).sum())
    if name == "components":
        return int(args[0].sum())
    if name == "build_k":  # instances: W (R M + 3 Mraw)
        K, bases, raw = args[0], args[1], args[8]
        W, R, L = bases.shape
        return W * (R * (L - K + 1) + 3 * (raw.shape[1] - K + 1))
    if name in ("low_cov_pass", "item_mincovs"):  # donating mers x K
        st = args[0]
        return int((st["keep_hi"] > st["keep_lo"]).sum()) * int(args[1])
    return int(args[5].sum())  # path_cover: runnable components


_CHECKED = ("path_cover", "seq_removal", "almost_repeat",
            "cycle_dfs") + _SCREENS + (_COMPRESS,) + _GRAPHSTATE \
    + _CLEANUP + ("cleanup", "build_k")  # every call


@contextlib.contextmanager
def instrument_devgraph(kept: dict | None, ops: dict | None,
                        calls: list | None = None):
    """While active: keep, per walk and screen (compress_round: per item
    axis), a copy of the inputs of its card call with the most work
    (`kept`); count the calls of the _OP_COUNTED functions and the aten
    ops they dispatch, nested calls' included (`ops`); append a copy of the
    inputs and outputs of every card call of the _CHECKED walks, screens
    and compress_round, with the k of the attempt that made it, to `calls`
    (on the caller's stream, from any thread), for check_walk_calls."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from lancet_tpu_torch.engine import devicepipe
    from lancet_tpu_torch.gpu import (cleanup, compress, dbg, graphstate,
                                      pipeline, screens, stages, walks)

    class Count(TorchDispatchMode):
        n = 0
        paused = False  # the instrument's own copies are not counted

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not Count.paused:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    real_w = {n: getattr(walks, n) for n in _WALKS}
    real_sc = {n: getattr(screens, n) for n in _SCREENS}
    real_c = compress.compress_round
    real_g = {n: getattr(graphstate, n) for n in _GRAPHSTATE}
    real_l = {n: getattr(cleanup, n) for n in _CLEANUP}
    real_b = dbg.build_k
    mods = {n: dbg if n == "build_k" else
            pipeline if n in _PIPELINE_COUNTED else stages
            for n in _OP_COUNTED}
    real_s = {n: getattr(mods[n], n) for n in _OP_COUNTED}
    real_a = devicepipe._assemble
    local = threading.local()  # the attempt's k; the counted depth

    def assemble(b, ranks, raw, K, *a, **k):
        local.K = K
        return real_a(b, ranks, raw, K, *a, **k)

    def copy(x):
        return _tree(x, lambda t: t.clone() if torch.is_tensor(t) else t)

    def build(*a, **k):
        # a build_k call on the card: its inputs (and, for check_walk_calls,
        # its outputs) copied, the largest kept
        card = torch.is_tensor(a[1]) and a[1].is_cuda
        held = None
        paused, Count.paused = Count.paused, True
        try:
            if kept is not None and card:
                work = _walk_work("build_k", a)
                if "build_k" not in kept or kept["build_k"][0] < work:
                    kept["build_k"] = (work, copy(list(a)), dict(k))
            if calls is not None and card:
                held = (copy(list(a)), dict(k))
        finally:
            Count.paused = paused
        out = real_b(*a, **k)
        if held is not None:
            Count.paused = True
            try:
                calls.append(("build_k", *held, copy(out), a[0]))
            finally:
                Count.paused = paused
        return out

    if kept is not None or calls is not None:
        dbg.build_k = build
        real_s["build_k"] = build  # counted around the copies it pauses

    def wrap_walk(n, real):
        def f(*a, **k):
            card = _on_card(a)
            paused, Count.paused = Count.paused, True
            try:
                if kept is not None and card:
                    work = _walk_work(n, a)
                    key = _kept_key(n, a)
                    if key not in kept or kept[key][0] < work:
                        kept[key] = (work, copy(_walk_args(n, list(a))),
                                     dict(k))
                held = None
                if calls is not None and n in _CHECKED and card:
                    # the inputs before the call: an in-place call (the
                    # cleanup's links tip_fixpoint) rewrites them
                    held = (copy(_walk_args(n, list(a))), copy(dict(k)))
            finally:
                Count.paused = paused
            out = real(*a, **k)
            if held is not None:
                Count.paused = True
                try:
                    calls.append((n, *held, copy(_walk_out(n, out)),
                                  getattr(local, "K", None)))
                finally:
                    Count.paused = paused
            return out
        return f

    def wrap_op(n):
        def f(*a, **k):
            c = ops.setdefault(n, {"calls": 0, "aten_ops": 0})
            before = Count.n
            depth = getattr(local, "depth", 0)
            local.depth = depth + 1
            try:  # one mode, the outermost call's: an op counts once
                with Count() if depth == 0 else contextlib.nullcontext():
                    out = real_s[n](*a, **k)
            finally:
                local.depth = depth
            c["calls"] += 1
            c["aten_ops"] += Count.n - before
            return out
        return f

    for n, f in real_w.items():
        setattr(walks, n, wrap_walk(n, f))
    for n, f in real_sc.items():
        setattr(screens, n, wrap_walk(n, f))
    compress.compress_round = wrap_walk(_COMPRESS, real_c)
    for n, f in real_g.items():
        setattr(graphstate, n, wrap_walk(n, f))
    for n, f in real_l.items():
        setattr(cleanup, n, wrap_walk(n, f))
    if ops is not None:
        for n in _OP_COUNTED:
            setattr(mods[n], n, wrap_op(n))
    # the cleanup's calls kept around its counted wrapper
    pipeline.cleanup = wrap_walk("cleanup", pipeline.cleanup)
    devicepipe._assemble = assemble
    try:
        yield
    finally:
        for n, f in real_w.items():
            setattr(walks, n, f)
        for n, f in real_sc.items():
            setattr(screens, n, f)
        compress.compress_round = real_c
        for n, f in real_g.items():
            setattr(graphstate, n, f)
        for n, f in real_l.items():
            setattr(cleanup, n, f)
        for n, f in real_s.items():
            setattr(mods[n], n, f)
        dbg.build_k = real_b
        devicepipe._assemble = real_a


def removal_plain(st, cond, U, D2):
    """seq_removal_pass_plain's outputs as the K2 wrapper returns them:
    (alive, e_alive, removed_any, over)."""
    from lancet_tpu_torch.gpu import stages

    out, removed_any, over = stages.seq_removal_pass_plain(st, cond, U, D2)
    return out["alive"], out["e_alive"], removed_any, over


def _mismatches(got, want) -> int:
    """Elements that differ between two walk outputs (a tensor, or a dict
    or tuple of them)."""
    if isinstance(want, dict):
        return sum(_mismatches(got[k], want[k]) for k in want)
    if isinstance(want, tuple):
        return sum(_mismatches(g, w) for g, w in zip(got, want))
    return int((got.cpu() != want.cpu()).sum())


def compress_plain(st, K, NI, N, Dcap=64):
    """compress_round_plain's rewritten keys and fallback, as the
    instrument keeps a card call's."""
    from lancet_tpu_torch.gpu import compress, stages

    out, fb = stages.compress_round_plain(st, K, NI, N, Dcap)
    return {k: out[k] for k in compress.OUTPUT_KEYS}, fb


def dtype_mismatches(got, want) -> int:
    """Elements, dtypes and keys that differ between two outputs (a
    tensor, or a dict or tuple of them): compress_round's ({key: tensor},
    fallback), a graphstate function's."""
    if isinstance(want, dict):
        return sum(dtype_mismatches(got[k], want[k]) for k in want) + len(
            set(got) ^ set(want))
    if isinstance(want, tuple):
        return sum(dtype_mismatches(g, w) for g, w in zip(got, want))
    return _mismatches(got, want) + int(got.dtype != want.dtype)


def graphstate_plain(name: str, args, kw):
    """The plain version of a graphstate function on a kept call's
    inputs, its outputs as _walk_out keeps the kernel's."""
    from lancet_tpu_torch.gpu import stages

    return _walk_out(name, getattr(stages, f"{name}_plain")(*args, **kw))


def graphstate_sync_free(name: str, args, kw) -> bool:
    """The kernel's wrapper again on a kept call's inputs under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises): True
    where it made no sync and one launch."""
    import torch

    from lancet_tpu_torch.gpu import graphstate

    torch.cuda.synchronize()
    before = graphstate.LAUNCHES[name]
    torch.cuda.set_sync_debug_mode("error")
    try:
        getattr(graphstate, name)(*args, **kw)
        ok = True
    except RuntimeError as e:
        print(f"{name}: a host sync on the card path: {e}", file=sys.stderr)
        ok = False
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return ok and graphstate.LAUNCHES[name] == before + 1


def build_sync_free(args, kw) -> bool:
    """build_k again on a kept call's inputs under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises): True
    where it made no sync and launched each kernel as often as its plan
    (build_launches) says."""
    import torch

    from lancet_tpu_torch.gpu import dbg, dbgk

    torch.cuda.synchronize()
    before = dict(dbgk.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        dbg.build_k(*args, **kw)
        ok = True
    except RuntimeError as e:
        print(f"build_k: a host sync on the card path: {e}", file=sys.stderr)
        ok = False
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return ok and {k: dbgk.LAUNCHES[k] - before[k]
                   for k in before} == build_launches(args, kw)


def build_launches(args, kw) -> dict:
    """The launches of each build kernel that a build_k call's plan fixes
    (dbgk.build_plan: its shapes and k)."""
    from lancet_tpu_torch.gpu import dbgk

    W, R, L = args[1].shape
    return dbgk.build_plan(args[0], W, R, L, kw["Lraw"], kw["N"], kw["E"],
                           kw["D"]).launches


def cleanup_sync_free(args, kw) -> bool:
    """The cleanup again on a kept call's inputs under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises): True
    where it made no sync and launched each kernel of CLEANUP_LAUNCHES its
    count of times."""
    import torch

    from lancet_tpu_torch.gpu import pipeline

    torch.cuda.synchronize()
    before = launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipeline.cleanup(*args, **kw)
        ok = True
    except RuntimeError as e:
        print(f"cleanup: a host sync on the card path: {e}", file=sys.stderr)
        ok = False
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = launch_counts()
    return ok and all(after[k] - before[k] == n
                      for k, n in CLEANUP_LAUNCHES.items())


def _keep_largest(largest: dict, n: str, args, kw, K) -> None:
    work = _walk_work(n, args)
    key = _kept_key(n, args)
    if key not in largest or largest[key][0] < work:
        largest[key] = (work, args, kw, K)


def check_walk_calls(calls: list, case: str, largest: dict | None = None,
                     plain_ops: dict | None = None) -> dict:
    """Each captured card call of path_cover, seq_removal, almost_repeat,
    cycle_dfs, tandem_at, cycle_screen, compress_round, the graphstate
    functions, tip_fixpoint, short_link_strings or the cleanup against the
    plain version on its own inputs, bit for bit (cycle_dfs's on a copy on
    the host: its step loop of small ops runs many times faster there than
    launched op by op on the card; the others' on the card, the dtypes of
    compress_round, the graphstate functions, the cleanup loops and the
    cleanup too); returns {walk: {calls, mismatches}} and raises on a
    mismatch. Empties `calls`. A cleanup call's plain version is
    cleanup_plain on the card, the composition with host bools whose
    stages launch their own kernels (the removal pass's K2 among them):
    each of those calls is held against its plain version in turn, its
    largest call of each walk kept in `largest` ((work, args, kw, K)) and
    its stages' aten ops counted into `plain_ops`; the cleanup is also run
    again free of host syncs (cleanup_sync_free)."""
    import torch

    from lancet_tpu_torch.gpu import dbg, pipeline, stages

    torch.cuda.synchronize()
    res = {n: {"calls": 0, "mismatches": 0} for n in _CHECKED}
    while calls:
        n, args, kw, got, K = calls.pop(0)
        if n == "path_cover":
            want = pipeline.path_cover_plain(*args, **kw)
        elif n == "seq_removal":
            want = removal_plain(*args, **kw)
        elif n == "almost_repeat":
            want = pipeline.almost_repeat_plain(*args, **kw)
        elif n == "tandem_at":
            want = stages.tandem_at_plain(*args, **kw)
        elif n == "cycle_screen":
            want = stages.cycle_screen_plain(*args, **kw)
        elif n == _COMPRESS:
            want = compress_plain(*args, **kw)
        elif n in _GRAPHSTATE:
            want = graphstate_plain(n, args, kw)
            res[n]["sync_free"] = (res[n].get("sync_free", 0)
                                   + graphstate_sync_free(n, args, kw))
        elif n == "tip_fixpoint":
            want = _walk_out(n, pipeline.tip_fixpoint_plain(
                *args, **_plain_kw(kw)))
        elif n == "short_link_strings":
            want = pipeline.short_link_stage_plain(*args, **kw)
        elif n == "build_k":
            want = dbg.build_k_plain(*args, **kw)
            res[n]["sync_free"] = (res[n].get("sync_free", 0)
                                   + build_sync_free(args, kw))
        elif n == "cleanup":
            inner: list = []
            with instrument_devgraph(None, plain_ops, inner):
                want = _walk_out(n, pipeline.cleanup_plain(*args, **kw))
            inner = [c[:4] + (K,) for c in inner]
            if largest is not None:
                for c in inner:
                    _keep_largest(largest, c[0], c[1], c[2], K)
            for m, r in check_walk_calls(inner, case).items():
                for f in ("calls", "mismatches", "sync_free"):
                    if f in r:
                        res[m][f] = res[m].get(f, 0) + r[f]
                res[m]["plain_cleanup_calls"] = (
                    res[m].get("plain_cleanup_calls", 0) + r["calls"])
            res[n]["sync_free"] = (res[n].get("sync_free", 0)
                                   + cleanup_sync_free(args, kw))
        else:
            want = stages.cycle_dfs_plain(
                *_tree(args, lambda t: t.cpu() if torch.is_tensor(t) else t),
                **kw)
        bad = (dtype_mismatches(got, want)
               if n in (_COMPRESS, *_GRAPHSTATE, *_CLEANUP, "cleanup",
                        "build_k")
               else _mismatches(got, want))
        res[n]["calls"] += 1
        res[n]["mismatches"] += int(bad > 0)
    if any(r["mismatches"] or r.get("sync_free", r["calls"]) != r["calls"]
           for r in res.values()):
        raise AssertionError(f"{case}: a walk kernel disagrees with its "
                             f"plain version: {res}")
    return res


def check_screen_ops(ops: dict, case: str, names) -> None:
    """Each of `names` ran on the card and took at most SCREEN_MAX_ATEN_OPS
    aten ops a call (counted by instrument_devgraph)."""
    for n in names:
        c = ops.get(n, {"calls": 0, "aten_ops": 0})
        if not c["calls"] or c["aten_ops"] > SCREEN_MAX_ATEN_OPS * c["calls"]:
            raise AssertionError(f"{case}: {n} took {c} aten ops on the card "
                                 f"(at most {SCREEN_MAX_ATEN_OPS} a call)")


def check_compress_ops(ops: dict, case: str) -> None:
    """compress_round ran on the card and took at most
    COMPRESS_MAX_ATEN_OPS aten ops a call (counted by instrument_devgraph;
    the stages function, the wrapper's dispatch included)."""
    c = ops.get(_COMPRESS, {"calls": 0, "aten_ops": 0})
    if not c["calls"] or c["aten_ops"] > COMPRESS_MAX_ATEN_OPS * c["calls"]:
        raise AssertionError(f"{case}: compress_round took {c} aten ops on "
                             f"the card (at most {COMPRESS_MAX_ATEN_OPS} a "
                             f"call)")


def check_graphstate_ops(ops: dict, case: str) -> None:
    """Each graphstate function ran on the card and took at most its
    GRAPHSTATE_MAX_ATEN_OPS aten ops a call (counted by
    instrument_devgraph)."""
    for n in _GRAPHSTATE:
        c = ops.get(n, {"calls": 0, "aten_ops": 0})
        cap = GRAPHSTATE_MAX_ATEN_OPS[n]
        if not c["calls"] or c["aten_ops"] > cap * c["calls"]:
            raise AssertionError(f"{case}: {n} took {c} aten ops on the "
                                 f"card (at most {cap} a call)")


def check_build_ops(ops: dict, case: str) -> None:
    """build_k ran on the card and took at most BUILD_MAX_ATEN_OPS aten ops
    a call (counted by instrument_devgraph)."""
    c = ops.get("build_k", {"calls": 0, "aten_ops": 0})
    if not c["calls"] or c["aten_ops"] > BUILD_MAX_ATEN_OPS * c["calls"]:
        raise AssertionError(f"{case}: build_k took {c} aten ops on the "
                             f"card (at most {BUILD_MAX_ATEN_OPS} a call)")


@contextlib.contextmanager
def pack_split(split: dict):
    """While active: add to `split` the host seconds and calls of the
    three parts of t_dg_pack (engine/devicepipe.py::_dispatch_chunk):
    pack_chunk, the H2D copy of its arrays (parallel/mesh.py::_rows
    within the dispatch) and build_k's dispatch."""
    from lancet_tpu_torch.engine import devicepipe
    from lancet_tpu_torch.gpu import dbg, pack
    from lancet_tpu_torch.parallel import mesh

    real = {"pack_chunk": (pack, pack.pack_chunk),
            "h2d": (mesh, mesh._rows), "build_k": (dbg, dbg.build_k)}
    real_d = devicepipe._dispatch_chunk
    inside = threading.local()
    names = {"pack_chunk": "pack_chunk", "h2d": "_rows",
             "build_k": "build_k"}

    def timed(key, f):
        def g(*a, **k):
            if key == "h2d" and not getattr(inside, "on", False):
                return f(*a, **k)
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                with _SPLIT_LOCK:
                    split[f"t_{key}"] = split.get(f"t_{key}", 0.0) + dt
                    split[f"n_{key}"] = split.get(f"n_{key}", 0) + 1
        return g

    def dispatch(*a, **k):
        inside.on = True
        try:
            return real_d(*a, **k)
        finally:
            inside.on = False

    for key, (mod, f) in real.items():
        setattr(mod, names[key], timed(key, f))
    devicepipe._dispatch_chunk = dispatch
    try:
        yield
    finally:
        for key, (mod, f) in real.items():
            setattr(mod, names[key], f)
        devicepipe._dispatch_chunk = real_d


_SPLIT_LOCK = threading.Lock()


def run_devgraph(workdir: str, region: str, stats: dict, num_threads=8,
                 **kw):
    """runner.run with LANCET_TPU_DEVGRAPH=1 on the card."""
    os.environ["LANCET_TPU_DEVGRAPH"] = "1"
    try:
        return run_captured(workdir, region, stats, device="cuda",
                            num_threads=num_threads, **kw)
    finally:
        del os.environ["LANCET_TPU_DEVGRAPH"]


@contextlib.contextmanager
def sum_attempts(sums: dict):
    """While active: add numcomp, n_sel and fallback of every unsharded
    attempt tail's output (devicepipe._assemble) into `sums`, the
    counterpart of a mesh run's mesh_counters."""
    from lancet_tpu_torch.engine import devicepipe

    real = devicepipe._assemble

    def summed(*a, **k):
        out = real(*a, **k)
        for key in ("numcomp", "n_sel", "fallback"):
            sums[key] = sums.get(key, 0) + int(out[key].long().sum())
        return out

    devicepipe._assemble = summed
    try:
        yield
    finally:
        devicepipe._assemble = real


def profile_devgraph(workdir: str, region: str, t_unprofiled: float) -> dict:
    """One more devgraph run under torch.profiler: the card's busy time
    (the sum of its kernel and copy intervals, which do not overlap on one
    stream) against the wall time of this run and of the unprofiled run
    (the profiler slows the host, not the card), and the kernels that take
    most. The profile's raw events are read: building the profiler's event
    tree over a run's million host events takes minutes. A profiler that
    cannot trace the card gives "not_measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    st: dict = {}
    by_name: dict = {}
    # only the profiler's own failures become a measurement gap: an error
    # of the run itself propagates
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except (AttributeError, RuntimeError) as e:
        return {"not_measured": f"profiler: {e}"}
    try:
        run_devgraph(workdir, region, st)
    except BaseException:
        prof.stop()
        raise
    try:
        prof.stop()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ms, n = by_name.get(e.name(), (0.0, 0))
                by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    except (AttributeError, RuntimeError) as e:
        return {"not_measured": f"profiler: {e}"}
    if not by_name:
        return {"not_measured": "the profiler recorded no device event"}
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"t_total_profiled": st["t_total"], "busy_ms": busy_ms,
            "busy_share_profiled": busy_ms / 1e3 / st["t_total"],
            "busy_share": busy_ms / 1e3 / t_unprofiled,
            "device_events": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:80], "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def _narrow(x):
    """A walk input as the kernel reads it: int32 or bytes."""
    import torch

    if not torch.is_tensor(x):
        return x
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x.to(torch.int32) if x.dtype == torch.int64 else x


def smem_latency_ns() -> dict:
    """The latency of one dependent shared-memory load on this card: the
    probe kernel of csrc/walks.cu (one thread chasing a ring in shared
    memory) timed at two chain lengths with CUDA events; the slope is ns a
    load, free of the launch's own time."""
    import ctypes

    import torch

    from lancet_tpu_torch.gpu import walks

    lib = walks._load()
    lib.smem_chase.restype = ctypes.c_int
    lib.smem_chase.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p]
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def chase(n):
        rc = lib.smem_chase(n, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"smem_chase launch failed: CUDA error {rc}")

    chase(CHASE_STEPS[0])  # warm up
    lo, hi = (statistics.median(cuda_times(lambda n=n: chase(n), 5))
              for n in CHASE_STEPS)
    return {"ns_per_load": (hi - lo) * 1e6 / (CHASE_STEPS[1]
                                                - CHASE_STEPS[0]),
            "ms": {str(n): t for n, t in zip(CHASE_STEPS, (lo, hi))},
            "source": "csrc/walks.cu smem_chase_kernel, this run"}


def almost_repeat_words(n: int, K: int, plan) -> tuple[int, int]:
    """csrc/walks.cu K3 on a string of n codes with no hit: the 32-position
    mismatch words its tiles build, over all threads and on the busiest
    thread (tile t goes to thread t % (blocks x threads) of the string's
    cluster; a tile of nv starts builds ceil(nv / 32) + 1 words, one more
    for K > 32)."""
    import numpy as np

    maxp = n - K - 1
    if maxp < 1:
        return 0, 0
    G, T = plan.tile, plan.blocks * plan.threads
    npairs = (maxp + 1) // 2
    t = np.arange(npairs * ((maxp + G) // G + 1))
    pair, i = t % npairs, t // npairs
    d1, d2 = 1 + pair, maxp - pair
    segs1 = (maxp - d1 + G) // G
    second = i >= segs1
    d = np.where(second, d2, d1)
    seg = np.where(second, i - segs1, i)
    empty = second & ((d2 == d1) | (seg * G > maxp - d2))
    nv = np.minimum(G, maxp - d - seg * G + 1)
    words = np.where(empty, 0, (nv + 31) // 32 + 1 + (K > 32))
    per = np.bincount(t % T, weights=words, minlength=T)
    return int(words.sum()), int(per.max())


def removal_accounting(st, cond, U, D2, alive_out) -> dict:
    """What one removal pass needs on this data: the bytes (each input
    element it must read once: every item's alive and special byte, a live
    item's rank, merlen and, for links, mincov and guard, thr a window,
    every edge's alive byte and an alive edge's two ends; each output
    once), the slots swept and the kills, and its serial chain in
    dependent shared loads: the busiest window's slots plus
    REMOVAL_KILL_LOADS a kill (WALK_CHAIN_LOADS is 1 a slot)."""
    W, NI = st["alive"].shape
    EE = st["e_src"].shape[1]
    links = cond[0] == "links"
    live = (st["alive"] & ~st["special"]).sum(dim=1)
    slots = live.clamp(max=U)
    kills = (st["alive"] & ~alive_out).sum(dim=1)
    n_live = int(live.sum())
    nbytes = (2 * W * NI + (16 + (9 if links else 0)) * n_live
              + (8 * W if links else 0) + W * EE
              + 16 * int(st["e_alive"].sum())  # the inputs
              + W * NI + W * EE + 2 * W)  # alive', e_alive', the flags
    return {"bytes": nbytes, "slots": int(slots.sum()),
            "kills": int(kills.sum()), "live": n_live,
            "chain": int((slots + REMOVAL_KILL_LOADS * kills).max())
            if W else 0}


def walk_case(name: str, args, kw: dict, rate: dict, chase: dict) -> dict:
    """One walk kernel on inputs captured from the devgraph runs: its
    outputs bit-equal to the plain version on the card, then timed beside
    it (CUDA events; the kernel's wrapper on int32/byte inputs, so the
    launch and the widening of its outputs) and by the kernel's own
    device time (torch.profiler), the card's bound, and the
    chain floor: the walk's longest serial chain on this data (counted by
    the plain version; for almost_repeat from its tile plan) x
    WALK_CHAIN_LOADS x the measured latency of a dependent shared-memory
    load."""
    import torch

    from lancet_tpu_torch.gpu import pipeline, stages, walks

    kname = _WALKS[name]
    fn = getattr(walks, name)
    counts: dict = {}
    if name == "path_cover":
        def plain(c=None):
            return pipeline.path_cover_plain(*args, **kw, counts=c)
    elif name == "seq_removal":
        def plain(c=None):
            return removal_plain(*args)
    elif name == "almost_repeat":
        def plain(c=None):
            return pipeline.almost_repeat_plain(*args, **kw)
    else:
        def plain(c=None):
            return stages.cycle_dfs_plain(*args, **kw, counts=c)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain(counts)
    torch.cuda.synchronize()
    err = _mismatches(got, want)
    if err:
        raise AssertionError(f"{kname} disagrees with its plain version on "
                             f"{err} outputs")
    # K2 takes the engine's state as it is; the others int32 and bytes
    narrow = (list(args) if name == "seq_removal"
              else _tree(list(args), _narrow))
    ms = spread(cuda_times(lambda: fn(*narrow, **kw), *KERNEL_REPS))
    dev_ms = device_ms(lambda: fn(*narrow, **kw), _KERNEL_NAMES[kname])
    plain_ms = spread(cuda_times(plain, WALK_PLAIN_REPS))

    # bytes: each input element the walk reads on this data, once (int32,
    # bytes; the plain version marks them, stages.touch), each output
    # once; units of work: this data's pops, slots, steps or compared
    # positions
    def seen(key):
        return int((counts[key] > 0).sum()) if key in counts else 0

    if name == "path_cover":
        D2, W = args[0].shape[2], args[0].shape[0]
        C, J, PN = kw["Cmax"], kw["JMAX"], kw["PN"]
        nbytes = (4 * D2 * seen("adj_rows") + 4 * seen("e_dir")
                  + 4 * seen("e_dst") + 5 * seen("nodes")
                  + 4 * W + 5 * W * C  # numcomp, runnable, reflens
                  + 4 * W * J * PN + 8 * W * J + 5 * W)  # the outputs
        units = counts["pops"]
        # one warp walks a window's components in turn
        chain = int(counts["lanes"]["pops"].max())
    elif name == "seq_removal":
        acc = removal_accounting(*args, got[0])
        nbytes, units, chain = acc["bytes"], acc["slots"], acc["chain"]
    elif name == "almost_repeat":
        seq, lens = args[0], args[1]
        W, J, LP = seq.shape
        nbytes = int(lens.clamp(0, LP).sum()) + 5 * W * J
        K = args[2]
        plan = walks.almost_repeat_plan(LP, K)
        units = chain = 0
        for n, hit in zip(lens.clamp(0, LP).reshape(-1).tolist(),
                          got.reshape(-1).tolist()):
            maxp = n - K - 1
            if hit:
                units += K + 1  # one window compared at the least
            elif maxp > 0:
                # every shift's mismatch bits over [0, n - d)
                units += sum(n - d for d in range(1, maxp + 1))
                chain = max(chain, almost_repeat_words(n, K, plan)[1])
    else:
        W, C = args[0].shape[0], args[6]
        nbytes = (4 * seen("adj") + 4 * seen("e_dir") + 4 * seen("e_dst")
                  + seen("special") + 3 * W * C)  # alive, lane_mask, flags
        units = counts["steps"]
        # a window's components walk side by side, one warp each
        chain = int(counts["lanes"]["steps"].max())
    nops = WALK_OPS[kname] * units
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / rate["int_ops_per_s"] * 1e3}
    chain_ms = chain * WALK_CHAIN_LOADS[kname] * chase["ns_per_load"] / 1e6
    shape = (list(args[0]["alive"].shape) + [args[0]["e_src"].shape[1]]
             if name == "seq_removal" else list(args[0].shape))
    return {"name": kname, "shape": shape,
            "work_units": units, "tolerance": 0, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound": bound, "chain_units": chain, "chain_loads": WALK_CHAIN_LOADS[kname],
            "chain_floor_ms": chain_ms, "bytes": nbytes, "int_ops": nops}


def aten_ops(fn) -> int:
    """The aten ops one call of fn dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def screen_rounds(args) -> tuple:
    """cycle_screen's rounds on this data, per window: the reach rounds
    (up to and including the first that changes nothing, at most T), the
    peel rounds (up to and including the first with an empty layer) and
    the active edges; the plain version's two loops with a window's count
    stopping where its loop would. The kernel runs both in the same
    rounds, max(reach rounds, peel rounds) a window."""
    import torch

    from lancet_tpu_torch.gpu import stages

    e_src, e_dst, e_dir, e_alive, alive, special, _, N, NI, Cmax = args[:10]
    T = args[10] if len(args) > 10 else 32
    W = e_src.shape[0]
    srcs = e_src.clamp(0, NI - 1)
    dsts = e_dst.clamp(0, NI - 1)
    eact = (e_alive & stages._take(alive, srcs) & stages._take(alive, dsts)
            & ~stages._take(special, dsts))
    s_st = srcs * 2 + stages.startbit(e_dir)
    d_st = dsts * 2 + stages.destbit(e_dir)
    reach = torch.zeros((W, 2 * NI), dtype=torch.bool, device=e_src.device)
    for c in range(Cmax):
        reach[:, 2 * (N + 2 * c)] |= alive[:, N + 2 * c]
        reach[:, 2 * (N + 2 * c) + 1] |= alive[:, N + 2 * c]
    rounds = torch.zeros(W, dtype=torch.int64, device=e_src.device)
    on = torch.ones(W, dtype=torch.bool, device=e_src.device)
    for _ in range(T):
        rounds += on
        m = stages._take(reach, s_st) & eact
        new = reach | (stages.scatter_max(2 * NI, 0, d_st, m.long(), W) > 0)
        on &= (new != reach).any(dim=1)
        reach = new
        if not bool(on.any()):
            break
    live = (alive & ~special).repeat_interleave(2, dim=1)
    eact_p = eact & ~stages._take(special, srcs)
    indeg = stages.scatter_add(2 * NI, d_st, eact_p.long(), W)
    peels = torch.zeros_like(rounds)
    on = torch.ones_like(on)
    for _ in range(T):
        peels += on
        f = live & (indeg == 0)
        indeg = indeg.scatter_add(
            1, d_st, -(stages._take(f, s_st) & eact_p).long())
        live &= ~f
        on &= f.any(dim=1)
        if not bool(on.any()):
            break
    inside = (s_st >= 0) & (s_st < 2 * NI) & (d_st >= 0) & (d_st < 2 * NI)
    return (rounds.tolist(), peels.tolist(),
            (eact & inside).sum(dim=1).tolist())


def screen_accounting(name: str, args) -> dict:
    """What one screen call needs on this data. tandem_at: the bytes of
    each string's codes below min(lens, L) (int64), its lens and its flag;
    the operations of its positions and, for each string probed, its
    prefix sums (TANDEM_OPS_*); its chain, the longest probed string's
    positions. cycle_screen: every input element once (three int64 and
    one bool a edge, two bools and an int64 an item) and the flags; the
    operations of the staging and of each window's rounds on its active
    edges (SCREEN_OPS); its chain, the slowest window's rounds."""
    if name == "tandem_at":
        seqs, lens, _, mu = args[:4]
        B, L = seqs.shape
        mu = max(int(mu), 0)
        positions = int(lens.clamp(0, L).sum())
        probed = int((lens > 0).sum())
        nops = (positions * sum(TANDEM_OPS_RUN * m + TANDEM_OPS_STEP
                                for m in range(1, mu + 1))
                + probed * L * max(mu - 1, 0) * TANDEM_OPS_PREFIX)
        return {"bytes": 8 * positions + 9 * B, "int_ops": nops,
                "positions": positions, "strings_probed": probed,
                "chain_units": int(lens.clamp(0, L).max()) if B else 0}
    W, EE = args[0].shape
    NI, Cmax = args[8], args[9]
    rounds, peels, active = screen_rounds(args)
    both = [max(r, p) for r, p in zip(rounds, peels)]
    o = SCREEN_OPS
    nops = (W * EE * o["stage_edge"] + W * NI * o["item"]
            + o["round_edge"] * sum(b * a for b, a in zip(both, active)))
    return {"bytes": 25 * W * EE + 10 * W * NI + W * Cmax, "int_ops": nops,
            "reach_rounds": rounds, "peel_rounds": peels,
            "active_edges": active, "chain_units": max(both, default=0)}


def screen_case(name: str, args, kw: dict, rate: dict, chase: dict) -> dict:
    """One screen kernel on inputs captured from the devgraph runs: its
    output bit-equal to the plain version on the card, then timed beside
    it (CUDA events around the wrapper; the kernel's own device time,
    torch.profiler), the aten ops a call dispatches, the card's bound and
    the chain floor (screen_accounting, SCREEN_CHAIN_LOADS, the smem_chase
    latency)."""
    import torch

    from lancet_tpu_torch.gpu import screens, stages

    fn = getattr(screens, name)
    plain = getattr(stages, f"{name}_plain")
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = _mismatches(got, want)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"{err} outputs")
    ms = spread(cuda_times(lambda: fn(*args, **kw), *KERNEL_REPS))
    dev_ms = device_ms(lambda: fn(*args, **kw), _SCREEN_KERNELS[name])
    plain_ms = spread(cuda_times(lambda: plain(*args, **kw),
                                 WALK_PLAIN_REPS))
    acc = screen_accounting(name, args)
    bound = {"bytes": acc["bytes"] / HBM_BYTES_PER_S * 1e3,
             "operations": acc["int_ops"] / rate["int_ops_per_s"] * 1e3}
    return {"name": name, "shape": [list(args[0].shape), *(
        [list(args[4].shape)] if name == "cycle_screen" else [])],
        "tolerance": 0, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms, "bound": bound,
        "aten_ops_per_call": aten_ops(lambda: fn(*args, **kw)),
        "plain_aten_ops_per_call": aten_ops(lambda: plain(*args, **kw)),
        "chain_loads": SCREEN_CHAIN_LOADS,
        "chain_floor_ms": acc["chain_units"] * SCREEN_CHAIN_LOADS
        * chase["ns_per_load"] / 1e6, **acc}


def compress_rounds(st, NI: int) -> list:
    """The pointer-jumping rounds the kernel runs in each window of a
    compress_round call: up to and including the first that changes no
    word of the window, at most the plain loop's bound (the plain loop's
    links and words on the card)."""
    import torch

    from lancet_tpu_torch.gpu import stages

    lnk = stages.links(st["e_src"], st["e_dst"], st["e_dir"], st["e_alive"],
                       st["e_okey"], st["alive"], st["special"], NI)
    W, S = lnk["lnk_valid"].shape[0], 2 * NI
    valid = lnk["lnk_valid"].reshape(W, S)
    to = (lnk["lnk_to"] * 2 + lnk["lnk_bit"]).reshape(W, S)
    sid = torch.arange(S, device=valid.device)[None].expand(W, S)
    p = (torch.where(valid, to, sid) << 13) | valid.to(torch.int64)
    dcap, mask = min(NI + 8, 8191), 8191
    rounds = torch.zeros(W, dtype=torch.int64, device=p.device)
    on = torch.ones(W, dtype=torch.bool, device=p.device)
    for _ in range(max(2, int(NI + 8).bit_length())):
        rounds += on
        q = torch.gather(p, 1, p >> 13)
        p2 = (q & ~mask) | torch.clamp((p & mask) + (q & mask), max=dcap)
        on &= (p2 != p).any(dim=1)
        p = p2
        if not bool(on.any()):
            break
    return rounds.tolist()


def compress_accounting(args) -> dict:
    """What one compress_round call needs on this data: every input
    element read once and every output written once (the shapes and dtypes
    of compress.INPUTS and OUTPUTS, and the fallback flags); the integer
    operations of COMPRESS_OPS over its items, edges and mers and each
    window's jumping rounds on its states; its chain, the slowest window's
    rounds."""
    import torch

    from lancet_tpu_torch.gpu import compress

    st, _, NI = args[:3]
    W, EE = st["e_src"].shape
    NM = st["mer_item"].shape[1]
    n_in = sum(st[k].numel() * st[k].element_size()
               for k in compress.INPUT_KEYS)
    per = {"i": NI, "i4": 4 * NI, "e": EE, "m": NM}
    n_out = W * sum(per[ax] * (1 if dt == torch.bool else 8)
                    for _, dt, ax in compress.OUTPUTS) + W
    rounds = compress_rounds(st, NI)
    o = COMPRESS_OPS
    nops = (W * (NI * o["item"] + EE * o["edge"] + NM * o["mer"])
            + o["state_round"] * 2 * NI * sum(rounds))
    return {"bytes": n_in + n_out, "int_ops": nops, "rounds": rounds,
            "W": W, "NI": NI, "EE": EE, "NM": NM,
            "chain_units": max(rounds, default=0)}


def compress_case(args, kw: dict, rate: dict, chase: dict) -> dict:
    """The kernel on one compress_round call captured from the devgraph
    runs: its outputs bit-equal to the plain version on the card (dtypes
    too), then timed beside it (CUDA events around the wrapper; the
    kernel's own device time, torch.profiler), the aten ops a call
    dispatches, the card's bound (compress_accounting) and the chain floor
    (COMPRESS_CHAIN_LOADS, the smem_chase latency)."""
    import torch

    from lancet_tpu_torch.gpu import compress

    def fn():
        return _walk_out(_COMPRESS, compress.compress_round(*args, **kw))

    got = fn()
    torch.cuda.synchronize()
    want = compress_plain(*args, **kw)
    torch.cuda.synchronize()
    err = dtype_mismatches(got, want)
    if err:
        raise AssertionError(f"compress_round disagrees with its plain "
                             f"version on {err} outputs")
    ms = spread(cuda_times(fn, *KERNEL_REPS))
    dev_ms = device_ms(fn, "compress_kernel")
    plain_ms = spread(cuda_times(lambda: compress_plain(*args, **kw),
                                 WALK_PLAIN_REPS))
    acc = compress_accounting(args)
    bound = {"bytes": acc["bytes"] / HBM_BYTES_PER_S * 1e3,
             "operations": acc["int_ops"] / rate["int_ops_per_s"] * 1e3}
    W, NI, EE, NM = acc["W"], acc["NI"], acc["EE"], acc["NM"]
    grid = cluster_grid(fn, "compress_kernel", W, compress.plan_for(
        W, NI, EE, NM, args[0]["alive"].device))
    return {"name": _COMPRESS, **grid, "tolerance": 0,
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms, "bound": bound,
        "aten_ops_per_call": aten_ops(fn),
        "plain_aten_ops_per_call": aten_ops(
            lambda: compress_plain(*args, **kw)),
        "chain_loads": COMPRESS_CHAIN_LOADS,
        "chain_floor_ms": acc["chain_units"] * COMPRESS_CHAIN_LOADS
        * chase["ns_per_load"] / 1e6, **acc}


def _kept_positions(st, K: int):
    """(kept totq positions, donating mers) of a low-coverage call: each
    mer of width > 0 reads its kept window within [0, K)."""
    import torch

    lo, hi, f = st["keep_lo"], st["keep_hi"], st["mer_flip"]
    on = hi > lo
    clo = torch.where(f, K - hi, lo).clamp(0, K)
    chi = torch.where(f, K - lo, hi).clamp(0, K)
    return int(torch.where(on, chi - clo, 0).sum()), int(on.sum())


def _col_bytes(spec, axes, st, skip=()) -> int:
    """The bytes of one element of each column of `spec` on `axes` that
    the state holds, those in `skip` left out (i4: four int64)."""
    import torch

    return sum((1 if dt == torch.bool else 8) * (4 if ax == "i4" else 1)
               for k, dt, ax in spec
               if ax in axes and k in st and k not in skip)


def graphstate_accounting(name: str, args) -> dict:
    """What one graphstate call needs on this data: each input element
    the function needs read once, each output written once. The flags are
    read over every item, edge and mer; the data columns only where the
    function uses them: components the ranks of alive items and the ends
    of alive edges; compact_state the columns of the items it gathers
    (min(n_reg, NCR) regular ones and the 2 Cmax anchors) and of the
    edges it packs (min(alive, EC)), and one of keep_lo / keep_hi a mer;
    low_cov_pass and item_mincovs mer_totq's kept positions, the
    donating mers' columns, low_cov_pass the csum and merlen of alive
    regular items and the ends of alive edges. The integer operations of
    GRAPHSTATE_OPS on the same counts."""
    from lancet_tpu_torch.gpu import graphstate

    o = GRAPHSTATE_OPS
    if name == "components":
        alive, e_src, _, e_alive = args[:4]
        W, NI = alive.shape
        EE = e_src.shape[1]
        na, ne = int(alive.sum()), int(e_alive.sum())
        nbytes = W * (NI + EE + 8 * NI + 9) + 8 * na + 16 * ne
        nops = ne * o["comp_edge"] + W * NI * o["comp_item"]
        return {"bytes": nbytes, "int_ops": nops, "alive_items": na,
                "alive_edges": ne, "W": W, "NI": NI, "EE": EE}
    st = args[0]
    spec = graphstate.COMPACT_INPUTS
    if name == "compact_state":
        N, NI, Cmax, NCR, ECR = args[1:6]
        W, EE = st["e_src"].shape
        NM = st["mer_item"].shape[1]
        NC, EC = NCR + 2 * Cmax, ECR + 4 * Cmax
        n_reg = (st["alive"] & ~st["special"]).sum(dim=1)
        n_e = st["e_alive"].sum(dim=1)
        items = int(n_reg.clamp(max=NCR).sum()) + W * 2 * Cmax
        edges = int(n_e.clamp(max=EC).sum())
        n_in = (W * (2 * NI + EE + 16 * NM)
                + items * _col_bytes(spec, ("i", "i4"), st,
                                     ("alive", "special"))
                + edges * _col_bytes(spec, ("e",), st, ("e_alive",)))
        n_out = W * (NC * _col_bytes(graphstate.COMPACT_OUTPUTS,
                                     ("i", "i4"), st)
                     + EC * _col_bytes(graphstate.COMPACT_OUTPUTS, ("e",),
                                       st) + 16 * NM + 2)
        nops = W * (NI * o["compact_item"] + EE * o["compact_edge"]
                    + NM * o["compact_mer"])
        return {"bytes": n_in + n_out, "int_ops": nops,
                "gathered_items": items, "packed_edges": edges, "W": W,
                "NI": NI, "EE": EE, "NM": NM}
    K, NI = args[1], args[3]
    W, NM = st["mer_item"].shape
    pos, mers = _kept_positions(st, K)
    nops = pos * o["low_pos"] + mers * o["low_mer"]
    acc = {"kept_positions": pos, "donating_mers": mers, "W": W, "NI": NI,
           "NM": NM, "K": K}
    if name == "item_mincovs":  # mer_tot, mer_item, mer_flip a donor
        nbytes = 8 * pos + 16 * W * NM + 17 * mers + 16 * W * NI
        return {"bytes": nbytes, "int_ops": nops, **acc}
    EE = st["e_src"].shape[1]
    reg = int((st["alive"] & ~st["special"]).sum())
    ne = int(st["e_alive"].sum())
    nbytes = (8 * pos + 16 * W * NM + 9 * mers + 40 * reg + 16 * ne
              + W * (2 * NI + EE + 4) + W * (NI + EE + 1))
    nops += W * (NI * o["low_item"] + EE * o["low_edge"])
    return {"bytes": nbytes, "int_ops": nops, "regular_items": reg,
            "alive_edges": ne, "EE": EE, **acc}


def graphstate_case(name: str, args, kw: dict, rate: dict) -> dict:
    """One graphstate kernel on a call captured from the devgraph runs:
    its outputs bit-equal to the plain version on the card (dtypes too),
    then timed beside it (CUDA events around the wrapper; the kernel's own
    device time, torch.profiler), the aten ops a call dispatches and the
    card's bound (graphstate_accounting)."""
    import torch

    from lancet_tpu_torch.gpu import graphstate

    def fn():
        return _walk_out(name, getattr(graphstate, name)(*args, **kw))

    def plain():
        return graphstate_plain(name, args, kw)

    got = fn()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    err = dtype_mismatches(got, want)
    if err:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"{err} outputs")
    ms = spread(cuda_times(fn, *KERNEL_REPS))
    dev_ms = device_ms(fn, _GRAPHSTATE_KERNELS[name])
    plain_ms = spread(cuda_times(plain, WALK_PLAIN_REPS))
    acc = graphstate_accounting(name, args)
    bound = {"bytes": acc["bytes"] / HBM_BYTES_PER_S * 1e3,
             "operations": acc["int_ops"] / rate["int_ops_per_s"] * 1e3}
    grid = {}
    if name in _LOWCOV:  # W clusters of the plan's C
        st, K, NI = args[0], args[1], args[3]
        W, NM = st["mer_item"].shape
        low = name == "low_cov_pass"
        EE = st["e_src"].shape[1] if low else 0
        plan = graphstate.lowcov_plan(NI, NM, K, low, EE)
        grid = cluster_grid(fn, _GRAPHSTATE_KERNELS[name], W, plan)
    return {"name": name, "tolerance": 0, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound": bound,
            **grid, "aten_ops_per_call": aten_ops(fn),
            "plain_aten_ops_per_call": aten_ops(plain), **acc}


def device_ms_by_kernel(fn, kernels, n: int = 10,
                        launches: dict | None = None,
                        blocks: bool = False) -> dict:
    """{kernel: device ms per call of fn} summed over the launches whose
    name holds the kernel's (a tuple of names: any of them, keyed by the
    tuple), and "all": every kernel of the call, from torch.profiler's
    CUDA activity over n calls (None where none was recorded). With
    `launches` ({kernel: launches a call}) a profile counts only where it
    holds every launch of each kernel (n of them a launch a call: a
    profile can drop kernel records, and a sum over some of them reads
    low); a kernel never seen whole reads None, and so does "all". With
    `blocks`, also "blocks": {kernel: the blocks of its launches' grids in
    the profile returned, each distinct count once, least first}, read
    from the profiler's kernel records (its trace's "grid"), and "smem"
    (their "shared memory" a block, where the trace has it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def hits(k, m):
        return any(x in m for x in ((k,) if isinstance(k, str) else k))

    def with_blocks(prof, out):
        if not blocks:
            return out
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                tr = json.load(f)
        recs = [(e["name"], e["args"]) for e in tr["traceEvents"]
                if e.get("cat") == "kernel" and "grid" in e.get("args", {})]
        return {**out, "blocks": {
            k: sorted({a["grid"][0] * a["grid"][1] * a["grid"][2]
                       for m, a in recs if hits(k, m)}) for k in kernels},
            "smem": {k: sorted({a["shared memory"] for m, a in recs
                                if hits(k, m) and "shared memory" in a})
                     for k in kernels}}

    fn()
    torch.cuda.synchronize()
    for _ in range(5 if launches else 3):  # a profile that missed kernels
        with profile(activities=[ProfilerActivity.CPU,  # is taken again
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [(e.name(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
        out = {k: sum(d for m, d in ev if hits(k, m)) / n / 1e6
               for k in kernels}
        out["all"] = sum(d for _, d in ev) / n / 1e6
        if launches is None:
            if all(out[k] for k in kernels):
                return with_blocks(prof, out)
            continue
        whole = {k: sum(hits(k, m) for m, _ in ev) == n * launches.get(k, 0)
                 for k in kernels}
        if all(whole.values()):
            return with_blocks(prof, {k: v or None for k, v in out.items()})
    if launches is not None:
        return with_blocks(prof, {**{k: out[k] if whole[k] and out[k]
                                     else None for k in kernels},
                                  "all": None})
    return with_blocks(prof, {k: out[k] or None for k in out})


def cluster_grid(fn, kernel: str, W: int, plan) -> dict:
    """The cluster size and grid of the one launch of `kernel` a call of
    fn makes, read from the profiler's records: "blocks" the grid's block
    count (one count over the profile), "cluster" blocks // W, and "smem"
    the records' shared memory a block (None where the trace has none).
    Raises unless the grid is W whole clusters of a size of
    gpu.compress.CLUSTER_SIZES, and that size is the wrapper's `plan`'s
    (plan_for, lowcov_plan)."""
    from lancet_tpu_torch.gpu import compress

    by = device_ms_by_kernel(fn, [kernel], launches={kernel: 1}, blocks=True)
    blocks = by["blocks"][kernel]
    if len(blocks) != 1:
        raise AssertionError(f"{kernel}: the profile holds grids of "
                             f"{blocks} blocks, one count expected")
    C = blocks[0] // W
    if blocks[0] != W * C or C not in compress.CLUSTER_SIZES:
        raise AssertionError(f"{kernel}: a grid of {blocks[0]} blocks is not "
                             f"{W} clusters of one of "
                             f"{compress.CLUSTER_SIZES} blocks")
    if C != plan.C:
        raise AssertionError(f"{kernel}: the profile's grid gives clusters "
                             f"of {C} blocks, the wrapper's plan {plan.C}")
    smem = by["smem"][kernel]
    return {"cluster": C, "blocks": blocks,
            "smem": smem[0] if len(smem) == 1 else smem or None}


def queued_ms(fn, n: int = 20) -> float:
    """Device ms per call of fn: CUDA events around n calls that the host
    queued behind a spin kernel (torch.cuda._sleep), so that the card runs
    them back to back; the gaps between a call's kernels are in it, the
    host's dispatch is not. No profiler."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host = time.perf_counter() - t  # the host's seconds to issue a call
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # spin 3x as long as the host takes to queue the n calls (2e9 cycles
    # at most: ~1 s at 1,980 MHz)
    torch.cuda._sleep(int(2e9 * min(3 * n * host + 1e-3, 1.0)))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def build_stage_inputs(args, kw):
    """The plain stages on a build_k call's inputs on the card: the
    instance table, its sort permutation and the node tables, the inputs
    of each kernel."""
    from lancet_tpu_torch.gpu import dbg

    K, t = args[0], args[1:]
    inst = dbg.mer_instances_plain(K, *t[:11], t[12], Lraw=kw["Lraw"],
                                   min_qual_call=kw["min_qual_call"])
    perm = dbg.window_sort_plain(inst["keys"])
    nodes = dbg.node_tables_plain(
        K, inst, perm, t[8], t[11], N=kw["N"],
        low_cov_threshold=kw["low_cov_threshold"],
        min_cov_ratio=kw["min_cov_ratio"])
    return inst, perm, nodes


def build_accounting(name: str, args, kw, inst) -> dict:
    """What one call of a build kernel's function needs: each input read
    once, each output written once (bytes), and the integer operations of
    BUILD_OPS on this call's counts."""
    from lancet_tpu_torch.gpu import dbg, dbgk

    K = args[0]
    W, R, L = args[1].shape
    p = dbgk.build_plan(K, W, R, L, kw["Lraw"], kw["N"], kw["E"], kw["D"])
    NW, I, IP, N, E = p.NW, p.I, p.IP, p.N, p.E
    o = BUILD_OPS
    reads = int(dbg.pay_bit(inst["pay"][:, :IP], dbg.P_READ).sum())
    if name == "mer_instances":
        nbytes = (2 * W * R * L + 11 * W * R + W * p.Lraw + 13 * W
                  + 8 * W * I * (NW + 2) + 8 * W * IP * (NW + 1))
        nops = W * I * K * o["base"] + W * IP * (K + 1) * o["qual"]
    elif name == "window_sort":  # the instance sort
        nbytes = 8 * W * I * (NW + 1)
        nops = W * I * p.sorts["inst"].P * o["digit"]
    elif name == "node_tables":
        nbytes = (8 * W * I * (NW + 4) + 8 * W + 8 * NW * W * N
                  + 48 * W * N + 24 * W * N * K + 6 * W * N + 21 * W)
        nops = W * I * o["instance"] + reads * K * o["qbit"]
    else:
        nbytes = (16 * W * I + 8 * W * IP * (NW + 1) + 41 * W * N + 18 * W
                  + 25 * W * E + 8 * W * N * p.D + 8 * W * N
                  + 9 * W * p.Mraw + 32 * W * p.Lraw + 10 * W)
        nops = W * p.PU * o["pair"] + 2 * W * E * o["row"]
    return {"bytes": nbytes, "int_ops": nops, "K": K, "W": W, "R": R,
            "L": L, "N": N, "E": E, "I": I, "read_instances": reads}


def build_sorts_case(args, kw: dict, rate: dict) -> dict:
    """The six sorts of a build_k call captured from the devgraph runs,
    each on its keys from one card build (dbgk.build_sort_keys) with the
    build's plan (its declared key ranges): bit-equal to
    window_sort_plain on the card, then its device time (all of its
    kernels, torch.profiler, each launch's record required; also split by
    kernel: the records and pass 0's counts, the counts, the scatters, or
    a one-tile sort's one kernel; and queued_ms, no profiler) and CUDA
    events around the wrapper, beside the plain lexsort chain's
    and, where the sort has one key word, one
    stable torch.sort of that word along the window axis (device time and
    CUDA events: the library yardstick), and its bound: the keys read once
    and the permutation written once, or 2 operations a record a pass."""
    import torch

    from lancet_tpu_torch.gpu import dbg, dbgk

    out = {}
    for name, (keys, sp) in dbgk.build_sort_keys(*args, **kw).items():
        NK, W, n = keys.shape
        before = dbgk.LAUNCHES["window_sort"]
        got = dbgk.window_sort(keys, plan=sp)
        launched = dbgk.LAUNCHES["window_sort"] - before
        torch.cuda.synchronize()
        err = dtype_mismatches(got, dbg.window_sort_plain(keys))
        if err or launched != sp.launches:
            raise AssertionError(f"window_sort ({name} sort): {err} outputs "
                                 f"differ, {launched} launches of "
                                 f"{sp.launches}")
        del got

        def fn(keys=keys, sp=sp):
            return dbgk.window_sort(keys, plan=sp)

        def plain(keys=keys):
            return dbg.window_sort_plain(keys)

        def lib(word=keys[0]):
            return torch.sort(word, dim=1, stable=True)

        ks = _BUILD_KERNELS["window_sort"]  # keys, count, scatter, tile
        multi = sp.T > 1
        dev = device_ms_by_kernel(
            fn, [ks, *ks], launches={ks: sp.launches, ks[0]: multi,
                                     ks[1]: (sp.P - 1) * multi,
                                     ks[2]: sp.P * multi, ks[3]: not multi})
        nbytes = 8 * (NK + 1) * W * n
        nops = 2 * W * n * sp.P
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": nops / rate["int_ops_per_s"] * 1e3}
        by = max(bound, key=bound.get)
        out[name] = {
            "NK": NK, "W": W, "n": n, "key_bits": sp.B, "passes": sp.P,
            "tiles": sp.T, "launches": sp.launches, "max_abs_err": err,
            "device_ms": dev[ks],
            "device_ms_by_kernel": {k: dev[k] for k in ks},
            "queued_ms": queued_ms(fn),
            "ms": spread(cuda_times(fn, *KERNEL_REPS)),
            "plain_device_ms": device_ms_by_kernel(plain, [])["all"],
            "plain_queued_ms": queued_ms(plain),
            "plain_ms": spread(cuda_times(plain, *KERNEL_REPS)),
            "library_device_ms": (device_ms_by_kernel(lib, [])["all"]
                                  if NK == 1 else None),
            "library_queued_ms": queued_ms(lib) if NK == 1 else None,
            "library_ms": (spread(cuda_times(lib, *KERNEL_REPS))
                           if NK == 1 else None),
            "bound_ms": bound[by], "bound_by": by, "bytes": nbytes,
            "int_ops": nops}
    return out


def build_case(args, kw: dict, rate: dict) -> dict:
    """The four build kernels on a build_k call captured from the devgraph
    runs, each on its own inputs (the plain stages' outputs before it):
    bit-equal to its plain version on the card (dtypes too), then timed
    beside it (CUDA events around the wrapper; its kernels' own device
    time and its call's, torch.profiler), its bound on this data
    (build_accounting), and for window_sort (the instance sort, with the
    build's plan) one stable torch.sort of the last key word at the same
    shape; for node_tables and edge_tables also each kernel's device time
    (one launch a call each), the stage's a launch and the blocks of each
    kernel's grid as the profiler recorded them; under window_sort also
    each of the six sorts (build_sorts_case) and the whole build_k call's
    device time."""
    import torch

    from lancet_tpu_torch.gpu import dbg, dbgk

    K, t = args[0], args[1:]
    W, R, L = t[0].shape
    Lraw, N, E, D = kw["Lraw"], kw["N"], kw["E"], kw["D"]
    plan = dbgk.build_plan(K, W, R, L, Lraw, N, E, D)
    inst, perm, nodes = build_stage_inputs(args, kw)
    sc = {k: kw[k] for k in ("low_cov_threshold", "min_cov_ratio")}
    ik = dict(Lraw=Lraw, min_qual_call=kw["min_qual_call"])
    ek = dict(R=R, L=L, N=N, E=E, D=D, Lraw=Lraw)
    calls = {
        "mer_instances": (
            lambda: dbgk.mer_instances(K, *t[:11], t[12], **ik),
            lambda: dbg.mer_instances_plain(K, *t[:11], t[12], **ik)),
        "window_sort": (
            lambda: dbgk.window_sort(inst["keys"], plan=plan.sorts["inst"]),
            lambda: dbg.window_sort_plain(inst["keys"])),
        "node_tables": (
            lambda: dbgk.node_tables(K, inst, perm, t[8], t[11], N=N, R=R,
                                     L=L, Lraw=Lraw, **sc),
            lambda: dbg.node_tables_plain(K, inst, perm, t[8], t[11], N=N,
                                          **sc)),
        "edge_tables": (
            lambda: dbgk.edge_tables(K, inst, nodes, t[12], **ek),
            lambda: dbg.edge_tables_plain(K, inst, nodes, t[12], **ek))}
    out = {}
    for name, (fn, plain) in calls.items():
        before = dict(dbgk.LAUNCHES)
        got = fn()
        launched = {k: dbgk.LAUNCHES[k] - before[k] for k in before
                    if dbgk.LAUNCHES[k] != before[k]}
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err = dtype_mismatches(got, want)
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {err} outputs")
        del got, want
        ms = spread(cuda_times(fn, *KERNEL_REPS))
        ks = _BUILD_KERNELS[name]
        dev = device_ms_by_kernel(fn, [ks], launches={ks: launched[name]})
        plain_ms = spread(cuda_times(plain, WALK_PLAIN_REPS))
        acc = build_accounting(name, args, kw, inst)
        bound = {"bytes": acc["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "operations": acc["int_ops"] / rate["int_ops_per_s"] * 1e3}
        lib = None
        if name == "window_sort":
            last = inst["keys"][-1]
            lib = spread(cuda_times(
                lambda: torch.sort(last, dim=1, stable=True), *KERNEL_REPS))
        split = {}
        if name in ("node_tables", "edge_tables"):
            by = device_ms_by_kernel(fn, list(ks),
                                     launches={k: 1 for k in ks},
                                     blocks=True)
            split = {"device_ms_by_kernel": {k: by[k] for k in ks},
                     "device_ms_per_launch": (dev[ks] / launched[name]
                                              if dev[ks] else None),
                     "blocks_by_kernel": {
                         k: b[0] if len(b) == 1 else b
                         for k, b in by["blocks"].items()}}
        out[name] = {"name": name, "tolerance": 0, "max_abs_err": err,
                     "ms": ms, "device_ms": dev[ks], **split,
                     "queued_ms": queued_ms(fn),
                     "call_device_ms": dev["all"], "plain_ms": plain_ms,
                     "bound": bound, "library_ms": lib,
                     "launches_per_call": launched,
                     "aten_ops_per_call": aten_ops(fn),
                     "plain_aten_ops_per_call": aten_ops(plain), **acc}
    out["window_sort"]["sorts"] = build_sorts_case(args, kw, rate)
    stages = {_BUILD_KERNELS[k]: n for k, n in plan.launches.items()}
    out["window_sort"]["build_device_ms"] = device_ms_by_kernel(
        lambda: dbg.build_k(*args, **kw), list(stages),
        launches=stages)["all"]
    out["window_sort"]["build_queued_ms"] = queued_ms(
        lambda: dbg.build_k(*args, **kw))
    return out


def _nbytes(*ts) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in ts
               if torch.is_tensor(t))


@contextlib.contextmanager
def _counting(mod, names, counts: dict):
    """While active: count the calls of mod's functions `names`."""
    real = {n: getattr(mod, n) for n in names}

    def wrap(n, f):
        def g(*a, **k):
            counts[n] = counts.get(n, 0) + 1
            return f(*a, **k)
        return g

    for n, f in real.items():
        setattr(mod, n, wrap(n, f))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(mod, n, f)


def _plain_kw(kw: dict) -> dict:
    """A tip_fixpoint call's keywords for its plain version, which returns
    new tensors whether or not the call was in place."""
    return {k: v for k, v in kw.items() if k != "inplace"}


def cleanup_accounting(name: str, args, kw: dict, rounds: dict) -> dict:
    """What one call of a cleanup loop needs on this data: each input
    element read once, each output written once, and the integer
    operations of its passes. tip_fixpoint: the state's 16 keys it
    rewrites, special, rank and the fallback in; the 16 keys and the
    fallback out; the links mode's mincov, thr, guard and gate in (an
    in-place links call whose gate is closed: the gate and the fallback
    in, the fallback out); `rounds` the removal passes and compressions the plain version ran on
    this data (REMOVAL_PASS_OPS, COMPRESS_OPS a window). short_link_strings:
    what its tests reach, each read once: alive of every item, special of
    the alive ones, merlen of those not special, mincov of the candidates
    of initial degree >= 2, thr; e_alive of every edge, e_src of the alive
    ones; mer_item of every mer, keep_lo and keep_hi of the mers whose
    item holds a slot, mer_pos of those with a kept base, mer_flip and
    mer_base once a written cell (the write that wins it); its four
    outputs (STRINGS_OPS)."""
    import torch

    from lancet_tpu_torch.gpu import cleanup, pipeline

    st = args[0]
    W, NI = st["alive"].shape
    EE = st["e_src"].shape[1]
    NM = st["mer_item"].shape[1]
    if name == "tip_fixpoint":
        state = [st[k] for k in cleanup.STATE_KEYS]
        links = [t for t in args[1][2:6]] if args[1][0] == "links" else []
        if links and kw.get("inplace") and not bool(links[3].any()):
            # in place with the gate closed: the gate and the fallback in,
            # the fallback out
            n_in, n_out = _nbytes(links[3], args[8]), W
        else:
            n_in = _nbytes(*state, st["special"], st["rank"], args[8],
                           *links)
            n_out = _nbytes(*state) + W
        o = COMPRESS_OPS
        nops = W * (rounds.get("compress_round_plain", 0)
                    * (NI * o["item"] + EE * o["edge"] + NM * o["mer"])
                    + rounds.get("seq_removal_pass_plain", 0)
                    * (NI * REMOVAL_PASS_OPS["item"]
                       + EE * REMOVAL_PASS_OPS["edge"]))
        return {"bytes": n_in + n_out, "int_ops": nops, "W": W, "NI": NI,
                "EE": EE, "NM": NM, "mode": args[1][0],
                "compress_rounds": rounds.get("compress_round_plain", 0),
                "removal_passes": rounds.get("seq_removal_pass_plain", 0)}
    mincov, thr, K, _, max_link = args[1:6]
    alive, ea = st["alive"], st["e_alive"]
    cand, _ = pipeline._short_link_pre(st, mincov, thr, NI, max_link)
    deg0 = torch.zeros((W, NI + 1), dtype=torch.int64,
                       device=ea.device).scatter_add_(
        1, torch.where(ea, st["e_src"], NI), ea.to(torch.int64))[:, :NI]
    slot = torch.cumsum(cand.to(torch.int64), dim=1) - 1
    probed = cand & (slot < cleanup.SL_ITEMS)
    mi = st["mer_item"].clamp(0, NI - 1)
    on = torch.gather(probed, 1, mi)
    j = torch.arange(K, device=ea.device)
    kept = (on[..., None] & (j >= st["keep_lo"][..., None])
            & (j < st["keep_hi"][..., None]))
    pos = int(kept.sum())
    at = (st["mer_pos"][..., None] + j).clamp(0, cleanup.SL_CAP - 1)
    row = (torch.arange(W, device=ea.device)[:, None] * cleanup.SL_ITEMS
           + torch.gather(slot, 1, mi))
    written = int(torch.unique((row[..., None] * cleanup.SL_CAP
                                + at)[kept]).numel())
    cells = W * cleanup.SL_ITEMS * cleanup.SL_CAP
    n_in = (W * NI + int(alive.sum()) + 8 * int((alive & ~st["special"])
                                                .sum())
            + 8 * int((cand & (deg0 >= 2)).sum()) + 8 * W
            + W * EE + 8 * int(ea.sum())
            + 8 * W * NM + 16 * int(on.sum()) + 8 * int(kept.any(-1).sum())
            + 9 * written)
    n_out = 8 * cells + 16 * W * cleanup.SL_ITEMS + W
    o = STRINGS_OPS
    nops = (W * NI * o["item"] + int(ea.sum()) * o["edge"]
            + pos * o["position"] + cells * o["cell"])
    return {"bytes": n_in + n_out, "int_ops": nops, "W": W, "NI": NI,
            "EE": EE, "NM": NM, "K": K, "candidates": int(cand.sum()),
            "probed": int(probed.sum()), "kept_bases": pos,
            "written_cells": written}


def cleanup_case(key: str, args, kw: dict, rate: dict) -> dict:
    """One cleanup loop's kernel on a call captured from the devgraph runs
    (`key`: tip_fixpoint/tips, tip_fixpoint/links or short_link_strings):
    its outputs bit-equal to the plain version on the card (dtypes too),
    then timed beside it (CUDA events around the wrapper; the kernel's own
    device time, torch.profiler), the aten ops a call dispatches (at most
    CLEANUP_MAX_ATEN_OPS) and the card's bound (cleanup_accounting). An
    in-place call (the links tip_fixpoint) runs on a copy of its inputs:
    the check's call on the copy as captured, the timed repeats on what the
    calls before them wrote (with the gate closed, the same work; with it
    open, the links pass again on its own output)."""
    import torch

    from lancet_tpu_torch.gpu import cleanup, pipeline, stages

    name = key.split("/")[0]
    work = (_tree(args, lambda t: t.clone() if torch.is_tensor(t) else t)
            if kw.get("inplace") else args)

    def fn():
        return _walk_out(name, getattr(cleanup, name)(*work, **kw))

    def plain():
        if name == "tip_fixpoint":
            return _walk_out(name, pipeline.tip_fixpoint_plain(
                *args, **_plain_kw(kw)))
        return pipeline.short_link_stage_plain(*args, **kw)

    got = fn()
    torch.cuda.synchronize()
    rounds: dict = {}
    with _counting(stages, ("compress_round_plain",
                            "seq_removal_pass_plain"), rounds):
        want = plain()
    torch.cuda.synchronize()
    err = dtype_mismatches(got, want)
    if err:
        raise AssertionError(f"{key} disagrees with its plain version on "
                             f"{err} outputs")
    ops = aten_ops(fn)
    if ops > CLEANUP_MAX_ATEN_OPS[name]:
        raise AssertionError(f"{key} took {ops} aten ops on the card (at "
                             f"most {CLEANUP_MAX_ATEN_OPS[name]})")
    ms = spread(cuda_times(fn, *KERNEL_REPS))
    dev_ms = device_ms(fn, _CLEANUP_KERNELS[name])
    plain_ms = spread(cuda_times(plain, WALK_PLAIN_REPS))
    acc = cleanup_accounting(name, args, kw, rounds)
    bound = {"bytes": acc["bytes"] / HBM_BYTES_PER_S * 1e3,
             "operations": acc["int_ops"] / rate["int_ops_per_s"] * 1e3}
    grid = {}
    if name == "tip_fixpoint":  # its cluster and the blocks of its grid
        W, NI, EE, NM = acc["W"], acc["NI"], acc["EE"], acc["NM"]
        grid = cluster_grid(fn, _CLEANUP_KERNELS[name], W, cleanup.plan_for(
            W, NI, EE, NM, args[5], args[6], args[0]["alive"].device))
    return {"name": key, "tolerance": 0, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound": bound,
            "aten_ops_per_call": ops, "plain_aten_ops_per_call":
            aten_ops(plain), **grid, **acc}


def mesh_main_case(workdir: str, region: str, mesh, case: str, vcf: str,
                   summary: str, st_main: dict) -> dict:
    """(a) The main path with its DP groups split over `mesh`: VCF and
    summary equal to the unsharded run's, one gotoh_align launch for each
    non-empty shard of each group."""
    from lancet_tpu_torch.engine import shardrun

    sizes: list = []
    real = shardrun.mesh_batch_align_async

    def spy(pairs, m):
        sizes.append(len(pairs))
        return real(pairs, m)

    st: dict = {}
    shardrun.mesh_batch_align_async = spy
    reset_counts()
    try:
        v, summ = run_captured(workdir, region, st, device="cuda", mesh=mesh)
    finally:
        shardrun.mesh_batch_align_async = real
    launches = launch_counts()
    want = sum(min(p, len(mesh)) for p in sizes)
    got = launches["gotoh_align_smem"] + launches["gotoh_align_global"]
    emit({"phase": "mesh", "case": case, "mesh": [str(d) for d in mesh],
          "windows_per_s": st["n_windows"] / st["t_total"],
          "unsharded_windows_per_s": st_main["n_windows"]
          / st_main["t_total"],
          **{k: st[k] for k in ("t_total", "t_dp", "t_dp_send", "t_dp_wait",
                                "n_dp", "n_groups")},
          "dp_groups": sizes, "launches": launches,
          "gotoh_launches_expected": want, "vcf_equal_unsharded": v == vcf,
          "summary_equal_unsharded": summ == summary})
    if v != vcf or summ != summary:
        raise AssertionError(f"mesh {case}: VCF or summary differs from the "
                             "unsharded main path's")
    if not sizes or got != want:
        raise AssertionError(f"mesh {case}: {got} gotoh_align launches for "
                             f"groups {sizes} over {len(mesh)} shards")
    return launches


def mesh_devgraph_case(workdir: str, n: int, vcf_g: str, summary_g: str,
                       st_g: dict, sums_g: dict) -> dict:
    """(b) Device-graph case 1 with its windows over n entries of cuda:0;
    every _CHECKED walk call held against its plain version
    after the run (its inputs and outputs copied during it, so t_devgraph
    includes the copies)."""
    from lancet_tpu_torch.parallel.mesh import make_mesh

    st: dict = {}
    calls: list = []
    reset_counts()
    with instrument_devgraph(None, None, calls):
        v, summ = run_devgraph(workdir, DEVGRAPH_REGION, st,
                               mesh=make_mesh(devices=["cuda:0"] * n))
    launches = launch_counts()
    checked = check_walk_calls(calls, f"devgraph over {n} shards")
    same = {k: st[k] == st_g[k] for k in ("n_dev_windows",
                                           "dev_fallback_causes",
                                           "k_histogram")}
    emit({"phase": "mesh", "case": f"devgraph_{n}", "region":
          DEVGRAPH_REGION, "mesh": ["cuda:0"] * n,
          "t_devgraph": st["t_devgraph"],
          "unsharded_t_devgraph": st_g["t_devgraph"],
          **{k: st[k] for k in ("t_total", "t_dg_pack", "t_dg_build",
                                "t_dg_assemble", "t_dp", "n_dev_windows",
                                "n_dev_attempts", "dev_fallback_causes")},
          "mesh_counters": st["mesh_counters"], "unsharded_sums": sums_g,
          "launches": launches, "walk_calls_checked": checked,
          "stats_equal_unsharded": same,
          "vcf_equal_unsharded": v == vcf_g,
          "summary_equal_unsharded": summ == summary_g})
    if v != vcf_g or summ != summary_g or not all(same.values()):
        raise AssertionError(f"devgraph over {n} shards differs from the "
                             f"unsharded run: {same}")
    if st["mesh_counters"] != sums_g:
        raise AssertionError(f"mesh_counters {st['mesh_counters']} differ "
                             f"from the unsharded sums {sums_g}")
    for k in ("gotoh_align_smem", "repeat_gates", "path_cover",
              "almost_repeat_paths", "cycle_dfs", "cycle_screen",
              "tandem_at", _COMPRESS, *_GRAPHSTATE, *_CLEANUP, *_BUILD):
        if launches[k] < 1:
            raise AssertionError(f"devgraph over {n} shards launched no {k}")
    b = checked["build_k"]
    if not b["calls"] or b.get("sync_free") != b["calls"]:
        raise AssertionError(f"devgraph over {n} shards: build_k calls {b}")
    return launches


def _processes_left(marker: str) -> list:
    """Processes that are this one's children, or whose command line holds
    `marker` (a string unique to this checkout: another checkout's runs on
    the same machine are not this run's), with their command lines."""
    me, left = os.getpid(), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == me:
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, IndexError, ValueError):
            continue  # exited meanwhile
        if ppid == me or marker in cmd:
            left.append(f"{pid}: {cmd[:120]}")
    return left


def multihost_case(workdir: str, region: str, vcf: str, st_main: dict):
    """(c) MH_PROCESSES processes of this script on gloo run run_multihost
    on the default corpus; returns their launch counts summed."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = str(sk.getsockname()[1])
    outp = os.path.join(workdir, "multihost")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mh-worker", str(r),
         str(MH_PROCESSES), port, workdir, region, outp],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MH_PROCESSES)]
    fails = []
    try:
        for r, pr in enumerate(procs):
            try:
                _, err = pr.communicate(timeout=MH_LIMIT_S)
            except subprocess.TimeoutExpired:
                fails.append(f"rank {r}: no exit within {MH_LIMIT_S} s")
                continue
            if pr.returncode != 0:
                fails.append(f"rank {r}: rc {pr.returncode}: {err[-2000:]}")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    t_wall = time.perf_counter() - t0
    left = _processes_left(f"{os.path.abspath(__file__)} --mh-worker")
    ranks = []
    for r in range(MH_PROCESSES):
        if os.path.exists(f"{outp}.{r}.json"):
            with open(f"{outp}.{r}.json") as f:
                ranks.append(json.load(f))
    got = None
    if os.path.exists(outp + ".vcf"):
        with open(outp + ".vcf") as f:
            got = f.read()
    launches = {k: sum(rk["launches"][k] for rk in ranks)
                for k in launch_counts()}
    emit({"phase": "mesh", "case": "multihost", "processes": MH_PROCESSES,
          "backend": "gloo", "t_wall": t_wall,
          "single_process_t_total": st_main["t_total"], "ranks": ranks,
          "launches": launches, "failures": fails, "processes_left": left,
          "vcf_equal_single_process": got == vcf})
    if fails or left or got != vcf or len(ranks) != MH_PROCESSES:
        raise AssertionError(f"the fan-out over processes failed: {fails}, "
                             f"left {left}, VCF equal {got == vcf}")
    return launches


def mh_worker(argv: list) -> int:
    """One process of case (c): join the gloo group, run run_multihost on
    the default corpus on cuda:{rank % card count}, write the launch counts
    and times (and, on rank 0, the VCF) beside `outp`."""
    import torch

    from lancet_tpu_torch.config import Config
    from lancet_tpu_torch.parallel.multihost import (init_distributed,
                                                     run_multihost, shutdown)

    rank, nproc, port, workdir, region, outp = argv
    rank, nproc = int(rank), int(nproc)
    dev = f"cuda:{rank % torch.cuda.device_count()}"
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{port}", nproc, rank)
    try:
        cfg = Config(tumor_bam=os.path.join(workdir, "tumor.bam"),
                     normal_bam=os.path.join(workdir, "normal.bam"),
                     ref_fasta=os.path.join(workdir, "ref.fa"),
                     region=region, num_threads=8)
        st: dict = {}
        reset_counts()
        with contextlib.redirect_stderr(io.StringIO()):
            vcf = run_multihost(cfg, command_line="chip_smoke",
                                date="SMOKE\n", device=dev, stats=st)
        rec = {"rank": rank, "device": dev, "t_run": st["t_total"],
               "t_since_start": time.perf_counter() - t0,
               "n_windows": st["n_windows"], "launches": launch_counts()}
    finally:
        shutdown()
    if rank == 0:
        with open(outp + ".vcf", "w") as f:
            f.write(vcf)
    with open(f"{outp}.{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def gates_case_main(workdir: str, region: str, vcf: str, summary: str,
                    chunks: list):
    """(d) The main path with the eager gate sweep (LANCET_TPU_GATES=1) in
    an A/B against the main path without it, in the order GATES_AB (off
    and on alternating, each arm in the same slots on average): every VCF
    equal, repeat_gates launched in every run with the sweep; the first
    run with the sweep's repeat_gates calls are appended to `chunks`.
    Returns the launch counts of the last run with the sweep."""
    t_total = {"off": [], "on": []}
    t_gates = []
    launches_on: dict = {}
    for arm in GATES_AB:
        st: dict = {}
        if arm == "on":
            os.environ["LANCET_TPU_GATES"] = "1"
        reset_counts()
        try:
            with capture_gates(chunks if arm == "on" and not t_gates
                               else []):
                v, summ = run_captured(workdir, region, st, device="cuda")
        finally:
            os.environ.pop("LANCET_TPU_GATES", None)
        t_total[arm].append(st["t_total"])
        if arm == "on":
            launches_on = launch_counts()
            t_gates.append(st["t_gates"])
            if launches_on["repeat_gates"] < 1:
                raise AssertionError(f"LANCET_TPU_GATES=1 launched no "
                                     f"repeat_gates: {launches_on}")
        if v != vcf or summ != summary:
            raise AssertionError(f"LANCET_TPU_GATES {arm}: the VCF or "
                                 "summary differs from the main path's")
    emit({"phase": "mesh", "case": "gates_switch", "order": list(GATES_AB),
          "t_total_off": t_total["off"], "t_total_on": t_total["on"],
          "median_off": statistics.median(t_total["off"]),
          "median_on": statistics.median(t_total["on"]),
          "t_gates": t_gates, "n_windows": st["n_windows"],
          "launches": launches_on, "vcf_equal_main": True,
          "summary_equal_main": True})
    return launches_on


@contextlib.contextmanager
def replayed_windows(out: list):
    """While active: append (cause, k, window midpoint) for every window
    the device graph engine hands back to the native ladder: at an
    attempt's caps (the causes that attempt added, and its k), or before
    any attempt (k_gt_63, k None: gated at every device k; the shape
    screen would count here too, but the pinned stats hold none)."""
    from lancet_tpu_torch.engine import devicepipe

    real_run, real_cc = (devicepipe.run_device_graph,
                         devicepipe._complete_chunk)
    marked: dict = {}

    def complete(st_if, cfg, K, stats, *a, **k):
        before = dict(stats.get("dev_fallback_causes", {}))
        fresh = [t for t in st_if["chunk"] if not t.fallback]
        real_cc(st_if, cfg, K, stats, *a, **k)
        after = stats.get("dev_fallback_causes", {})
        added = "/".join(sorted(c for c in after
                                if after[c] != before.get(c, 0)))
        for t in fresh:
            if t.fallback:
                marked[id(t)] = (added, K)

    def run(tasks, *a, **k):
        real_run(tasks, *a, **k)
        for t in tasks:
            if t.fallback:
                cause, K = marked.get(id(t), ("k_gt_63", None))
                out.append((cause, K, t.refstart + len(t.rawseq) // 2))

    devicepipe.run_device_graph, devicepipe._complete_chunk = run, complete
    try:
        yield
    finally:
        devicepipe.run_device_graph = real_run
        devicepipe._complete_chunk = real_cc


def dp_parity(case: str, pairs: list) -> dict:
    """The port's counterpart of bench.py's pallas_parity_check: gotoh_align
    against dp_fill_plain + traceback_plain on the card, on the DP pairs a
    run sampled (stats["dp_samples"]); every op and count must be equal.
    Emits and returns the dp_parity line."""
    import torch

    from lancet_tpu_torch.gpu import gotoh
    from lancet_tpu_torch.gpu.align_batch import _pack

    if not pairs:
        raise AssertionError(f"dp_parity {case}: the run sampled no DP pair")
    dev = torch.device("cuda", 0)
    S, T, n_len, m_len, N, M = _pack(pairs)
    S, T, n_d, m_d = (torch.from_numpy(a).to(dev)
                      for a in (S, T, n_len, m_len))
    ops, cnt = gotoh.align(S, T, n_d, m_d, N, M)
    ops_p, cnt_p = gotoh.traceback_plain(
        gotoh.dp_fill_plain(S, T, n_d, m_d, N, M), n_d, m_d, N, M)
    P = len(pairs)
    bad = int(((ops != ops_p).reshape(P, -1).any(1)
               | (cnt != cnt_p).reshape(P, -1).any(1)).sum())
    line = {"phase": "dp_parity", "case": case, "samples": P,
            "longest_N": max(len(a) for a, _ in pairs),
            "longest_M": max(len(b) for _, b in pairs),
            "mode": gotoh.plan(N, M).mode, "tolerance": 0,
            "pairs_differing": bad, "equal": bad == 0}
    emit(line)
    if bad:
        raise AssertionError(f"dp_parity {case}: gotoh_align differs from "
                             f"its plain version on {bad} of {P} pairs")
    return line


def hard_phase(rate: dict, chase: dict) -> dict:
    """The JAX benchmark's hard corpus (corpus.hard_corpus, 1,995 windows)
    on the card: (a) the main path with device cuda and cpu, equal VCFs and
    summaries with BENCH_r05's records and KMERSIZE histogram; (b) the
    device graph engine, timed, then instrumented (every walk call and
    repeat_gates call held against its plain version, the counted
    functions' aten ops, each replayed window's cause, k and site family),
    then profiled, its VCF and summary equal to (a)'s and its stats equal
    to HARD_DEVGRAPH_STATS; each walk's largest call as a kernels line.
    Returns the launch counts and DP samples of both runs."""
    from lancet_tpu_torch import corpus

    t_phase = time.perf_counter()
    hdir = os.path.join(HERE, "build", "smoke_hard")
    os.makedirs(hdir, exist_ok=True)
    refseq, tumor, normal, region = corpus.hard_corpus()
    corpus.write_pair(hdir, refseq, "chr1", tumor, normal)
    t_corpus = time.perf_counter() - t_phase

    # (a) the main path
    st: dict = {}
    groups: list = []
    reset_counts()
    vcf, summary = run_main_path("cuda", hdir, region, st, groups)
    launches = launch_counts()
    st_cc: dict = {}
    vcf_cc, summary_cc = run_main_path("cuda", hdir, HARD_CPU_REGION, st_cc)
    st_cpu: dict = {}
    vcf_cpu, summary_cpu = run_main_path("cpu", hdir, HARD_CPU_REGION,
                                         st_cpu)
    hist = kmersizes(vcf)
    n_gotoh = sum(launches[f"gotoh_align_{m}"]
                  for m in ("smem", "global", "strips"))
    emit({"phase": "hard", "case": "main_path", "region": region,
          "t_corpus": t_corpus, "num_threads": 8,
          "windows_per_s": st["n_windows"] / st["t_total"],
          **{k: st[k] for k in ("t_total", "t_host", "t_dp", "t_dp_wait",
                                "n_windows", "n_jobs", "n_dp", "n_groups",
                                "n_fallback")},
          "cpu_region": HARD_CPU_REGION,
          "cpu_region_windows": st_cpu["n_windows"],
          "t_total_cpu": st_cpu["t_total"],
          "t_total_cuda_cpu_region": st_cc["t_total"], "launches": launches,
          "dp_groups": [len(g) for g in groups],
          "vcf_records": len(vcf_records(vcf)), "kmersize_histogram": hist,
          "max_kmersize": max(hist), "vcf_equal_cpu": vcf_cc == vcf_cpu,
          "summary_equal_cpu": summary_cc == summary_cpu})
    if vcf_cc != vcf_cpu or summary_cc != summary_cpu:
        raise AssertionError("hard: device='cuda' and device='cpu' runs "
                             "differ")
    if len(vcf_records(vcf)) != HARD_RECORDS or hist != HARD_KMERSIZE:
        raise AssertionError(f"hard: {len(vcf_records(vcf))} records, "
                             f"KMERSIZE {hist}; BENCH_r05 has "
                             f"{HARD_RECORDS}, {HARD_KMERSIZE}")
    if st["n_dp"] != HARD_DP_PAIRS or n_gotoh < 1:
        raise AssertionError(f"hard: {st['n_dp']} DP pairs, {n_gotoh} "
                             "gotoh_align launches")

    # (b) the device graph engine: timed, instrumented, profiled
    st_g: dict = {}
    split: dict = {}  # t_dg_pack's three parts
    reset_counts()
    with pack_split(split):
        vcf_g, summary_g = run_devgraph(hdir, region, st_g)
    launches_g = launch_counts()
    st_g2: dict = {}
    ops: dict = {}
    calls: list = []
    gcalls: list = []
    replays: list = []
    with instrument_devgraph(None, ops, calls), capture_gates(gcalls), \
            replayed_windows(replays):
        vcf_g2, summary_g2 = run_devgraph(hdir, region, st_g2)
    busy = profile_devgraph(hdir, region, st_g["t_total"])
    got_stats = {k: st_g[k] for k in HARD_DEVGRAPH_STATS}
    dkeys = ("t_total", "t_host", "t_unpack", "t_devgraph", "t_dg_pack",
             "t_dg_build", "t_dg_ranks", "t_dg_assemble", "t_dg_a_dispatch",
             "t_dg_a_exec", "t_dg_a_fetch", "t_dg_finish", "t_dp",
             "t_finish", "n_windows", "n_jobs", "n_dp", "n_dev_attempts")
    families: dict = {}
    replay_ks: dict = {}
    for cause, K, mid in replays:
        fam = families.setdefault(cause, {})
        fam[corpus.hard_family(mid)] = fam.get(corpus.hard_family(mid), 0) + 1
        ks = replay_ks.setdefault(cause, {})
        ks[str(K)] = ks.get(str(K), 0) + 1
    # each walk's call with the most work, and its k, before the calls go
    largest: dict = {}
    for n, args, kw, _, K in calls:
        work = _walk_work(n, args)
        key = _kept_key(n, args)
        if key not in largest or largest[key][0] < work:
            largest[key] = (work, args, kw, K)
    captured = {n: sum(1 for c in calls if c[0] == n) for n in _CHECKED}
    call_ks = {n: sorted({K for m, *_, K in calls if m == n})
               for n in _CHECKED}
    t0 = time.perf_counter()
    plain_ops: dict = {}
    inner: dict = {}  # the plain cleanups' stage calls
    checked = check_walk_calls(calls, "hard devgraph", inner, plain_ops)
    for key, val in inner.items():
        if key not in largest or largest[key][0] < val[0]:
            largest[key] = val
    gdev = check_gate_calls(gcalls, "hard devgraph", rate)
    t_checks = time.perf_counter() - t0
    emit({"phase": "gates", "case": "hard_devgraph_calls",
          "ks": [c[1] for c in gcalls], **gdev})
    emit({"phase": "hard", "case": "devgraph", "region": region,
          "num_threads": 8, "windows_per_s": st_g["n_windows"]
          / st_g["t_total"], **{k: st_g[k] for k in dkeys}, **got_stats,
          "t_dg_pack_split": split,
          "launches": launches_g, "walk_calls_checked": checked,
          "walk_calls_captured": captured, "walk_call_ks": call_ks,
          "gate_calls_captured": len(gcalls),
          "gate_calls_checked": gdev["calls"],
          "t_checks": t_checks, "torch_op_functions": ops,
          "plain_cleanup_op_functions": plain_ops,
          "replayed_families": families, "replayed_ks": replay_ks,
          "instrumented_t_total": st_g2["t_total"], "device_busy": busy,
          "max_kmersize": max(kmersizes(vcf_g)),
          "vcf_equal_native": vcf_g == vcf,
          "summary_equal_native": summary_g == summary,
          "stats_equal_pinned": got_stats == HARD_DEVGRAPH_STATS})
    if (vcf_g != vcf or summary_g != summary or vcf_g2 != vcf
            or summary_g2 != summary):
        raise AssertionError("hard: the device graph engine's VCF or "
                             "summary differs from the native main path's")
    if got_stats != HARD_DEVGRAPH_STATS:
        raise AssertionError(f"hard: device-graph stats {got_stats} differ "
                             f"from {HARD_DEVGRAPH_STATS}")
    for k in ("gotoh_align_smem", "repeat_gates", *_DEVGRAPH_KERNELS):
        if launches_g[k] < 1:
            raise AssertionError(f"hard: the devgraph run launched no {k}")
    check_screen_ops(ops, "hard devgraph", _SCREENS)
    check_compress_ops(ops, "hard devgraph")
    check_graphstate_ops(ops, "hard devgraph")
    check_build_ops(ops, "hard devgraph")
    b = checked["build_k"]
    if not b["calls"] or b.get("sync_free") != b["calls"]:
        raise AssertionError(f"hard: build_k calls {b}")
    walks_h = {}
    for name in _WALKS:
        _, args, kw, K = largest[name]
        walks_h[name] = walk_case(name, args, kw, rate, chase)
        emit({"phase": "kernels", "case": f"hard_{_WALKS[name]}", "K": K,
              "launches": launches_g[_WALKS[name]], **walks_h[name]})
    for name in _SCREENS:
        _, args, kw, K = largest[name]
        walks_h[name] = screen_case(name, args, kw, rate, chase)
        emit({"phase": "kernels", "case": f"hard_{name}", "K": K,
              "launches": launches_g[name], **walks_h[name]})
    for key in sorted(k for k in largest if k.startswith(_COMPRESS)):
        _, args, kw, K = largest[key]
        walks_h[key] = compress_case(args, kw, rate, chase)
        emit({"phase": "kernels", "case": f"hard_{key}", "K": K,
              "launches": launches_g[_COMPRESS], **walks_h[key]})
    for name in _GRAPHSTATE:
        _, args, kw, K = largest[name]
        walks_h[name] = {**graphstate_case(name, args, kw, rate), "K": K}
        emit({"phase": "kernels", "case": f"hard_{name}", "K": K,
              "launches": launches_g[name], **walks_h[name]})
    for key in ("tip_fixpoint/tips", "tip_fixpoint/links",
                "short_link_strings"):
        _, args, kw, K = largest[key]
        walks_h[key] = {**cleanup_case(key, args, kw, rate), "K": K}
        emit({"phase": "kernels", "case": f"hard_{key}", "K": K,
              "launches": launches_g[key.split("/")[0]], **walks_h[key]})
    _, bargs, bkw, K = largest["build_k"]
    bres = build_case(bargs, bkw, rate)
    for name in _BUILD:
        walks_h[name] = bres[name]
        emit({"phase": "kernels", "case": f"hard_{name}", "K": K,
              "launches": launches_g[name], **bres[name]})
    emit({"phase": "hard", "case": "done",
          "t_phase": time.perf_counter() - t_phase})
    return {"launches_main": launches, "launches_devgraph": launches_g,
            "dp_samples_main": st.get("dp_samples", []),
            "dp_samples_devgraph": st_g.get("dp_samples", []),
            "walks": walks_h, "gates_max_abs_err": gdev["max_abs_err"]}


def lr_phase(rate: dict) -> dict:
    """The JAX benchmark's linked-reads corpus (corpus.lr_corpus, 595
    windows, lr_mode) on the card: (a) the main path with device cuda and
    cpu; (b) with LANCET_TPU_DEVGRAPH=1, which the runner sends to the
    native path (no walk kernel launches); (c) the two-phase process pool,
    the native runner off, every repeat_gates call held against
    gates_plain. Every VCF equal, LR_RECORDS records. Returns the launch
    counts of (a), (b) and (c)."""
    from lancet_tpu_torch import corpus

    t_phase = time.perf_counter()
    ldir = os.path.join(HERE, "build", "smoke_lr")
    os.makedirs(ldir, exist_ok=True)
    refseq, tumor, normal, region = corpus.lr_corpus()
    corpus.write_pair(ldir, refseq, "chr1", tumor, normal)
    st: dict = {}
    reset_counts()
    vcf, summary = run_main_path("cuda", ldir, region, st, lr_mode=True)
    launches = launch_counts()
    st_cpu: dict = {}
    vcf_cpu, summary_cpu = run_main_path("cpu", ldir, region, st_cpu,
                                         lr_mode=True)
    st_d: dict = {}
    reset_counts()
    vcf_d, summary_d = run_devgraph(ldir, region, st_d, lr_mode=True)
    launches_d = launch_counts()
    st_e: dict = {}
    gcalls: list = []
    reset_counts()
    with capture_gates(gcalls):
        vcf_e, summary_e = run_engine_path(ldir, region, st_e, lr_mode=True)
    launches_e = launch_counts()
    stop_pool_servers()
    gates = check_gate_calls(gcalls, "lr two-phase", rate)
    emit({"phase": "gates", "case": "lr_two_phase_calls", **gates})
    walks_d = {k: launches_d[k] for k in _WALKS.values()}
    emit({"phase": "lr", "region": region, "num_threads": 8,
          "windows_per_s": st["n_windows"] / st["t_total"],
          **{k: st[k] for k in ("t_total", "n_windows", "n_jobs", "n_dp")},
          "t_total_cpu": st_cpu["t_total"], "launches": launches,
          "vcf_records": len(vcf_records(vcf)),
          "kmersize_histogram": kmersizes(vcf),
          "vcf_equal_cpu": vcf == vcf_cpu,
          "summary_equal_cpu": summary == summary_cpu,
          "devgraph_env": {"t_total": st_d["t_total"],
                           "walk_launches": walks_d,
                           "vcf_equal": vcf_d == vcf,
                           "summary_equal": summary_d == summary},
          "two_phase": {"windows_per_s": st_e["n_windows"]
                        / st_e["t_total"],
                        **{k: st_e[k] for k in ("t_total", "t_gates",
                                                "t_host", "t_dp",
                                                "t_finish")},
                        "n_dead_workers": st_e.get("n_dead_workers", 0),
                        "launches": launches_e, "vcf_equal": vcf_e == vcf,
                        "summary_equal": summary_e == summary},
          "t_phase": time.perf_counter() - t_phase})
    if vcf != vcf_cpu or summary != summary_cpu:
        raise AssertionError("lr: device='cuda' and device='cpu' runs "
                             "differ")
    if len(vcf_records(vcf)) != LR_RECORDS:
        raise AssertionError(f"lr: {len(vcf_records(vcf))} records, "
                             f"{LR_RECORDS} expected")
    if vcf_d != vcf or any(walks_d.values()):
        raise AssertionError(f"lr with LANCET_TPU_DEVGRAPH=1: VCF equal "
                             f"{vcf_d == vcf}, walk launches {walks_d}")
    if vcf_e != vcf or summary_e != summary or st_e.get("n_dead_workers"):
        raise AssertionError("lr: the two-phase path's VCF or summary "
                             "differs, or a worker died")
    if launches_e["repeat_gates"] < 1:
        raise AssertionError(f"lr: the two-phase path launched "
                             f"{launches_e}")
    return {"main": launches, "devgraph_env": launches_d,
            "two_phase": launches_e, "gates_max_abs_err": gates["max_abs_err"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "lancet_tpu_torch")):
        print("lancet_tpu_torch/ is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--mh-worker"]:
        return mh_worker(sys.argv[2:])
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build, and the SASS counts the bounds are held against
    secs, libs, ptxas = build_all()
    so = os.path.join(HERE, libs["gotoh_cu"])
    sass, why = sass_loop_counts(so)
    gsass, gwhy = sass_gate_counts(os.path.join(HERE, libs["repeats_cu"]))
    clock_hz, clock_txt = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per = {}
    for key, c in (sass or {}).items():
        per[key] = {"fill_ops_per_cell": min(FILL_OPS_PER_CELL,
                                             c["fill_per_cell"]["arith"]),
                    "trace_ops_per_step": min(TRACE_OPS_PER_STEP,
                                              c["trace_per_step"]["arith"])}
    rate = {"int_ops_per_s": sms * ISSUE_LANES_PER_SM_CLK * clock_hz,
            "sms": sms, "sm_clock_max": clock_txt,
            "hand_fill_ops_per_cell": FILL_OPS_PER_CELL,
            "hand_trace_ops_per_step": TRACE_OPS_PER_STEP,
            "per_instantiation": per,
            "gate_ops_per_step": GATE_OPS_PER_STEP,
            "hand_gate_ops_per_word": GATE_OPS_PER_WORD,
            "gate_ops_per_word": min(GATE_OPS_PER_WORD,
                                     gsass["W5"]["bytes"]["arith"])
            if gsass else None,
            "gate_ops_per_plane_word": min(GATE_OPS_PER_PLANE_WORD,
                                          gsass["W5"]["planes"]["arith"])
            if gsass else None, "gate_ops_per_test": GATE_OPS_PER_TEST}
    emit({"phase": "build", "seconds": secs, "libraries": libs,
          "ptxas": ptxas, "dpx_headers": dpx_headers(),
          "sass": sass if sass is not None else {"not_measured": why},
          "sass_gates": gsass if gsass is not None
          else {"not_measured": gwhy},
          "bound_rate": rate})
    if sass is None or gsass is None:
        raise RuntimeError(f"SASS counts missing: {why or gwhy}")

    from lancet_tpu_torch import corpus
    from lancet_tpu_torch.config import Config

    workdir = os.path.join(HERE, "build", "smoke_corpus")
    t0 = time.perf_counter()
    region = corpus.write_default_corpus(workdir)
    t_corpus = time.perf_counter() - t0

    # 3. the repeat-gate kernel against its plain version: every window of
    # the default corpus (the two-phase path's call), the adversarial
    # windows, then the crafted cases of gpu/gatecases.py, each also at the
    # GATE_FORCED launches
    from lancet_tpu_torch.gpu import gatecases

    cfg0 = Config()
    ks = list(range(cfg0.min_k, cfg0.max_k + 1, 2))
    gres = gates_case(default_windows(workdir, region), ks,
                      cfg0.max_mismatch, rate, timed=True)
    emit({"phase": "gates", "case": "default_corpus", **gres})
    adv = corpus.repeat_windows() + ["", "A", "AA", "ACGT"]
    n_adv = 0
    for kl in (ks, GATE_ODD_KS):
        for mm in GATE_MISMATCHES:
            r = gates_case(adv, kl, mm, rate, timed=False)
            n_adv += 1
            gres["max_abs_err"] = max(gres["max_abs_err"], r["max_abs_err"])
    emit({"phase": "gates", "case": "adversarial", "W": len(adv),
          "cases": n_adv, "ks_lists": [ks, GATE_ODD_KS],
          "max_mismatch": list(GATE_MISMATCHES), "tolerance": 0,
          "max_abs_err": gres["max_abs_err"]})
    gcrafted = {}
    for name, c in gatecases.gate_cases().items():
        r = gates_case(c["windows"], c["ks"], c["mm"], rate, timed=False,
                       forced=GATE_FORCED)
        gcrafted[name] = {k: r[k] for k in ("W", "L", "nk", "max_mismatch",
                                            "plan", "forced_plans",
                                            "max_abs_err")}
        gres["max_abs_err"] = max(gres["max_abs_err"], r["max_abs_err"])
    emit({"phase": "gates", "case": "crafted", "tolerance": 0,
          "forced": GATE_FORCED, "cases": gcrafted})

    # 4. main path on the default corpus
    st: dict = {}
    groups: list = []
    reset_counts()
    vcf, summary = run_main_path("cuda", workdir, region, st, groups)
    launches = launch_counts()
    st_cc: dict = {}
    vcf_cc, summary_cc = run_main_path("cuda", workdir, CPU_COMPARE_REGION,
                                       st_cc)
    st_cpu: dict = {}
    vcf_cpu, summary_cpu = run_main_path("cpu", workdir, CPU_COMPARE_REGION,
                                         st_cpu)
    n_rec = len(vcf_records(vcf))
    keys = ("t_total", "t_pipeline", "t_host", "t_dp", "t_dp_prep",
            "t_dp_send", "t_dp_wait", "t_finish", "t_render", "n_windows",
            "n_jobs", "n_dp", "n_groups", "n_fallback")
    lens = sorted(len(x) for g in groups for pr in g for x in pr)
    emit({"phase": "main_path", "t_corpus": t_corpus,
          "windows_per_s": st["n_windows"] / st["t_total"],
          **{k: st[k] for k in keys}, "launches": launches,
          "dp_groups": [len(g) for g in groups],
          "dp_lengths": {"min": lens[0], "median": lens[len(lens) // 2],
                         "max": lens[-1]} if lens else None,
          "native_stages": {k: st[k] for k in sorted(st)
                            if k.startswith("t_c_")},
          "vcf_records": n_rec,
          "cpu_dp": {"region": CPU_COMPARE_REGION,
                     "n_windows": st_cpu["n_windows"],
                     "windows_per_s": st_cpu["n_windows"]
                     / st_cpu["t_total"],
                     "cuda_t_total": st_cc["t_total"],
                     "vcf_records": len(vcf_records(vcf_cc)),
                     **{k: st_cpu[k] for k in ("t_total", "t_dp",
                                               "t_dp_wait")}},
          "vcf_equal_cpu": vcf_cc == vcf_cpu,
          "summary_equal_cpu": summary_cc == summary_cpu})
    if vcf_cc != vcf_cpu or summary_cc != summary_cpu:
        raise AssertionError("device='cuda' and device='cpu' runs differ")
    if n_rec == 0 or st["n_dp"] == 0:
        raise AssertionError(f"main path produced {n_rec} records from "
                             f"{st['n_dp']} DP pairs")
    if launches["gotoh_align_smem"] != len(groups) or launches[
            "gotoh_align_global"] + launches["gotoh_align_strips"] != 0:
        raise AssertionError(f"gotoh_align launches {launches} on the main "
                             f"path for {len(groups)} DP groups (one "
                             "shared-memory launch each expected)")

    # 4b. the main path at --window-size 9,000: a region of the default
    # corpus (its reads come in 2 kb segments, so no DP pair there passes
    # 2 kb, whatever the window size), then the long-window corpus, whose
    # DP pairs pass 8,192 bases and take gotoh_align's strip mode
    from lancet_tpu_torch.gpu import gotoh

    longdir = os.path.join(HERE, "build", "smoke_long")
    os.makedirs(longdir, exist_ok=True)
    refseq_l, tumor_l, normal_l, long_region = corpus.long_window_corpus()
    corpus.write_pair(longdir, refseq_l, "chr1", tumor_l, normal_l)
    long_default = long_window_case("default_region", workdir,
                                    LONG_DEFAULT_REGION)
    long_corpus = long_window_case("long_corpus", longdir, long_region)
    if (long_corpus["largest_N"] <= gotoh.STRIP_ROWS
            or long_corpus["launches"]["gotoh_align_strips"] < 1):
        raise AssertionError(f"the long-window corpus's largest N "
                             f"{long_corpus['largest_N']} took no strip "
                             f"launch: {long_corpus['launches']}")

    # 5. the two-phase process pool on the same corpus
    st_e: dict = {}
    reset_counts()
    vcf_e, summary_e = run_engine_path(workdir, region, st_e)
    launches_e = launch_counts()
    stop_pool_servers()
    ekeys = ("t_total", "t_gates", "t_host", "t_dp", "t_finish", "t_render",
             "n_windows", "n_jobs", "n_dp")
    emit({"phase": "engine_path", "num_threads": 8,
          "windows_per_s": st_e["n_windows"] / st_e["t_total"],
          **{k: st_e[k] for k in ekeys},
          "n_dead_workers": st_e.get("n_dead_workers", 0),
          "launches": launches_e, "vcf_equal_main": vcf_e == vcf,
          "summary_equal_main": summary_e == summary})
    if vcf_e != vcf or summary_e != summary:
        raise AssertionError("the two-phase path's VCF or summary differs "
                             "from the main path's")
    if st_e.get("n_dead_workers", 0):
        raise AssertionError(f"{st_e['n_dead_workers']} workers died")
    if launches_e["repeat_gates"] < 1 or launches_e[
            "gotoh_align_smem"] + launches_e["gotoh_align_global"] < 1:
        raise AssertionError(f"the two-phase path launched {launches_e}")

    # 6. native fallback windows replayed on the per-window engine
    st_u: dict = {}
    reset_counts()
    vcf_u, summary_u = run_captured(workdir, FALLBACK_REGION, st_u,
                                    device="cuda")
    launches_u = launch_counts()
    st_f: dict = {}
    forced: list = []
    reset_counts()
    vcf_f, summary_f = run_forced_fallback(workdir, FALLBACK_REGION, st_f,
                                           forced)
    launches_f = launch_counts()
    warn = ("WARNING: 2 windows replayed on the python engine (native "
            "shard runner fallback)\n")
    replay = {k: launches_f[k] - launches_u[k] for k in launches_f}
    emit({"phase": "fallback", "region": FALLBACK_REGION,
          "n_windows": st_f["n_windows"], "forced": forced,
          "n_fallback": st_f["n_fallback"], "launches_unforced": launches_u,
          "launches_forced": launches_f, "replay_launches": replay,
          "t_total": st_f["t_total"], "vcf_equal_unforced": vcf_f == vcf_u,
          "summary_equal_unforced": summary_f == warn + summary_u})
    if (st_f["n_fallback"] != 2 or vcf_f != vcf_u
            or summary_f != warn + summary_u):
        raise AssertionError("the forced fallback run differs from the "
                             "unforced run")
    if replay["gotoh_align_smem"] + replay["gotoh_align_global"] < 1:
        raise AssertionError(f"the replay launched no DP: {replay}")

    # 7. the device graph engine: case 1, the JAX bench's device-graph
    # region, twice (the first run timed, the second keeping the walks'
    # inputs), against the native main path on that region and the JAX
    # package's stats; case 2, the adversarial windows with tandem
    # duplications, whose cycles reach the exact cycle replay
    st_n: dict = {}
    vcf_n, summary_n = run_main_path("cuda", workdir, DEVGRAPH_REGION, st_n)
    st_g: dict = {}
    split_g: dict = {}  # t_dg_pack's three parts
    reset_counts()
    with pack_split(split_g):
        vcf_g, summary_g = run_devgraph(workdir, DEVGRAPH_REGION, st_g)
    launches_g = launch_counts()
    kept: dict = {}
    st_g2: dict = {}
    sums_g: dict = {}  # the attempt outputs' counters, for phase mesh
    calls: list = []
    gcalls: list = []  # repeat_gates calls of devgraph cases 1 and 2
    ops_g: dict = {}
    with instrument_devgraph(kept, ops_g, calls), sum_attempts(sums_g), \
            capture_gates(gcalls):
        vcf_g2, _ = run_devgraph(workdir, DEVGRAPH_REGION, st_g2)
    largest_g: dict = {}  # the plain cleanups' stage calls
    plain_ops_g: dict = {}
    checked_g = check_walk_calls(calls, "devgraph case 1", largest_g,
                                 plain_ops_g)
    busy = profile_devgraph(workdir, DEVGRAPH_REGION, st_g["t_total"])
    got_stats = {k: st_g[k] for k in DEVGRAPH_STATS}
    dkeys = ("t_total", "t_pipeline", "t_host", "t_unpack", "t_devgraph",
             "t_dg_pack", "t_dg_build", "t_dg_ranks", "t_dg_assemble",
             "t_dg_a_dispatch", "t_dg_a_exec", "t_dg_a_fetch", "t_dg_finish",
             "t_dp", "t_finish", "t_render", "n_windows", "n_jobs", "n_dp",
             "n_dev_attempts")
    emit({"phase": "devgraph", "case": "bench_region",
          "region": DEVGRAPH_REGION, "num_threads": 8,
          "windows_per_s": st_g["n_windows"] / st_g["t_total"],
          **{k: st_g[k] for k in dkeys}, **got_stats,
          "t_dg_pack_split": split_g,
          "launches": launches_g, "walk_calls_checked": checked_g,
          "torch_op_functions": ops_g,
          "second_run_t_total": st_g2["t_total"], "device_busy": busy,
          "native_main_path": {"windows_per_s": st_n["n_windows"]
                               / st_n["t_total"], "t_total": st_n["t_total"]},
          "vcf_records": len(vcf_records(vcf_g)),
          "vcf_equal_native": vcf_g == vcf_n,
          "summary_equal_native": summary_g == summary_n,
          "stats_equal_jax": got_stats == DEVGRAPH_STATS})
    if vcf_g != vcf_n or summary_g != summary_n or vcf_g2 != vcf_g:
        raise AssertionError("the device graph engine's VCF or summary "
                             "differs from the native main path's")
    if got_stats != DEVGRAPH_STATS:
        raise AssertionError(f"device-graph stats {got_stats} differ from "
                             f"the JAX package's {DEVGRAPH_STATS}")
    for k in ("gotoh_align_smem", "repeat_gates"):
        if launches_g[k] < 1:
            raise AssertionError(f"the devgraph path launched no {k}")

    advdir = os.path.join(HERE, "build", "smoke_adversarial")
    os.makedirs(advdir, exist_ok=True)
    refseq, tumor, normal, adv_region = corpus.adversarial_corpus()
    corpus.write_pair(advdir, refseq, "chr1", tumor, normal)
    st_an: dict = {}
    vcf_an, summary_an = run_main_path("cuda", advdir, adv_region, st_an)
    st_a: dict = {}
    ops: dict = {}
    reset_counts()
    with instrument_devgraph(kept, ops, calls), capture_gates(gcalls):
        vcf_a, summary_a = run_devgraph(advdir, adv_region, st_a,
                                        num_threads=2)
    launches_a = launch_counts()
    plain_ops_a: dict = {}
    checked_a = check_walk_calls(calls, "devgraph case 2", largest_g,
                                 plain_ops_a)
    # each stage's largest call of the plain cleanups, beside the run's
    # own (the removal pass's K2 runs on the card path inside tip_fixpoint
    # only: its calls are the plain cleanups')
    for key, (work, args, kw, _) in largest_g.items():
        if key not in kept or kept[key][0] < work:
            kept[key] = (work, args, kw)
    gdev = check_gate_calls(gcalls, "devgraph cases 1 and 2", rate)
    emit({"phase": "gates", "case": "devgraph_calls", **gdev})
    gres["max_abs_err"] = max(gres["max_abs_err"], gdev["max_abs_err"])
    emit({"phase": "devgraph", "case": "adversarial", "region": adv_region,
          "itd_events": list(corpus.ITD_EVENTS), "num_threads": 2,
          **{k: st_a[k] for k in ("t_total", "n_windows", "n_dev_windows",
                                  "n_dev_fallback", "dev_fallback_causes",
                                  "k_histogram")},
          "launches": launches_a, "walk_calls_checked": checked_a,
          "torch_op_functions": ops,
          "cycle_dfs_flagged_components": kept.get("cycle_dfs", (0,))[0],
          "vcf_equal_native": vcf_a == vcf_an,
          "summary_equal_native": summary_a == summary_an})
    if vcf_a != vcf_an or summary_a != summary_an:
        raise AssertionError("the device graph engine's adversarial VCF "
                             "differs from the native main path's")
    # the removal pass's aten ops on the card, in case 2's plain cleanups
    rops = plain_ops_a.get("_seq_removal_pass", {"calls": 0, "aten_ops": 0})
    if not rops["calls"] or rops["aten_ops"] > (REMOVAL_MAX_ATEN_OPS
                                                * rops["calls"]):
        raise AssertionError(f"the removal pass took {rops} aten ops on the "
                             f"card (at most {REMOVAL_MAX_ATEN_OPS} a call)")
    walk_launches = {k: launches_g[k] + launches_a[k]
                     for k in (*_WALKS.values(), *_SCREENS, _COMPRESS,
                               *_GRAPHSTATE, *_CLEANUP, *_BUILD)}
    if (min(walk_launches[k] for k in _DEVGRAPH_KERNELS) < 1
            or kept["cycle_dfs"][0] < 1):
        raise AssertionError(f"a walk or screen kernel did not launch, or "
                             f"no component reached the cycle replay: "
                             f"{walk_launches}")
    check_screen_ops(ops_g, "devgraph case 1", ("cycle_screen",))
    check_screen_ops(ops, "devgraph case 2", _SCREENS)
    check_compress_ops(ops_g, "devgraph case 1")
    check_compress_ops(ops, "devgraph case 2")
    check_graphstate_ops(ops_g, "devgraph case 1")
    check_graphstate_ops(ops, "devgraph case 2")
    check_build_ops(ops_g, "devgraph case 1")
    check_build_ops(ops, "devgraph case 2")
    for c, checked in (("case_1", checked_g), ("case_2", checked_a)):
        b = checked["build_k"]
        if not b["calls"] or b.get("sync_free") != b["calls"]:
            raise AssertionError(f"devgraph {c}: build_k calls {b}")
    chase = smem_latency_ns()
    emit({"phase": "kernels", "case": "smem_latency", **chase})
    wres = {}
    for name in _WALKS:
        _, args, kw = kept[name]
        wres[name] = walk_case(name, args, kw, rate, chase)
        emit({"phase": "kernels", "case": f"devgraph_{_WALKS[name]}",
              **wres[name]})
    for name in _SCREENS:
        _, args, kw = kept[name]
        wres[name] = screen_case(name, args, kw, rate, chase)
        emit({"phase": "kernels", "case": f"devgraph_{name}", **wres[name]})
    for key in sorted(k for k in kept if k.startswith(_COMPRESS)):
        _, args, kw = kept[key]
        wres[key] = compress_case(args, kw, rate, chase)
        emit({"phase": "kernels", "case": f"devgraph_{key}", **wres[key]})
    for name in _GRAPHSTATE:
        _, args, kw = kept[name]
        wres[name] = graphstate_case(name, args, kw, rate)
        emit({"phase": "kernels", "case": f"devgraph_{name}",
              "launches": walk_launches[name], **wres[name]})
    for key in ("tip_fixpoint/tips", "tip_fixpoint/links",
                "short_link_strings"):
        _, args, kw = kept[key]
        wres[key] = cleanup_case(key, args, kw, rate)
        emit({"phase": "kernels", "case": f"devgraph_{key}",
              "launches": walk_launches[key.split("/")[0]], **wres[key]})
    _, bargs, bkw = kept["build_k"]
    bres = build_case(bargs, bkw, rate)
    for name in _BUILD:
        emit({"phase": "kernels", "case": f"devgraph_{name}",
              "launches": walk_launches[name], **bres[name]})
    emit({"phase": "devgraph", "case": "build",
          "calls": {"case_1": checked_g["build_k"],
                    "case_2": checked_a["build_k"]},
          "aten_ops_card": {"case_1": ops_g.get("build_k"),
                            "case_2": ops.get("build_k")},
          "max_aten_ops": BUILD_MAX_ATEN_OPS,
          "launches_per_call": build_launches(bargs, bkw),
          "largest": {k: bres["window_sort"][k]
                      for k in ("K", "W", "R", "L", "N", "E", "I")}})
    emit({"phase": "devgraph", "case": "cleanup",
          "calls": {"case_1": checked_g["cleanup"],
                    "case_2": checked_a["cleanup"]},
          "aten_ops_card": {"case_1": ops_g.get("cleanup"),
                            "case_2": ops.get("cleanup")},
          "aten_ops_plain": {"case_1": plain_ops_g, "case_2": plain_ops_a},
          "launches_per_call": CLEANUP_LAUNCHES})

    # 7b. the JAX benchmark's hard corpus: the main path and the device
    # graph engine, whose k ladder climbs past 63; 7c. its linked-reads
    # corpus on the main, device-graph-set and two-phase paths; 7d. the DP
    # parity check on the DP pairs the main path and the hard corpus's runs
    # sampled
    hard = hard_phase(rate, chase)
    lr = lr_phase(rate)
    gres["max_abs_err"] = max(gres["max_abs_err"], hard["gates_max_abs_err"],
                              lr["gates_max_abs_err"])
    parity = [dp_parity("default_main_path", st.get("dp_samples", [])),
              dp_parity("hard_main_path", hard["dp_samples_main"]),
              dp_parity("hard_devgraph", hard["dp_samples_devgraph"])]

    # 8. the mesh: (a) the main path over every card and over 4 entries of
    # cuda:0 (and over 2 cards where there are two); (b) device-graph case
    # 1 over 1, 2 and 4 entries of cuda:0; (c) two processes on gloo; (d)
    # the main path with the eager gate sweep
    from lancet_tpu_torch.parallel.mesh import make_mesh

    mesh_cases = [("all_cards", make_mesh()),
                  (f"cuda0_x{MESH_ON_ONE_CARD}",
                   make_mesh(devices=["cuda:0"] * MESH_ON_ONE_CARD))]
    if count > 1:
        mesh_cases.append(("two_cards", make_mesh(2)))
    launches_m = [mesh_main_case(workdir, region, m, c, vcf, summary, st)
                  for c, m in mesh_cases]
    launches_m += [mesh_devgraph_case(workdir, n, vcf_g, summary_g, st_g,
                                      sums_g) for n in DEVGRAPH_MESHES]
    launches_mh = multihost_case(workdir, region, vcf, st)
    gsweep: list = []  # the eager sweep's chunks, from its first run
    launches_d = gates_case_main(workdir, region, vcf, summary, gsweep)
    gsw = check_gate_calls(gsweep, "the eager gate sweep", rate)
    emit({"phase": "gates", "case": "sweep_chunks", **gsw})
    gres["max_abs_err"] = max(gres["max_abs_err"], gsw["max_abs_err"])
    emit({"phase": "mesh", "case": "summary", "cards": count,
          "cases_run": [c for c, _ in mesh_cases]
          + [f"devgraph_{n}" for n in DEVGRAPH_MESHES]
          + ["multihost", "gates_switch"]})

    # 9. Gotoh kernel parity and times: each DP group of the main path,
    # the tie-heavy pairs, and one group that takes the global mode
    kres = []
    for g, pairs in enumerate(groups):
        kres.append(kernel_phase(pairs, rate))
        emit({"phase": "kernels", "case": f"main_path_group_{g}",
              **kres[-1]})
    ties = kernel_phase(TIE_PAIRS, rate)
    emit({"phase": "kernels", "case": "repeats_ties", **ties})
    large = kernel_phase(large_group(), rate)
    emit({"phase": "kernels", "case": "large_global", **large})
    if large["mode"] != "global":
        raise AssertionError(f"the large group took mode {large['mode']}")
    long_ref = kernel_phase(long_pairs(), rate, LONG_PLAIN_REPS)
    emit({"phase": "kernels", "case": "long_ref", **long_ref})
    if long_ref["mode"] != "strips":
        raise AssertionError(f"long_ref took mode {long_ref['mode']}")

    # the four walks on the crafted cases: each staging mode, K3's edges,
    # the removal pass's corners
    from lancet_tpu_torch.gpu import walkcases, walks

    crafted = {}
    for name, c in walkcases.cycle_cases().items():
        got = walkcases.run_cycle(c, "cuda")
        want = walkcases.run_cycle(c)
        crafted[f"cycle_dfs/{name}"] = {
            "mode": walks.cycle_dfs_plan(c["NI"], c["D2"],
                                         c["e_src"].shape[1],
                                         c["Cmax"]).mode,
            "mismatches": sum(int((g.cpu() != w).sum())
                              for g, w in zip(got, want))}
    for name, c in walkcases.path_cover_cases().items():
        got = walkcases.run_cover(c, "cuda")
        want = walkcases.run_cover(c)
        cp = c["caps"]
        crafted[f"path_cover/{name}"] = {
            "mode": walks.path_cover_plan(c["NI"], cp["D2"],
                                          c["st"]["e_src"].shape[1],
                                          cp["Q"], cp["PN"]).mode,
            "mismatches": sum(int((got[k].cpu() != want[k]).sum())
                              for k in want)}
    for name, c in walkcases.almost_repeat_cases().items():
        got = walkcases.run_almost_repeat(c, "cuda")
        want = walkcases.run_almost_repeat(c)
        pl = walks.almost_repeat_plan(c["seq"].shape[2], c["K"])
        crafted[f"almost_repeat_paths/{name}"] = {
            "plan": pl._asdict(),
            "mismatches": int((got.cpu() != want).sum())}
    for name, c in walkcases.removal_cases().items():
        before = walks.LAUNCHES["seq_removal"]
        got = walkcases.run_removal(c, "cuda")
        launched = walks.LAUNCHES["seq_removal"] - before
        want = walkcases.run_removal(c)
        W, NI = c["st"]["alive"].shape
        crafted[f"seq_removal/{name}"] = {
            "W": W, "NI": NI, "EE": c["st"]["e_src"].shape[1],
            "U": c["U"], "D2": c["D2"], "mode": c["mode"],
            "launches": launched, "mismatches": _mismatches(got, want)
            + int(launched != 1)}
    # the screens on the crafted and seeded batches of gpu/screencases.py
    from lancet_tpu_torch.gpu import screencases

    seqs, lens, _ = screencases.tandem_batch()
    crafted_screens = {n: 0 for n in _SCREENS}
    for params in screencases.TANDEM_PARAMS:
        got = screencases.run_tandem(seqs, lens, "cuda", params)
        want = screencases.run_tandem(seqs, lens, "cpu", params)
        bad = int((got.cpu() != want).sum())
        crafted[f"tandem_at/pos{params[0]}_mu{params[1]}"] = {
            "B": len(lens), "mismatches": bad}
        crafted_screens["tandem_at"] = max(crafted_screens["tandem_at"], bad)
    arrs, _, sN, sNI, sC = screencases.screen_batch()
    for T in screencases.SCREEN_ROUNDS:
        got = screencases.run_screen(arrs, sN, sNI, sC, "cuda", T)
        want = screencases.run_screen(arrs, sN, sNI, sC, "cpu", T)
        bad = int((got.cpu() != want).sum())
        crafted[f"cycle_screen/T{T}"] = {"W": arrs["alive"].shape[0],
                                         "mismatches": bad}
        crafted_screens["cycle_screen"] = max(crafted_screens["cycle_screen"],
                                              bad)
    # compress_round on the batches of gpu/compresscases.py
    from lancet_tpu_torch.gpu import compress, compresscases

    crafted_compress = 0
    for name, arrs, K in compresscases.batches():
        before = compress.LAUNCHES[_COMPRESS]
        got = compresscases.run(arrs, K, "cuda")
        launched = compress.LAUNCHES[_COMPRESS] - before
        want = compresscases.run(arrs, K)
        bad = dtype_mismatches(
            ({k: got[0][k] for k in compress.OUTPUT_KEYS}, got[1]),
            ({k: want[0][k] for k in compress.OUTPUT_KEYS}, want[1]))
        # and at each cluster size the plan takes where it is forced to
        st = compresscases.to_torch(arrs, "cuda")
        W = arrs["alive"].shape[0]
        NI, EE, NM = compresscases.shape_of(arrs)
        by_c = {}
        for C in compress.CLUSTER_SIZES:
            forced = {c: W if c == C else 0 for c in compress.CLUSTER_SIZES}
            ran = compress.compress_plan(W, NI, EE, NM, forced).C
            outs, fb = compress._launch(st, K, NI, NI - 2 * compresscases.CMAX,
                                        64, clusters=forced)
            by_c[ran] = dtype_mismatches(
                (dict(zip(compress.OUTPUT_KEYS, outs)), fb),
                ({k: want[0][k] for k in compress.OUTPUT_KEYS}, want[1]))
        crafted[f"compress_round/{name}"] = {
            "W": W, "shape": [NI, EE, NM], "launches": launched,
            "mismatches_by_cluster": by_c,
            "mismatches": bad + int(launched != 1) + sum(by_c.values())}
        crafted_compress = max(crafted_compress, bad + sum(by_c.values()))
    # the graphstate kernels on the batches of gpu/statecases.py: one
    # launch a call, no host sync, the hold-point flag on its lane alone
    from lancet_tpu_torch.gpu import graphstate, statecases

    @contextlib.contextmanager
    def no_sync():
        torch.cuda.set_sync_debug_mode("error")  # a host sync raises
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    crafted_gs = dict.fromkeys(_GRAPHSTATE, 0)
    for name, func, arrs, params in statecases.batches():
        before = graphstate.LAUNCHES[func]
        got = statecases.run(func, arrs, params, "cuda", guard=no_sync)
        launched = graphstate.LAUNCHES[func] - before
        want = statecases.run(func, arrs, params, plain=True)
        bad = dtype_mismatches(got, want)
        # the low-coverage kernels also at each cluster size, forced
        by_c = {}
        if func in _LOWCOV:
            st = statecases.state(arrs, params, "cuda")
            K, NI = params["K"], arrs["alive"].shape[1]
            for C in compress.CLUSTER_SIZES:
                if func == "item_mincovs":
                    out = graphstate._mincovs_card(st, K, NI, C=C)
                    keys = ("mincov", "mincov_qv")
                else:
                    lct, ratio = params["params"]
                    thr = ratio * torch.from_numpy(params["avgcov"]).cuda()
                    out = graphstate._lowcov_card(st, K, NI, lct, thr, C=C)
                    keys = ("alive", "e_alive", "any")
                by_c[C] = dtype_mismatches(
                    {k: v.cpu() for k, v in zip(keys, out)}, want)
        crafted[f"{func}/{name}"] = {
            "W": arrs["alive"].shape[0], "launches": launched,
            **({"mismatches_by_cluster": by_c} if by_c else {}),
            "mismatches": bad + int(launched != 1) + sum(by_c.values())}
        crafted_gs[func] = max(crafted_gs[func], bad + sum(by_c.values()))
    held = statecases.run("compact_state", statecases.dead_edge_batch(),
                          {"caps": statecases.SMALL_CAPS}, "cuda")
    crafted["compact_state/dead_edge"] = {
        "W": 2, "dead_edge": held["dead_edge"].tolist(),
        "mismatches": int(held["dead_edge"].tolist() != [True, False])}
    # the cleanup on the batches of gpu/cleanupcases.py: its eight launches
    # free of host syncs, against cleanup_plain on the card, dtypes too
    from lancet_tpu_torch.gpu import cleanupcases, pipeline

    crafted_cleanup = 0
    for name, arrs, K in cleanupcases.batches():
        args = cleanupcases.inputs(arrs, K, "cuda")
        kw = dict(U=cleanupcases.U, D2=cleanupcases.D2,
                  TIP_ROUNDS=cleanupcases.TIP_ROUNDS)
        ok = cleanup_sync_free(args, kw)
        got = _walk_out("cleanup", pipeline.cleanup(*args, **kw))
        want = _walk_out("cleanup", pipeline.cleanup_plain(*args, **kw))
        bad = dtype_mismatches(got, want)
        # tip_fixpoint's tips call at each cluster size the plan takes
        # where it is forced to (the state after the cleanup's
        # low-coverage pass and compress)
        from lancet_tpu_torch.gpu import cleanup, compress, stages

        st, K_, N, NI, cfg, avg = args
        st, _ = stages.low_cov_pass(st, K_, N, NI, cfg["low_cov_threshold"],
                                    cfg["min_cov_ratio"], avg)
        st, fb0 = stages.compress_round(st, K_, NI, N)
        tips = ("tips", cfg["max_tip_len"])
        targs = (st, tips, K_, N, NI, kw["U"], kw["D2"], kw["TIP_ROUNDS"],
                 fb0)
        twant = _walk_out("tip_fixpoint",
                          pipeline.tip_fixpoint_plain(*targs))
        W = arrs["alive"].shape[0]
        EE, NM = st["e_src"].shape[1], st["mer_item"].shape[1]
        by_c = {}
        for C in compress.CLUSTER_SIZES:
            forced = {c: W if c == C else 0 for c in compress.CLUSTER_SIZES}
            ran = cleanup.tip_fixpoint_plan(W, NI, EE, NM, kw["U"], kw["D2"],
                                            forced).C
            by_c[ran] = dtype_mismatches(_walk_out(
                "tip_fixpoint", cleanup.tip_fixpoint(*targs,
                                                     clusters=forced)),
                twant)
        crafted[f"cleanup/{name}"] = {
            "W": W, "sync_free": ok, "fallback": got[1].tolist(),
            "tip_fixpoint_mismatches_by_cluster": by_c,
            "mismatches": bad + int(not ok) + sum(by_c.values())}
        crafted_cleanup = max(crafted_cleanup, bad + sum(by_c.values()))
    # the build on the crafted windows of gpu/buildcases.py at every
    # bucket's shape (the hub at HUB_D): the plan's launches free of host
    # syncs, against build_k_plain on the card, dtypes too
    from lancet_tpu_torch.gpu import buildcases, dbgk

    crafted_build = 0
    for bi, (R, L, N, E) in enumerate(buildcases.BUCKETS):
        for K in (buildcases.KS if bi == 0 else (11, 63)):
            for tag, arrs, D in (
                    ("lanes", buildcases.batch(K, R, L, N, E),
                     buildcases.D_ENGINE),
                    ("hub", buildcases.hub_batch(K, R, L), buildcases.HUB_D)):
                before = dict(dbgk.LAUNCHES)
                got = buildcases.run(arrs, K, N, E, D, "cuda", guard=no_sync)
                launched = {k: dbgk.LAUNCHES[k] - before[k] for k in before}
                want = buildcases.run(arrs, K, N, E, D, "cuda", plain=True)
                bad = dtype_mismatches(got, want)
                crafted[f"build_k/b{bi}_k{K}_{tag}"] = {
                    "W": int(arrs["rlen"].shape[0]), "R": R, "L": L, "N": N,
                    "E": E, "D": D,
                    "fallback": got["fallback"].tolist(),
                    "mismatches": bad + int(
                        launched != dbgk.build_plan(
                            K, int(arrs["rlen"].shape[0]), R, L,
                            buildcases.LRAW, N, E, D).launches)}
                crafted_build = max(crafted_build, bad)
                del got, want
    emit({"phase": "kernels", "case": "walks_crafted", "tolerance": 0,
          "cases": crafted})
    if any(r["mismatches"] for r in crafted.values()):
        raise AssertionError(f"a walk kernel disagrees with its plain "
                             f"version on a crafted case: {crafted}")

    def mean(vals):
        return sum(vals) / len(vals)

    def by_path(name):
        return {"main_path": launches[name],
                "long_window": long_default["launches"][name]
                + long_corpus["launches"][name],
                "engine_path": launches_e[name],
                "fallback_replay": replay[name],
                "devgraph": launches_g[name] + launches_a[name],
                "mesh": sum(lm[name] for lm in launches_m),
                "multihost": launches_mh[name],
                "gates_switch": launches_d[name],
                "hard_main_path": hard["launches_main"][name],
                "hard_devgraph": hard["launches_devgraph"][name],
                "lr_main_path": lr["main"][name],
                "lr_devgraph_env": lr["devgraph_env"][name],
                "lr_two_phase": lr["two_phase"][name]}

    line = []
    for mode, cases in (("smem", kres), ("global", [large]),
                        ("strips", [long_ref])):
        # per launch, averaged over the cases: the main path's DP groups
        # for the shared mode, the large seeded group for the global mode,
        # long_ref for the strip mode (whose path is long_window's)
        bnd = {k: mean([r["bound"][k] for r in cases])
               for k in ("bytes", "operations")}
        by = max(bnd, key=bnd.get)
        line.append({
            "name": f"gotoh_align_{mode}", "route": "cuda",
            "source": "lancet_tpu_torch/csrc/gotoh.cu",
            "replaces": "lancet_tpu/tpu/pallas_gotoh.py:113",
            "also_replaces": "lancet_tpu/tpu/align_batch.py:128",
            "launches": (long_corpus["launches"]["gotoh_align_strips"]
                         if mode == "strips" else
                         launches[f"gotoh_align_{mode}"]),
            "launches_by_path": by_path(f"gotoh_align_{mode}"),
            "on_main_path": mode == "smem",
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            **({"dp_parity_pairs": sum(p["samples"] for p in parity)}
               if mode == "smem" else {}),
            "ms": mean([r["ms"]["median"] for r in cases]),
            "device_ms": mean([r["device_ms"] for r in cases])
            if all(r["device_ms"] is not None for r in cases) else None,
            "plain_ms": mean([r["plain_ms"]["median"] for r in cases]),
            "bound_ms": bnd[by], "bound_by": by, "library_ms": None})
    # the bound of what these inputs need under the kernel's plan; the
    # function-level count (GATE_OPS_PER_STEP) beside it
    gb = {"bytes": gres["bound"]["bytes"],
          "operations": gres["bound"]["plan_operations"]}
    gby = max(gb, key=gb.get)
    big = gdev["largest"]
    line.append({
        "name": "repeat_gates", "route": "cuda",
        "source": "lancet_tpu_torch/csrc/repeats.cu",
        "replaces": "lancet_tpu/tpu/repeats.py:37",
        # the native main path runs no gates; the two-phase path is this
        # kernel's path
        "launches": launches_e["repeat_gates"],
        "launches_by_path": by_path("repeat_gates"),
        "on_main_path": False, "max_abs_err": gres["max_abs_err"],
        "ms": gres["ms"]["median"], "plain_ms": gres["plain_ms"]["median"],
        "bound_ms": gb[gby], "bound_by": gby,
        "function_bound_ms": gres["bound"]["operations"],
        "device_ms": gres["device_ms"]["median"]
        if gres["device_ms"] else None,
        "devgraph_largest": {
            "W": big["W"], "L": big["L"], "nk": big["nk"],
            "ms": big["ms"]["median"],
            "device_ms": big["device_ms"]["median"]
            if big["device_ms"] else None,
            "bound_ms": max(big["bound"]["bytes"],
                            big["bound"]["plan_operations"]),
            "function_bound_ms": big["bound"]["operations"]},
        "library_ms": None})
    for name, kname in _WALKS.items():
        r = wres[name]
        by = max(r["bound"], key=r["bound"].get)
        line.append({
            "name": kname, "route": "cuda",
            "source": "lancet_tpu_torch/csrc/walks.cu",
            "replaces": _WALK_SOURCES[kname],
            # the devgraph path is these kernels' path (the removal pass's
            # K2 runs there as tip_fixpoint's body: its own launches are
            # the plain cleanups' of the checks)
            **({"also_source": "lancet_tpu_torch/csrc/removal_body.cuh",
                "body_runs_in": "tip_fixpoint",
                "plain_cleanup_calls_checked":
                    checked_g[name].get("plain_cleanup_calls", 0)
                    + checked_a[name].get("plain_cleanup_calls", 0)}
               if kname == "seq_removal" else {}),
            "launches": walk_launches[kname],
            "launches_by_path": by_path(kname), "on_main_path": False,
            "max_abs_err": max(r["max_abs_err"],
                               hard["walks"][name]["max_abs_err"]),
            "ms": r["ms"]["median"],
            "plain_ms": r["plain_ms"]["median"], "bound_ms": r["bound"][by],
            "bound_by": by, "device_ms": r["device_ms"],
            "hard_largest_device_ms": hard["walks"][name]["device_ms"],
            "chain_floor_ms": r["chain_floor_ms"], "library_ms": None,
            **({"aten_ops_per_call": rops["aten_ops"] / rops["calls"]}
               if kname == "seq_removal" else {})})
    for name in _SCREENS:
        r = wres[name]
        by = max(r["bound"], key=r["bound"].get)
        line.append({
            "name": name, "route": "cuda",
            "source": "lancet_tpu_torch/csrc/screens.cu",
            "replaces": _SCREEN_SOURCES[name],
            "launches": walk_launches[name],
            "launches_by_path": by_path(name), "on_main_path": False,
            "max_abs_err": max(r["max_abs_err"],
                               hard["walks"][name]["max_abs_err"],
                               crafted_screens[name]),
            "ms": r["ms"]["median"], "plain_ms": r["plain_ms"]["median"],
            "bound_ms": r["bound"][by], "bound_by": by,
            "device_ms": r["device_ms"],
            "hard_largest_device_ms": hard["walks"][name]["device_ms"],
            "chain_floor_ms": r["chain_floor_ms"],
            "hard_largest_chain_floor_ms":
                hard["walks"][name]["chain_floor_ms"],
            "aten_ops_per_call": r["aten_ops_per_call"],
            "plain_aten_ops_per_call": r["plain_aten_ops_per_call"],
            "library_ms": None})
    # compress_round: the largest call of devgraph cases 1 and 2 at the
    # engine's first item axis, the others beside it
    ckeys = sorted(k for k in wres if k.startswith(_COMPRESS))
    big = wres[f"{_COMPRESS}/NI1552"] if f"{_COMPRESS}/NI1552" in wres \
        else wres[ckeys[-1]]
    by = max(big["bound"], key=big["bound"].get)

    def shape_line(r):
        b = max(r["bound"], key=r["bound"].get)
        return {"W": r["W"], "NI": r["NI"], "EE": r["EE"], "NM": r["NM"],
                "cluster": r["cluster"], "blocks": r["blocks"],
                "ms": r["ms"]["median"], "device_ms": r["device_ms"],
                "plain_ms": r["plain_ms"]["median"], "bound_ms": r["bound"][b],
                "bound_by": b, "chain_floor_ms": r["chain_floor_ms"],
                "rounds_max": r["chain_units"]}

    line.append({
        "name": _COMPRESS, "route": "cuda",
        "source": "lancet_tpu_torch/csrc/compress.cu",
        "replaces": _COMPRESS_SOURCE,
        "also_replaces": "lancet_tpu/tpu/stages.py:369",
        "launches": walk_launches[_COMPRESS],
        "launches_by_path": by_path(_COMPRESS), "on_main_path": False,
        "max_abs_err": max([wres[k]["max_abs_err"] for k in ckeys]
                           + [hard["walks"][k]["max_abs_err"]
                              for k in hard["walks"]
                              if k.startswith(_COMPRESS)]
                           + [crafted_compress]),
        "ms": big["ms"]["median"], "plain_ms": big["plain_ms"]["median"],
        "bound_ms": big["bound"][by], "bound_by": by,
        "device_ms": big["device_ms"],
        "chain_floor_ms": big["chain_floor_ms"],
        "aten_ops_per_call": big["aten_ops_per_call"],
        "plain_aten_ops_per_call": big["plain_aten_ops_per_call"],
        "devgraph_by_shape": {k.split("/")[1]: shape_line(wres[k])
                              for k in ckeys},
        "hard_by_shape": {k.split("/")[1]: shape_line(hard["walks"][k])
                          for k in hard["walks"] if k.startswith(_COMPRESS)},
        "also_source": "lancet_tpu_torch/csrc/compress_body.cuh",
        "body_runs_in": "tip_fixpoint",
        "library_ms": None})
    for name in _GRAPHSTATE:
        r, h = wres[name], hard["walks"][name]
        by = max(r["bound"], key=r["bound"].get)
        hby = max(h["bound"], key=h["bound"].get)
        line.append({
            "name": name, "route": "cuda",
            "source": "lancet_tpu_torch/csrc/graphstate.cu",
            "replaces": _GRAPHSTATE_SOURCES[name],
            "launches": walk_launches[name],
            "launches_by_path": by_path(name), "on_main_path": False,
            "max_abs_err": max(r["max_abs_err"], h["max_abs_err"],
                               crafted_gs[name]),
            "ms": r["ms"]["median"], "plain_ms": r["plain_ms"]["median"],
            "bound_ms": r["bound"][by], "bound_by": by,
            "device_ms": r["device_ms"],
            "aten_ops_per_call": r["aten_ops_per_call"],
            "plain_aten_ops_per_call": r["plain_aten_ops_per_call"],
            **{k: r[k] for k in ("cluster", "blocks", "W", "NI", "NM", "K")
               if k in r},
            "hard_largest": {"K": h.get("K"), "ms": h["ms"]["median"],
                             "device_ms": h["device_ms"],
                             "plain_ms": h["plain_ms"]["median"],
                             "bound_ms": h["bound"][hby], "bound_by": hby,
                             **{k: h[k] for k in ("cluster", "blocks")
                                if k in h}},
            "library_ms": None})
    for name in _CLEANUP:
        keys = sorted(k for k in wres if k.split("/")[0] == name)
        hkeys = sorted(k for k in hard["walks"] if k.split("/")[0] == name)
        big = wres[f"{name}/tips" if name == "tip_fixpoint" else name]
        by = max(big["bound"], key=big["bound"].get)

        def mode_line(r):
            b = max(r["bound"], key=r["bound"].get)
            return {"W": r["W"], "NI": r["NI"], "ms": r["ms"]["median"],
                    "device_ms": r["device_ms"],
                    "plain_ms": r["plain_ms"]["median"],
                    "bound_ms": r["bound"][b], "bound_by": b,
                    **{k: r[k] for k in ("compress_rounds", "removal_passes",
                                         "candidates", "kept_bases", "K",
                                         "cluster", "blocks")
                       if k in r}}

        line.append({
            "name": name, "route": "cuda",
            "source": "lancet_tpu_torch/csrc/cleanup.cu",
            "replaces": _CLEANUP_SOURCES[name],
            "also_replaces": _CLEANUP_ALSO[name],
            "launches": walk_launches[name],
            "launches_by_path": by_path(name), "on_main_path": False,
            "max_abs_err": max([wres[k]["max_abs_err"] for k in keys]
                               + [hard["walks"][k]["max_abs_err"]
                                  for k in hkeys] + [crafted_cleanup]),
            "ms": big["ms"]["median"], "plain_ms": big["plain_ms"]["median"],
            "bound_ms": big["bound"][by], "bound_by": by,
            "device_ms": big["device_ms"],
            "aten_ops_per_call": big["aten_ops_per_call"],
            "plain_aten_ops_per_call": big["plain_aten_ops_per_call"],
            "devgraph_by_call": {k: mode_line(wres[k]) for k in keys},
            "hard_by_call": {k: mode_line(hard["walks"][k]) for k in hkeys},
            "library_ms": None})
    for name in _BUILD:
        r, h = bres[name], hard["walks"][name]
        by = max(r["bound"], key=r["bound"].get)
        hby = max(h["bound"], key=h["bound"].get)

        def med(x):
            return x["median"] if x else None

        line.append({
            "name": name, "route": "cuda",
            "source": "lancet_tpu_torch/csrc/dbg.cu",
            "replaces": _BUILD_SOURCE, "also_replaces": _BUILD_ALSO[name],
            "launches": walk_launches[name],
            "launches_by_path": by_path(name), "on_main_path": False,
            "max_abs_err": max(r["max_abs_err"], h["max_abs_err"],
                               crafted_build),
            "ms": r["ms"]["median"], "plain_ms": r["plain_ms"]["median"],
            "bound_ms": r["bound"][by], "bound_by": by,
            "device_ms": r["device_ms"],
            "call_device_ms": r["call_device_ms"],
            "aten_ops_per_call": r["aten_ops_per_call"],
            "plain_aten_ops_per_call": r["plain_aten_ops_per_call"],
            "largest": {k: r[k] for k in ("K", "W", "R", "L", "N", "E",
                                          "I")},
            "hard_largest": {"K": h["K"], "W": h["W"], "R": h["R"],
                             "ms": h["ms"]["median"],
                             "device_ms": h["device_ms"],
                             "device_ms_by_kernel": h.get(
                                 "device_ms_by_kernel"),
                             "blocks_by_kernel": h.get(
                                 "blocks_by_kernel"),
                             "plain_ms": h["plain_ms"]["median"],
                             "bound_ms": h["bound"][hby], "bound_by": hby,
                             "library_ms": med(h["library_ms"])},
            **({"sorts": r["sorts"], "hard_sorts": h["sorts"],
                "build_device_ms": r["build_device_ms"],
                "hard_build_device_ms": h["build_device_ms"]}
               if name == "window_sort" else {}),
            **({k: r[k] for k in ("device_ms_by_kernel",
                                  "device_ms_per_launch",
                                  "blocks_by_kernel")}
               if name in ("node_tables", "edge_tables") else {}),
            "library_ms": med(r["library_ms"])})
    emit({"kernels": line, "t_smoke": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
