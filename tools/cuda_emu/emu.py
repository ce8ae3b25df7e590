#!/usr/bin/env python3
"""Run a CUDA source of lancet_tpu_torch/csrc on the CPU: g++ builds it
against tools/cuda_emu/cuda_runtime.h (a launch's clusters one after
another, a cluster's blocks at once, a cooperative launch's every block at
once, each thread a std::thread), with the launch syntax rewritten, into a
shared library with the source's plain C interface, which the wrapper
module binds as it binds the card's build.

    python3 tools/cuda_emu/emu.py --check-build
    python3 tools/cuda_emu/emu.py --check-compress
    python3 tools/cuda_emu/emu.py --check-cleanup
    python3 tools/cuda_emu/emu.py --check-graphstate

--check-compress builds csrc/compress.cu so and runs gpu/compress.py's card
path (compress._launch: its plan, the launch through the same pointers) on
CPU tensors on every batch of gpu/compresscases.py, the plan's cluster
size forced to each of CLUSTER_C (where a size does not fit the shape's
shared memory the plan takes the next that does: at NI 1,552 C 2 becomes
1), the outputs and fallback held bit-equal, dtypes too, to
gpu/stages.py::compress_round_plain. --check-cleanup builds csrc/cleanup.cu
and runs gpu/cleanup.py's tip_fixpoint card path (one cooperative launch:
every window's cluster at once, a grid barrier a round) on each batch of
gpu/cleanupcases.py at the cleanup's tips call (the state after its
low-coverage pass and compress) and its links call (the state after the
tips fixpoint, its mincov and thr, the gate open and, in place, closed) at
each of CLUSTER_C, held bit-equal to gpu/pipeline.py::tip_fixpoint_plain.
--check-graphstate builds csrc/graphstate.cu and runs gpu/graphstate.py's
item_mincovs and low_cov_pass card paths (their plans, a cluster of C
blocks a window, the launch through the same pointers) on every batch of
gpu/statecases.py at each of CLUSTER_C, held bit-equal, dtypes too, to
gpu/stages.py::item_mincovs_plain and low_cov_pass_plain.

builds csrc/dbg.cu so, runs gpu/dbgk.py's card path (its launches through
the same pointers and workspace) on CPU tensors on crafted windows of
gpu/buildcases.py at small shapes (BUILD_CASES: k 13, 33 and 63, the
sorts' and mer_instances' tiles shrunk so that the sorts take several
passes and several tiles a window and mer_instances several tiles a
window, cut inside reads), holds the outputs bit-equal, dtypes too, to
gpu/dbg.py::build_k_plain and the launches equal to the plan's (node_tables'
and edge_tables' tiles shrunk too, to 256 positions and 8 creation slots
a block, so that every phase takes several tiles a window, groups cross
tile edges and some span three tiles; TIES_CASE once more with the
instance and pair sorts' ties put in reverse index order, which moves each
group's least times to its end, so that the heads across tile edges decide
them), and runs
window_sort on generic int64 keys (SORT_CASES) against window_sort_plain.
Exits 0 when every output is equal. What it cannot show: the card's compiler (a source that
g++ takes may still fail nvcc), timing, races a barrier-per-warp schedule
hides.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# kernel<<<grid, threads, smem, stream>>>(args); the grid may be a call
# such as dim3(W, 3)
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<((?:[^,()]|\([^()]*\))*?),"
                     r"(.*?),(.*?),(.*?)>>>\((.*?)\);", re.S)


def translate(src: str) -> str:
    """A CUDA source in the emulation's terms: the dynamic shared memory a
    block buffer, static __shared__ variables function statics, each
    launch an emu_launch."""
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_dyn_smem();")
    src = src.replace("__shared__ ", "static ")
    return _LAUNCH.sub(r"emu_launch(\2, \3, \4, [&] { \1(\6); });", src)


# the cluster sizes the compress and cleanup checks force
CLUSTER_C = (1, 2, 3, 4)


def build(src: str, out_dir: str) -> str:
    """g++ build of `src` under the emulation into out_dir; returns the
    .so path."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(src))[0]
    cpp = os.path.join(out_dir, f"{stem}_emu.cpp")
    so = os.path.join(out_dir, f"lib{stem}_emu.so")
    with open(src) as f:
        text = translate(f.read())
    with open(cpp, "w") as f:
        f.write(text)
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           "-Wno-unknown-pragmas", "-I", HERE, "-I",
           os.path.dirname(os.path.abspath(src)), cpp, "-o", so]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ refused {src}:\n{r.stderr[-4000:]}")
    return so


# (K, L, R, N, E, sort tile, read instances a mer_instances tile,
# reference offsets a reference tile, node_tables' and edge_tables' tile,
# creation slots a node_tables_order block): the plan's tiles, then tiles
# shrunk so that every sort takes several tiles a window (the node and
# adjacency sorts at N and E 300), mer_instances several read tiles a
# window, their edges inside reads, and node_tables and edge_tables
# several tiles a window (the rows' at E 300 too)
BUILD_CASES = ((13, 48, 6, 64, 160, None, None, None, None, None),
               (13, 48, 12, 300, 300, 256, 64, 256, 256, 8),
               (33, 48, 12, 300, 300, 256, 50, 300, 256, 16),
               (63, 80, 12, 64, 300, 256, 37, 128, 512, 8))
# a BUILD_CASES entry run again with the instance and pair sorts' ties
# reversed
TIES_CASE = BUILD_CASES[1]
# (NK, W, n): generic int64 keys (both signs, the extremes, ties), one tile
# and several, n not a power of two
SORT_CASES = ((1, 3, 200), (1, 3, 700), (2, 2, 1000), (4, 2, 300))


def _equal(got, want) -> bool:
    """Outputs equal, dtypes too (a tuple of tensors item by item)."""
    import torch

    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)


def _reversing_ties(dbgk, p):
    """dbgk._launch_sort, patched while active: after the instance and pair
    sorts of plan p, their permutations rewritten (the emulation's device
    memory is the host's) with ties in reverse index order: a sort still,
    and build_k_plain's outputs do not depend on the order of ties."""
    import ctypes

    import numpy as np

    real = dbgk._launch_sort

    def view(ptr, n):
        return np.ctypeslib.as_array((ctypes.c_int64 * n).from_address(ptr))

    def launch(c, sp, W, keys, ps, wst, perm, scratch):
        real(c, sp, W, keys, ps, wst, perm, scratch)
        if sp is p.sorts["inst"] or sp is p.sorts["pair"]:
            n = sp.n
            k = view(keys, sp.NK * ps).reshape(sp.NK, -1)
            out = view(perm, W * n).reshape(W, n)
            for w in range(W):
                out[w] = np.lexsort((-np.arange(n),) + tuple(
                    k[j][w * wst:w * wst + n]
                    for j in reversed(range(sp.NK))))

    @contextlib.contextmanager
    def active():
        dbgk._launch_sort = launch
        try:
            yield
        finally:
            dbgk._launch_sort = real

    return active()


def check_build(out_dir: str) -> int:
    """dbgk's card path through the emulated build against build_k_plain on
    crafted windows, the launches against the plan, and window_sort on
    generic keys against window_sort_plain; returns the count of unequal
    outputs."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from lancet_tpu_torch.gpu import buildcases as bc
    from lancet_tpu_torch.gpu import dbg, dbgk

    torch.set_num_threads(1)
    lib = dbgk.bind(build(dbgk._SRC, out_dir))
    card = dbgk._Card(lib, None, torch.device("cpu"))
    tiles = (dbgk.SORT_TILE, dbgk.INST_TILE, dbgk.REF_TILE,
             dbgk.BUILD_TILE, dbgk.NODE_SLOTS)
    bad = 0
    try:
        for case, ties in ([(c, False) for c in BUILD_CASES]
                           + [(TIES_CASE, True)]):
            K, L, R, N, E, *shrunk = case
            (dbgk.SORT_TILE, dbgk.INST_TILE, dbgk.REF_TILE, dbgk.BUILD_TILE,
             dbgk.NODE_SLOTS) = (x or d for x, d in zip(shrunk, tiles))
            D = 4
            arrs = bc.batch(K, R, L, N, E, lanes=("over_n", "mate",
                                                  "palindrome", "codes",
                                                  "quals", "short"))
            t = [torch.from_numpy(np.ascontiguousarray(arrs[f]))
                 for f in bc.FIELDS]
            kw = dict(N=N, E=E, D=D, Lraw=bc.LRAW, **bc.SCALARS)
            want = dbg.build_k_plain(K, *t, **kw)
            p = dbgk.build_plan(K, len(t[0]), R, L, bc.LRAW, N, E, D)
            ins = dbgk._inputs("emu", t[:11] + [t[12]]) + [t[11]]
            before = dict(dbgk.LAUNCHES)
            with (_reversing_ties(dbgk, p) if ties
                  else contextlib.nullcontext()):
                got = dbgk._build_card(card, p, ins,
                                       bc.SCALARS["min_qual_call"],
                                       bc.SCALARS["low_cov_threshold"],
                                       bc.SCALARS["min_cov_ratio"])
            launched = {k: dbgk.LAUNCHES[k] - before[k] for k in before}
            shape = (f"K {K} L {L} tiles {dbgk.SORT_TILE}/"
                     f"{dbgk.INST_TILE}/{dbgk.REF_TILE}/{dbgk.BUILD_TILE}/"
                     f"{dbgk.NODE_SLOTS}" + (", ties reversed" if ties
                                              else ""))
            print(f"{shape}: read tiles {p.TR}, reference tiles {p.TF}, "
                  f"node tiles {p.TN}, slot blocks {p.NB}, pair tiles "
                  f"{p.TPu}, row tiles {p.TE}, reference and mate tiles "
                  f"{p.TJ}, {p.TM}, "
                  f"sorts (passes, tiles) "
                  f"{ {k: (s.P, s.T) for k, s in p.sorts.items()} }, "
                  f"launches {launched}", file=sys.stderr)
            if launched != p.launches:
                print(f"{shape}: launches {launched}, the plan "
                      f"{p.launches}", file=sys.stderr)
                bad += 1
            for k in dbg.BUILD_KEYS:
                if not _equal(got[k], want[k]):
                    print(f"{shape}: {k} differs", file=sys.stderr)
                    bad += 1
        dbgk.SORT_TILE = 256
        rng = np.random.default_rng(5)
        for NK, W, n in SORT_CASES:
            k = rng.integers(-5, 5, (NK, W, n)) * (1 << 60)
            k[:, :, ::7] = rng.integers(-(1 << 63), (1 << 63) - 1,
                                        (NK, W, len(range(0, n, 7))))
            k[0, 0, :3] = (-(1 << 63), (1 << 63) - 1, 0)
            keys = torch.from_numpy(k)
            sp = dbgk.sort_plan(NK, n, W)
            got = dbgk._sort_card(card, keys, sp)
            if not torch.equal(got, dbg.window_sort_plain(keys)):
                print(f"window_sort NK {NK} W {W} n {n} differs",
                      file=sys.stderr)
                bad += 1
    finally:
        (dbgk.SORT_TILE, dbgk.INST_TILE, dbgk.REF_TILE, dbgk.BUILD_TILE,
         dbgk.NODE_SLOTS) = tiles
    return bad


def _forced(C: int) -> dict:
    """A clusters table ({C: most held at once}) that makes a plan take C
    where it fits."""
    from lancet_tpu_torch.gpu import compress

    return {c: (1 << 20 if c == C else 0) for c in compress.CLUSTER_SIZES}


def check_compress(out_dir: str) -> int:
    """compress's card path through the emulated build against
    compress_round_plain on every batch of compresscases, at each of
    CLUSTER_C; returns the count of unequal outputs."""
    sys.path.insert(0, ROOT)
    import torch

    from lancet_tpu_torch.gpu import compress, stages
    from lancet_tpu_torch.gpu import compresscases as cc

    torch.set_num_threads(1)
    lib = compress.bind(build(compress._SRC, out_dir))
    bad = 0
    for name, arrs, K in cc.batches():
        st = cc.to_torch(arrs)
        W, NI = arrs["alive"].shape
        NM = arrs["mer_item"].shape[1]
        EE = arrs["e_src"].shape[1]
        N = NI - 2 * cc.CMAX
        want, wfb = stages.compress_round_plain(st, K, NI, N)
        for C in CLUSTER_C:
            ran = compress.compress_plan(W, NI, EE, NM, _forced(C)).C
            outs, fb = compress._launch(st, K, NI, N, 64, lib=lib,
                                        clusters=_forced(C))
            got = dict(zip(compress.OUTPUT_KEYS, outs))
            diff = [k for k in compress.OUTPUT_KEYS
                    if not _equal(got[k], want[k])]
            if not _equal(fb, wfb):
                diff.append("fallback")
            print(f"compress {name} W {W} NI {NI} C {C} (ran {ran}): "
                  f"{'equal' if not diff else 'differs: ' + str(diff)}",
                  file=sys.stderr)
            bad += len(diff)
    return bad


def check_cleanup(out_dir: str) -> int:
    """tip_fixpoint's card path through the emulated build against
    tip_fixpoint_plain on every batch of cleanupcases, the tips call and
    the links call (gate open; closed and in place), at each of
    CLUSTER_C; returns the count of unequal outputs."""
    sys.path.insert(0, ROOT)
    import torch

    from lancet_tpu_torch.gpu import cleanup, pipeline, stages
    from lancet_tpu_torch.gpu import cleanupcases as cl

    torch.set_num_threads(1)
    lib = cleanup.bind(build(cleanup._SRC, out_dir))
    bad = 0
    for tag, arrs, K in cl.batches():
        st, K, N, NI, cfg, avg = cl.inputs(arrs, K)
        W = st["alive"].shape[0]
        st, _ = stages.low_cov_pass(st, K, N, NI, cfg["low_cov_threshold"],
                                    cfg["min_cov_ratio"], avg)
        st, fb0 = stages.compress_round(st, K, NI, N)
        tips = ("tips", cfg["max_tip_len"])
        after, _ = pipeline.tip_fixpoint_plain(st, tips, K, N, NI, cl.U,
                                               cl.D2, cl.TIP_ROUNDS, fb0)
        mincov, _ = stages.item_mincovs_plain(after, K, N, NI)
        thr = torch.full((W,), 5, dtype=torch.int64)
        pre = pipeline.short_link_stage_plain(
            after, mincov, thr, K, NI, cfg["max_link_len"])["pre_any"]
        guard = torch.zeros_like(after["alive"])
        calls = [("tips", st, tips, False),
                 ("links", after, ("links", cfg["max_link_len"], mincov, thr,
                                   guard, pre | True), False),
                 ("links_closed_inplace", after,
                  ("links", cfg["max_link_len"], mincov, thr, guard,
                   pre & False), True)]
        for what, s0, cond, inplace in calls:
            want, wfb = pipeline.tip_fixpoint_plain(
                s0, cond, K, N, NI, cl.U, cl.D2, cl.TIP_ROUNDS, fb0)
            for C in CLUSTER_C:
                own = {k: v.clone() for k, v in s0.items()}
                got, fb = cleanup.tip_fixpoint(
                    own, cond, K, N, NI, cl.U, cl.D2, cl.TIP_ROUNDS, fb0,
                    inplace=inplace, lib=lib, clusters=_forced(C))
                diff = [k for k in cleanup.STATE_KEYS
                        if not _equal(got[k], want[k])]
                if not _equal(fb, wfb):
                    diff.append("fallback")
                if inplace and any(got[k] is not own[k]
                                   for k in cleanup.STATE_KEYS):
                    diff.append("not in place")
                print(f"tip_fixpoint {tag} {what} W {W} C {C}: "
                      f"{'equal' if not diff else 'differs: ' + str(diff)}",
                      file=sys.stderr)
                bad += len(diff)
    return bad


def check_graphstate(out_dir: str) -> int:
    """item_mincovs' and low_cov_pass's card path through the emulated
    build against item_mincovs_plain and low_cov_pass_plain on every batch
    of statecases, at each of CLUSTER_C; returns the count of unequal
    outputs."""
    sys.path.insert(0, ROOT)
    import torch

    from lancet_tpu_torch.gpu import graphstate as gs
    from lancet_tpu_torch.gpu import statecases as sc

    torch.set_num_threads(1)
    lib = gs.bind(build(gs._SRC, out_dir))
    bad = 0
    for name, func, arrs, params in sc.batches():
        if func not in ("item_mincovs", "low_cov_pass"):
            continue
        want = sc.run(func, arrs, params, plain=True)
        st = sc.state(arrs, params)
        K = params["K"]
        W, NI = arrs["alive"].shape
        for C in CLUSTER_C:
            if func == "item_mincovs":
                out = gs._mincovs_card(st, K, NI, lib=lib, C=C)
                got = dict(zip(("mincov", "mincov_qv"), out))
            else:
                lct, ratio = params["params"]
                thr = ratio * torch.from_numpy(params["avgcov"])
                out = gs._lowcov_card(st, K, NI, lct, thr, lib=lib, C=C)
                got = dict(zip(("alive", "e_alive", "any"), out))
            diff = [k for k in want if not _equal(got[k], want[k])]
            print(f"{func} {name} W {W} NI {NI} C {C}: "
                  f"{'equal' if not diff else 'differs: ' + str(diff)}",
                  file=sys.stderr)
            bad += len(diff)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-build", action="store_true",
                    help="hold csrc/dbg.cu's kernels, emulated, against "
                         "build_k_plain")
    ap.add_argument("--check-compress", action="store_true",
                    help="hold csrc/compress.cu, emulated, against "
                         "compress_round_plain")
    ap.add_argument("--check-cleanup", action="store_true",
                    help="hold csrc/cleanup.cu's tip_fixpoint, emulated, "
                         "against tip_fixpoint_plain")
    ap.add_argument("--check-graphstate", action="store_true",
                    help="hold csrc/graphstate.cu's item_mincovs and "
                         "low_cov_pass, emulated, against their plain "
                         "versions")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "cuda_emu"))
    a = ap.parse_args()
    if not (a.check_build or a.check_compress or a.check_cleanup
            or a.check_graphstate):
        ap.error("nothing to do: pass --check-build, --check-compress, "
                 "--check-cleanup or --check-graphstate")
    bad = 0
    if a.check_build:
        bad += check_build(a.out)
    if a.check_compress:
        bad += check_compress(a.out)
    if a.check_cleanup:
        bad += check_cleanup(a.out)
    if a.check_graphstate:
        bad += check_graphstate(a.out)
    print("equal" if not bad else f"{bad} outputs differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
