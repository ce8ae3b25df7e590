#!/usr/bin/env python3
"""Run a CUDA source of lancet_tpu_torch/csrc on the CPU: g++ builds it
against tools/cuda_emu/cuda_runtime.h (a launch's blocks one after another,
each thread a std::thread), with the launch syntax rewritten, into a shared
library with the source's plain C interface, which the wrapper module binds
as it binds the card's build.

    python3 tools/cuda_emu/emu.py --check-build

builds csrc/dbg.cu so, runs gpu/dbgk.py's card path (its thirteen launches
through the same pointers and workspace) on CPU tensors on crafted windows
of gpu/buildcases.py at a small shape, at k 33 the sorts' tiles shrunk so
that every sort also merges through device memory, and holds the outputs
bit-equal, dtypes too, to gpu/dbg.py::build_k_plain. Exits 0 when every
output is equal. What it cannot show: the card's compiler (a source that
g++ takes may still fail nvcc), timing, races a barrier-per-warp schedule
hides.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?),(.*?),(.*?),(.*?)>>>\((.*?)\);",
                     re.S)


def translate(src: str) -> str:
    """A CUDA source in the emulation's terms: the dynamic shared memory a
    block buffer, static __shared__ variables function statics, each
    launch an emu_launch."""
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_dyn_smem();")
    src = src.replace("__shared__ ", "static ")
    return _LAUNCH.sub(r"emu_launch(\2, \3, \4, [&] { \1(\6); });", src)


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
           "-Wno-unknown-pragmas", "-I", HERE, cpp, "-o", so]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ refused {src}:\n{r.stderr[-4000:]}")
    return so


def check_build(out_dir: str) -> int:
    """dbgk's card path through the emulated build against build_k_plain on
    crafted windows; returns the count of unequal outputs."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from lancet_tpu_torch.gpu import buildcases as bc
    from lancet_tpu_torch.gpu import dbg, dbgk

    torch.set_num_threads(1)
    lib = dbgk.bind(build(dbgk._SRC, out_dir))
    card = dbgk._Card(lib, None, torch.device("cpu"))
    bad = 0
    for K, tile in ((13, dbgk.SORT_SMEM), (33, 3200)):
        dbgk.SORT_SMEM = tile  # 3,200 bytes: tiles of 64-256 records
        R, L, N, E, D = 6, 48, 64, 160, 4
        arrs = bc.batch(K, R, L, N, E, lanes=("over_n", "mate",
                                              "palindrome"))
        t = [torch.from_numpy(np.ascontiguousarray(arrs[f]))
             for f in bc.FIELDS]
        kw = dict(N=N, E=E, D=D, Lraw=bc.LRAW, **bc.SCALARS)
        want = dbg.build_k_plain(K, *t, **kw)
        p = dbgk.build_plan(K, len(t[0]), R, L, bc.LRAW, N, E, D)
        ins = dbgk._inputs("emu", t[:11] + [t[12]]) + [t[11]]
        got = dbgk._build_card(card, p, ins, bc.SCALARS["min_qual_call"],
                               bc.SCALARS["low_cov_threshold"],
                               bc.SCALARS["min_cov_ratio"])
        for k in dbg.BUILD_KEYS:
            a, b = got[k], want[k]
            pairs = zip(a, b) if isinstance(b, tuple) else [(a, b)]
            ok = all(x.dtype == y.dtype and torch.equal(x, y)
                     for x, y in pairs)
            if not ok:
                print(f"K {K}: {k} differs", file=sys.stderr)
                bad += 1
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-build", action="store_true",
                    help="hold csrc/dbg.cu's kernels, emulated, against "
                         "build_k_plain")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "cuda_emu"))
    a = ap.parse_args()
    if not a.check_build:
        ap.error("nothing to do: pass --check-build")
    bad = check_build(a.out)
    print("equal" if not bad else f"{bad} outputs differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
