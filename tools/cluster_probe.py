#!/usr/bin/env python3
"""Whether this card takes a thread block cluster and a cooperative launch
together, and how many such clusters it holds at once.

    python3 tools/cluster_probe.py

Builds tools/cluster_probe.cu with nvcc into build/ and, for clusters of C
= 1 to 4 blocks of 512 threads at the dynamic shared memory of the
compression body's blocks (SMEM: the engine's compact and first shapes'
layouts, and the most a block may take beside its static arrays):
cudaOccupancyMaxActiveClusters with and without the cooperative
attribute; one cudaLaunchKernelEx with both attributes at that many
clusters (grid.sync() and cluster.sync() a round, a peer's shared memory
read and updated by 32- and 64-bit atomics between split cluster
barriers, ROUNDS rounds: the launch's code and the faults its checks
counted), and at one cluster more without the grid barriers (whether the
cooperative launch refuses it); the same launch without the cooperative attribute (no grid
barrier). Then one cp.async.bulk of each block's slice from device memory
into shared memory on an mbarrier, checked. Prints one JSON line a probe,
the card's name and power limit, and a last line {"ok": ...}; exits
non-zero without a card or when a check fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SMEM = (123072, 206160, 214016)
ROUNDS = 4


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: cluster_probe.py needs one card",
              file=sys.stderr)
        return 2
    from lancet_tpu_torch._build import build_shared
    from lancet_tpu_torch.gpu.gotoh import NVCC_FLAGS, _nvcc

    import chip_smoke as cs

    src = os.path.join(HERE, "cluster_probe.cu")
    so = build_shared(src, "libcluster_probe", [_nvcc()] + NVCC_FLAGS + [src])
    lib = ctypes.CDLL(so)
    ci, vp, sz = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
    lib.probe_max_clusters.restype = ci
    lib.probe_max_clusters.argtypes = [ci, sz, ci, ctypes.POINTER(ci)]
    lib.probe_launch.restype = ci
    lib.probe_launch.argtypes = [ci, ci, sz, ci, ci, ci, vp]
    lib.bulk_launch.restype = ci
    lib.bulk_launch.argtypes = [vp, ci, ci, vp]
    props = torch.cuda.get_device_properties(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "sms": props.multi_processor_count,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    ok = True
    for smem in SMEM:
        for C in (1, 2, 3, 4):
            rc = ci(0)
            line = {"C": C, "smem": smem}
            for coop in (1, 0):
                n = lib.probe_max_clusters(C, smem, coop, ctypes.byref(rc))
                line[f"max_active_clusters_coop{coop}"] = n
                line[f"occupancy_rc_coop{coop}"] = rc.value
            n = line["max_active_clusters_coop1"]
            for coop in (1, 0):
                for extra in ((0, 1) if coop else (0,)):
                    k = max(n, 1) + extra
                    out = torch.zeros(2, dtype=torch.int32, device="cuda")
                    # past the most clusters, no grid barrier: a launch
                    # the card took anyway would wait there for ever
                    r = lib.probe_launch(C, k, smem, coop,
                                         coop and not extra, ROUNDS,
                                         out.data_ptr())
                    got = out.tolist() if r == 0 else None
                    line[f"launch_coop{coop}_clusters{k}"] = {
                        "rc": r, "arrivals_faults": got}
                    if extra == 0:
                        ok &= r == 0 and got == [C * k * ROUNDS, 0]
            print(json.dumps(line), flush=True)
    n = 1536
    src_t = torch.arange(32 * n, dtype=torch.int64, device="cuda")
    bad = torch.zeros(1, dtype=torch.int32, device="cuda")
    r = lib.bulk_launch(src_t.data_ptr(), 32, n, bad.data_ptr())
    print(json.dumps({"bulk_copy": {"rc": r, "faults": int(bad.item())
                                    if r == 0 else None}}), flush=True)
    ok &= r == 0 and int(bad.item()) == 0
    with open(so + ".log") as f:
        print(json.dumps({"ptxas": [ln for ln in f.read().splitlines()
                                    if "registers" in ln or "spill" in ln]}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
