"""Device work: the batched Gotoh alignment, the repeat gates and the
device graph engine (graph build, cleanup, path cover and its walks)."""

from __future__ import annotations

import threading

import torch

_COUNT_LOCK = threading.Lock()


def count_launch(table: dict, name: str) -> None:
    """Add one to a kernel's launch count (shard threads of a mesh launch
    side by side)."""
    with _COUNT_LOCK:
        table[name] += 1


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:N" or "cpu"). Raises if a
    CUDA device is asked for and none is present: nothing carries on
    silently on the CPU. None (a process that must not touch a device)
    raises too."""
    if device is None:
        raise RuntimeError("no device was given to this process (a "
                           "two-phase worker does host work only)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available (pass device='cpu' to "
                               "run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def input_device(name: str, *tensors) -> torch.device:
    """The device of a kernel wrapper's input tensors (None entries are
    skipped). Raises ValueError when they lie on two devices: a kernel
    launches on its inputs' device, so mixed inputs have no device to
    launch on."""
    devs = [t.device for t in tensors if t is not None]
    for d in devs[1:]:
        if d != devs[0]:
            raise ValueError(f"{name}: inputs lie on {devs[0]} and {d}; "
                             "a kernel takes tensors on one device")
    return devs[0]
