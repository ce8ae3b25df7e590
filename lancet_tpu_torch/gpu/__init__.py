"""Device work: the batched Gotoh alignment, the repeat gates and the
device graph engine (graph build, cleanup, path cover and its walks)."""

from __future__ import annotations

import torch


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
