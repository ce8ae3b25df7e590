"""Batched global affine-gap alignment on one device.

`batch_align_async(pairs, device)` packs the pairs, enqueues the Gotoh fill
and traceback (`gotoh.align`, one fused kernel launch on a card) and, on a
card, the copy of the op codes into pinned host memory, then returns
without waiting; `batch_align_wait` waits for that copy and decodes the
alignments. Results
equal the oracle `global_align_aff` of the JAX package (same scores, tie
rules and forced-gap traceback).

The batch is padded only to its own longest S and T: padding never changes
a result, because the traceback reads only cells with i <= n and j <= m.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.align import OP_SGAP, OP_TGAP
from . import gotoh, resolve_device


def _pack(pairs):
    P = len(pairs)
    N = max(1, max(len(s) for s, _ in pairs))
    M = max(1, max(len(t) for _, t in pairs))
    S = np.zeros((P, N + 1), dtype=np.uint8)
    T = np.zeros((P, M + 1), dtype=np.uint8)
    n_len = np.zeros(P, np.int32)
    m_len = np.zeros(P, np.int32)
    for p, (s, t) in enumerate(pairs):
        S[p, 1 : len(s) + 1] = np.frombuffer(s.encode("latin-1"), np.uint8)
        T[p, 1 : len(t) + 1] = np.frombuffer(t.encode("latin-1"), np.uint8)
        n_len[p] = len(s)
        m_len[p] = len(t)
    return S, T, n_len, m_len, N, M


def _decode(ops_rev: np.ndarray, k: int, S: str, T: str) -> tuple[str, str]:
    """Rebuild aligned strings from back-to-front op codes. (A trailing
    '-' sentinel keeps the masked gather in bounds for an empty S or T.)"""
    ops = ops_rev[:k][::-1]
    s_take = ops != OP_TGAP
    t_take = ops != OP_SGAP
    s_idx = np.cumsum(s_take) - 1
    t_idx = np.cumsum(t_take) - 1
    Sa = np.frombuffer(S.encode("latin-1") + b"-", np.uint8)
    Ta = np.frombuffer(T.encode("latin-1") + b"-", np.uint8)
    dash = np.uint8(ord("-"))
    s_chars = np.where(s_take, Sa[np.clip(s_idx, 0, len(S))], dash)
    t_chars = np.where(t_take, Ta[np.clip(t_idx, 0, len(T))], dash)
    return (s_chars.tobytes().decode("latin-1"),
            t_chars.tobytes().decode("latin-1"))


def batch_align_async(pairs: list[tuple[str, str]], device="cuda"):
    """Enqueue the alignment of [(S, T), ...] on `device` without waiting;
    returns a state for batch_align_wait (None for no pairs)."""
    if not pairs:
        return None
    dev = resolve_device(device)
    host = _pack(pairs)
    S, T, n_len, m_len, N, M = host
    if dev.type == "cpu":
        ops, count = gotoh.align(torch.from_numpy(S), torch.from_numpy(T),
                                 torch.from_numpy(n_len),
                                 torch.from_numpy(m_len), N, M)
        return None, ops, count, pairs
    # the copies, the launch and the completion event all on `dev` and its
    # current stream, whatever the calling thread's current device
    with torch.cuda.device(dev):
        S_d, T_d, n_d, m_d = (torch.from_numpy(a).pin_memory().to(
            dev, non_blocking=True) for a in (S, T, n_len, m_len))
        ops_d, count_d = gotoh.align(S_d, T_d, n_d, m_d, N, M)
        ops = torch.empty(ops_d.shape, dtype=ops_d.dtype, pin_memory=True)
        count = torch.empty(count_d.shape, dtype=count_d.dtype,
                            pin_memory=True)
        ops.copy_(ops_d, non_blocking=True)
        count.copy_(count_d, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
    return done, ops, count, pairs


def batch_align_wait(state) -> list[tuple[str, str]]:
    """Wait for a batch_align_async dispatch and decode the alignments. A
    list of states (parallel.mesh.mesh_batch_align_async: one a shard)
    decodes shard after shard, in pair order."""
    if state is None:
        return []
    if isinstance(state, list):
        return [r for st in state for r in batch_align_wait(st)]
    done, ops, count, pairs = state
    if done is not None:
        done.synchronize()  # releases the GIL while it waits
    ops = ops.numpy()
    count = count.numpy()
    return [_decode(ops[p], int(count[p]), s, t)
            for p, (s, t) in enumerate(pairs)]


def batch_align(pairs: list[tuple[str, str]], device="cuda"
                ) -> list[tuple[str, str]]:
    """Align [(S, T), ...] with global affine Gotoh on `device`; returns
    aligned string pairs identical to the oracle global_align_aff."""
    return batch_align_wait(batch_align_async(pairs, device))
