"""Checkpoint / resume: per-shard completed-window + variant logs.

The reference has no in-process recovery — the unit of restart is a whole
region job (SURVEY.md §5 "Failure detection"). This framework adds what the
reference lacks: each shard streams an append-only JSONL log of completed
window chunks with the variant records those windows produced. On resume,
logged windows are skipped and their variants are replayed through the
signature-keyed dedup (which is idempotent and order-deterministic,
ref: src/VariantDB.cc:28-91), so a crashed run continues where it died
and yields the identical VCF.
"""

from __future__ import annotations

import json
import os

from .engine.variant import Variant


def variant_to_record(v: Variant) -> dict:
    d = {k: getattr(v, k) for k in Variant.__slots__ if hasattr(v, k)}
    # tuples -> lists happen in JSON; sets (BX barcodes) need explicit care
    for key in ("bx_ref_n", "bx_ref_t", "bx_alt_n", "bx_alt_t"):
        val = d.get(key)
        if isinstance(val, (set, frozenset)):
            d[key] = {"__set__": sorted(val)}
    return d


def variant_from_record(d: dict) -> Variant:
    v = Variant.__new__(Variant)
    for key, val in d.items():
        if isinstance(val, dict) and "__set__" in val:
            val = set(val["__set__"])
        elif key in ("hprn", "hprt", "hpan", "hpat") and isinstance(val, list):
            val = tuple(val)
        setattr(v, key, val)
    return v


class ShardLog:
    """Append-only per-shard log; one JSON line per completed chunk."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def append_chunk(self, window_names: list[str], variants: list) -> None:
        rec = {"windows": window_names,
               "variants": [variant_to_record(v) for v in variants]}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


def shard_log_path(resume_dir: str, shard_idx: int) -> str:
    return os.path.join(resume_dir, f"shard{shard_idx:04d}.jsonl")


def load_resume_state(resume_dir: str, shard_ids):
    """Per-shard [(done_window_names, replay_variants)] from the existing
    logs of the shards `shard_ids` (global shard indices). Replaying a
    shard's variants into its worker's DB before processing reproduces the
    exact window-order accumulation of a fresh run (resume therefore
    requires the same num_threads/shard layout).
    Truncated trailing lines (crash mid-write) are ignored."""
    state = []
    for i in shard_ids:
        done: set[str] = set()
        replay: list = []
        p = shard_log_path(resume_dir, i)
        if resume_dir and os.path.exists(p):
            with open(p) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn tail write; rest is invalid
                    done.update(rec["windows"])
                    replay.extend(variant_from_record(d)
                                  for d in rec["variants"])
        state.append((done, replay))
    return state
