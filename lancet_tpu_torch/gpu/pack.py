"""Host-side packing of window reads into the device graph engine's padded
tensors, and the plain reference of the map-order rank round trip.

The device engine (gpu.dbg) consumes post-trim reads; trimming and junk
filtering happen in the native extractor, mirroring Graph_t::trim (ref:
src/Graph.cc:355-384). The JAX package's copy of this module imports its
sample codes from its build module, which loads JAX; this one keeps its own
(S_TMR/S_NML/S_REF, the same values).
"""

from __future__ import annotations

import numpy as np

# sample codes used on the device (the host maps TMR=4/NML=5/REF=3 onto them)
S_TMR = 0
S_NML = 1
S_REF = 2

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i

# per-window engine sample labels (engine.node)
_TMR, _NML, _REF_LABEL = 4, 5, 3
_SAMPLE_MAP = {_TMR: S_TMR, _NML: S_NML, _REF_LABEL: S_REF}


class WindowBatch:
    """Padded numpy tensors for one build_k call (the caller moves them to
    the device)."""

    __slots__ = ("bases", "quals", "rlen", "rsample", "rstrand", "rfrag",
                 "rorder", "raw", "rawlen", "seq_off", "seq_len",
                 "totalreadbp", "window_ok", "overflow",
                 "W", "R", "L", "Lraw")

    def __init__(self, W, R, L, Lraw):
        self.W, self.R, self.L, self.Lraw = W, R, L, Lraw
        self.bases = np.full((W, R, L), 4, np.uint8)
        self.quals = np.zeros((W, R, L), np.uint8)
        self.rlen = np.zeros((W, R), np.int32)
        self.rsample = np.full((W, R), S_REF, np.int8)
        self.rstrand = np.zeros((W, R), np.int8)
        self.rfrag = np.full((W, R), -1, np.int32)
        self.rorder = np.zeros((W, R), np.int8)
        self.raw = np.full((W, Lraw), 4, np.uint8)
        self.rawlen = np.zeros(W, np.int32)
        self.seq_off = np.zeros(W, np.int32)
        self.seq_len = np.zeros(W, np.int32)
        self.totalreadbp = np.zeros(W, np.int32)
        self.window_ok = np.zeros(W, bool)
        self.overflow = np.zeros(W, bool)  # host-side cap overflow


def pack_window(batch: WindowBatch, w: int, reads, rawseq: str,
                seq_off: int, seq_len: int, totalreadbp: int) -> None:
    """Fill lane `w`. `reads` = list of (seq_bytes, qual_bytes,
    sample_label, strand, frag_id, mate_order) post-trim in readid order,
    WITHOUT the ref pseudo-read (the device builds it from rawseq).
    Overflowing lanes are flagged, not packed."""
    R, L, Lraw = batch.R, batch.L, batch.Lraw
    if len(reads) > R or len(rawseq) > Lraw:
        batch.overflow[w] = True
        return
    for r, (seq, qual, sample, strand, frag, order) in enumerate(reads):
        n = len(seq)
        if n > L:
            batch.overflow[w] = True
            return
        batch.bases[w, r, :n] = _CODE[np.frombuffer(seq, np.uint8)]
        batch.quals[w, r, :n] = np.frombuffer(qual, np.uint8)
        batch.rlen[w, r] = n
        batch.rsample[w, r] = _SAMPLE_MAP[sample]
        batch.rstrand[w, r] = strand - 1  # FWD=1/REV=2 -> 0/1
        batch.rfrag[w, r] = frag
        batch.rorder[w, r] = order
    raw = _CODE[np.frombuffer(rawseq.encode("latin-1"), np.uint8)]
    if (raw >= 4).any():
        # non-ACGT in the window sequence: the reference would build
        # N-containing mer nodes, which 2-bit packing cannot represent
        batch.overflow[w] = True
        return
    batch.raw[w, : raw.size] = raw
    batch.rawlen[w] = raw.size
    batch.seq_off[w] = seq_off
    batch.seq_len[w] = seq_len
    batch.totalreadbp[w] = totalreadbp
    batch.window_ok[w] = True


def pack_chunk(batch: WindowBatch, tasks) -> None:
    """pack_window over a whole chunk, with one fancy-indexed assignment
    for all reads' bases and quals."""
    R, L, Lraw = batch.R, batch.L, batch.Lraw
    seq_parts: list[bytes] = []
    qual_parts: list[bytes] = []
    rows: list[int] = []
    lens: list[int] = []
    for w, t in enumerate(tasks):
        reads = t.reads
        rawseq = t.rawseq
        if len(reads) > R or len(rawseq) > Lraw \
                or any(len(seq) > L for seq, *_ in reads):
            batch.overflow[w] = True
            continue
        raw = _CODE[np.frombuffer(rawseq.encode("latin-1"), np.uint8)]
        if (raw >= 4).any():
            batch.overflow[w] = True  # non-ACGT, as in pack_window
            continue
        for r, (seq, qual, sample, strand, frag, order) in enumerate(reads):
            seq_parts.append(seq)
            qual_parts.append(qual)
            rows.append(w * R + r)
            lens.append(len(seq))
            batch.rlen[w, r] = len(seq)
            batch.rsample[w, r] = _SAMPLE_MAP[sample]
            batch.rstrand[w, r] = strand - 1
            batch.rfrag[w, r] = frag
            batch.rorder[w, r] = order
        batch.raw[w, : raw.size] = raw
        batch.rawlen[w] = raw.size
        batch.seq_off[w] = t.seq_off
        batch.seq_len[w] = t.seq_len
        batch.totalreadbp[w] = t.totalreadbp
        batch.window_ok[w] = True
    if not rows:
        return
    lens_a = np.asarray(lens, np.int64)
    rows_a = np.repeat(np.asarray(rows, np.int64), lens_a)
    offs = np.zeros(len(lens_a) + 1, np.int64)
    np.cumsum(lens_a, out=offs[1:])
    cols_a = np.arange(int(offs[-1]), dtype=np.int64) \
        - np.repeat(offs[:-1], lens_a)
    seq_flat = _CODE[np.frombuffer(b"".join(seq_parts), np.uint8)]
    qual_flat = np.frombuffer(b"".join(qual_parts), np.uint8)
    batch.bases.reshape(-1, L)[rows_a, cols_a] = seq_flat
    batch.quals.reshape(-1, L)[rows_a, cols_a] = qual_flat


def words_to_128(words, K: int):
    """The device's mer words (gpu.dbg: int64 words of 31 bases, most
    significant first, the last word full) -> the (hi64, lo64) uint64 halves
    of the 2-bit packed mer, first base most significant, as the native
    rank kernel reads them. `words` is a list of equal-shape int64 numpy
    arrays; k <= 63."""
    u = [np.asarray(w).astype(np.uint64) for w in words]
    sh62 = np.uint64(62)
    mask = np.uint64(0xFFFFFFFFFFFFFFFF)
    zero = np.zeros_like(u[0])
    w2 = u[-1]
    w1 = u[-2] if len(u) >= 2 else zero
    w0 = u[-3] if len(u) >= 3 else zero
    lo = (w2 | (w1 << sh62)) & mask
    hi = (w1 >> np.uint64(2)) | (w0 << np.uint64(60))
    return hi, lo


def map_ranks(mer_strings: list[str]) -> tuple[np.ndarray, int]:
    """libstdc++ unordered_map iteration ranks for keys inserted in
    creation order (the reference's node-table order: survivor choice and
    component numbering depend on it; see cpp_hash).

    Returns (ranks int32 [n], slack): slack is the insert headroom before
    the next rehash. The plain reference of the native lmo_ranks_batch
    (engine.devicepipe._map_ranks_batch), which the engine requires."""
    n = len(mer_strings)
    if n == 0:
        return np.zeros(0, np.int32), 1 << 30
    from ..cpp_hash import CppUnorderedMap

    m = CppUnorderedMap()
    for s in mer_strings:
        m[s] = None
    order = {k: i for i, k in enumerate(m.keys())}
    ranks = np.fromiter((order[s] for s in mer_strings), np.int32, n)
    return ranks, m._next_resize - n


def unpack_mers_words(hi64: np.ndarray, lo64: np.ndarray, K: int) -> list[str]:
    """128-bit packed (hi64, lo64) -> mer strings, k <= 63."""
    out = []
    for i in range(len(lo64)):
        v = (int(hi64[i]) << 64) | int(lo64[i])
        out.append("".join("ACGT"[(v >> (2 * (K - 1 - j))) & 3]
                           for j in range(K)))
    return out
