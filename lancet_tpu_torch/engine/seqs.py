"""DNA sequence utilities (ref: src/util.cc).

Implements the reference's exact behavior, including its quirks (noted
inline), since they shape which windows are assembled and what is called.
"""

from __future__ import annotations

import numpy as np

_RC = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")

_NATIVE = None  # 0 = unavailable, else the loaded ctypes lib


def _native():
    global _NATIVE
    if _NATIVE is None:
        try:
            from ..native import load_library

            lib = load_library()
            import ctypes

            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.lsq_is_repeat.restype = ctypes.c_int
            lib.lsq_is_repeat.argtypes = [u8p, ctypes.c_int64, ctypes.c_int]
            lib.lsq_is_almost_repeat.restype = ctypes.c_int
            lib.lsq_is_almost_repeat.argtypes = [u8p, ctypes.c_int64,
                                                 ctypes.c_int, ctypes.c_int]
            _NATIVE = lib
        except Exception:
            _NATIVE = 0
    return _NATIVE

_DNA = frozenset("ACGTacgt")

_AMBIG = frozenset("MmRrWwSsYyKkVvHhDdBbXx")


def rc_str(s: str) -> str:
    """Reverse complement (ref: util.cc:227-237)."""
    return s.translate(_RC)[::-1]


def is_dna(b: str) -> bool:
    """A/C/G/T upper or lower (ref: util.cc:194-205)."""
    return b in _DNA


def is_ambiguous(b: str) -> bool:
    """IUPAC ambiguity code (ref: util.cc:171-189)."""
    return b in _AMBIG


def is_n_seq(seq: str) -> bool:
    """Always False: reference's `isNseq` has an `||` bug that makes the
    all-N test unconditionally false (ref: util.cc:259-273), so all-N
    windows are NOT skipped. Preserved for parity.
    """
    return False


def hamming_distance(s1: str, s2: str) -> int:
    """Hamming distance, -1 on length mismatch (ref: util.cc:278-289)."""
    if len(s1) != len(s2):
        return -1
    return sum(a != b for a, b in zip(s1, s2))


def seq_above_qual(qv: str, q: int) -> bool:
    """All quality chars >= q (ref: util.cc:406-412)."""
    return all(ord(c) >= q for c in qv)


def _as_u8(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)


_COMP_U8 = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTacgtNn", b"TGCAtgcaNn"):
    _COMP_U8[_a] = _b


def canonical_rows(s: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer rows for every offset of uint8 sequence `s`:
    returns (rows [n, k] uint8, is_forward [n] bool). Vectorized version
    of CanonicalMer_t::set (Mer.hh:57-71): lexicographic min of the
    window vs its revcomp; palindromes orient R."""
    n = s.size - k + 1
    if n <= 0:
        return np.zeros((0, k), np.uint8), np.zeros(0, bool)
    win = np.lib.stride_tricks.sliding_window_view(s, k)
    rc = np.lib.stride_tricks.sliding_window_view(_COMP_U8[s][::-1], k)[::-1]
    neq = win != rc
    anyneq = neq.any(axis=1)
    first = neq.argmax(axis=1)
    rows_idx = np.arange(n)
    is_f = anyneq & (win[rows_idx, first] < rc[rows_idx, first])
    return np.where(is_f[:, None], win, rc), is_f


def is_repeat(seq: str, k: int) -> bool:
    """Exact duplicate k-mer in seq among offsets [0, L-k) — the final k-mer
    at offset L-k is excluded, matching the reference's loop bound
    (ref: util.cc:295-315 `end = len - K; offset < end`).
    """
    n_off = len(seq) - k  # offsets 0 .. n_off-1
    if n_off <= 1:
        return False
    lib = _native()
    if lib:
        b = _as_u8(seq)
        import ctypes

        return bool(lib.lsq_is_repeat(
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), b.size, k))
    seen = set()
    for off in range(n_off):
        s = seq[off : off + k]
        if s in seen:
            return True
        seen.add(s)
    return False


def is_almost_repeat(seq: str, k: int, max_mismatch: int) -> bool:
    """Near-duplicate (K+1)-length window with <= max_mismatch mismatches.

    The reference compares windows of length K+1 (e-s+1 with e=offset+K,
    ref: util.cc:317-360) between pattern start `offset` in [0, L-K) and
    candidate start i in [offset+1, L-K-1]. Vectorized with shifted
    comparisons + sliding sums; semantics identical.
    """
    arr = _as_u8(seq)
    L = arr.size
    lib = _native()
    if lib:
        import ctypes

        return bool(lib.lsq_is_almost_repeat(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), L, k,
            max_mismatch))
    w = k + 1  # the reference's pattern length quirk
    max_pat = L - k - 1  # pattern offsets 0..L-k-1
    max_i = L - k - 1  # candidate starts must fit the full K+1 window
    if max_pat < 0 or max_i < 1:
        return False
    # One matrix pass over all shifts d (1..max_i) at once:
    #   Mneq[i, d-1] = (seq[i+d] != seq[i]); S[p, d-1] = window sum of w
    # starting at i=p via a column cumsum. Valid (p, d) pairs require
    # p <= max_pat and candidate start p+d <= max_i (which also keeps the
    # compared windows fully in bounds, so the zero padding never leaks
    # into a valid cell).
    D = max_i
    idx = np.arange(L)
    arr_pad = np.concatenate([arr, np.zeros(D + 1, np.uint8)])
    shifts = np.arange(1, D + 1)
    shifted = arr_pad[idx[:, None] + shifts[None, :]]  # [L, D]
    mneq = shifted != arr[:, None]
    cs = np.zeros((L + 1, D), np.int32)
    np.cumsum(mneq, axis=0, out=cs[1:])
    if L - w + 1 <= 0:
        return False
    sums = cs[w:, :] - cs[:-w, :]  # [L-w+1, D], row p = pattern offset
    pidx = np.arange(sums.shape[0])[:, None]
    valid = pidx <= np.minimum(max_pat, max_i - shifts[None, :])
    return bool((valid & (sums <= max_mismatch)).any())


def find_tandems(
    seq: str,
    max_unit_len: int,
    min_report_units: int,
    min_report_len: int,
    dist_from_str: int,
    pos: int,
) -> tuple[bool, int, str]:
    """Microsatellite finder (ref: util.cc:574-758).

    Scans for leftmost primitive tandems with unit length 1..max_unit_len,
    >= min_report_units units and >= min_report_len bp; returns
    (hit, length, motif) where hit is True when `pos` falls within
    dist_from_str bp of a reported tandem. Motif accumulates across hits
    exactly as the reference (+= on every matching report).
    """
    L = len(seq)
    ans = False
    out_len = 0
    motif = []
    offsets = [[p for p in range(m)] + [0] * (max_unit_len - m + 1) for m in range(max_unit_len + 1)]

    for i in range(L):
        for merlen in range(1, max_unit_len + 1):
            phase = i % merlen
            offset = offsets[merlen][phase]

            j = 0
            while j < merlen and i + j < L and seq[i + j] == seq[offset + j]:
                j += 1

            if j != merlen or (i + j + 1 == L):
                # left neighbor test; seq[offset-1] for offset==0 is C++ OOB
                # read — model it as a sentinel that never matches a base.
                left = seq[offset - 1] if offset > 0 else "\0"
                if left != seq[offset + merlen - 1]:
                    if (i - offset) // merlen >= min_report_units and i - offset >= min_report_len:
                        # primitivity check
                        ml = 1
                        while ml < merlen:
                            units = (i - offset + j) // ml
                            allmatch = True
                            for index in range(1, units):
                                if seq[offset : offset + ml] != seq[offset + index * ml : offset + index * ml + ml]:
                                    allmatch = False
                                    break
                            if not allmatch:
                                ml += 1
                            else:
                                break
                        if ml == merlen:
                            start = offset
                            end = i + j
                            if (pos >= start - dist_from_str) and (pos <= end + dist_from_str):
                                ans = True
                                out_len = end - start
                                motif.append(seq[offset : offset + merlen])
                offsets[merlen][phase] = i
    return ans, out_len, "".join(motif)


def parse_md(md: str, counts: dict[int, int], start: int, qual: str, min_qv: int) -> None:
    """MD-tag parser accumulating quality-gated per-locus mismatch counts
    (ref: util.cc:432-483), including the reference's off-by-one quality
    index (`qual[rpos]` AFTER the increment past the mismatched base) and
    C++ `operator[]`-at-end returning NUL.
    """
    valid = set("acgtumrwsykvhdbxnACGTUMRWSYKVHDBXN^")

    def find_first_of(s: str, chars, p: int) -> int:
        for idx in range(p, len(s)):
            if s[idx] in chars:
                return idx
        return -1

    def find_first_not_of(s: str, chars, p: int) -> int:
        for idx in range(p, len(s)):
            if s[idx] not in chars:
                return idx
        return -1

    def atoi(s: str) -> int:
        s2 = s.lstrip()
        out = []
        for idx, c in enumerate(s2):
            if c.isdigit() or (idx == 0 and c in "+-"):
                out.append(c)
            else:
                break
        try:
            return int("".join(out)) if out else 0
        except ValueError:
            return 0

    p = find_first_of(md, valid, 0)
    p_old = -1
    pos = start
    rpos = 0
    while p != -1:
        num = md[p_old + 1 : p]
        step = atoi(num)
        pos += step
        rpos += step
        if md[p] == "^":
            p2 = find_first_not_of(md, valid, p + 1)
            if p2 == -1:
                p2 = len(md)
            deletion = md[p + 1 : p2]
            pos += len(deletion)
            p = find_first_of(md, valid, p2)
            p_old = p2 - 1
        else:
            pos += 1
            rpos += 1
            qc = qual[rpos] if rpos < len(qual) else "\0"
            if ord(qc) >= min_qv:
                counts[pos] = counts.get(pos, 0) + 1
            p_old = p
            p = find_first_of(md, valid, p_old + 1)
