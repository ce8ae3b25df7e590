"""ctypes bindings for the native C++ host plane (lancet_native.cc).

`load_library` builds `_lancet_native.so` with g++ at first use into the
build directory (`_build.BUILD_DIR`) and loads it. `NativeBamReader` and
`NativeFastaFile` are the streaming readers that `io.open_bam` /
`io.open_fasta` return; `dbg_build` runs the colored-DBG build of the
per-window engine (`engine/fastbuild.py`); `lmo_ranks_batch` gives the
device graph engine its map-order ranks. The shard runner
(`engine/shardrun.py`), the per-k pipeline (`engine/fastpipe.py`) and the
repeat scans (`engine/seqs.py`) bind their entry points themselves.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading

from .._build import BuildError, build_shared

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "lancet_native.cc")
_CIGAR_OPS = "MIDNSHP=X"

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def build() -> str:
    """Compile the native plane (if not built yet); returns the .so path.
    Raises NativeUnavailable with the compiler's error text."""
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-lz",
           "-lpthread"]
    try:
        return build_shared(_SRC, "_lancet_native", cmd)
    except BuildError as e:
        raise NativeUnavailable(str(e)) from e


def load_library() -> ctypes.CDLL:
    """Build (if needed) and dlopen the native library. It is loaded with
    the default RTLD_LOCAL, so its symbols never bind to another copy of
    the plane loaded in the same process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.lbam_open.restype = ctypes.c_void_p
        lib.lbam_open.argtypes = [ctypes.c_char_p]
        lib.lbam_close.argtypes = [ctypes.c_void_p]
        lib.lbam_header_text.restype = ctypes.c_char_p
        lib.lbam_header_text.argtypes = [ctypes.c_void_p]
        lib.lbam_nrefs.restype = ctypes.c_int
        lib.lbam_nrefs.argtypes = [ctypes.c_void_p]
        lib.lbam_ref_name.restype = ctypes.c_char_p
        lib.lbam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lbam_ref_len.restype = ctypes.c_long
        lib.lbam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lbam_has_index.restype = ctypes.c_int
        lib.lbam_has_index.argtypes = [ctypes.c_void_p]
        lib.lbam_fetch.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.lbam_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_long, ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_long),
                                   ctypes.POINTER(ctypes.c_long)]
        lib.lbam_first.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.lbam_first.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_long),
                                   ctypes.POINTER(ctypes.c_long)]
        lib.lbam_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.lfa_open.restype = ctypes.c_void_p
        lib.lfa_open.argtypes = [ctypes.c_char_p]
        lib.lfa_close.argtypes = [ctypes.c_void_p]
        lib.lfa_nseqs.restype = ctypes.c_long
        lib.lfa_nseqs.argtypes = [ctypes.c_void_p]
        lib.lfa_name.restype = ctypes.c_char_p
        lib.lfa_name.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.lfa_len.restype = ctypes.c_long
        lib.lfa_len.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.lfa_fetch.restype = ctypes.POINTER(ctypes.c_char)
        lib.lfa_fetch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_long,
                                  ctypes.POINTER(ctypes.c_long)]
        lib.lfa_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.lgb_build.restype = ctypes.c_void_p
        lib.lgb_build.argtypes = [
            u8p, u8p, ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p,
            i32p, i32p, i64p, u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, u8p,
            ctypes.c_int64]
        for nm, rt in (("lgb_n_nodes", ctypes.c_int64),
                       ("lgb_n_edges", ctypes.c_int64),
                       ("lgb_mers", u8p), ("lgb_cov", i32p),
                       ("lgb_mq", i32p), ("lgb_flags", u8p),
                       ("lgb_mincov_qv", i32p), ("lgb_tot_cov", i32p),
                       ("lgb_esrc", i32p), ("lgb_edst", i32p),
                       ("lgb_edir", u8p)):
            fn = getattr(lib, nm)
            fn.restype = rt
            fn.argtypes = [ctypes.c_void_p]
        lib.lgb_result_free.argtypes = [ctypes.c_void_p]
        lib.lmo_ranks_batch.restype = None
        lib.lmo_ranks_batch.argtypes = [
            ctypes.c_int64, i64p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32, i32p, i64p]
        _lib = lib
        return lib


def dbg_build(cat, qcat, starts, lens, sample, strand, order, name_off,
              name_blob, K, minq, avgcov, low_cov_threshold, min_cov_ratio,
              refseq):
    """Run the native colored-DBG build kernel; returns a dict of numpy
    arrays (copies — the native result is freed before returning). Raises
    NativeUnavailable when the toolchain is missing."""
    import numpy as np

    lib = load_library()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def p(a, t):
        return a.ctypes.data_as(t)

    h = lib.lgb_build(
        p(cat, u8p), p(qcat, u8p), cat.size, lens.size, p(starts, i64p),
        p(lens, i32p), p(sample, i32p), p(strand, i32p), p(order, i32p),
        p(name_off, i64p), p(name_blob, u8p), K, minq, float(avgcov),
        int(low_cov_threshold), float(min_cov_ratio), p(refseq, u8p),
        refseq.size)
    try:
        n = lib.lgb_n_nodes(h)
        m = lib.lgb_n_edges(h)

        def arr(fn, count, dtype):
            if count == 0:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(fn(h), shape=(count,)).astype(
                dtype, copy=True)

        return {
            "n_nodes": n,
            "mers": arr(lib.lgb_mers, n * K, np.uint8),
            "cov": arr(lib.lgb_cov, n * 4, np.int32).reshape(n, 4),
            "mq": arr(lib.lgb_mq, 4 * n * K, np.int32).reshape(4, n, K),
            "flags": arr(lib.lgb_flags, n, np.uint8),
            "mincov_qv": arr(lib.lgb_mincov_qv, n, np.int32),
            "tot_cov": arr(lib.lgb_tot_cov, n, np.int32),
            "esrc": arr(lib.lgb_esrc, m, np.int32),
            "edst": arr(lib.lgb_edst, m, np.int32),
            "edir": arr(lib.lgb_edir, m, np.uint8),
        }
    finally:
        lib.lgb_result_free(h)


def lmo_ranks_batch(hi, lo, offs, k):
    """libstdc++ iteration-order ranks for packed mers, batched over
    windows (lancet_native.cc lmo_ranks_batch). `hi`/`lo` are flat uint64
    arrays (2-bit packed mers, first base most significant; k <= 63),
    `offs` the per-window [n_windows+1] int64 offsets. Returns (ranks int32
    flat, slack int64 per window), slack being the insert headroom before
    the next rehash. Raises NativeUnavailable when the plane cannot be
    built."""
    import numpy as np

    lib = load_library()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint64)
    offs = np.ascontiguousarray(offs, np.int64)
    nw = len(offs) - 1
    ranks = np.zeros(max(1, hi.size), np.int32)
    slack = np.zeros(max(1, nw), np.int64)

    def p(a, t):
        return a.ctypes.data_as(t) if a.size else ctypes.cast(None, t)

    lib.lmo_ranks_batch(nw, p(offs, i64p), p(hi, u64p), p(lo, u64p), k,
                        p(ranks, i32p), p(slack, i64p))
    return ranks[: hi.size], slack[:nw]


def _unpack_records(buf: bytes, n: int):
    """Decode the packed wire format (see lancet_native.cc header comment)
    into Aln objects."""
    from ..io.aln import Aln
    from ..io.bam import _parse_tags

    out = []
    p = 0
    for _ in range(n):
        (pos, _end, flag, mapq, has_qual, n_cigar, l_name, l_seq,
         l_tags) = struct.unpack_from("<iiHBBHHii", buf, p)
        p += 24
        name = buf[p : p + l_name].decode("ascii")
        p += l_name
        cigar = []
        for c in range(n_cigar):
            v = struct.unpack_from("<I", buf, p + 4 * c)[0]
            cigar.append((_CIGAR_OPS[v & 0xF], v >> 4))
        p += 4 * n_cigar
        seq = buf[p : p + l_seq].decode("ascii")
        p += l_seq
        if has_qual:
            qual = buf[p : p + l_seq].decode("ascii")
            p += l_seq
        else:
            qual = ""
        tags = _parse_tags(buf[p : p + l_tags])
        p += l_tags
        out.append(Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                       qual=qual, cigar=cigar, tags=tags))
    return out


class NativeBamReader:
    """Streaming indexed BAM reader over the C++ core."""

    def __init__(self, path: str):
        self._h = None
        self._lib = load_library()
        self._h = self._lib.lbam_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open BAM {path}")
        self.header_text = self._lib.lbam_header_text(self._h).decode(
            "ascii", "replace")
        nrefs = self._lib.lbam_nrefs(self._h)
        self.references = [
            (self._lib.lbam_ref_name(self._h, i).decode("ascii"),
             self._lib.lbam_ref_len(self._h, i))
            for i in range(nrefs)
        ]
        self._name_to_id = {nm: i for i, (nm, _) in enumerate(self.references)}

    def close(self):
        if self._h:
            self._lib.lbam_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def sample_name(self) -> str:
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SM:"):
                        return fld[3:]
        return "NA"

    def _call_fetch(self, fn, *args):
        n = ctypes.c_long()
        size = ctypes.c_long()
        ptr = fn(self._h, *args, ctypes.byref(n), ctypes.byref(size))
        if not ptr or n.value == 0:
            if ptr:
                self._lib.lbam_free(ptr)
            return []
        buf = ctypes.string_at(ptr, size.value)
        self._lib.lbam_free(ptr)
        return _unpack_records(buf, n.value)

    def fetch(self, chrom: str, left: int, right: int):
        """Alignments with pos <= right and end_position >= left, file
        order (same superset contract as the Python reader)."""
        rid = self._name_to_id.get(chrom)
        if rid is None:
            return []
        return self._call_fetch(self._lib.lbam_fetch, rid, left, right)

    def first_record(self):
        recs = self._call_fetch(self._lib.lbam_first)
        return recs[0] if recs else None


class NativeFastaFile:
    """faidx-style random-access FASTA over the C++ core (builds the .fai
    if missing)."""

    def __init__(self, path: str):
        self._h = None
        self._lib = load_library()
        if not os.path.exists(path + ".fai"):
            from ..io.fasta import write_fai

            write_fai(path)
        self.path = path
        self._h = self._lib.lfa_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open FASTA {path}")
        n = self._lib.lfa_nseqs(self._h)
        self.lengths = {
            self._lib.lfa_name(self._h, i).decode("ascii"):
                self._lib.lfa_len(self._h, i)
            for i in range(n)
        }

    def close(self):
        if self._h:
            self._lib.lfa_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def fetch(self, chrom: str, start: int, end: int) -> str:
        if chrom not in self.lengths:
            raise KeyError(chrom)
        ln = ctypes.c_long()
        ptr = self._lib.lfa_fetch(self._h, chrom.encode(), start, end,
                                  ctypes.byref(ln))
        if not ptr:
            return ""
        s = ctypes.string_at(ptr, ln.value).decode("ascii")
        self._lib.lfa_free(ptr)
        return s
