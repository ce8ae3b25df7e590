"""Reference window model (ref: src/Ref.{hh,cc}).

Holds the window's raw/trimmed sequence, per-k canonical-mer index, and
per-sample per-strand reference k-mer coverage projected onto bases.
"""

from __future__ import annotations

import numpy as np

from .mer import canonical
from .node import FWD, HP0_C, HP1_C, HP2_C, NML, REV, TMR, FWD_C, REV_C


class Ref:
    def __init__(self, k: int):
        self.K = k
        self.hdr = ""
        self.seq = ""
        self.rawseq = ""
        self.refchr = ""
        self.refstart = 0
        self.refend = 0
        self.trim5 = 0
        self.trim3 = 0
        self.indexed = False
        self._rawkeys: list[str] | None = None
        self.mertable_nml: dict[str, np.ndarray] | None = None
        self.mertable_tmr: dict[str, np.ndarray] | None = None
        self.normal_coverage: np.ndarray | None = None
        self.tumor_coverage: np.ndarray | None = None
        self.refcompids: set[int] = set()
        self.refnodes = 0
        self.refcomp = 0
        self.allcomp = 0
        self.bx_table_tmr: dict[str, set[str]] = {}
        self.bx_table_nml: dict[str, set[str]] = {}

    def set_k(self, k: int) -> None:
        """Re-key the mer index; NOTE `seq` is NOT reset, so a trim from a
        previous k iteration persists (reference behavior: Ref.hh:109 setK
        clears tables but seq set only by markRefEnds/load)."""
        self.K = k
        self.indexed = False
        self._rawkeys = None  # cached per-position canonical mer strings
        self.clear()
        self.init()

    def init(self) -> None:
        self.mertable_nml = {}
        self.mertable_tmr = {}
        n = len(self.rawseq)
        self.normal_coverage = np.zeros((n, 10), dtype=np.int32)
        self.tumor_coverage = np.zeros((n, 10), dtype=np.int32)

    def clear(self) -> None:
        self.mertable_nml = None
        self.mertable_tmr = None
        self.normal_coverage = None
        self.tumor_coverage = None
        self.bx_table_tmr = {}
        self.bx_table_nml = {}

    def index_mers(self) -> None:
        """Index canonical mers of `seq` for i+K < len(seq) — the final mer
        is excluded (ref: Ref.cc:51 loop bound)."""
        if self.indexed:
            return
        from .seqs import canonical_rows

        K = self.K
        s = np.frombuffer(self.seq.encode("latin-1"), np.uint8)
        rows, _ = canonical_rows(s, K)
        rows = rows[: max(0, len(self.seq) - K)]  # final mer excluded
        nml = self.mertable_nml
        tmr = self.mertable_tmr
        blob = rows.tobytes()
        for i in range(rows.shape[0]):
            cmer = blob[i * K : (i + 1) * K].decode("latin-1")
            if cmer not in nml:
                nml[cmer] = np.zeros(10, dtype=np.int32)
                tmr[cmer] = np.zeros(10, dtype=np.int32)
        self.indexed = True

    def has_mer(self, cmer: str) -> bool:
        self.index_mers()
        return cmer in self.mertable_nml

    def update_coverage(self, cmer: str, cov: int, strand: int, sample: int) -> None:
        self.index_mers()
        table = self.mertable_tmr if sample == TMR else self.mertable_nml
        row = table.get(cmer)
        if row is not None:
            if strand == FWD:
                row[FWD_C] = cov
            elif strand == REV:
                row[REV_C] = cov

    def update_hp_coverage(self, cmer: str, hp0: int, hp1: int, hp2: int, sample: int) -> None:
        self.index_mers()
        table = self.mertable_tmr if sample == TMR else self.mertable_nml
        row = table.get(cmer)
        if row is not None:
            row[HP0_C] = hp0
            row[HP1_C] = hp1
            row[HP2_C] = hp2

    def compute_coverage(self, sample: int) -> None:
        """Project mer coverage onto rawseq positions (ref: Ref.cc:173-250):
        mer at i covers position i+K-1 (positions 0..K-1 from mer 0)."""
        from .seqs import canonical_rows

        table = self.mertable_tmr if sample == TMR else self.mertable_nml
        cov = self.tumor_coverage if sample == TMR else self.normal_coverage
        K = self.K
        cols = [FWD_C, REV_C, HP0_C, HP1_C, HP2_C]
        n = max(0, len(self.rawseq) - K)  # final mer excluded
        keys = self._rawkeys
        if keys is None or len(keys) != n:
            s = np.frombuffer(self.rawseq.encode("latin-1"), np.uint8)
            rows, _ = canonical_rows(s, K)
            blob = rows[:n].tobytes()
            keys = [blob[i * K : (i + 1) * K].decode("latin-1")
                    for i in range(n)]
            self._rawkeys = keys
        zeros5 = (0, 0, 0, 0, 0)
        for i in range(n):
            row = table.get(keys[i])
            vals = (row[FWD_C], row[REV_C], row[HP0_C], row[HP1_C],
                    row[HP2_C]) if row is not None else zeros5
            if i == 0:
                for c, v in zip(cols, vals):
                    cov[:K, c] = v
            else:
                for c, v in zip(cols, vals):
                    cov[i + K - 1, c] = v

    def get_cov_struct_at(self, pos: int, sample: int) -> np.ndarray:
        cov = self.normal_coverage if sample == NML else self.tumor_coverage
        if cov is not None and 0 <= pos < cov.shape[0]:
            return cov[pos]
        return np.zeros(10, dtype=np.int32)

    # --- linked reads ---------------------------------------------------
    def add_bx(self, bx: str, cmer: str, sample: int) -> None:
        self.index_mers()
        table = self.mertable_tmr if sample == TMR else self.mertable_nml
        bxmap = self.bx_table_tmr if sample == TMR else self.bx_table_nml
        if cmer in table:
            bxmap.setdefault(cmer, set()).add(bx)

    def get_bx_set_at(self, start: int, end: int, rseq: str, sample: int) -> str:
        bxmap = self.bx_table_tmr if sample == TMR else self.bx_table_nml
        out: set[str] = set()
        for i in range(start, end + 1):
            cmer, _ = canonical(rseq[i : i + self.K])
            if cmer in bxmap:
                out |= bxmap[cmer]
        if not out:
            return "."
        return ";".join(sorted(out))
