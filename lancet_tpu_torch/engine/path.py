"""Source→sink path (ref: src/Path.{hh,cc}).

A path is a node list with edge directions; its sequence is assembled by
orienting each node and overlapping K-1 bases.
"""

from __future__ import annotations

import numpy as np

from .mer import F, R
from .node import edgedir_dest, edgedir_start
from .seqs import rc_str


class Path:
    __slots__ = (
        "nodes", "edges", "edgedir", "dir", "len_m", "has_cycle_m",
        "match_bp", "snp_bp", "ins_bp", "del_bp", "K", "score", "flag",
    )

    def __init__(self, k: int, other: "Path | None" = None):
        self.K = k
        if other is None:
            self.nodes = []
            self.edges = []
            self.edgedir = []
            self.dir = F
            self.len_m = 0
            self.has_cycle_m = 0
            self.match_bp = self.snp_bp = self.ins_bp = self.del_bp = 0
            self.score = 0
            self.flag = 1
        else:
            self.nodes = list(other.nodes)
            self.edges = list(other.edges)
            self.edgedir = list(other.edgedir)
            self.dir = other.dir
            self.len_m = other.len_m
            self.has_cycle_m = other.has_cycle_m
            self.match_bp = other.match_bp
            self.snp_bp = other.snp_bp
            self.ins_bp = other.ins_bp
            self.del_bp = other.del_bp
            self.score = other.score
            self.flag = other.flag

    def cur_node(self):
        return self.nodes[-1]

    def strlen(self) -> int:
        return self.len_m + self.K - 2

    def has_cycle(self, node) -> int:
        """Mark and report when `node` already occurs (ref: Path.cc:319-334)."""
        if self.has_cycle_m:
            return self.has_cycle_m
        if node in self.nodes:
            self.has_cycle_m = 1
            return 1
        return 0

    def pathlen(self) -> int:
        return sum(1 for n in self.nodes if not n.is_special())

    def str(self) -> str:
        """Concatenated oriented node strings with K-1 overlap
        (ref: Path.cc:69-105)."""
        K = self.K
        retval = []
        retlen = 0
        d = edgedir_start(self.edgedir[0])
        for i, n in enumerate(self.nodes):
            nstr = n.str_m
            if d == R:
                nstr = rc_str(nstr)
            if not n.is_special():
                if retlen > 0:
                    retval.append(nstr[K - 1 :])
                    retlen += len(nstr) - K + 1
                else:
                    retval.append(nstr)
                    retlen = len(nstr)
            if i < len(self.edgedir):
                d = edgedir_dest(self.edgedir[i])
        return "".join(retval)

    def cov_distr(self, sample: str) -> np.ndarray:
        """Per-base [L,10] coverage along the path, orientation-corrected
        (ref: Path.cc:110-180)."""
        K = self.K
        parts = []
        total = 0
        d = edgedir_start(self.edgedir[0])
        for i, n in enumerate(self.nodes):
            C = n.cov_distr_tmr if sample == "T" else n.cov_distr_nml
            nc = C[::-1] if d == R else C
            if not n.is_special():
                if total == 0:
                    parts.append(nc)
                    total = nc.shape[0]
                else:
                    parts.append(nc[K - 1 :])
                    total += nc.shape[0] - (K - 1)
            if i < len(self.edgedir):
                d = edgedir_dest(self.edgedir[i])
        if not parts:
            return np.zeros((0, 10), dtype=np.int32)
        return np.concatenate(parts, axis=0)

    def _node_cov(self, n, sample: str) -> float:
        if sample == "T":
            return n.tot_tmr_cov()
        if sample == "N":
            return n.tot_nml_cov()
        return n.tot_tmr_cov() + n.tot_nml_cov()

    def cov(self, sample: str) -> float:
        covsum = 0.0
        strlen = 0.0
        for n in self.nodes:
            if not n.is_special():
                merlen = n.strlen() - self.K + 1
                covsum += self._node_cov(n, sample) * merlen
                strlen += merlen
        return covsum / strlen if strlen else 0.0

    def mincov(self, sample: str) -> float:
        m = -1.0
        for n in self.nodes:
            if not n.is_special():
                c = self._node_cov(n, sample)
                if m == -1 or c < m:
                    m = c
        return m

    def maxcov(self, sample: str) -> float:
        m = -1.0
        for n in self.nodes:
            if not n.is_special():
                c = self._node_cov(n, sample)
                if m == -1 or c > m:
                    m = c
        return m

    def pathcontig(self, pos: int):
        """Node spanning path position `pos` (ref: Path.cc:291-314)."""
        curpos = 0
        for n in self.nodes:
            if not n.is_special():
                span = len(n.str_m)
                if curpos + span >= pos:
                    return n
                curpos += span - self.K + 1
        return None

    def pathstr(self) -> str:
        out = []
        for i, n in enumerate(self.nodes):
            if i:
                out.append(":")
            out.append(n.nodeid)
            if i < len(self.edgedir):
                out.append(":" + self.edgedir[i])
        return "".join(out)
