"""Graph node and edge types of the colored de Bruijn graph
(ref: src/Node.{hh,cc}, src/Edge.hh, cov_t at src/Ref.hh:41-53).

Per-base coverage is a [L, 10] int array with columns
(fwd, rev, minqv_fwd, minqv_rev, hp0, hp1, hp2, hp0_minqv, hp1_minqv, hp2_minqv).
"""

from __future__ import annotations

import numpy as np

from ..cpp import std_binary_search
from .mer import F, R
from .seqs import rc_str

# cov_t column indices
FWD_C, REV_C, MQF_C, MQR_C, HP0_C, HP1_C, HP2_C, HP0Q_C, HP1Q_C, HP2Q_C = range(10)

# samples / strands (ref: Ref.hh:36-37, ReadInfo.hh:31-32)
TMR = 4
NML = 5
FWD = 1
REV = 2

# edge directions
FF, FR, RF, RR = "FF", "FR", "RF", "RR"


def edgedir_start(d: str) -> str:
    return F if d in (FF, FR) else R


def edgedir_dest(d: str) -> str:
    return F if d in (FF, RF) else R


def flipme(d: str) -> str:
    """Flip the start orientation (ref: Edge.hh:93-101)."""
    return {FF: RF, FR: RR, RF: FF, RR: FR}[d]


def fliplink(d: str) -> str:
    """Reverse the edge (ref: Edge.hh:103-111)."""
    return {FF: RR, FR: FR, RF: RF, RR: FF}[d]


def make_dir(ori_u: str, ori_v: str) -> str:
    return (F if ori_u == F else R) + ("F" if ori_v == F else "R")


class Edge:
    __slots__ = ("nodeid", "dir", "flag", "readids")

    def __init__(self, nodeid: str, d: str):
        self.nodeid = nodeid
        self.dir = d
        self.flag = 0
        self.readids: list[int] = []

    def isdir(self, ori: str) -> bool:
        return edgedir_start(self.dir) == ori

    def startdir(self) -> str:
        return edgedir_start(self.dir)

    def destdir(self) -> str:
        return edgedir_dest(self.dir)


class Node:
    """One node (k-mer or compressed unitig) of the colored DBG."""

    __slots__ = (
        "nodeid", "K", "str_m", "cov_tmr_fwd", "cov_tmr_rev", "cov_nml_fwd",
        "cov_nml_rev", "is_ref", "is_tumor", "is_normal", "is_source", "is_sink",
        "dead", "component", "touch_ref", "on_ref_path", "color", "min_qual",
        "mincov", "mincov_qv", "cov_status", "cov_distr_tmr", "cov_distr_nml",
        "edges", "reads", "bx_tmr_fwd", "bx_tmr_rev", "bx_nml_fwd", "bx_nml_rev",
        "hpset_tmr", "hpset_nml", "mate1_name", "mate2_name", "readstarts",
    )

    def __init__(self, mer: str):
        self.nodeid = mer
        self.K = 0
        self.str_m = mer
        self.cov_tmr_fwd = 0.0
        self.cov_tmr_rev = 0.0
        self.cov_nml_fwd = 0.0
        self.cov_nml_rev = 0.0
        self.is_ref = False
        self.is_tumor = False
        self.is_normal = False
        self.is_source = False
        self.is_sink = False
        self.dead = False
        self.component = 0
        self.touch_ref = False
        self.on_ref_path = 0
        self.color = 0
        self.min_qual = 0
        self.mincov = 0
        self.mincov_qv = 0
        L = len(mer)
        self.cov_status = bytearray(b"E" * L)
        self.cov_distr_tmr = np.zeros((L, 10), dtype=np.int32)
        self.cov_distr_nml = np.zeros((L, 10), dtype=np.int32)
        self.edges: list[Edge] = []
        self.reads: set[int] = set()
        self.bx_tmr_fwd: set[str] = set()
        self.bx_tmr_rev: set[str] = set()
        self.bx_nml_fwd: set[str] = set()
        self.bx_nml_rev: set[str] = set()
        self.hpset_tmr = [0, 0, 0]
        self.hpset_nml = [0, 0, 0]
        self.mate1_name: list[str] = []
        self.mate2_name: list[str] = []
        self.readstarts: list[list] = []  # [readid, nodeoffset, trim5, ori]

    # --- flags ---------------------------------------------------------
    def is_special(self) -> bool:
        return self.is_sink or self.is_source or self.is_ref

    def strlen(self) -> int:
        return 0 if self.is_special() else len(self.str_m)

    def get_size(self) -> int:
        return len(self.str_m) - self.K + 1

    # --- coverage ------------------------------------------------------
    def get_cov(self, strand: int, label: int) -> float:
        if label == TMR:
            return self.cov_tmr_fwd if strand == FWD else self.cov_tmr_rev
        return self.cov_nml_fwd if strand == FWD else self.cov_nml_rev

    def inc_cov(self, strand: int, label: int) -> None:
        if label == TMR:
            if strand == FWD:
                self.cov_tmr_fwd += 1
            elif strand == REV:
                self.cov_tmr_rev += 1
        elif label == NML:
            if strand == FWD:
                self.cov_nml_fwd += 1
            elif strand == REV:
                self.cov_nml_rev += 1

    def tot_tmr_cov(self) -> float:
        return self.cov_tmr_fwd + self.cov_tmr_rev

    def tot_nml_cov(self) -> float:
        return self.cov_nml_fwd + self.cov_nml_rev

    def tot_cov(self) -> float:
        return self.tot_tmr_cov() + self.tot_nml_cov()

    def update_cov_distr(self, cov: int, qv: str, strand: int, sample: int) -> None:
        """Broadcast node counter into fwd/rev; per-base increment of minqv_*
        gated on base quality (ref: Node.cc:470-497)."""
        cd = self.cov_distr_tmr if sample == TMR else self.cov_distr_nml
        q = np.frombuffer(qv.encode("latin-1"), dtype=np.uint8)
        n = cd.shape[0]
        above = np.zeros(n, dtype=bool)
        m = min(n, q.size)
        above[:m] = q[:m] >= self.min_qual
        # C++ reads qv[i] for i beyond the string in UB territory only when
        # node is longer than qv; during build both have length K.
        if strand == FWD:
            cd[:, FWD_C] = cov
            cd[above, MQF_C] += 1
        elif strand == REV:
            cd[:, REV_C] = cov
            cd[above, MQR_C] += 1

    def update_hp_cov_distr(self, hp0: int, hp1: int, hp2: int, qv: str, sample: int) -> None:
        """(ref: Node.cc:502-520)"""
        cd = self.cov_distr_tmr if sample == TMR else self.cov_distr_nml
        q = np.frombuffer(qv.encode("latin-1"), dtype=np.uint8)
        n = cd.shape[0]
        above = np.zeros(n, dtype=bool)
        m = min(n, q.size)
        above[:m] = q[:m] >= self.min_qual
        cd[above & (cd[:, HP0_C] < hp0), HP0Q_C] += 1
        cd[above & (cd[:, HP1_C] < hp1), HP1Q_C] += 1
        cd[above & (cd[:, HP2_C] < hp2), HP2Q_C] += 1
        cd[:, HP0_C] = hp0
        cd[:, HP1_C] = hp1
        cd[:, HP2_C] = hp2

    def update_cov_status(self, c: int) -> None:
        """'E'->c; !=c -> 'B' (ref: Node.cc:445-465)."""
        cs = self.cov_status
        for i in range(len(cs)):
            if cs[i] == ord("E"):
                cs[i] = c
            elif cs[i] != c:
                cs[i] = ord("B")

    def is_status_cnt(self, c: int) -> bool:
        """>80% of positions from K-1 onward have status c (ref: Node.cc:423-440)."""
        cs = self.cov_status
        n = 0
        cnt = 0
        for i in range(self.K - 1, len(cs)):
            n += 1
            if cs[i] == c:
                cnt += 1
        if n == 0:
            return False
        return (cnt / n) > 0.8

    def compute_min_cov(self) -> None:
        """(ref: Node.cc:600-615)"""
        tot = (
            self.cov_distr_tmr[:, FWD_C] + self.cov_distr_tmr[:, REV_C]
            + self.cov_distr_nml[:, FWD_C] + self.cov_distr_nml[:, REV_C]
        )
        totq = (
            self.cov_distr_tmr[:, MQF_C] + self.cov_distr_tmr[:, MQR_C]
            + self.cov_distr_nml[:, MQF_C] + self.cov_distr_nml[:, MQR_C]
        )
        self.mincov = int(tot.min()) if tot.size else 10000000
        self.mincov_qv = int(totq.min()) if totq.size else 10000000

    def min_non0_cov(self, sample: str) -> int:
        cd = self.cov_distr_tmr if sample == "T" else self.cov_distr_nml
        tot = cd[:, FWD_C] + cd[:, REV_C]
        nz = tot[tot > 0]
        return int(nz.min()) if nz.size else 10000000

    def avg_cov_distr(self, sample: str) -> int:
        """floor(mean of non-zero totals) (ref: Node.cc:525-549)."""
        cd = self.cov_distr_tmr if sample == "T" else self.cov_distr_nml
        tot = cd[:, FWD_C] + cd[:, REV_C]
        nz = tot[tot > 0]
        if nz.size == 0 or nz.sum() <= 0:
            return 0
        return int(np.floor(float(nz.sum()) / float(nz.size)))

    def rev_cov_distr(self) -> None:
        self.cov_distr_tmr = self.cov_distr_tmr[::-1].copy()
        self.cov_distr_nml = self.cov_distr_nml[::-1].copy()
        # NOTE: the reference does NOT reverse cov_status here (Node.cc:564-573)

    # --- linked reads --------------------------------------------------
    def add_bx(self, bx: str, strand: int, label: int) -> bool:
        if bx == "null":
            return False
        tgt = {
            (TMR, FWD): self.bx_tmr_fwd, (TMR, REV): self.bx_tmr_rev,
            (NML, FWD): self.bx_nml_fwd, (NML, REV): self.bx_nml_rev,
        }.get((label, strand))
        if tgt is None:
            return False
        before = len(tgt)
        tgt.add(bx)
        return len(tgt) != before

    def has_bx(self, bx: str, label: int) -> bool:
        if label == TMR:
            return bx in self.bx_tmr_fwd or bx in self.bx_tmr_rev
        if label == NML:
            return bx in self.bx_nml_fwd or bx in self.bx_nml_rev
        return False

    def bx_cnt(self, strand: int, label: int) -> int:
        if label == TMR:
            return len(self.bx_tmr_fwd) if strand == FWD else len(self.bx_tmr_rev)
        if label == NML:
            return len(self.bx_nml_fwd) if strand == FWD else len(self.bx_nml_rev)
        return -1

    def add_hp(self, hp: int, label: int) -> None:
        if label == TMR:
            self.hpset_tmr[hp] += 1
        if label == NML:
            self.hpset_nml[hp] += 1

    def hp_cnt(self, hp: int, label: int) -> int:
        if label == TMR:
            return self.hpset_tmr[hp]
        if label == NML:
            return self.hpset_nml[hp]
        return -1

    # --- mates ---------------------------------------------------------
    def add_mate_name(self, name: str, order: int) -> None:
        if order == 1:
            self.mate1_name.append(name)
        if order == 2:
            self.mate2_name.append(name)

    def has_overlapping_mate(self, name: str, order: int) -> bool:
        """std::binary_search over the (possibly unsorted) other-mate list
        (ref: Node.cc:638-661) — exact probe-sequence emulation."""
        if order == 1:
            return std_binary_search(self.mate2_name, name)
        if order == 2:
            return std_binary_search(self.mate1_name, name)
        return False

    # --- edges ---------------------------------------------------------
    def is_tandem(self) -> bool:
        return any(e.nodeid == self.nodeid for e in self.edges)

    def add_edge(self, nodeid: str, d: str, readid: int) -> None:
        if readid != -1:
            self.reads.add(readid)
        for e in self.edges:
            if e.nodeid == nodeid and e.dir == d:
                if readid != -1:
                    e.readids.append(readid)
                return
        ne = Edge(nodeid, d)
        if readid != -1:
            ne.readids.append(readid)
        self.edges.append(ne)

    def update_edge(self, oldid: str, olddir: str, newid: str, newdir: str) -> None:
        for e in self.edges:
            if e.nodeid == oldid and e.dir == olddir:
                e.nodeid = newid
                e.dir = newdir
                return
        raise AssertionError(f"update_edge: {self.nodeid} missing {olddir}:{oldid}")

    def remove_edge(self, nodeid: str, d: str) -> None:
        for i, e in enumerate(self.edges):
            if e.nodeid == nodeid and e.dir == d:
                del self.edges[i]
                return
        raise AssertionError(f"remove_edge: {self.nodeid} missing {d}:{nodeid}")

    def get_buddy(self, ori: str) -> int:
        """Index of unique edge in direction ori, else -1; specials and
        self-loops excluded (ref: Node.cc:235-266)."""
        if self.is_special():
            return -1
        retval = -1
        for i, e in enumerate(self.edges):
            if e.isdir(ori):
                if retval != -1:
                    return -1
                retval = i
        if retval != -1 and self.edges[retval].nodeid == self.nodeid:
            return -1
        return retval

    def degree(self, ori: str) -> int:
        return sum(1 for e in self.edges if e.isdir(ori))

    def mark_ref(self, ref, k: int) -> int:
        """Does any k-mer of this node occur in the reference window index
        (ref: Node.cc:271-295)."""
        from .mer import canonical

        if self.is_source or self.is_sink:
            return 1
        self.touch_ref = False
        for i in range(len(self.str_m) - k + 1):
            cmer, _ = canonical(self.str_m[i : i + k])
            if ref.has_mer(cmer):
                self.touch_ref = True
                return 1
        return 0

    # --- read starts ---------------------------------------------------
    def add_read_start(self, readid: int, nodeoffset: int, trim5: int, ori: str) -> None:
        self.readstarts.append([readid, nodeoffset, trim5, ori])

    def revreads(self) -> None:
        ln = self.strlen()
        for rs in self.readstarts:
            rs[1] = ln - 1 - rs[1]
            rs[3] = F if rs[3] == R else R

    def sort_read_starts(self) -> None:
        self.readstarts.sort(key=lambda rs: rs[1])

    def read_overlaps(self, other: "Node") -> int:
        return len(self.reads & other.reads)

    def cnt_read_code(self, code: str, readid2info) -> int:
        n = 0
        for rid in self.reads:
            if rid < 0 or rid > len(readid2info):
                continue
            if readid2info[rid].code == code:
                n += 1
        return n
