"""Experimental k-mer recovery for tumor singletons
(ref: src/ErrorCorrector.hh:38-134, enabled by --kmer-recovery,
Microassembler.cc:137-140).

For each tumor-singleton node, every zero-quality base position is
mutated through the other bases; Hamming-1 neighbor mers (fwd and rc)
with support >= min_support and quality coverage at the position get a
coverage bump on the singleton's strand. Mutations are applied while
iterating the node map in libstdc++ order (effects cascade, order
matters) — including the reference's quirk that a base equal to the
current value leaves the probe mer unchanged (duplicate search).
"""

from __future__ import annotations

from .node import FWD, REV, TMR
from .seqs import rc_str

_BP = "ACGT"


def mers_recovery(graph, min_support: int, min_qv: int) -> None:
    for key in list(graph.nodes.keys()):
        node_a = graph.nodes.get(key)
        if node_a is None:
            continue
        if node_a.tot_tmr_cov() != 1:
            continue
        mer_a = list(key)
        for i in range(len(mer_a)):
            qv_cov_a = int(node_a.cov_distr_tmr[i, 2] + node_a.cov_distr_tmr[i, 3])
            if qv_cov_a != 0:
                continue
            old_bp = mer_a[i]
            for j in range(4):
                if _BP[j] != mer_a[i]:
                    mer_a[i] = _BP[j]
                probe = "".join(mer_a)
                probe_rc = rc_str(probe)
                node_f = graph.nodes.get(probe)
                node_r = graph.nodes.get(probe_rc)
                if node_f is not None and probe != key:
                    qv_cov_b = int(node_f.cov_distr_tmr[i, 2] + node_f.cov_distr_tmr[i, 3])
                    if node_f.tot_tmr_cov() >= min_support and qv_cov_b > 0:
                        strand = FWD if node_a.get_cov(FWD, TMR) > 0 else REV
                        node_f.inc_cov(strand, TMR)
                if node_r is not None and probe_rc != key:
                    m = len(probe_rc) - 1
                    qv_cov_b = int(node_r.cov_distr_tmr[m - i, 2] + node_r.cov_distr_tmr[m - i, 3])
                    if node_r.tot_tmr_cov() >= min_support and qv_cov_b > 0:
                        strand = FWD if node_a.get_cov(FWD, TMR) > 0 else REV
                        node_r.inc_cov(strand, TMR)
            mer_a[i] = old_bp
