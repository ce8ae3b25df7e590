"""Synthetic tumor/normal corpora made from a seed: a random reference,
reads tiled over it with planted somatic events, written as FASTA + BAM.

`write_default_corpus` writes the benchmark's default corpus: 520 kb of
chr1 at about 40x in tumor and normal, 100 bp reads every 5 bp, one SNV or
indel (1-6 bp) every 2 kb at a tumor VAF of 0.5. Its region,
chr1:300-519700, gives 5,195 windows at the default window size and
padding. `hard_corpus` and `lr_corpus` copy the JAX benchmark's hard
(window families that climb the k ladder) and linked-reads (BX and HP
tags) corpora.
"""

from __future__ import annotations

import os
import random

from .io.aln import Aln
from .io.bam import write_bam
from .io.fasta import write_fasta

BASES = "ACGT"
_OTHER = {"A": "C", "C": "G", "G": "T", "T": "A"}

CHROM_LEN = 520_000
EVENT_SPACING = 2000
READ_LEN = 100
STEP = 5  # ~40x coverage, continuous over the chromosome


def make_reference(length: int, seed: int = 7) -> str:
    rng = random.Random(seed)
    return "".join(rng.choice(BASES) for _ in range(length))


def md_for(refseg: str, readseq: str) -> str:
    """MD tag for an all-M alignment."""
    out = []
    run = 0
    for r, q in zip(refseg, readseq):
        if r == q:
            run += 1
        else:
            out.append(str(run))
            out.append(r)
            run = 0
    out.append(str(run))
    return "".join(out)


def _md_from_cigar(refseq: str, pos0: int, cigar, readseq: str) -> str:
    """MD tag from CIGAR + sequences (M/I/D only)."""
    out = []
    run = 0
    rp = pos0
    qp = 0
    for op, ln in cigar:
        if op == "M":
            for i in range(ln):
                if refseq[rp + i] == readseq[qp + i]:
                    run += 1
                else:
                    out.append(str(run))
                    out.append(refseq[rp + i])
                    run = 0
            rp += ln
            qp += ln
        elif op == "I":
            qp += ln
        elif op == "D":
            out.append(str(run))
            out.append("^" + refseq[rp : rp + ln])
            run = 0
            rp += ln
    out.append(str(run))
    return "".join(out)


def hap_reads(refseq: str, edit, start0: int, end0: int, readlen: int,
              step: int, prefix: str, frac: float, seed: int,
              qual_char: str = "I", mapq: int = 60) -> list[Aln]:
    """Tile reads over [start0, end0); a `frac` fraction carries `edit`
    (('s', pos, base) | ('i', pos, seq) | ('d', pos, dellen)); reads not
    fully spanning the event fall back to reference reads."""
    rng = random.Random(seed)
    out = []
    i = 0
    for pos in range(start0, end0 - readlen + 1, step):
        flag = 0x10 if i % 2 else 0x0
        use_hap = edit is not None and rng.random() < frac
        name = f"{prefix}{i}"
        al = None
        if use_hap:
            kind, p, payload = edit
            if kind == "s":
                if pos <= p < pos + readlen:
                    seq = refseq[pos : pos + readlen]
                    seq = seq[: p - pos] + payload + seq[p - pos + 1 :]
                    cigar = [("M", readlen)]
                    al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                             qual=qual_char * readlen, cigar=cigar,
                             tags={"MD": ("Z", md_for(refseq[pos : pos + readlen], seq)),
                                   "RG": ("Z", "rg1")})
            elif kind == "i":
                ins = payload
                if pos < p and pos + readlen >= p + len(ins) + 1:
                    a = p - pos
                    seq = refseq[pos:p] + ins + refseq[p : p + readlen - a - len(ins)]
                    cigar = [("M", a), ("I", len(ins)), ("M", readlen - a - len(ins))]
                    al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                             qual=qual_char * readlen, cigar=cigar,
                             tags={"MD": ("Z", _md_from_cigar(refseq, pos, cigar, seq)),
                                   "RG": ("Z", "rg1")})
            elif kind == "d":
                dl = payload
                if pos < p and pos + readlen > p:
                    a = p - pos
                    seq = refseq[pos:p] + refseq[p + dl : p + dl + readlen - a]
                    cigar = [("M", a), ("D", dl), ("M", readlen - a)]
                    al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                             qual=qual_char * readlen, cigar=cigar,
                             tags={"MD": ("Z", _md_from_cigar(refseq, pos, cigar, seq)),
                                   "RG": ("Z", "rg1")})
        if al is None:
            seq = refseq[pos : pos + readlen]
            al = Aln(name=name, pos=pos, mapq=mapq, flag=flag, seq=seq,
                     qual=qual_char * readlen, cigar=[("M", readlen)],
                     tags={"MD": ("Z", str(readlen)), "RG": ("Z", "rg1")})
        out.append(al)
        i += 1
    return out


def write_pair(tmpdir: str, refseq: str, chrom: str, tumor: list[Aln],
               normal: list[Aln]):
    """Write reference FASTA + tumor/normal BAMs; returns paths."""
    ref_path = f"{tmpdir}/ref.fa"
    write_fasta(ref_path, {chrom: refseq})
    t_path = f"{tmpdir}/tumor.bam"
    n_path = f"{tmpdir}/normal.bam"
    write_bam(t_path, [(chrom, len(refseq))],
              [(0, a) for a in sorted(tumor, key=lambda a: a.pos)], sample="TUMOR")
    write_bam(n_path, [(chrom, len(refseq))],
              [(0, a) for a in sorted(normal, key=lambda a: a.pos)], sample="NORMAL")
    return ref_path, t_path, n_path


def default_corpus_reads(chrom_len: int = CHROM_LEN, seed: int = 2024,
                         ref_seed: int = 99):
    """(refseq, tumor, normal) of the default corpus; smaller `chrom_len`
    gives a prefix-shaped corpus of the same kind."""
    rng = random.Random(seed)
    refseq = make_reference(chrom_len, seed=ref_seed)
    tumor: list[Aln] = []
    normal: list[Aln] = []
    half = EVENT_SPACING // 2
    for idx, c in enumerate(range(half, chrom_len - half, EVENT_SPACING)):
        kind = rng.choice(["s", "s", "i", "d"])
        if kind == "s":
            edit = ("s", c, _OTHER[refseq[c]])
        elif kind == "i":
            edit = ("i", c, "".join(rng.choice(BASES)
                                    for _ in range(rng.randint(1, 6))))
        else:
            edit = ("d", c, rng.randint(1, 6))
        # contiguous segments -> continuous ~40x coverage chromosome-wide
        lo, hi = c - half, c + half
        tumor += hap_reads(refseq, edit, lo, hi, READ_LEN, STEP, f"t{idx}_",
                           0.5, 1000 + idx)
        normal += hap_reads(refseq, None, lo, hi, READ_LEN, STEP, f"n{idx}_",
                            0, 2000 + idx)
    return refseq, tumor, normal


def write_default_corpus(dirpath: str, chrom_len: int = CHROM_LEN) -> str:
    """Write the default corpus into `dirpath`; returns its region."""
    os.makedirs(dirpath, exist_ok=True)
    refseq, tumor, normal = default_corpus_reads(chrom_len)
    write_pair(dirpath, refseq, "chr1", tumor, normal)
    return f"chr1:300-{chrom_len - 300}"


LONG_CHROM = 9800


def long_window_corpus(seed: int = 5):
    """One 9.8 kb chromosome with reads tiled over all of it (~20x each
    sample, no segment edges, unlike the default corpus's 2 kb segments)
    and a 4 bp somatic deletion in its middle: at --window-size 9,000 the
    paths of its windows span ~9 kb, so its DP pairs pass 8,192 bases.
    Returns (refseq, tumor, normal, region); the region gives 4 windows."""
    refseq = make_reference(LONG_CHROM, seed=seed)
    edit = ("d", LONG_CHROM // 2, 4)
    tumor = hap_reads(refseq, edit, 0, LONG_CHROM, READ_LEN, STEP, "t", 0.5,
                      seed + 6)
    normal = hap_reads(refseq, None, 0, LONG_CHROM, READ_LEN, STEP, "n", 0,
                       seed + 7)
    return refseq, tumor, normal, "chr1:500-9300"


def repeat_windows(seed: int = 13, n: int = 48) -> list[str]:
    """Adversarial windows for the repeat gates: lengths 0, 1, 2, 5 and 12,
    then lengths up to 600; random sequence (with N and a lowercase base)
    or tandem repeats of a 1-8 bp unit with 0-4 substitutions, N
    included."""
    rng = random.Random(seed)
    lengths = [0, 1, 2, 5, 12, 600] + [rng.choice([rng.randint(5, 60),
                                                   rng.randint(60, 600)])
                                       for _ in range(n - 6)]
    out = []
    for i, ln in enumerate(lengths):
        if i % 2:
            unit = "".join(rng.choice(BASES) for _ in range(rng.randint(1, 8)))
            s = list((unit * (ln // len(unit) + 1))[:ln])
            for _ in range(rng.randint(0, 4)):
                if s:
                    s[rng.randrange(ln)] = rng.choice("ACGTN")
        else:
            s = [rng.choice("ACGTNa" if rng.random() < 0.1 else BASES)
                 for _ in range(ln)]
        out.append("".join(s))
    return out


# internal tandem duplications (a stretch inserted right after itself):
# (center, length). Their graphs hold a cycle at every k up to about the
# length, which the cycle screen flags and the exact cycle replay confirms,
# so the k ladder climbs past them.
ITD_EVENTS = ((13_000, 15), (15_000, 24))


def adversarial_corpus(itd: bool = True):
    """Hard windows -> (refseq, tumor, normal, region): one family every
    2 kb over 12 kb (STR runs, a near-repeat 24 bp duplication with one
    mismatch, a homopolymer, dense germline hets, a plain SNV), the JAX
    package's adversarial device-graph windows; with `itd`, also the
    ITD_EVENTS on a 16 kb reference (the first 12 kb unchanged)."""
    other = _OTHER
    base = list(make_reference(16_000 if itd else 12_000, seed=77))
    centers = list(range(1000, 11_000, 2000))
    for idx, c in enumerate(centers):
        fam = idx % 5
        if fam == 0:  # STR
            base[c - 60:c - 60 + 36] = "AC" * 18
            base[c + 20:c + 20 + 30] = "AGC" * 10
        elif fam == 1:  # near-repeat 24bp dup, 1 mismatch
            seg = list(base[c - 30:c - 6])
            seg[11] = other[seg[11]]
            base[c + 30:c + 54] = seg
        elif fam == 2:  # homopolymer
            base[c - 40:c - 16] = "A" * 24
    refseq = "".join(base)
    tumor, normal = [], []
    for idx, c in enumerate(centers):
        fam = idx % 5
        if fam == 0:
            edit = ("i", c + 21, "AGC")
        elif fam == 2:
            edit = ("d", c - 30, 1)
        else:
            edit = ("s", c, other[refseq[c]])
        tumor += hap_reads(refseq, edit, c - 700, c + 700, 100, 5,
                           f"t{idx}_", 0.5, 100 + idx)
        normal += hap_reads(refseq, None, c - 700, c + 700, 100, 5,
                            f"n{idx}_", 0, 200 + idx)
        if fam == 3:  # dense germline hets -> bubbles at every k
            for j, off in enumerate((-90, -33, 54)):
                e = ("s", c + off, other[refseq[c + off]])
                tumor += hap_reads(refseq, e, c + off - 140, c + off + 140,
                                   100, 11, f"tx{idx}_{j}_", 0.5, 300 + j)
                normal += hap_reads(refseq, e, c + off - 140, c + off + 140,
                                    100, 11, f"nx{idx}_{j}_", 0.5, 400 + j)
    if not itd:
        return refseq, tumor, normal, "chr1:400-11600"
    for idx, (c, n) in enumerate(ITD_EVENTS):
        tumor += hap_reads(refseq, ("i", c, refseq[c - n:c]), c - 700,
                           c + 700, 100, 5, f"ti{idx}_", 0.5, 500 + idx)
        normal += hap_reads(refseq, None, c - 700, c + 700, 100, 5,
                            f"ni{idx}_", 0, 600 + idx)
    return refseq, tumor, normal, "chr1:400-15600"


HARD_CHROM_LEN = 200_000
HARD_FAMILIES = ("str", "nearrep", "homopoly", "dense", "highcov", "plain",
                 "dup70")


def hard_corpus():
    """The JAX benchmark's hard corpus (`bench.py:82-172`) -> (refseq,
    tumor, normal, region): a 200 kb chromosome with one window family
    every 2 kb, in the order of HARD_FAMILIES: STR runs around a unit
    insertion, a 24 bp near-repeat duplication, a homopolymer with a 1 bp
    deletion, a forest of germline het SNVs, a ~100x coverage spike, a
    plain SNV, and an exact 70 bp tandem duplication (also ~100x). The
    region, chr1:300-199700, gives 1,995 windows."""
    base = list(make_reference(HARD_CHROM_LEN, seed=555))
    half = EVENT_SPACING // 2
    centers = list(range(half, HARD_CHROM_LEN - half, EVENT_SPACING))
    fams = [HARD_FAMILIES[idx % 7] for idx in range(len(centers))]
    for c, fam in zip(centers, fams):
        if fam == "str":  # (AC)x18 and (AGC)x10 flanking the event
            base[c - 60:c - 60 + 36] = "AC" * 18
            base[c + 20:c + 20 + 30] = "AGC" * 10
        elif fam == "nearrep":  # a 24 bp block 60 bp on, 1 mismatch
            seg = list(base[c - 30:c - 6])
            seg[11] = _OTHER[seg[11]]
            base[c + 30:c + 30 + 24] = seg
        elif fam == "homopoly":
            base[c - 40:c - 16] = "A" * 24
        elif fam == "dup70":  # the 70 bp before c - 80, repeated
            base[c - 80:c - 10] = base[c - 150:c - 80]
    refseq = "".join(base)
    tumor: list[Aln] = []
    normal: list[Aln] = []
    for idx, (c, fam) in enumerate(zip(centers, fams)):
        lo, hi = c - half, c + half
        step, extra_edits = STEP, []
        if fam == "str":
            edit = ("i", c + 21, "AGC")  # a unit insertion inside the STR
        elif fam == "dup70":
            edit = ("s", c + 40, _OTHER[refseq[c + 40]])
            step = 2
        elif fam == "nearrep":
            edit = ("s", c + 60, _OTHER[refseq[c + 60]])
        elif fam == "homopoly":
            edit = ("d", c - 30, 1)
        elif fam == "dense":
            edit = ("s", c, _OTHER[refseq[c]])
            extra_edits = [("s", c + off, _OTHER[refseq[c + off]])
                           for off in (-90, -60, -33, 27, 54, 81)]
        elif fam == "highcov":
            edit = ("s", c, _OTHER[refseq[c]])
            step = 2
        else:
            edit = ("s", c, _OTHER[refseq[c]])
        tumor += hap_reads(refseq, edit, lo, hi, READ_LEN, step,
                           f"t{idx}_", 0.5, 3000 + idx)
        for j, e in enumerate(extra_edits):
            # germline hets: in both samples, so no somatic call
            tumor += hap_reads(refseq, e, max(lo, e[1] - 140),
                               min(hi, e[1] + 140), READ_LEN, 11,
                               f"tx{idx}_{j}_", 0.5, 4000 + 7 * idx + j)
            normal += hap_reads(refseq, e, max(lo, e[1] - 140),
                                min(hi, e[1] + 140), READ_LEN, 11,
                                f"nx{idx}_{j}_", 0.5, 5000 + 7 * idx + j)
        normal += hap_reads(refseq, None, lo, hi, READ_LEN, step,
                            f"n{idx}_", 0, 6000 + idx)
    return refseq, tumor, normal, f"chr1:300-{HARD_CHROM_LEN - 300}"


def hard_family(pos: int) -> str:
    """The family of the hard corpus's event site nearest to `pos`."""
    idx = min(max(round((pos - EVENT_SPACING // 2) / EVENT_SPACING), 0),
              (HARD_CHROM_LEN - EVENT_SPACING) // EVENT_SPACING - 1)
    return HARD_FAMILIES[idx % 7]


LR_CHROM_LEN = 60_000


def lr_corpus():
    """The JAX benchmark's linked-reads corpus (`bench.py:179-216`) ->
    (refseq, tumor, normal, region): a 60 kb chromosome with a somatic SNV
    every 2 kb, every read tagged with a BX barcode (one of 6) and an HP
    haplotype (2 on reads that carry the alternate base, else 1; 0 for a
    fifth of the reads). The region, chr1:300-59700, gives 595 windows."""
    rng = random.Random(909)
    refseq = make_reference(LR_CHROM_LEN, seed=808)
    tumor: list[Aln] = []
    normal: list[Aln] = []
    half = EVENT_SPACING // 2
    for idx, c in enumerate(range(half, LR_CHROM_LEN - half,
                                  EVENT_SPACING)):
        edit = ("s", c, _OTHER[refseq[c]])
        t = hap_reads(refseq, edit, c - half, c + half, READ_LEN, STEP,
                      f"t{idx}_", 0.5, 7000 + idx)
        n = hap_reads(refseq, None, c - half, c + half, READ_LEN, STEP,
                      f"n{idx}_", 0, 8000 + idx)
        for al in t + n:
            off = c - al.pos
            has_alt = 0 <= off < READ_LEN and al.seq[off] != refseq[c]
            bc = rng.randrange(6)
            al.tags["BX"] = ("Z", f"BX{bc:03d}-1")
            al.tags["HP"] = ("i", (2 if has_alt else 1)
                             if rng.random() < 0.8 else 0)
        tumor += t
        normal += n
    return refseq, tumor, normal, f"chr1:300-{LR_CHROM_LEN - 300}"
