"""Window generation (ref: src/Lancet.cc:189-362).

Regions (chr:start-end, bare chromosome, or BED rows) are padded ±PADDING,
clamped to [1, chrlen], fetched from the FASTA, uppercased with IUPAC
ambiguity codes mapped to N, and sliced into WINDOW_SIZE-bp windows
advancing 100 bp (500 bp overlap at defaults). Windows are assigned
round-robin to `num_threads` shards, and each shard's windows are keyed by
"chr:start-end" and processed in lexicographic order — both match the
reference's per-thread std::map reftables.
"""

from __future__ import annotations

from dataclasses import dataclass

from .engine.ref import Ref
from .engine.seqs import is_ambiguous


@dataclass
class Window:
    chrom: str
    refstart: int  # 1-based inclusive (reference convention)
    refend: int
    rawseq: str

    @property
    def name(self) -> str:
        return f"{self.chrom}:{self.refstart}-{self.refend}"

    def make_ref(self, k: int) -> Ref:
        r = Ref(k)
        r.refchr = self.chrom
        r.refstart = self.refstart
        r.refend = self.refend
        r.hdr = self.name
        r.seq = self.rawseq
        r.rawseq = self.rawseq
        return r


def _clean(s: str) -> str:
    out = []
    for ch in s:
        ch = ch.upper()
        if is_ambiguous(ch):
            ch = "N"
        out.append(ch)
    return "".join(out)


def parse_region(region: str, chrom_lengths: dict[str, int], padding: int):
    """-> (chrom, start, end) with padding and clamping (Lancet.cc:199-243)."""
    if ":" not in region:
        chrom = region
        start = 1
        end = chrom_lengths.get(chrom)
        if end is None:
            raise ValueError(f"chromosome label {chrom} not found")
        return chrom, start, end
    chrom, rng = region.split(":", 1)
    s, e = rng.split("-", 1)
    sp = int(s) - padding
    ep = int(e) + padding
    if sp < 1:
        sp = 1
    if chrom in chrom_lengths and ep > chrom_lengths[chrom]:
        ep = chrom_lengths[chrom]
    return chrom, sp, ep


def windows_from_sequence(chrom: str, start: int, seq: str,
                          window_size: int = 600, delta: int = 100) -> list[Window]:
    """Slice a padded region sequence into overlapping windows
    (ref: Lancet.cc:265-311). The final window drops the last base
    (LEN = len-offset-1), matching the reference."""
    s = _clean(seq)
    out: list[Window] = []
    end = len(s)
    offset = 0
    while offset < end:
        ln = window_size
        if offset + window_size >= len(s):
            ln = len(s) - offset - 1
            end = offset  # last window
        ss = s[offset : offset + ln]
        w = Window(chrom=chrom, refstart=start + offset,
                   refend=start + offset + ln, rawseq=ss)
        out.append(w)
        offset += delta
    return out


def generate_windows(fasta, regions: list[str], chrom_lengths: dict[str, int],
                     window_size: int, padding: int) -> list[Window]:
    """Windows for a list of region strings, in generation order."""
    out: list[Window] = []
    for region in regions:
        chrom, sp, ep = parse_region(region, chrom_lengths, padding)
        seq = fasta.fetch(chrom, sp, ep)  # 1-based inclusive
        out.extend(windows_from_sequence(chrom, sp, seq, window_size))
    return out


def shard_windows(windows: list[Window], num_shards: int) -> list[list[Window]]:
    """Round-robin assignment in generation order (ref: Lancet.cc:305-310)."""
    shards: list[list[Window]] = [[] for _ in range(num_shards)]
    for i, w in enumerate(windows):
        shards[i % num_shards].append(w)
    return shards
