"""Canonical k-mers (ref: src/Mer.hh).

A canonical mer is the lexicographic min of (mer, revcomp(mer)); orientation
is F when the forward form wins, R otherwise (palindromes get R, matching the
reference's strict `<` at Mer.hh:62).
"""

from __future__ import annotations

from .seqs import rc_str

F = "F"
R = "R"


def canonical(mer: str) -> tuple[str, str]:
    """Return (canonical_mer, orientation)."""
    rmer = rc_str(mer)
    if mer < rmer:
        return mer, F
    return rmer, R


def flip_dir(d: str) -> str:
    return F if d == R else R
