"""Crafted inputs for the repeat-gate kernel of csrc/repeats.cu
(`repeat_gates`): windows whose exact and near repeats sit at the edges of
its tiles (multiples of 32 starts, the tile lengths gates_plan picks), at
the end of a tile's halo (kmax + 1 positions past its last start) and at
the ends of the two regions a shift s holds (an exact window ends before
len-1-s, an almost window before len-s); mismatch budgets -1, 0, 1, 2, 7,
8 and 40; k lists with 0, 64, 101, duplicates and unsorted; k lists whose
widest window takes each count of mismatch words and the plain scan; and
window lengths 0, 1, 2, 63, 64, 65, 600 and ~9,000.
`tests/test_torch_gatecases.py` holds `gates_plain` on every case against
the JAX package, and `chip_smoke.py` the kernel against `gates_plain` on
the card.

Each case is a dict: `windows` (latin-1 strings), `ks` and `mm`.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"
MISMATCHES = (-1, 0, 1, 2, 7, 8, 40)
ODD_KS = [64, 0, 13, 13, 101, 1, 2, 31, 32, 33, 65]  # unsorted, a duplicate
DEFAULT_KS = list(range(11, 102, 2))  # Config min_k..max_k, step 2
EDGE_KS = [101, 0, 64, 64, 12, 11]
LONG = 9000  # a user's --window-size 9,000


def _rand(rng, n: int) -> list:
    return list(rng.choice(list(BASES), n))


def _other(c: str) -> str:
    return BASES[(BASES.index(c) + 1) % 4] if c in BASES else "A"


def plant(row: list, p: int, s: int, length: int, n_mis: int = 0,
          rng=None, after: bool = False) -> list:
    """Make row[p + s + j] equal row[p + j] for j < length, position by
    position (a copy overlapping its source repeats with period s), so the
    mismatch bits of shift s are 0 on [p, p + length); then change n_mis
    of the copied bases (a copy that does not overlap its source: s >=
    length), away from the ends. The bits at p - 1 and p + length are made
    1, so the run is exactly [p, p + length), unless `after`, where the
    bit at p + length is made 0 (the run would go on, were it not for an
    edge there)."""
    for j in range(length):
        row[p + s + j] = row[p + j]
    if n_mis:
        assert s >= length
        lo, hi = length // 4, length - length // 4
        for j in rng.choice(np.arange(lo, hi), n_mis, replace=False):
            row[p + s + j] = _other(row[p + j])
    if p >= 1:
        row[p - 1] = _other(row[p + s - 1])
    if p + s + length < len(row):
        row[p + s + length] = (row[p + length] if after
                               else _other(row[p + length]))
    return row


def _near(rng, n: int, spec) -> str:
    """A random window of length n with plants (p, s, length, n_mis,
    after)."""
    row = _rand(rng, n)
    for p, s, length, n_mis, after in spec:
        plant(row, p, s, length, n_mis, rng, after)
    return "".join(row)


def _short_windows(rng) -> list:
    """Lengths 0, 1, 2, 3 and 63-65: random, a homopolymer, a period-2
    repeat, N and lowercase bases, NUL bytes (equal to the zero pad past a
    window in the kernel's shared memory), and windows whose last shift or
    last start holds the only repeat."""
    out = ["", "A", "AA", "AC", "AAA", "ACG"]
    for n in (63, 64, 65):
        out += ["".join(_rand(rng, n)), "A" * n,
                "AC" * (n // 2) + "A" * (n % 2),
                "".join(rng.choice(list("ACGTNa"), n)),
                "".join(_rand(rng, n - 3)) + "\0\0\0",
                # the largest shift: position 0 against the last base
                "G" + "".join(rng.choice(list("ACT"), n - 2)) + "G",
                _near(rng, n, [(0, 1, n - 1, 0, False)]),
                _near(rng, n, [(n - 40, 20, 20, 0, False)]),
                _near(rng, n, [(3, 30, 30, 2, False)])]
    return out


def _edge_windows(rng, n: int, G: int) -> list:
    """Windows of length n whose repeats straddle multiples of G starts
    (a tile's edge for tiles of G and of every divisor of G that is a
    multiple of 32) and end at or past the halo of a tile (kmax + 1 = 102
    positions after its last start, for the default k ladder): runs of 11
    to 102 bases starting at G - 1, G and G + 1, at shifts 1, 7, 64 and
    n - G - 120, exact and with 1-3 mismatches."""
    out = []
    for s in (1, 7, 64, n - G - 120):
        for p, length, n_mis in ((G - 1, 12, 0), (G, 33, 1), (G + 1, 64, 2),
                                 (G - 1, 101, 0), (G - 31, 102, 3),
                                 (G - 2, 65, 2)):
            if n_mis and s < length:
                n_mis = 0
            if p + s + length + 1 < n:
                out.append(_near(rng, n, [(p, s, length, n_mis, False)]))
    return out


def _region_windows(rng, n: int) -> list:
    """Runs that end exactly at n-1-s (the last exact window; the next bit,
    at n-1-s, is a match, so only the edge stops the run) and at n-s (the
    last almost window), for shifts 1, 2, 37, n // 2 and n - 20, exact and
    with 2 mismatches."""
    out = []
    for s in (1, 2, 37, n // 2, n - 20):
        for length in (11, 13, 64):
            if length + s + 1 > n:
                continue
            # the exact run [n-1-s-length, n-1-s), then a match at n-1-s
            out.append(_near(rng, n, [(n - 1 - s - length, s, length, 0,
                                       True)]))
            # the almost stretch ends at n-s: the copy's last base is the
            # window's last
            n_mis = 2 if s >= length else 0
            out.append(_near(rng, n, [(n - s - length, s, length, n_mis,
                                       False)]))
    return out


def gate_cases() -> dict:
    """name -> {windows, ks, mm}."""
    rng = np.random.default_rng(2026)
    cases = {}
    short = _short_windows(rng)
    for mm in MISMATCHES:
        cases[f"short_mm{mm}"] = dict(windows=short, ks=ODD_KS, mm=mm)
    edges = (_edge_windows(rng, 600, 128) + _edge_windows(rng, 600, 256)
             + ["".join(_rand(rng, 600))])
    cases["tile_edges_default_ks"] = dict(windows=edges, ks=DEFAULT_KS,
                                          mm=2)
    cases["tile_edges_mm0"] = dict(windows=edges, ks=EDGE_KS, mm=0)
    cases["tile_edges_mm8"] = dict(windows=edges, ks=EDGE_KS, mm=8)
    region = _region_windows(rng, 600) + _region_windows(rng, 65)
    for mm in (0, 2):
        cases[f"region_edges_mm{mm}"] = dict(windows=region,
                                             ks=[13, 11, 64, 12, 65, 0],
                                             mm=mm)
    # the widest window of a k list decides the words a thread holds: 32
    # (two words), 64 (three), 96 (four), 127 and 128 (five; 128 without a
    # budget), then 129 (the plain scan), on windows with runs of those
    # lengths
    wide = [_near(rng, 600, [(40, 150, length, 0, False)])
            for length in (31, 32, 63, 64, 95, 96, 126, 127, 128, 129, 200)]
    for ks, mm in (([31, 0], 1), ([63, 11], 8), ([95, 12], 2),
                   ([126, 11], 7), ([127, 13], -1), ([128, 127], 0),
                   ([150, 11, 200], 2)):
        cases[f"widest_k{max(ks)}_mm{mm}"] = dict(windows=wide, ks=ks, mm=mm)
    # ~9,000-base windows: repeats across multiples of 1,024 starts and at
    # the regions' ends of a shift of 701
    longw = [_near(rng, LONG, [(8191, 701, 64, 0, False)]),
             _near(rng, LONG - 1, [(1023, 5000, 101, 2, False),
                                   (LONG - 1 - 701 - 40, 701, 40, 0,
                                    True)]),
             "".join(_rand(rng, LONG - 2))]
    cases["long_window"] = dict(windows=longw, ks=[101, 0, 64], mm=2)
    return cases


def run_case(c: dict, dev="cpu", work=None):
    """A case through the port's repeats.gates on `dev`: (gates, exact)
    bool [W, nk] on `dev`."""
    import torch

    from . import repeats

    seq, lens = repeats.pack(c["windows"])
    return repeats.gates(torch.from_numpy(seq).to(dev),
                         torch.from_numpy(lens).to(dev), c["ks"], c["mm"],
                         work)
