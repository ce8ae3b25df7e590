"""Crafted and seeded inputs for the two screens of csrc/screens.cu.

`tandem_batch()`: candidate strings for `tandem_at` (the findTandems
position probe) at the short-link guard's width (L 64): lens 0, 1, 63, 64
and past L (where the sentinels of two indices past L alias modulo 97),
unfilled slots (code 99) inside lens, N (4) runs, homopolymers and 2-, 3-
and 4-base repeats ending before, at and after the probed position,
non-primitive units (ATAT inside a 4-mer scan), repeats from position 0
(the offset - 1 sentinel) and to the end of the string (the i + j + 1 ==
lens break), repeats at the report thresholds, repeats that only the
positions of phase m - 1 of their unit length m report (each other phase
sees one unit fewer), units of 5 to 8 bases (the engine's unit length is
4; TANDEM_PARAMS holds 8 too), probed rows among rows of length 0 whose
codes would hit, repeats running past L with lens around L +
max_unit_len + 1 (where the kernel caps lens), and seeded random strings
of low entropy.

`screen_batch()`: graphs for `cycle_screen` in the compact state's layout
(items [0, N) regular, component c's anchors N + 2(c - 1) and N + 2(c - 1)
+ 1, special): a chain longer than T edges (the reach does not converge),
a peel deeper than T layers, an item reached in both orientations, a
cycle, components labelled above Cmax and at or below 0, dead and padded
(-1) edges, dead anchors, a reach that needs more rounds than its peel and
the reverse, a state reached by two frontier edges in one round, an
in-degree brought to 0 by two edges (and a duplicate) in one round, reach
chains of 4, 5 and 6 rounds and peels of 5 and 6 layers (T 5 equal to and
one below them), and seeded random graphs.

`tests/test_torch_screens.py` holds the plain versions on these batches
against the JAX package and a replay of each kernel's loop, and
`chip_smoke.py` the kernels against the plain versions on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .walkcases import FF, FR, RF, RR

L_TANDEM = 64  # gpu/pipeline.py _SL_CAP
TANDEM_POS = 20  # K - 1 at K 21
# (pos, max_unit_len, min_report_units, min_report_len, dist_from_str):
# the engine's (config.py) at K 21 first, then other positions and
# parameters the kernels are held at
TANDEM_PARAMS = ((TANDEM_POS, 4, 3, 7, 1), (0, 4, 3, 7, 1), (63, 4, 3, 7, 1),
                 (40, 2, 2, 4, 0), (20, 8, 3, 7, 2), (20, 1, 3, 7, 1),
                 (20, 0, 3, 7, 1), (-3, 5, 0, 0, 5), (100, 3, 1, 1, 40))
SCREEN_ROUNDS = (32, 0, 1, 5, 40)  # cycle_screen's T: the engine's first
A, C, G, T, NN, UNFILLED = 0, 1, 2, 3, 4, 99


def _row(codes, lens=None, L=L_TANDEM, fill=UNFILLED):
    """A row of L codes: `codes` from position 0, `fill` after; its lens
    (len(codes) unless given)."""
    row = np.full(L, fill, np.int64)
    codes = np.asarray(codes, np.int64)[:L]
    row[:len(codes)] = codes
    return row, len(codes) if lens is None else lens


def _bg(rng, n, avoid=()):
    """n random bases from A, C, G, T."""
    out = rng.integers(0, 4, n)
    for a in avoid:
        out[out == a] = (a + 1) % 4
    return list(out)


def tandem_batch(seed: int = 3, n_random: int = 96):
    """(seqs [B, L_TANDEM] int64, lens [B] int64, names [B]) of crafted rows
    around TANDEM_POS, then n_random seeded rows."""
    rng = np.random.default_rng(seed)
    P = TANDEM_POS
    rows, names = [], []

    def add(name, codes, lens=None):
        r, n = _row(codes, lens)
        rows.append((r, n))
        names.append(name)

    for n in (0, 1, 2, 7, 8, 9, 63, 64):
        add(f"lens_{n}", _bg(rng, n))
    # lens past L: the scan runs to L, i + jj < lens stays true past L and
    # two out-of-range sentinels 97 apart compare equal
    for n in (65, 70, 100, 161, 200, 1 << 40):
        add(f"lens_{n}", _bg(rng, L_TANDEM), n)
        add(f"lens_{n}_homopolymer_tail",
            _bg(rng, 40) + [A] * (L_TANDEM - 40), n)
    add("lens_negative", _bg(rng, 30), -5)
    add("unfilled_inside_lens", _bg(rng, 12) + [UNFILLED] * 14 + _bg(rng, 20))
    add("unfilled_run_at_pos", _bg(rng, P - 5) + [UNFILLED] * 12
        + _bg(rng, 30), 60)
    add("n_run_at_pos", _bg(rng, P - 6) + [NN] * 10 + _bg(rng, 30))
    add("odd_codes", [5, 6, 5, 6, 5, 6, 5, 6, 7, 300, 301, 300, 301, 300,
                      301, 300, 301] + _bg(rng, 30))
    for unit in ([A], [A, C], [A, C, G], [A, C, G, T], [C, A, A], [G, G, T, T]):
        u = len(unit)
        for units in (2, 3, 4, 6):
            for end in (P - 3, P - 2, P - 1, P, P + 1, P + 2, P + 3):
                n = u * units
                start = end - n
                if start < 0:
                    continue
                codes = (_bg(rng, start, avoid=unit[-1:]) + unit * units
                         + _bg(rng, 25, avoid=unit[:1]))
                add(f"unit{''.join('ACGT'[b] for b in unit)}_x{units}"
                    f"_end{end - P:+d}", codes)
            for start in (P - 1, P, P + 1, P + 2):
                codes = (_bg(rng, start, avoid=unit[-1:]) + unit * units
                         + _bg(rng, 25, avoid=unit[:1]))
                add(f"unit{''.join('ACGT'[b] for b in unit)}_x{units}"
                    f"_start{start - P:+d}", codes)
    # non-primitive units: ATAT is AT twice; AAAA is A four times
    for reps in (3, 4, 5, 8):
        add(f"atat_x{reps}", _bg(rng, 10) + [A, T, A, T] * reps
            + _bg(rng, 20))
        add(f"aaca_x{reps}", _bg(rng, 12) + [A, A, C, A] * reps
            + _bg(rng, 20))
    # from position 0 (offset - 1 is the -1 sentinel) and to the end of
    # the string (the i + j + 1 == lens break)
    for n in (6, 7, 8, 12, 22, 30):
        add(f"homopolymer_from_0_len{n}", [G] * n + _bg(rng, 30, avoid=[G]))
        add(f"dinuc_to_end_len{n}", _bg(rng, 15) + [A, G] * (n // 2))
        add(f"whole_row_{n}", [C, T] * (n // 2))
    add("whole_row_homopolymer_64", [T] * 64)
    add("whole_row_homopolymer_64_lens_97", [T] * 64, 97)
    add("trinuc_whole_row", [A, C, G] * 21 + [A])
    # at the thresholds: 7 bp and 3 units
    for n in (5, 6, 7, 8):
        add(f"homopolymer_len{n}_at_pos", _bg(rng, P - 3, avoid=[C])
            + [C] * n + _bg(rng, 20, avoid=[C]))
    add("dinuc_3_units_at_pos", _bg(rng, P - 2) + [G, C] * 3 + _bg(rng, 20))
    add("dinuc_4_units_at_pos", _bg(rng, P - 2) + [G, C] * 4 + _bg(rng, 20))
    add("tetranuc_2_units", _bg(rng, P - 4) + [A, C, G, T] * 2
        + _bg(rng, 20))
    add("near_pos_two_tandems", [A] * 9 + [C, G] * 5 + [T] * 9
        + _bg(rng, 30))
    # a repeat of unit length m from s = m - 1 (mod m): the positions of
    # phase m - 1 see `units` units, every other phase one fewer, which the
    # report thresholds (3 units, 7 bases) refuse
    for unit, units, start in (([A, C], 4, P - 3), ([A, C, G], 3, P - 3),
                               ([A, C, G, T], 3, P - 5)):
        add(f"phase_m_minus_1_only_unit{''.join('ACGT'[b] for b in unit)}",
            _bg(rng, start, avoid=unit[-1:]) + unit * units
            + _bg(rng, 30, avoid=unit[:1]))
    # units of 5 to 8 bases around the probed position, at each phase
    for unit in ([A, C, G, T, T], [A, A, C, G, T, G], [C, A, T, G, G, A, T],
                 [A, C, G, T, A, G, C, C]):
        u = len(unit)
        for start in (P - u, P - u + 1, P - 2, P):
            add(f"unit{u}_x3_start{start - P:+d}",
                _bg(rng, start, avoid=unit[-1:]) + unit * 3
                + _bg(rng, 20, avoid=unit[:1]))
    # probed rows among rows of length 0 whose codes would hit
    for k in range(24):
        if k in (7, 8, 15, 23):
            add(f"probed_among_empty_{k}", _bg(rng, P - 4) + [G, T] * 5
                + _bg(rng, 30))
        else:
            add(f"empty_homopolymer_{k}", [T] * 64, 0)
    # a repeat running past L, lens around L + max_unit_len + 1 (69 at
    # unit length 4, 73 at 8: past it the kernel caps lens)
    for n in (66, 67, 68, 69, 70, 72, 73, 74):
        add(f"lens_{n}_dinuc_tail", _bg(rng, 44) + [C, T] * 10, n)
        add(f"lens_{n}_tetranuc_tail", _bg(rng, 40) + [A, C, G, T] * 6, n)
    # seeded rows of low entropy: runs and repeats from a few letters
    alphabets = ([A, C], [A, C, G, T], [A, A, A, C], [A, C, NN],
                 [A, C, UNFILLED], [G, T, T])
    for k in range(n_random):
        alpha = alphabets[k % len(alphabets)]
        codes: list = []
        while len(codes) < L_TANDEM:
            if rng.random() < 0.5:
                u = int(rng.integers(1, 6))
                unit = list(rng.choice(alpha, u))
                codes += unit * int(rng.integers(1, 7))
            else:
                codes += list(rng.choice(alpha, int(rng.integers(1, 6))))
        n = int(rng.choice([rng.integers(0, 65), L_TANDEM,
                            rng.integers(65, 260)]))
        add(f"random_{k}", codes[:L_TANDEM], n)
    seqs = np.stack([r for r, _ in rows])
    lens = np.array([n for _, n in rows], np.int64)
    return seqs, lens, names


def codes_str(row, n: int) -> str | None:
    """A row's first n codes as the host engine's string (A, C, G, T, N and
    X for an unfilled slot), or None where a code has no letter."""
    letters = {A: "A", C: "C", G: "G", T: "T", NN: "N", UNFILLED: "X"}
    out = [letters.get(int(c)) for c in row[:n]]
    return None if None in out else "".join(out)


# ---------------------------------------------------------------------------
# cycle_screen
# ---------------------------------------------------------------------------

SCREEN_N, SCREEN_CMAX, SCREEN_EE = 64, 4, 160


def _window(N=SCREEN_N, Cmax=SCREEN_CMAX, EE=SCREEN_EE):
    NI = N + 2 * Cmax
    w = dict(e_src=np.zeros(EE, np.int64), e_dst=np.zeros(EE, np.int64),
             e_dir=np.zeros(EE, np.int64), e_alive=np.zeros(EE, bool),
             alive=np.zeros(NI, bool), special=np.zeros(NI, bool),
             comp=np.zeros(NI, np.int64))
    w["special"][N:] = True
    return w


def _edges(w, edges, start=0):
    for i, (s, d, r) in enumerate(edges, start):
        w["e_src"][i], w["e_dst"][i], w["e_dir"][i] = s, d, r
        w["e_alive"][i] = True
    return start + len(edges)


def _comp(w, items, c, N=SCREEN_N):
    """Items and component c's two anchors alive, labelled c."""
    for v in list(items) + [N + 2 * (c - 1), N + 2 * (c - 1) + 1]:
        w["alive"][v] = True
        w["comp"][v] = c


def _chain_edges(nodes, d=FF):
    return [(a, b, d) for a, b in zip(nodes, nodes[1:])]


def screen_windows(seed: int = 5, n_random: int = 20) -> dict:
    """{name: window dict} of crafted windows, then n_random seeded ones."""
    N, Cm = SCREEN_N, SCREEN_CMAX
    src = [N + 2 * c for c in range(Cm)]  # component c + 1's source
    snk = [N + 2 * c + 1 for c in range(Cm)]
    out = {}

    w = _window()  # a chain of 40 edges: the reach needs 40 rounds
    _comp(w, range(40), 1)
    _edges(w, _chain_edges([src[0]] + list(range(40)) + [snk[0]]))
    out["chain_past_T"] = w

    w = _window()  # a chain of 31 edges: converges in T
    _comp(w, range(30), 1)
    _edges(w, _chain_edges([src[0]] + list(range(30)) + [snk[0]]))
    out["chain_within_T"] = w

    w = _window()  # a peel of 40 layers: the anchor reaches only the end
    _comp(w, range(40), 2)
    n = _edges(w, _chain_edges(list(range(40))))
    _edges(w, [(src[1], 39, FF), (39, snk[1], FF)], n)
    out["peel_past_T"] = w

    w = _window()  # item 3 reached as F and as R
    _comp(w, range(6), 1)
    _edges(w, [(src[0], 0, FF), (0, 1, FF), (1, 3, FF), (src[0], 2, FF),
               (2, 3, FR), (3, snk[0], FF)])
    out["dual_orientation"] = w

    w = _window()  # a directed cycle 1 -> 2 -> 3 -> 1 reached from 0
    _comp(w, range(5), 1)
    _edges(w, [(src[0], 0, FF), (0, 1, FF), (1, 2, FF), (2, 3, FF),
               (3, 1, FF), (3, 4, FF), (4, snk[0], FF)])
    out["cycle"] = w

    w = _window()  # an unreached cycle, a clean component beside it
    _comp(w, range(4), 1)
    _comp(w, range(10, 14), 2)
    _edges(w, [(src[0], 0, FF), (0, 1, FF), (1, snk[0], FF), (2, 3, FF),
               (3, 2, FF), (src[1], 10, RR), (10, 11, RR), (11, 12, RF),
               (12, 13, FF), (13, snk[1], FF)])
    out["unreached_cycle"] = w

    w = _window()  # components above Cmax and at or below 0
    _comp(w, range(6), 1)
    for v, c in ((2, Cm + 1), (3, Cm + 3), (4, 0), (5, -2)):
        w["comp"][v] = c
    _edges(w, [(src[0], 0, FF), (0, 1, FF), (1, 0, FF), (1, 2, FF),
               (2, 3, FF), (3, 2, FF), (3, 4, FF), (4, 5, FF), (5, 4, FF)])
    out["comp_labels"] = w

    w = _window()  # dead and padded edges, a dead item on a cycle
    _comp(w, range(6), 1)
    w["alive"][5] = False
    n = _edges(w, [(src[0], 0, FF), (0, 1, FF), (1, 0, FF), (1, 5, FF),
                   (5, 1, FF), (-1, -1, FF), (-1, 3, FF), (3, -1, RR)])
    w["e_alive"][1] = False  # 0 -> 1 dead: the cycle 0 <-> 1 is cut
    w["e_alive"][n:n + 4] = False
    w["e_src"][n:n + 4] = -1
    w["e_dst"][n:n + 4] = -1
    out["dead_and_padded_edges"] = w

    w = _window()  # every component's anchors dead or absent
    _comp(w, range(8), 1)
    w["alive"][src[0]] = False
    _edges(w, [(src[0], 0, FF), (0, 1, FF), (1, 0, FF)])
    out["dead_anchor"] = w

    w = _window()  # an edge into a special (never entered) and out of one
    _comp(w, range(4), 1)
    _comp(w, range(4, 8), 2)
    w["special"][2] = True
    _edges(w, [(src[0], 0, FF), (0, 2, FF), (2, 0, FF), (0, 1, FF),
               (1, snk[0], FF), (src[1], 4, FF), (4, 5, FF), (5, snk[1], FF),
               (snk[1], 4, FF)])
    out["special_items"] = w

    w = _window()  # all four components, each a self-loop or a palindrome
    for c in range(Cm):
        _comp(w, [10 * c, 10 * c + 1], c + 1)
    _edges(w, [(src[0], 0, FF), (0, 0, FF), (src[1], 10, FF), (10, 10, FR),
               (src[2], 20, FF), (20, 21, FR), (21, 20, RF),
               (src[3], 30, FF), (30, 31, FF), (31, snk[3], FF)])
    out["self_loops"] = w

    out["empty"] = _window()

    w = _window()  # the reach runs 14 rounds past a cycle; the peel stops
    _comp(w, range(14), 1)  # after its first layer (the cycle feeds all)
    _edges(w, [(src[0], 0, FF)] + _chain_edges([0, 1, 2, 0])
           + _chain_edges(list(range(2, 14))))
    out["reach_longer_than_peel"] = w

    w = _window()  # 20 layers to peel; the reach takes 2 rounds
    _comp(w, range(20), 2)
    n = _edges(w, _chain_edges(list(range(20))))
    _edges(w, [(src[1], 19, FF), (19, snk[1], FF)], n)
    out["peel_longer_than_reach"] = w

    w = _window()  # item 3 reached by two frontier edges in round 2
    _comp(w, range(5), 1)
    _edges(w, [(src[0], 1, FF), (src[0], 2, FF), (1, 3, FF), (2, 3, FF),
               (3, 4, FR)])
    out["two_frontier_edges"] = w

    w = _window()  # item 2's in-degree falls from 3 to 0 in round 0
    _comp(w, range(5), 1)
    _edges(w, [(0, 2, FF), (1, 2, FF), (0, 2, FF), (2, 3, FF), (3, 4, FF),
               (src[0], 4, FF)])
    out["indeg_zero_from_two_edges"] = w

    for r in (4, 5, 6):  # a reach chain of r rounds (T 5: above, at, below)
        w = _window()
        _comp(w, range(r), 1)
        _edges(w, _chain_edges([src[0]] + list(range(r))))
        out[f"reach_{r}_rounds"] = w
    for n_l in (5, 6):  # a peel of n_l layers whose last item is reached
        w = _window()
        _comp(w, range(n_l), 1)
        n = _edges(w, _chain_edges(list(range(n_l))))
        _edges(w, [(src[0], n_l - 1, FF)], n)
        out[f"peel_{n_l}_layers"] = w

    rng = np.random.default_rng(seed)
    NI = N + 2 * Cm
    for k in range(n_random):
        w = _window()
        n_items = int(rng.integers(4, N))
        items = rng.permutation(N)[:n_items]
        w["alive"][items] = rng.random(n_items) < 0.95
        w["alive"][N:] = rng.random(2 * Cm) < 0.8
        w["comp"][:] = rng.integers(-1, Cm + 3, NI)
        w["special"][items[rng.random(n_items) < 0.03]] = True
        n_e = int(rng.integers(0, SCREEN_EE + 1))
        pick = np.concatenate([items, np.arange(N, NI)])
        w["e_src"][:n_e] = rng.choice(pick, n_e)
        w["e_dst"][:n_e] = rng.choice(pick, n_e)
        w["e_dir"][:n_e] = rng.integers(0, 4, n_e)
        w["e_alive"][:n_e] = rng.random(n_e) < 0.9
        # anchors feed a few items each; padded rows carry -1 ends
        w["e_src"][n_e:] = rng.choice([-1, 0], SCREEN_EE - n_e)
        w["e_dst"][n_e:] = rng.choice([-1, 0], SCREEN_EE - n_e)
        out[f"random_{k}"] = w
    return out


def screen_batch(windows: dict | None = None):
    """The windows stacked: (dict e_src, e_dst, e_dir, e_alive, alive,
    special, comp of numpy arrays [W, ...], names, N, NI, Cmax)."""
    windows = screen_windows() if windows is None else windows
    keys = ("e_src", "e_dst", "e_dir", "e_alive", "alive", "special", "comp")
    arrs = {k: np.stack([w[k] for w in windows.values()]) for k in keys}
    return (arrs, list(windows), SCREEN_N, SCREEN_N + 2 * SCREEN_CMAX,
            SCREEN_CMAX)


SCREEN_ARGS = ("e_src", "e_dst", "e_dir", "e_alive", "alive", "special",
               "comp")


def to_torch(a, dev="cpu"):
    a = np.asarray(a)
    return torch.from_numpy(a.copy() if a.dtype == bool
                            else a.astype(np.int64)).to(dev)


def run_tandem(seqs, lens, dev="cpu", params=TANDEM_PARAMS[0]):
    """stages.tandem_at on `dev` (the kernel on a card, the plain version
    on the CPU) at params (pos, max_unit_len, min_report_units,
    min_report_len, dist_from_str)."""
    from . import stages

    return stages.tandem_at(to_torch(seqs, dev), to_torch(lens, dev), *params)


def run_screen(arrs, N, NI, Cmax, dev="cpu", T=32):
    """stages.cycle_screen on `dev`: may_cycle [W, Cmax]."""
    from . import stages

    return stages.cycle_screen(*[to_torch(arrs[k], dev) for k in SCREEN_ARGS],
                               N, NI, Cmax, T)
