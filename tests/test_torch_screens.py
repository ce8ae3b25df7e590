"""The device graph engine's two screens (`lancet_tpu_torch.gpu.screens`,
`csrc/screens.cu`) on the CPU, against the JAX package.

- `stages.tandem_at_plain` (the findTandems position probe of the
  short-link STR guard) bit-equal to the JAX `tandem_at` on the crafted and
  seeded rows of `gpu.screencases.tandem_batch` (lens 0, 1, 63, 64 and past
  L, where two out-of-range sentinels alias modulo 97; unfilled slots
  inside lens; homopolymers and 2-, 3- and 4-base repeats ending before, at
  and after the probed position; non-primitive units), each row with a
  letter for every code also against the host engine's `find_tandems`;
- `stages.cycle_screen_plain` bit-equal to the JAX `cycle_screen` on the
  windows of `gpu.screencases.screen_batch` (a chain longer than T, a peel
  deeper than T, an item reached in both orientations, component labels
  above Cmax and at or below 0, dead and padded edges, seeded graphs);
- a numpy replay of each kernel, lane by lane and round by round, bit-equal
  to the plain version on those inputs, at the engine's parameters and
  others: per string, the staged codes with their sentinels, the prefix
  sums, and for each unit length 32 positions a chunk, one a lane (a
  lane's break test against the codes at max(i - m, p), the ballot of
  breaks, the lane's chain mask and the chains' carried last breaks); per
  window, the compacted edge list, the reach as round labels over the
  frontier's edges, the peel as Kahn layers by decrements, both in the
  same rounds under one stop;
- which (m, p) chains report each crafted phase-(m - 1) repeat, and the
  crafted windows' reach and peel rounds and verdicts at T 5;
- `screens.tandem_plan` and `screens.cycle_screen_plan` on the engine's
  shapes, every shape the first designs' plans took, and the wrappers'
  refusals.

The JAX side runs each function once, at one shape (its loops compile
once). The `cuda` tests hold both kernels bit-equal to their plain versions
on the same inputs on the card.
"""

import functools

import numpy as np
import pytest
import torch

from lancet_tpu_torch.engine.seqs import find_tandems
from lancet_tpu_torch.gpu import screencases as sc
from lancet_tpu_torch.gpu import screens, stages

torch.set_num_threads(1)

TANDEM_PARAMS = sc.TANDEM_PARAMS
ENGINE = TANDEM_PARAMS[0]  # pos 20 (K 21) and config.py's STR parameters
SCREEN_T = sc.SCREEN_ROUNDS


def _tandem_plain(seqs, lens, pos, mu, units, length, dist):
    return stages.tandem_at_plain(torch.from_numpy(seqs),
                                  torch.from_numpy(lens), pos, mu, units,
                                  length, dist).numpy()


def _screen_plain(arrs, N, NI, Cmax, T=32):
    return stages.cycle_screen_plain(
        *[sc.to_torch(arrs[k]) for k in sc.SCREEN_ARGS], N, NI, Cmax,
        T).numpy()


@functools.lru_cache(maxsize=None)
def _tandem():
    return sc.tandem_batch()


@functools.lru_cache(maxsize=None)
def _screen():
    return sc.screen_batch()


# ---------------------------------------------------------------------------
# tandem_at
# ---------------------------------------------------------------------------

def test_tandem_plain_equals_jax():
    """tandem_at_plain bit-equal to the JAX tandem_at at the engine's
    parameters (one call: the scan compiles once)."""
    import jax.numpy as jnp

    from lancet_tpu.tpu import stages as jstages

    seqs, lens, names = _tandem()
    want = np.asarray(jstages.tandem_at(
        jnp.asarray(seqs.astype(np.int32)),
        jnp.asarray(np.clip(lens, -2**31, 2**31 - 1).astype(np.int32)),
        *ENGINE))
    got = _tandem_plain(seqs, lens, *ENGINE)
    bad = [names[i] for i in np.nonzero(got != want)[0]]
    assert not bad, bad
    # the batch has both verdicts, in the crafted rows and the seeded ones
    crafted = np.array([not n.startswith("random") for n in names])
    for part in (crafted, ~crafted):
        assert 0 < got[part].sum() < part.sum()


@pytest.mark.parametrize("pos", [sc.TANDEM_POS, 0, 9, 40, 63])
def test_tandem_plain_equals_host_find_tandems(pos):
    """Each row that the host engine's find_tandems takes (a letter for
    every code; more than 2 max_unit_len bases, below which its end test
    reads past the string) gives find_tandems's verdict."""
    seqs, lens, names = _tandem()
    mu, units, length, dist = ENGINE[1:]
    got = _tandem_plain(seqs, lens, pos, mu, units, length, dist)
    n_held = 0
    for row, n, name, g in zip(seqs, lens, names, got):
        if not 2 * mu < n <= sc.L_TANDEM:
            continue
        s = sc.codes_str(row, int(n))
        if s is None:
            continue
        want = find_tandems(s, mu, units, length, dist, pos)[0]
        assert g == want, (name, s)
        n_held += 1
    assert n_held > 300


def tandem_replay(seqs, lens, pos, mu, min_units, min_len, dist):
    """csrc/screens.cu's tandem_kernel, lane by lane: per string (a warp)
    the staged codes g[x] for x in [-1, L + mu - 2] (the code below lens,
    100 + x % 50 past it, the sentinel 300 + |x| % 97 outside [0, L)), the
    ml-mismatch prefix sums, then for each unit length m and chunk of 32
    positions below min(lens, L): each lane's break test against the codes
    at max(i - m, p) with lens capped at L + mu + 1, the ballot of breaks,
    the lane's offset (the highest break below it among every m-th lane,
    else its chain's carried last break, p at first), the hit test on a
    break at least min_len long, and the chains' carries for the next
    chunk."""
    B, L = seqs.shape
    out = np.zeros(B, bool)
    for b in range(B):
        n = int(lens[b])
        if n <= 0 or mu <= 0:
            continue
        g = {x: (301 if x < 0 else 300 + x % 97 if x >= L
                 else int(seqs[b, x]) if x < n else 100 + x % 50)
             for x in range(-1, L + mu - 1)}
        cs = {}
        for ml in range(1, mu):
            acc, c = 0, [0]
            for k in range(L):
                acc += (g[k] != g[k + ml]) if k < L - ml else 1
                c.append(acc)
            cs[ml] = c

        def periodic(ml, a, bb):
            if bb <= a:
                return True
            c = cs[ml]
            return c[min(max(bb, 0), L)] == c[min(max(a, 0), L)]

        last, nn = min(n, L), min(n, L + mu + 1)
        minl = 0 if min_len < 0 else (L + 1 if min_len > L else min_len)
        hit = False
        for m in range(1, mu + 1):
            every = sum(1 << x for x in range(0, 32, m))
            carry = list(range(mu))
            for base in range(0, last, 32):
                brk, jv = [False] * 32, [0] * 32
                for lane in range(32):
                    i = base + lane
                    ic = i if i < last else last - 1
                    ref = ic if ic < m else ic - m
                    j, still = 0, True
                    for jj in range(m):
                        still = still and ic + jj < nn and (g[ic + jj]
                                                            == g[ref + jj])
                        j += still
                    jv[lane] = j
                    brk[lane] = i < last and (j != m or i + j + 1 == nn)
                bm = sum(1 << x for x in range(32) if brk[x])
                for lane in range(32):
                    i, j = base + lane, jv[lane]
                    mine = (bm & (every << lane % m) & 0xffffffff
                            & ((1 << lane) - 1))
                    offset = (base + mine.bit_length() - 1 if mine
                              else carry[i % m])
                    if brk[lane] and i - offset >= minl:
                        h = (g[offset - 1] != g[offset + m - 1]
                             and (i - offset) // m >= min_units)
                        for ml in range(1, m):
                            units = (i - offset + j) // ml
                            h = h and not periodic(ml, offset,
                                                   offset + units * ml - ml)
                        hit = hit or (h and offset - dist <= pos
                                      <= i + j + dist)
                for q in range(m):
                    x = bm & (every << (q - base % m) % m) & 0xffffffff
                    if x:
                        carry[q] = base + x.bit_length() - 1
        out[b] = hit
    return out


def chain_hits(row, n, pos, mu, min_units, min_len, dist, L=sc.L_TANDEM):
    """The (m, p) chains whose breaks report a hit: the findTandems scan
    one chain at a time, its offset table entry starting at p and
    advancing on a break (as tandem_at_plain runs every chain at once)."""
    e = [int(row[x]) if x < n else 100 + x % 50 for x in range(L)]

    def gb(x):
        return e[x] if 0 <= x < L else 300 + abs(x) % 97

    def mis(ml, a, bb):
        return sum((e[t] != e[t + ml]) if t < L - ml else 1
                   for t in range(max(a, 0), min(bb, L)))

    out = set()
    for m in range(1, mu + 1):
        for p in range(m):
            offset = p
            for i in range(p, min(n, L), m):
                j, still = 0, True
                for jj in range(m):
                    still = still and i + jj < n and gb(i + jj) == gb(
                        offset + jj)
                    j += still
                if j != m or i + j + 1 == n:
                    h = (gb(offset - 1) != gb(offset + m - 1)
                         and (i - offset) // m >= min_units
                         and i - offset >= min_len)
                    for ml in range(1, m):
                        units = (i - offset + j) // ml
                        h = h and mis(ml, offset, offset + units * ml - ml) > 0
                    if h and offset - dist <= pos <= i + j + dist:
                        out.add((m, p))
                    offset = i
    return out


@pytest.mark.parametrize("params", TANDEM_PARAMS,
                         ids=[f"pos{p[0]}_mu{p[1]}_u{p[2]}_l{p[3]}_d{p[4]}"
                              for p in TANDEM_PARAMS])
def test_tandem_replay_equals_plain(params):
    """The kernel's loop (tandem_replay) bit-equal to tandem_at_plain; the
    engine's parameters on every row, the others on the crafted rows."""
    seqs, lens, names = _tandem()
    if params[1:] != ENGINE[1:]:
        keep = np.array([not n.startswith("random") for n in names])
        seqs, lens = seqs[keep], lens[keep]
    want = _tandem_plain(seqs, lens, *params)
    np.testing.assert_array_equal(tandem_replay(seqs, lens, *params), want)


def test_tandem_replay_odd_widths():
    """The replay and the plain version at other string widths (L 1, 5, 9,
    100) on seeded rows with lens around L."""
    rng = np.random.default_rng(11)
    for L in (1, 5, 9, 100):
        seqs = rng.choice([0, 1, 2, 3, 4, 99], (40, L),
                          p=[.4, .3, .1, .1, .05, .05]).astype(np.int64)
        lens = rng.integers(-1, 2 * L + 3, 40)
        for params in ((L // 2, 4, 3, 7, 1), (L, 3, 1, 2, 0)):
            want = _tandem_plain(seqs, lens, *params)
            np.testing.assert_array_equal(
                tandem_replay(seqs, lens, *params), want)


def test_tandem_phase_m_minus_1_rows():
    """Each crafted phase-(m - 1) repeat is reported by chain (m, m - 1)
    alone (the other phases see one unit fewer), and tandem_at_plain and
    the replay find it."""
    seqs, lens, names = _tandem()
    rows = [k for k, name in enumerate(names)
            if name.startswith("phase_m_minus_1_only")]
    assert len(rows) == 3
    for k in rows:
        m = len(names[k].split("unit")[1])
        assert chain_hits(seqs[k], int(lens[k]), *ENGINE) == {(m, m - 1)}
        one = (seqs[k:k + 1], lens[k:k + 1])
        assert _tandem_plain(*one, *ENGINE)[0]
        assert tandem_replay(*one, *ENGINE)[0]


def test_tandem_plan():
    """The engine's shape (L 64, unit length 4) fits under 48 KB in a
    block of 8 strings; longer strings take fewer a block, down to one; a
    unit length past TANDEM_MAX_UNIT and a string past shared memory
    refuse."""
    assert screens.tandem_plan(64, 4) == 10624 == screens.tandem_smem(64, 4)
    assert screens.tandem_warps(64, 4) == screens.TANDEM_WARPS == 8
    assert screens.tandem_plan(64, 0) == screens.tandem_plan(64, -2)
    assert screens.tandem_warps(1000, 8) == 6
    assert screens.tandem_warps(6400, 8) == 1
    for L, mu in ((64, 9), (64, 100)):
        with pytest.raises(ValueError, match="max_unit_len"):
            screens.tandem_plan(L, mu)
    with pytest.raises(ValueError, match="shared memory"):
        screens.tandem_plan(7000, 8)


# ---------------------------------------------------------------------------
# cycle_screen
# ---------------------------------------------------------------------------

def test_screen_plain_equals_jax():
    """cycle_screen_plain bit-equal to the JAX cycle_screen on every crafted
    and seeded window (one call), and each crafted window's verdict."""
    import jax.numpy as jnp

    from lancet_tpu.tpu import stages as jstages

    arrs, names, N, NI, Cmax = _screen()
    want = np.asarray(jstages.cycle_screen(
        *[jnp.asarray(arrs[k] if arrs[k].dtype == bool
                      else arrs[k].astype(np.int32)) for k in sc.SCREEN_ARGS],
        N, NI, Cmax))
    got = _screen_plain(arrs, N, NI, Cmax)
    np.testing.assert_array_equal(got, want)
    verdict = dict(zip(names, got.astype(int).tolist()))
    assert verdict["chain_past_T"] == [1, 0, 0, 0]  # r_unconv
    assert verdict["chain_within_T"] == [0, 0, 0, 0]
    assert verdict["peel_past_T"] == [0, 1, 0, 0]
    assert verdict["dual_orientation"] == [1, 0, 0, 0]
    assert verdict["unreached_cycle"] == [0, 0, 0, 0]
    assert verdict["self_loops"] == [1, 1, 1, 0]
    assert verdict["empty"] == [0, 0, 0, 0]
    seeded = got[[n.startswith("random") for n in names]]
    assert 0 < seeded.sum() < seeded.size


UNSET = 0xffff  # csrc/screens.cu kUnset: a label not given


def screen_replay(arrs, N, NI, Cmax, T, rounds=None):
    """csrc/screens.cu's cycle_screen_kernel, window by window: the items'
    flags, components (0 unless in [1, Cmax]) and labels (dist 0 on an
    alive anchor's states, lay 0 on every live state); the compacted edge
    list (a packed edge kept when alive, its state ids inside [0, 2 NI),
    its source alive, its destination alive and not special; eact_p when
    its source is not special, which counts in the destination's in-degree
    and unsets its layer 0); then rounds k = 0, 1, ... < T on the labels as
    the round found them: an edge out of dist k labels an unlabelled
    destination k + 1, an eact_p edge out of layer k decrements its
    destination and the one that finds it at 1 puts it in layer k + 1; a
    round that labels nothing ends the loop. r_unconv is T <= 0 or a state
    labelled T, leftover the live states in no layer below T. With
    `rounds`, appends each window's (rounds run, rounds that reached a
    state, rounds that put a state in a layer)."""
    W = arrs["e_src"].shape[0]
    NS = 2 * NI
    out = np.zeros((W, Cmax), bool)
    for w in range(W):
        fl = arrs["alive"][w].astype(int) | arrs["special"][w].astype(int) << 1
        comp = arrs["comp"][w]
        cm = np.where((comp >= 1) & (comp <= Cmax), comp, 0)
        dist = np.full(NS, UNSET)
        for c in range(Cmax):
            if fl[N + 2 * c] & 1:
                dist[2 * (N + 2 * c):2 * (N + 2 * c) + 2] = 0
        lay = np.where(np.repeat(fl, 2) == 1, 0, UNSET)
        indeg = np.zeros(NS, np.int64)
        front, back = [], []
        for e in range(arrs["e_src"].shape[1]):
            src = min(max(int(arrs["e_src"][w, e]), 0), NI - 1)
            dst = min(max(int(arrs["e_dst"][w, e]), 0), NI - 1)
            d_ = int(arrs["e_dir"][w, e])
            st, dt = src * 2 + (d_ >> 1), dst * 2 + (d_ & 1)
            if not (arrs["e_alive"][w, e] and 0 <= st < NS and 0 <= dt < NS):
                continue
            fs, fd = fl[st >> 1], fl[dt >> 1]
            if not (fs & 1 and fd == 1):
                continue
            if fs & 2:
                back.append((st, dt))
            else:
                front.append((st, dt))
                indeg[dt] += 1
                lay[dt] = UNSET
        edges = [(st, dt, True) for st, dt in front] + [
            (st, dt, False) for st, dt in back]
        k, last_reach, last_peel = 0, -1, -1
        while k < T:
            d0, l0 = dist.copy(), lay.copy()
            ch = False
            for st, dt, eact_p in edges:
                if d0[st] == k and d0[dt] == UNSET:
                    dist[dt] = k + 1
                    ch, last_reach = True, k
                if eact_p and l0[st] == k:
                    indeg[dt] -= 1
                    if indeg[dt] == 0:
                        lay[dt] = k + 1
                        ch, last_peel = True, k
            k += 1
            if not ch:
                break
        if rounds is not None:
            rounds.append((k, last_reach + 1, last_peel + 1))
        unconv = T <= 0 or (T < UNSET and bool((dist == T).any()))
        flagged, present = set(), set()
        for v in range(NI):
            c = int(cm[v])
            if c == 0:
                continue
            present.add(c)
            if fl[v] != 1:
                continue
            r0, r1 = dist[2 * v] != UNSET, dist[2 * v + 1] != UNSET
            left0 = r0 and not (lay[2 * v] != UNSET and lay[2 * v] < T)
            left1 = r1 and not (lay[2 * v + 1] != UNSET
                                and lay[2 * v + 1] < T)
            if left0 or left1 or (r0 and r1):
                flagged.add(c)
        for c in range(1, Cmax + 1):
            out[w, c - 1] = c in flagged or (unconv and c in present)
    return out


@pytest.mark.parametrize("T", SCREEN_T)
def test_screen_replay_equals_plain(T):
    """The kernel's rounds (screen_replay) bit-equal to cycle_screen_plain
    at T 0, 1, 5, 32 and 40: labels over the frontier's edges and layers by
    decrements, both in the same rounds, equal the plain version's Jacobi
    reach and layer-by-layer peel run one after the other."""
    arrs, _, N, NI, Cmax = _screen()
    np.testing.assert_array_equal(screen_replay(arrs, N, NI, Cmax, T),
                                  _screen_plain(arrs, N, NI, Cmax, T))


def test_screen_replay_engine_shape():
    """The replay and the plain version at the engine's compact shape (W 8
    of NI 528 = NCR 512 + 2 Cmax 8, EE 1,568) on seeded graphs whose
    reach runs past T (a ring of 512 items entered from an anchor), with
    directions 4 and 5 whose state ids stay inside the states."""
    rng = np.random.default_rng(7)
    W, N, Cmax, EE = 8, 512, 8, 1568
    NI = N + 2 * Cmax
    arrs = dict(e_src=rng.integers(-1, NI, (W, EE)),
                e_dst=rng.integers(-1, NI, (W, EE)),
                e_dir=rng.integers(0, 4, (W, EE)),
                e_alive=rng.random((W, EE)) < 0.7,
                alive=rng.random((W, NI)) < 0.9,
                special=np.zeros((W, NI), bool),
                comp=rng.integers(-1, Cmax + 3, (W, NI)))
    arrs["special"][:, N:] = True
    # window 0: a ring of 512 items entered from anchor 0; window 1 a DAG
    arrs["e_src"][0, :512] = np.arange(512)
    arrs["e_dst"][0, :512] = np.arange(1, 513) % 512
    arrs["e_src"][0, 512] = N
    arrs["e_dst"][0, 512] = 0
    arrs["e_dir"][:2] = 0
    arrs["e_alive"][1] &= arrs["e_src"][1] < arrs["e_dst"][1]
    hi = arrs["e_src"] < NI - 1
    arrs["e_dir"][2] = np.where(hi[2], 4, arrs["e_dir"][2])
    for T in (32, 600):
        want = _screen_plain(arrs, N, NI, Cmax, T)
        np.testing.assert_array_equal(screen_replay(arrs, N, NI, Cmax, T),
                                      want)


def test_screen_crafted_rounds():
    """The crafted windows run the rounds they were built for (the reach
    past the peel and the reverse; a window ends after max(reach rounds,
    peel rounds) + 1, or T), and give their verdicts at T 5: a reach of 4
    rounds converges, one of 5 and one of 6 do not; a peel of 5 layers
    ends, one of 6 leaves its reached last item."""
    arrs, names, N, NI, Cmax = _screen()
    rounds: list = []
    got = screen_replay(arrs, N, NI, Cmax, 32, rounds)
    by = dict(zip(names, rounds))
    for name, (k, reach, peel) in by.items():
        assert k == min(max(reach, peel) + 1, 32), name
    assert by["reach_longer_than_peel"][1:] == (14, 0)
    assert by["peel_longer_than_reach"][1:] == (1, 19)
    assert by["two_frontier_edges"][1] == 3
    for r in (4, 5, 6):
        assert by[f"reach_{r}_rounds"][1] == r
    verdict = dict(zip(names, got.astype(int).tolist()))
    assert verdict["reach_longer_than_peel"] == [1, 0, 0, 0]
    assert verdict["peel_longer_than_reach"] == [0, 0, 0, 0]
    got5 = _screen_plain(arrs, N, NI, Cmax, 5)
    np.testing.assert_array_equal(screen_replay(arrs, N, NI, Cmax, 5), got5)
    v5 = {n: int(got5[k, 0]) for k, n in enumerate(names)}
    assert [v5[f"reach_{r}_rounds"] for r in (4, 5, 6)] == [0, 1, 1]
    assert [v5[f"peel_{n}_layers"] for n in (5, 6)] == [0, 1]


# the first designs' shared-memory plans (csrc/screens.cu before the
# redesign): every shape they took, the new plans take
def _first_tandem_smem(L, mu):
    return (screens._r16(32 * (L | 1) * 8)
            + screens._r16(32 * max(mu - 1, 0) * (L + 1) * 4))


def _first_screen_smem(NI, EE, Cmax):
    r16 = screens._r16
    return (r16(EE * 4) + r16(EE) + 2 * r16(NI) + 4 * r16(2 * NI)
            + r16(8 * NI) + r16(Cmax + 2))


def test_plans_take_what_the_first_designs_took():
    """No shape the first designs' plans took is refused now: strings of L
    up to 2,000 at every unit length, and windows of NI and EE on a grid
    to the limits (with Cmax 0, 1 and its most)."""
    limit = screens.SMEM_LIMIT
    for L in range(0, 2001):
        for mu in range(0, 9):
            if _first_tandem_smem(L, mu) <= limit:
                assert screens.tandem_plan(L, mu) <= limit
    rng = np.random.default_rng(3)
    nis = list(range(1, 80)) + rng.integers(1, 32768, 300).tolist()
    ees = [0, 1, 15, 16, 17, 1568] + rng.integers(0, 47000, 20).tolist()
    for NI in nis:
        for EE in ees:
            for C in {0, 1, (NI + 1) // 2}:
                if _first_screen_smem(NI, EE, C) <= limit:
                    screens.cycle_screen_plan(NI, EE, max(0, NI - 2 * C), C)


def test_screen_plan():
    """The engine's compact shape fits under 48 KB; too many items or
    edges, anchors outside the items and windows past shared memory
    refuse."""
    assert screens.cycle_screen_plan(528, 1568, 512, 8) == 14240
    assert screens.cycle_screen_plan(72, 160, 64, 4) == \
        screens.cycle_screen_smem(72, 160, 4)
    assert screens.cycle_screen_plan(4, 0, 0, 0) > 0
    with pytest.raises(ValueError, match="items"):
        screens.cycle_screen_plan(32768, 10, 0, 1)
    for N, Cmax in ((512, 9), (-1, 1), (528, 1), (0, -1)):
        with pytest.raises(ValueError, match="anchors"):
            screens.cycle_screen_plan(528, 1568, N, Cmax)
    with pytest.raises(ValueError, match="shared memory"):
        screens.cycle_screen_plan(32000, 40000, 0, 1)
    with pytest.raises(ValueError, match="shared memory"):
        screens.cycle_screen_plan(4, 65536, 0, 1)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_cpu_runs_the_plain_versions():
    """On the CPU stages.tandem_at and stages.cycle_screen are the plain
    versions, and launch nothing."""
    screens.reset_launches()
    seqs, lens, _ = _tandem()
    np.testing.assert_array_equal(
        sc.run_tandem(seqs, lens).numpy(),
        _tandem_plain(seqs, lens, *ENGINE))
    arrs, _, N, NI, Cmax = _screen()
    np.testing.assert_array_equal(sc.run_screen(arrs, N, NI, Cmax).numpy(),
                                  _screen_plain(arrs, N, NI, Cmax))
    assert screens.LAUNCHES == {"tandem_at": 0, "cycle_screen": 0}


def test_wrappers_refuse_mixed_devices():
    """Inputs on two devices raise before any work."""
    seqs = torch.zeros((2, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="one device"):
        screens.tandem_at(seqs, torch.zeros(2, dtype=torch.int64,
                                            device="meta"), 20, 4, 3, 7, 1)
    arrs, _, N, NI, Cmax = _screen()
    ts = [sc.to_torch(arrs[k]) for k in sc.SCREEN_ARGS]
    ts[-1] = ts[-1].to("meta")
    with pytest.raises(ValueError, match="one device"):
        screens.cycle_screen(*ts, N, NI, Cmax)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tandem_kernel_matches_plain_on_card():
    """tandem_at on the card bit-equal to tandem_at_plain on every row at
    every parameter set, one launch a call; the refusals on the card."""
    dev = _card()
    seqs, lens, _ = _tandem()
    for params in TANDEM_PARAMS:
        before = screens.LAUNCHES["tandem_at"]
        got = screens.tandem_at(torch.from_numpy(seqs).to(dev),
                                torch.from_numpy(lens).to(dev), *params)
        assert screens.LAUNCHES["tandem_at"] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _tandem_plain(seqs, lens, *params))
    s = torch.from_numpy(seqs).to(dev)
    n = torch.from_numpy(lens).to(dev)
    with pytest.raises(ValueError, match="max_unit_len"):
        screens.tandem_at(s, n, 20, 9, 3, 7, 1)
    with pytest.raises(ValueError, match="integer"):
        screens.tandem_at(s.float(), n, 20, 4, 3, 7, 1)
    with pytest.raises(ValueError, match="lens"):
        screens.tandem_at(s, n[:5], 20, 4, 3, 7, 1)


@pytest.mark.cuda
def test_screen_kernel_matches_plain_on_card():
    """cycle_screen on the card bit-equal to cycle_screen_plain on every
    window at every T, and at the engine's shape; the refusals."""
    dev = _card()
    arrs, _, N, NI, Cmax = _screen()
    for T in SCREEN_T:
        got = sc.run_screen(arrs, N, NI, Cmax, dev, T)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _screen_plain(arrs, N, NI, Cmax, T))
    ts = [sc.to_torch(arrs[k], dev) for k in sc.SCREEN_ARGS]
    with pytest.raises(ValueError, match="anchors"):
        screens.cycle_screen(*ts, NI, NI, Cmax)
    with pytest.raises(ValueError, match="items"):
        screens.cycle_screen(*ts, N, NI + 1, Cmax)
