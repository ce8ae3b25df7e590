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
- a numpy replay of each kernel's own loop (per string: the staged codes,
  the prefix sums, the ring-rotated offset table, the scan stopping at
  min(lens, L); per window: Jacobi reach rounds with two buffers, the peel
  a layer a round, each window stopping on its own) bit-equal to the plain
  version on those inputs, at the engine's parameters and others;
- `screens.tandem_plan` and `screens.cycle_screen_plan` on the engine's
  shapes, and the wrappers' refusals.

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
    """csrc/screens.cu's tandem_kernel, thread by thread: the block's
    staged codes (a row's code below lens, 100 + x % 50 past it), the
    row's ml-mismatch prefix sums, the offset table as one ring a unit
    length rotated each position, the scan over i < min(lens, L), the
    report, units and primitivity tests only on a break."""
    B, L = seqs.shape
    out = np.zeros(B, bool)
    for b in range(B):
        n = int(lens[b])
        e = [int(seqs[b, x]) if x < n else 100 + x % 50 for x in range(L)]
        cs = {}
        for ml in range(1, mu):
            acc, c = 0, [0]
            for k in range(L):
                acc += (e[k] != e[k + ml]) if k < L - ml else 1
                c.append(acc)
            cs[ml] = c

        def gb(x):
            return e[x] if 0 <= x < L else 300 + abs(x) % 97

        def periodic(ml, a, bb):
            if bb <= a:
                return True
            c = cs[ml]
            return c[min(max(bb, 0), L)] == c[min(max(a, 0), L)]

        ring = {m: list(range(m)) for m in range(1, mu + 1)}
        ans = False
        for i in range(min(n, L)):
            for m in range(1, mu + 1):
                offset = ring[m][0]
                j, still = 0, True
                for jj in range(m):
                    still = still and i + jj < n and gb(i + jj) == gb(
                        offset + jj)
                    j += still
                brk = j != m or i + j + 1 == n
                if brk:
                    hit = (gb(offset - 1) != gb(offset + m - 1)
                           and (i - offset) // m >= min_units
                           and i - offset >= min_len)
                    for ml in range(1, m):
                        units = (i - offset + j) // ml
                        hit = hit and not periodic(
                            ml, offset, offset + units * ml - ml)
                    ans = ans or (hit and offset - dist <= pos
                                  <= i + j + dist)
                ring[m] = ring[m][1:] + [i if brk else offset]
        out[b] = ans
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


def test_tandem_plan():
    """The engine's shape (L 64, unit length 4) fits under 48 KB; a unit
    length past the register table and rows past shared memory refuse."""
    assert screens.tandem_plan(64, 4) == 41600 == screens.tandem_smem(64, 4)
    assert screens.tandem_plan(64, 0) == screens.tandem_plan(64, -2)
    for L, mu in ((64, 9), (64, 100)):
        with pytest.raises(ValueError, match="max_unit_len"):
            screens.tandem_plan(L, mu)
    with pytest.raises(ValueError, match="shared memory"):
        screens.tandem_plan(1000, 8)


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


def screen_replay(arrs, N, NI, Cmax, T):
    """csrc/screens.cu's cycle_screen_kernel, window by window: the staged
    edges (state ids, eact / eact_p; an edge with a state outside [0, 2
    NI) dropped), Jacobi reach rounds (every edge reads the old buffer and
    writes the new one, then the states compare and copy back; stop after
    a round that changes nothing), the peel a layer a round with its empty
    last round, the item flags and the clamped component slots."""
    W = arrs["e_src"].shape[0]
    NS = 2 * NI
    out = np.zeros((W, Cmax), bool)
    for w in range(W):
        al, sp = arrs["alive"][w], arrs["special"][w]
        src = np.clip(arrs["e_src"][w], 0, NI - 1)
        dst = np.clip(arrs["e_dst"][w], 0, NI - 1)
        d = arrs["e_dir"][w]
        s_st, d_st = src * 2 + (d >> 1), dst * 2 + (d & 1)
        ok = (s_st >= 0) & (s_st < NS) & (d_st >= 0) & (d_st < NS)
        act = ok & arrs["e_alive"][w] & al[src] & al[dst] & ~sp[dst]
        act_p = act & ~sp[src]
        ra = np.zeros(NS, bool)
        for c in range(Cmax):
            if al[N + 2 * c]:
                ra[2 * (N + 2 * c):2 * (N + 2 * c) + 2] = True
        rb = ra.copy()
        unconv = True
        r = 0
        while r < T and unconv:
            hot = act & ra[np.where(ok, s_st, 0)]
            rb[d_st[hot]] = True
            unconv = bool((rb != ra).any())
            ra[:] = rb
            r += 1
        live = np.repeat(al & ~sp, 2)
        indeg = np.zeros(NS, np.int64)
        np.add.at(indeg, d_st[act_p], 1)
        for _ in range(max(T, 0)):
            f = live & (indeg == 0)
            hot = act_p & f[np.where(ok, s_st, 0)]
            np.add.at(indeg, d_st[hot], -1)
            live &= ~f
            if not f.any():
                break
        may = np.zeros(Cmax + 2, bool)
        for v in range(NI):
            c = int(arrs["comp"][w, v])
            if c <= 0:
                continue
            r0, r1 = ra[2 * v], ra[2 * v + 1]
            left = (live[2 * v] and r0) or (live[2 * v + 1] and r1)
            if ((left or (r0 and r1)) and al[v] and not sp[v]) or unconv:
                may[min(c, Cmax + 1)] = True
        out[w] = may[1:Cmax + 1]
    return out


@pytest.mark.parametrize("T", SCREEN_T)
def test_screen_replay_equals_plain(T):
    """The kernel's loops (screen_replay) bit-equal to cycle_screen_plain at
    T 0, 1, 5, 32 and 40: a window stopping on its own equals the plain
    version's loop over all windows."""
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


def test_screen_plan():
    """The engine's compact shape fits under 48 KB; too many items, anchors
    outside the items and windows past shared memory refuse."""
    assert screens.cycle_screen_plan(528, 1568, 512, 8) == 17360
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
