"""The port's repeat gates against the JAX package's.

`gpu.repeats.gates_plain` and the port's `repeat_gates(device="cpu")` must
equal `lancet_tpu.tpu.repeats.repeat_gates` (JAX on the CPU) bit for bit,
in both the gates and the exact rows, on seeded adversarial windows
(`corpus.repeat_windows`: lengths 0-600, random sequence and tandem
repeats with substitutions and N), for max_mismatch 0-3, the default ks
and a list with even and non-consecutive k. The `cuda` test holds the
kernel `repeat_gates` of csrc/repeats.cu against `gates_plain` on a card
and skips without one.

The JAX side is imported inside the tests that use it, so the `cuda` test
also runs where JAX is not installed:
    pytest --noconftest -m cuda tests/test_torch_repeats.py
"""

import numpy as np
import pytest
import torch

from lancet_tpu_torch import corpus
from lancet_tpu_torch.gpu import repeats

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

DEFAULT_KS = list(range(11, 102, 2))  # Config min_k..max_k, step 2
ODD_KS = [31, 4, 6, 7, 12, 10, 64, 0]  # even, non-consecutive, unsorted


def _jax_gates(windows, ks, mm):
    from lancet_tpu.tpu.repeats import repeat_gates

    return repeat_gates(windows, ks, mm, with_exact=True)


def _plain(windows, ks, mm):
    seq, lens = repeats.pack(windows)
    g, e = repeats.gates_plain(torch.from_numpy(seq), torch.from_numpy(lens),
                               tuple(ks), mm)
    return g.numpy(), e.numpy()


@pytest.mark.parametrize("ks,mm", [(DEFAULT_KS, 0), (DEFAULT_KS, 1),
                                   (DEFAULT_KS, 2), (DEFAULT_KS, 3),
                                   (ODD_KS, 2)])
def test_gates_equal_jax(ks, mm):
    windows = corpus.repeat_windows()
    jg, je = _jax_gates(windows, ks, mm)
    pg, pe = _plain(windows, ks, mm)
    cg, ce = repeats.repeat_gates(windows, ks, mm, with_exact=True,
                                  device="cpu")
    assert pg.dtype == cg.dtype == np.bool_ and pg.shape == jg.shape
    np.testing.assert_array_equal(pg, jg)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(cg, jg)
    np.testing.assert_array_equal(ce, je)
    # the set exercises both verdicts: exact repeats, and with a mismatch
    # budget near repeats that are not exact
    assert je.any() and not jg.all()
    assert (jg & ~je).any() == (mm > 0)


def test_gates_edges():
    ks = [0, 1, 2, 11]
    g, e = repeats.repeat_gates(["", "A", "AA", "AAA", "ACGT"], ks, 2,
                                with_exact=True, device="cpu")
    assert not g[0].any() and not e[0].any()  # length 0: never gated
    assert not g[1].any()
    jg, je = _jax_gates(["", "A", "AA", "AAA", "ACGT"], ks, 2)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(e, je)
    empty = repeats.repeat_gates([], ks, 2, device="cpu")
    assert empty.shape == (0, 4)
    with pytest.raises(ValueError, match=">= 0"):
        repeats.repeat_gates(["ACGT"], [-1], 2, device="cpu")


# gates_plan on the shapes the port hands the kernel: the device graph
# path's largest call (one k), its late rounds (a few windows), the
# two-phase path and the eager sweep (the default ladder), the long-window
# setting, a k list whose widest window takes the plain scan, and a window
# too long to stage with its pad
PLAN_SHAPES = [(357, 600, [13], 2), (3, 600, [21], 2),
               (5195, 600, DEFAULT_KS, 2), (512, 600, DEFAULT_KS, 2),
               (7, 9000, DEFAULT_KS, 2), (40, 600, [150, 11], 2),
               (40, 600, [127], -1), (2, 232432, [11], 2), (5, 1, [0], 0)]


@pytest.mark.parametrize("W,L,ks,mm", PLAN_SHAPES)
def test_gates_plan_shapes(W, L, ks, mm):
    pl = repeats.gates_plan(W, L, ks, mm)
    kmin, kmax = repeats.clamp_ks(ks, L)
    assert (pl.kmin, pl.kmax) == (kmin, kmax) and 0 <= kmin <= kmax <= L + 1
    widest = max(kmax + 1 if mm >= 0 else kmax, 1)
    if pl.words:  # the widest window fits the words a thread holds
        assert 2 <= pl.words <= repeats.MAX_WORDS
        assert 32 * (pl.words - 2) < widest <= 32 * (pl.words - 1)
    else:
        assert widest > 32 * (repeats.MAX_WORDS - 1) or (
            repeats.gates_smem(L, 2) > repeats.SMEM_LIMIT - 16)
    assert pl.smem == repeats.gates_smem(L, pl.words)
    assert pl.smem <= repeats.SMEM_LIMIT - 16
    assert 1 <= pl.blocks <= repeats.MAX_CLUSTER
    assert pl.threads % 32 == 0 and 32 <= pl.threads <= 512
    assert pl.tile % 32 == 0 and 32 <= pl.tile <= repeats.MAX_TILE
    # a small batch spreads over a cluster; a large one takes a block
    if W <= 3 and L >= 600:
        assert pl.blocks == repeats.MAX_CLUSTER
    if W >= 512:
        assert pl.blocks == 1
    # the tile leaves a window's busiest thread the fewest starts and
    # halos, within a third of an even share on the port's shapes
    maxp = repeats.first_starts(L, kmin, kmax, mm)
    halo = 32 if pl.words else widest
    threads = pl.blocks * pl.threads

    def busiest(g):
        return -(-repeats.tile_count(maxp, g) // threads) * (g + halo)

    assert all(busiest(pl.tile) <= busiest(g)
               for g in range(32, repeats.MAX_TILE + 1, 32))
    even = (maxp + 1) // 2 * (maxp + 1) / threads
    if maxp >= 1 and L == 600 and pl.words:
        assert busiest(pl.tile) <= 1.34 * even + pl.tile


def test_gates_plan_fills_the_card():
    # the device graph path's largest call (W 357 at k 11): every window's
    # threads resident at once
    pl = repeats.gates_plan(357, 600, [11], 2)
    assert (pl.blocks, pl.threads, pl.words) == (1, 256, 2)
    assert 357 * pl.blocks * pl.threads <= 132 * repeats.THREADS_PER_SM
    # a late k round's few windows: a cluster of blocks a window
    pl = repeats.gates_plan(3, 600, [21], 2)
    assert (pl.blocks, pl.threads) == (repeats.MAX_CLUSTER, 512)
    # the two-phase shape: one block a window
    pl = repeats.gates_plan(5195, 600, DEFAULT_KS, 2)
    assert (pl.blocks, pl.threads, pl.tile, pl.words) == (1, 128, 320, 5)
    with pytest.raises(ValueError, match="shared memory"):
        repeats.gates_plan(1, 232433, [11], 2)


def _deal(maxp: int, G: int):
    """The kernel's deal of tiles: tile t -> its parts [(shift, word
    base, first start, end)] (csrc/repeats.cu, the loop over t)."""
    npairs = (maxp + 1) // 2
    out = []
    for t in range(repeats.tile_count(maxp, G)):
        pair, a = t % npairs, (t // npairs) * G
        s1, s2 = 1 + pair, maxp - pair
        c1, c2 = maxp - pair, (0 if s2 == s1 else pair + 1)
        b = min(a + G, c1 + c2)
        parts = []
        for half in (0, 1):
            s = s2 if half else s1
            lo = max(a - c1, 0) if half else a
            hi = b - c1 if half else min(b, c1)
            if lo < hi:
                parts.append((s, lo & ~31, lo, hi))
        out.append(parts)
    return out


def test_plane_words_equal_byte_compares():
    # csrc/repeats.cu's neq32_planes on a window of A, C, G and T: codes
    # (byte >> 1) & 3 (distinct for the four bases) as two bit planes, 32
    # positions a word, and the mismatch bits of 32 positions at a shift
    # from a funnel shift of each plane, equal to the byte compares
    assert len({(ord(c) >> 1) & 3 for c in "ACGT"}) == 4
    rng = np.random.default_rng(5)
    n = 700
    row = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    codes = np.concatenate([row, np.zeros(64, np.uint8)]) >> 1
    planes = [[sum(int((codes[32 * i + j] >> bit) & 1) << j
                   for j in range(32)) for i in range((n + 64) // 32)]
              for bit in (0, 1)]

    def funnel(lo, hi, sh):
        return ((hi << 32 | lo) >> sh) & 0xFFFFFFFF

    for s in (1, 2, 15, 31, 32, 33, 301, n - 33):
        for q in range(0, n - s, 32):
            b = q + s
            got = 0
            for pw in planes:
                got |= pw[q >> 5] ^ funnel(pw[b >> 5], pw[(b >> 5) + 1],
                                           b & 31)
            for j in range(min(32, n - s - q)):
                assert (got >> j) & 1 == int(row[q + j] != row[b + j])


def _ffs(v: int) -> int:
    """CUDA's __ffs: the 1-based position of the lowest set bit, 0 for 0."""
    return (v & -v).bit_length()


def _run_from(x: list, r: int, budget: int) -> int:
    """csrc/repeats.cu's run_from: the longest stretch from bit r of the
    words x holding at most budget ones, up to 32 * (len(x) - 1) bits."""
    run = 0
    for i in range(len(x) - 1):
        v = ((x[i + 1] << 32 | x[i]) >> r) & 0xFFFFFFFF
        c = bin(v).count("1")
        if c <= budget:
            budget -= c
            run += 32
            continue
        for _ in range(budget):
            v &= v - 1
        return run + (v & -v).bit_length() - 1
    return run


def _zero_pair(x0: int, x1: int) -> bool:
    """csrc/repeats.cu's zero_pair: two zero nibbles side by side in the
    64 bits x0:x1."""
    t0, t1 = x0 | (x0 >> 1), x1 | (x1 >> 1)
    t0 |= t0 >> 2
    t1 |= t1 >> 2
    z0, z1 = ~t0 & 0x11111111, ~t1 & 0x11111111
    return ((z0 & (z0 >> 4)) | (z1 & (z1 >> 4)) | ((z0 >> 28) & z1)) != 0


def test_zero_pair_is_necessary_for_a_run_of_eleven():
    # every run of 11 to 32 zeros starting in the first 32 bits
    rng = np.random.default_rng(3)
    for _ in range(2000):
        v = int(rng.integers(0, 1 << 62)) | int(rng.integers(0, 4)) << 62
        length = int(rng.integers(11, 33))
        start = int(rng.integers(0, 32))
        v &= ~(((1 << length) - 1) << start)
        assert _zero_pair(v & 0xFFFFFFFF, v >> 32)
    assert not _zero_pair(0xEEEEEEEE, 0x77777777)  # a zero bit a nibble


def _replay_window(row, n, kmin, kmax, mm, words, G):
    """The kernel's arithmetic for one window, one tile after another
    (the bars shared as a cluster shares them): (Z, A) clamped, from
    mismatch words of 32 bits, window counts at offsets r < 32, the
    growing window and the skip, the zero-pair filter of a chunk's Z
    tests; words 0 is the plain scan. Bits past a shift's almost region
    in its last word are 0 here (matches), so only the kernel's validity
    tests may stop a run there; unbuilt words are all ones, as in the
    kernel."""
    if n < 2:
        return -1, 0
    zcap, acap = kmax, (kmax + 1 if mm >= 0 else 0)
    bz, ba = max(kmin - 1, 0), (kmin if mm >= 0 else 0)
    maxp = repeats.first_starts(n, kmin, kmax, mm)
    parts = [q for tile in (_deal(maxp, G) if maxp >= 1 else [])
             for q in tile]
    for s, p0, pstart, pend in parts:
        if bz >= zcap and ba >= acap:
            break
        ez, ea = n - 1 - s, n - s
        ne = row[s:n] != row[:ea]
        if words == 0:
            zend = min(ez, pend - 1 + zcap)
            aend = min(ea, pend - 1 + acap)
            run, left, cnt = 0, pstart, 0
            for p in range(pstart, max(zend, aend)):
                if not (bz < zcap or ba < acap):
                    break
                if p < zend:
                    run = 0 if ne[p] else run + 1
                    bz = max(bz, min(run, zcap))
                if p < aend and ba < acap:
                    cnt += int(ne[p])
                    while cnt > mm:
                        cnt -= int(ne[left])
                        left += 1
                    ba = max(ba, min(p - left + 1, acap))
            continue
        bits = int.from_bytes(np.packbits(ne, bitorder="little").tobytes(),
                              "little")

        def word(j):
            q = p0 + 32 * j
            return 0xFFFFFFFF if q >= ea else (bits >> q) & 0xFFFFFFFF

        def limits():
            return (ez - (bz + 1) if bz < zcap else -1,
                    ea - (ba + 1) if ba < acap else -1)

        def word32():  # the 32 bits from the start tested
            return ((x[1] << 32 | x[0]) >> r) & 0xFFFFFFFF

        def count(width):
            # the words the window reaches are built first (the kernel
            # holds x[0] and x[1], and builds the rest on demand)
            nonlocal nxt, have
            assert width <= 32 * (words - 1)
            need = min((r + width + 31) // 32, words)
            for j in range(have, need):
                x[j] = word(nxt)
                nxt += 1
            have = max(have, need)
            cat = sum(v << (32 * i) for i, v in enumerate(x[:have]))
            return bin((cat >> r) & ((1 << width) - 1)).count("1")

        x = [word(0), word(1)] + [0xFFFFFFFF] * (words - 2)
        nxt, have = 2, 2
        base, r = p0, pstart - p0
        zl, al = limits()
        while True:  # a chunk of 32 starts, then a slide
            p = base + r
            zskip = 11 <= bz + 1 <= 32 and not _zero_pair(x[0], x[1])
            if zskip:
                zl = -1
            # the lean loops of one test alone (its window in one word)
            one = ((al, ba + 1, mm) if zl < p and ba + 1 <= 32 else
                   (zl, bz + 1, 0) if al < p and bz + 1 <= 32 else None)
            if one is not None:
                lim, width, budget = one
                while r < 32 and p <= min(pend - 1, lim):
                    c = count(width)
                    if c <= budget:
                        break
                    r += c - budget
                    p += c - budget
            while r < 32 and p < pend and (p <= zl or p <= al):
                step = 1 << 31
                # a pass raises the bar to the whole run or stretch from p
                # (every word built: up to 32 * (words - 1), the region's
                # end and the cap)
                if p <= zl:
                    c = count(bz + 1)
                    if c == 0:
                        count(32 * (words - 1) - r)  # builds every word
                        run = _run_from(x, r, 0)
                        bz = max(bz + 1, min(run, ez - p, zcap))
                        zl, al = limits()
                        continue
                    step = c
                if p <= al:
                    c = count(ba + 1)
                    if c <= mm:
                        count(32 * (words - 1) - r)
                        run = _run_from(x, r, mm)
                        ba = max(ba + 1, min(run, ea - p, acap))
                        zl, al = limits()
                        continue
                    step = min(step, c - mm)
                # nor can a start before the first mismatch from p pass
                step = max(step, _ffs(word32()))
                r += step
                p += step
            if zskip:  # the chunk's Z tests were skipped: Z goes on after
                zl = ez - (bz + 1) if bz < zcap else -1
                if r < 32:
                    r, p = 32, base + 32
            if r < 32 or p >= pend or (p > zl and p > al):
                break
            x = x[1:] + [0xFFFFFFFF]
            have -= 1
            if have < 2:
                x[1] = word(nxt)
                nxt += 1
                have = 2
            base += 32
            r -= 32
    return bz, ba


def _replay(windows, ks, mm, words=None, tile=None):
    """gates and exact [W, nk] from the replay, on gates_plan's words and
    tile unless given; mm clamped as gates() clamps it."""
    seq, lens = repeats.pack(windows)
    W, L = seq.shape
    pl = repeats.gates_plan(W, L, ks, mm)
    words = pl.words if words is None else words
    G = pl.tile if tile is None else tile
    mm_k = max(min(mm, pl.kmax + 1), -1)
    g = np.zeros((W, len(ks)), bool)
    e = np.zeros((W, len(ks)), bool)
    for i in range(W):
        z, a = _replay_window(seq[i].astype(np.int64), int(lens[i]), pl.kmin,
                              pl.kmax, mm_k, words, G)
        for j, k in enumerate(ks):
            e[i, j] = z >= k
            g[i, j] = e[i, j] or a > k
    return g, e


def _planted(seed: int, n_windows: int, L: int):
    """Seeded windows up to L long, each random with 0-3 copies of an
    earlier stretch at a later shift (some overlapping their source, some
    with mismatches), N and lowercase bases in a few."""
    from lancet_tpu_torch.gpu import gatecases

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        n = int(rng.integers(0, L + 1))
        row = list(rng.choice(list("ACGTNa" if rng.random() < 0.2 else "ACGT"),
                              n))
        for _ in range(int(rng.integers(0, 4))):
            if n < 4:
                break
            s = int(rng.integers(1, n))
            length = int(rng.integers(1, max(2, n - s)))
            p = int(rng.integers(0, n - s - length + 1))
            n_mis = int(rng.integers(0, 4)) if s >= length >= 8 else 0
            gatecases.plant(row, p, s, length, n_mis, rng,
                            after=bool(rng.integers(0, 2)))
        out.append("".join(row))
    return out


# (seed, ks, mm, words, tile): words None and tile None take gates_plan's
REPLAY_CASES = [
    (1, [13], 2, None, None), (2, [0, 1, 2], 0, None, None),
    (3, ODD_KS, 2, None, None), (4, ODD_KS, -1, None, None),
    (5, [20, 11, 11, 30], 1, 2, 32), (6, [20, 11, 30], 3, 5, 32),
    (7, [13, 15, 17, 19], 2, 3, 64), (8, [40, 11], 8, 0, 64),
    (9, [31, 4, 6], 7, 4, 32), (10, [64, 100, 11], 40, 5, 128),
    (11, [9, 10], 0, 0, 32), (12, [33], 1, 3, 32),
    # Z alone (no A budget): the zero-pair filter decides which chunks
    # test, over tiles of several chunks
    (13, [7, 5], -1, None, 64), (14, [11, 20], -1, 2, 128),
    (15, [12, 30], 1, 2, 1024), (16, [13], -1, 2, 128)]


def test_replay_skip_lands_on_the_first_start_that_can_pass():
    # shift 1 of "ACGT" x 3 + "A" x 14: bits 1 1 1 ... then 0s; at mm 2 the
    # stretch of width 13 starting at 1 (two ones) is the longest, 2 longer
    # than the run of zeros a skip past it would find
    w = "CAGT" + "A" * 14
    for k in (12, 13, 14, 15):
        g, e = _replay([w], [k], 2)
        pg, pe = _plain([w], [k], 2)
        np.testing.assert_array_equal(g, pg)
        np.testing.assert_array_equal(e, pe)


@pytest.mark.parametrize("ks,tile", [([7], 1024), ([13], 1024),
                                     ([13], 128)])
def test_replay_z_filter_on_long_random_windows(ks, tile):
    # Z alone on random 600-base windows, whose longest exact repeats (7 to
    # 10 bases) hold no zero-nibble pair, and on two with a run of 20 in a
    # late chunk of a tile: the filter may skip only the chunks of runs
    # shorter than 11, and a skipped chunk must not end the tile
    from lancet_tpu_torch.gpu import gatecases

    rng = np.random.default_rng(8)
    windows = ["".join(rng.choice(list("ACGT"), 600)) for _ in range(3)]
    windows += [gatecases._near(rng, 600, [(300, 50, 20, 0, False)]),
                gatecases._near(rng, 600, [(100, 400, 20, 0, False)])]
    rg, re_ = _replay(windows, ks, -1, None, tile)
    pg, pe = _plain(windows, ks, -1)
    np.testing.assert_array_equal(rg, pg)
    np.testing.assert_array_equal(re_, pe)
    assert pe[3:].all() and (ks[0] > 7 or pe[:3].any())


@pytest.mark.parametrize("case", ["region_edges_mm0", "region_edges_mm2",
                                  "tile_edges_default_ks", "short_mm2",
                                  "widest_k128_mm0"])
def test_replay_on_crafted_cases(case):
    from lancet_tpu_torch.gpu import gatecases

    c = gatecases.gate_cases()[case]
    pg, pe = _plain(c["windows"], c["ks"], c["mm"])
    for words, tile in ((None, None), (None, 128), (None, 1024)):
        rg, re_ = _replay(c["windows"], c["ks"], c["mm"], words, tile)
        np.testing.assert_array_equal(rg, pg)
        np.testing.assert_array_equal(re_, pe)


@pytest.mark.parametrize("seed,ks,mm,words,tile", REPLAY_CASES)
def test_replay_of_the_tile_plan_matches_plain(seed, ks, mm, words, tile):
    windows = _planted(seed, 10, 150)
    if words is not None:
        widest = max(max(ks) + 1 if mm >= 0 else max(ks), 1)
        assert words == 0 or widest <= 32 * (words - 1)
    rg, re_ = _replay(windows, ks, mm, words, tile)
    pg, pe = _plain(windows, ks, mm)
    np.testing.assert_array_equal(rg, pg)
    np.testing.assert_array_equal(re_, pe)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    windows = corpus.repeat_windows() + ["", "A", "AA", "ACGT"]
    seq, lens = repeats.pack(windows)
    seq_d = torch.from_numpy(seq).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    for ks in (DEFAULT_KS, ODD_KS):
        for mm in (-1, 0, 1, 2, 3, 7, 8, 40):
            before = repeats.LAUNCHES["repeat_gates"]
            g, e = repeats.gates(seq_d, lens_d, ks, mm)
            torch.cuda.synchronize()
            assert repeats.LAUNCHES["repeat_gates"] == before + 1
            pg, pe = repeats.gates_plain(seq_d, lens_d, tuple(ks), mm)
            assert torch.equal(g, pg), (ks, mm)
            assert torch.equal(e, pe), (ks, mm)
