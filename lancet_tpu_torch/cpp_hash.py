"""Bit-exact emulation of libstdc++ (GCC 12) ``std::unordered_map<string, T>``
iteration order.

Why: the reference iterates its node table (``nodes_m``,
Graph.hh:68) during compression/cleanup, and which node survives a unitig
merge decides which constituent k-mer node donates per-base coverage rows
in unitig overlaps — observable in VCF coverage fields. Record-exact
parity therefore requires replaying libstdc++'s iteration order.

Components (all verified against a compiled probe on this toolchain):
- ``hash_bytes``: libstdc++ ``_Hash_bytes`` (Murmur-style, seed 0xc70f6907).
- ``_PRIMES``: the bucket-count ladder (extracted empirically via
  ``rehash(n)``/``bucket_count()`` probing).
- ``_Prime_rehash_policy._M_need_rehash`` semantics: first insert requests
  11 slots -> 13 buckets; growth request = max(floor(size+1)+1? -- see
  need_rehash below) with lower-bound into the prime ladder.
- ``_M_insert_bucket_begin`` / ``_M_rehash_aux`` / ``_M_erase`` list
  surgery: one global forward list; new nodes go to the front of their
  bucket's chain; an empty bucket's chain is spliced at the global head.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1
_MUL = 0xC6A4A7935BD1E995
_SEED = 0xC70F6907

_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
    31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 103, 109, 113, 127, 137,
    139, 149, 157, 167, 179, 193, 199, 211, 227, 241,
    257, 277, 293, 313, 337, 359, 383, 409, 439, 467,
    503, 541, 577, 619, 661, 709, 761, 823, 887, 953,
    1031, 1109, 1193, 1289, 1381, 1493, 1613, 1741, 1879, 2029,
    2179, 2357, 2549, 2753, 2971, 3209, 3469, 3739, 4027, 4349,
    4703, 5087, 5503, 5953, 6427, 6949, 7517, 8123, 8783, 9497,
    10273, 11113, 12011, 12983, 14033, 15173, 16411, 17749, 19183, 20753,
    22447, 24281, 26267, 28411, 30727, 33223, 35933, 38873, 42043, 45481,
    49201, 53201, 57557, 62233, 67307, 72817, 78779, 85229, 92203, 99733,
    107897, 116731, 126271, 136607, 147793, 159871, 172933, 187091, 202409, 218971,
    236897, 256279, 277261, 299951, 324503, 351061, 379787, 410857, 444487, 480881,
    520241, 562841, 608903, 658753, 712697, 771049, 834181, 902483, 976369, 1056323,
    1142821, 1236397, 1337629, 1447153, 1565659, 1693859, 1832561, 1982627, 2144977,
)

import bisect


def _shift_mix(v: int) -> int:
    return v ^ (v >> 47)


def hash_bytes(data: bytes, seed: int = _SEED) -> int:
    """libstdc++ _Hash_bytes (64-bit)."""
    ln = len(data)
    h = (seed ^ (ln * _MUL)) & _MASK
    end = ln & ~7
    for i in range(0, end, 8):
        chunk = int.from_bytes(data[i : i + 8], "little")
        d = (_shift_mix((chunk * _MUL) & _MASK) * _MUL) & _MASK
        h = ((h ^ d) * _MUL) & _MASK
    if ln & 7:
        tail = int.from_bytes(data[end:], "little")
        h = ((h ^ tail) * _MUL) & _MASK
    h = (_shift_mix(h) * _MUL) & _MASK
    return _shift_mix(h)


def _next_bkt(n: int) -> int:
    i = bisect.bisect_left(_PRIMES, n)
    if i >= len(_PRIMES):
        raise OverflowError("bucket ladder exhausted")
    return _PRIMES[i]


class _BB:  # before-begin sentinel
    __slots__ = ()


_BEFORE_BEGIN = _BB()


class CppUnorderedMap:
    """dict-like map whose iteration order replays libstdc++."""

    __slots__ = ("_val", "_next", "_head", "_nbkt", "_buckets",
                 "_next_resize", "_h")

    def __init__(self):
        self._val: dict[str, object] = {}
        self._next: dict[str, str | None] = {}
        self._head: str | None = None
        self._nbkt = 1
        self._buckets: list = [None]
        self._next_resize = 0
        self._h: dict[str, int] = {}

    # -- helpers --------------------------------------------------------
    def _after(self, before):
        return self._head if before is _BEFORE_BEGIN else self._next[before]

    def _set_after(self, before, key):
        if before is _BEFORE_BEGIN:
            self._head = key
        else:
            self._next[before] = key

    # -- dict API -------------------------------------------------------
    def __len__(self):
        return len(self._val)

    def __contains__(self, key):
        return key in self._val

    def get(self, key, default=None):
        return self._val.get(key, default)

    def __getitem__(self, key):
        return self._val[key]

    def __setitem__(self, key, value):
        if key in self._val:
            self._val[key] = value
            return
        self._insert_new(key, value)

    def keys(self):
        out = []
        p = self._head
        while p is not None:
            out.append(p)
            p = self._next[p]
        return out

    def values(self):
        return [self._val[k] for k in self.keys()]

    def items(self):
        return [(k, self._val[k]) for k in self.keys()]

    def __iter__(self):
        return iter(self.keys())

    # -- core surgery ---------------------------------------------------
    def _insert_new(self, key, value):
        h = hash_bytes(key.encode("latin-1"))
        self._h[key] = h
        n_elt = len(self._val)
        # _Prime_rehash_policy::_M_need_rehash (GCC 12): first allocation
        # requests 11 slots; growth = max(size+2, 2*buckets), lower-bound
        # into the prime ladder.
        if n_elt + 1 > self._next_resize:
            min_bkts = max(n_elt + 1, 11 if self._next_resize == 0 else 0)
            if min_bkts >= self._nbkt:
                self._rehash(_next_bkt(max(min_bkts + 1, self._nbkt * 2)))
            else:
                self._next_resize = self._nbkt
        bkt = h % self._nbkt
        before = self._buckets[bkt]
        if before is not None:
            # insert at bucket begin
            self._next[key] = self._after(before)
            self._set_after(before, key)
        else:
            self._next[key] = self._head
            old_head = self._head
            self._head = key
            if old_head is not None:
                self._buckets[self._h[old_head] % self._nbkt] = key
            self._buckets[bkt] = _BEFORE_BEGIN
        self._val[key] = value

    def _rehash(self, new_n: int) -> None:
        p = self._head
        self._head = None
        buckets: list = [None] * new_n
        bbegin_bkt = 0
        nxt_map = self._next
        hmap = self._h
        while p is not None:
            nxt = nxt_map[p]
            bkt = hmap[p] % new_n
            before = buckets[bkt]
            if before is None:
                nxt_map[p] = self._head
                self._head = p
                buckets[bkt] = _BEFORE_BEGIN
                if nxt_map[p] is not None:
                    buckets[bbegin_bkt] = p
                bbegin_bkt = bkt
            else:
                first = self._head if before is _BEFORE_BEGIN else nxt_map[before]
                nxt_map[p] = first
                if before is _BEFORE_BEGIN:
                    self._head = p
                else:
                    nxt_map[before] = p
            p = nxt
        self._buckets = buckets
        self._nbkt = new_n
        self._next_resize = new_n

    def __delitem__(self, key):
        h = self._h[key]
        bkt = h % self._nbkt
        before = self._buckets[bkt]
        prev = before
        cur = self._after(prev)
        is_bucket_first = True
        while cur != key:
            prev = cur
            cur = self._next[cur]
            is_bucket_first = False
        nxt = self._next[key]
        if is_bucket_first:
            next_bkt = (self._h[nxt] % self._nbkt) if nxt is not None else 0
            if nxt is None or next_bkt != bkt:
                if nxt is not None:
                    self._buckets[next_bkt] = self._buckets[bkt]
                self._buckets[bkt] = None
        else:
            if nxt is not None:
                next_bkt = self._h[nxt] % self._nbkt
                if next_bkt != bkt:
                    self._buckets[next_bkt] = prev
        self._set_after(prev, nxt)
        del self._val[key]
        del self._next[key]
        del self._h[key]
