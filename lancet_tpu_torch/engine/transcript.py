"""Mutation transcript: per-event coverage accumulation and statistics
(ref: src/Transcript.hh).

Coverage rows are 10-field int vectors (see engine.node column order).
Stats follow the reference exactly: `min` seeded from the first row;
`min_non0` seeded from `min` (so a zero first row pins it to 0); `mean`
truncates float->ushort; `mean_non0` ceils (Transcript.hh:123-226).
"""

from __future__ import annotations

import math

import numpy as np


def _compute_stats(rows: list[np.ndarray]):
    n = len(rows)
    arr = np.stack(rows).astype(np.int64)
    first = arr[0]
    mn = first.copy()
    mn_non0 = first.copy()
    s = np.zeros(10, dtype=np.int64)
    s_non0 = np.zeros(10, dtype=np.int64)
    n_non0 = np.zeros(10, dtype=np.int64)
    for i in range(n):
        row = arr[i]
        # sum fields are unsigned short in the reference and wrap mod 2^16
        s = (s + row) & 0xFFFF
        nz = row != 0
        s_non0 = (s_non0 + np.where(nz, row, 0)) & 0xFFFF
        n_non0 += nz
        mn = np.minimum(mn, row)
        upd = nz & (row < mn_non0)
        mn_non0 = np.where(upd, row, mn_non0)
    mean = np.zeros(10, dtype=np.int64)
    if n > 0:
        # float->unsigned short assignment truncates
        mean = (s.astype(np.float32) / np.float32(n)).astype(np.int64)
    mean_non0 = np.zeros(10, dtype=np.int64)
    for c in range(10):
        if n_non0[c] > 0:
            mean_non0[c] = int(math.ceil(float(np.float32(s_non0[c]) / np.float32(n_non0[c]))))
    return mn, mn_non0, mean, mean_non0


class Transcript:
    def __init__(self, pos, ref_pos, start_pos, code, ref_c, qry_c,
                 alt_cov_nml, alt_cov_tmr, ref_cov_nml, ref_cov_tmr,
                 prev_bp_ref, prev_bp_alt, end_pos, ref_end_pos, flag):
        self.pos = pos
        self.ref_pos = ref_pos
        self.start_pos = start_pos
        self.code = code
        self.end_pos = end_pos
        self.ref_end_pos = ref_end_pos
        self.ref = ref_c
        self.qry = qry_c
        self.is_somatic = flag
        self.alt_cov_N = [np.array(alt_cov_nml, dtype=np.int64)]
        self.alt_cov_T = [np.array(alt_cov_tmr, dtype=np.int64)]
        self.ref_cov_N = [np.array(ref_cov_nml, dtype=np.int64)]
        self.ref_cov_T = [np.array(ref_cov_tmr, dtype=np.int64)]
        self.prev_bp_ref = prev_bp_ref
        self.prev_bp_alt = prev_bp_alt
        z = np.zeros(10, dtype=np.int64)
        self.min_alt_cov_N = self.min_non0_alt_cov_N = z
        self.min_alt_cov_T = self.min_non0_alt_cov_T = z
        self.mean_alt_cov_N = self.mean_non0_alt_cov_N = z
        self.mean_alt_cov_T = self.mean_non0_alt_cov_T = z
        self.min_ref_cov_N = self.min_non0_ref_cov_N = z
        self.min_ref_cov_T = self.min_non0_ref_cov_T = z
        self.mean_ref_cov_N = self.mean_non0_ref_cov_N = z
        self.mean_ref_cov_T = self.mean_non0_ref_cov_T = z

    def add_alt_cov_nml(self, c):
        self.alt_cov_N.append(np.array(c, dtype=np.int64))

    def add_alt_cov_tmr(self, c):
        self.alt_cov_T.append(np.array(c, dtype=np.int64))

    def add_ref_cov_nml(self, c):
        self.ref_cov_N.append(np.array(c, dtype=np.int64))

    def add_ref_cov_tmr(self, c):
        self.ref_cov_T.append(np.array(c, dtype=np.int64))

    def update_stats(self):
        (self.min_alt_cov_N, self.min_non0_alt_cov_N,
         self.mean_alt_cov_N, self.mean_non0_alt_cov_N) = _compute_stats(self.alt_cov_N)
        (self.min_alt_cov_T, self.min_non0_alt_cov_T,
         self.mean_alt_cov_T, self.mean_non0_alt_cov_T) = _compute_stats(self.alt_cov_T)
        (self.min_ref_cov_N, self.min_non0_ref_cov_N,
         self.mean_ref_cov_N, self.mean_non0_ref_cov_N) = _compute_stats(self.ref_cov_N)
        (self.min_ref_cov_T, self.min_non0_ref_cov_T,
         self.mean_ref_cov_T, self.mean_non0_ref_cov_T) = _compute_stats(self.ref_cov_T)

    # column indices: 0 fwd, 1 rev, 2 minqv_fwd, 3 minqv_rev,
    #                 4 hp0, 5 hp1, 6 hp2, 7 hp0_minqv, 8 hp1_minqv, 9 hp2_minqv
    def get_min_cov_N_fwd(self):
        return int(self.min_alt_cov_N[2] if self.code == "x" else self.min_alt_cov_N[0])

    def get_min_cov_N_rev(self):
        return int(self.min_alt_cov_N[3] if self.code == "x" else self.min_alt_cov_N[1])

    def get_min_cov_T_fwd(self):
        return int(self.min_alt_cov_T[2] if self.code == "x" else self.min_alt_cov_T[0])

    def get_min_cov_T_rev(self):
        return int(self.min_alt_cov_T[3] if self.code == "x" else self.min_alt_cov_T[1])

    def get_min_non0_cov_N_fwd(self):
        return int(self.min_non0_alt_cov_N[2] if self.code == "x" else self.min_non0_alt_cov_N[0])

    def get_min_non0_cov_N_rev(self):
        return int(self.min_non0_alt_cov_N[3] if self.code == "x" else self.min_non0_alt_cov_N[1])

    def get_min_cov_N_hp(self, hp: int):
        col = (7 + hp) if self.code == "x" else (4 + hp)
        return int(self.min_alt_cov_N[col])

    def get_min_cov_T_hp(self, hp: int):
        col = (7 + hp) if self.code == "x" else (4 + hp)
        return int(self.min_alt_cov_T[col])
