// The device graph engine's build of one k attempt (gpu/dbg.py::build_k)
// for Hopper (sm_90a): four kernels, thirteen launches a build whatever k
// is. Plain C interface, loaded with ctypes by gpu/dbgk.py; each entry
// point returns cudaGetLastError() after its launch.
//
// The JAX package compiles the build into one XLA program a k and shape
// bucket (lancet_tpu/tpu/dbg.py::build_k :120, jitted at :116; no Pallas);
// the port's plain version (gpu/dbg.py::build_k_plain) is ~1,000 torch ops
// launched one by one from the host, most of them from per-base loops and
// the seven sorts' chains of sort and gather. Here:
//   mer_instances  <- dbg.py :152-235 and :459-468 (_pack_mers :54, the
//                     instance table, the quality gates, the mate keys)
//   window_sort    <- the build's stable sorts: the instance sort :264,
//                     the creation order :367, the canonical edges :461,
//                     the time order :501, the adjacency :518 and the
//                     mate overlap :575
//   node_tables    <- :239-327 (two launches: the groups, their first
//                     read times; then, after window_sort gives the
//                     creation order, the tables in that order and the
//                     prune)
//   edge_tables    <- :329-478 (four launches: the pair keys; their
//                     canonical groups and directed rows; the time order;
//                     the adjacency, the reference projection, the mate
//                     candidates and the fallback flags)
// The launch sequence (gpu/dbgk.py::build_k): mer_instances, window_sort
// (instances), node_tables 0, window_sort (node keys), node_tables 1,
// edge_tables 0, window_sort (pair keys), edge_tables 1, window_sort
// (times), edge_tables 2, window_sort (sources), window_sort (mate keys),
// edge_tables 3.
//
// What bounds them on this card: a build moves ~15 MB at k 13 in bucket 0
// (W 32: mq and totq, [W, N, K, 4] int32 and [W, N, K] int64, are most of
// it) and its instance tables are a few MB more, ~5 us of memory; the
// work is the sorts' compare-exchanges and the per-instance K-base loops.
// This first version is simple and right, one block of 1,024 threads a
// window for every kernel (32 of 132 SMs at W 32):
// - mer_instances: a thread an instance, its K bases read from device
//   memory (neighbouring threads neighbouring offsets), the read
//   instances' stream positions from a block scan in instance order;
// - window_sort: a bitonic network on (key words, index), so that it is
//   the stable sort whatever the keys (the index breaks every tie). A
//   window's records take 12-36 bytes each and bucket 3's instances
//   ~1.4 MB at one key word: more than a block's shared memory and, at
//   the mate sort's four words (~4.3 MB), more than a cluster's 16 x 227
//   KB. So the network runs through device memory: tiles of up to 16,384
//   records sorted and merged in shared memory, the strides past a tile
//   as passes over the window's records in device memory (L2-resident at
//   these sizes). One block a window, one launch a sort;
// - node_tables and edge_tables: block scans for the group boundaries,
//   shared-memory atomic minima for the groups' first times, a warp a
//   node for its counts (lanes over the group's instances, then each
//   lane's quality bits over the instances broadcast by shuffles), shared
//   counters for the adjacency's first slot and degree.
// Data outside what gpu/dbgk.py::build_plan takes gives wrong answers,
// never a fault: every index into shared memory is bounded.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper
constexpr long long kSent = 1LL << 62;
constexpr long long kBig = 1LL << 30;
constexpr int kBigI = 1 << 30;
constexpr long long kI32Max = 2147483647LL;
constexpr int kI32MaxI = 2147483647;
// the instance payload's bits (gpu/dbg.py P_*)
constexpr int kValid = 32, kRead = 33, kIdx = 34, kStrand = 35, kTflag = 36,
              kIsF = 37, kPair = 38, kTmr = 40, kNml = 41, kRef = 42,
              kOrder = 48;

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

__device__ __forceinline__ bool bit(long long pay, int b) {
  return (pay >> b) & 1;
}

// bits 0-31 of the payload as int32, sign-extended
__device__ __forceinline__ long long pay_time(long long pay) {
  return static_cast<long long>(
      static_cast<int>(static_cast<unsigned>(pay & 0xffffffffLL)));
}

// Python's // and % (floor) on int64, as torch's
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ long long floormod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ long long fliplink(long long d) {
  return ((d & 1) ^ 1) * 2 + ((d >> 1) ^ 1);
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// ws: kWarps ints of shared memory. Every thread of the block calls it.
__device__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = ws[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    ws[lane] = s;  // inclusive sums of the warps' totals
  }
  __syncthreads();
  const int before = (warp ? ws[warp - 1] : 0) + x - v;
  *total = ws[kWarps - 1];
  __syncthreads();  // ws is reused by the next call
  return before;
}

__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const long long y = __shfl_xor_sync(kFull, x, d);
    x = y < x ? y : x;
  }
  return x;
}

// ---------------------------------------------------------------------------
// mer words (gpu/dbg.py's packing: int64 words of 31 bases, most
// significant word first, the last word full, first base most significant)
// ---------------------------------------------------------------------------

struct Words {
  long long w[3];
};

// The forward and reverse-complement words of the K bases at b, and
// whether every base is below 4.
__device__ __forceinline__ void mer_words(const uint8_t* b, int K, int NW,
                                          Words& f, Words& r, bool& ok) {
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    long long fv = 0, rv = 0;
    if (i < NW) {
      const int lo = max(K - 31 * (NW - i), 0), hi = K - 31 * (NW - 1 - i);
      for (int j = lo; j < hi; ++j) {
        const int c = b[j];
        bad |= c >= 4;
        fv = (fv << 2) | (c & 3);
      }
      // the reverse complement holds comp(b_j) at distance j from its end
      const int rlo = 31 * (NW - 1 - i), rhi = min(31 * (NW - i), K);
      for (int j = rhi - 1; j >= rlo; --j) rv = (rv << 2) | ((b[j] & 3) ^ 3);
    }
    f.w[i] = fv;
    r.w[i] = rv;
  }
  ok = !bad;
}

__device__ __forceinline__ bool lex_less(const Words& a, const Words& b,
                                         int NW) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < NW && a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  return false;
}

__device__ __forceinline__ Words pick(bool f, const Words& a,
                                      const Words& b) {
  Words o;
#pragma unroll
  for (int i = 0; i < 3; ++i) o.w[i] = f ? a.w[i] : b.w[i];
  return o;
}

// ---------------------------------------------------------------------------
// mer_instances
// ---------------------------------------------------------------------------

struct InstArgs {
  const uint8_t* bases;  // [W, R, L]
  const uint8_t* quals;
  const int32_t* rlen;  // [W, R]
  const int8_t* rsample;
  const int8_t* rstrand;
  const int32_t* rfrag;
  const int8_t* rorder;
  const uint8_t* raw;  // [W, Lraw]
  const int32_t* rawlen;  // [W]
  const int32_t* seq_off;
  const int32_t* seq_len;
  const uint8_t* window_ok;
  long long* keys;   // [NW, W, I]
  long long* pay;    // [W, I]
  long long* qok;    // [W, I]
  long long* fkeys;  // [NW + 1, W, IP]
  int W, R, L, Lraw, K, NW, M, Mraw, I, IP, minq;
};

__global__ void __launch_bounds__(kThreads)
    mer_instances_kernel(const InstArgs a) {
  __shared__ int ws[kWarps];
  const int w = blockIdx.x;
  const bool okW = a.window_ok[w] != 0;
  const int K = a.K, NW = a.NW, M = a.M, L = a.L, R = a.R, Mraw = a.Mraw;
  const int RM = R * M;
  const long long plane = static_cast<long long>(a.W) * a.I;
  const long long fplane = static_cast<long long>(a.W) * a.IP;
  long long* keys = a.keys + static_cast<long long>(w) * a.I;
  long long* pay = a.pay + static_cast<long long>(w) * a.I;
  long long* qok = a.qok + static_cast<long long>(w) * a.I;
  long long* fkeys = a.fkeys + static_cast<long long>(w) * a.IP;

  // the read instances, in (read, offset) order: the stream position g
  // of a valid one is the count of valid ones before it
  int carry = 0;
  for (int base = 0; base < RM; base += kThreads) {
    const int q = base + threadIdx.x;
    bool inst_valid = false, is_last = false, isF = false, tflag = false;
    int m = 0, samp = 0, order = 0;
    long long qk = 0;
    Words mw{};
    const int rr = q < RM ? q / M : 0;
    if (q < RM) {
      m = q - rr * M;
      const long long row = static_cast<long long>(w) * R + rr;
      const int rl = a.rlen[row];
      const int n_mers = max(rl - K + 1, 0);
      const bool use_read = rl - K > 0;  // a single-mer read is skipped
      const uint8_t* b = a.bases + row * L;
      const uint8_t* qu = a.quals + row * L;
      Words f, r;
      bool bok;
      mer_words(b + m, K, NW, f, r, bok);
      isF = lex_less(f, r, NW);
      mw = pick(isF, f, r);
      // quality bits of mer m; the pair gates of m (quals m..m+K) and of
      // m-1 (quals m-1..m+K-1); the bases of mer m-1
      long long qf = 0, qr = 0;
      bool qbad = false, qbad_prev = false, bad_prev = false;
      for (int j = -1; j <= K; ++j) {
        const int pos = m + j;
        if (pos < 0 || pos >= L) continue;
        const bool qb = static_cast<int>(qu[pos]) < a.minq;
        if (j >= 0) qbad |= qb;
        if (j <= K - 1) qbad_prev |= qb;
        if (j <= K - 2) bad_prev |= b[pos] >= 4;
        if (j >= 0 && j < K && !qb) {
          qf |= 1LL << j;
          qr |= 1LL << (K - 1 - j);
        }
      }
      qk = isF ? qf : qr;
      inst_valid = use_read && m < n_mers && bok;
      is_last = m == n_mers - 1;
      samp = a.rsample[row];
      const bool tmr = samp == 0;
      const bool pair_ok = m < L - K && !qbad && tmr && !is_last &&
                           inst_valid;
      const bool prev_ok = m >= 1 && !qbad_prev && tmr &&
                           m - 1 != n_mers - 1 && use_read &&
                           m - 1 < n_mers && !bad_prev;
      tflag = pair_ok || prev_ok;
      order = a.rorder[row];
    }
    int total;
    const int before = block_scan(inst_valid ? 1 : 0, ws, &total);
    if (q < RM) {
      const long long row = static_cast<long long>(w) * R + rr;
      const bool isread = inst_valid && okW;
      const long long g = carry + before;  // where inst_valid
      const long long t = 2 * g - (m > 0 ? 1 : 0);
      const bool paired = order > 0 && inst_valid;
      long long pv = (isread ? t : kBig) & 0xffffffffLL;
      pv |= static_cast<long long>(isread) << kValid;
      pv |= static_cast<long long>(isread) << kRead;
      pv |= static_cast<long long>(a.rstrand[row] != 0) << kStrand;
      pv |= static_cast<long long>(tflag) << kTflag;
      pv |= static_cast<long long>(isF) << kIsF;
      pv |= static_cast<long long>(inst_valid && !is_last && okW) << kPair;
      pv |= static_cast<long long>(samp == 0) << kTmr;
      pv |= static_cast<long long>(samp == 1) << kNml;
      pv |= static_cast<long long>(samp == 2) << kRef;
      if (paired) pv |= static_cast<long long>(order) << kOrder;
      pay[q] = pv;
      qok[q] = qk;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i < NW) {
          keys[i * plane + q] = isread ? mw.w[i] : kSent;
          fkeys[i * fplane + q] = paired ? mw.w[i] : kSent;
        }
      }
      fkeys[NW * fplane + q] =
          paired ? static_cast<long long>(a.rfrag[row]) : kI32Max;
    }
    carry += total;
  }

  // the ref pseudo-read, the projection and the index, Mraw each
  const uint8_t* rb = a.raw + static_cast<long long>(w) * a.Lraw;
  const int rawlen = a.rawlen[w];
  const long long seq_off = a.seq_off[w];
  const int seq_len = a.seq_len[w];
  const int ref_nmers = max(rawlen - K + 1, 0);
  const bool ref_use = rawlen - K > 0;
  for (int ro = threadIdx.x; ro < Mraw; ro += kThreads) {
    Words f, r;
    bool pok;
    mer_words(rb + ro, K, NW, f, r, pok);
    const bool pisF = lex_less(f, r, NW);
    const Words pw = pick(pisF, f, r);
    const bool ref_valid = ro < ref_nmers && pok && ref_use;
    const bool rv = ref_valid && okW;
    const long long tr = 2 * (static_cast<long long>(carry) + ro) -
                         (ro > 0 ? 1 : 0);
    long long pv = (rv ? tr : kBig) & 0xffffffffLL;
    pv |= static_cast<long long>(rv) << kValid;
    pv |= static_cast<long long>(rv) << kRead;
    pv |= static_cast<long long>(pisF) << kIsF;
    pv |= static_cast<long long>(rv && ro != ref_nmers - 1) << kPair;
    pv |= 1LL << kRef;
    const int qr = RM + ro, qp = RM + Mraw + ro, qi = RM + 2 * Mraw + ro;
    pay[qr] = pv;
    qok[qr] = 0;
    const bool pv_ok = ro < rawlen - K + 1 && pok && okW;
    pay[qp] = kBig | (static_cast<long long>(pv_ok) << kValid) |
              (static_cast<long long>(pisF) << kIsF);
    qok[qp] = 0;
    // the index's mer at seq_off + ro, clamped into the ref
    const long long ipos = seq_off + ro;
    const int ip = static_cast<int>(ipos < 0 ? 0
                                    : (ipos > Mraw - 1 ? Mraw - 1 : ipos));
    Words fi, ri;
    bool iok;
    mer_words(rb + ip, K, NW, fi, ri, iok);
    const Words iw = pick(lex_less(fi, ri, NW), fi, ri);
    const bool iv = ro < seq_len - K && ipos < Mraw && iok && okW;
    pay[qi] = kBig | (static_cast<long long>(iv) << kValid) |
              (static_cast<long long>(iv) << kIdx);
    qok[qi] = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i < NW) {
        keys[i * plane + qr] = rv ? pw.w[i] : kSent;
        keys[i * plane + qp] = pv_ok ? pw.w[i] : kSent;
        keys[i * plane + qi] = iv ? iw.w[i] : kSent;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// window_sort: a bitonic network on (NK key words, index) records
// ---------------------------------------------------------------------------

struct SortArgs {
  const long long* keys;  // key c, window w, element i: c*ps + w*wst + i
  long long ps, wst;
  long long* perm;   // [W, n]
  long long* skeys;  // [NK, W, P] (P > T only)
  int* sidx;         // [W, P]
  int W, n, P, T;
};

template <int NK>
struct Rec {
  long long k[NK];
  int i;
};

// a > b in (keys, index) order
template <int NK>
__device__ __forceinline__ bool greater(const Rec<NK>& a, const Rec<NK>& b) {
#pragma unroll
  for (int c = 0; c < NK; ++c)
    if (a.k[c] != b.k[c]) return a.k[c] > b.k[c];
  return a.i > b.i;
}

template <int NK>
__device__ __forceinline__ Rec<NK> sload(const long long* sk, const int* si,
                                         int T, int l) {
  Rec<NK> r;
#pragma unroll
  for (int c = 0; c < NK; ++c) r.k[c] = sk[c * T + l];
  r.i = si[l];
  return r;
}

template <int NK>
__device__ __forceinline__ void sstore(long long* sk, int* si, int T, int l,
                                       const Rec<NK>& r) {
#pragma unroll
  for (int c = 0; c < NK; ++c) sk[c * T + l] = r.k[c];
  si[l] = r.i;
}

// The bitonic stages j = jtop, jtop/2, .., 1 of merge size k on the tile
// in shared memory whose first record is element t0 of the window.
template <int NK>
__device__ void tile_stages(long long* sk, int* si, int T, long long t0,
                            long long k, int jtop) {
  for (int j = jtop; j >= 1; j >>= 1) {
    for (int h = threadIdx.x; h < T / 2; h += kThreads) {
      const int l = ((h & ~(j - 1)) << 1) | (h & (j - 1));  // j: 2^m
      const bool asc = ((t0 + l) & k) == 0;
      const Rec<NK> x = sload<NK>(sk, si, T, l);
      const Rec<NK> y = sload<NK>(sk, si, T, l + j);
      if (asc ? greater(x, y) : greater(y, x)) {
        sstore<NK>(sk, si, T, l, y);
        sstore<NK>(sk, si, T, l + j, x);
      }
    }
    __syncthreads();
  }
}

template <int NK>
__global__ void __launch_bounds__(kThreads)
    window_sort_kernel(const SortArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, P = a.P, n = a.n;
  long long* sk = reinterpret_cast<long long*>(smem);
  int* si = reinterpret_cast<int*>(smem + round16(sizeof(long long) * NK * T));
  const int w = blockIdx.x;
  const long long* keys = a.keys + static_cast<long long>(w) * a.wst;
  long long* perm = a.perm + static_cast<long long>(w) * n;
  const long long gps = static_cast<long long>(a.W) * P;  // scratch plane
  long long* gk = a.skeys + static_cast<long long>(w) * P;
  int* gi = a.sidx + static_cast<long long>(w) * P;
  const bool one = P == T;  // the window fits one tile

  // a tile out of shared memory: to the permutation, or to the scratch
  auto put_tile = [&](long long t0, bool last) {
    for (int l = threadIdx.x; l < T; l += kThreads) {
      if (last) {
        if (t0 + l < n) perm[t0 + l] = si[l];
      } else {
#pragma unroll
        for (int c = 0; c < NK; ++c) gk[c * gps + t0 + l] = sk[c * T + l];
        gi[t0 + l] = si[l];
      }
    }
    __syncthreads();
  };

  // every tile sorted, in the direction its merge of size 2T wants;
  // elements past n are (INT64_MAX words, index) records, last in order
  for (long long t0 = 0; t0 < P; t0 += T) {
    for (int l = threadIdx.x; l < T; l += kThreads) {
      const long long i = t0 + l;
#pragma unroll
      for (int c = 0; c < NK; ++c)
        sk[c * T + l] = i < n ? keys[c * a.ps + i] : LLONG_MAX;
      si[l] = static_cast<int>(i);
    }
    __syncthreads();
    for (long long k = 2; k <= T; k <<= 1)
      tile_stages<NK>(sk, si, T, t0, k, static_cast<int>(k >> 1));
    put_tile(t0, one);
  }
  if (one) return;

  // merges past a tile: the strides >= T through device memory, then the
  // rest tile by tile in shared memory
  for (long long k = 2LL * T; k <= P; k <<= 1) {
    for (long long j = k >> 1; j >= T; j >>= 1) {
      for (long long h = threadIdx.x; h < P / 2; h += kThreads) {
        const long long l = ((h & ~(j - 1)) << 1) | (h & (j - 1)), u = l + j;
        const bool asc = (l & k) == 0;
        Rec<NK> x, y;
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          x.k[c] = gk[c * gps + l];
          y.k[c] = gk[c * gps + u];
        }
        x.i = gi[l];
        y.i = gi[u];
        if (asc ? greater(x, y) : greater(y, x)) {
#pragma unroll
          for (int c = 0; c < NK; ++c) {
            gk[c * gps + l] = y.k[c];
            gk[c * gps + u] = x.k[c];
          }
          gi[l] = y.i;
          gi[u] = x.i;
        }
      }
      __syncthreads();
    }
    for (long long t0 = 0; t0 < P; t0 += T) {
      for (int l = threadIdx.x; l < T; l += kThreads) {
#pragma unroll
        for (int c = 0; c < NK; ++c) sk[c * T + l] = gk[c * gps + t0 + l];
        si[l] = gi[t0 + l];
      }
      __syncthreads();
      tile_stages<NK>(sk, si, T, t0, k, T >> 1);
      put_tile(t0, k == P);
    }
  }
}

// ---------------------------------------------------------------------------
// node_tables
// ---------------------------------------------------------------------------

struct NodeArgs {
  const long long* keys;  // [NW, W, I]
  const long long* pay;   // [W, I]
  const long long* qok;   // [W, I]
  const long long* perm;  // [W, I]
  const long long* order;  // [W, N] (phase 1)
  const int32_t* rawlen;   // [W]
  const int32_t* totalreadbp;
  long long* node_key;  // [W, N]
  int* gstart;          // [W, N + 1]
  uint8_t* over_n;      // [W]
  long long* mers;      // [NW, W, N]
  long long* counts;    // [W, N, 4]
  int* mq;              // [W, N, K, 4]
  long long* totq;      // [W, N, K]
  long long* mincov_qv;  // [W, N]
  uint8_t *exists, *alive, *low, *in_index, *is_tumor, *is_normal;
  long long* n_nodes;   // [W]
  float* avgcov;        // [W]
  long long* rawlen_dev;
  long long* nid;       // [W, I]
  int W, I, N, K, NW;
  long long low_cov_threshold;
  float min_cov_ratio;
};

struct NodeLayout {
  size_t gs, nk, total;
};

__host__ __device__ inline NodeLayout node_layout(int N) {
  NodeLayout o{};
  o.gs = 0;
  o.nk = round16(sizeof(int) * (N + 1));
  o.total = o.nk + round16(sizeof(int) * N);
  return o;
}

__device__ __forceinline__ bool words_differ(const long long* keys,
                                             long long plane, int NW,
                                             long long x, long long y) {
  bool d = false;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < NW) d |= keys[i * plane + x] != keys[i * plane + y];
  return d;
}

// phase 0: the groups of equal keys in sorted order (their starts, at
// most N + 1, into gstart; over_n) and each group's first read time
__device__ __forceinline__ void node_groups(const NodeArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ws[kWarps];
  const int N = a.N, I = a.I, w = blockIdx.x;
  const NodeLayout lay = node_layout(N);
  int* gs = reinterpret_cast<int*>(smem + lay.gs);
  int* nk = reinterpret_cast<int*>(smem + lay.nk);
  const long long plane = static_cast<long long>(a.W) * I;
  const long long* keys = a.keys + static_cast<long long>(w) * I;
  const long long* pay = a.pay + static_cast<long long>(w) * I;
  const long long* perm = a.perm + static_cast<long long>(w) * I;
  for (int g = threadIdx.x; g < N; g += kThreads) nk[g] = kBigI;
  __syncthreads();
  int carry = 0, nvalid = 0;
  for (int base = 0; base < I; base += kThreads) {
    const int p = base + threadIdx.x;
    int newg = 0, valid = 0, tm = kBigI;
    if (p < I) {
      const long long x = perm[p];
      const long long pv = pay[x];
      valid = bit(pv, kValid);
      if (valid) {
        tm = static_cast<int>(pay_time(pv));
        newg = p == 0 || words_differ(keys, plane, a.NW, x, perm[p - 1]);
      }
    }
    int total;
    const int before = block_scan(newg, ws, &total);
    const int gid = carry + before + newg - 1;
    if (newg && gid <= N) gs[gid] = p;
    if (valid && gid < N) atomicMin(&nk[gid], tm);
    nvalid += __syncthreads_count(valid);
    carry += total;
  }
  for (int g = threadIdx.x; g <= N; g += kThreads)
    if (g >= carry) gs[g] = nvalid;
  __syncthreads();
  int* gout = a.gstart + static_cast<long long>(w) * (N + 1);
  for (int g = threadIdx.x; g <= N; g += kThreads) gout[g] = gs[g];
  for (int g = threadIdx.x; g < N; g += kThreads)
    a.node_key[static_cast<long long>(w) * N + g] = nk[g];
  if (threadIdx.x == 0) a.over_n[w] = carry > N;
}

// phase 1: after window_sort gives the creation order, a warp a creation
// slot: its group's instances (their nodes into nid), counts, quality
// counts, flags and mer words, then the prune
__device__ __forceinline__ void node_order(const NodeArgs& a) {
  __shared__ int n_nodes;
  const int N = a.N, I = a.I, K = a.K, NW = a.NW, w = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long plane = static_cast<long long>(a.W) * I;
  const long long wI = static_cast<long long>(w) * I;
  const long long* keys = a.keys + wI;
  const long long* pay = a.pay + wI;
  const long long* qok = a.qok + wI;
  const long long* perm = a.perm + wI;
  const int* gs = a.gstart + static_cast<long long>(w) * (N + 1);
  long long* nid = a.nid + wI;
  for (int i = threadIdx.x; i < I; i += kThreads) nid[i] = -1;
  if (threadIdx.x == 0) n_nodes = 0;
  __syncthreads();
  const float avg =
      __fdiv_rn(static_cast<float>(a.totalreadbp[w]),
                fmaxf(static_cast<float>(static_cast<long long>(a.rawlen[w])),
                      1.0f));
  const float thr = __fmul_rn(a.min_cov_ratio, avg);
  for (int c = warp; c < N; c += kWarps) {
    const long long wc = static_cast<long long>(w) * N + c;
    const long long g = a.order[wc];
    const int gg = static_cast<int>(g < 0 ? 0 : (g > N - 1 ? N - 1 : g));
    const int s = gs[gg], e = gs[gg + 1];
    int lo0 = 0, lo1 = 0, lo2 = 0, lo3 = 0, hi0 = 0, hi1 = 0, hi2 = 0, hi3 = 0;
    long long c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    bool has = false, inidx = false, nml = false, tum = false;
    for (int base = s; base < e; base += 32) {
      const int p = base + lane;
      long long pv = 0, q = 0;
      if (p < e) {
        const long long x = perm[p];
        pv = pay[x];
        q = qok[x];
        nid[x] = c;
      }
      has |= __any_sync(kFull, bit(pv, kRead));
      inidx |= __any_sync(kFull, bit(pv, kIdx));
      nml |= __any_sync(kFull, bit(pv, kRead) && bit(pv, kNml));
      tum |= __any_sync(kFull, bit(pv, kTflag));
      const int cnt = min(32, e - base);
      for (int t = 0; t < cnt; ++t) {
        const long long pt = __shfl_sync(kFull, pv, t);
        const long long qt = __shfl_sync(kFull, q, t);
        if (!bit(pt, kRead) || bit(pt, kRef)) continue;  // not coverage
        const int lo = static_cast<int>((qt >> lane) & 1);
        const int hi = static_cast<int>((qt >> (lane + 32)) & 1);
        const int cls = (bit(pt, kTmr) ? 0 : 2) + (bit(pt, kStrand) ? 1 : 0);
        if (cls == 0) {
          lo0 += lo; hi0 += hi; ++c0;
        } else if (cls == 1) {
          lo1 += lo; hi1 += hi; ++c1;
        } else if (cls == 2) {
          lo2 += lo; hi2 += hi; ++c2;
        } else {
          lo3 += lo; hi3 += hi; ++c3;
        }
      }
    }
    // the group's mer (all-T words for a group without instances)
    if (lane < NW) {
      long long v;
      if (s < e) {
        v = keys[lane * plane + perm[s]];
      } else {
        const int nb = lane == 0 ? K - 31 * (NW - 1) : 31;
        v = (1LL << (2 * nb)) - 1;
      }
      a.mers[lane * static_cast<long long>(a.W) * N + wc] = v;
    }
    long long tmin = LLONG_MAX;
    if (lane < K) {
      reinterpret_cast<int4*>(a.mq)[wc * K + lane] =
          make_int4(lo0, lo1, lo2, lo3);
      const long long t = static_cast<long long>(lo0) + lo1 + lo2 + lo3;
      a.totq[wc * K + lane] = t;
      tmin = t;
    }
    if (lane + 32 < K) {
      reinterpret_cast<int4*>(a.mq)[wc * K + lane + 32] =
          make_int4(hi0, hi1, hi2, hi3);
      const long long t = static_cast<long long>(hi0) + hi1 + hi2 + hi3;
      a.totq[wc * K + lane + 32] = t;
      tmin = t < tmin ? t : tmin;
    }
    tmin = warp_min(tmin);
    if (lane == 0) {
      long long* cn = a.counts + wc * 4;
      cn[0] = c0;
      cn[1] = c1;
      cn[2] = c2;
      cn[3] = c3;
      const long long mincov = has ? tmin : 0;
      const bool low = mincov <= a.low_cov_threshold ||
                       __ll2float_rn(mincov) <= thr ||
                       (c0 + c1 == 1 && c2 + c3 == 1);
      a.mincov_qv[wc] = mincov;
      a.exists[wc] = has;
      a.alive[wc] = has && !low;
      a.low[wc] = low;
      a.in_index[wc] = inidx;
      a.is_tumor[wc] = tum;
      a.is_normal[wc] = nml;
      if (has) atomicAdd(&n_nodes, 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.n_nodes[w] = n_nodes;
    a.avgcov[w] = avg;
    a.rawlen_dev[w] = a.rawlen[w];
  }
}

// one kernel, two launches: phase 0 before the creation order's sort,
// phase 1 after it
__global__ void __launch_bounds__(kThreads)
    node_tables_kernel(const NodeArgs a, int phase) {
  if (phase == 0)
    node_groups(a);
  else
    node_order(a);
}

// ---------------------------------------------------------------------------
// edge_tables
// ---------------------------------------------------------------------------

struct EdgeArgs {
  const long long* pay;   // [W, I]
  const long long* nid;   // [W, I]
  const long long* counts;  // [W, N, 4]
  const uint8_t* in_index;  // [W, N]
  const uint8_t* over_n;    // [W]
  const long long* rawlen;  // [W] (node_tables' rawlen_dev)
  const uint8_t* window_ok;
  const long long* fkeys;   // [NW + 1, W, IP]
  const long long* fperm;   // [W, IP]
  long long* ckey;   // [W, PU]
  long long* tab;    // [W, PU]: tA | tB << 32
  const long long* cperm;   // [W, PU]
  long long* de_src;  // [W, 2E]
  long long* de_dst;
  long long* de_dx;   // dir | exists << 2
  long long* et_key;
  const long long* eorder;  // [W, 2E]
  uint8_t* over_e;    // [W]
  long long* ak_key;  // [W, E]
  const long long* aperm;  // [W, E]
  long long* n_edges;  // [W]
  long long* edge_src;  // [W, E]
  long long* edge_dst;
  long long* edge_dir;
  uint8_t* edge_exists;
  long long* adj;  // [W, N, D]
  long long* deg;  // [W, N]
  long long* nid_proj;  // [W, Mraw]
  uint8_t* proj_isF;
  long long* refcov;  // [W, Lraw, 4]
  uint8_t* mate_cand;  // [W]
  uint8_t* fallback;
  int W, R, M, Mraw, Lraw, K, NW, I, IP, PU, N, E, D;
};

struct EdgeLayout {
  size_t a, b, c, total;
};

// phase 1: group starts, tA and tB minima [E + 1, E, E] ints; phase 3:
// the first slot and count of each source [N + 64] ints twice
__host__ __device__ inline EdgeLayout edge_layout(int phase, int N, int E) {
  EdgeLayout o{};
  if (phase == 1) {
    o.b = round16(sizeof(int) * (E + 1));
    o.c = o.b + round16(sizeof(int) * E);
    o.total = o.c + round16(sizeof(int) * E);
  } else if (phase == 3) {
    o.b = round16(sizeof(int) * (N + 64));
    o.total = 2 * o.b;
  }
  return o;
}

// phase 0: each adjacent pair's canonical key and its two time lanes
__device__ __forceinline__ void edge_pairs(const EdgeArgs& a) {
  const int w = blockIdx.x, M = a.M, Mraw = a.Mraw, RM = a.R * a.M;
  const long long wI = static_cast<long long>(w) * a.I;
  const long long* pay = a.pay + wI;
  const long long* nid = a.nid + wI;
  const long long NODECAP = a.N + 64;
  for (int q = threadIdx.x; q < a.PU; q += kThreads) {
    int off;
    bool nxt;
    if (q < RM) {
      off = q % M;
      nxt = off + 1 < M;
    } else {
      off = q - RM;
      nxt = off + 1 < Mraw;
    }
    const long long pv = pay[q];
    const long long u = nid[q];
    const long long v = nxt ? nid[q + 1] : -1;
    const long long uF = bit(pv, kIsF);
    const long long vF = nxt ? bit(pay[q + 1], kIsF) : 0;
    const bool pm = bit(pv, kPair);
    const long long t = pay_time(pv) + (off > 0 ? 1 : 0);
    const long long fdir = (1 - uF) * 2 + (1 - vF);
    const long long rdir = fliplink(fdir);
    const bool tw = v < u || (v == u && rdir < fdir);
    const long long cs = tw ? v : u, cd = tw ? u : v, cr = tw ? rdir : fdir;
    const long long ck = pm ? (cs * NODECAP + cd) * 4 + cr : kI32Max;
    const long long tA = pm && !tw ? t : kBig;
    const long long tB = pm && tw ? t : kBig;
    const long long o = static_cast<long long>(w) * a.PU + q;
    a.ckey[o] = ck;
    a.tab[o] = (tA & 0xffffffffLL) | (tB << 32);
  }
}

// phase 1: the canonical groups of the sorted pair keys (at most E) and
// their directed rows, each with its time key
__device__ __forceinline__ void edge_groups(const EdgeArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ws[kWarps];
  __shared__ int n_self;
  const int w = blockIdx.x, E = a.E, PU = a.PU;
  const EdgeLayout lay = edge_layout(1, a.N, E);
  int* es = reinterpret_cast<int*>(smem);
  int* sA = reinterpret_cast<int*>(smem + lay.b);
  int* sB = reinterpret_cast<int*>(smem + lay.c);
  const long long wP = static_cast<long long>(w) * PU;
  const long long* ckey = a.ckey + wP;
  const long long* tab = a.tab + wP;
  const long long* cperm = a.cperm + wP;
  for (int g = threadIdx.x; g < E; g += kThreads) sA[g] = sB[g] = kI32MaxI;
  if (threadIdx.x == 0) n_self = 0;
  __syncthreads();
  int carry = 0, nev = 0;
  for (int base = 0; base < PU; base += kThreads) {
    const int p = base + threadIdx.x;
    int enew = 0, ev = 0;
    long long tb = 0;
    if (p < PU) {
      const long long x = cperm[p];
      const long long ck = ckey[x];
      ev = ck != kI32Max;
      if (ev) {
        enew = p == 0 || ck != ckey[cperm[p - 1]];
        tb = tab[x];
      }
    }
    int total;
    const int before = block_scan(enew, ws, &total);
    const int gid = carry + before + enew - 1;
    if (enew && gid <= E) es[gid] = p;
    if (ev && gid < E) {
      atomicMin(&sA[gid], static_cast<int>(tb & 0xffffffffLL));
      atomicMin(&sB[gid], static_cast<int>(tb >> 32));
    }
    nev += __syncthreads_count(ev);
    carry += total;
  }
  for (int g = threadIdx.x; g <= E; g += kThreads)
    if (g >= carry) es[g] = nev;
  __syncthreads();
  const long long NODECAP = a.N + 64;
  const long long w2 = static_cast<long long>(w) * 2 * E;
  for (int g = threadIdx.x; g < E; g += kThreads) {
    const long long ck = es[g] < es[g + 1] ? ckey[cperm[es[g]]] : kI32Max;
    const long long gA = sA[g], gB = sB[g];
    const bool ex = ck != kI32Max;
    const long long dir = ex ? floormod(ck, 4) : 0;
    const long long dst = ex ? floormod(floordiv(ck, 4), NODECAP) : 0;
    const long long src = ex ? floordiv(ck, 4 * NODECAP) : 0;
    const long long tc = min(gA, min(gB, kBig - 1) + 1);
    const long long tt = min(gB, min(gA, kBig - 1) + 1);
    const bool selftw = ex && src == dst && (dir == 1 || dir == 2);
    const bool ex2 = ex && !selftw;
    a.de_src[w2 + g] = src;
    a.de_dst[w2 + g] = dst;
    a.de_dx[w2 + g] = dir | (static_cast<long long>(ex) << 2);
    a.et_key[w2 + g] = ex ? tc : kBig;
    a.de_src[w2 + E + g] = dst;
    a.de_dst[w2 + E + g] = src;
    a.de_dx[w2 + E + g] = fliplink(dir) | (static_cast<long long>(ex2) << 2);
    a.et_key[w2 + E + g] = ex2 ? tt : kBig;
    if (selftw) atomicAdd(&n_self, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long n_edges = 2LL * min(carry, E) - n_self;
    a.n_edges[w] = n_edges;
    a.over_e[w] = n_edges > E || carry > E;
  }
}

// phase 2: the directed rows in time order, truncated to E; the sources'
// sort key; deg zeroed for phase 3's sums
__device__ __forceinline__ void edge_order(const EdgeArgs& a) {
  const int w = blockIdx.x, E = a.E;
  const long long w2 = static_cast<long long>(w) * 2 * E;
  const long long wE = static_cast<long long>(w) * E;
  for (int t = threadIdx.x; t < E; t += kThreads) {
    const long long o = a.eorder[w2 + t];
    const long long dx = a.de_dx[w2 + o];
    const bool ex = (dx >> 2) & 1;
    const long long src = ex ? a.de_src[w2 + o] : -1;
    a.edge_src[wE + t] = src;
    a.edge_dst[wE + t] = ex ? a.de_dst[w2 + o] : -1;
    a.edge_dir[wE + t] = ex ? (dx & 3) : 0;
    a.edge_exists[wE + t] = src >= 0;
    a.ak_key[wE + t] = src >= 0 ? src : kI32Max;
  }
  for (int v = threadIdx.x; v < a.N; v += kThreads)
    a.deg[static_cast<long long>(w) * a.N + v] = 0;
}

// phase 3: the adjacency and degrees, the reference projection, the mate
// candidates and the fallback flags
__device__ __forceinline__ void edge_adj(const EdgeArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = blockIdx.x, E = a.E, N = a.N, D = a.D, K = a.K;
  const int NC = N + 64;  // sources: node ids and the N + 63 of a pair
                          // whose two mers are past N
  const EdgeLayout lay = edge_layout(3, N, E);
  int* fp = reinterpret_cast<int*>(smem);
  int* cn = reinterpret_cast<int*>(smem + lay.b);
  const long long wE = static_cast<long long>(w) * E;
  for (int v = threadIdx.x; v < NC; v += kThreads) {
    fp[v] = kI32MaxI;
    cn[v] = 0;
  }
  long long* adj = a.adj + static_cast<long long>(w) * N * D;
  for (long long i = threadIdx.x; i < static_cast<long long>(N) * D;
       i += kThreads)
    adj[i] = -1;
  __syncthreads();
  for (int p = threadIdx.x; p < E; p += kThreads) {
    const long long k1 = a.ak_key[wE + a.aperm[wE + p]];
    if (k1 >= 0 && k1 < NC) {
      atomicMin(&fp[k1], p);
      atomicAdd(&cn[k1], 1);
    }
  }
  __syncthreads();
  bool over_d = false;
  const long long NS = N + 1;
  for (int v = threadIdx.x; v < NC; v += kThreads) {
    over_d |= cn[v] > D;
    if (cn[v]) {  // deg's segment wid * NS + src, where it falls
      const long long id = w * NS + v;
      const long long tw = id / NS, tn = id % NS;
      if (tw < a.W && tn < N)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.deg + tw * N + tn),
                  static_cast<unsigned long long>(cn[v]));
    }
  }
  for (int p = threadIdx.x; p < E; p += kThreads) {
    const long long x = a.aperm[wE + p];
    const long long k1 = a.ak_key[wE + x];
    if (k1 >= 0 && k1 < N) {
      const int slot = p - fp[k1];
      if (slot < D) adj[k1 * D + slot] = x;
    }
  }
  // the reference coverage projection: mer i covers base i + K - 1, mer 0
  // bases 0..K-1
  const long long wI = static_cast<long long>(w) * a.I;
  const int RM = a.R * a.M, Mraw = a.Mraw;
  const long long* nidp = a.nid + wI + RM + Mraw;
  const long long n_proj = max(a.rawlen[w] - K, 0LL);
  for (int r = threadIdx.x; r < Mraw; r += kThreads) {
    a.nid_proj[static_cast<long long>(w) * Mraw + r] = nidp[r];
    a.proj_isF[static_cast<long long>(w) * Mraw + r] =
        bit(a.pay[wI + RM + r], kIsF);
  }
  for (int pos = threadIdx.x; pos < a.Lraw; pos += kThreads) {
    const int i = pos >= K - 1 ? pos - K + 1 : 0;
    const bool on = pos >= K - 1 ? i < n_proj : n_proj > 0;
    const long long nd = nidp[i];
    long long* out = a.refcov + (static_cast<long long>(w) * a.Lraw + pos) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      long long val = 0;
      if (on && nd >= 0) {
        const long long wn = static_cast<long long>(w) * N + nd;
        const long long cc = a.counts[wn * 4 + c];
        val = a.in_index[wn] && cc > 0 ? cc : 0;
      }
      out[c] = val;
    }
  }
  // a run of (mer, fragment) holding both mate orders of one fragment
  const long long fplane = static_cast<long long>(a.W) * a.IP;
  const long long wF = static_cast<long long>(w) * a.IP;
  const long long* fk = a.fkeys + wF;
  const long long* fperm = a.fperm + wF;
  bool cand = false;
  for (int p = 1 + threadIdx.x; p < a.IP; p += kThreads) {
    const long long x = fperm[p], y = fperm[p - 1];
    const long long fx = fk[a.NW * fplane + x];
    if (fx == kI32Max || fx != fk[a.NW * fplane + y]) continue;
    bool same = true;
    for (int i = 0; i < a.NW; ++i)
      same &= fk[i * fplane + x] == fk[i * fplane + y];
    const long long ox = (a.pay[wI + x] >> kOrder) & 0xff;
    const long long oy = (a.pay[wI + y] >> kOrder) & 0xff;
    cand |= same && ox != oy && ox > 0 && oy > 0;
  }
  over_d = __syncthreads_or(over_d);
  cand = __syncthreads_or(cand);
  if (threadIdx.x == 0) {
    const bool ok = a.window_ok[w] != 0;
    a.mate_cand[w] = cand && ok;
    a.fallback[w] = (a.over_n[w] || a.over_e[w] || over_d || cand) && ok;
  }
}

// one kernel, four launches, each phase after a window_sort of the last
// one's keys (the mate keys' sort before phase 3)
__global__ void __launch_bounds__(kThreads)
    edge_tables_kernel(const EdgeArgs a, int phase) {
  switch (phase) {
    case 0: edge_pairs(a); break;
    case 1: edge_groups(a); break;
    case 2: edge_order(a); break;
    default: edge_adj(a);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int set_smem(const void* kern, size_t smem) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  return 0;
}

template <class F>
int launch_checked(const void* kern, size_t smem, F&& go) {
  const int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  go();
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int sort_launch(const SortArgs& a, size_t smem, cudaStream_t s) {
  return launch_checked(
      reinterpret_cast<const void*>(window_sort_kernel<NK>), smem,
      [&] { window_sort_kernel<NK><<<a.W, kThreads, smem, s>>>(a); });
}

size_t sort_smem_bytes(int NK, int T) {
  return round16(sizeof(long long) * NK * T) + round16(sizeof(int) * T);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block (gpu/dbgk.py's *_smem).
size_t dbg_sort_smem(int NK, int T) { return sort_smem_bytes(NK, T); }

size_t dbg_nodes_smem(int N) { return node_layout(N).total; }

size_t dbg_edges_smem(int phase, int N, int E) {
  return edge_layout(phase, N, E).total;
}

// mer_instances: W windows; ins (bases, quals, rlen, rsample, rstrand,
// rfrag, rorder, raw, rawlen, seq_off, seq_len, window_ok), outs (keys,
// pay, qok, fkeys).
int dbg_instances(const void* const* ins, void* const* outs, int W, int R,
                  int L, int Lraw, int K, int minq, void* stream) {
  if (W <= 0 || R <= 0 || K < 1 || K > 63 || L < K || Lraw < K)
    return static_cast<int>(cudaErrorInvalidValue);
  InstArgs a{};
  a.bases = static_cast<const uint8_t*>(ins[0]);
  a.quals = static_cast<const uint8_t*>(ins[1]);
  a.rlen = static_cast<const int32_t*>(ins[2]);
  a.rsample = static_cast<const int8_t*>(ins[3]);
  a.rstrand = static_cast<const int8_t*>(ins[4]);
  a.rfrag = static_cast<const int32_t*>(ins[5]);
  a.rorder = static_cast<const int8_t*>(ins[6]);
  a.raw = static_cast<const uint8_t*>(ins[7]);
  a.rawlen = static_cast<const int32_t*>(ins[8]);
  a.seq_off = static_cast<const int32_t*>(ins[9]);
  a.seq_len = static_cast<const int32_t*>(ins[10]);
  a.window_ok = static_cast<const uint8_t*>(ins[11]);
  a.keys = static_cast<long long*>(outs[0]);
  a.pay = static_cast<long long*>(outs[1]);
  a.qok = static_cast<long long*>(outs[2]);
  a.fkeys = static_cast<long long*>(outs[3]);
  a.W = W;
  a.R = R;
  a.L = L;
  a.Lraw = Lraw;
  a.K = K;
  a.NW = (K + 30) / 31;
  a.M = L - K + 1;
  a.Mraw = Lraw - K + 1;
  a.IP = R * a.M;
  a.I = a.IP + 3 * a.Mraw;
  a.minq = minq;
  return launch_checked(
      reinterpret_cast<const void*>(mer_instances_kernel), 0, [&] {
        mer_instances_kernel<<<W, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
      });
}

// window_sort: W windows of n elements, NK key words each (key c of
// window w, element i at keys[c * ps + w * wst + i]); perm [W, n] int64;
// skeys [NK, W, P] and sidx [W, P] scratch where P > T.
int dbg_sort(const void* keys, long long ps, long long wst, int NK, int W,
             int n, int P, int T, void* perm, void* skeys, void* sidx,
             size_t smem, void* stream) {
  if (W <= 0 || n <= 0 || NK < 1 || NK > 4 || T < 2 || P < T || P < n ||
      (P & (P - 1)) || (T & (T - 1)) || smem != sort_smem_bytes(NK, T) ||
      (P > T && (skeys == nullptr || sidx == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  SortArgs a{};
  a.keys = static_cast<const long long*>(keys);
  a.ps = ps;
  a.wst = wst;
  a.perm = static_cast<long long*>(perm);
  a.skeys = static_cast<long long*>(skeys);
  a.sidx = static_cast<int*>(sidx);
  a.W = W;
  a.n = n;
  a.P = P;
  a.T = T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NK) {
    case 1: return sort_launch<1>(a, smem, s);
    case 2: return sort_launch<2>(a, smem, s);
    case 3: return sort_launch<3>(a, smem, s);
    default: return sort_launch<4>(a, smem, s);
  }
}

// node_tables, phase 0 (groups) or 1 (creation order): p the pointers in
// the order of gpu/dbgk.py's NODE_PTRS.
int dbg_nodes(int phase, void* const* p, int W, int I, int N, int K,
              long long low_cov_threshold, float min_cov_ratio, size_t smem,
              void* stream) {
  if (W <= 0 || I <= 0 || N <= 0 || K < 1 || K > 63 ||
      (phase == 0 && smem != node_layout(N).total) ||
      (phase == 1 && smem != 0) || phase < 0 || phase > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  NodeArgs a{};
  a.keys = static_cast<const long long*>(p[0]);
  a.pay = static_cast<const long long*>(p[1]);
  a.qok = static_cast<const long long*>(p[2]);
  a.perm = static_cast<const long long*>(p[3]);
  a.order = static_cast<const long long*>(p[4]);
  a.rawlen = static_cast<const int32_t*>(p[5]);
  a.totalreadbp = static_cast<const int32_t*>(p[6]);
  a.node_key = static_cast<long long*>(p[7]);
  a.gstart = static_cast<int*>(p[8]);
  a.over_n = static_cast<uint8_t*>(p[9]);
  a.mers = static_cast<long long*>(p[10]);
  a.counts = static_cast<long long*>(p[11]);
  a.mq = static_cast<int*>(p[12]);
  a.totq = static_cast<long long*>(p[13]);
  a.mincov_qv = static_cast<long long*>(p[14]);
  a.exists = static_cast<uint8_t*>(p[15]);
  a.alive = static_cast<uint8_t*>(p[16]);
  a.low = static_cast<uint8_t*>(p[17]);
  a.in_index = static_cast<uint8_t*>(p[18]);
  a.is_tumor = static_cast<uint8_t*>(p[19]);
  a.is_normal = static_cast<uint8_t*>(p[20]);
  a.n_nodes = static_cast<long long*>(p[21]);
  a.avgcov = static_cast<float*>(p[22]);
  a.rawlen_dev = static_cast<long long*>(p[23]);
  a.nid = static_cast<long long*>(p[24]);
  a.W = W;
  a.I = I;
  a.N = N;
  a.K = K;
  a.NW = (K + 30) / 31;
  a.low_cov_threshold = low_cov_threshold;
  a.min_cov_ratio = min_cov_ratio;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_checked(
      reinterpret_cast<const void*>(node_tables_kernel), smem,
      [&] { node_tables_kernel<<<W, kThreads, smem, s>>>(a, phase); });
}

// edge_tables, phase 0-3: p the pointers in the order of gpu/dbgk.py's
// EDGE_PTRS.
int dbg_edges(int phase, void* const* p, int W, int R, int L, int Lraw,
              int K, int N, int E, int D, size_t smem, void* stream) {
  if (W <= 0 || R <= 0 || K < 1 || K > 63 || L < K || Lraw < K || N <= 0 ||
      E <= 0 || D <= 0 || phase < 0 || phase > 3 ||
      smem != edge_layout(phase, N, E).total)
    return static_cast<int>(cudaErrorInvalidValue);
  EdgeArgs a{};
  a.pay = static_cast<const long long*>(p[0]);
  a.nid = static_cast<const long long*>(p[1]);
  a.counts = static_cast<const long long*>(p[2]);
  a.in_index = static_cast<const uint8_t*>(p[3]);
  a.over_n = static_cast<const uint8_t*>(p[4]);
  a.rawlen = static_cast<const long long*>(p[5]);
  a.window_ok = static_cast<const uint8_t*>(p[6]);
  a.fkeys = static_cast<const long long*>(p[7]);
  a.fperm = static_cast<const long long*>(p[8]);
  a.ckey = static_cast<long long*>(p[9]);
  a.tab = static_cast<long long*>(p[10]);
  a.cperm = static_cast<const long long*>(p[11]);
  a.de_src = static_cast<long long*>(p[12]);
  a.de_dst = static_cast<long long*>(p[13]);
  a.de_dx = static_cast<long long*>(p[14]);
  a.et_key = static_cast<long long*>(p[15]);
  a.eorder = static_cast<const long long*>(p[16]);
  a.over_e = static_cast<uint8_t*>(p[17]);
  a.ak_key = static_cast<long long*>(p[18]);
  a.aperm = static_cast<const long long*>(p[19]);
  a.n_edges = static_cast<long long*>(p[20]);
  a.edge_src = static_cast<long long*>(p[21]);
  a.edge_dst = static_cast<long long*>(p[22]);
  a.edge_dir = static_cast<long long*>(p[23]);
  a.edge_exists = static_cast<uint8_t*>(p[24]);
  a.adj = static_cast<long long*>(p[25]);
  a.deg = static_cast<long long*>(p[26]);
  a.nid_proj = static_cast<long long*>(p[27]);
  a.proj_isF = static_cast<uint8_t*>(p[28]);
  a.refcov = static_cast<long long*>(p[29]);
  a.mate_cand = static_cast<uint8_t*>(p[30]);
  a.fallback = static_cast<uint8_t*>(p[31]);
  a.W = W;
  a.R = R;
  a.M = L - K + 1;
  a.Mraw = Lraw - K + 1;
  a.Lraw = Lraw;
  a.K = K;
  a.NW = (K + 30) / 31;
  a.IP = R * a.M;
  a.I = a.IP + 3 * a.Mraw;
  a.PU = a.IP + a.Mraw;
  a.N = N;
  a.E = E;
  a.D = D;
  return launch_checked(
      reinterpret_cast<const void*>(edge_tables_kernel), smem,
      [&] {
        edge_tables_kernel<<<W, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(a, phase);
      });
}

}  // extern "C"
