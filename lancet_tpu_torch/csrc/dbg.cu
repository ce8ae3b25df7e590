// The device graph engine's build of one k attempt (gpu/dbg.py::build_k)
// for Hopper (sm_90a): four stages, each one or a few kernels, a build's
// launches fixed by its shapes and k (gpu/dbgk.py::build_plan). Plain C
// interface, loaded with ctypes by gpu/dbgk.py; each entry point returns
// cudaGetLastError() after each of its launches.
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
//   node_tables    <- :239-327 (three launches: each tile's counts, then
//                     the groups and their first read times; after
//                     window_sort gives the creation order, the tables in
//                     that order and the prune)
//   edge_tables    <- :329-478 (five launches: the pair keys; each tile's
//                     counts, then the canonical groups and directed rows;
//                     the time order, the reference projection and the
//                     mate candidates; the adjacency and the fallback
//                     flags)
// The launch sequence (gpu/dbgk.py::build_k): mer_instances (2),
// window_sort (instances), node_tables 0 (2), window_sort (node keys),
// node_tables 1, edge_tables 0, window_sort (pair keys), edge_tables 1
// (2), window_sort (times), window_sort (mate keys), edge_tables 2,
// window_sort (sources), edge_tables 3.
//
// What bounds them on this card: a build moves ~15 MB at k 13 in bucket 0
// (W 32: mq and totq, [W, N, K, 4] int32 and [W, N, K] int64, are most of
// it) and its instance tables and sorts a few tens of MB at the largest
// bucket, tens of microseconds of memory; the work is the sorts' passes
// and the instances' mer words. So every stage but the adjacency fills
// the card with many blocks a window:
// - mer_instances: (window, tile of 2,048 read instances) blocks and
//   (window, tile of 512 reference offsets) blocks, 256 threads. A block
//   stages the reads its tile touches as bit strings in shared memory (a
//   warp loads 32 bases and qualities with one coalesced load each and
//   builds the 2-bit codes and the bad-base and bad-quality masks by
//   ballots); an instance's mer words, quality bits and pair gates are
//   then a few extractions from those strings, not K loads. The stream
//   position of a valid read instance needs the count of valid ones before
//   it in the window: a first launch counts each tile's, the second adds
//   the earlier tiles' counts to a block scan (no atomics, no look-back);
// - window_sort: an LSD radix sort of (key, index) records by 8-bit
//   digits, stable by construction and at any n. The plan declares each
//   key word's range (gpu/dbgk.py::build_plan: a mer word's 2 bits a base,
//   the times below 2I + 2, the pair keys, the sources below N + 64) and
//   its sentinel, which maps to the top of that range; the record's key is
//   the mapped words side by side in 32-bit lanes, and the sort takes a
//   pass for each 8 of their bits (3 at k 11 for the instances, not a
//   compare of all 64 bits of each word). A window of one tile (4,096
//   records) sorts in one block in shared memory, one launch; past a
//   tile, (window, tile) blocks of 512 threads: launch 1 maps the keys
//   into records and counts each tile's digits of pass 0; each pass then
//   a scatter (the digit's offset in the window from every tile's counts,
//   the tile's records ranked by digit in shared memory from warp ballots,
//   written in sorted runs) and, before every pass but the first, a count
//   of each tile's digits as the last pass left them;
// - node_tables and edge_tables: (window, tile of 2,048 positions) blocks
//   of 256 threads wherever the work is a pass over positions. A group of
//   equal sorted keys may cross tile edges: a first launch counts each
//   tile's group starts and its head (the least times of its positions
//   ahead of its first start); the second numbers the groups from the
//   earlier tiles' counts and one tile scan (no look-back, no spin on
//   another block), takes a group's least times by shared atomic minima and
//   its last group's with the heads of the tiles it runs into. A key's
//   words are gathered once, every gather of a tile in flight together
//   (the position before's from the lane before), and the sorted payload
//   and packed pair records are written in order for the launch after.
//   The creation order runs (window, 32 slots) blocks, a warp a slot, its
//   quality bits counted by warp ballots; the adjacency keeps a block a
//   window (its first slots and counts over N + 64 sources in shared
//   memory), after the tiles that fill adj and set the mate flags.
// Data outside what gpu/dbgk.py::build_plan takes gives wrong answers,
// never a fault: every index into shared memory is bounded.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
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
// ws: 32 ints of shared memory. Every thread of the block calls it.
__device__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarp ? ws[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    ws[lane] = s;  // inclusive sums of the warps' totals
  }
  __syncthreads();
  const int before = (warp ? ws[warp - 1] : 0) + x - v;
  *total = ws[nwarp - 1];
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
// sequences as bit strings in shared memory
// ---------------------------------------------------------------------------

struct Words {
  long long w[3];
};

// Bits [off, off + len) of the little-endian bit string s, len 0..64; s
// holds two words past the last one a caller reads.
__device__ __forceinline__ unsigned long long ext(const unsigned* s, int off,
                                                  int len) {
  const int i = off >> 5, sh = off & 31;
  unsigned long long v = (static_cast<unsigned long long>(s[i]) |
                          (static_cast<unsigned long long>(s[i + 1]) << 32)) >>
                         sh;
  if (sh) v |= static_cast<unsigned long long>(s[i + 2]) << (64 - sh);
  return len >= 64 ? v : v & ((1ULL << len) - 1);
}

// The nb 2-bit groups of v (group 0 least significant) in reverse order.
__device__ __forceinline__ unsigned long long rev2(unsigned long long v,
                                                   int nb) {
  unsigned long long x = __brevll(v);
  x = ((x >> 1) & 0x5555555555555555ULL) | ((x & 0x5555555555555555ULL) << 1);
  return x >> (64 - 2 * nb);
}

// bit b of x to bit 2b (x: 16 bits)
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// A staged sequence of len bases, in 32-bit words: code, each base's low
// two bits (base x at bits 2x, 2x + 1); bad, base x >= 4 at bit x; qbad,
// quality x below the minimum at bit x. nc = ceil(len / 32) chunks; each
// string ends in two zero words, which ext reads past its last bit.
struct SeqLayout {
  int nc, code, bad, qbad, words;
};

__host__ __device__ inline SeqLayout seq_layout(int len) {
  SeqLayout o{};
  o.nc = (len + 31) / 32;
  o.code = 0;
  o.bad = 2 * o.nc + 2;
  o.qbad = o.bad + o.nc + 2;
  o.words = o.qbad + o.nc + 2;
  return o;
}

constexpr int kStageBatch = 8;  // chunks a warp loads before its ballots

// Stages rows row0 .. row0 + nseq - 1 of b (and of q, where not null) of
// len bases each into s, `stride` (>= lay.words) words a row: a warp a
// chunk of 32 positions, one coalesced load a base and a quality (a warp's
// kStageBatch chunks' loads in flight together), each word built by the
// warp's ballots. Every thread of the block calls it; it ends in a
// barrier.
__device__ void stage_seqs(const uint8_t* b, const uint8_t* q, long long row0,
                           int nseq, int len, int minq, const SeqLayout& lay,
                           int stride, unsigned* s) {
  const int lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
  const int njobs = nseq * lay.nc;
  for (int j0 = (threadIdx.x >> 5) * kStageBatch; j0 < njobs;
       j0 += nwarp * kStageBatch) {
    int bv[kStageBatch];
    bool qb[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int job = j0 + u;
      const int j = job / lay.nc, x = 32 * (job - j * lay.nc) + lane;
      const bool in = job < njobs && x < len;
      const long long at = (row0 + j) * len + x;
      bv[u] = in ? b[at] : 0;
      qb[u] = in && q != nullptr && static_cast<int>(q[at]) < minq;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int job = j0 + u;
      const unsigned lo = __ballot_sync(kFull, bv[u] & 1);
      const unsigned hi = __ballot_sync(kFull, (bv[u] >> 1) & 1);
      const unsigned bad = __ballot_sync(kFull, bv[u] >= 4);
      const unsigned qbad = __ballot_sync(kFull, qb[u]);
      if (lane == 0 && job < njobs) {
        const int j = job / lay.nc, c = job - j * lay.nc;
        unsigned* r = s + j * stride;
        r[lay.code + 2 * c] = spread16(lo) | (spread16(hi) << 1);
        r[lay.code + 2 * c + 1] =
            spread16(lo >> 16) | (spread16(hi >> 16) << 1);
        r[lay.bad + c] = bad;
        r[lay.qbad + c] = qbad;
      }
    }
  }
  for (int i = threadIdx.x; i < 2 * nseq; i += blockDim.x) {
    unsigned* r = s + (i >> 1) * stride;
    r[lay.code + 2 * lay.nc + (i & 1)] = 0;
    r[lay.bad + lay.nc + (i & 1)] = 0;
    r[lay.qbad + lay.nc + (i & 1)] = 0;
  }
  __syncthreads();
}

// The forward and reverse-complement words of the K bases at m of a staged
// sequence r (gpu/dbg.py's packing: int64 words of 31 bases, most
// significant word first, the last word full, first base most
// significant), and whether every base is below 4: NW extractions each,
// not K loads.
__device__ __forceinline__ void mer_words(const unsigned* r,
                                          const SeqLayout& lay, int m, int K,
                                          int NW, Words& f, Words& rc,
                                          bool& ok) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    long long fv = 0, rv = 0;
    if (i < NW) {
      const int lo = max(K - 31 * (NW - i), 0), hi = K - 31 * (NW - 1 - i);
      fv = static_cast<long long>(
          rev2(ext(r + lay.code, 2 * (m + lo), 2 * (hi - lo)), hi - lo));
      // the reverse complement holds comp(b_j) at distance j from its end
      const int rlo = 31 * (NW - 1 - i), nb = min(31 * (NW - i), K) - rlo;
      rv = static_cast<long long>(ext(r + lay.code, 2 * (m + rlo), 2 * nb) ^
                                  ((1ULL << (2 * nb)) - 1));
    }
    f.w[i] = fv;
    rc.w[i] = rv;
  }
  ok = ext(r + lay.bad, m, K) == 0;
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
// mer_instances: a block a tile of read instances or of reference offsets
// ---------------------------------------------------------------------------

constexpr int kInstThreads = 256;

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
  int* cnt;          // [W, TR]: the valid read instances of each read tile
  int W, R, L, Lraw, K, NW, M, Mraw, I, IP, minq;
  int TQ, TR, RQ, TF;  // instances a read tile and read tiles a window;
                       // offsets a reference tile and reference tiles
};

// read tile t: its instances [q0, q1) in (read, offset) order, which lie
// in the nr reads from r0
__device__ __forceinline__ void read_tile(const InstArgs& a, int t, int& q0,
                                          int& q1, int& r0, int& nr) {
  q0 = t * a.TQ;
  q1 = min(q0 + a.TQ, a.R * a.M);
  r0 = q0 / a.M;
  nr = (q1 - 1) / a.M - r0 + 1;
}

// A read tile's shared memory: the stream positions of its instances (TQ
// ints), then its reads, each its staged strings and kReadFields ints
// (rlen, rsample, rstrand, rorder, rfrag).
constexpr int kReadFields = 5;

__host__ __device__ inline int read_stride(int L) {
  return seq_layout(L).words + kReadFields;
}

// Stages read tile t's reads of window w: their strings and fields.
__device__ void stage_reads(const InstArgs& a, int w, int r0, int nr,
                            unsigned* s) {
  const SeqLayout lay = seq_layout(a.L);
  const int stride = read_stride(a.L);
  const long long row0 = static_cast<long long>(w) * a.R + r0;
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    int* f = reinterpret_cast<int*>(s + i * stride + lay.words);
    f[0] = a.rlen[row0 + i];
    f[1] = a.rsample[row0 + i];
    f[2] = a.rstrand[row0 + i];
    f[3] = a.rorder[row0 + i];
    f[4] = a.rfrag[row0 + i];
  }
  stage_seqs(a.bases, a.quals, row0, nr, a.L, a.minq, lay, stride, s);
}

// whether read instance q (offset m of staged read r) is valid: a read of
// more than one mer, m below its mers, every base below 4
__device__ __forceinline__ bool read_valid(const InstArgs& a,
                                           const unsigned* r, int m) {
  const SeqLayout lay = seq_layout(a.L);
  const int rl = reinterpret_cast<const int*>(r + lay.words)[0];
  return rl - a.K > 0 && m < rl - a.K + 1 &&
         ext(r + lay.bad, m, a.K) == 0;
}

constexpr int kInstItems = 8;  // a thread's consecutive instances in a scan

// The valid instances of read tile [q0, q1) (its reads staged at s from
// r0): each thread counts kInstItems consecutive ones, then one block
// scan; where gpos is not null, each valid instance's count of valid ones
// before it in the tile. Returns the tile's count. Every thread calls it.
__device__ int scan_valid(const InstArgs& a, const unsigned* s, int q0,
                          int q1, int r0, int* gpos, int* ws) {
  const int M = a.M, stride = read_stride(a.L);
  int c = 0;
  for (int base = q0; base < q1; base += kInstItems * blockDim.x) {
    const int b0 = base + kInstItems * threadIdx.x;
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < kInstItems; ++i) {
      const int q = b0 + i;
      if (q < q1) {
        const int rr = q / M;
        v |= static_cast<unsigned>(
                 read_valid(a, s + (rr - r0) * stride, q - rr * M))
             << i;
      }
    }
    int total;
    int before = block_scan(__popc(v), ws, &total) + c;
    if (gpos != nullptr) {
#pragma unroll
      for (int i = 0; i < kInstItems; ++i) {
        if (b0 + i < q1) gpos[b0 + i - q0] = before;
        before += (v >> i) & 1;
      }
    }
    c += total;
  }
  return c;
}

// the valid read instances of window w in read tiles [0, t); every thread
// calls it
__device__ int tiles_before(const InstArgs& a, int w, int t, int* ws) {
  int c = 0;
  for (int u = threadIdx.x; u < t; u += blockDim.x) c += a.cnt[w * a.TR + u];
  int total;
  block_scan(c, ws, &total);
  return total;
}

// launch 1: each read tile's count of valid instances
__global__ void __launch_bounds__(kInstThreads)
    mer_instances_count(const InstArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ws[32];
  unsigned* s = reinterpret_cast<unsigned*>(smem) + a.TQ;
  const int w = blockIdx.x / a.TR, t = blockIdx.x - w * a.TR;
  int q0, q1, r0, nr;
  read_tile(a, t, q0, q1, r0, nr);
  stage_reads(a, w, r0, nr, s);
  const int n = scan_valid(a, s, q0, q1, r0, nullptr, ws);
  if (threadIdx.x == 0) a.cnt[w * a.TR + t] = n;
}

// a read tile: the instance table's read part, the stream position g of a
// valid instance the count of valid ones before it in (read, offset) order
// (the earlier tiles' counts, then the tile's scan)
__device__ void inst_reads(const InstArgs& a, int w, int t, unsigned* sm,
                           int* ws) {
  const int K = a.K, NW = a.NW, M = a.M, L = a.L;
  const bool okW = a.window_ok[w] != 0;
  const long long plane = static_cast<long long>(a.W) * a.I;
  const long long fplane = static_cast<long long>(a.W) * a.IP;
  long long* keys = a.keys + static_cast<long long>(w) * a.I;
  long long* pay = a.pay + static_cast<long long>(w) * a.I;
  long long* qok = a.qok + static_cast<long long>(w) * a.I;
  long long* fkeys = a.fkeys + static_cast<long long>(w) * a.IP;
  int* gpos = reinterpret_cast<int*>(sm);
  unsigned* s = sm + a.TQ;
  int q0, q1, r0, nr;
  read_tile(a, t, q0, q1, r0, nr);
  stage_reads(a, w, r0, nr, s);
  const int carry = tiles_before(a, w, t, ws);
  scan_valid(a, s, q0, q1, r0, gpos, ws);
  __syncthreads();
  const SeqLayout lay = seq_layout(L);
  const int stride = read_stride(L);
  const unsigned long long kmask = (1ULL << K) - 1;  // K <= 63
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const int rr = q / M, m = q - rr * M;
    const unsigned* r = s + (rr - r0) * stride;
    const int* f = reinterpret_cast<const int*>(r + lay.words);
    const int rl = f[0], samp = f[1], order = f[3];
    const int n_mers = max(rl - K + 1, 0);
    const bool use_read = rl - K > 0;  // a single-mer read is skipped
    Words fw, rc;
    bool bok;
    mer_words(r, lay, m, K, NW, fw, rc, bok);
    const bool isF = lex_less(fw, rc, NW);
    const Words mw = pick(isF, fw, rc);
    // the quality bits of mer m; the pair gates of m (quals m..m+K) and of
    // m-1 (quals m-1..m+K-1); the bases of mer m-1
    const unsigned* rq = r + lay.qbad;
    const unsigned* rb = r + lay.bad;
    const unsigned long long qf = ~ext(rq, m, K) & kmask;
    const unsigned long long qr = __brevll(qf) >> (64 - K);
    const bool qbad = ext(rq, m, K + 1) != 0;
    const bool qbad_prev = (m >= 1 ? ext(rq, m - 1, K + 1)
                                   : ext(rq, 0, K)) != 0;
    const bool bad_prev = (m >= 1 ? ext(rb, m - 1, K)
                                  : ext(rb, 0, K - 1)) != 0;
    const bool inst_valid = use_read && m < n_mers && bok;
    const bool is_last = m == n_mers - 1;
    const bool tmr = samp == 0;
    const bool pair_ok = m < L - K && !qbad && tmr && !is_last && inst_valid;
    const bool prev_ok = m >= 1 && !qbad_prev && tmr &&
                         m - 1 != n_mers - 1 && use_read && m - 1 < n_mers &&
                         !bad_prev;
    const bool tflag = pair_ok || prev_ok;
    const bool isread = inst_valid && okW;
    const long long g = carry + gpos[q - q0];  // where inst_valid
    const long long tm = 2 * g - (m > 0 ? 1 : 0);
    const bool paired = order > 0 && inst_valid;
    long long pv = (isread ? tm : kBig) & 0xffffffffLL;
    pv |= static_cast<long long>(isread) << kValid;
    pv |= static_cast<long long>(isread) << kRead;
    pv |= static_cast<long long>(f[2] != 0) << kStrand;
    pv |= static_cast<long long>(tflag) << kTflag;
    pv |= static_cast<long long>(isF) << kIsF;
    pv |= static_cast<long long>(inst_valid && !is_last && okW) << kPair;
    pv |= static_cast<long long>(samp == 0) << kTmr;
    pv |= static_cast<long long>(samp == 1) << kNml;
    pv |= static_cast<long long>(samp == 2) << kRef;
    if (paired) pv |= static_cast<long long>(order) << kOrder;
    pay[q] = pv;
    qok[q] = static_cast<long long>(isF ? qf : qr);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i < NW) {
        keys[i * plane + q] = isread ? mw.w[i] : kSent;
        fkeys[i * fplane + q] = paired ? mw.w[i] : kSent;
      }
    }
    fkeys[NW * fplane + q] = paired ? static_cast<long long>(f[4]) : kI32Max;
  }
}

// a reference tile: offsets [ro0, ro1) of the ref pseudo-read, the
// projection and the index, their times after the window's valid read
// instances (all read tiles' counts)
__device__ void inst_refs(const InstArgs& a, int w, int t, unsigned* s,
                          int* ws) {
  const int K = a.K, NW = a.NW, Mraw = a.Mraw, RM = a.R * a.M;
  const bool okW = a.window_ok[w] != 0;
  const long long plane = static_cast<long long>(a.W) * a.I;
  long long* keys = a.keys + static_cast<long long>(w) * a.I;
  long long* pay = a.pay + static_cast<long long>(w) * a.I;
  long long* qok = a.qok + static_cast<long long>(w) * a.I;
  const SeqLayout lay = seq_layout(a.Lraw);
  stage_seqs(a.raw, nullptr, w, 1, a.Lraw, 0, lay, lay.words, s);
  const long long carry = tiles_before(a, w, a.TR, ws);
  const int rawlen = a.rawlen[w];
  const long long seq_off = a.seq_off[w];
  const int seq_len = a.seq_len[w];
  const int ref_nmers = max(rawlen - K + 1, 0);
  const bool ref_use = rawlen - K > 0;
  const int ro1 = min((t + 1) * a.RQ, Mraw);
  for (int ro = t * a.RQ + threadIdx.x; ro < ro1; ro += blockDim.x) {
    Words f, r;
    bool pok;
    mer_words(s, lay, ro, K, NW, f, r, pok);
    const bool pisF = lex_less(f, r, NW);
    const Words pw = pick(pisF, f, r);
    const bool ref_valid = ro < ref_nmers && pok && ref_use;
    const bool rv = ref_valid && okW;
    const long long tr = 2 * (carry + ro) - (ro > 0 ? 1 : 0);
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
    mer_words(s, lay, ip, K, NW, fi, ri, iok);
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

// launch 2: TR read tiles and TF reference tiles a window
__global__ void __launch_bounds__(kInstThreads)
    mer_instances_write(const InstArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ws[32];
  unsigned* s = reinterpret_cast<unsigned*>(smem);
  const int per = a.TR + a.TF;
  const int w = blockIdx.x / per, t = blockIdx.x - w * per;
  if (t < a.TR)
    inst_reads(a, w, t, s, ws);
  else
    inst_refs(a, w, t - a.TR, s, ws);
}

// ---------------------------------------------------------------------------
// window_sort: an LSD radix sort of (key, index) records, 8-bit digits
// ---------------------------------------------------------------------------

constexpr int kSortItems = 8;  // records a thread
constexpr int kSortMaxKeys = 4;
constexpr int kDigits = 256;

// The key words of a sort: word c of window w, element i at keys[c * ps + w
// * wst + i]. Word c holds lo[c] + [0, 2^bits[c]) or, where has_sent[c],
// the value sent[c] (above that range); it maps to v - lo[c] and sent[c]
// to 2^bits[c], which keeps its order in bits[c] + has_sent[c] bits. The
// record's key is the words' mapped values side by side, word 0 most
// significant, in NL 32-bit lanes (lane 0 least significant); pass p sorts
// by its bits [8p, 8p + 8). A word without a declared range is lo =
// INT64_MIN, bits = 64: its sign bit flipped.
struct SortArgs {
  const long long* keys;
  long long ps, wst;
  long long lo[kSortMaxKeys], sent[kSortMaxKeys];
  int bits[kSortMaxKeys], has_sent[kSortMaxKeys];
  int NK, W, n, tile, T, passes;  // T tiles of `tile` records a window
  long long* perm;  // [W, n]
  unsigned* cnt;    // [W, T, 256]: a pass's digit counts by tile
};

// the record's key lanes (the composite of its mapped words)
template <int NL>
__device__ __forceinline__ void map_key(const SortArgs& a, int w, int i,
                                        unsigned (&ln)[NL]) {
  unsigned long long limb[4] = {0, 0, 0, 0};
  int o = 0;
#pragma unroll
  for (int c = kSortMaxKeys - 1; c >= 0; --c) {
    if (c >= a.NK) continue;
    const long long v =
        a.keys[c * a.ps + static_cast<long long>(w) * a.wst + i];
    const unsigned long long u =
        a.has_sent[c] && v == a.sent[c]
            ? 1ULL << a.bits[c]
            : static_cast<unsigned long long>(v) -
                  static_cast<unsigned long long>(a.lo[c]);
    const int at = o >> 6, sh = o & 63;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j == at) limb[j] |= u << sh;
      if (j == at + 1 && sh) limb[j] |= u >> (64 - sh);
    }
    o += a.bits[c] + a.has_sent[c];
  }
#pragma unroll
  for (int j = 0; j < NL; ++j)
    ln[j] = static_cast<unsigned>(limb[j >> 1] >> (32 * (j & 1)));
}

template <int NL>
__device__ __forceinline__ unsigned digit_of(const unsigned (&ln)[NL],
                                             int p) {
  unsigned x = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j)
    if (j == (p >> 2)) x = ln[j];
  return (x >> (8 * (p & 3))) & 255u;
}

// the active lanes of the warp whose digit d equals this lane's
__device__ __forceinline__ unsigned peers8(unsigned d, unsigned active) {
  unsigned p = active;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned m = __ballot_sync(kFull, (d >> b) & 1u);
    p &= ((d >> b) & 1u) ? m : ~m;
  }
  return p;
}

// v[0..255] to its exclusive prefix sums, by warp 0; every thread calls it
__device__ void scan256(int* v) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int loc[8], s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      loc[j] = v[8 * lane + j];
      s += loc[j];
    }
    int x = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    int run = x - s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[8 * lane + j] = run;
      run += loc[j];
    }
  }
  __syncthreads();
}

// A scatter or tile block's shared memory, in 4-byte words: each warp's
// digit counts, the window's digit offsets, the tile's digit starts, the
// tile's records in sorted order (NL lanes, then the index, each `tile`
// words).
struct SortSmem {
  int whist, goff, tst, buf, total;
};

__host__ __device__ inline SortSmem sort_smem_layout(int NL, int tile) {
  SortSmem o{};
  o.whist = 0;
  o.goff = tile / (32 * kSortItems) * kDigits;
  o.tst = o.goff + kDigits;
  o.buf = o.tst + kDigits;
  o.total = o.buf + tile * (NL + 1);
  return o;
}

// A tile's records are a warp's 32 kSortItems consecutive ones each, item
// k of a lane its warp's record 32 k + lane. Ranks them by digit p,
// stably: pos[k] gets the record's place in the tile's sorted order and
// tst each digit's first place. whist: kDigits ints a warp.
template <int NL>
__device__ void rank_tile(const unsigned (&ln)[kSortItems][NL], int nv,
                          int p, int* whist, int* tst,
                          int (&pos)[kSortItems]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  int* wh = whist + warp * kDigits;
  for (int d = lane; d < kDigits; d += 32) wh[d] = 0;
  __syncwarp();
  unsigned dg[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const bool on = warp * 32 * kSortItems + 32 * k + lane < nv;
    const unsigned d = on ? digit_of<NL>(ln[k], p) : 0;
    dg[k] = d;
    const unsigned pe = peers8(d, __ballot_sync(kFull, on));
    const int before = __popc(pe & ((1u << lane) - 1));
    const int pre = on ? wh[d] : 0;
    __syncwarp();
    if (on && before == 0) wh[d] = pre + __popc(pe);
    __syncwarp();
    pos[k] = pre + before;
  }
  __syncthreads();
  // each digit's count over the warps before each warp, and in the tile
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    int s = 0;
    for (int v = 0; v < nwarp; ++v) {
      const int x = whist[v * kDigits + d];
      whist[v * kDigits + d] = s;
      s += x;
    }
    tst[d] = s;
  }
  __syncthreads();
  scan256(tst);
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) pos[k] += tst[dg[k]] + wh[dg[k]];
}

// the tile's records into buf at their sorted places
template <int NL>
__device__ __forceinline__ void put_sorted(
    unsigned* buf, int tile, int nv, const unsigned (&ln)[kSortItems][NL],
    const unsigned (&ix)[kSortItems], const int (&pos)[kSortItems]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (warp * 32 * kSortItems + 32 * k + lane < nv) {
#pragma unroll
      for (int j = 0; j < NL; ++j) buf[j * tile + pos[k]] = ln[k][j];
      buf[NL * tile + pos[k]] = ix[k];
    }
  }
}

// Launch 1 of a sort past one tile: the records of tile t of window w
// (their key lanes and index) into rec, and its digit counts of pass 0.
template <int NL>
__global__ void __launch_bounds__(512)
    window_sort_keys(const SortArgs a, unsigned* rec) {
  __shared__ int hist[kDigits];
  const int w = blockIdx.x / a.T, t = blockIdx.x - w * a.T, n = a.n;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  unsigned* r = rec + static_cast<long long>(w) * (NL + 1) * n;
  unsigned ln[kSortItems][NL];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {  // every load in flight first
    const int i = t * a.tile + k * blockDim.x + threadIdx.x;
#pragma unroll
    for (int j = 0; j < NL; ++j) ln[k][j] = 0;
    if (i < n) map_key<NL>(a, w, i, ln[k]);
  }
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int i = t * a.tile + k * blockDim.x + threadIdx.x;
    if (i < n) {
#pragma unroll
      for (int j = 0; j < NL; ++j)
        r[static_cast<long long>(j) * n + i] = ln[k][j];
      r[static_cast<long long>(NL) * n + i] = static_cast<unsigned>(i);
    }
    if (i < n) atomicAdd(&hist[digit_of<NL>(ln[k], 0)], 1);
  }
  __syncthreads();
  unsigned* c = a.cnt + (static_cast<long long>(w) * a.T + t) * kDigits;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) c[d] = hist[d];
}

// Pass p > 0 of a sort past one tile, first launch: the digit counts of
// each tile of the records as pass p - 1 left them.
template <int NL>
__global__ void __launch_bounds__(512)
    window_sort_count(const SortArgs a, const unsigned* rec, int p) {
  __shared__ int hist[kDigits];
  const int w = blockIdx.x / a.T, t = blockIdx.x - w * a.T, n = a.n;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  const unsigned* lane =
      rec + (static_cast<long long>(w) * (NL + 1) + (p >> 2)) * n;
  unsigned x[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {  // every load in flight first
    const int i = t * a.tile + k * blockDim.x + threadIdx.x;
    x[k] = i < n ? lane[i] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int i = t * a.tile + k * blockDim.x + threadIdx.x;
    if (i < n) atomicAdd(&hist[(x[k] >> (8 * (p & 3))) & 255u], 1);
  }
  __syncthreads();
  unsigned* c = a.cnt + (static_cast<long long>(w) * a.T + t) * kDigits;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) c[d] = hist[d];
}

// Pass p of a sort past one tile: tile t's records ranked by digit p in
// shared memory, then written in sorted runs to their places in the
// window (the digit's offset in the window, from every tile's counts, plus
// the tile's count before them), into `out` or, the last pass, their
// indices into perm.
template <int NL>
__global__ void __launch_bounds__(512)
    window_sort_scatter(const SortArgs a, const unsigned* in, unsigned* out,
                        int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SortSmem L = sort_smem_layout(NL, a.tile);
  int* sm = reinterpret_cast<int*>(smem);
  int* whist = sm + L.whist;
  int* goff = sm + L.goff;
  int* tst = sm + L.tst;
  unsigned* buf = reinterpret_cast<unsigned*>(sm + L.buf);
  const int w = blockIdx.x / a.T, t = blockIdx.x - w * a.T, n = a.n;
  const int tile = a.tile, t0 = t * tile, nv = min(tile, n - t0);
  const long long rw = static_cast<long long>(w) * (NL + 1) * n;
  const unsigned* c = a.cnt + static_cast<long long>(w) * a.T * kDigits;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    int b = 0, s = 0;
#pragma unroll 8
    for (int u = 0; u < a.T; ++u) {
      const int x = static_cast<int>(c[u * kDigits + d]);
      b += u < t ? x : 0;
      s += x;
    }
    goff[d] = b;
    tst[d] = s;
  }
  __syncthreads();
  scan256(tst);
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) goff[d] += tst[d];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ln[kSortItems][NL], ix[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int l = warp * 32 * kSortItems + 32 * k + lane;
    ix[k] = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) ln[k][j] = 0;
    if (l < nv) {
#pragma unroll
      for (int j = 0; j < NL; ++j) ln[k][j] = in[rw + static_cast<long long>(j) * n + t0 + l];
      ix[k] = in[rw + static_cast<long long>(NL) * n + t0 + l];
    }
  }
  int pos[kSortItems];
  rank_tile<NL>(ln, nv, p, whist, tst, pos);
  put_sorted<NL>(buf, tile, nv, ln, ix, pos);
  __syncthreads();
  const bool last = p == a.passes - 1;
  const unsigned* dl = buf + (p >> 2) * tile;
  for (int l = threadIdx.x; l < nv; l += blockDim.x) {
    const int d = (dl[l] >> (8 * (p & 3))) & 255;
    const long long dst = goff[d] + (l - tst[d]);
    if (last) {
      a.perm[static_cast<long long>(w) * n + dst] = buf[NL * tile + l];
    } else {
#pragma unroll
      for (int j = 0; j < NL; ++j)
        out[rw + static_cast<long long>(j) * n + dst] = buf[j * tile + l];
      out[rw + static_cast<long long>(NL) * n + dst] = buf[NL * tile + l];
    }
  }
}

// A sort of one tile a window: every pass in shared memory, one launch.
template <int NL>
__global__ void __launch_bounds__(512) window_sort_tile(const SortArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SortSmem L = sort_smem_layout(NL, a.tile);
  int* sm = reinterpret_cast<int*>(smem);
  int* whist = sm + L.whist;
  int* tst = sm + L.tst;
  unsigned* buf = reinterpret_cast<unsigned*>(sm + L.buf);
  const int w = blockIdx.x, n = a.n, tile = a.tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ln[kSortItems][NL], ix[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int l = warp * 32 * kSortItems + 32 * k + lane;
    ix[k] = static_cast<unsigned>(l);
#pragma unroll
    for (int j = 0; j < NL; ++j) ln[k][j] = 0;
    if (l < n) map_key<NL>(a, w, l, ln[k]);
  }
  for (int p = 0; p < a.passes; ++p) {
    int pos[kSortItems];
    rank_tile<NL>(ln, n, p, whist, tst, pos);
    put_sorted<NL>(buf, tile, n, ln, ix, pos);
    __syncthreads();
    if (p + 1 == a.passes) break;
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const int l = warp * 32 * kSortItems + 32 * k + lane;
      if (l < n) {
#pragma unroll
        for (int j = 0; j < NL; ++j) ln[k][j] = buf[j * tile + l];
        ix[k] = buf[NL * tile + l];
      }
    }
    __syncthreads();
  }
  for (int l = threadIdx.x; l < n; l += blockDim.x)
    a.perm[static_cast<long long>(w) * n + l] = buf[NL * tile + l];
}

// ---------------------------------------------------------------------------
// node_tables and edge_tables: tiles of sorted positions
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileItems = 8;  // positions a thread, at most
constexpr int kTileMax = kTileThreads * kTileItems;  // positions a tile
constexpr int kScanSlots = kTileItems * kTileWarps;
constexpr int kNewg = 62;  // a sorted payload's group-start bit

__device__ __forceinline__ int warp_min_i(int x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) x = min(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

__device__ __forceinline__ int warp_sum_i(int x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// A tile of `items` x 256 positions holds item k of a thread at position
// 256 k + threadIdx.x (a warp's 32 consecutive positions). Each item's
// count of set flags f ahead of it in the tile into before; returns the
// tile's total. tot: kScanSlots + 1 ints of shared memory. Every thread
// calls it; it ends in a barrier.
__device__ int tile_scan(const bool (&f)[kTileItems], int items,
                         int (&before)[kTileItems], int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned m[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    m[k] = __ballot_sync(kFull, k < items && f[k]);
    if (lane == 0 && k < items) tot[k * kTileWarps + warp] = __popc(m[k]);
  }
  __syncthreads();
  if (warp == 0) {  // the (item, warp) totals' exclusive sums, in order
    const int n = items * kTileWarps;
    const int a = lane < n ? tot[lane] : 0;
    const int b = lane + 32 < n ? tot[lane + 32] : 0;
    int x = a, y = b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, x, d);
      const int v = __shfl_up_sync(kFull, y, d);
      if (lane >= d) {
        x += u;
        y += v;
      }
    }
    const int sa = __shfl_sync(kFull, x, 31);
    const int sb = __shfl_sync(kFull, y, 31);
    tot[lane] = x - a;
    tot[lane + 32] = sa + y - b;
    if (lane == 0) tot[kScanSlots] = sa + sb;
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    before[k] = k < items ? tot[k * kTileWarps + warp] + __popc(m[k] & lt)
                          : 0;
  const int total = tot[kScanSlots];
  __syncthreads();  // tot is reused by the next call
  return total;
}

// s[0]: the sum of the window's tile counts c over tiles [0, t); s[1]:
// over all n. Warp 0 writes them; the caller's next barrier shows them.
__device__ void tile_sums(const int* c, int n, int t, int* s) {
  if (threadIdx.x < 32) {
    int b = 0, all = 0;
    for (int u = threadIdx.x; u < n; u += 32) {
      const int x = c[u];
      b += u < t ? x : 0;
      all += x;
    }
    b = warp_sum_i(b);
    all = warp_sum_i(all);
    if (threadIdx.x == 0) {
      s[0] = b;
      s[1] = all;
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
  long long* spay;      // [W, I]: the payload in sorted order, kNewg set
                        // at each group's start
  int* tcnt;            // [3, W, TN]: each tile's group starts, valid
                        // instances and head time
  int W, I, N, K, NW;
  int T, TN, SL, NB;  // positions a tile and tiles a window; creation
                      // slots a block and slot blocks a window
  long long low_cov_threshold;
  float min_cov_ratio;
};

// phase 0, launch 1, a tile of sorted positions: each position's payload
// in sorted order with its group-start bit (its NW key words against the
// position before's: every gather of the tile in flight before the first
// use, the words before a chunk of 32 from the chunk before's last lane,
// in shared memory), the tile's count of group starts, of valid
// instances, and its head time (the least time of its valid positions
// ahead of its first start: the tail of a group begun in an earlier
// tile); nid of the tile's instances to -1 for launch 3
template <int NW>
__global__ void __launch_bounds__(kTileThreads)
    node_tables_count(const NodeArgs a) {
  __shared__ int tot[kScanSlots + 1];
  __shared__ long long last[kScanSlots * NW], halo[NW];
  __shared__ int head, nval;
  const int w = blockIdx.x / a.TN, t = blockIdx.x - w * a.TN;
  const int I = a.I, items = a.T / kTileThreads, t0 = t * a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long plane = static_cast<long long>(a.W) * I;
  const long long wI = static_cast<long long>(w) * I;
  const long long* keys = a.keys + wI;
  const long long* pay = a.pay + wI;
  const long long* perm = a.perm + wI;
  long long* spay = a.spay + wI;
  long long* nid = a.nid + wI;
  long long x[kTileItems], pv[kTileItems], kw[kTileItems][NW];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int p = t0 + k * kTileThreads + threadIdx.x;
    x[k] = k < items && p < I ? perm[p] : -1;
  }
  const long long y = threadIdx.x == 0 && t0 > 0 ? perm[t0 - 1] : -1;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    pv[k] = x[k] >= 0 ? pay[x[k]] : 0;
#pragma unroll
    for (int i = 0; i < NW; ++i)
      kw[k][i] = x[k] >= 0 ? keys[i * plane + x[k]] : 0;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) halo[i] = y >= 0 ? keys[i * plane + y] : 0;
    head = kBigI;
    nval = 0;
  }
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    if (k < items && lane == 31)
#pragma unroll
      for (int i = 0; i < NW; ++i)
        last[(k * kTileWarps + warp) * NW + i] = kw[k][i];
  for (int i = t0 + threadIdx.x; i < min(t0 + a.T, I); i += kTileThreads)
    nid[i] = -1;
  __syncthreads();
  bool newg[kTileItems], valid[kTileItems];
  int tm[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    newg[k] = valid[k] = false;
    tm[k] = kBigI;
    if (k >= items) continue;  // the same for the whole block
    const int p = t0 + k * kTileThreads + threadIdx.x;
    const int c = k * kTileWarps + warp;
    bool differ = false;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      long long pw = __shfl_up_sync(kFull, kw[k][i], 1);
      if (lane == 0) pw = c == 0 ? halo[i] : last[(c - 1) * NW + i];
      differ |= kw[k][i] != pw;
    }
    valid[k] = x[k] >= 0 && bit(pv[k], kValid);
    newg[k] = valid[k] && (p == 0 || differ);
    if (valid[k]) tm[k] = static_cast<int>(pay_time(pv[k]));
    if (x[k] >= 0)
      spay[p] = pv[k] | (static_cast<long long>(newg[k]) << kNewg);
  }
  int before[kTileItems];
  const int n = tile_scan(newg, items, before, tot);
  int h = kBigI, v = 0;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (valid[k] && before[k] + newg[k] == 0) h = min(h, tm[k]);
    v += valid[k];
  }
  h = warp_min_i(h);
  v = warp_sum_i(v);
  if (lane == 0) {
    atomicMin(&head, h);
    atomicAdd(&nval, v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long st = static_cast<long long>(a.W) * a.TN;
    int* c = a.tcnt + static_cast<long long>(w) * a.TN + t;
    c[0] = n;
    c[st] = nval;
    c[2 * st] = head;
  }
}

// the least of v and the head times of the tiles after t up to the first
// that holds a group start: a group that runs on past tile t
__device__ __forceinline__ int heads_after(const int* cnt, const int* head,
                                           int n, int t, int v) {
  for (int u = t + 1; u < n; ++u) {
    v = min(v, head[u]);
    if (cnt[u] > 0) break;
  }
  return v;
}

// phase 0, launch 2, a tile: its groups' starts into gstart (at most N + 1
// a window) and their first read times into node_key (a group's least
// time in the tile by shared atomic minima; its last group's with the
// heads it runs into), the group numbers from the earlier tiles' counts
// and one tile scan; the groups past the window's last start at its valid
// count; over_n; n_nodes zeroed for launch 3's sums
__global__ void __launch_bounds__(kTileThreads)
    node_tables_groups(const NodeArgs a) {
  __shared__ int tot[kScanSlots + 1];
  __shared__ int smin[kTileMax];
  __shared__ int sums[4];
  const int w = blockIdx.x / a.TN, t = blockIdx.x - w * a.TN;
  const int N = a.N, I = a.I, items = a.T / kTileThreads, t0 = t * a.T;
  const long long st = static_cast<long long>(a.W) * a.TN;
  const int* cnt = a.tcnt + static_cast<long long>(w) * a.TN;
  const long long* spay = a.spay + static_cast<long long>(w) * I;
  int* gs = a.gstart + static_cast<long long>(w) * (N + 1);
  long long* nk = a.node_key + static_cast<long long>(w) * N;
  tile_sums(cnt, a.TN, t, sums);           // carry, all groups
  tile_sums(cnt + st, a.TN, 0, sums + 2);  // -, the valid instances
  for (int l = threadIdx.x; l < a.T; l += kTileThreads) smin[l] = kBigI;
  bool newg[kTileItems], valid[kTileItems];
  int tm[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int p = t0 + k * kTileThreads + threadIdx.x;
    const long long pv = k < items && p < I ? spay[p] : 0;
    valid[k] = bit(pv, kValid);
    newg[k] = bit(pv, kNewg);
    tm[k] = valid[k] ? static_cast<int>(pay_time(pv)) : kBigI;
  }
  int before[kTileItems];
  const int n = tile_scan(newg, items, before, tot);
  const int carry = sums[0], total = sums[1], nvalid = sums[3];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (!valid[k]) continue;
    const int l = before[k] + newg[k] - 1;  // -1: the head
    if (newg[k] && carry + l <= N)
      gs[carry + l] = t0 + k * kTileThreads + threadIdx.x;
    if (l >= 0) atomicMin(&smin[l], tm[k]);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n && carry + l < N; l += kTileThreads) {
    int v = smin[l];
    if (l == n - 1) v = heads_after(cnt, cnt + 2 * st, a.TN, t, v);
    nk[carry + l] = v;
  }
  for (int g = total + t * kTileThreads + threadIdx.x; g <= N;
       g += a.TN * kTileThreads) {
    gs[g] = nvalid;
    if (g < N) nk[g] = kBigI;
  }
  if (t == 0 && threadIdx.x == 0) {
    a.over_n[w] = total > N;
    a.n_nodes[w] = 0;
  }
}

// creation slot c of window w (its group's sorted positions [s, e)): its
// instances' nodes into nid, 32 at a time from the sorted payload; the
// class counts and each quality bit's by warp ballots (a class mask a
// ballot, bit b's count popc(ballot(q >> b & 1) & mask), kept by lane
// b % 32), the flags, the mer words and the prune. A warp calls it;
// returns whether the node exists.
__device__ __forceinline__ bool node_slot(const NodeArgs& a, int w, int c,
                                          int s, int e, float thr) {
  const int N = a.N, I = a.I, K = a.K, NW = a.NW, lane = threadIdx.x & 31;
  const long long wI = static_cast<long long>(w) * I;
  const long long wc = static_cast<long long>(w) * N + c;
  int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
  long long cn[4] = {0, 0, 0, 0};
  bool has = false, inidx = false, nml = false, tum = false;
  for (int base = s; base < e; base += 32) {
    const int p = base + lane;
    long long pv = 0, q = 0;
    if (p < e) {
      const long long x = a.perm[wI + p];
      pv = a.spay[wI + p];
      q = a.qok[wI + x];
      a.nid[wI + x] = c;
    }
    const bool rd = bit(pv, kRead);
    has |= __any_sync(kFull, rd);
    inidx |= __any_sync(kFull, bit(pv, kIdx));
    nml |= __any_sync(kFull, rd && bit(pv, kNml));
    tum |= __any_sync(kFull, bit(pv, kTflag));
    const bool cov = rd && !bit(pv, kRef);
    const int cls = (bit(pv, kTmr) ? 0 : 2) + (bit(pv, kStrand) ? 1 : 0);
    unsigned cm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cm[j] = __ballot_sync(kFull, cov && cls == j);
      cn[j] += __popc(cm[j]);
    }
    for (int bt = 0; bt < K; ++bt) {
      const unsigned m = __ballot_sync(kFull, (q >> bt) & 1);
      if (lane == (bt & 31)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = __popc(m & cm[j]);
          if (bt < 32)
            lo[j] += d;
          else
            hi[j] += d;
        }
      }
    }
  }
  // the group's mer (all-T words for a group without instances)
  if (lane < NW) {
    const int nb = lane == 0 ? K - 31 * (NW - 1) : 31;
    a.mers[lane * static_cast<long long>(a.W) * N + wc] =
        s < e ? a.keys[lane * static_cast<long long>(a.W) * I + wI +
                       a.perm[wI + s]]
              : (1LL << (2 * nb)) - 1;
  }
  long long tmin = LLONG_MAX;
  if (lane < K) {
    reinterpret_cast<int4*>(a.mq)[wc * K + lane] =
        make_int4(lo[0], lo[1], lo[2], lo[3]);
    const long long t = static_cast<long long>(lo[0]) + lo[1] + lo[2] + lo[3];
    a.totq[wc * K + lane] = t;
    tmin = t;
  }
  if (lane + 32 < K) {
    reinterpret_cast<int4*>(a.mq)[wc * K + lane + 32] =
        make_int4(hi[0], hi[1], hi[2], hi[3]);
    const long long t = static_cast<long long>(hi[0]) + hi[1] + hi[2] + hi[3];
    a.totq[wc * K + lane + 32] = t;
    tmin = t < tmin ? t : tmin;
  }
  tmin = warp_min(tmin);
  if (lane == 0) {
    long long* o = a.counts + wc * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = cn[j];
    const long long mincov = has ? tmin : 0;
    const bool low = mincov <= a.low_cov_threshold ||
                     __ll2float_rn(mincov) <= thr ||
                     (cn[0] + cn[1] == 1 && cn[2] + cn[3] == 1);
    a.mincov_qv[wc] = mincov;
    a.exists[wc] = has;
    a.alive[wc] = has && !low;
    a.low[wc] = low;
    a.in_index[wc] = inidx;
    a.is_tumor[wc] = tum;
    a.is_normal[wc] = nml;
  }
  return has;
}

// phase 1, after window_sort gives the creation order: (window, SL
// creation slots) blocks, a warp a slot at a time (node_slot), a warp's
// slots' groups and ranges loaded by its lanes first, all in flight
// together; n_nodes summed over the blocks
__global__ void __launch_bounds__(kTileThreads)
    node_tables_order(const NodeArgs a) {
  __shared__ int nn;
  const int w = blockIdx.x / a.NB, b = blockIdx.x - w * a.NB;
  const int N = a.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* gs = a.gstart + static_cast<long long>(w) * (N + 1);
  if (threadIdx.x == 0) nn = 0;
  __syncthreads();
  const float avg =
      __fdiv_rn(static_cast<float>(a.totalreadbp[w]),
                fmaxf(static_cast<float>(static_cast<long long>(a.rawlen[w])),
                      1.0f));
  const float thr = __fmul_rn(a.min_cov_ratio, avg);
  // the warp's slots c0 + 8 i: lane i loads slot i's group and its range
  // (SL <= 256: at most 32 a warp)
  const int c0 = b * a.SL + warp, c1 = min((b + 1) * a.SL, N);
  const int nsl = c0 < c1 ? (c1 - c0 + kTileWarps - 1) / kTileWarps : 0;
  int sl = 0, el = 0;
  if (lane < nsl) {
    const long long g =
        a.order[static_cast<long long>(w) * N + c0 + lane * kTileWarps];
    const int gg = static_cast<int>(g < 0 ? 0 : (g > N - 1 ? N - 1 : g));
    sl = gs[gg];
    el = gs[gg + 1];
  }
  int has = 0;
  for (int i = 0; i < nsl; ++i)
    has += node_slot(a, w, c0 + i * kTileWarps, __shfl_sync(kFull, sl, i),
                     __shfl_sync(kFull, el, i), thr);
  if (lane == 0 && has) atomicAdd(&nn, has);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (nn)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.n_nodes + w),
                static_cast<unsigned long long>(nn));
    if (b == 0) {
      a.avgcov[w] = avg;
      a.rawlen_dev[w] = a.rawlen[w];
    }
  }
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
  long long* ckey;   // [W, PU]: the pair sort's keys
  long long* ct;     // [W, PU]: each pair's key and time lane (pack_ct)
  const long long* cperm;   // [W, PU]
  long long* sct;    // [W, PU]: ct in sorted order
  long long* de;     // [W, 2E]: the directed rows (pack_row)
  long long* et_key;  // [W, 2E]
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
  int* ecnt;         // [3, W, TPu]: each tile's canonical group starts and
                     // its head's two time lanes
  int* nself;        // [W, TPu]: each tile's palindromic self-loops
  int* flags;        // [W]: 2 where a mate tile found a candidate
  int W, R, M, Mraw, Lraw, K, NW, I, IP, PU, N, E, D;
  int T, TPu, TE, TJ, TM;  // positions a tile; tiles a window of T pair
                           // keys, rows, reference positions, mate keys
};

// The edge tables' launches: 0 the pair keys; 1 their tiles' counts and 2
// their groups and rows (after the pair sort); 3 the time order, the
// reference projection and the mate candidates (after the time and mate
// sorts); 4 the adjacency and the flags (after the adjacency sort). An
// adjacency block's shared memory: each source's first slot and count
// [N + 64] ints, then the sources in the adjacency sort's order [E] ints.
struct EdgeLayout {
  size_t cn, ks, total;
};

__host__ __device__ inline EdgeLayout edge_layout(int N, int E) {
  EdgeLayout o{};
  o.cn = round16(sizeof(int) * (N + 64));
  o.ks = 2 * o.cn;
  o.total = o.ks + round16(sizeof(int) * E);
  return o;
}

// A pair's key and time lane in one int64 (the key, int32 since every
// pair key lies in int32 (build_plan), in the high half; bit 31 whether
// the pair is its twin's orientation; its time, below 2^30), so that the
// gather in sorted order moves one 32-byte sector a pair.
__device__ __forceinline__ long long pack_ct(long long ck, bool tw,
                                             long long t) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(
           static_cast<unsigned>(static_cast<int>(ck)))
       << 32) |
      (static_cast<unsigned long long>(tw) << 31) |
      static_cast<unsigned long long>(t & 0x7fffffff));
}

__device__ __forceinline__ int ct_key(long long ct) {
  return static_cast<int>(ct >> 32);
}

// time lane 0 (the pair in its canonical orientation) or 1 (its twin's):
// its time, BIG in the other lane
__device__ __forceinline__ int ct_lane(long long ct, int lane) {
  const int tw = static_cast<int>((ct >> 31) & 1);
  return tw == lane ? static_cast<int>(ct & 0x7fffffff) : kBigI;
}

// A directed row in one int64: src + 2, dst + 2 (each -2 to N + 63: a
// twin's ends are its canonical row's) and dir | exists << 2, 24, 24 and
// 3 bits (N below 2^24 - 66, and build_plan keeps it far below)
__device__ __forceinline__ long long pack_row(long long src, long long dst,
                                              long long dx) {
  return (src + 2) | ((dst + 2) << 24) | (dx << 48);
}

// launch 0: each adjacent pair's canonical key and its packed time lane,
// tiles of T pairs (every load of a thread's kPairBatch pairs before
// their stores)
constexpr int kPairBatch = 4;

__global__ void __launch_bounds__(kTileThreads)
    edge_tables_pairs(const EdgeArgs a) {
  const int w = blockIdx.x / a.TPu, t = blockIdx.x - w * a.TPu;
  const int M = a.M, Mraw = a.Mraw, RM = a.R * a.M;
  const long long wI = static_cast<long long>(w) * a.I;
  const long long* pay = a.pay + wI;
  const long long* nid = a.nid + wI;
  const long long NODECAP = a.N + 64;
  const int q1 = min((t + 1) * a.T, a.PU);
  for (int q0 = t * a.T + threadIdx.x; q0 < q1;
       q0 += kPairBatch * kTileThreads) {
    long long pv[kPairBatch], u[kPairBatch], v[kPairBatch], p1[kPairBatch];
    int off[kPairBatch];
#pragma unroll
    for (int k = 0; k < kPairBatch; ++k) {
      const int q = q0 + k * kTileThreads;
      bool nxt = false;
      off[k] = 0;
      if (q < q1) {
        off[k] = q < RM ? q % M : q - RM;
        nxt = off[k] + 1 < (q < RM ? M : Mraw);
      }
      pv[k] = q < q1 ? pay[q] : 0;
      u[k] = q < q1 ? nid[q] : 0;
      v[k] = nxt ? nid[q + 1] : -1;
      p1[k] = nxt ? pay[q + 1] : 0;
    }
#pragma unroll
    for (int k = 0; k < kPairBatch; ++k) {
      const int q = q0 + k * kTileThreads;
      if (q >= q1) continue;
      const long long uF = bit(pv[k], kIsF), vF = bit(p1[k], kIsF);
      const bool pm = bit(pv[k], kPair);
      const long long tq = pay_time(pv[k]) + (off[k] > 0 ? 1 : 0);
      const long long fdir = (1 - uF) * 2 + (1 - vF);
      const long long rdir = fliplink(fdir);
      const bool tw = v[k] < u[k] || (v[k] == u[k] && rdir < fdir);
      const long long cs = tw ? v[k] : u[k], cd = tw ? u[k] : v[k];
      const long long cr = tw ? rdir : fdir;
      const long long ck = pm ? (cs * NODECAP + cd) * 4 + cr : kI32Max;
      const long long o = static_cast<long long>(w) * a.PU + q;
      a.ckey[o] = ck;
      a.ct[o] = pack_ct(ck, pm && tw, pm ? tq : 0);
    }
  }
}

// launch 1, a tile of the sorted pair keys: each key's packed record
// gathered once (every gather of the tile in flight before the first
// use; the key before a chunk of 32 from the chunk before's last lane, in
// shared memory) and written in sorted order; the tile's count of
// canonical group starts and its head's two time lane minima (of its
// keys ahead of its first start)
__global__ void __launch_bounds__(kTileThreads)
    edge_tables_count(const EdgeArgs a) {
  __shared__ int tot[kScanSlots + 1];
  __shared__ int last[kScanSlots];  // each chunk's last key
  __shared__ int halo, hA, hB;
  const int w = blockIdx.x / a.TPu, t = blockIdx.x - w * a.TPu;
  const int PU = a.PU, items = a.T / kTileThreads, t0 = t * a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wP = static_cast<long long>(w) * PU;
  const long long* cperm = a.cperm + wP;
  const long long* ctab = a.ct + wP;
  const long long none = pack_ct(kI32Max, false, 0);
  long long x[kTileItems], ct[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int p = t0 + k * kTileThreads + threadIdx.x;
    x[k] = k < items && p < PU ? cperm[p] : -1;
  }
  const long long y = threadIdx.x == 0 && t0 > 0 ? cperm[t0 - 1] : -1;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) ct[k] = x[k] >= 0 ? ctab[x[k]] : none;
  if (threadIdx.x == 0) {
    halo = y >= 0 ? ct_key(ctab[y]) : kI32MaxI;
    hA = hB = kI32MaxI;
  }
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    if (k < items && lane == 31) last[k * kTileWarps + warp] = ct_key(ct[k]);
  __syncthreads();
  bool enew[kTileItems], ev[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    enew[k] = ev[k] = false;
    if (k >= items) continue;  // the same for the whole block
    const int p = t0 + k * kTileThreads + threadIdx.x;
    const int ck = ct_key(ct[k]);
    int prev = __shfl_up_sync(kFull, ck, 1);
    if (lane == 0) {
      const int c = k * kTileWarps + warp;
      prev = c == 0 ? halo : last[c - 1];
    }
    if (p < PU) a.sct[wP + p] = ct[k];
    ev[k] = p < PU && ck != kI32MaxI;
    enew[k] = ev[k] && (p == 0 || ck != prev);
  }
  int before[kTileItems];
  const int n = tile_scan(enew, items, before, tot);
  int mA = kI32MaxI, mB = kI32MaxI;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (ev[k] && before[k] + enew[k] == 0) {
      mA = min(mA, ct_lane(ct[k], 0));
      mB = min(mB, ct_lane(ct[k], 1));
    }
  }
  mA = warp_min_i(mA);
  mB = warp_min_i(mB);
  if (lane == 0) {
    atomicMin(&hA, mA);
    atomicMin(&hB, mB);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long st = static_cast<long long>(a.W) * a.TPu;
    int* c = a.ecnt + static_cast<long long>(w) * a.TPu + t;
    c[0] = n;
    c[st] = hA;
    c[2 * st] = hB;
  }
}

// canonical group g's two directed rows, each with its time key (ck its
// key, gA and gB its time lanes' minima; ck I32_MAX: an empty group);
// returns whether it is a palindromic self-loop (its own twin)
__device__ __forceinline__ bool edge_row(const EdgeArgs& a, int w, int g,
                                         long long ck, long long gA,
                                         long long gB) {
  const long long NODECAP = a.N + 64;
  const int E = a.E;
  const long long w2 = static_cast<long long>(w) * 2 * E;
  const bool ex = ck != kI32Max;
  const long long dir = ex ? floormod(ck, 4) : 0;
  const long long dst = ex ? floormod(floordiv(ck, 4), NODECAP) : 0;
  const long long src = ex ? floordiv(ck, 4 * NODECAP) : 0;
  const long long tc = min(gA, min(gB, kBig - 1) + 1);
  const long long tt = min(gB, min(gA, kBig - 1) + 1);
  const bool selftw = ex && src == dst && (dir == 1 || dir == 2);
  const bool ex2 = ex && !selftw;
  a.de[w2 + g] = pack_row(src, dst, dir | (static_cast<long long>(ex) << 2));
  a.et_key[w2 + g] = ex ? tc : kBig;
  a.de[w2 + E + g] =
      pack_row(dst, src, fliplink(dir) | (static_cast<long long>(ex2) << 2));
  a.et_key[w2 + E + g] = ex2 ? tt : kBig;
  return selftw;
}

// launch 2, a tile of the sorted pair keys: its canonical groups (at most
// E a window) numbered from the earlier tiles' counts and one tile scan,
// their time lane minima by shared atomic minima (its last group's with
// the heads it runs into), their directed rows; the rows past the
// window's last group empty; the tile's count of palindromic self-loops;
// tile 0 clears the window's flags
__global__ void __launch_bounds__(kTileThreads)
    edge_tables_groups(const EdgeArgs a) {
  __shared__ int tot[kScanSlots + 1];
  __shared__ int gA[kTileMax], gB[kTileMax], gck[kTileMax];
  __shared__ int sums[2];
  __shared__ int n_self;
  const int w = blockIdx.x / a.TPu, t = blockIdx.x - w * a.TPu;
  const int PU = a.PU, E = a.E, items = a.T / kTileThreads, t0 = t * a.T;
  const int lane = threadIdx.x & 31;
  const long long st = static_cast<long long>(a.W) * a.TPu;
  const int* cnt = a.ecnt + static_cast<long long>(w) * a.TPu;
  const long long* sct = a.sct + static_cast<long long>(w) * PU;
  tile_sums(cnt, a.TPu, t, sums);  // carry, all groups
  for (int l = threadIdx.x; l < a.T; l += kTileThreads)
    gA[l] = gB[l] = kI32MaxI;
  if (threadIdx.x == 0) n_self = 0;
  const long long none = pack_ct(kI32Max, false, 0);
  bool enew[kTileItems], ev[kTileItems];
  long long ct[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int p = t0 + k * kTileThreads + threadIdx.x;
    const bool in = k < items && p < PU;
    ct[k] = in ? sct[p] : none;
    const int ck = ct_key(ct[k]);
    int prev = __shfl_up_sync(kFull, ck, 1);
    if (lane == 0 && in && p > 0) prev = ct_key(sct[p - 1]);
    ev[k] = in && ck != kI32MaxI;
    enew[k] = ev[k] && (p == 0 || ck != prev);
  }
  int before[kTileItems];
  const int n = tile_scan(enew, items, before, tot);
  const int carry = sums[0], total = sums[1];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (!ev[k]) continue;
    const int l = before[k] + enew[k] - 1;  // -1: the head
    if (enew[k]) gck[l] = ct_key(ct[k]);
    if (l >= 0) {
      atomicMin(&gA[l], ct_lane(ct[k], 0));
      atomicMin(&gB[l], ct_lane(ct[k], 1));
    }
  }
  __syncthreads();
  int ns = 0;
  for (int l = threadIdx.x; l < n && carry + l < E; l += kTileThreads) {
    int mA = gA[l], mB = gB[l];
    if (l == n - 1) {
      mA = heads_after(cnt, cnt + st, a.TPu, t, mA);
      mB = heads_after(cnt, cnt + 2 * st, a.TPu, t, mB);
    }
    ns += edge_row(a, w, carry + l, gck[l], mA, mB);
  }
  for (int g = total + t * kTileThreads + threadIdx.x; g < E;
       g += a.TPu * kTileThreads)
    edge_row(a, w, g, kI32Max, kI32MaxI, kI32MaxI);
  ns = warp_sum_i(ns);
  if (lane == 0 && ns) atomicAdd(&n_self, ns);
  __syncthreads();
  if (threadIdx.x == 0) {
    a.nself[static_cast<long long>(w) * a.TPu + t] = n_self;
    if (t == 0) a.flags[w] = 0;  // for launch 3's mate tiles
  }
}

// launch 3, row tile t of window w: the directed rows in time order,
// truncated to E, and the sources' sort key; a slice of deg zeroed and of
// adj set to -1 for launch 4; tile 0: n_edges and over_e from every pair
// tile's counts
__device__ void order_tile(const EdgeArgs& a, int w, int t, int* sums) {
  const int E = a.E, N = a.N;
  const long long w2 = static_cast<long long>(w) * 2 * E;
  const long long wE = static_cast<long long>(w) * E;
  const int r0 = t * a.T + threadIdx.x, r1 = min((t + 1) * a.T, E);
  long long d[kTileItems];  // every load of the tile before its stores
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int r = r0 + k * kTileThreads;
    d[k] = r < r1 ? a.eorder[w2 + r] : -1;
  }
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) d[k] = d[k] >= 0 ? a.de[w2 + d[k]] : -1;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int r = r0 + k * kTileThreads;
    if (r >= r1) continue;
    const long long dx = d[k] >> 48;
    const bool ex = (dx >> 2) & 1;
    const long long src = ex ? (d[k] & 0xffffff) - 2 : -1;
    a.edge_src[wE + r] = src;
    a.edge_dst[wE + r] = ex ? ((d[k] >> 24) & 0xffffff) - 2 : -1;
    a.edge_dir[wE + r] = ex ? (dx & 3) : 0;
    a.edge_exists[wE + r] = src >= 0;
    a.ak_key[wE + r] = src >= 0 ? src : kI32Max;
  }
  const int vs = (N + a.TE - 1) / a.TE;
  for (int v = t * vs + threadIdx.x; v < min((t + 1) * vs, N);
       v += kTileThreads)
    a.deg[static_cast<long long>(w) * N + v] = 0;
  const long long ND = static_cast<long long>(N) * a.D;
  const long long as = (ND + a.TE - 1) / a.TE;
  long long* adj = a.adj + static_cast<long long>(w) * ND;
  for (long long i = t * as + threadIdx.x; i < min((t + 1) * as, ND);
       i += kTileThreads)
    adj[i] = -1;
  if (t == 0) {  // the same for the whole block
    const long long wT = static_cast<long long>(w) * a.TPu;
    tile_sums(a.ecnt + wT, a.TPu, 0, sums);
    tile_sums(a.nself + wT, a.TPu, 0, sums + 2);
    __syncthreads();
    if (threadIdx.x == 0) {
      const int total = sums[1];
      const long long n_edges = 2LL * min(total, E) - sums[3];
      a.n_edges[w] = n_edges;
      a.over_e[w] = n_edges > E || total > E;
    }
  }
}

// launch 3, reference tile j of window w: T positions of the projection's
// node ids and strands and of refcov (mer i covers base i + K - 1, mer 0
// bases 0..K-1)
__device__ void ref_tile(const EdgeArgs& a, int w, int j) {
  const int K = a.K, N = a.N, RM = a.R * a.M, Mraw = a.Mraw;
  const long long wI = static_cast<long long>(w) * a.I;
  const long long* nidp = a.nid + wI + RM + Mraw;
  const long long n_proj = max(a.rawlen[w] - K, 0LL);
  const int r1 = min((j + 1) * a.T, a.Lraw);
  for (int r = j * a.T + threadIdx.x; r < r1; r += kTileThreads) {
    if (r < Mraw) {
      a.nid_proj[static_cast<long long>(w) * Mraw + r] = nidp[r];
      a.proj_isF[static_cast<long long>(w) * Mraw + r] =
          bit(a.pay[wI + RM + r], kIsF);
    }
    const int i = r >= K - 1 ? r - K + 1 : 0;
    const bool on = r >= K - 1 ? i < n_proj : n_proj > 0;
    const long long nd = on ? nidp[i] : -1;
    long long* out = a.refcov + (static_cast<long long>(w) * a.Lraw + r) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      long long val = 0;
      if (nd >= 0) {
        const long long wn = static_cast<long long>(w) * N + nd;
        const long long cc = a.counts[wn * 4 + c];
        val = a.in_index[wn] && cc > 0 ? cc : 0;
      }
      out[c] = val;
    }
  }
}

// launch 3, mate tile m of window w: T sorted mate keys; whether a run of
// (mer, fragment) holds both mate orders of one fragment. A key's
// fragment is gathered once (every gather of the tile in flight first;
// the key before a chunk of 32 from the chunk before's last lane, in
// shared memory), its words only where the fragments agree. Every thread
// calls it.
__device__ bool mate_tile(const EdgeArgs& a, int w, int m) {
  __shared__ long long lx[kScanSlots], lf[kScanSlots];
  __shared__ long long hx, hf;
  const int IP = a.IP, NW = a.NW, items = a.T / kTileThreads;
  const int t0 = m * a.T, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long fplane = static_cast<long long>(a.W) * IP;
  const long long wF = static_cast<long long>(w) * IP;
  const long long wI = static_cast<long long>(w) * a.I;
  const long long* fk = a.fkeys + wF;
  const long long* fperm = a.fperm + wF;
  const long long* fr = fk + NW * fplane;
  long long x[kTileItems], fx[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int p = t0 + k * kTileThreads + threadIdx.x;
    x[k] = k < items && p < IP ? fperm[p] : -1;
  }
  const long long y = threadIdx.x == 0 && t0 > 0 ? fperm[t0 - 1] : -1;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    fx[k] = x[k] >= 0 ? fr[x[k]] : kI32Max;
  if (threadIdx.x == 0) {
    hx = y;
    hf = y >= 0 ? fr[y] : kI32Max;
  }
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (k < items && lane == 31) {
      lx[k * kTileWarps + warp] = x[k];
      lf[k * kTileWarps + warp] = fx[k];
    }
  }
  __syncthreads();
  bool cand = false;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (k >= items) continue;  // the same for the whole block
    long long px = __shfl_up_sync(kFull, x[k], 1);
    long long pf = __shfl_up_sync(kFull, fx[k], 1);
    if (lane == 0) {
      const int c = k * kTileWarps + warp;
      px = c == 0 ? hx : lx[c - 1];
      pf = c == 0 ? hf : lf[c - 1];
    }
    if (x[k] >= 0 && px >= 0 && fx[k] != kI32Max && fx[k] == pf) {
      bool same = true;
      for (int i = 0; i < NW; ++i)
        same &= fk[i * fplane + x[k]] == fk[i * fplane + px];
      const long long ox = (a.pay[wI + x[k]] >> kOrder) & 0xff;
      const long long oy = (a.pay[wI + px] >> kOrder) & 0xff;
      cand |= same && ox != oy && ox > 0 && oy > 0;
    }
  }
  return __syncthreads_or(cand);
}

// launch 3, after the time and mate sorts: each window's TE row tiles
// (order_tile), TJ reference tiles (ref_tile) and TM mate tiles
// (mate_tile, which sets the window's mate flag, cleared by launch 2)
__global__ void __launch_bounds__(kTileThreads)
    edge_tables_order(const EdgeArgs a) {
  __shared__ int sums[4];
  const int per = a.TE + a.TJ + a.TM;
  const int w = blockIdx.x / per, j = blockIdx.x - w * per;
  if (j < a.TE) {  // the same for the whole block
    order_tile(a, w, j, sums);
  } else if (j < a.TE + a.TJ) {
    ref_tile(a, w, j - a.TE);
  } else if (mate_tile(a, w, j - a.TE - a.TJ) && threadIdx.x == 0) {
    atomicOr(&a.flags[w], 2);
  }
}

// launch 4, after the adjacency sort, a block a window: each source's
// first slot and count in shared memory (sources: node ids and the N + 63
// of a pair whose two mers are past N), adj and deg (a count added to
// deg's segment w (N + 1) + source where it falls, as the JAX build's
// segment sum); then mate_cand and fallback, every tile's flag being in
__global__ void __launch_bounds__(kThreads) edge_tables_adj(const EdgeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = blockIdx.x, E = a.E, N = a.N, D = a.D;
  const int NC = N + 64;
  const EdgeLayout lay = edge_layout(N, E);
  int* fp = reinterpret_cast<int*>(smem);
  int* cn = reinterpret_cast<int*>(smem + lay.cn);
  int* ks = reinterpret_cast<int*>(smem + lay.ks);
  const long long wE = static_cast<long long>(w) * E;
  const long long* aperm = a.aperm + wE;
  const long long* ak = a.ak_key + wE;
  for (int v = threadIdx.x; v < NC; v += kThreads) {
    fp[v] = kI32MaxI;
    cn[v] = 0;
  }
  constexpr int kBatch = 4;  // loads in flight a thread
  for (int p0 = threadIdx.x; p0 < E; p0 += kBatch * kThreads) {
    long long x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      x[u] = p < E ? aperm[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      if (p < E) {
        const long long k1 = ak[x[u]];
        ks[p] = k1 >= 0 && k1 < NC ? static_cast<int>(k1) : -1;
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < E; p += kThreads) {
    const int k1 = ks[p];
    if (k1 >= 0) {
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
  long long* adj = a.adj + static_cast<long long>(w) * N * D;
  for (int p0 = threadIdx.x; p0 < E; p0 += kBatch * kThreads) {
    long long x[kBatch];  // every load of the batch before its stores
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      const int k1 = p < E ? ks[p] : -1;
      x[u] = k1 >= 0 && k1 < N && p - fp[k1] < D ? aperm[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      if (x[u] >= 0) {
        const int k1 = ks[p];
        adj[static_cast<long long>(k1) * D + p - fp[k1]] = x[u];
      }
    }
  }
  over_d = __syncthreads_or(over_d);
  if (threadIdx.x == 0) {
    const bool ok = a.window_ok[w] != 0;
    const bool cand = (a.flags[w] & 2) != 0;
    a.mate_cand[w] = cand && ok;
    a.fallback[w] = (a.over_n[w] || a.over_e[w] || over_d || cand) && ok;
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

// mer_instances' tiles and a block's dynamic shared memory: TR read
// tiles of TQ instances and TF reference tiles of RQ offsets a window; a
// read tile stages the reads it touches, a reference tile the window's
// reference
struct InstPlan {
  int M, Mraw, TR, TF;
  size_t smem;
};

InstPlan inst_plan(int R, int L, int Lraw, int K, int TQ, int RQ) {
  InstPlan o{};
  o.M = L - K + 1;
  o.Mraw = Lraw - K + 1;
  o.TR = (R * o.M + TQ - 1) / TQ;
  o.TF = (o.Mraw + RQ - 1) / RQ;
  const size_t reads = static_cast<size_t>(TQ) +
                       static_cast<size_t>((TQ - 1) / o.M + 2) *
                           read_stride(L);
  const size_t ref = seq_layout(Lraw).words;
  o.smem = 4 * (reads > ref ? reads : ref);
  return o;
}

// A sort's launches: NL key lanes a record (1, 2, 4, 6 or 8), passes of
// 8 bits over the key's B bits, T tiles a window; one launch where a
// tile holds the window, else 2 passes (the records and pass 0's counts,
// then each pass's scatter and, past pass 0, its counts); scratch: int64
// elements of two record buffers [W, NL + 1, n] and the counts [W, T,
// 256] (32-bit); smem: a scatter or tile block's bytes.
struct SortPlan {
  int NL, passes, T, launches;
  long long scratch;
  size_t smem;
};

int sort_plan(int NK, const int* bits, const int* has_sent, int W, int n,
              int tile, SortPlan* o) {
  if (W <= 0 || n <= 0 || NK < 1 || NK > kSortMaxKeys || tile < 256 ||
      tile > 4096 || (tile & (tile - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int B = 0;
  for (int c = 0; c < NK; ++c) {
    if (bits[c] < 1 || bits[c] > 64 || has_sent[c] < 0 || has_sent[c] > 1 ||
        (has_sent[c] && bits[c] > 63))
      return static_cast<int>(cudaErrorInvalidValue);
    B += bits[c] + has_sent[c];
  }
  const int q = (B + 31) / 32;
  o->NL = q <= 2 ? q : (q <= 4 ? 4 : (q <= 6 ? 6 : 8));
  o->passes = (B + 7) / 8;
  o->T = (n + tile - 1) / tile;
  o->launches = o->T == 1 ? 1 : 2 * o->passes;
  o->scratch = o->T == 1 ? 0
                         : (2LL * W * (o->NL + 1) * n +
                            static_cast<long long>(W) * o->T * kDigits + 1) /
                               2;
  o->smem = 4 * static_cast<size_t>(sort_smem_layout(o->NL, tile).total);
  return 0;
}

template <int NL>
int sort_run(SortArgs& a, const SortPlan& pl, unsigned* rec,
             cudaStream_t s) {
  const int threads = a.tile / kSortItems;
  const size_t smem = pl.smem;
  if (a.T == 1)
    return launch_checked(
        reinterpret_cast<const void*>(window_sort_tile<NL>), smem,
        [&] { window_sort_tile<NL><<<a.W, threads, smem, s>>>(a); });
  const long long per = static_cast<long long>(a.W) * (NL + 1) * a.n;
  unsigned* buf[2] = {rec, rec + per};
  a.cnt = rec + 2 * per;
  const int grid = a.W * a.T;
  int rc = launch_checked(
      reinterpret_cast<const void*>(window_sort_keys<NL>), 0,
      [&] { window_sort_keys<NL><<<grid, threads, 0, s>>>(a, buf[0]); });
  for (int p = 0; p < a.passes && rc == 0; ++p) {
    const unsigned* in = buf[p & 1];
    unsigned* out = buf[(p + 1) & 1];
    if (p > 0)
      rc = launch_checked(
          reinterpret_cast<const void*>(window_sort_count<NL>), 0,
          [&] { window_sort_count<NL><<<grid, threads, 0, s>>>(a, in, p); });
    if (rc == 0)
      rc = launch_checked(
          reinterpret_cast<const void*>(window_sort_scatter<NL>), smem, [&] {
            window_sort_scatter<NL><<<grid, threads, smem, s>>>(a, in, out,
                                                                 p);
          });
  }
  return rc;
}

// node_tables' and edge_tables' blocks: TN tiles of T sorted instances
// and NB blocks of SL creation slots a window; TPu tiles of T pair keys,
// TE of T directed rows, TJ of T reference positions and TM of T mate
// keys a window; smem: an edge_tables_adj block's bytes. T a multiple
// of 256 up to kTileMax, SL of kTileWarps up to 256 (a warp's slots in
// its lanes).
struct TablePlan {
  int TN, NB, TPu, TE, TJ, TM;
  size_t smem;
};

bool tiles_ok(int T, int SL) {
  return T >= kTileThreads && T <= kTileMax && T % kTileThreads == 0 &&
         SL >= kTileWarps && SL <= 32 * kTileWarps && SL % kTileWarps == 0;
}

// node_tables' blocks a window: TN tiles of T of the I sorted instances,
// NB blocks of SL creation slots.
void node_blocks(int I, int N, int T, int SL, int* TN, int* NB) {
  *TN = (I + T - 1) / T;
  *NB = (N + SL - 1) / SL;
}

TablePlan table_plan(int R, int L, int Lraw, int K, int N, int E, int T,
                     int SL) {
  const int M = L - K + 1, Mraw = Lraw - K + 1, IP = R * M;
  TablePlan o{};
  node_blocks(IP + 3 * Mraw, N, T, SL, &o.TN, &o.NB);
  o.TPu = (IP + Mraw + T - 1) / T;
  o.TE = (E + T - 1) / T;
  o.TJ = (Lraw + T - 1) / T;
  o.TM = (IP + T - 1) / T;
  o.smem = edge_layout(N, E).total;
  return o;
}

}  // namespace

extern "C" {

// mer_instances' tiles for gpu/dbgk.py's plan check: out (TR, TF, smem).
int dbg_inst_plan(int R, int L, int Lraw, int K, int TQ, int RQ,
                  long long* out) {
  if (R <= 0 || K < 1 || K > 63 || L < K || Lraw < K || TQ < 1 || RQ < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const InstPlan p = inst_plan(R, L, Lraw, K, TQ, RQ);
  out[0] = p.TR;
  out[1] = p.TF;
  out[2] = static_cast<long long>(p.smem);
  return 0;
}

// window_sort's plan for gpu/dbgk.py's check: out (NL, passes, T,
// launches, scratch, smem).
int dbg_sort_plan(int NK, const int* bits, const int* has_sent, int W, int n,
                  int tile, long long* out) {
  SortPlan p{};
  const int rc = sort_plan(NK, bits, has_sent, W, n, tile, &p);
  if (rc) return rc;
  out[0] = p.NL;
  out[1] = p.passes;
  out[2] = p.T;
  out[3] = p.launches;
  out[4] = p.scratch;
  out[5] = static_cast<long long>(p.smem);
  return 0;
}

// node_tables' and edge_tables' blocks for gpu/dbgk.py's plan check: out
// (TN, NB, TPu, TE, TJ, TM, smem).
int dbg_table_plan(int R, int L, int Lraw, int K, int N, int E, int T,
                   int SL, long long* out) {
  if (R <= 0 || K < 1 || K > 63 || L < K || Lraw < K || N <= 0 || E <= 0 ||
      !tiles_ok(T, SL))
    return static_cast<int>(cudaErrorInvalidValue);
  const TablePlan p = table_plan(R, L, Lraw, K, N, E, T, SL);
  out[0] = p.TN;
  out[1] = p.NB;
  out[2] = p.TPu;
  out[3] = p.TE;
  out[4] = p.TJ;
  out[5] = p.TM;
  out[6] = static_cast<long long>(p.smem);
  return 0;
}

// mer_instances, two launches: W windows; ins (bases, quals, rlen,
// rsample, rstrand, rfrag, rorder, raw, rawlen, seq_off, seq_len,
// window_ok), outs (keys, pay, qok, fkeys), cnt [W, TR] int32 scratch;
// read tiles of TQ instances, reference tiles of RQ offsets.
int dbg_instances(const void* const* ins, void* const* outs, void* cnt,
                  int W, int R, int L, int Lraw, int K, int minq, int TQ,
                  int RQ, size_t smem, void* stream) {
  if (W <= 0 || R <= 0 || K < 1 || K > 63 || L < K || Lraw < K || TQ < 1 ||
      RQ < 1 || cnt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const InstPlan pl = inst_plan(R, L, Lraw, K, TQ, RQ);
  if (smem != pl.smem) return static_cast<int>(cudaErrorInvalidValue);
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
  a.cnt = static_cast<int*>(cnt);
  a.W = W;
  a.R = R;
  a.L = L;
  a.Lraw = Lraw;
  a.K = K;
  a.NW = (K + 30) / 31;
  a.M = pl.M;
  a.Mraw = pl.Mraw;
  a.IP = R * a.M;
  a.I = a.IP + 3 * a.Mraw;
  a.minq = minq;
  a.TQ = TQ;
  a.TR = pl.TR;
  a.RQ = RQ;
  a.TF = pl.TF;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_checked(
      reinterpret_cast<const void*>(mer_instances_count), smem, [&] {
        mer_instances_count<<<W * pl.TR, kInstThreads, smem, s>>>(a);
      });
  if (rc) return rc;
  return launch_checked(
      reinterpret_cast<const void*>(mer_instances_write), smem, [&] {
        mer_instances_write<<<W * (pl.TR + pl.TF), kInstThreads, smem, s>>>(
            a);
      });
}

// window_sort of W windows of n elements by NK key words (word c of
// window w, element i at keys[c * ps + w * wst + i]; its range lo[c],
// bits[c], sent[c], has_sent[c], as SortArgs says) into perm [W, n]
// int64, in tiles of `tile` records; scratch: the plan's int64 elements
// (null where one tile holds a window). dbg_sort_plan's launches.
int dbg_sort(const void* keys, long long ps, long long wst, int NK, int W,
             int n, const long long* lo, const int* bits,
             const long long* sent, const int* has_sent, int tile,
             void* perm, void* scratch, void* stream) {
  SortPlan pl{};
  int rc = sort_plan(NK, bits, has_sent, W, n, tile, &pl);
  if (rc) return rc;
  if (pl.T > 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SortArgs a{};
  a.keys = static_cast<const long long*>(keys);
  a.ps = ps;
  a.wst = wst;
  for (int c = 0; c < NK; ++c) {
    a.lo[c] = lo[c];
    a.sent[c] = sent[c];
    a.bits[c] = bits[c];
    a.has_sent[c] = has_sent[c];
  }
  a.NK = NK;
  a.W = W;
  a.n = n;
  a.tile = tile;
  a.T = pl.T;
  a.passes = pl.passes;
  a.perm = static_cast<long long*>(perm);
  unsigned* rec = static_cast<unsigned*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl.NL) {
    case 1: return sort_run<1>(a, pl, rec, s);
    case 2: return sort_run<2>(a, pl, rec, s);
    case 4: return sort_run<4>(a, pl, rec, s);
    case 6: return sort_run<6>(a, pl, rec, s);
    default: return sort_run<8>(a, pl, rec, s);
  }
}

// node_tables, phase 0 (two launches: each tile's counts, then the
// groups) or 1 (the creation order; one launch): p the pointers in the
// order of gpu/dbgk.py's NODE_PTRS; tiles of T sorted instances, blocks
// of SL creation slots.
int dbg_nodes(int phase, void* const* p, int W, int I, int N, int K,
              long long low_cov_threshold, float min_cov_ratio, int T,
              int SL, void* stream) {
  if (W <= 0 || I <= 0 || N <= 0 || K < 1 || K > 63 || phase < 0 ||
      phase > 1 || !tiles_ok(T, SL))
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
  a.spay = static_cast<long long*>(p[25]);
  a.tcnt = static_cast<int*>(p[26]);
  a.W = W;
  a.I = I;
  a.N = N;
  a.K = K;
  a.NW = (K + 30) / 31;
  a.T = T;
  a.SL = SL;
  node_blocks(I, N, T, SL, &a.TN, &a.NB);
  a.low_cov_threshold = low_cov_threshold;
  a.min_cov_ratio = min_cov_ratio;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phase == 1)
    return launch_checked(
        reinterpret_cast<const void*>(node_tables_order), 0, [&] {
          node_tables_order<<<W * a.NB, kTileThreads, 0, s>>>(a);
        });
  const int grid = W * a.TN;
  int rc;
  switch (a.NW) {
    case 1:
      rc = launch_checked(
          reinterpret_cast<const void*>(node_tables_count<1>), 0,
          [&] { node_tables_count<1><<<grid, kTileThreads, 0, s>>>(a); });
      break;
    case 2:
      rc = launch_checked(
          reinterpret_cast<const void*>(node_tables_count<2>), 0,
          [&] { node_tables_count<2><<<grid, kTileThreads, 0, s>>>(a); });
      break;
    default:
      rc = launch_checked(
          reinterpret_cast<const void*>(node_tables_count<3>), 0,
          [&] { node_tables_count<3><<<grid, kTileThreads, 0, s>>>(a); });
  }
  if (rc) return rc;
  return launch_checked(
      reinterpret_cast<const void*>(node_tables_groups), 0, [&] {
        node_tables_groups<<<W * a.TN, kTileThreads, 0, s>>>(a);
      });
}

// edge_tables, phase 0 (the pair keys; one launch), 1 (after the pair
// sort: each tile's counts, then the groups and rows; two launches), 2
// (after the time and mate sorts: the time order, the reference and mate
// tiles; one launch) or 3 (after the adjacency sort: the adjacency and
// the flags; one launch): p the pointers in the order of gpu/dbgk.py's
// EDGE_PTRS; tiles of T positions; smem: table_plan's.
int dbg_edges(int phase, void* const* p, int W, int R, int L, int Lraw,
              int K, int N, int E, int D, int T, size_t smem, void* stream) {
  if (W <= 0 || R <= 0 || K < 1 || K > 63 || L < K || Lraw < K || N <= 0 ||
      E <= 0 || D <= 0 || phase < 0 || phase > 3 ||
      !tiles_ok(T, kTileWarps) || smem != edge_layout(N, E).total)
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
  a.ct = static_cast<long long*>(p[10]);
  a.cperm = static_cast<const long long*>(p[11]);
  a.sct = static_cast<long long*>(p[12]);
  a.de = static_cast<long long*>(p[13]);
  a.et_key = static_cast<long long*>(p[14]);
  a.eorder = static_cast<const long long*>(p[15]);
  a.over_e = static_cast<uint8_t*>(p[16]);
  a.ak_key = static_cast<long long*>(p[17]);
  a.aperm = static_cast<const long long*>(p[18]);
  a.n_edges = static_cast<long long*>(p[19]);
  a.edge_src = static_cast<long long*>(p[20]);
  a.edge_dst = static_cast<long long*>(p[21]);
  a.edge_dir = static_cast<long long*>(p[22]);
  a.edge_exists = static_cast<uint8_t*>(p[23]);
  a.adj = static_cast<long long*>(p[24]);
  a.deg = static_cast<long long*>(p[25]);
  a.nid_proj = static_cast<long long*>(p[26]);
  a.proj_isF = static_cast<uint8_t*>(p[27]);
  a.refcov = static_cast<long long*>(p[28]);
  a.mate_cand = static_cast<uint8_t*>(p[29]);
  a.fallback = static_cast<uint8_t*>(p[30]);
  a.ecnt = static_cast<int*>(p[31]);
  a.nself = static_cast<int*>(p[32]);
  a.flags = static_cast<int*>(p[33]);
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
  const TablePlan pl = table_plan(R, L, Lraw, K, N, E, T, kTileWarps);
  a.T = T;
  a.TPu = pl.TPu;
  a.TE = pl.TE;
  a.TJ = pl.TJ;
  a.TM = pl.TM;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  switch (phase) {
    case 0:
      return launch_checked(
          reinterpret_cast<const void*>(edge_tables_pairs), 0, [&] {
            edge_tables_pairs<<<W * a.TPu, kTileThreads, 0, s>>>(a);
          });
    case 1:
      rc = launch_checked(
          reinterpret_cast<const void*>(edge_tables_count), 0, [&] {
            edge_tables_count<<<W * a.TPu, kTileThreads, 0, s>>>(a);
          });
      if (rc) return rc;
      return launch_checked(
          reinterpret_cast<const void*>(edge_tables_groups), 0, [&] {
            edge_tables_groups<<<W * a.TPu, kTileThreads, 0, s>>>(a);
          });
    case 2:
      return launch_checked(
          reinterpret_cast<const void*>(edge_tables_order), 0, [&] {
            edge_tables_order<<<W * (a.TE + a.TJ + a.TM), kTileThreads, 0,
                                s>>>(a);
          });
    default:
      return launch_checked(
          reinterpret_cast<const void*>(edge_tables_adj), smem,
          [&] { edge_tables_adj<<<W, kThreads, smem, s>>>(a); });
  }
}

}  // extern "C"
