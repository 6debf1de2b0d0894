// Fused squared-L2 distance and per-row running top-l over uint8 points
// and uint8 queries, on the int8 tensor cores, without writing the (B, m)
// distance matrix.
//
// Replaces no TPU kernel: the JAX package serves f32 points only.  It is
// the distance_topk step of a point set stored as published in 8 bits
// (BIGANN-1B's SIFT descriptors, 128-d uint8), read as stored: an f32 copy
// would be four times the bytes, and at one card's share of a two-card
// deployment (5e8 points, 64 GB) it would not fit.
//
// What bounds it on an H100: at that step (B = 128, k = 8, m = 62,500,000,
// d = 128) it does 2 * 128 * 128 integer operations for the 128 bytes of
// each point, 256 a byte, under the int8 tensor cores' ridge (1,979 TOP/s
// over 3.35 TB/s, ~590 a byte): it is bound by the bytes, 64.0 GB in 19.1
// ms, with the products 8.3 ms at the dense peak (on the f32 FMA pipes,
// 245 ms).  So the product runs on the tensor cores, and the work is to
// keep the points streaming.
//
// Design: distance_topk_wide.cuh's whole-bucket walk, with its block
// layout, ring, walk over the chunks of every shard, thresholds, candidate
// areas and register merges (topw::Walk, Smem, merge_rows), and its own
// score loop and epilogue:
// - One tile of RT = 128 query rows (8 warps, one block an SM) or RT = 64
//   (4 warps, two blocks an SM; a bucket of 64 rows or fewer, padded)
//   against tiles of 128 points.  The queries stay resident, the points
//   stream through a ring of three 128-byte slabs (128 dims each), one
//   TMA box a slab issued by one thread (an mbarrier per slot; cp.async
//   by all threads where the rows are not 16-byte multiples) and one
//   barrier a slab; the next slab's copy is issued after the products of
//   this one.  Each 16-byte chunk of a slab row r is stored at chunk c ^
//   (r & 7) (the TMA's 128-byte swizzle), so the eight rows of an
//   ldmatrix phase, and the eight of a norm's 16-byte loads, hit eight
//   distinct bank groups.
// - A warp scores 64 rows x 32 points: per 32-byte k-step four ldmatrix.x4
//   of the queries (A, 16 x 32 a fragment), two of the points (B, two 32 x
//   8 fragments each), and 16 mma.sync m16n8k32 .u8.u8.s32, q.p summed in
//   int32 (exact: at most d * 255^2); the next k-step's fragments load
//   while this one's products issue.  A thread holds 8 rows x 8 points of
//   the tile, acc[i][j] at row(i), point(j), the mma's accumulator layout.
// - |q|^2 (once) and each point's |p|^2 (two lanes a point, four
//   independent __dp4a sums each, a row's slabs added in place) are exact
//   integers.
// - The epilogue forms d = |q|^2 + |p|^2 - 2 q.p in int32, exact, and
//   tests a row's eight by their least against the row's threshold value
//   as an integer (thresholds are exact distances or +inf, which converts
//   to INT_MAX); only a row that passes tests each pair, and only a pair
//   at or below it becomes an f32 key (value, id) for the exact key test
//   and the row's candidate area, as in the f32 path.
// Where the time goes at BIGANN's step (68.6 ms against the 19.1 ms bound,
// PERF.md): the phases of the one block an SM run in turn between
// barriers, the epilogue the longest; the products alone would need ~1,000
// cycles a slab at mma.sync's rate and the bytes ~1,280.
// Every distance is an exact integer, and an exact f32 while d * 255^2 <
// 2^24 (d <= 258; the wrappers refuse wider points), so the (value, id)
// lists equal the plain version's, an f64 product rounded once to f32,
// bit for bit: ties go to the smaller id.  Offsets into the points are
// 64-bit (a shard of 62.5e6 points is 8.0e9 bytes).
#include <cuda.h>

#include <cstdint>

#include "distance_topk_wide.cuh"

namespace knn {
namespace u8 {

using tile::ROW_BYTES;
using topw::PT;
using topw::Rows;
using topw::SLAB;
using topw::Shape;
using topw::Smem;

constexpr int BK = ROW_BYTES;    // dims (bytes) a slab
constexpr int NG = 3;            // ring slabs, one commit group each

// Where the ring's mbarriers start: past the block's other state
// (topw::Smem, `bytes` of it), 8-byte aligned.
__host__ __device__ inline size_t ring_bars_at(size_t bytes) {
  return (bytes + 7) & ~static_cast<size_t>(7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The byte offset of 16-byte chunk c of row r in a slab of 128-byte rows.
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// Rows [r0, r0 + R) of a (rows, d) uint8 matrix, bytes [kk BK, kk BK +
// BK) of each, into a slab; rows at or past `end` and bytes past d zero.
// aligned (d and the base a multiple of 16 bytes): cp.async, committed by
// the caller; else plain loads.
template <int R, int NT>
__device__ __forceinline__ void copy_rows(char* slab,
                                          const uint8_t* __restrict__ src,
                                          long long r0, long long end, int kk,
                                          int d, bool aligned) {
  for (int x = threadIdx.x; x < R * 8; x += NT) {
    const int r = x >> 3, c = x & 7, b = kk * BK + c * 16;
    const long long row = r0 + r;
    const int n = row < end ? min(16, max(0, d - b)) : 0;
    char* dst = slab + chunk_at(r, c);
    const uint8_t* s = src + (n > 0 ? row * d + b : 0);
    if (aligned) {
      cp_async16(dst, s, n);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (e < n) w[e >> 2] |= static_cast<unsigned>(s[e]) << (8 * (e & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The sum of squares of 64 bytes of a slab row: chunks 4 h .. 4 h + 3 of
// row r, four independent sums (order-free: integers).
__device__ __forceinline__ unsigned norm_half(const char* slab, int r,
                                              int h) {
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 x =
        *reinterpret_cast<const uint4*>(slab + chunk_at(r, 4 * h + c));
    v[0] = __dp4a(x.x, x.x, v[0]);
    v[1] = __dp4a(x.y, x.y, v[1]);
    v[2] = __dp4a(x.z, x.z, v[2]);
    v[3] = __dp4a(x.w, x.w, v[3]);
  }
  return (v[0] + v[1]) + (v[2] + v[3]);
}

// The squared norms of the R rows of a slab into out[0 .. R), or added to
// what out holds (a row's later slabs): two lanes a row, one a half, added
// across the pair; a row is always the same lane's.  All NT threads (a
// multiple of 32 that divides 2 R).
template <int R, int NT>
__device__ __forceinline__ void norm_rows(const char* slab, int* out,
                                          bool add) {
  for (int x = threadIdx.x; x < 2 * R; x += NT) {
    unsigned v = norm_half(slab, x >> 1, x & 1);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if ((x & 1) == 0)
      out[x >> 1] = (add ? out[x >> 1] : 0) + static_cast<int>(v);
  }
}

// The points' slabs come by the tensor memory accelerator where the rows
// allow it (d a multiple of 16 bytes, a 16-byte aligned base, a ring
// aligned to 1,024 bytes): one thread issues a 128-row x 128-byte box a
// slab, which the TMA writes with the 128-byte swizzle, chunk c of row r
// at c ^ (r & 7), the layout chunk_at reads; rows past the tensor and
// bytes past d are zero.  Each ring slot has an mbarrier that the box's
// bytes complete.  Elsewhere the threads copy by cp.async.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for a 16 x 32 A fragment and a 32 x 8 B fragment, uint8 in,
// int32 sums: c0, c1 at (row g, points 2 t4, 2 t4 + 1), c2, c3 at row g + 8.
__device__ __forceinline__ void mma_u8(int& c0, int& c1, int& c2, int& c3,
                                       const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 32-byte k-step's fragments of the warp's 64 rows (A: four 16 x 32)
// and 32 points (B: four 32 x 8), by ldmatrix.x4: lanes 8 q .. 8 q + 7
// give matrix q's rows; A's matrices are (rows 0-7 | 8-15) x (k bytes
// 0-15 | 16-31), B's (k bytes 0-15 | 16-31) x (points 0-7 | 8-15) of a
// pair of n-tiles.
struct Frags {
  unsigned a[4][4], b[4][2];
};

__device__ __forceinline__ void load_frags(Frags& f, unsigned qa,
                                           unsigned pa, int ks, int lane) {
  const int lr = lane & 7;
  const int qrow = lr + ((lane >> 3) & 1) * 8, qc = lane >> 4;
  const int prow = lr + (lane >> 4) * 8, pc = (lane >> 3) & 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    ldsm_x4(f.a[mt], qa + (qrow + 16 * mt) * ROW_BYTES +
                         (((2 * ks + qc) ^ lr) << 4));
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    unsigned t[4];
    ldsm_x4(t, pa + (prow + 16 * np) * ROW_BYTES +
                   (((2 * ks + pc) ^ lr) << 4));
    f.b[2 * np][0] = t[0];
    f.b[2 * np][1] = t[1];
    f.b[2 * np + 1][0] = t[2];
    f.b[2 * np + 1][1] = t[3];
  }
}

// acc[i][j] += q[row i] . p[point j] over one slab's four 32-byte k-steps
// (bytes past d are zero): the resident query slab qs, the point slab ps;
// the warp's rows wr0 .. wr0 + 63, its points wc0 .. wc0 + 31.  The next
// k-step's fragments load while this one's 16 products issue.
__device__ __forceinline__ void score_slab(const char* qs, const char* ps,
                                           int wr0, int wc0, int lane,
                                           int (&acc)[8][8]) {
  const unsigned qa = smem_addr(qs) + wr0 * ROW_BYTES;
  const unsigned pa = smem_addr(ps) + wc0 * ROW_BYTES;
  Frags f[2];
  load_frags(f[0], qa, pa, 0, lane);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks + 1 < 4) load_frags(f[(ks + 1) & 1], qa, pa, ks + 1, lane);
    const Frags& c = f[ks & 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_u8(acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1],
               acc[2 * mt + 1][2 * nt], acc[2 * mt + 1][2 * nt + 1],
               c.a[mt], c.b[nt][0], c.b[nt][1]);
  }
}

// The whole-bucket walk (topw::Walk: the chunks of every shard, the rows'
// runs, thresholds and merges) with this kernel's tile layout and integer
// epilogue.  |q|^2 and the |p|^2 partials are int32 in the slots the f32
// path keeps for floats.
template <int RT>
struct Walk : topw::Walk<RT> {
  int wr0, wc0, g, t4;           // the warp's tile corner, the lane's place
  Key pre;                       // a row's shared threshold, read ahead
  int pre_step;                  // the step it was read in

  __device__ int row(int i) const {
    return wr0 + (i >> 1) * 16 + g + 8 * (i & 1);
  }
  __device__ int point(int j) const {
    return wc0 + (j >> 1) * 8 + 2 * t4 + (j & 1);
  }
  __device__ const int* qn() const {
    return reinterpret_cast<const int*>(this->sm.qn());
  }

  // Whether the tile's point j is one of the walk's (inside the chunk, and
  // valid where a mask is given).
  __device__ bool live(int s, int n0, int j) const {
    const int n = n0 + point(j);
    return n < this->c1 &&
           (this->valid == nullptr ||
            this->valid[(long long)s * this->m + n] != 0);
  }

  // The pairs of the tile whose distance is at or below its row's
  // threshold value: bit 8 i + j for (row i, point j), live points only.
  // A row's eight are first tested by their least |p|^2 - 2 q.p against
  // the threshold less |q|^2 (a min a pair, no bits); most rows pass none.
  __device__ unsigned long long maybe(const int (&acc)[8][8],
                                      const int (&pn)[8], int s,
                                      int n0) const {
    unsigned long long bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row(i);
      // an exact distance, or +inf: INT_MAX (the conversion saturates);
      // less |q|^2 >= 0, it cannot overflow
      const int t = __float2int_rz(__uint_as_float(static_cast<unsigned>(
                        this->sm.thr()[r] >> 32))) - qn()[r];
      int least = pn[0] - 2 * acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) least = min(least, pn[j] - 2 * acc[i][j]);
      if (least <= t && this->rw.b0 + r < this->rw.B) {
        unsigned rb = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rb |= static_cast<unsigned>(pn[j] - 2 * acc[i][j] <= t &&
                                      live(s, n0, j)) << j;
        bits |= static_cast<unsigned long long>(rb) << (8 * i);
      }
    }
    return bits;
  }

  // Test the pairs of `bits` against their rows' threshold keys and claim
  // a slot for each candidate, one atomicAdd a row; returns those that
  // found none.
  __device__ unsigned long long insert(const int (&acc)[8][8],
                                       const int (&pn)[8], int n0,
                                       unsigned long long bits) {
    const Smem<RT>& sm = this->sm;
    unsigned long long pend = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned rb = static_cast<unsigned>(bits >> (8 * i)) & 0xffu;
      if (rb == 0) continue;
      const int r = row(i);
      const Key th = sm.thr()[r];
      const int q2 = qn()[r];
      Key key[8];
      unsigned cand = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        key[j] = key_of(__int2float_rn(q2 + pn[j] - 2 * acc[i][j]),
                        n0 + point(j));
        if ((rb >> j) & 1 && key[j] < th) cand |= 1u << j;
      }
      if (cand == 0) continue;
      int pos = atomicAdd(&sm.cnt()[r], __popc(cand));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!((cand >> j) & 1)) continue;
        if (pos < sm.C)
          sm.cand()[r * sm.C + pos] = key[j];
        else
          pend |= 1ULL << (8 * i + j);
        ++pos;
      }
    }
    return pend;
  }

  // Tile g's distances into the rows' candidates (topw::Walk::epilogue's
  // order of work).  pnp: the tile's |p|^2 [PT].  Every eighth
  // tile of a step takes the other blocks' thresholds, read from device
  // memory at the tile before (gthr only falls, so the older key still
  // bounds the row).  All threads; ends with a barrier.
  __device__ void epilogue(int g, const int (&acc)[8][8], const int* pnp) {
    const int i = g / this->tpc, t = g % this->tpc;
    this->advance_to(i);
    const Smem<RT>& sm = this->sm;
    const Rows& rw = this->rw;
    const int s = this->shard(i);
    const int tid = threadIdx.x;
    const bool mine = tid < RT && rw.b0 + tid < rw.B;
    const bool refresh = mine && (t & 7) == 0 && t > 0 && pre_step == i;
    const Key gk = pre;
    if (mine && (t & 7) == 7) {
      pre = __ldcg(rw.gthr + (long long)s * rw.B + rw.b0 + tid);
      pre_step = i;
    }
    const int n0 = this->c0 + t * PT;         // local point index
    int pn[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pn[j] = pnp[point(j)];
    const unsigned long long bits = maybe(acc, pn, s, n0);
    unsigned long long pend = bits ? insert(acc, pn, n0, bits) : 0;
    if (refresh) sm.thr()[tid] = kmin(sm.thr()[tid], gk);
    // a full area: merge it and every row at least half full, then test
    // the pending pairs again
    while (__syncthreads_or(pend != 0)) {
      topw::merge_rows<RT>(rw, sm, s, (sm.C + 1) / 2, false);
      __syncthreads();
      pend = insert(acc, pn, n0, pend);
    }
  }
};

template <int RT>
__global__ void __launch_bounds__(Shape<RT>::NT, Shape<RT>::MIN_BLOCKS)
distance_topk_u8_kernel(const uint8_t* __restrict__ q,
                        const uint8_t* __restrict__ p,
                        const unsigned char* __restrict__ valid,
                        Key* __restrict__ gthr, float* __restrict__ out_v,
                        int* __restrict__ out_i, int B, int k, int m, int d,
                        int l, int C, int chunk, int nchunks,
                        const __grid_constant__ CUtensorMap tmap,
                        bool tma_ok) {
  using S = Shape<RT>;
  const int nk = tile::slabs(d, BK);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Walk<RT> w;
  w.valid = valid;
  w.rw = Rows{gthr, out_v, out_i, B, (int)blockIdx.y * RT, l, nchunks};
  w.k = k;
  w.m = m;
  w.c0 = blockIdx.x * chunk;
  w.c1 = min(w.c0 + chunk, m);
  w.tpc = (w.c1 - w.c0 + PT - 1) / PT;
  w.sm = Smem<RT>{nk, NG, C};
  w.cur = 0;
  w.wr0 = (warp >> 2) * 64;
  w.wc0 = (warp & 3) * 32;
  w.g = lane >> 2;
  w.t4 = lane & 3;
  w.pre = INF_KEY;
  w.pre_step = -1;
  const Smem<RT> sm = w.sm;
  int* const pnp = reinterpret_cast<int*>(sm.pnp());

  // the ring's mbarriers, past the block's other state
  uint64_t* const bars = reinterpret_cast<uint64_t*>(
      topw::smem + ring_bars_at(Smem<RT>::bytes(nk, NG, C)));
  const bool tma = tma_ok && (smem_addr(sm.ring()) & 1023) == 0;
  if (tma && tid == 0) {
    for (int x = 0; x < NG; ++x) mbar_init(bars + x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the bucket's queries, resident; |q|^2 one sum a row
  const bool aq = d % 16 == 0 && (reinterpret_cast<size_t>(q) & 15) == 0;
  const bool ap = d % 16 == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
  for (int kk = 0; kk < nk; ++kk)
    copy_rows<RT, S::NT>(sm.q() + kk * RT * ROW_BYTES, q, w.rw.b0, B, kk, d,
                         aq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int kk = 0; kk < nk; ++kk)
    norm_rows<RT, S::NT>(sm.q() + kk * RT * ROW_BYTES,
                         reinterpret_cast<int*>(sm.qn()), kk > 0);
  w.reset(0);

  // one slab into ring slot `slot`, one commit group; a tile's point range
  // is found once, at its first slab
  int ptile = w.first(), pk = 0, issued = 0;
  long long pstart = 0, pend_row = 0;
  auto produce = [&](int slot) {
    if (pk == 0 && valid != nullptr && ptile >= 0)
      ptile = tile::skip_dead<S::NT, 8>(sm.vote(), valid, w, ptile);
    if (ptile >= 0) {
      if (pk == 0) {
        pstart = w.start(ptile);
        pend_row = w.end(ptile);
      }
      if (!tma) {
        copy_rows<PT, S::NT>(sm.ring() + slot * SLAB, p, pstart, pend_row,
                             pk, d, ap);
      } else if (tid == 0) {
        mbar_expect(bars + slot, SLAB);
        tma_box(sm.ring() + slot * SLAB, &tmap, pk * BK,
                static_cast<int>(pstart), bars + slot);
      }
      if (tid == 0) sm.group_tile()[slot] = ptile;
      ++issued;
      if (++pk == nk) {
        pk = 0;
        ptile = w.next(ptile);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < NG - 1; ++s) produce(s);
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
  int ck = 0, buf = 0, pend = -1;
  for (int u = 0; u < issued; ++u) {
    // slab u in: one more may stay in flight
    if (tma)
      mbar_wait(bars + u % NG, (u / NG) & 1);
    else
      cp_async_wait<NG - 2>();
    __syncthreads();
    const int slot = u % NG;
    const int g = sm.group_tile()[slot];
    if (pend >= 0) {
      w.epilogue(pend, acc, pnp + (buf ^ 1) * PT);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0;
      pend = -1;
    }
    const char* slab = sm.ring() + slot * SLAB;
    score_slab(sm.q() + ck * RT * ROW_BYTES, slab, w.wr0, w.wc0, lane,
               acc);
    // the next copies issue while the products run
    produce((u + NG - 1) % NG);
    norm_rows<PT, S::NT>(slab, pnp + buf * PT, ck > 0);
    if (++ck == nk) {
      ck = 0;
      pend = g;
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pend >= 0) w.epilogue(pend, acc, pnp + (buf ^ 1) * PT);
  w.advance_to(k);
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, found through the runtime (no link to
// the driver library), or null.
inline Encode encoder() {
  static Encode fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<Encode>(nullptr);
    return reinterpret_cast<Encode>(f);
  }();
  return fn;
}

// The points, (rows, d) uint8, as a 2-D tensor in boxes of 128 rows x 128
// bytes with the 128-byte swizzle; false where the TMA cannot read them.
inline bool encode_points(CUtensorMap* map, const uint8_t* p, long long rows,
                          int d) {
  const Encode fn = encoder();
  if (fn == nullptr || d % 16 != 0 ||
      (reinterpret_cast<size_t>(p) & 15) != 0)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d)};
  const cuuint32_t box[2] = {BK, PT};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<uint8_t*>(p),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RT>
int launch(const uint8_t* q, const uint8_t* p, const unsigned char* valid,
           Key* gthr, float* out_v, int* out_i, int B, int k, int m, int d,
           int l, int C, int chunk, cudaStream_t stream) {
  if (C < 1 || C > topw::MAX_CAND || l < 1 || l > 256 || chunk % PT != 0 ||
      d < 1 || d > 258)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmap = {};
  const bool tma = encode_points(&tmap, p, (long long)k * m, d);
  const size_t bytes =
      ring_bars_at(Smem<RT>::bytes(tile::slabs(d, BK), NG, C)) +
      NG * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      distance_topk_u8_kernel<RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (m + chunk - 1) / chunk;
  dim3 grid((unsigned)nchunks, (unsigned)((B + RT - 1) / RT));
  distance_topk_u8_kernel<RT><<<grid, Shape<RT>::NT, bytes, stream>>>(
      q, p, valid, gthr, out_v, out_i, B, k, m, d, l, C, chunk, nchunks,
      tmap, tma);
  return (int)cudaGetLastError();
}

}  // namespace u8
}  // namespace knn

// q: (B, d) uint8, p: (k, m, d) uint8, d <= 258; valid: (k, m) uint8 or
// null; gthr: (k, B) keys, +inf keys before the launch; row_tile 64 or
// 128 query rows a block; cand candidate keys a row (<= 128); grid
// (chunks, ceil(B / row_tile)).  out: (k, B, chunks, l) partials of local
// point indices in [0, m), each the chunk's l smallest ascending, (+inf,
// 2^31-1) past its points.  chunk must be a multiple of 128.
extern "C" int knn_distance_topk_u8(const void* q, const void* p,
                                    const unsigned char* valid, void* gthr,
                                    float* out_v, int* out_i, int B, int k,
                                    int m, int d, int l, int chunk,
                                    int row_tile, int cand, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<knn::Key*>(gthr);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* pb = static_cast<const uint8_t*>(p);
  if (row_tile == 64)
    return knn::u8::launch<64>(qb, pb, valid, g, out_v, out_i, B, k, m, d, l,
                               cand, chunk, s);
  if (row_tile == 128)
    return knn::u8::launch<128>(qb, pb, valid, g, out_v, out_i, B, k, m, d,
                                l, cand, chunk, s);
  return (int)cudaErrorInvalidValue;
}
