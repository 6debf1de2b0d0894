// The block-level squared-L2 distance main loop shared by l2_distance.cu
// and distance_topk.cu: a (32 queries x 64 points) tile of
// |q|^2 - 2 q.p + |p|^2 per step, in f32 FMAs, for a walk over point
// tiles that each kernel defines.
//
// What it does about the card (H100, sm_90a):
// - Queries stay resident.  The block's (32, d) query tile is loaded into
//   shared memory once, with 16-byte loads where the rows allow, widened
//   to f32 and zero-padded to whole slabs; |q|^2 is summed once.
// - Point tiles stream through a ring of STAGES = 4 slabs in shared
//   memory with cp.async 16-byte copies and one commit group a slab, so
//   slabs u+1..u+3 are in flight while slab u is computed, and each slab
//   costs one block barrier.  A slab is 64 points x 128 bytes of one
//   point row (32 f32 or 64 bf16 dims); a point's bytes are one
//   contiguous run of the row-major (k*m, d) matrix, so the copies are
//   fully used 128-byte segments.  Ragged points and dims are
//   zero-filled by the copy (src-size 0).  Rows whose 16-byte chunks are
//   not aligned (d % 4 != 0 in f32, d % 8 != 0 in bf16) take plain loads
//   into the same layout.
// - Bank conflicts: slab rows are 128 bytes unpadded, so every point
//   would start on bank 0.  The 16-byte chunk c of point p is stored at
//   chunk c ^ ((p >> 2) & 7).  A warp is 4 query rows x 8 point groups;
//   its thread (ty, tx) reads the 4 consecutive points 4 tx .. 4 tx + 3,
//   so the 8 distinct addresses of each 16-byte point load fall in 8
//   distinct chunk columns, and the 4 query rows of a warp's query load
//   sit 16 bytes apart (row stride = 16 mod 128 bytes).  The |p|^2 pass
//   gives thread t point 4 (t & 7) + ((t >> 3) & 3) + 32 (t >> 5), which
//   is conflict-free under the same swizzle.
// - Register tile: each of the 128 threads holds 4 rows x 4 points, 16
//   FMAs per dim for 8 loads of 16 bytes per 4 (f32) or 8 (bf16) dims.
//   |p|^2 is summed once per point per tile by one thread into shared
//   memory (double-buffered by tile parity), not once per thread row.
// - Dead tiles: where a valid mask is given, the block votes (warp
//   ballots, one barrier) on the flags of the next 32 tiles before the
//   next tile's first slab is copied; a tile with no valid point is
//   neither copied nor scored (the walk's dead() hook runs instead), and
//   a run of dead tiles costs one vote per 32.  Partly valid tiles are
//   scored and the walk's epilogue tests each point.
// - A tile's epilogue runs one slab late, right after the next slab's
//   barrier, so it needs no barrier of its own.
//
// Every point uses the same instruction sequence over the dims in
// ascending order, so equal points give bit-equal distances (the tie
// order of the top-l kernels relies on it).  f32 FMAs only: no TF32.
#pragma once

#include "common.cuh"

namespace knn {
namespace tile {

constexpr int TB = 32;            // queries per tile
constexpr int TN = 64;            // points per tile
constexpr int NT = 128;           // threads per block: 4 warps of 4 x 4
constexpr int STAGES = 4;         // slabs in the ring
constexpr int CHUNKS = 8;         // 16-byte chunks per slab row
constexpr int ROW_BYTES = CHUNKS * 16;
constexpr int SLAB_BYTES = TN * ROW_BYTES;

template <typename T>
struct Dims {
  static constexpr int PER = 16 / sizeof(T);   // dims per chunk
  static constexpr int BK = CHUNKS * PER;      // dims per slab
};

__host__ __device__ inline int slabs(int d, int bk) {
  return (d + bk - 1) / bk;
}
__host__ __device__ inline int q_stride(int d, int bk) {
  return slabs(d, bk) * bk + 4;
}

// Shared memory of the main loop; a kernel's own state follows it.
template <typename T>
inline size_t loop_bytes(int d) {
  const int dq = q_stride(d, Dims<T>::BK);
  return (size_t)STAGES * SLAB_BYTES +
         sizeof(float) * ((size_t)TB * dq + TB + 2 * TN) +
         sizeof(int) * (STAGES + NT / 32);
}

struct Shared {
  char* ring;       // [STAGES][TN][ROW_BYTES], swizzled chunks
  float* q;         // [TB][dq] f32, zero-padded
  float* qn;        // [TB]
  float* pn;        // [2][TN]
  int* slab_tile;   // [STAGES] tile id of each slab in the ring
  unsigned* vote;   // [NT / 32] per-warp ballots of the dead-tile vote
  int dq;
  char* tail;       // first byte after the loop's state
};

template <typename T>
__device__ inline Shared carve(char* base, int d) {
  Shared s;
  s.dq = q_stride(d, Dims<T>::BK);
  s.ring = base;
  s.q = reinterpret_cast<float*>(base + STAGES * SLAB_BYTES);
  s.qn = s.q + TB * s.dq;
  s.pn = s.qn + TB;
  s.slab_tile = reinterpret_cast<int*>(s.pn + 2 * TN);
  s.vote = reinterpret_cast<unsigned*>(s.slab_tile + STAGES);
  s.tail = reinterpret_cast<char*>(s.vote + NT / 32);
  return s;
}

// Which outputs a thread owns.
struct Lane {
  int r0;      // rows r0 + 4 i, i < 4
  int p0;      // points p0 + j, j < 4 (p0 a multiple of 4)
  int norm_p;  // the point whose |p|^2 this thread sums (tid < TN)
};

__device__ inline Lane lane_of(int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  Lane ln;
  ln.r0 = (warp >> 1) * 16 + (lane >> 3);
  ln.p0 = (warp & 1) * 32 + (lane & 7) * 4;
  ln.norm_p = 4 * (tid & 7) + ((tid >> 3) & 3) + 32 * (tid >> 5);
  return ln;
}

__device__ inline int swz(int p, int c) { return c ^ ((p >> 2) & 7); }

template <typename T>
__device__ inline T zero_of();
template <>
__device__ inline float zero_of<float>() { return 0.f; }
template <>
__device__ inline __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

__device__ inline unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ inline unsigned bits_of(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// Chunk of PER values from shared memory, widened to f32.
__device__ inline void load_chunk(const char* a, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(a);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ inline void load_chunk(const char* a, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(a);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    __nv_bfloat162 b;
    *reinterpret_cast<unsigned*>(&b) = w[h];
    const float2 f = __bfloat1622float2(b);
    o[2 * h] = f.x;
    o[2 * h + 1] = f.y;
  }
}

// Whether 16-byte copies may be used for rows of d values of type T.
template <typename T>
__device__ inline bool rows_aligned(const T* p, int d) {
  return d % Dims<T>::PER == 0 &&
         (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Load the query tile rows [b0, b0 + TB) of the (B, d) queries, widened
// and zero-padded, and |q|^2 per row.  Ends with a barrier.
template <typename T>
__device__ void load_queries(const Shared& sm, const T* __restrict__ q,
                             int B, int d, int b0) {
  constexpr int PER = Dims<T>::PER;
  const int tid = threadIdx.x;
  const int dq = sm.dq;
  const int cpr = (dq - 4) / PER;          // chunks per padded row
  const bool vec = rows_aligned(q, d);
  for (int e = tid; e < TB * cpr; e += NT) {
    const int r = e / cpr, c = e % cpr;
    const int b = b0 + r, k0 = c * PER;
    float v[PER];
    if (vec && b < B && k0 < d) {
      load_chunk(reinterpret_cast<const char*>(q + (long long)b * d + k0),
                 v);
    } else {
#pragma unroll
      for (int x = 0; x < PER; ++x)
        v[x] = (b < B && k0 + x < d) ? to_f32(q[(long long)b * d + k0 + x])
                                     : 0.f;
    }
#pragma unroll
    for (int x = 0; x < PER; ++x) sm.q[r * dq + k0 + x] = v[x];
  }
  __syncthreads();
  if (tid < TB) {
    float s = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      const float a = sm.q[tid * dq + kk];
      s = fmaf(a, a, s);
    }
    sm.qn[tid] = s;
  }
  __syncthreads();
}

// Copy dims [k0, k0 + BK) of points [n0, n0 + TN) (zero past n_end or d)
// into one ring slab.
template <typename T>
__device__ void copy_slab(char* slab, const T* __restrict__ p,
                          long long n0, long long n_end, int k0, int d,
                          bool async) {
  constexpr int PER = Dims<T>::PER;
  for (int e = threadIdx.x; e < TN * CHUNKS; e += NT) {
    const int row = e >> 3, c = e & 7;
    const long long n = n0 + row;
    const int kk = k0 + c * PER;
    char* dst = slab + row * ROW_BYTES + (swz(row, c) << 4);
    const bool in = n < n_end && kk < d;
    if (async) {
      cp_async16(dst, in ? p + n * d + kk : p, in ? 16 : 0);
    } else {
      unsigned w[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        w[h] = 0u;
#pragma unroll
        for (int x = h * PER / 4; x < (h + 1) * PER / 4; ++x) {
          const T v = (in && kk + x < d) ? p[n * d + kk + x] : zero_of<T>();
          w[h] |= bits_of(v) << (32 / (PER / 4) * (x - h * PER / 4));
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// acc[i][j] += q[r0 + 4 i] . p[p0 + j] over the slab's BK dims, which are
// dims k0.. of the query rows.
template <typename T>
__device__ __forceinline__ void compute_slab(const char* slab,
                                             const Shared& sm, int k0,
                                             const Lane& ln,
                                             float (&acc)[4][4]) {
  constexpr int PER = Dims<T>::PER;
  const char* prow = slab + ln.p0 * ROW_BYTES;
  const int sw = (ln.p0 >> 2) & 7;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    float a[4][PER], w[4][PER];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* qr = sm.q + (ln.r0 + 4 * i) * sm.dq + k0 + c * PER;
#pragma unroll
      for (int h = 0; h < PER; h += 4) {
        const float4 v = *reinterpret_cast<const float4*>(qr + h);
        a[i][h] = v.x; a[i][h + 1] = v.y; a[i][h + 2] = v.z;
        a[i][h + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load_chunk(prow + j * ROW_BYTES + ((c ^ sw) << 4), w[j]);
#pragma unroll
    for (int x = 0; x < PER; ++x)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(a[i][x], w[j][x], acc[i][j]);
  }
}

// One thread's |p|^2 partial over the slab (tid < TN).
template <typename T>
__device__ __forceinline__ float norm_slab(const char* slab, int p) {
  constexpr int PER = Dims<T>::PER;
  const char* row = slab + p * ROW_BYTES;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    float w[PER];
    load_chunk(row + (swz(p, c) << 4), w);
#pragma unroll
    for (int x = 0; x < PER; ++x) s = fmaf(w[x], w[x], s);
  }
  return s;
}

__device__ __forceinline__ float dist_of(float qn, float acc, float pn) {
  // clamp at +0 (never -0), so the bits order like the values
  const float v = qn - 2.f * acc + pn;
  return v > 0.f ? v : 0.f;
}

// The first tile from g0 on (in the walk's order) with a valid point, or
// -1; the walk's dead() runs for each tile skipped.  One vote covers the
// WIN = NT / TPT tiles g0 .. g0 + WIN - 1: TPT threads a tile (4 for a
// tile of 64 points, 8 for 128), each testing 16 flags of the tile's
// range [start(g), end(g)), ballots per warp into vote[NT / 32], the
// first live tile read from shared memory.  All NT threads call it.
template <int NT, int TPT, typename Walk>
__device__ int skip_dead(unsigned* vote,
                         const unsigned char* __restrict__ valid,
                         const Walk& w, int g0) {
  static_assert(TPT == 4 || TPT == 8, "four or eight threads a tile");
  constexpr int WIN = NT / TPT, LOG = TPT == 8 ? 3 : 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  while (g0 >= 0) {
    const int g = w.step(g0, tid >> LOG);
    int live = 0;
    if (g >= 0) {
      const long long n = w.start(g) + (tid & (TPT - 1)) * 16, e = w.end(g);
      const unsigned char* f = valid + n;
      if (n + 16 <= e && (reinterpret_cast<size_t>(f) & 15) == 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(f);
        live = (v.x | v.y | v.z | v.w) != 0;
      } else {
        for (int x = 0; x < 16 && n + x < e; ++x) live |= f[x] != 0;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) vote[warp] = bal;
    __syncthreads();
    int first = WIN;
    for (int v = 0; v < NT / 32; ++v) {
      const unsigned b = vote[v];
      if (b != 0) {
        first = v * (32 / TPT) + ((__ffs(b) - 1) >> LOG);
        break;
      }
    }
    __syncthreads();
    for (int i = 0; i < first; ++i) {
      const int dg = w.step(g0, i);
      if (dg < 0) break;
      w.dead(dg);
    }
    g0 = w.step(g0, first);
    if (first < WIN) break;
  }
  return g0;
}

// Walk the tiles that w yields through the ring.  Walk:
//   int first(), next(int g)       tile ids in order, -1 at the end
//   int step(int g, int i)         the i-th tile after g, or -1
//   long long start(g), end(g)     point rows [start, end) of tile g's
//                                  range, flat in the (k*m, d) matrix
//   void dead(int g)               tile g has no valid point (all threads)
//   void epilogue(int g, acc, qn, pn)  all threads; may use barriers
// valid: flat (k*m) flags, or null.  The query tile must be loaded.
template <typename T, typename Walk>
__device__ void stream(const Shared& sm, const T* __restrict__ p, int d,
                       const unsigned char* __restrict__ valid, Walk& w) {
  constexpr int BK = Dims<T>::BK;
  const int tid = threadIdx.x;
  const Lane ln = lane_of(tid);
  const int nk = slabs(d, BK);
  const bool async = rows_aligned(p, d);
  int ptile = w.first(), pk = 0, issued = 0;

  auto produce = [&](int stage) {
    if (pk == 0 && valid != nullptr && ptile >= 0)
      ptile = skip_dead<NT, 4>(sm.vote, valid, w, ptile);
    if (ptile >= 0) {
      copy_slab<T>(sm.ring + stage * SLAB_BYTES, p, w.start(ptile),
                   w.end(ptile), pk * BK, d, async);
      if (tid == 0) sm.slab_tile[stage] = ptile;
      ++issued;
      if (++pk == nk) {
        pk = 0;
        ptile = w.next(ptile);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) produce(s);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float pn = 0.f;
  int ck = 0, buf = 0, pend = -1;
  for (int u = 0; u < issued; ++u) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int stage = u % STAGES;
    const int g = sm.slab_tile[stage];
    if (pend >= 0) {
      w.epilogue(pend, acc, sm.qn, sm.pn + (buf ^ 1) * TN);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      pend = -1;
    }
    produce((u + STAGES - 1) % STAGES);
    const char* slab = sm.ring + stage * SLAB_BYTES;
    compute_slab<T>(slab, sm, ck * BK, ln, acc);
    if (tid < TN) pn += norm_slab<T>(slab, ln.norm_p);
    if (++ck == nk) {
      if (tid < TN) sm.pn[buf * TN + ln.norm_p] = pn;
      pn = 0.f;
      ck = 0;
      pend = g;
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pend >= 0) w.epilogue(pend, acc, sm.qn, sm.pn + (buf ^ 1) * TN);
}

}  // namespace tile
}  // namespace knn
