// Squared-L2 distance matrix for all k shards in one launch.
//
// Replaces: src/repro/kernels/l2_distance.py::l2_distance (Pallas _kernel).
//
// Computes out[s, b, j] = max(|q_b|^2 - 2 q_b.p_sj + |p_sj|^2, 0) for the
// (B, d) queries against the (k, m, d) points, which are contiguous, so
// the point axis is one (k*m, d) matrix and each element is written to its
// shard's (B, m) slab.  With a (k, m) valid mask, masked points come out
// as +inf (the reference's unfused masked path, done in the kernel).
//
// What bounds it on an H100: it reads 4*k*m*d bytes of points, writes a
// 4*B*k*m-byte output and does 2*B*k*m*d FLOP, B/2 FLOP per byte of
// points.  At the small buckets (B <= 32, d = 64) that is far below the
// f32 SIMT ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte) once the
// output is counted: bound by the bytes, mostly the output.  At the
// service's large buckets (B = 128, d = 1,024: 64 FLOP per byte of
// points) it is bound by the f32 FMAs.
//
// Two main loops; kernels/plan.py says which a bucket takes:
// - the shared distance main loop of distance_tile.cuh (queries
//   resident in shared memory, a 4-slab cp.async ring of point tiles,
//   4 x 4 register tiles, |p|^2 once per point, dead tiles skipped by a
//   block vote) under a persistent grid: a multiple of the SM count of
//   blocks per query tile, block x walking point tiles x, x + gridDim.x,
//   ...  Its 32 x d query tile grows with d (131.6 KB at d = 1,024, one
//   4-warp block an SM), and each query tile's blocks sweep all the points.
// - l2_distance_wide.cuh, one block's tile spanning the bucket (64
//   or 128 rows) with queries and points streamed along d through one
//   ring: shared memory that does not grow with d, 8 x 8 register tiles
//   with up to 255 registers a thread, each point byte read from device
//   memory once a launch.
// Both write bit-equal distances.  A dead tile writes +inf without reading
// its points.  The epilogues find a thread's shard and offset once per
// tile (one 32-bit division where k*m < 2^31) and store 16-byte vectors
// with streaming stores wherever its 4 points share a shard and
// m % 4 == 0.  f32 FMAs only.
#include "distance_tile.cuh"
#include "l2_distance_wide.cuh"

namespace {

using namespace knn::tile;

struct L2Walk {
  const unsigned char* valid;
  float* out;
  int B, m, b0, ntiles;
  long long N;
  Lane ln;

  __device__ int first() const {
    return (int)blockIdx.x < ntiles ? (int)blockIdx.x : -1;
  }
  __device__ int next(int g) const {
    const long long n = (long long)g + gridDim.x;
    return n < ntiles ? (int)n : -1;
  }
  __device__ int step(int g, int i) const {
    const long long n = (long long)g + (long long)i * gridDim.x;
    return n < ntiles ? (int)n : -1;
  }
  __device__ long long start(int g) const { return (long long)g * TN; }
  __device__ long long end(int) const { return N; }

  __device__ void store(int g, const float (&v)[4][4]) const {
    const long long n0 = start(g) + ln.p0;
    if (n0 >= N) return;
    long long s, j;
    if (N < (1LL << 31)) {
      const unsigned n = (unsigned)n0, mu = (unsigned)m;
      const unsigned su = n / mu;
      s = su;
      j = n - su * mu;
    } else {
      s = n0 / m;
      j = n0 - s * m;
    }
    const bool vec = (m & 3) == 0 && j + 3 < m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ln.r0 + 4 * i;
      if (b >= B) continue;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(out + (s * B + b) * m + j),
               make_float4(v[i][0], v[i][1], v[i][2], v[i][3]));
        continue;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (n0 + t >= N) break;
        long long jx = j + t, sx = s;
        while (jx >= m) {
          jx -= m;
          ++sx;
        }
        out[(sx * B + b) * m + jx] = v[i][t];
      }
    }
  }

  __device__ void dead(int g) const {
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) v[i][t] = CUDART_INF_F;
    store(g, v);
  }

  __device__ void epilogue(int g, const float (&acc)[4][4],
                           const float* qn, const float* pn) const {
    const long long n0 = start(g) + ln.p0;
    bool ok[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      ok[t] = n0 + t < N && (valid == nullptr || valid[n0 + t] != 0);
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = qn[ln.r0 + 4 * i];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[i][t] = ok[t] ? dist_of(a, acc[i][t], pn[ln.p0 + t])
                        : CUDART_INF_F;
    }
    store(g, v);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
l2_distance_kernel(const T* __restrict__ q, const T* __restrict__ p,
                   const unsigned char* __restrict__ valid,
                   float* __restrict__ out, int B, int k, int m, int d) {
  extern __shared__ __align__(128) char smem[];
  const Shared sm = carve<T>(smem, d);
  const int b0 = blockIdx.y * TB;
  load_queries<T>(sm, q, B, d, b0);
  const long long N = (long long)k * m;
  L2Walk w{valid, out, B, m, b0, (int)((N + TN - 1) / TN), N,
           lane_of(threadIdx.x)};
  stream<T>(sm, p, d, valid, w);
}

template <typename T>
int launch(const T* q, const T* p, const unsigned char* valid, float* out,
           int B, int k, int m, int d, int blocks, cudaStream_t stream) {
  const size_t bytes = loop_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      l2_distance_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = ((long long)k * m + TN - 1) / TN;
  const long long bx = blocks < ntiles ? blocks : ntiles;
  dim3 grid((unsigned)bx, (unsigned)((B + TB - 1) / TB));
  l2_distance_kernel<T><<<grid, NT, bytes, stream>>>(q, p, valid, out, B, k,
                                                     m, d);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, d), p: (k, m, d), both f32 or both bf16; valid: (k, m) uint8 or
// null; out: (k, B, m) f32.  blocks: persistent blocks per query tile.
extern "C" int knn_l2_distance(const void* q, const void* p,
                               const unsigned char* valid, float* out, int B,
                               int k, int m, int d, int dtype, int blocks,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == knn::kBF16) {
    return launch(static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(p), valid, out, B, k, m,
                  d, blocks, s);
  }
  return launch(static_cast<const float*>(q), static_cast<const float*>(p),
                valid, out, B, k, m, d, blocks, s);
}

// The whole-bucket loop (l2_distance_wide.cuh) for B > 32: row_tile 64 or
// 128 query rows a block; blocks from the occupancy API.
extern "C" int knn_l2_distance_wide(const void* q, const void* p,
                                    const unsigned char* valid, float* out,
                                    int B, int k, int m, int d, int dtype,
                                    int row_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  const BF *qb = static_cast<const BF*>(q), *pb = static_cast<const BF*>(p);
  const float *qf = static_cast<const float*>(q),
              *pf = static_cast<const float*>(p);
  const bool bf = dtype == knn::kBF16;
  if (row_tile == 64)
    return bf ? knn::wide::launch<BF, 64>(qb, pb, valid, out, B, k, m, d, s)
              : knn::wide::launch<float, 64>(qf, pf, valid, out, B, k, m,
                                             d, s);
  if (row_tile == 128)
    return bf ? knn::wide::launch<BF, 128>(qb, pb, valid, out, B, k, m, d,
                                           s)
              : knn::wide::launch<float, 128>(qf, pf, valid, out, B, k, m,
                                              d, s);
  return (int)cudaErrorInvalidValue;
}
