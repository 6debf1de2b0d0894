// Algorithm 1 on the device: the whole randomized selection loop of a batch
// in one launch, one block a row.
//
// Port of the loop of repro.core.selection (lax.while_loop there; the
// host-paced loop of repro_torch/core/selection.py on the CPU).  A row b's
// k*m composite keys (v, id) are v/ids[(j*B + b)*m + p] for shard j and slot
// p; flattened as x = j*m + p, thread t owns the keys x = s*T + t, s < per.
// The keys sit in shared memory at x where the row fits (conflict-free), else
// they are read where they lie, from L2 once the first pass has touched them.
// Each thread keeps a bit a key of its in-range set, {valid and lo < (v, id)
// < hi}, in words of shared memory that only it touches, so the set narrows
// and the keys outside it are never read again.  A shard's keys are one run
// of x, so they are one run of each thread's slots.
//
// Every thread holds the row's control state (lo, hi, the remaining rank,
// done, the threshold, the iteration) in registers, draws the same Philox
// numbers and applies the same update, so no state is broadcast.  With P
// pivots an iteration (P = 1, the paper's; P = k, num_pivots > 1: every
// shard's proposal) is three barriers:
//   1. each thread counts its in-range keys of each group (P = 1: all its
//      keys; P = k: shard p's); a block scan gives each its offset and every
//      thread the group's total n_p;
//   2. one draw r_p, uniform on [0, n_p): the thread holding the group's
//      r_p-th in-range key, in the order of the scan, writes it as pivot p;
//      an empty group proposes the (+inf, ID_HI) sentinel.  At P = 1 machine
//      j's keys are ranks of their own in that order, so the pivot is machine
//      j with probability n_j / n and then uniform in j's set: the paper's two
//      draws (Lemma 2.1) with the proposals that one pivot discards left
//      unmade; at P = k each shard's pivot is uniform in its set;
//   3. a block count of the in-range keys <= each pivot (getSize(lo, p]);
//      then each thread updates as core/selection.py's _select_body does:
//      among the pivots inside (lo, hi), one whose count equals the rank ends
//      the row with it as threshold (the smallest such); else the largest
//      below the rank becomes lo (the rank less its count) and the smallest
//      above it hi, and the in-range bits outside the new (lo, hi) clear.
// Ties break by id (core/counting.py).  The threshold is the rank-l key
// whatever the draws, so it equals the host loop's.

#include <cuda_fp16.h>
#include <curand_kernel.h>

#include "common.cuh"

namespace {

constexpr int kIdLo = -2147483647 - 1;   // pairs with -inf
constexpr int kIdHi = 2147483647;        // pairs with +inf
constexpr int kMaxThreads = 1024;
constexpr int kF16 = 2;                  // beside knn::kF32, knn::kBF16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* out, float x) { *out = x; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float x) {
  *out = __float2bfloat16(x);   // exact: x is a bf16 value or +-inf
}
__device__ __forceinline__ void store(__half* out, float x) {
  *out = __float2half(x);       // exact: x is an f16 value or +-inf
}

__device__ __forceinline__ bool key_le(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai <= bi);
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The first slot s of thread t (of nt) with s*nt + t >= x.
__device__ __forceinline__ int first_slot(int x, int t, int nt) {
  return x <= t ? 0 : (x - t + nt - 1) / nt;
}

// The bits [s0, s1) of word wd (slots wd*32 .. wd*32 + 31).
__device__ __forceinline__ unsigned slot_bits(int wd, int s0, int s1) {
  const int lo = min(max(s0 - wd * 32, 0), 32);
  const int hi = min(max(s1 - wd * 32, 0), 32);
  const unsigned below_hi = hi >= 32 ? 0xffffffffu : (1u << hi) - 1u;
  const unsigned below_lo = lo >= 32 ? 0xffffffffu : (1u << lo) - 1u;
  return below_hi & ~below_lo;
}

// A row's keys: in shared memory (kv, ki at x) or where they lie.
template <typename T, bool kSmemKeys>
struct RowKeys {
  const T* v;
  const int* ids;
  const float* kv;
  const int* ki;
  long long row;   // b*m: the offset of the row in shard 0
  long long shard_stride;   // B*m
  int m;

  __device__ __forceinline__ void get(int x, float& xv, int& xi) const {
    if constexpr (kSmemKeys) {
      xv = kv[x];
      xi = ki[x];
    } else {
      const int j = x / m;
      const long long g = j * shard_stride + row + (x - j * m);
      xv = to_f32(v[g]);
      xi = ids[g];
    }
  }
};

template <typename T, bool kSmemKeys>
__global__ void __launch_bounds__(kMaxThreads)
    select_loop_kernel(const T* __restrict__ v, const int* __restrict__ ids,
                       const unsigned char* __restrict__ valid,
                       const int* __restrict__ ls, int l_all,
                       const long long* __restrict__ seed, int B, int k,
                       int m, int per, int P, int max_it,
                       T* __restrict__ thr_v, int* __restrict__ thr_i,
                       unsigned char* __restrict__ converged,
                       int* __restrict__ iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5, nw = nt >> 5;
  const int n = k * m;
  const int words = (per + 31) / 32;
  // the layout of kernels/plan.py's select: keys, in-range words, the
  // scan's and the count's warp parts, the pivots
  unsigned char* at = smem;
  float* kv = reinterpret_cast<float*>(at);
  int* ki = reinterpret_cast<int*>(kv + (kSmemKeys ? per * nt : 0));
  at = reinterpret_cast<unsigned char*>(ki + (kSmemKeys ? per * nt : 0));
  unsigned* mw = reinterpret_cast<unsigned*>(at);
  int* scan_part = reinterpret_cast<int*>(mw + words * nt);
  int* cnt_part = scan_part + P * nw;
  float* piv_v = reinterpret_cast<float*>(cnt_part + P * nw);
  int* piv_i = reinterpret_cast<int*>(piv_v + P);

  const RowKeys<T, kSmemKeys> keys{v, ids, kv, ki,
                                   static_cast<long long>(b) * m,
                                   static_cast<long long>(B) * m, m};
  const float inf = CUDART_INF_F;

  // the row's keys, its valid count and the initial in-range bits
  int nvalid = 0;
  for (int wd = 0; wd < words; ++wd) {
    unsigned word = 0;
    for (int s = wd * 32; s < min(per, wd * 32 + 32); ++s) {
      const int x = s * nt + t;
      if (x >= n) break;
      const int j = x / m;
      const long long g =
          (static_cast<long long>(j) * B + b) * m + (x - j * m);
      const float xv = to_f32(v[g]);
      const int xi = ids[g];
      if constexpr (kSmemKeys) {
        kv[x] = xv;
        ki[x] = xi;
      }
      const bool ok = valid == nullptr || valid[g] != 0;
      nvalid += ok;
      if (ok && knn::key_lt(-inf, kIdLo, xv, xi) &&
          knn::key_lt(xv, xi, inf, kIdHi))
        word |= 1u << (s - wd * 32);
    }
    mw[wd * nt + t] = word;
  }
  nvalid = warp_sum(nvalid);
  if (lane == 0) cnt_part[w] = nvalid;
  __syncthreads();
  int total = 0;
  for (int q = 0; q < nw; ++q) total += cnt_part[q];

  int l = ls == nullptr ? l_all : ls[b];
  l = min(l, total);
  const bool allsel = l >= total;
  bool done = l <= 0 || allsel;
  float tv = allsel ? inf : -inf;
  int ti = allsel ? kIdHi : kIdLo;
  float lo_v = -inf, hi_v = inf;
  int lo_i = kIdLo, hi_i = kIdHi, rank = l, it = 0;
  curandStatePhilox4_32_10_t rng;
  curand_init(static_cast<unsigned long long>(seed[0]), b, 0, &rng);

  // group p's slots of this thread: [s0, s1)
  auto group = [&](int p, int& s0, int& s1) {
    const int x0 = P == 1 ? 0 : p * m, x1 = P == 1 ? n : (p + 1) * m;
    s0 = first_slot(x0, t, nt);
    s1 = min(first_slot(x1, t, nt), per);
  };
  auto count = [&](int s0, int s1) {
    int c = 0;
    for (int wd = s0 / 32; wd < words && wd * 32 < s1; ++wd)
      c += __popc(mw[wd * nt + t] & slot_bits(wd, s0, s1));
    return c;
  };
  auto inclusive = [&](int c) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += y;
    }
    return c;
  };

  while (!done && it < max_it) {   // uniform: every thread holds the state
    ++it;
    // 1. each group's in-range counts, scanned over the block
    for (int p = 0; p < P; ++p) {
      int s0, s1;
      group(p, s0, s1);
      const int incl = inclusive(count(s0, s1));
      if (lane == 31) scan_part[p * nw + w] = incl;
    }
    __syncthreads();
    // 2. pivot p: group p's r_p-th in-range key, or the sentinel
    for (int p = 0; p < P; ++p) {
      int before = 0, live = 0;
      for (int q = 0; q < nw; ++q) {
        const int y = scan_part[p * nw + q];
        before += q < w ? y : 0;
        live += y;
      }
      const unsigned u = curand(&rng);
      if (live == 0) {
        if (t == 0) {
          piv_v[p] = inf;
          piv_i[p] = kIdHi;
        }
        continue;
      }
      const int r = static_cast<int>(
          (static_cast<unsigned long long>(u) * live) >> 32);
      int s0, s1;
      group(p, s0, s1);
      const int c = count(s0, s1);
      const int first = before + inclusive(c) - c;
      if (r >= first && r < first + c) {
        int q = r - first;
        for (int wd = s0 / 32; wd < words; ++wd) {
          unsigned bits = mw[wd * nt + t] & slot_bits(wd, s0, s1);
          const int pc = __popc(bits);
          if (q >= pc) {
            q -= pc;
            continue;
          }
          for (; q > 0; --q) bits &= bits - 1;
          keys.get((wd * 32 + __ffs(bits) - 1) * nt + t, piv_v[p], piv_i[p]);
          break;
        }
      }
    }
    __syncthreads();
    // 3. the in-range keys <= each pivot
    for (int p = 0; p < P; ++p) {
      const float pv = piv_v[p];
      const int pi = piv_i[p];
      int c = 0;
      for (int wd = 0; wd < words; ++wd)
        for (unsigned bits = mw[wd * nt + t]; bits; bits &= bits - 1) {
          float xv;
          int xi;
          keys.get((wd * 32 + __ffs(bits) - 1) * nt + t, xv, xi);
          c += key_le(xv, xi, pv, pi);
        }
      c = warp_sum(c);
      if (lane == 0) cnt_part[p * nw + w] = c;
    }
    __syncthreads();
    // the update, the same in every thread
    bool hit = false, has_lo = false, has_hi = false;
    float hit_v = inf, nlo_v = -inf, nhi_v = inf;
    int hit_i = kIdHi, nlo_i = kIdLo, nhi_i = kIdHi, nlo_cnt = 0;
    for (int p = 0; p < P; ++p) {
      const float pv = piv_v[p];
      const int pi = piv_i[p];
      if (!knn::key_lt(lo_v, lo_i, pv, pi) || !knn::key_lt(pv, pi, hi_v, hi_i))
        continue;
      int cnt = 0;
      for (int q = 0; q < nw; ++q) cnt += cnt_part[p * nw + q];
      if (cnt == rank) {
        if (!hit || knn::key_lt(pv, pi, hit_v, hit_i)) {
          hit_v = pv;
          hit_i = pi;
        }
        hit = true;
      } else if (cnt < rank) {
        if (!has_lo || knn::key_lt(nlo_v, nlo_i, pv, pi)) {
          nlo_v = pv;
          nlo_i = pi;
          nlo_cnt = cnt;
        }
        has_lo = true;
      } else {
        if (!has_hi || knn::key_lt(pv, pi, nhi_v, nhi_i)) {
          nhi_v = pv;
          nhi_i = pi;
        }
        has_hi = true;
      }
    }
    if (hit) {
      done = true;
      tv = hit_v;
      ti = hit_i;
      break;
    }
    if (has_lo) {
      lo_v = nlo_v;
      lo_i = nlo_i;
      rank -= nlo_cnt;
    }
    if (has_hi) {
      hi_v = nhi_v;
      hi_i = nhi_i;
    }
    if (has_lo || has_hi) {
      for (int wd = 0; wd < words; ++wd) {
        unsigned word = mw[wd * nt + t];
        for (unsigned bits = word; bits; bits &= bits - 1) {
          const int bit = __ffs(bits) - 1;
          float xv;
          int xi;
          keys.get((wd * 32 + bit) * nt + t, xv, xi);
          if (!knn::key_lt(lo_v, lo_i, xv, xi) ||
              !knn::key_lt(xv, xi, hi_v, hi_i))
            word &= ~(1u << bit);
        }
        mw[wd * nt + t] = word;
      }
    }
  }
  if (t == 0) {
    store(thr_v + b, tv);
    thr_i[b] = ti;
    converged[b] = done;
    iters[b] = it;
  }
}

template <typename T, bool kSmemKeys>
int launch(const void* v, const int* ids, const unsigned char* valid,
           const int* ls, int l_all, const long long* seed, void* thr_v,
           int* thr_i, unsigned char* converged, int* iters, int B, int k,
           int m, int max_it, int threads, int per, int P, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      select_loop_kernel<T, kSmemKeys>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  select_loop_kernel<T, kSmemKeys><<<B, threads, smem, stream>>>(
      static_cast<const T*>(v), ids, valid, ls, l_all, seed, B, k, m, per, P,
      max_it, static_cast<T*>(thr_v), thr_i, converged, iters);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* v, const int* ids, const unsigned char* valid,
             const int* ls, int l_all, const long long* seed, void* thr_v,
             int* thr_i, unsigned char* converged, int* iters, int B, int k,
             int m, int max_it, int threads, int per, int P, int smem_keys,
             cudaStream_t stream) {
  const int words = (per + 31) / 32;
  const long long smem = (smem_keys ? 8LL * threads * per : 0) +
                         4LL * words * threads + 8LL * P * (threads / 32) +
                         8LL * P;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      per < 0 || P < 1 || (P != 1 && P != k) ||
      static_cast<long long>(threads) * per < static_cast<long long>(k) * m ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem_keys)
    return launch<T, true>(v, ids, valid, ls, l_all, seed, thr_v, thr_i,
                           converged, iters, B, k, m, max_it, threads, per,
                           P, (int)smem, stream);
  return launch<T, false>(v, ids, valid, ls, l_all, seed, thr_v, thr_i,
                          converged, iters, B, k, m, max_it, threads, per, P,
                          (int)smem, stream);
}

}  // namespace

// v (k, B, m) f32, bf16 or f16, ids (k, B, m) int32, valid (k, B, m) bytes
// or null, ls (B,) int32 or null (then every row asks for l_all), seed one
// int64 on the device; out: thr_v (B,) of v's dtype, thr_i, converged (B,)
// bytes, iters (B,) int32.  Grid B; threads a block, per keys a thread, P
// pivots (1 or k) and the keys in shared memory or not (smem_keys) as
// kernels/plan.py's select plan gives them.
extern "C" int knn_select_loop(const void* v, const int* ids,
                               const unsigned char* valid, const int* ls,
                               int l_all, const long long* seed, void* thr_v,
                               int* thr_i, unsigned char* converged,
                               int* iters, int B, int k, int m, int max_it,
                               int threads, int per, int P, int smem_keys,
                               int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == knn::kF32)
    return dispatch<float>(v, ids, valid, ls, l_all, seed, thr_v, thr_i,
                           converged, iters, B, k, m, max_it, threads, per,
                           P, smem_keys, s);
  if (dtype == knn::kBF16)
    return dispatch<__nv_bfloat16>(v, ids, valid, ls, l_all, seed, thr_v,
                                   thr_i, converged, iters, B, k, m, max_it,
                                   threads, per, P, smem_keys, s);
  if (dtype == kF16)
    return dispatch<__half>(v, ids, valid, ls, l_all, seed, thr_v, thr_i,
                            converged, iters, B, k, m, max_it, threads, per,
                            P, smem_keys, s);
  return (int)cudaErrorInvalidValue;
}
