// Device code shared by the port's aggregate kernels (fused_agg.cu,
// group_agg.cu, chunk_agg.cu): fixed-order block sums, the chunk sort and
// the run walk of the group step.  Every sum has one fixed order — a fixed
// shuffle tree within a block, and in the group step exactly one writer
// per (group, column) per chunk — so two runs on the same inputs give
// bitwise-equal outputs.  Products and sums use __fmul_rn/__fadd_rn so that
// no multiply-add is contracted into an FMA: the plain PyTorch versions
// round the product before the add.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pfola {

constexpr int kScalarThreads = 256;
constexpr int kFoldThreads = 128;
constexpr int kGroupThreads = 1024;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

// Fixed-order block sum: a shuffle tree inside each warp, then warp 0 folds
// the warp totals with the same tree.  The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // the previous call's readers are done with smem
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  x = (threadIdx.x < (blockDim.x >> 5)) ? smem[threadIdx.x] : 0.f;
  if (warp == 0) x = warp_sum(x);
  return x;
}

// Ascending bitonic sort of n (a power of two) keys in shared memory.
__device__ __forceinline__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long x = keys[i], y = keys[ixj];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The group step of one block: it owns column a of partition p's tables
// (a == A is the matched column) and walks the C chunks of L rows in order.
// The tables start from in_* (zero where in_* is null).  Per chunk it sorts
// the keys (gid << 32 | row) in shared memory — a stable sort by gid — and
// one thread per run of equal gids sums that run's rows in row order from
// zero and adds the total to the table once, as the reference adds each
// chunk's segment sums to its state: rows added straight onto a large total
// would round at its ulp.  Ids outside [0, G) drop out.  The tables stay in
// global memory (2**13 buckets x 4 aggregates x 2 + matched is 288 KiB,
// more than a block's 227 KB of shared memory), where each element has
// exactly one writer.  keys holds Lp (L rounded up to a power of two)
// entries; layouts: vals [P, C, L, A], w and gids [P, C, L], tables
// [P, G, A] and [P, G].
__device__ __forceinline__ void group_step(
    const float* __restrict__ vals, const float* __restrict__ w,
    const int* __restrict__ gids, const float* __restrict__ in_s,
    const float* __restrict__ in_q, const float* __restrict__ in_m,
    float* __restrict__ out_s, float* __restrict__ out_q,
    float* __restrict__ out_m, int p, int a, int C, int L, int Lp, int A,
    int G, unsigned long long* keys) {
  const bool matched = (a == A);
  const long long row0 = (long long)p * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (matched) {
      out_m[row0 + g] = in_m ? in_m[row0 + g] : 0.f;
    } else {
      const long long o = (row0 + g) * A + a;
      out_s[o] = in_s ? in_s[o] : 0.f;
      out_q[o] = in_q ? in_q[o] : 0.f;
    }
  }
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    const long long base = ((long long)p * C + c) * L;
    for (int i = threadIdx.x; i < Lp; i += blockDim.x) {
      unsigned long long key = kNoKey;
      if (i < L) {
        const int g = gids[base + i];
        if (g >= 0 && g < G)
          key = ((unsigned long long)(unsigned)g << 32) | (unsigned)i;
      }
      keys[i] = key;
    }
    __syncthreads();
    bitonic_sort(keys, Lp);
    for (int i = threadIdx.x; i < Lp; i += blockDim.x) {
      const unsigned long long key = keys[i];
      if (key == kNoKey) continue;
      const unsigned g = (unsigned)(key >> 32);
      if (i > 0 && (unsigned)(keys[i - 1] >> 32) == g) continue;  // not a run start
      if (matched) {
        float acc = 0.f;
        for (int j = i; j < Lp && (unsigned)(keys[j] >> 32) == g; ++j)
          acc = __fadd_rn(acc, w[base + (unsigned)keys[j]]);
        out_m[row0 + g] = __fadd_rn(out_m[row0 + g], acc);
      } else {
        const long long o = (row0 + g) * A + a;
        float s = 0.f, q = 0.f;
        for (int j = i; j < Lp && (unsigned)(keys[j] >> 32) == g; ++j) {
          const long long r = base + (unsigned)keys[j];
          const float v = vals[r * A + a];
          const float vw = __fmul_rn(v, w[r]);
          s = __fadd_rn(s, vw);
          q = __fadd_rn(q, __fmul_rn(v, vw));
        }
        out_s[o] = __fadd_rn(out_s[o], s);
        out_q[o] = __fadd_rn(out_q[o], q);
      }
    }
    __syncthreads();  // table writes visible, keys free for the next chunk
  }
}

inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace pfola

extern "C" const char* pf_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
