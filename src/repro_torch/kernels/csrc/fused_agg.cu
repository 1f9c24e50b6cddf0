// Hopper (sm_90a) CUDA versions of the fused-aggregate Pallas kernels.
//
// Replaces, in src/repro/kernels/fused_agg.py:
//   fused_round_step    (pallas_call at l.363)  -> pf_scalar (carry in,
//                        final out) and pf_group
//   fused_prefix_states (pallas_call at l.454)  -> pf_scalar (zero carry,
//                        every running value out)
//
// The Pallas kernels run the query's closures (predicate, values, group
// ids) inside their body.  Compiled CUDA cannot take a Python closure, so
// the wrapper (repro_torch/kernels/fused_agg.py) evaluates them with
// PyTorch on the device and hands over vals [P,C,L,A] f32, w = cond*_mask
// [P,C,L] f32 and gids [P,C,L] i32.  What stays here is what the Pallas
// body keeps in VMEM: the chunk-ordered, carry-in accumulation.
//
// What bounds it on an H100: bytes.  Per row the kernels read 4(A+1) bytes
// (plus 4 for gids) and do about 5A+1 float operations; at 3.35 TB/s
// against 67 TFLOP/s (f32, no tensor cores) that is memory-bound by two
// orders of magnitude.
//
// Determinism: no atomics.  Every sum has one fixed order — a fixed
// shuffle tree within a chunk, a sequential fold across chunks, and in the
// group kernel exactly one writer per (group, column) per chunk — so two
// runs on the same inputs give bitwise-equal outputs.  Products and sums
// use __fmul_rn/__fadd_rn so that no multiply-add is contracted into an
// FMA: the plain PyTorch version rounds the product before the add.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__device__ float block_sum(float x, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // the previous call's readers are done with smem
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  x = (threadIdx.x < (blockDim.x >> 5)) ? smem[threadIdx.x] : 0.f;
  if (warp == 0) x = warp_sum(x);
  return x;
}

// Pass 1 (scalar): one block per (partition, chunk) reduces its L rows to
// part[p, c, :] = (sum v*w [A] | sum (v*v)*w [A] | sum w).
__global__ void __launch_bounds__(kScalarThreads)
scalar_partials_kernel(const float* __restrict__ vals,
                       const float* __restrict__ w, float* __restrict__ part,
                       int L, int A) {
  __shared__ float smem[32];
  const long long pc = blockIdx.x;
  const float* wr = w + pc * L;
  const float* vr = vals + pc * L * A;
  float* out = part + pc * (2 * A + 1);
  for (int a = 0; a < A; ++a) {
    float s = 0.f, q = 0.f;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      const float v = vr[(long long)l * A + a];
      const float ww = wr[l];
      s = __fadd_rn(s, __fmul_rn(v, ww));
      q = __fadd_rn(q, __fmul_rn(__fmul_rn(v, v), ww));
    }
    s = block_sum(s, smem);
    if (threadIdx.x == 0) out[a] = s;
    q = block_sum(q, smem);
    if (threadIdx.x == 0) out[A + a] = q;
  }
  float m = 0.f;
  for (int l = threadIdx.x; l < L; l += blockDim.x) m = __fadd_rn(m, wr[l]);
  m = block_sum(m, smem);
  if (threadIdx.x == 0) out[2 * A] = m;
}

// Pass 2 (scalar): one thread per (partition, column) folds the chunk
// totals in chunk order onto the carry (zero when carry is null), writing
// every running value to prefix when it is not null.
__global__ void scalar_fold_kernel(const float* __restrict__ part,
                                   const float* __restrict__ carry,
                                   float* __restrict__ out,
                                   float* __restrict__ prefix, int P, int C,
                                   int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * K) return;
  const int p = t / K, k = t % K;
  const long long base = (long long)p * C * K + k;
  float acc = carry ? carry[t] : 0.f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    acc = __fadd_rn(acc, part[base + (long long)c * K]);
    if (prefix) prefix[base + (long long)c * K] = acc;
  }
  out[t] = acc;
}

// Ascending bitonic sort of n (a power of two) keys in shared memory.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
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

// Group step: block (p, a) owns column a of partition p's carry (a == A is
// the matched column) and walks the C chunks in order.  Per chunk it sorts
// the keys (gid << 32 | row) — a stable sort by gid — and one thread per run
// of equal gids sums that run's rows in row order and adds the total onto
// the carry.  The
// carry (2**13 buckets x 4 aggregates x (sum, sumsq) + matched = 288 KiB for
// the large-domain Q1) exceeds a block's 227 KB of shared memory, so it
// stays in global memory, where each element has exactly one writer.
__global__ void __launch_bounds__(kGroupThreads)
group_step_kernel(const float* __restrict__ vals, const float* __restrict__ w,
                  const int* __restrict__ gids, const float* __restrict__ in_s,
                  const float* __restrict__ in_q,
                  const float* __restrict__ in_m, float* __restrict__ out_s,
                  float* __restrict__ out_q, float* __restrict__ out_m, int C,
                  int L, int Lp, int A, int G) {
  extern __shared__ unsigned long long keys[];
  const int p = blockIdx.x / (A + 1);
  const int a = blockIdx.x % (A + 1);
  const bool matched = (a == A);
  const long long row0 = (long long)p * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (matched) {
      out_m[row0 + g] = in_m[row0 + g];
    } else {
      const long long o = (row0 + g) * A + a;
      out_s[o] = in_s[o];
      out_q[o] = in_q[o];
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
      // The run sums from zero and is added to the carry once, as the
      // reference adds each chunk's segment sums to its state: rows added
      // straight onto a large carry would round at the carry's ulp.
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
    __syncthreads();  // carry writes visible, keys free for the next chunk
  }
}

}  // namespace

extern "C" {

// K1 scalar (carry non-null, prefix null) and K2 (carry null, prefix
// non-null).  part is [P, C, 2A+1] scratch, out [P, 2A+1].
int pf_scalar(const float* vals, const float* w, float* part,
              const float* carry, float* out, float* prefix, int P, int C,
              int L, int A, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (long long)P * C;
  if (blocks > 0) {
    scalar_partials_kernel<<<(unsigned)blocks, kScalarThreads, 0, s>>>(
        vals, w, part, L, A);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int K = 2 * A + 1;
  const int n = P * K;
  scalar_fold_kernel<<<(n + kFoldThreads - 1) / kFoldThreads, kFoldThreads,
                       0, s>>>(part, carry, out, prefix, P, C, K);
  return (int)cudaGetLastError();
}

// K1 group: carries in (in_*) and out (out_*), [P, G, A] and [P, G].
int pf_group(const float* vals, const float* w, const int* gids,
             const float* in_s, const float* in_q, const float* in_m,
             float* out_s, float* out_q, float* out_m, int P, int C, int L,
             int A, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int Lp = 1;
  while (Lp < L) Lp <<= 1;
  const size_t smem = (size_t)Lp * sizeof(unsigned long long);
  group_step_kernel<<<P * (A + 1), kGroupThreads, smem, s>>>(
      vals, w, gids, in_s, in_q, in_m, out_s, out_q, out_m, C, L, Lp, A, G);
  return (int)cudaGetLastError();
}

const char* pf_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
