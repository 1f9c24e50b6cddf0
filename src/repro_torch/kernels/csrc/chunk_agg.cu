// Hopper (sm_90a) CUDA versions of the chunk-aggregate Pallas kernels K4,
// K5 and K6 (src/repro/kernels/chunk_agg.py).
//
// K4 — replaces shard_agg_kernel (src/repro/kernels/chunk_agg.py:118,
// pallas_call at l.131), reached through ops.shard_chunk_partials
// (src/repro/kernels/ops.py:64): per chunk of L rows,
//
//   (sum v*wm, sum (v*v)*wm, sum m, sum wm),  wm = w*m,
//
// with vals, w (the bare predicate) and m (_mask) [P, C, L] f32 -> [P, C, 4].
// The TPU kernel keeps lane partials per chunk in VMEM across the chunk's
// row blocks and the wrapper sums the 128 lanes.  Here one block per
// (partition, chunk) reduces the chunk with a fixed shuffle tree
// (agg_common.cuh): no atomics, repeat runs bitwise-equal.  The prefix sum
// over chunks and a round's delta stay outside the kernel, as in the
// reference.
//
// What bounds it on an H100: bytes — 12 bytes read per row against 7 float
// operations.
//
// K5 — replaces chunk_agg_kernel (chunk_agg.py:78, pallas_call at l.85),
// reached through ops.chunk_agg (src/repro/kernels/ops.py:46): the same
// four sums over ONE flat chunk of N rows, [N] x 3 -> [4].
// K6 — replaces q6_agg_kernel (chunk_agg.py:162, pallas_call at l.170),
// reached through ops.q6_agg (ops.py:98): all of TPC-H Q6 from the raw
// columns, shipdate int32 converted to f32 in the kernel as chunk_agg.py:149
// does, predicate sd in [lo, hi) & dc in [dlo, dhi] & qt == q, value ep*dc,
// weight cond*m, then K5's sums.  Nothing of Q6 is written to device memory
// before it runs: 20 bytes read per row, 16 bytes written in all.
// The TPU kernels carry one VMEM accumulator tile across a sequential grid.
// Here pf_chunk_agg and pf_q6_agg launch two grids: a fixed number of
// blocks (set by N alone) each reduce a grid-stride share of the rows with
// the fixed shuffle tree, and one fold block adds the block totals in block
// order.  No float atomics: repeat runs are bitwise-equal.  What bounds
// them on an H100: bytes (12 and 20 per row against 7 and 12 operations).
#include "agg_common.cuh"

namespace {

using namespace pfola;

__global__ void __launch_bounds__(kScalarThreads)
shard_partials_kernel(const float* __restrict__ vals,
                      const float* __restrict__ w,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int L) {
  __shared__ float smem[32];
  const long long pc = blockIdx.x;
  const float* vr = vals + pc * L;
  const float* wr = w + pc * L;
  const float* mr = mask + pc * L;
  float s = 0.f, q = 0.f, n = 0.f, k = 0.f;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float v = vr[l], m = mr[l];
    const float wm = __fmul_rn(wr[l], m);
    s = __fadd_rn(s, __fmul_rn(v, wm));
    q = __fadd_rn(q, __fmul_rn(__fmul_rn(v, v), wm));
    n = __fadd_rn(n, m);
    k = __fadd_rn(k, wm);
  }
  s = block_sum(s, smem);
  q = block_sum(q, smem);
  n = block_sum(n, smem);
  k = block_sum(k, smem);
  if (threadIdx.x == 0) {
    float* o = out + pc * 4;
    o[0] = s;
    o[1] = q;
    o[2] = n;
    o[3] = k;
  }
}

// -- K5 / K6: flat rows ------------------------------------------------------

constexpr int kFlatThreads = 256;
constexpr int kFlatBlocks = 1024;  // block totals folded by pf_*_agg

struct Sums {
  float s = 0.f, q = 0.f, n = 0.f, k = 0.f;

  // one row: (v*wm, (v*v)*wm, m, wm) with wm = w*m, as the Pallas body
  __device__ __forceinline__ void add(float v, float w, float m) {
    const float wm = __fmul_rn(w, m);
    s = __fadd_rn(s, __fmul_rn(v, wm));
    q = __fadd_rn(q, __fmul_rn(__fmul_rn(v, v), wm));
    n = __fadd_rn(n, m);
    k = __fadd_rn(k, wm);
  }
};

struct Row {
  float v, w, m;
};

struct ChunkRows {
  const float* vals;
  const float* w;
  const float* m;
  __device__ __forceinline__ Row operator()(long long i) const {
    return {vals[i], w[i], m[i]};
  }
};

struct Q6Rows {
  const int* sd;
  const float* dc;
  const float* qt;
  const float* ep;
  const float* m;
  float lo, hi, dlo, dhi, qeq;
  __device__ __forceinline__ Row operator()(long long i) const {
    const float s = (float)sd[i], d = dc[i], q = qt[i], e = ep[i], mm = m[i];
    const float cond =
        (s >= lo && s < hi && d >= dlo && d <= dhi && q == qeq) ? 1.f : 0.f;
    return {__fmul_rn(e, d), __fmul_rn(cond, mm), mm};
  }
};

// Block b's totals of its grid-stride rows into part[4b .. 4b+3]; four
// independent rows in flight per thread and iteration.
template <typename Rows>
__device__ __forceinline__ void flat_partials(const Rows& rows, long long n,
                                              float* __restrict__ part) {
  __shared__ float smem[32];
  Sums acc;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const Row r0 = rows(i), r1 = rows(i + stride), r2 = rows(i + 2 * stride),
              r3 = rows(i + 3 * stride);
    acc.add(r0.v, r0.w, r0.m);
    acc.add(r1.v, r1.w, r1.m);
    acc.add(r2.v, r2.w, r2.m);
    acc.add(r3.v, r3.w, r3.m);
  }
  for (; i < n; i += stride) {
    const Row r = rows(i);
    acc.add(r.v, r.w, r.m);
  }
  const float s = block_sum(acc.s, smem);
  const float q = block_sum(acc.q, smem);
  const float c = block_sum(acc.n, smem);
  const float k = block_sum(acc.k, smem);
  if (threadIdx.x == 0) {
    float* o = part + 4 * (long long)blockIdx.x;
    o[0] = s;
    o[1] = q;
    o[2] = c;
    o[3] = k;
  }
}

__global__ void __launch_bounds__(kFlatThreads)
chunk_partials_kernel(ChunkRows rows, long long n, float* __restrict__ part) {
  flat_partials(rows, n, part);
}

__global__ void __launch_bounds__(kFlatThreads)
q6_partials_kernel(Q6Rows rows, const float* __restrict__ params, long long n,
                   float* __restrict__ part) {
  rows.lo = params[0];
  rows.hi = params[1];
  rows.dlo = params[2];
  rows.dhi = params[3];
  rows.qeq = params[4];
  flat_partials(rows, n, part);
}

// Thread j adds block totals part[4b + j] in block order.
__global__ void flat_fold_kernel(const float* __restrict__ part, int blocks,
                                 float* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= 4) return;
  float acc = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) acc = __fadd_rn(acc, part[4 * b + j]);
  out[j] = acc;
}

int flat_blocks(long long n) {
  long long b = (n + 4LL * kFlatThreads - 1) / (4LL * kFlatThreads);
  return (int)(b < 1 ? 1 : (b > kFlatBlocks ? kFlatBlocks : b));
}

}  // namespace

extern "C" {

// K5: vals, w (predicate, or any weight), m [n] f32 -> out [4] f32.  part
// is [4 * 1024] f32 scratch.
int pf_chunk_agg(const float* vals, const float* w, const float* m,
                 float* part, float* out, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = flat_blocks(n);
  chunk_partials_kernel<<<blocks, kFlatThreads, 0, s>>>(ChunkRows{vals, w, m},
                                                        n, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flat_fold_kernel<<<1, 32, 0, s>>>(part, blocks, out);
  return (int)cudaGetLastError();
}

// K6: params [>= 5] f32 on the device (date_lo, date_hi, disc_lo, disc_hi,
// qty_eq); shipdate [n] i32; discount, quantity, extendedprice, m [n] f32
// -> out [4] f32.  part as for K5.
int pf_q6_agg(const float* params, const int* sd, const float* dc,
              const float* qt, const float* ep, const float* m, float* part,
              float* out, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = flat_blocks(n);
  Q6Rows rows{sd, dc, qt, ep, m, 0.f, 0.f, 0.f, 0.f, 0.f};
  q6_partials_kernel<<<blocks, kFlatThreads, 0, s>>>(rows, params, n, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flat_fold_kernel<<<1, 32, 0, s>>>(part, blocks, out);
  return (int)cudaGetLastError();
}

int pf_shard_partials(const float* vals, const float* w, const float* mask,
                      float* out, int P, int C, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (long long)P * C;
  if (blocks == 0) return 0;
  shard_partials_kernel<<<(unsigned)blocks, kScalarThreads, 0, s>>>(
      vals, w, mask, out, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
