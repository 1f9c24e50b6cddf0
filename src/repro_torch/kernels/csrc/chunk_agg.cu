// Hopper (sm_90a) CUDA version of the whole-shard Pallas kernel K4.
//
// Replaces shard_agg_kernel (src/repro/kernels/chunk_agg.py:118,
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

}  // namespace

extern "C" {

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
