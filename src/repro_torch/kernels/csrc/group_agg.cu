// Hopper (sm_90a) CUDA version of the group-by Pallas kernel K3.
//
// Replaces group_agg_kernel (src/repro/kernels/group_agg.py:61, pallas_call
// at l.76), reached through ops.group_agg (src/repro/kernels/ops.py:113):
//
//   sums[G, A]   += onehot(gids)^T (v*w)      per block of block_rows rows,
//   sumsqs[G, A] += onehot(gids)^T (v*(v*w))  from zero, blocks in order
//   matched[G]   += onehot(gids)^T w
//
// The TPU turns the scatter into a one-hot matrix product on its matrix
// unit, with the tables resident in VMEM across the sequential grid.  Here
// the scatter stays a scatter: the group step of K1 (agg_common.cuh) from a
// zero start, with each block of rows taking the place of a chunk — per
// block a stable sort by gid, one thread per run of equal ids summing the
// run in row order from zero and adding it to the table once.  One writer
// per table element, no atomics: repeat runs are bitwise-equal, and a
// bundle member's rows (whole blocks of their own) leave the other members'
// table rows untouched, so each group member equals its solo launch bit for
// bit.  No G->128 / A->8 padding: that is the TPU matrix unit's shape.
//
// What bounds it on an H100: bytes — 4(A+2) bytes per row against about
// 5A+1 float operations.  The serial run walk keeps it far above that
// bound (a one-group table walks a whole block in one thread); speed is
// later work.
#include "agg_common.cuh"

namespace {

using namespace pfola;

__global__ void __launch_bounds__(kGroupThreads)
group_agg_kernel(const float* __restrict__ vals, const float* __restrict__ w,
                 const int* __restrict__ gids, float* __restrict__ sums,
                 float* __restrict__ sumsqs, float* __restrict__ matched,
                 int C, int L, int Lp, int A, int G) {
  extern __shared__ unsigned long long keys[];
  group_step(vals, w, gids, nullptr, nullptr, nullptr, sums, sumsqs, matched,
             blockIdx.x / (A + 1), blockIdx.x % (A + 1), C, L, Lp, A, G, keys);
}

}  // namespace

extern "C" {

// vals [P, N, A], w and gids [P, N] (N a multiple of L = block_rows) ->
// sums and sumsqs [P, G, A], matched [P, G], written from zero.
int pf_group_agg(const float* vals, const float* w, const int* gids,
                 float* sums, float* sumsqs, float* matched, int P, int N,
                 int L, int A, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Lp = pow2_at_least(L);
  const size_t smem = (size_t)Lp * sizeof(unsigned long long);
  group_agg_kernel<<<P * (A + 1), kGroupThreads, smem, s>>>(
      vals, w, gids, sums, sumsqs, matched, N / L, L, Lp, A, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
