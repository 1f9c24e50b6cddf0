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
// the scatter stays a scatter: the group step of K1 (agg_common.cuh, whose
// header states the design) from a zero start, with each block of rows
// taking the place of a chunk.  Phase 1 runs one thread block per block of
// rows: a stable radix sort by id in shared memory, then every run of equal
// ids reduced by the whole thread block in a fixed shuffle order (the
// within-run order is stated in agg_common.cuh; a one-group table, such as
// a scalar member of a bundle stack, is one run per block and takes the
// same path).  Phase 2 adds the blocks' compacted tables to the totals in
// block order, one warp per window of ids (32, or 32*s where G >= 8L), one
// writer per element.
// No atomics: repeat runs are bitwise-equal, and a bundle member's rows
// (whole blocks of their own, ids offset) sort and sum exactly as in its
// own launch, while the other members' blocks hold none of its ids, so
// each group member equals its solo launch bit for bit.  No G->128 / A->8
// padding: that is the TPU matrix unit's shape.
//
// What bounds it on an H100: bytes — 4(A+2) bytes per row against about
// 5A+1 float operations, plus a scratch table per block of rows (at most
// min(block_rows, G) entries) written once and read once.
#include "agg_common.cuh"

extern "C" {

// vals [P, N, A], w and gids [P, N] (N a multiple of L = block_rows) ->
// sums and sumsqs [P, G, A], matched [P, G], written from zero.  scratch
// holds P * min(Ct, N / L) tables of `words` floats, one per block of rows,
// words at least pfola::group_step_words(L, A, G) (checked); the step runs
// in tiles of Ct blocks.
int pf_group_agg(const float* vals, const float* w, const int* gids,
                 float* sums, float* sumsqs, float* matched, float* scratch,
                 int P, int N, int L, int A, int G, int Ct, int words,
                 void* stream) {
  if (L < 1 || N % L) return (int)cudaErrorInvalidValue;
  pfola::GroupSet set = {};
  set.m[0] = {vals,   w,      gids,    nullptr, nullptr, nullptr,
              sums,   sumsqs, matched, scratch, A,       G,
              words};
  set.n = 1;
  return pfola::run_group_step(set, P, N / L, L, Ct,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
