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
// a scalar member of a bundle, is one run per block and takes the same
// path).  Phase 2 adds the blocks' compacted tables to the totals in
// block order, one warp per window of ids (32, or 32*s where G >= 8L), one
// writer per element.
// No atomics: repeat runs are bitwise-equal.  No G->128 / A->8 padding:
// that is the TPU matrix unit's shape.
//
// One entry point, pf_group_agg_bundle: the members of a bundle on the
// legacy path (scan.bundle_round_deltas) in one launch, each member at its
// own shape: its own vals, w, gids, A, G, scratch and outputs, as
// pf_bundle's group members in fused_agg.cu, so that each member's fold
// windows follow its own (A, G) (agg_common.cuh's step_span) and not a
// table of every member's groups.  All members share the same [P, N] rows
// and block length.  A member's arithmetic depends only on its own rows, A,
// G and L, so it equals a launch of that member alone bit for bit; a single
// group-by (ops.group_agg, scan.kernel_round_delta) is a one-member launch.
//
// What bounds it on an H100: bytes — 4(A+2) bytes per row against about
// 5A+1 float operations, plus a scratch table per block of rows (at most
// min(block_rows, G) entries) written once and read once.
#include "agg_common.cuh"

extern "C" {

// The members of a bundle over the same [P, N] rows (N a multiple of L =
// block_rows) in one launch; each member's sums and sumsqs [P, G, A] and
// matched [P, G] are written from zero.  table is a host array of M rows of
// kBundleCols int64: A, G, then the addresses vals [P, N, A], w [P, N], gids
// [P, N], sums, sumsqs, matched, scratch (P * min(Ct, N / L) tables of
// `words` floats, one per block of rows), then words (at least
// pfola::group_step_words(L, A, G), checked).  Both phases of the group
// step take every member in the same grids, in tiles of Ct blocks.
int pf_group_agg_bundle(const long long* table, int M, int P, int N, int L,
                        int Ct, void* stream) {
  constexpr int kBundleCols = 10;
  if (M < 1 || M > pfola::kMaxMembers || L < 1 || N % L)
    return (int)cudaErrorInvalidValue;
  pfola::GroupSet set = {};
  for (int i = 0; i < M; ++i) {
    const long long* r = table + (long long)i * kBundleCols;
    set.m[i] = {reinterpret_cast<const float*>(r[2]),
                reinterpret_cast<const float*>(r[3]),
                reinterpret_cast<const int*>(r[4]),
                nullptr,
                nullptr,
                nullptr,
                reinterpret_cast<float*>(r[5]),
                reinterpret_cast<float*>(r[6]),
                reinterpret_cast<float*>(r[7]),
                reinterpret_cast<float*>(r[8]),
                (int)r[0],
                (int)r[1],
                r[9]};
  }
  set.n = M;
  return pfola::run_group_step(set, P, N / L, L, Ct,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
