// Hopper (sm_90a) CUDA versions of the fused-aggregate Pallas kernels.
//
// Replaces, in src/repro/kernels/fused_agg.py:
//   fused_round_step    (pallas_call at l.363)  -> pf_scalar (carry in,
//                        final out), pf_group, and pf_bundle (every member
//                        of a bundle in one call, as the Pallas kernel runs
//                        all members in one pallas_call)
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
// The group modes (pf_group, and the group members of pf_bundle) run the
// group step of agg_common.cuh, whose header states its design: per chunk
// one block sorts the rows by id once (a stable radix sort in shared
// memory) and reduces every run of equal ids with the whole block in a
// fixed shuffle order; a second grid then adds the chunks' compacted tables
// onto the carry in chunk order, one warp per 32 ids and column, one writer
// per element.  Within one run of one chunk the rows are summed in that
// fixed tree order; the chunk totals reach the carry once each, in chunk
// order.
//
// Determinism: no atomics (agg_common.cuh).  A bundle member runs its solo
// kernel's body with the solo block size and the solo (partition, chunk)
// mapping, so its result is bitwise-equal to its solo launch.
#include "agg_common.cuh"

namespace {

using namespace pfola;

// One (partition, chunk) pc of the scalar partials: part[pc, :] =
// (sum v*w [A] | sum (v*v)*w [A] | sum w) over the chunk's L rows.
__device__ __forceinline__ void scalar_partials(const float* __restrict__ vals,
                                                const float* __restrict__ w,
                                                float* __restrict__ part,
                                                long long pc, int L, int A,
                                                float* smem) {
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

// Column t = (p, k) of the scalar fold: the chunk totals in chunk order onto
// the carry (zero when carry is null), every running value to prefix when
// it is not null.
__device__ __forceinline__ void scalar_fold(const float* __restrict__ part,
                                            const float* __restrict__ carry,
                                            float* __restrict__ out,
                                            float* __restrict__ prefix, int t,
                                            int C, int K) {
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

// Pass 1 (scalar): one block per (partition, chunk).
__global__ void __launch_bounds__(kScalarThreads)
scalar_partials_kernel(const float* __restrict__ vals,
                       const float* __restrict__ w, float* __restrict__ part,
                       int L, int A) {
  __shared__ float smem[32];
  scalar_partials(vals, w, part, blockIdx.x, L, A, smem);
}

// Pass 2 (scalar): one thread per (partition, column).
__global__ void scalar_fold_kernel(const float* __restrict__ part,
                                   const float* __restrict__ carry,
                                   float* __restrict__ out,
                                   float* __restrict__ prefix, int P, int C,
                                   int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * K) return;
  scalar_fold(part, carry, out, prefix, t, C, K);
}

// -- bundles ----------------------------------------------------------------
// The member table travels as the kernels' parameter (__grid_constant__: it
// stays in the parameter bank on the device, indexed by blockIdx.y).

constexpr int kTableCols = 14;  // int64 slots per member in pf_bundle's table

struct ScalarMember {
  const float* vals;
  const float* w;
  const float* carry;
  float* out;
  float* part;
  int A;
};

struct Bundle {
  ScalarMember s[kMaxMembers];
  int ns;
};

__global__ void __launch_bounds__(kScalarThreads)
bundle_partials_kernel(const __grid_constant__ Bundle b, int L) {
  __shared__ float smem[32];
  const ScalarMember& m = b.s[blockIdx.y];
  scalar_partials(m.vals, m.w, m.part, blockIdx.x, L, m.A, smem);
}

__global__ void bundle_fold_kernel(const __grid_constant__ Bundle b, int P,
                                   int C) {
  const ScalarMember& m = b.s[blockIdx.y];
  const int K = 2 * m.A + 1;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * K) return;
  scalar_fold(m.part, m.carry, m.out, nullptr, t, C, K);
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

// K1 group: carries in (in_*) and out (out_*), [P, G, A] and [P, G];
// scratch holds P * min(Ct, C) chunk tables of `words` floats, words at
// least group_step_words(L, A, G) (agg_common.cuh, checked), and the step
// runs in tiles of Ct chunks.
int pf_group(const float* vals, const float* w, const int* gids,
             const float* in_s, const float* in_q, const float* in_m,
             float* out_s, float* out_q, float* out_m, float* scratch, int P,
             int C, int L, int A, int G, int Ct, int words, void* stream) {
  GroupSet set = {};
  set.m[0] = {vals, w, gids, in_s, in_q, in_m, out_s, out_q, out_m, scratch,
              A, G, words};
  set.n = 1;
  return run_group_step(set, P, C, L, Ct, static_cast<cudaStream_t>(stream));
}

// K1 bundle: M members over the same [P, C, L] round-slice.  table is a
// host array of M rows of kTableCols int64: kind (0 scalar, 1 group), A, G,
// then the addresses vals, w, gids, in_s (scalar: carry), in_q, in_m,
// out_s (scalar: out), out_q, out_m, part (scalar: [P, C, 2A+1] partials;
// group: the group step's scratch for tiles of Ct chunks, as pf_group's),
// words (group: the scratch's floats per chunk table, as pf_group's).
// One call launches the scalar members' partials, the group members' step
// (both phases per tile, every group member in the same grids) and the
// scalar members' fold, however many members.
int pf_bundle(const long long* table, int M, int P, int C, int L, int Ct,
              void* stream) {
  if (M < 1 || M > kMaxMembers) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Bundle b = {};
  GroupSet g = {};
  int A_scalar = 0;
  for (int i = 0; i < M; ++i) {
    const long long* r = table + (long long)i * kTableCols;
    const int A = (int)r[1];
    if (r[0] == 0) {
      ScalarMember& m = b.s[b.ns++];
      m = {reinterpret_cast<const float*>(r[3]),
           reinterpret_cast<const float*>(r[4]),
           reinterpret_cast<const float*>(r[6]),
           reinterpret_cast<float*>(r[9]), reinterpret_cast<float*>(r[12]), A};
      A_scalar = A > A_scalar ? A : A_scalar;
    } else {
      g.m[g.n++] = {reinterpret_cast<const float*>(r[3]),
                    reinterpret_cast<const float*>(r[4]),
                    reinterpret_cast<const int*>(r[5]),
                    reinterpret_cast<const float*>(r[6]),
                    reinterpret_cast<const float*>(r[7]),
                    reinterpret_cast<const float*>(r[8]),
                    reinterpret_cast<float*>(r[9]),
                    reinterpret_cast<float*>(r[10]),
                    reinterpret_cast<float*>(r[11]),
                    reinterpret_cast<float*>(r[12]), A, (int)r[2], r[13]};
    }
  }
  const long long blocks = (long long)P * C;
  if (b.ns > 0 && blocks > 0) {
    bundle_partials_kernel<<<dim3((unsigned)blocks, b.ns), kScalarThreads, 0,
                             s>>>(b, L);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (g.n > 0) {
    const int e = run_group_step(g, P, C, L, Ct, s);
    if (e != 0) return e;
  }
  if (b.ns > 0) {
    const int n = P * (2 * A_scalar + 1);
    bundle_fold_kernel<<<dim3((n + kFoldThreads - 1) / kFoldThreads, b.ns),
                         kFoldThreads, 0, s>>>(b, P, C);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
