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
// The scalar mode (pf_scalar, and the scalar members of pf_bundle)
// ----------------------------------------------------------------
// For each partition p: per chunk c the totals (sum v*w [A] | sum (v*v)*w
// [A] | sum w), each from zero, then added onto the carry (zero for K2)
// once each, in chunk order, as the reference adds each block's
// contribution to its state (fused_agg.py:357-360); K2 writes every running
// value.  Two grids per call:
//
// Pass 1, the partials (scalar_partials_kernel): one block of
// kScalarThreads threads per (partition, chunk).  Thread t owns the
// contiguous rows [t*R, t*R + R) of the chunk, R = ceil(L / kScalarThreads)
// rounded up to a multiple of 4 (8 rows for L = 2048), and reads each row's
// w and vals[A] once: 16 bytes a load (one float4 of w and A float4s of
// vals per 4 rows) when the launch allows it (L a multiple of 4, vals and w
// 16-byte aligned; then every chunk and every thread's range starts on 16
// bytes), else 4 bytes a load.  It keeps all 2A+1 sums in registers for A
// <= kRegA (8); a wider A takes column groups of kRegA aggregates, each a
// pass over the rows with 4-byte loads.  The block then reduces them in ONE
// exchange: each sum through the warp's shuffle tree, the warp totals into
// a [warps][2A+1] table in shared memory, one barrier, and thread k adds
// column k's warp totals in a fixed pairwise tree.
//
//   Summation order within one chunk, fixed by L alone: each thread folds
//   its rows left to right; the thread sums meet in the shuffle tree of
//   warp_sum (agg_common.cuh: distances 16, 8, 4, 2, 1, lane 0 keeps the
//   total), and the 8 warp totals in the pairwise tree ((w0+w1)+(w2+w3)) +
//   ((w4+w5)+(w6+w7)).  A thread owns the same rows on both load paths, so
//   a misaligned view gives the bits of an aligned copy; which path runs is
//   chosen per launch, not by the data.  The plain version (kernels/ref.py)
//   sums a chunk in torch's order, so the card check holds the sums to
//   SUM_RTOL and the counter (a sum of 0/1 weights, exact in any order) bit
//   for bit.
//
// Pass 2, the fold (scalar_fold_kernel): one block per partition.  It
// stages the partition's [C, 2A+1] chunk totals through shared memory in
// tiles of Ct chunks (kFoldTile floats, Ct a multiple of 4), double-buffered
// with cp.async (16-byte copies where aligned): tile t+1 is in flight while
// thread k adds column k of tile t in chunk order onto its running value,
// which starts at the carry.  For K2 the running values go back into the
// tile and the block stores it coalesced.  The fold's one dependent chain
// per column (C adds) is the only serial part; it reads shared memory in
// batches of kFoldBatch chunks, so that one wait on shared memory serves 32
// dependent adds.  2A+1 is limited to kFoldTile / 4 (A <= 639) so that
// a tile holds 4 chunks.
//
// No atomics, on floats or integers.  Products are rounded before the add
// (__fmul_rn/__fadd_rn): nvcc contracts nothing into an FMA.  Two grids and
// not a chained single-pass scan: a chain would serialise the chunks'
// blocks.
//
// The group modes (pf_group, and the group members of pf_bundle) run the
// group step of agg_common.cuh, whose header states its design: per chunk
// one block sorts the rows by id once (a stable radix sort in shared
// memory) and reduces every run of equal ids with the whole block in a
// fixed shuffle order; a second grid then adds the chunks' compacted tables
// onto the carry in chunk order, one warp per window of ids (32, or 32*s
// where G >= 8L: agg_common.cuh), one writer per element.  Within one run
// of one chunk the rows are summed in that fixed tree order; the chunk
// totals reach the carry once each, in chunk order.
//
// Determinism: no atomics (agg_common.cuh).  A bundle member runs its solo
// kernel's bodies with the solo block size and the solo (partition, chunk)
// mapping, so its result is bitwise-equal to its solo launch.
#include "agg_common.cuh"

namespace {

using namespace pfola;

constexpr int kRegA = 8;  // aggregates whose sums one pass keeps in registers
constexpr int kWarps = kScalarThreads / 32;
constexpr int kRedCols = 2 * kRegA + 1;  // columns of the exchange table
constexpr int kFoldTile = 5120;  // floats of one fold tile; two are staged
constexpr int kFoldBlock = 256;
constexpr int kFoldBatch = 32;  // chunk totals a fold thread reads at once
constexpr int kMaxScalarK = kFoldTile / 4;  // 2A+1 limit: 4 chunks a tile

// Rows of a chunk that one pass-1 thread owns.
__host__ __device__ __forceinline__ int scalar_rows(int L) {
  const int r = (L + kScalarThreads - 1) / kScalarThreads;
  return (r + 3) & ~3;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether pass 1 reads with 16-byte loads: every chunk's rows and every
// thread's range then start on 16 bytes.  Chosen per launch.
bool scalar_vec(const float* vals, const float* w, int L) {
  return L % 4 == 0 && aligned16(vals) && aligned16(w);
}

// One row onto a thread's sums acc = (s[A] | q[A] | m).
template <int A>
__device__ __forceinline__ void fold_row(float (&acc)[2 * A + 1],
                                         const float* v, float wr) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
    acc[a] = __fadd_rn(acc[a], __fmul_rn(v[a], wr));
    acc[A + a] = __fadd_rn(acc[A + a], __fmul_rn(__fmul_rn(v[a], v[a]), wr));
  }
  acc[2 * A] = __fadd_rn(acc[2 * A], wr);
}

// The block's one exchange of K sums: the warp shuffle tree, the warp
// totals through red [kWarps][K] and one barrier, then thread k < K adds
// column k's warp totals in a fixed pairwise tree and returns the total
// (other threads return 0).
template <int K>
__device__ __forceinline__ float block_exchange(float (&acc)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x >= K) return 0.f;
  float x[kWarps];
#pragma unroll
  for (int i = 0; i < kWarps; ++i) x[i] = red[i * K + threadIdx.x];
#pragma unroll
  for (int h = 1; h < kWarps; h <<= 1) {
#pragma unroll
    for (int i = 0; i + h < kWarps; i += 2 * h) x[i] = __fadd_rn(x[i], x[i + h]);
  }
  return x[0];
}

// Pass 1 for A <= kRegA: chunk pc's 2A+1 totals into part[pc, :].
template <int A>
__device__ __forceinline__ void partials_reg(const float* __restrict__ vals,
                                             const float* __restrict__ w,
                                             float* __restrict__ part,
                                             long long pc, int L, bool vec,
                                             float* red) {
  constexpr int K = 2 * A + 1;
  const int R = scalar_rows(L);
  const int r0 = min((int)threadIdx.x * R, L), r1 = min(r0 + R, L);
  const float* wr = w + pc * L;
  const float* vr = vals + pc * L * A;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  if (vec) {
#pragma unroll 2
    for (int r = r0; r < r1; r += 4) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(wr + r));
      const float4* v4 = reinterpret_cast<const float4*>(vr + (long long)r * A);
      float v[4 * A];
#pragma unroll
      for (int j = 0; j < A; ++j) {
        const float4 x = __ldg(v4 + j);
        v[4 * j] = x.x;
        v[4 * j + 1] = x.y;
        v[4 * j + 2] = x.z;
        v[4 * j + 3] = x.w;
      }
      fold_row<A>(acc, v, w4.x);
      fold_row<A>(acc, v + A, w4.y);
      fold_row<A>(acc, v + 2 * A, w4.z);
      fold_row<A>(acc, v + 3 * A, w4.w);
    }
  } else {
    for (int r = r0; r < r1; ++r) {
      float v[A];
#pragma unroll
      for (int a = 0; a < A; ++a) v[a] = vr[(long long)r * A + a];
      fold_row<A>(acc, v, wr[r]);
    }
  }
  const float t = block_exchange<K>(acc, red);
  if (threadIdx.x < K) part[pc * K + threadIdx.x] = t;
}

// Pass 1 for A > kRegA: column groups of kRegA aggregates, one pass over
// the rows (4-byte loads) and one exchange each; sum w is written once.
__device__ __forceinline__ void partials_wide(const float* __restrict__ vals,
                                              const float* __restrict__ w,
                                              float* __restrict__ part,
                                              long long pc, int L, int A,
                                              float* red) {
  const int K = 2 * A + 1, R = scalar_rows(L);
  const int r0 = min((int)threadIdx.x * R, L), r1 = min(r0 + R, L);
  const float* wr = w + pc * L;
  const float* vr = vals + pc * L * A;
  for (int a0 = 0; a0 < A; a0 += kRegA) {
    const int na = min(kRegA, A - a0);
    float acc[kRedCols];
#pragma unroll
    for (int k = 0; k < kRedCols; ++k) acc[k] = 0.f;
    for (int r = r0; r < r1; ++r) {
      float v[kRegA];
#pragma unroll
      for (int j = 0; j < kRegA; ++j)
        v[j] = j < na ? vr[(long long)r * A + a0 + j] : 0.f;
      fold_row<kRegA>(acc, v, wr[r]);
    }
    if (a0 > 0) __syncthreads();  // the last group's readers are done with red
    const float t = block_exchange<kRedCols>(acc, red);
    const int k = threadIdx.x;
    if (k < na) part[pc * K + a0 + k] = t;
    else if (k >= kRegA && k < kRegA + na) part[pc * K + A + a0 + k - kRegA] = t;
    else if (k == 2 * kRegA && a0 == 0) part[pc * K + 2 * A] = t;
  }
}

// Pass 1 of chunk pc (partition-major), for any A: the bundle's body.
__device__ __forceinline__ void scalar_partials(const float* vals,
                                                const float* w, float* part,
                                                long long pc, int L, int A,
                                                bool vec, float* red) {
  switch (A) {
    case 1: partials_reg<1>(vals, w, part, pc, L, vec, red); break;
    case 2: partials_reg<2>(vals, w, part, pc, L, vec, red); break;
    case 3: partials_reg<3>(vals, w, part, pc, L, vec, red); break;
    case 4: partials_reg<4>(vals, w, part, pc, L, vec, red); break;
    case 5: partials_reg<5>(vals, w, part, pc, L, vec, red); break;
    case 6: partials_reg<6>(vals, w, part, pc, L, vec, red); break;
    case 7: partials_reg<7>(vals, w, part, pc, L, vec, red); break;
    case 8: partials_reg<8>(vals, w, part, pc, L, vec, red); break;
    default: partials_wide(vals, w, part, pc, L, A, red);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// n floats from g into shared s, as one cp.async group per thread (16-byte
// copies where vec: s and g both 16-byte aligned).
__device__ __forceinline__ void stage(float* s, const float* g, int n,
                                      bool vec) {
  int i0 = 0;
  if (vec) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(s + 4 * i)), "l"(g + 4 * i) : "memory");
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(s + i)), "l"(g + i) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pass 2 of partition p: part[p] is [C, K] chunk totals; column k starts at
// carry[p, k] (zero when carry is null), adds chunk c's total for c = 0 ..
// C-1, writes every running value to prefix[p] when prefix is non-null, and
// the last one to out[p, k].  tile holds 2 * kFoldTile floats, accs K.
__device__ __forceinline__ void scalar_fold(const float* __restrict__ part,
                                            const float* __restrict__ carry,
                                            float* __restrict__ out,
                                            float* __restrict__ prefix, int p,
                                            int C, int K, float* tile,
                                            float* accs) {
  const long long base = (long long)p * C * K;
  const float* g = part + base;
  float* pre = prefix ? prefix + base : nullptr;
  const bool vec = aligned16(g) && (!pre || aligned16(pre));
  const int Ct = (kFoldTile / K) & ~3;  // chunks a tile, a multiple of 4
  const int nt = (C + Ct - 1) / Ct;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    accs[k] = carry ? carry[(long long)p * K + k] : 0.f;
  if (nt > 0) stage(tile, g, min(Ct, C) * K, vec);
  for (int t = 0; t < nt; ++t) {
    float* buf = tile + (t & 1) * kFoldTile;
    const int c0 = t * Ct, ct = min(Ct, C - c0), n = ct * K;
    if (t + 1 < nt) {
      const int c1 = c0 + Ct;
      stage(tile + ((t + 1) & 1) * kFoldTile, g + (long long)c1 * K,
            min(Ct, C - c1) * K, vec);
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float acc = accs[k];
      int c = 0;
      for (; c + kFoldBatch <= ct; c += kFoldBatch) {
        float y[kFoldBatch];
#pragma unroll
        for (int j = 0; j < kFoldBatch; ++j) y[j] = buf[(c + j) * K + k];
#pragma unroll
        for (int j = 0; j < kFoldBatch; ++j) {
          acc = __fadd_rn(acc, y[j]);
          if (pre) buf[(c + j) * K + k] = acc;
        }
      }
      for (; c < ct; ++c) {
        acc = __fadd_rn(acc, buf[c * K + k]);
        if (pre) buf[c * K + k] = acc;
      }
      accs[k] = acc;
    }
    if (pre) {
      __syncthreads();  // every running value of the tile is in buf
      float* d = pre + (long long)c0 * K;
      int i0 = 0;
      if (vec) {
        const int n4 = n >> 2;
        for (int i = threadIdx.x; i < n4; i += blockDim.x)
          reinterpret_cast<float4*>(d)[i] = reinterpret_cast<const float4*>(buf)[i];
        i0 = n4 << 2;
      }
      for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) d[i] = buf[i];
    }
    __syncthreads();  // buf is read before tile t+2 is staged into it
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    out[(long long)p * K + k] = accs[k];
}

// Pass 1 (scalar): one block per (partition, chunk), instantiated per
// A <= kRegA (NA = A) so that each A gets its own registers; NA = 0 runs
// the column groups of a wider A.
template <int NA>
__global__ void __launch_bounds__(kScalarThreads)
scalar_partials_kernel(const float* __restrict__ vals,
                       const float* __restrict__ w, float* __restrict__ part,
                       int L, int A, int vec) {
  __shared__ float red[kWarps * kRedCols];
  if constexpr (NA == 0)
    partials_wide(vals, w, part, blockIdx.x, L, A, red);
  else
    partials_reg<NA>(vals, w, part, blockIdx.x, L, vec != 0, red);
}

using PartialsKernel = void (*)(const float*, const float*, float*, int, int,
                                int);
const PartialsKernel kPartials[kRegA + 1] = {
    scalar_partials_kernel<0>, scalar_partials_kernel<1>,
    scalar_partials_kernel<2>, scalar_partials_kernel<3>,
    scalar_partials_kernel<4>, scalar_partials_kernel<5>,
    scalar_partials_kernel<6>, scalar_partials_kernel<7>,
    scalar_partials_kernel<8>};

// Pass 2 (scalar): one block per partition.
__global__ void __launch_bounds__(kFoldBlock)
scalar_fold_kernel(const float* __restrict__ part,
                   const float* __restrict__ carry, float* __restrict__ out,
                   float* __restrict__ prefix, int C, int K) {
  __shared__ __align__(16) float tile[2 * kFoldTile];
  __shared__ float accs[kMaxScalarK];
  scalar_fold(part, carry, out, prefix, blockIdx.x, C, K, tile, accs);
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
  int vec;  // pass 1 reads with 16-byte loads (scalar_vec)
};

struct Bundle {
  ScalarMember s[kMaxMembers];
  int ns;
};

__global__ void __launch_bounds__(kScalarThreads)
bundle_partials_kernel(const __grid_constant__ Bundle b, int L) {
  __shared__ float red[kWarps * kRedCols];
  const ScalarMember& m = b.s[blockIdx.y];
  scalar_partials(m.vals, m.w, m.part, blockIdx.x, L, m.A, m.vec != 0, red);
}

__global__ void __launch_bounds__(kFoldBlock)
bundle_fold_kernel(const __grid_constant__ Bundle b, int C) {
  __shared__ __align__(16) float tile[2 * kFoldTile];
  __shared__ float accs[kMaxScalarK];
  const ScalarMember& m = b.s[blockIdx.y];
  scalar_fold(m.part, m.carry, m.out, nullptr, blockIdx.x, C, 2 * m.A + 1,
              tile, accs);
}

}  // namespace

extern "C" {

// K1 scalar (carry non-null, prefix null) and K2 (carry null, prefix
// non-null).  part is [P, C, 2A+1] scratch, out [P, 2A+1].
int pf_scalar(const float* vals, const float* w, float* part,
              const float* carry, float* out, float* prefix, int P, int C,
              int L, int A, void* stream) {
  const int K = 2 * A + 1;
  if (P < 1 || A < 1 || K > kMaxScalarK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (long long)P * C;
  if (blocks > 0) {
    kPartials[A <= kRegA ? A : 0]<<<(unsigned)blocks, kScalarThreads, 0, s>>>(
        vals, w, part, L, A, scalar_vec(vals, w, L));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scalar_fold_kernel<<<P, kFoldBlock, 0, s>>>(part, carry, out, prefix, C, K);
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
  for (int i = 0; i < M; ++i) {
    const long long* r = table + (long long)i * kTableCols;
    const int A = (int)r[1];
    if (r[0] == 0) {
      if (A < 1 || 2 * A + 1 > kMaxScalarK) return (int)cudaErrorInvalidValue;
      ScalarMember& m = b.s[b.ns++];
      m = {reinterpret_cast<const float*>(r[3]),
           reinterpret_cast<const float*>(r[4]),
           reinterpret_cast<const float*>(r[6]),
           reinterpret_cast<float*>(r[9]), reinterpret_cast<float*>(r[12]), A,
           0};
      m.vec = scalar_vec(m.vals, m.w, L);
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
  if (b.ns > 0 && P > 0)
    bundle_fold_kernel<<<dim3(P, b.ns), kFoldBlock, 0, s>>>(b, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
