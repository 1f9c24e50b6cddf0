// Device code shared by the port's aggregate kernels (fused_agg.cu,
// group_agg.cu, chunk_agg.cu): fixed-order block sums, and the group step.
// Every sum has one fixed order, so two runs on the same inputs give
// bitwise-equal outputs; no atomics are used, on floats or otherwise.
// Products and sums use __fmul_rn/__fadd_rn so that no multiply-add is
// contracted into an FMA: the plain PyTorch versions round the product
// before the add.
//
// The group step
// --------------
// Replaces the scatter of the Pallas kernels K1 (fused_round_step, group
// and bundle modes; src/repro/kernels/fused_agg.py, pallas_call at l.363)
// and K3 (group_agg_kernel, src/repro/kernels/group_agg.py:61, pallas_call
// at l.76).  Launched by pf_group and pf_bundle (fused_agg.cu) and by
// pf_group_agg_bundle (group_agg.cu), all through
// run_group_step below.  For one partition p of vals [P, C, L, A], w and
// gids [P, C, L] and the carries [P, G, A], [P, G, A], [P, G] (zero where
// in_* is null):
//
//   per chunk c and group g in [0, G): S = sum v*w, Q = sum v*(v*w),
//   M = sum w over the chunk's rows whose id is g, each from zero; ids
//   outside [0, G) drop out; each chunk's (S, Q, M) is added onto the
//   carry once, in chunk order, as the reference's fused_round_step adds
//   segment_sum results to its state (fused_agg.py:357-360).  K3 is the
//   same step from a zero carry, with block_rows rows as a chunk.
//
// Two phases, each a grid of its own, over tiles of chunks (below):
//
// Phase 1, chunk-parallel partials (group_partials_kernel): one block of
// kStepThreads threads per (member, partition, chunk).  It stages the
// chunk's ids (clamped: G for an id outside [0, G)), w and a tile of the
// value columns in shared memory with coalesced loads (16 bytes a thread
// where aligned), then sorts the row indices ONCE for all 2A+1 sums: a
// stable LSD radix sort with two bits per pass over the bit width of G
// (2 passes for 4 groups, 7 for 2^13 buckets, 1 for one group), each
// pass's ranks from a block-wide scan of four per-thread digit counters
// packed into 64 bits.  Valid rows end up first, grouped into runs of
// equal ids in row order.  Every run is then reduced by the whole block
// (seg_scan, kSegSums of the 2A+1 sums per pass): thread t owns KI
// consecutive sorted positions [t*KI, t*KI+KI) (KI = the power of two at
// least ceil(L / kStepThreads)).
//
//   Summation order within a run of one chunk, fixed by L alone: each
//   thread folds its positions of the run left to right; those thread
//   partials are combined by a segmented Hillis-Steele scan across the
//   lanes of a warp (shuffle distances 1, 2, 4, 8, 16, the earlier partial
//   always on the left); a run that spans warps gets the partial of the
//   warps before it (the same scan over the warp totals) added on the
//   left of its warp's partial.  This within-run order is the only
//   association the step chooses: each chunk total still reaches the
//   carry once, in chunk order, as in the reference.  The plain versions
//   (kernels/ref.py) sum a run with index_add_ in another order, so the
//   card check holds the sums to SUM_RTOL and the counters (sums of 0/1
//   weights, exact in any order) bit for bit.
//
// Each chunk writes a compacted table to the scratch: its runs' ids in
// ascending order, (S[A] | Q[A] | M) per run, and the offsets off[w] =
// number of runs with id < 32*s*w for the W + 1 windows of 32*s ids.  A
// table holds at most E = min(L, G) entries.
//
// Where the fold is wide (s > 1, below), phase 1 first drops every row that
// cannot change a sum: weight 0 and all A values finite (0*inf and 0*NaN
// are NaN, so such a row still reaches its sum), beside the ids outside
// [0, G).  One block-wide scan of the kept counts writes the kept rows'
// indices, in row order, to the front of the index buffer; the sort, the
// runs, the staged values, the reductions and the table then cover those
// n rows alone, and the sort stays stable, so runs keep their row order.
// A sort of n <= kRankSortRows rows counts each row's place against the
// other kept keys (key, then row order) in one step; a larger one takes
// the radix passes over the n positions: the same order either way.  With
// few runs, each window's offset is a binary search of the runs' ids, and
// where every run is one row the segmented scan is skipped (each position
// already holds its run's totals, as the scan would leave them).  At
// s > 1 a window of 32*s ids takes at most 8 of a chunk's rows on average,
// so runs are nearly all one or two rows, whose sums are the same bits
// whatever zeros are dropped around them; Q15 keeps about 3.6% of a chunk,
// Q10 about 1%, and their tables shrink with their rows.  At s = 1 a run
// holds many rows, and dropping zeros would change their association:
// there every row is sorted, as before.  The only sign this can change is
// that of a -0.0 carry element whose id has only dropped rows in a chunk:
// it stays -0.0 where adding the run's +0.0 made it +0.0.
//
// The window's width follows the member's shape alone (step_span): s is
// the largest power of two <= G / 4L (1 where G < 8L), so that a window of
// 32*s ids takes at most 8 of a chunk's L rows on average, capped so that
// the window's carry, 32*s ids of 2A+1 floats, fits kFoldSpanFloats (12 KB:
// two blocks of 8 warps fit an SM's shared memory).  A chunk then writes
// W + 1 = ceil(G / 32s) + 1 offsets, not G / 32 + 1, and phase 2 visits
// (partition, window, chunk) triples in proportion to the entries, not to
// G: Q15's 1,000,000 suppliers (A = 1, L = 2048) take s = 32, 977 windows
// of 1,024 ids (the cap binds: about 2 entries a window and chunk); its
// 100,000 at SF 10 s = 8, 391 windows of 256 ids.  Shapes whose 32-id
// windows already hold several of a chunk's entries keep s = 1: Q1's 4
// groups, one-group members, and 2^13 buckets (about 7 a window), where
// wider windows measured slower (PERF.md §6).  Q10's 15,000,000
// customers take s = 32 (the cap binds), 14,649 windows of 1,024 ids.
//
// Phase 2, the ordered fold (group_fold_kernel), one warp per window,
// partition and group of columns, walking the tile's chunks in order.  An
// id absent from a chunk is skipped; one writer per element; no atomics.
//
//   s = 1 (group_fold): lane j owns carry elements (p, 32*w + j, k) of its
//   columns in registers and takes chunk c's entries of its window (off[w]
//   to off[w+1], at most 32 distinct ids) with one coalesced load per
//   column and a shuffle that hands each lane its id's value.  A warp loads
//   the entries of U chunks at once, and the offsets of the next U while it
//   adds them.  With many (partition, window, column) triples a warp takes
//   9 columns and U = 8, so that the ids and offsets are read once for all
//   of them and every warp stays resident; with few (a handful of groups) a
//   warp takes 1 column and U = 32, so that the few warps keep more loads
//   in flight.
//
//   s > 1 (group_fold_span): a warp holds its window's 32*s carry elements
//   of kSpanCols columns in shared memory, read from in_* (or zero) at the
//   start and written to out_* at the end.  Lane j reads the offsets of
//   chunk c0 + j, 32 chunks at once (the next 32 a batch ahead), and a warp
//   scan lays the 32 chunks' entries end to end in chunk order; the lanes
//   take 32 consecutive entries a round, and each adds its entry to its own
//   element with __fadd_rn.  A chunk's ids are distinct, so lanes that share
//   an id hold entries of different chunks, in lane order: they add one
//   after another (__match_any_sync ranks them), with a __syncwarp between
//   steps and between rounds.
//
// Members of one launch with different s share the fold grid, each taking
// its own path (blockIdx.y is the member).  Neither path changes the order
// of any sum: each carry element is the carry plus its chunk totals in
// chunk order, so the outputs are the same bits at every s, U and tile.
//
// Scratch and tiles: the wrapper allocates the scratch with torch.empty
// (a table of `words` floats per chunk and member, words passed with the
// scratch and checked against group_step_words) for at most Ct chunks of
// every partition, Ct chosen so that the scratch does not exceed the
// round-slice's own input bytes; run_group_step runs both phases once per
// tile of Ct chunks, each tile's fold starting from the previous tile's
// output.  Tiling changes no arithmetic.
//
// Bundles: the group members of a K1 bundle (pf_bundle) or of a K3 bundle
// (pf_group_agg_bundle) are the grid's y index of both phases (the member
// table is a __grid_constant__ parameter), each with its own rows, A, G,
// window width and scratch.  A member's arithmetic depends only on its own
// rows, A, G and L, so it equals its solo launch bit for bit.
//
// What bounds it on an H100: bytes.  Per row phase 1 reads 4(A+2) bytes
// and does about 5A+1 float operations, and writes a table of at most the
// input's size (168 bytes per chunk of 2048 rows for 4 groups and 4
// aggregates, 82,948 for 2^13 buckets against 49,152 bytes of input: those
// take two tiles; 36,680 for Q15 against 24,576, beside Q1's 49,152 in the
// report bundle: one tile; of Q15's table the kept rows fill about 5 KB,
// 978 offsets and about 82 entries).  The fold reads the entries' bytes
// (the ids once a group of columns), two offsets a chunk and window, and
// the carry once and writes it once a tile: at s > 1 its work follows a chunk's
// entries, not G / 32.
//
// Choices made for simplicity, each measured in PERF.md: one block per
// chunk rather than a persistent grid that prefetches its next chunk with
// cp.async or TMA (a chunk's loads overlap the other resident blocks'
// work instead); one compacted table layout for every G, also where G <= L
// would allow a dense one (absent ids are skipped, not added as zeros);
// the window offsets that phase 1 writes take the place of a binary
// search in phase 2; the width rule reads only L, A and G, not the
// partitions or the card, so a member's fold is the same at every P.
//
// Tensor cores are not used: the TPU's one-hot matrix-unit variant
// (use_mxu) is called only statistically interchangeable by the
// reference itself, and wgmma takes float32 only as TF32, which keeps
// about 3 decimal digits and would fail SUM_RTOL = 1e-5.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pfola {

constexpr int kScalarThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(kFull, x, o));
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

// -- the group step ----------------------------------------------------------

constexpr int kStepThreads = 512;   // phase 1 block
constexpr int kMaxStepRows = 4096;  // L limit (_runtime.MAX_GROUP_ROWS)
constexpr int kStepValFloats = 16384;  // 64 KB of staged value columns
constexpr int kSegSums = 5;         // sums per segmented-scan pass
constexpr int kFoldWarps = 8;       // phase 2 block: 8 warps
constexpr int kFoldWide = 4096;     // (p, window, column) triples past which
                                    // one phase 2 warp takes 9 columns
constexpr int kMaxMembers = 16;     // group members in one launch
constexpr int kFoldSpanFloats = 3072;  // carry floats of a phase 2 warp at
                                       // s > 1: 12 KB, two 8-warp blocks an SM
constexpr int kSpanCols = 3;        // s > 1: columns of the 2A+1 a warp takes
// s > 1: kept rows up to which a chunk sorts by counting each row's place
// against the others, one row a thread, rather than by radix passes.
// Measured on an H100 (PERF.md §6), a phase 1 grid over a tile of Q15's
// round-slice at SF 100 with exactly n kept rows a chunk: the counted sort
// takes 0.30-0.31 ms to n = 128, 0.41 at 256 and 0.56-0.59 at 384, the
// radix passes 0.60-0.71 ms at every n (ten passes of barriers, whatever
// n); at 448 the counted sort takes 0.71-0.72 against their 0.67-0.69.
constexpr int kRankSortRows = 384;
static_assert(kRankSortRows <= kStepThreads, "one kept row a thread");

// One member of a group-step launch.  The carries in_* may be null (zero).
struct GroupMember {
  const float* vals;
  const float* w;
  const int* gids;
  const float* in_s;
  const float* in_q;
  const float* in_m;
  float* out_s;
  float* out_q;
  float* out_m;
  float* scratch;  // P * min(Ct, C) chunk tables of `words` floats each
  int A;
  int G;
  long long words;  // at least group_step_words(L, A, G), else refused
};

struct GroupSet {
  GroupMember m[kMaxMembers];
  int n;
};

__host__ __device__ __forceinline__ int step_entries(int L, int G) {
  return L < G ? L : G;
}
// Ids a lane of phase 2 owns (s in the header): the largest power of two
// <= G / 4L (1 where G < 8L), so that a window of 32*s ids takes at most 8
// of a chunk's L rows on average, whose window of 2A+1 floats an id fits
// kFoldSpanFloats.
__host__ __device__ __forceinline__ int step_span(int L, int A, int G) {
  int s = 1;
  while (8LL * s * L <= G && 64LL * s * (2 * A + 1) <= kFoldSpanFloats) s *= 2;
  return s;
}
// Windows of 32*s ids a chunk table has offsets for (and one more).
__host__ __device__ __forceinline__ int step_windows(int L, int A, int G) {
  const int S = 32 * step_span(L, A, G);
  return (G + S - 1) / S;
}
// Scratch words of one chunk's table: W + 1 offsets, E ids, E * (2A+1) sums
// (the least GroupMember::words run_group_step accepts).
__host__ __device__ __forceinline__ long long group_step_words(int L, int A,
                                                               int G) {
  const long long E = step_entries(L, G);
  return step_windows(L, A, G) + 1 + E * (2LL * A + 2);
}
// Value columns staged in shared memory at once.
__host__ __device__ __forceinline__ int step_val_cols(int L, int A) {
  const int t = kStepValFloats / L;
  return t < 1 ? 1 : (t < A ? t : A);
}

// Block-wide exclusive scan of one value per thread (int, or four 16-bit
// counters packed into an unsigned long long); *total gets the sum.  sbuf
// holds 32 values.  Begins with a barrier, so consecutive calls may reuse
// sbuf.
template <typename T>
__device__ __forceinline__ T block_scan_excl(T x, T* sbuf, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) sbuf[warp] = inc;
  __syncthreads();
  const T wv = lane < nw ? sbuf[lane] : T(0);
  T winc = wv;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, winc, o);
    if (lane >= o) winc += y;
  }
  *total = __shfl_sync(kFull, winc, nw - 1);
  return __shfl_sync(kFull, winc - wv, warp) + inc - x;
}

// Segmented inclusive scan, block-wide, of the NQ sums x[i][*] at sorted
// positions t*KI + i (each sum on its own, all in the same order); a
// position whose bit in `head` is set starts a new segment.  On return
// x[i] holds the segment's running sums at that position (its totals at
// the segment's last position), in the order the header states.  sf holds
// 32 * NQ floats, sh 32 ints.
template <int KI, int NQ>
__device__ __forceinline__ void seg_scan(float (&x)[KI][NQ], unsigned head,
                                         float* sf, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // each thread: a left fold over its positions
#pragma unroll
  for (int i = 1; i < KI; ++i)
    if (!((head >> i) & 1))
#pragma unroll
      for (int q = 0; q < NQ; ++q) x[i][q] = __fadd_rn(x[i - 1][q], x[i][q]);
  // the lanes of a warp: Hillis-Steele over (has a head, trailing partial)
  float a[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) a[q] = x[KI - 1][q];
  int f = head != 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int uf = __shfl_up_sync(kFull, f, o);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float u = __shfl_up_sync(kFull, a[q], o);
      if (lane >= o && !f) a[q] = __fadd_rn(u, a[q]);
    }
    if (lane >= o) f |= uf;
  }
  // the warps of the block: the same scan over the warp totals
  __syncthreads();
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) sf[warp * NQ + q] = a[q];
    sh[warp] = f;
  }
  __syncthreads();
  float wa[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) wa[q] = lane < nw ? sf[lane * NQ + q] : 0.f;
  int wf = lane < nw ? sh[lane] : 1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int uf = __shfl_up_sync(kFull, wf, o);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float u = __shfl_up_sync(kFull, wa[q], o);
      if (lane >= o && !wf) wa[q] = __fadd_rn(u, wa[q]);
    }
    if (lane >= o) wf |= uf;
  }
  // this thread's carry-in: the running sum just before its first position
  const int src = warp > 0 ? warp - 1 : 0;
  const int ef = __shfl_up_sync(kFull, f, 1);
  float carry[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    carry[q] = __shfl_sync(kFull, wa[q], src);
    const float e = __shfl_up_sync(kFull, a[q], 1);
    if (lane > 0) carry[q] = ef ? e : __fadd_rn(carry[q], e);
  }
  if (warp == 0 && lane == 0) return;  // position 0 always starts a segment
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    if ((head >> i) & 1) break;
#pragma unroll
    for (int q = 0; q < NQ; ++q) x[i][q] = __fadd_rn(carry[q], x[i][q]);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// inf or NaN: the exponent's bits all set
__device__ __forceinline__ bool not_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// Phase 1's rows at s > 1: the rows that can change a sum, those with an id
// in [0, G) and a weight other than 0 or a value that is not finite.
// Thread t reads rows [t*KI, t*KI + KI), 16 bytes at a time where `vec`; a
// block-wide scan of the kept counts writes the kept rows' indices to pa in
// row order, their ids to kk by position, and their ids, weights and (where
// `one`: A = 1, the values loaded beside the weights) values to key, ws and
// vs by row.  Returns the number kept.
template <int KI>
__device__ __forceinline__ int keep_rows(const int* gid, const float* wr,
                                         const float* vr, int A, int G, int L,
                                         bool vec, bool one, int* key,
                                         float* ws, float* vs,
                                         unsigned short* pa, int* kk, int* sh) {
  const int base = threadIdx.x * KI;
  int g[KI];
  float wv[KI], v1[KI];
  if (vec) {
#pragma unroll
    for (int i = 0; i < KI; i += 4) {
      int4 g4 = make_int4(-1, -1, -1, -1);
      float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = w4;
      if (base + i < L) {
        g4 = *reinterpret_cast<const int4*>(gid + base + i);
        w4 = *reinterpret_cast<const float4*>(wr + base + i);
        if (one) v4 = *reinterpret_cast<const float4*>(vr + base + i);
      }
      g[i] = g4.x, g[i + 1] = g4.y, g[i + 2] = g4.z, g[i + 3] = g4.w;
      wv[i] = w4.x, wv[i + 1] = w4.y, wv[i + 2] = w4.z, wv[i + 3] = w4.w;
      v1[i] = v4.x, v1[i + 1] = v4.y, v1[i + 2] = v4.z, v1[i + 3] = v4.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      g[i] = base + i < L ? gid[base + i] : -1;
      wv[i] = base + i < L ? wr[base + i] : 0.f;
      v1[i] = 0.f;
    }
  }
  unsigned keep = 0;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    if (g[i] < 0 || g[i] >= G) continue;
    bool k = wv[i] != 0.f || (one && not_finite(v1[i]));
    for (int a = 0; !one && a < A && !k; ++a)
      k = not_finite(vr[(long long)(base + i) * A + a]);
    keep |= (unsigned)k << i;
  }
  int n;
  int o = block_scan_excl(__popc(keep), sh, &n);
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    if (!((keep >> i) & 1)) continue;
    pa[o] = (unsigned short)(base + i);
    kk[o++] = g[i];
    key[base + i] = g[i];
    ws[base + i] = wv[i];
    if (one) vs[base + i] = v1[i];  // A = 1: a row stride of 1
  }
  return n;
}

// Stable LSD radix sort of the row indices pa[0, n) by key, two bits per
// pass over the bit width of G: four counters per thread, packed 16 bits
// each, scanned block-wide.  Returns the buffer (pa or pb) with the order.
template <int KI>
__device__ __forceinline__ unsigned short* radix_sort(
    unsigned short* pa, unsigned short* pb, const int* key, int n, int G,
    unsigned long long* s64) {
  const int base = threadIdx.x * KI;
  const int bits = 32 - __clz(G);
  for (int b = 0; b < bits; b += 2) {
    __syncthreads();  // the previous pass's (or the load's) writes are done
    unsigned short r[KI];
    unsigned dig = 0;
    unsigned long long cnt = 0;
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      r[i] = 0;
      if (base + i < n) {
        r[i] = pa[base + i];
        const unsigned d = (key[r[i]] >> b) & 3;
        dig |= d << (2 * i);
        cnt += 1ull << (16 * d);
      }
    }
    unsigned long long tot;
    unsigned long long ex = block_scan_excl(cnt, s64, &tot);
    const int t0 = (int)(tot & 0xffff), t1 = (int)((tot >> 16) & 0xffff);
    const int t2 = (int)((tot >> 32) & 0xffff);
    const int start[4] = {0, t0, t0 + t1, t0 + t1 + t2};
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      if (base + i < n) {
        const unsigned d = (dig >> (2 * i)) & 3;
        pb[start[d] + (int)((ex >> (16 * d)) & 0xffff)] = r[i];
        ex += 1ull << (16 * d);
      }
    }
    unsigned short* t = pa;
    pa = pb;
    pb = t;
  }
  return pa;
}

// The same stable order for n <= kStepThreads rows in one step: row t's
// place is the number of rows before it by (key, then t), kk holding the
// keys of pa[0, n) in that order.  Returns pb, which holds the order.
__device__ __forceinline__ unsigned short* rank_sort(const unsigned short* pa,
                                                     unsigned short* pb,
                                                     const int* kk, int n) {
  __syncthreads();  // pa and kk are written
  const int t = threadIdx.x;
  if (t < n) {
    const int k = kk[t];
    int r = 0, j = 0;
    if (aligned16(kk))  // four keys a load
      for (; j + 4 <= n; j += 4) {
        const int4 q = *reinterpret_cast<const int4*>(kk + j);
        r += (q.x < k || (q.x == k && j < t)) +
             (q.y < k || (q.y == k && j + 1 < t)) +
             (q.z < k || (q.z == k && j + 2 < t)) +
             (q.w < k || (q.w == k && j + 3 < t));
      }
    for (; j < n; ++j) {
      const int kj = kk[j];
      r += kj < k || (kj == k && j < t);
    }
    pb[r] = pa[t];
  }
  return pb;
}

// Phase 1 for one chunk: sort, reduce every run, write the chunk's table.
// slot is the chunk's table index within the tile, row0 its first row.
// DROP (the member's fold is wide, s > 1): the zero-weight rows leave
// before the sort; without it the code is that of every row sorted.
template <int KI, bool DROP>
__device__ void group_partials(const GroupMember& m, long long row0,
                               long long slot, int L, char* smem) {
  const int A = m.A, G = m.G;
  const int E = step_entries(L, G), W = step_windows(L, A, G);
  const int wsh = 4 + __ffs(step_span(L, A, G));  // id >> wsh: its window
  constexpr bool drop = DROP;
  const int AT = step_val_cols(L, A);
  float* sf = reinterpret_cast<float*>(smem);      // 32 * kSegSums floats
  unsigned long long* s64 = reinterpret_cast<unsigned long long*>(smem);
  int* sh = reinterpret_cast<int*>(smem + 768);    // 32 ints
  int* last = sh + 32;                             // the last run's id
  int* key = reinterpret_cast<int*>(smem + 1024);  // [L]
  float* ws = reinterpret_cast<float*>(key + L);   // [L]
  float* vs = ws + L;                              // [L, AT | 1]
  const int VS = AT | 1;  // odd row stride: permuted rows spread over banks
  unsigned short* pa = reinterpret_cast<unsigned short*>(vs + (long long)L * VS);
  unsigned short* pb = pa + L;                     // [L] each
  float* stg = reinterpret_cast<float*>(pb + L);   // [kSegSums, L]

  float* tab = m.scratch + slot * m.words;
  int* off = reinterpret_cast<int*>(tab);          // [W + 1]
  int* ids = off + W + 1;                          // [E]
  float* sums = tab + W + 1 + E;                   // [2A+1, E]

  const int* gid = m.gids + row0;
  const float* wr = m.w + row0;
  const float* vr = m.vals + row0 * A;
  const int base = threadIdx.x * KI;
  // drop: 16-byte loads of KI rows a thread, and where A = 1 the values
  // staged with the ids and weights
  const bool vec =
      KI % 4 == 0 && (L & 3) == 0 && aligned16(gid) && aligned16(wr);
  const bool one = drop && A == 1 && vec && aligned16(vr);
  int n = L;  // the rows the sort and the runs cover: every row, or the kept
  if (drop) {
    n = keep_rows<KI>(gid, wr, vr, A, G, L, vec, one, key, ws, vs, pa,
                      reinterpret_cast<int*>(stg), sh);
  } else if ((L & 3) == 0 && aligned16(gid) && aligned16(wr)) {
    for (int i = threadIdx.x; i < L / 4; i += blockDim.x) {
      const int4 g = reinterpret_cast<const int4*>(gid)[i];
      reinterpret_cast<int4*>(key)[i] = make_int4(
          (g.x >= 0 && g.x < G) ? g.x : G, (g.y >= 0 && g.y < G) ? g.y : G,
          (g.z >= 0 && g.z < G) ? g.z : G, (g.w >= 0 && g.w < G) ? g.w : G);
      reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(wr)[i];
    }
  } else {
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      const int g = gid[i];
      key[i] = (g >= 0 && g < G) ? g : G;
      ws[i] = wr[i];
    }
  }
  if (!drop)
    for (int i = threadIdx.x; i < L; i += blockDim.x) pa[i] = (unsigned short)i;

  pa = drop && n <= kRankSortRows
           ? rank_sort(pa, pb, reinterpret_cast<const int*>(stg), n)
           : radix_sort<KI>(pa, pb, key, n, G, s64);
  __syncthreads();

  // runs: heads, ends, the run index of every position
  int k_[KI];
  unsigned head = 0, end = 0;
  int heads = 0;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int j = base + i;
    const int kj = j < n ? key[pa[j]] : G;
    k_[i] = kj;
    if (kj < G) {
      if (j == 0 || key[pa[j - 1]] != kj) {
        head |= 1u << i;
        ++heads;
      }
      if (j + 1 == n || key[pa[j + 1]] != kj) end |= 1u << i;
    } else {
      head |= 1u << i;  // past the valid rows: a segment of its own
    }
  }
  int runs;
  int e = block_scan_excl(heads, sh, &runs) - 1;
  int rank[KI];
  int* rid = reinterpret_cast<int*>(stg);  // drop: the runs' ids, for off
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    if (k_[i] < G && ((head >> i) & 1)) {
      ++e;
      ids[e] = k_[i];
      if (drop) {
        rid[e] = k_[i];
      } else {
        // the windows whose first id lies in (previous id, this id]
        const int wlo = e == 0 ? 0 : (key[pa[base + i - 1]] >> wsh) + 1;
        for (int w = wlo; w <= (k_[i] >> wsh); ++w) off[w] = e;
      }
    }
    rank[i] = e;
    if (!drop && k_[i] < G && ((end >> i) & 1) && e == runs - 1) *last = k_[i];
  }
  __syncthreads();
  if (drop) {  // few runs: each window's offset by a binary search of their ids
    for (int w = threadIdx.x; w <= W; w += blockDim.x) {
      const int first = w << wsh;
      int lo = 0, hi = runs;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (rid[mid] < first) lo = mid + 1;
        else hi = mid;
      }
      off[w] = lo;
    }
  } else {  // the windows past the last run
    const int wlo = runs == 0 ? 0 : (*last >> wsh) + 1;
    for (int w = wlo + threadIdx.x; w <= W; w += blockDim.x) off[w] = runs;
  }

  // every run reduced by the block, four sums per pass, in the order
  // (S[a], Q[a]) for the staged value columns, then M
  for (int a0 = 0; a0 < A; a0 += AT) {
    const int at = A - a0 < AT ? A - a0 : AT;
    __syncthreads();  // the previous tile's readers are done with vs
    if (drop) {  // the kept rows' values alone (`one`: staged with the ids)
      for (int i = threadIdx.x; !one && i < n * at; i += blockDim.x) {
        const int r = pa[i / at], a = i - (i / at) * at;
        vs[r * VS + a] = vr[(long long)r * A + a0 + a];
      }
    } else if (at == A && ((L * A) & 3) == 0 && aligned16(vr)) {
      for (int i = threadIdx.x; i < L * A / 4; i += blockDim.x) {
        const float4 v = reinterpret_cast<const float4*>(vr)[i];
        const float c[4] = {v.x, v.y, v.z, v.w};
        int r = 4 * i / A, a = 4 * i - r * A;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          vs[r * VS + a] = c[u];
          if (++a == A) a = 0, ++r;
        }
      }
    } else {
      for (int i = threadIdx.x; i < L * at; i += blockDim.x)
        vs[(i / at) * VS + i % at] = vr[(long long)(i / at) * A + a0 + i % at];
    }
    __syncthreads();
    const int nq = 2 * at + (a0 + at == A);  // M with the last tile
    for (int q0 = 0; q0 < nq; q0 += kSegSums) {
      float x[KI][kSegSums];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const int r = pa[base + i < n ? base + i : 0];
#pragma unroll
        for (int u = 0; u < kSegSums; ++u) {
          const int q = q0 + u;
          float c = 0.f;
          if (k_[i] < G) {
            if (q == 2 * at) {
              c = ws[r];
            } else if (q < 2 * at) {
              const float v = vs[r * VS + (q >> 1)];
              const float vw = __fmul_rn(v, ws[r]);
              c = (q & 1) ? __fmul_rn(v, vw) : vw;
            }
          }
          x[i][u] = c;
        }
      }
      // where every run is one row (drop: the usual chunk at s > 1) each
      // position already holds its run's totals, as the scan would leave it
      if (!drop || runs < n)
        seg_scan<KI, kSegSums>(x, head, sf, sh);
      else
        __syncthreads();  // the previous pass's readers are done with stg
      // the run totals, staged by run index, then written out coalesced
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        if (!((end >> i) & 1)) continue;
#pragma unroll
        for (int u = 0; u < kSegSums; ++u) stg[u * L + rank[i]] = x[i][u];
      }
      __syncthreads();
      const int nu = nq - q0 < kSegSums ? nq - q0 : kSegSums;
      for (int t = threadIdx.x; t < nu * runs; t += blockDim.x) {
        const int u = t / runs, e = t - u * runs, q = q0 + u;
        const int k = q == 2 * at ? 2 * A : (q & 1) ? A + a0 + (q >> 1) : a0 + (q >> 1);
        sums[(long long)k * E + e] = stg[u * L + e];
      }
    }
  }
}

// Phase 1 grid: blockIdx.x = p * ct + (chunk - c0), blockIdx.y = member.
template <int KI>
__global__ void __launch_bounds__(kStepThreads, KI <= 4 ? 2 : 1)
group_partials_kernel(const __grid_constant__ GroupSet set, int C, int c0,
                      int ct, int L) {
  extern __shared__ __align__(16) char step_smem[];
  const GroupMember& m = set.m[blockIdx.y];
  const int p = blockIdx.x / ct, c = c0 + blockIdx.x % ct;
  const long long row0 = ((long long)p * C + c) * L;
  if (step_span(L, m.A, m.G) > 1)
    group_partials<KI, true>(m, row0, blockIdx.x, L, step_smem);
  else
    group_partials<KI, false>(m, row0, blockIdx.x, L, step_smem);
}

// Carry element (p, g, k) of a member: where the fold reads it (null: zero)
// and writes it.
__device__ __forceinline__ void carry_at(const GroupMember& m, int p, int g,
                                         int k, bool first, const float** in,
                                         float** out, long long* idx) {
  const int A = m.A, G = m.G;
  if (k < A) {
    *in = m.in_s, *out = m.out_s, *idx = ((long long)p * G + g) * A + k;
  } else if (k < 2 * A) {
    *in = m.in_q, *out = m.out_q, *idx = ((long long)p * G + g) * A + k - A;
  } else {
    *in = m.in_m, *out = m.out_m, *idx = (long long)p * G + g;
  }
  if (!first) *in = *out;
}

// Phase 2 at s = 1, one warp: carry elements (p, 32*w + lane, k) for the
// KG columns k of group kg, over the tile's ct chunk tables in chunk order.
// `first` reads the carry from in_* (zero when null), later tiles from
// out_*.  The warp loads the entries of U chunks at once, and the offsets
// of the next U chunks while it adds them.
template <int U, int KG>
__device__ void group_fold(const GroupMember& m, long long warp_id, int P,
                           int ct, int L, bool first) {
  const int A = m.A, G = m.G, K = 2 * A + 1, NKG = (K + KG - 1) / KG;
  const int E = step_entries(L, G), W = step_windows(L, A, G);
  if (warp_id >= (long long)P * W * NKG) return;
  const int kg = (int)(warp_id % NKG);
  const int w = (int)((warp_id / NKG) % W);
  const int p = (int)(warp_id / ((long long)NKG * W));
  const int lane = threadIdx.x & 31;
  const int g = 32 * w + lane;
  float acc[KG];
#pragma unroll
  for (int j = 0; j < KG; ++j) {
    const int k = kg * KG + j;
    const float* in;
    float* out;
    long long idx;
    acc[j] = 0.f;
    if (k < K && g < G) {
      carry_at(m, p, g, k, first, &in, &out, &idx);
      if (in) acc[j] = in[idx];
    }
  }
  const long long words = m.words;
  const float* tabs = m.scratch + (long long)p * ct * words;
  const unsigned below = (1u << lane) - 1;
  int o0 = 0, o1 = 0;
  if (lane < U && lane < ct) {
    const int* off = reinterpret_cast<const int*>(tabs + lane * words);
    o0 = off[w];
    o1 = off[w + 1];
  }
  for (int c0 = 0; c0 < ct; c0 += U) {
    int n0 = 0, n1 = 0;  // the next group's offsets
    if (lane < U && c0 + U + lane < ct) {
      const int* off = reinterpret_cast<const int*>(tabs + (c0 + U + lane) * words);
      n0 = off[w];
      n1 = off[w + 1];
    }
    int id[U];
    float v[U][KG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = __shfl_sync(kFull, o0, u);
      const int n = __shfl_sync(kFull, o1, u) - s;
      id[u] = -1;
#pragma unroll
      for (int j = 0; j < KG; ++j) v[u][j] = 0.f;
      if (lane < n) {
        const float* tab = tabs + (c0 + u) * words + W + 1;
        id[u] = reinterpret_cast<const int*>(tab)[s + lane];
#pragma unroll
        for (int j = 0; j < KG; ++j)
          if (kg * KG + j < K) v[u][j] = tab[E + (long long)(kg * KG + j) * E + s + lane];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned mask =
          __reduce_or_sync(kFull, id[u] >= 0 ? 1u << (id[u] - 32 * w) : 0u);
      const int src = __popc(mask & below);
      const bool mine = (mask >> lane) & 1;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const float x = __shfl_sync(kFull, v[u][j], src);
        if (mine) acc[j] = __fadd_rn(acc[j], x);
      }
    }
    o0 = n0;
    o1 = n1;
  }
#pragma unroll
  for (int j = 0; j < KG; ++j) {
    const int k = kg * KG + j;
    const float* in;
    float* out;
    long long idx;
    if (k < K && g < G) {
      carry_at(m, p, g, k, first, &in, &out, &idx);
      out[idx] = acc[j];
    }
  }
}

// Shared floats of one span warp: its window's carry of up to kSpanCols
// columns (at most the 32*s*(2A+1) floats step_span caps), then 32 ints of
// entry offsets.
__host__ __device__ __forceinline__ int span_floats(int s, int A) {
  return 32 * s * (2 * A + 1 < kSpanCols ? 2 * A + 1 : kSpanCols) + 32;
}

// Phase 2 at s > 1, one warp: the carry elements of window w (ids
// [32*s*w, 32*s*w + 32*s)) of partition p, for the KS columns of group kg,
// in `acc` (shared, span_floats(s, A): column c of id j at c*32*s + j), over
// the tile's ct chunk tables in chunk order.  `first` reads the carry from
// in_* (zero when null), later tiles from out_*.
//
// The chunks go by in batches of 32: lane j holds the offsets of chunk
// c0 + j (the next batch's are loaded a batch ahead), and a warp scan lays
// the batch's entries end to end in chunk order, `pos` (the last 32 ints
// of the warp's table) holding the scan.  Each round the lanes take 32
// consecutive entries, chunk u's entry i - pos[u-1] + off[w] at flat
// position i.
template <int KS>
__device__ void group_fold_span(const GroupMember& m, long long warp_id,
                                int s, int P, int ct, int L, bool first,
                                float* acc) {
  const int A = m.A, G = m.G, K = 2 * A + 1, NKS = (K + KS - 1) / KS;
  const int S = 32 * s, E = step_entries(L, G), W = (G + S - 1) / S;
  if (warp_id >= (long long)P * W * NKS) return;
  const int k0 = (int)(warp_id % NKS) * KS;
  const int w = (int)((warp_id / NKS) % W);
  const int p = (int)(warp_id / ((long long)NKS * W));
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int g0 = S * w, n = G - g0 < S ? G - g0 : S;
  int* pos = reinterpret_cast<int*>(acc + span_floats(s, A) - 32);
  for (int c = 0; c < KS && k0 + c < K; ++c) {
    for (int j = lane; j < n; j += 32) {
      const float* in;
      float* out;
      long long idx;
      carry_at(m, p, g0 + j, k0 + c, first, &in, &out, &idx);
      acc[c * S + j] = in ? in[idx] : 0.f;
    }
  }

  const long long words = m.words;
  const float* tabs = m.scratch + (long long)p * ct * words + W + 1;  // ids
  const int* offs = reinterpret_cast<const int*>(tabs - W - 1) + w;  // off[w]
  int o0 = 0, o1 = 0;
  if (lane < ct) {
    o0 = offs[lane * words];
    o1 = offs[lane * words + 1];
  }
  for (int c0 = 0; c0 < ct; c0 += 32) {
    int n0 = 0, n1 = 0;  // the next 32 chunks' offsets
    if (c0 + 32 + lane < ct) {
      n0 = offs[(c0 + 32 + lane) * words];
      n1 = offs[(c0 + 32 + lane) * words + 1];
    }
    const int cnt = o1 - o0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int delta = o0 - (incl - cnt);  // entry index less flat position
    __syncwarp();  // the previous 32 chunks' readers are done with pos
    pos[lane] = incl;
    __syncwarp();
    for (int r0 = 0; r0 < total; r0 += 32) {
      const int i = r0 + lane;  // this lane's entry: its id in the window
      int u = 0;                // the chunk of flat position i: #{j : pos[j] <= i}
      if (i < total) {
#pragma unroll
        for (int b = 16; b > 0; b >>= 1)
          if (pos[u + b - 1] <= i) u += b;
      }
      const int e = i + __shfl_sync(kFull, delta, u);
      int id = -1;
      float v[KS];
#pragma unroll
      for (int c = 0; c < KS; ++c) v[c] = 0.f;
      if (i < total) {
        const float* at = tabs + (c0 + u) * words + e;
        id = reinterpret_cast<const int*>(at)[0] - g0;
#pragma unroll
        for (int c = 0; c < KS; ++c)
          if (k0 + c < K) v[c] = at[E + (long long)(k0 + c) * E];
      }
      // lanes with one id hold it from different chunks, in lane order: a
      // step a rank among them
      const unsigned same = __match_any_sync(kFull, id >= 0 ? id : -1 - lane);
      const int rank = __popc(same & below);
      const int top = (int)__reduce_max_sync(kFull, (unsigned)rank);
      for (int q = 0; q <= top; ++q) {
        if (id >= 0 && rank == q) {
          float x[KS];  // the columns' elements differ: read all, then write
#pragma unroll
          for (int c = 0; c < KS; ++c)
            if (k0 + c < K) x[c] = acc[c * S + id];
#pragma unroll
          for (int c = 0; c < KS; ++c)
            if (k0 + c < K) acc[c * S + id] = __fadd_rn(x[c], v[c]);
        }
        __syncwarp();
      }
    }
    o0 = n0;
    o1 = n1;
  }
  __syncwarp();
  for (int c = 0; c < KS && k0 + c < K; ++c) {
    for (int j = lane; j < n; j += 32) {
      const float* in;
      float* out;
      long long idx;
      carry_at(m, p, g0 + j, k0 + c, first, &in, &out, &idx);
      out[idx] = acc[c * S + j];
    }
  }
}

// Phase 2 grid: blockIdx.x * kFoldWarps + warp, blockIdx.y = member.  A
// member at s > 1 takes group_fold_span in its warp's share of the dynamic
// shared memory (none is asked for when no member has s > 1), one at s = 1
// group_fold.  Two blocks an SM: at most 128 registers a thread, and 12 KB
// of shared carry a warp.
template <int U, int KG>
__global__ void __launch_bounds__(kFoldWarps * 32, 2)
group_fold_kernel(const __grid_constant__ GroupSet set, int P, int ct, int L,
                  int first) {
  extern __shared__ __align__(16) char step_smem[];
  const GroupMember& m = set.m[blockIdx.y];
  const long long warp_id =
      (long long)blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  const int s = step_span(L, m.A, m.G);
  if (s > 1)
    group_fold_span<kSpanCols>(
        m, warp_id, s, P, ct, L, first != 0,
        reinterpret_cast<float*>(step_smem) +
            (threadIdx.x >> 5) * span_floats(s, m.A));
  else
    group_fold<U, KG>(m, warp_id, P, ct, L, first != 0);
}

// Phase 1's shared memory: scan buffers, key and w [L], the value columns
// [L, AT | 1], two index buffers [L] and the staged run totals
// [kSegSums, L] (group_partials' layout).
inline size_t step_smem_bytes(int L, int A_max) {
  const size_t pairs = (size_t)2 * L * sizeof(unsigned short);
  return 1024 + (size_t)L * 4 * (2 + (step_val_cols(L, A_max) | 1) + kSegSums) +
         pairs;
}

template <int KI>
inline int launch_partials(const GroupSet& set, int P, int C, int c0, int ct,
                           int L, size_t smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      group_partials_kernel<KI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  group_partials_kernel<KI><<<dim3((unsigned)(P * ct), set.n), kStepThreads,
                              smem, s>>>(set, C, c0, ct, L);
  return (int)cudaGetLastError();
}

// The group step of every member of `set` over the same [P, C, L] rows, in
// tiles of Ct chunks: phase 1 then phase 2 per tile.  Each member's scratch
// holds P * min(Ct, C) chunk tables of m.words floats; a member whose
// m.words is below group_step_words(L, A, G) is refused before either phase,
// so a wrapper that sizes the scratch from another formula fails loudly
// instead of letting phase 1 write past the buffer.
inline int run_group_step(const GroupSet& set, int P, int C, int L, int Ct,
                          cudaStream_t s) {
  if (set.n < 1 || set.n > kMaxMembers || L < 1 || L > kMaxStepRows ||
      Ct < 1 || P < 1 || C < 0)
    return (int)cudaErrorInvalidValue;
  int A_max = 0;
  long long cols = 0, wide_warps = 0;  // s = 1: warps at 1 and 9 columns
  long long span_warps = 0;            // s > 1: at kSpanCols columns
  int span_smem = 0;                   // s > 1: shared bytes of a fold block
  for (int i = 0; i < set.n; ++i) {
    const GroupMember& m = set.m[i];
    if (m.A < 1 || m.G < 1 || m.words < group_step_words(L, m.A, m.G))
      return (int)cudaErrorInvalidValue;
    A_max = m.A > A_max ? m.A : A_max;
    const long long n = (long long)P * step_windows(L, m.A, m.G);
    const int sp = step_span(L, m.A, m.G);
    if (sp > 1) {
      const long long nw = n * ((2 * m.A + kSpanCols) / kSpanCols);
      span_warps = nw > span_warps ? nw : span_warps;
      const int b = kFoldWarps * 4 * span_floats(sp, m.A);
      span_smem = b > span_smem ? b : span_smem;
      continue;
    }
    cols = n * (2 * m.A + 1) > cols ? n * (2 * m.A + 1) : cols;
    wide_warps = n * ((2 * m.A + 9) / 9) > wide_warps ? n * ((2 * m.A + 9) / 9)
                                                      : wide_warps;
  }
  // many (p, window, column) triples: a warp takes 9 columns and overlaps
  // the loads of 8 chunks; few: a warp takes 1 column and 32 chunks
  const bool wide = cols >= kFoldWide;
  long long warps = wide ? wide_warps : cols;
  warps = span_warps > warps ? span_warps : warps;
  const size_t smem = step_smem_bytes(L, A_max);
  const int ki = (L + kStepThreads - 1) / kStepThreads;
  const dim3 fold_grid((unsigned)((warps + kFoldWarps - 1) / kFoldWarps), set.n);
  if (span_smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        wide ? group_fold_kernel<8, 9> : group_fold_kernel<32, 1>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, span_smem);
    if (e != cudaSuccess) return (int)e;
  }
  int c0 = 0;
  do {
    const int ct = C - c0 < Ct ? C - c0 : Ct;
    if (ct > 0) {
      const int e = ki <= 1   ? launch_partials<1>(set, P, C, c0, ct, L, smem, s)
                    : ki <= 2 ? launch_partials<2>(set, P, C, c0, ct, L, smem, s)
                    : ki <= 4 ? launch_partials<4>(set, P, C, c0, ct, L, smem, s)
                              : launch_partials<8>(set, P, C, c0, ct, L, smem, s);
      if (e != 0) return e;
    }
    const dim3 b(kFoldWarps * 32);
    const int f = c0 == 0;
    if (wide)
      group_fold_kernel<8, 9><<<fold_grid, b, span_smem, s>>>(set, P, ct, L, f);
    else
      group_fold_kernel<32, 1><<<fold_grid, b, span_smem, s>>>(set, P, ct, L, f);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    c0 += ct;
  } while (c0 < C);
  return 0;
}

}  // namespace pfola

extern "C" const char* pf_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
