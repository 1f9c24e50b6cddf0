// Hopper (sm_90a) CUDA version of K1's column-decode stage.
//
// Replaces _decode_chunk (src/repro/kernels/fused_agg.py:224-238), which
// the Pallas kernels K1 (fused_round_step, pallas_call at l.363) and K2
// (fused_prefix_states, l.454) run on every encoded column of a block
// before the query's closures: a dictionary gather values[code] or a
// bit-packed shift-and-mask (src/repro/data/encodings.py).  The port's
// closures are PyTorch, so they need logical columns in device memory:
// pf_decode turns every encoded column of a round-slice into its logical
// [P, C, L] column in ONE launch, ahead of them.  Fusing decode, closures
// and accumulation into one kernel is later work.
//
// What it computes, bit-exactly:
//   dictionary: out[i] = values[clamp(code[i], 0, n_values - 1)], codes
//     int8 or int16 read signed; the value table sits in shared memory when
//     it fits (kSmemTable bytes), else it is read through __ldg (int16
//     codes allow 32,768 entries).  Values move as raw 1-, 2-, 4- or 8-byte
//     words, so any logical dtype decodes bit-exactly.
//   bit-packed: word j holds the lanes = 32 / bits values j*lanes + l at
//     bit offsets bits*l, unsigned, written as int32 (the wrapper casts to
//     another logical dtype as the reference's astype does).  The trailing
//     length is a multiple of lanes, so the flat index of a logical element
//     maps to its word the same way.
//
// What bounds it on an H100: bytes — per TPC-H round-slice row it reads
// 5.25 bytes of codes and words and writes 20 bytes of logical columns,
// with no arithmetic to speak of.  The unit of work is a granule: the
// values of ONE 16-byte store.  Thread t of the grid takes granules t, t +
// stride, ..., kInFlight of them at a time (their loads first, then the
// values and the stores), so that every warp instruction, load or store,
// covers consecutive addresses, and a thread has kInFlight loads in flight:
//   - dictionary: a granule is 16 / ES values of ES bytes (4 float32s),
//     whose codes are one load of 16 * CB / ES bytes (4 for int8 codes of
//     4-byte values); each value is gathered from the table;
//   - bit-packed: a granule is 4 int32 values, in one word (4, 8, 16 or 32
//     lanes), two (2 lanes: one 8-byte load; 3, 5, 6 or 10 lanes: the 4
//     values may straddle two words) or four (1 lane: one 16-byte load).
//     The kernel is instantiated per bit width, so shifts and masks are
//     compile-time constants and a granule's word and first lane come from
//     a shift and a mask of its index (a division by a constant for 3, 5, 6
//     and 10 lanes): nothing per element.
//   - The granule loops cover a column when its codes or words and its
//     output are 16-byte aligned; the values past the last whole granule,
//     and a column that is not aligned, take a scalar loop in the same
//     launch (per element for a dictionary and for those < 4 values, per
//     word for a misaligned bit-packed column).  Both give the same bits.
// Why the unit is a store and not a 16-byte load of codes: the values of a
// thread's 16 int8 codes are 64 contiguous bytes (256 for four 2-bit
// words), so a warp's store instruction would touch 32 sectors at that
// stride; on an H100 that took 0.41 ms for a TPC-H round-slice's five
// columns, twice the one-element-per-thread kernel it replaced.
//
// Grid: one dimension, cut into a range of blocks per column (the column
// table travels as a __grid_constant__ kernel parameter, as pf_bundle's
// member table does; a block finds its column among the ranges).  The
// grid fills the card once: the SM count times the blocks one SM holds
// with the largest staged table (the occupancy API, asked once per device),
// split over the columns by the bytes each reads and writes, so that the
// columns end together (at least one block a column, and no more than one
// thread per element).  The blocks of a column walk its granules with a
// grid stride.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kTableCols = 9;  // int64 slots per column in pf_decode's table
constexpr int kThreads = 256;
constexpr int kSmemTable = 32 * 1024;  // largest value table held in smem
constexpr int kInFlight = 4;  // granules whose loads a thread issues at once

struct Col {
  const void* src;     // codes (int8/int16) or int32 words
  void* dst;           // logical elements
  const void* values;  // dictionary value table (null for bit-packed)
  long long n;         // logical elements
  int kind;            // 0 dictionary, 1 bit-packed
  int width;           // dictionary: code bytes (1, 2); bit-packed: bits
  int es;              // dictionary: value bytes (1, 2, 4, 8)
  int n_values;        // dictionary: table entries
  int smem;            // dictionary: 1 when the table is staged in smem
  int block0;          // the column's first block of the grid
  int blocks;          // and its number of blocks
};

struct Table {
  Col c[kMaxCols];
  int m;  // columns
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int ES>
struct Word;  // the raw word of a value of ES bytes
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = unsigned long long; };

template <int ES>
__device__ __forceinline__ typename Word<ES>::T lookup(const unsigned char* tab,
                                                       bool in_smem, int k) {
  const typename Word<ES>::T* t = reinterpret_cast<const typename Word<ES>::T*>(tab);
  return in_smem ? t[k] : __ldg(t + k);
}

// NB bytes (2, 4, 8, 16 or 32) loaded from an NB-aligned address, as
// 32-bit words.
template <int NB>
struct Raw {
  uint32_t w[NB < 4 ? 1 : NB / 4];
};

template <int NB>
__device__ __forceinline__ Raw<NB> load_raw(const unsigned char* p) {
  Raw<NB> r;
  if constexpr (NB == 2) {
    r.w[0] = __ldg(reinterpret_cast<const uint16_t*>(p));
  } else if constexpr (NB == 4) {
    r.w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else if constexpr (NB == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = q.x;
    r.w[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r.w[4 * i] = q.x;
      r.w[4 * i + 1] = q.y;
      r.w[4 * i + 2] = q.z;
      r.w[4 * i + 3] = q.w;
    }
  }
  return r;
}

// Dictionary column, CB code bytes and ES value bytes, one granule at a
// time: granule g is the VS = 16 / ES values from element g * VS on (one
// 16-byte store) and reads their NB = VS * CB bytes of codes.
template <int CB, int ES>
__device__ __forceinline__ void dict_col(const Col& c,
                                         const unsigned char* tab, bool sm,
                                         long long tid, long long stride) {
  using T = typename Word<ES>::T;
  constexpr int VS = 16 / ES;
  constexpr int NB = VS * CB;
  constexpr int per = ES < 4 ? 4 / ES : 1;  // values per 32-bit word
  const int hi = c.n_values - 1;
  const unsigned char* src = static_cast<const unsigned char*>(c.src);
  T* out = static_cast<T*>(c.dst);
  const bool vec = aligned16(c.src) && aligned16(c.dst);
  const long long ng = vec ? c.n / VS : 0;
  for (long long g0 = tid; g0 < ng; g0 += kInFlight * stride) {
    Raw<NB> r[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long g = g0 + u * stride;
      if (g < ng) r[u] = load_raw<NB>(src + g * NB);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long g = g0 + u * stride;
      if (g >= ng) break;
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < VS; ++q) {
        const int code = CB == 1 ? (int)(int8_t)(r[u].w[q >> 2] >> (8 * (q & 3)))
                                 : (int)(int16_t)(r[u].w[q >> 1] >> (16 * (q & 1)));
        const T v = lookup<ES>(tab, sm, min(max(code, 0), hi));
        if constexpr (ES == 8) {
          o[2 * q] = (uint32_t)v;
          o[2 * q + 1] = (uint32_t)(v >> 32);
        } else if constexpr (ES == 4) {
          o[q] = v;
        } else {
          const uint32_t bits = (uint32_t)v << (8 * ES * (q % per));
          o[q / per] = (q % per) ? (o[q / per] | bits) : bits;
        }
      }
      reinterpret_cast<uint4*>(out)[g] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  for (long long i = ng * VS + tid; i < c.n; i += stride) {
    const int code = CB == 1 ? (int)static_cast<const int8_t*>(c.src)[i]
                             : (int)static_cast<const int16_t*>(c.src)[i];
    out[i] = lookup<ES>(tab, sm, min(max(code, 0), hi));
  }
}

// Bit-packed column of BITS-bit values, LANES = 32 / BITS to a word, one
// granule at a time: granule g is the 4 values from element 4g on (one int4
// store); they lie in NW words, the first from lane l0 on.
template <int BITS>
struct Packed {
  static constexpr int LANES = 32 / BITS;
  static constexpr int NW = LANES <= 2 ? 4 / LANES : (LANES % 4 == 0 ? 1 : 2);
  static constexpr unsigned kMask = BITS >= 32 ? 0xffffffffu : ((1u << BITS) - 1u);

  __device__ __forceinline__ static void fetch(const unsigned* words,
                                               long long g, uint32_t (&wd)[NW],
                                               int& l0) {
    l0 = 0;
    if constexpr (LANES == 1) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(words) + g);
      wd[0] = q.x;
      wd[1] = q.y;
      wd[2] = q.z;
      wd[3] = q.w;
    } else if constexpr (LANES == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(words) + g);
      wd[0] = q.x;
      wd[1] = q.y;
    } else if constexpr (LANES % 4 == 0) {  // granules per word: a power of 2
      constexpr int GPW = LANES / 4;
      wd[0] = __ldg(words + g / GPW);
      l0 = 4 * (int)(g % GPW);
    } else {  // 3, 5, 6 or 10 lanes: the 4 values may reach into a next word
      const long long w0 = 4 * g / LANES;
      l0 = (int)(4 * g - w0 * LANES);
      wd[0] = __ldg(words + w0);
      wd[1] = l0 + 3 >= LANES ? __ldg(words + w0 + 1) : 0u;
    }
  }

  __device__ __forceinline__ static int4 values(const uint32_t (&wd)[NW], int l0) {
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (LANES <= 2) {
        v[e] = (int)((wd[e / LANES] >> (BITS * (e % LANES))) & kMask);
      } else {
        const int l = l0 + e;
        const bool first = l < LANES;
        v[e] = (int)(((first ? wd[0] : wd[NW - 1]) >> (BITS * (first ? l : l - LANES)))
                     & kMask);
      }
    }
    return make_int4(v[0], v[1], v[2], v[3]);
  }
};

template <int BITS>
__device__ __forceinline__ void packed_col(const Col& c, long long tid,
                                           long long stride) {
  using K = Packed<BITS>;
  constexpr int LANES = K::LANES;
  const unsigned* words = static_cast<const unsigned*>(c.src);
  int* out = static_cast<int*>(c.dst);
  const bool vec = aligned16(words) && aligned16(out);
  const long long ng = vec ? c.n / 4 : 0;
  for (long long g0 = tid; g0 < ng; g0 += kInFlight * stride) {
    uint32_t wd[kInFlight][K::NW];
    int l0[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long g = g0 + u * stride;
      if (g < ng) K::fetch(words, g, wd[u], l0[u]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long g = g0 + u * stride;
      if (g >= ng) break;
      reinterpret_cast<int4*>(out)[g] = K::values(wd[u], l0[u]);
    }
  }
  if (vec) {  // the last n % 4 values
    for (long long i = 4 * ng + tid; i < c.n; i += stride) {
      const long long j = i / LANES;
      out[i] = (int)((__ldg(words + j) >> (BITS * (int)(i - j * LANES))) & K::kMask);
    }
    return;
  }
  const long long nw = c.n / LANES;  // a misaligned column: word by word
  for (long long j = tid; j < nw; j += stride) {
    const unsigned wd = __ldg(words + j);
    int* o = out + j * LANES;
#pragma unroll
    for (int l = 0; l < LANES; ++l) o[l] = (int)((wd >> (BITS * l)) & K::kMask);
  }
}

// The column's bit width as a template argument.
template <int BITS = 1>
__device__ __forceinline__ void packed_bits(const Col& c, long long tid,
                                            long long stride) {
  if constexpr (BITS < 32) {
    if (c.width != BITS) return packed_bits<BITS + 1>(c, tid, stride);
  }
  packed_col<BITS>(c, tid, stride);
}

template <int CB>
__device__ __forceinline__ void dict_es(const Col& c, const unsigned char* tab,
                                        bool sm, long long tid,
                                        long long stride) {
  switch (c.es) {
    case 1: dict_col<CB, 1>(c, tab, sm, tid, stride); break;
    case 2: dict_col<CB, 2>(c, tab, sm, tid, stride); break;
    case 4: dict_col<CB, 4>(c, tab, sm, tid, stride); break;
    default: dict_col<CB, 8>(c, tab, sm, tid, stride); break;
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ Table tbl) {
  extern __shared__ __align__(16) unsigned char stab[];
  int ci = 0;  // the column whose blocks hold this one
  while (ci + 1 < tbl.m && (int)blockIdx.x >= tbl.c[ci + 1].block0) ++ci;
  const Col& c = tbl.c[ci];
  const long long tid = (long long)(blockIdx.x - c.block0) * blockDim.x + threadIdx.x;
  const long long stride = (long long)c.blocks * blockDim.x;
  if (c.kind == 0) {
    const unsigned char* tab = static_cast<const unsigned char*>(c.values);
    if (c.smem) {
      const int nbytes = c.n_values * c.es;
      int b0 = 0;
      if (aligned16(tab)) {
        for (int b = threadIdx.x; b < nbytes / 16; b += blockDim.x)
          reinterpret_cast<uint4*>(stab)[b] = __ldg(reinterpret_cast<const uint4*>(tab) + b);
        b0 = nbytes / 16 * 16;
      }
      for (int b = b0 + threadIdx.x; b < nbytes; b += blockDim.x) stab[b] = tab[b];
      __syncthreads();
      tab = stab;
    }
    if (c.width == 1) dict_es<1>(c, tab, c.smem != 0, tid, stride);
    else dict_es<2>(c, tab, c.smem != 0, tid, stride);
    return;
  }
  packed_bits(c, tid, stride);
}

// Blocks of decode_kernel the current device holds at once (its SMs times
// the blocks one SM holds with the largest staged table), found once per
// device.
cudaError_t resident_blocks(long long* out) {
  static long long cache[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev] > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel,
                                                      kThreads, kSmemTable);
  if (e != cudaSuccess) return e;
  *out = (long long)sms * (per_sm < 1 ? 1 : per_sm);
  if (dev < 64) cache[dev] = *out;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* pf_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// table: M rows of kTableCols int64 — kind, width, es, n_values, n, then
// the addresses src, dst, values, and smem (1: stage the table in shared
// memory).  One launch decodes all M columns.
int pf_decode(const long long* table, int M, void* stream) {
  if (M < 1 || M > kMaxCols) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Table t = {};
  t.m = M;
  double bytes[kMaxCols], total = 0;
  int smem = 0;
  for (int i = 0; i < M; ++i) {
    const long long* r = table + (long long)i * kTableCols;
    Col& c = t.c[i];
    c.kind = (int)r[0];
    c.width = (int)r[1];
    c.es = (int)r[2];
    c.n_values = (int)r[3];
    c.n = r[4];
    c.src = reinterpret_cast<const void*>(r[5]);
    c.dst = reinterpret_cast<void*>(r[6]);
    c.values = reinterpret_cast<const void*>(r[7]);
    c.smem = (int)r[8];
    if (c.kind == 0) {
      if (c.n_values < 1 || (c.width != 1 && c.width != 2) ||
          (c.es != 1 && c.es != 2 && c.es != 4 && c.es != 8))
        return (int)cudaErrorInvalidValue;
      const int nbytes = c.n_values * c.es;
      if (c.smem && nbytes > kSmemTable) return (int)cudaErrorInvalidValue;
      if (c.smem && nbytes > smem) smem = nbytes;
      bytes[i] = (double)c.n * (c.width + c.es);
    } else {
      if (c.width < 1 || c.width > 32) return (int)cudaErrorInvalidValue;
      bytes[i] = (double)c.n * (4.0 / (32 / c.width) + 4);
    }
    total += bytes[i];
  }
  if (total == 0) return 0;
  long long resident = 0;
  const cudaError_t e = resident_blocks(&resident);
  if (e != cudaSuccess) return (int)e;
  long long grid = 0;
  for (int i = 0; i < M; ++i) {  // blocks by bytes, at least 1, at most n / kThreads
    Col& c = t.c[i];
    const long long need = (c.n + kThreads - 1) / kThreads;
    long long b = (long long)(resident * bytes[i] / total + 0.5);
    b = b < 1 ? 1 : (b > need ? need : b);
    c.block0 = (int)grid;
    c.blocks = (int)b;
    grid += b;
  }
  decode_kernel<<<(unsigned)grid, kThreads, smem, s>>>(t);
  return (int)cudaGetLastError();
}

}  // extern "C"
