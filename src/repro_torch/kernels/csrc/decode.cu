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
// The column table travels as a __grid_constant__ kernel parameter, as
// pf_bundle's member table does; blockIdx.y picks the column, and the
// blocks of a column walk its elements with a grid stride.
//
//   dictionary: out[i] = values[clamp(code[i], 0, n_values - 1)], codes
//     int8 or int16 read signed and widened to int; the value table sits in
//     shared memory when it fits (kSmemTable bytes), else it is read
//     through __ldg (int16 codes allow 32,768 entries).  Elements move as
//     raw 1-, 2-, 4- or 8-byte words, so any logical dtype decodes
//     bit-exactly.
//   bit-packed: out[i] = (word[i / lanes] >> (bits * (i % lanes))) & mask,
//     unsigned, written as int32 (the wrapper casts to another logical
//     dtype as the reference's astype does).  The trailing length is a
//     multiple of lanes, so the flat index of a logical element maps to its
//     word the same way.
//
// What bounds it on an H100: bytes — per TPC-H round-slice row it reads
// 5.25 bytes of codes and words and writes 20 bytes of logical columns,
// with no arithmetic to speak of.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kTableCols = 9;  // int64 slots per column in pf_decode's table
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // blocks per column (grid stride beyond)
constexpr int kSmemTable = 32 * 1024;  // largest value table held in smem

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
};

struct Table {
  Col c[kMaxCols];
};

template <typename T>
__device__ __forceinline__ void gather(const Col& c, const unsigned char* tab,
                                       bool in_smem) {
  const T* t = reinterpret_cast<const T*>(tab);
  T* out = static_cast<T*>(c.dst);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < c.n;
       i += stride) {
    int code = c.width == 1 ? (int)static_cast<const int8_t*>(c.src)[i]
                            : (int)static_cast<const int16_t*>(c.src)[i];
    code = min(max(code, 0), c.n_values - 1);
    out[i] = in_smem ? t[code] : __ldg(t + code);
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ Table tbl) {
  extern __shared__ __align__(16) unsigned char stab[];
  const Col& c = tbl.c[blockIdx.y];
  if (c.kind == 0) {
    const unsigned char* tab = static_cast<const unsigned char*>(c.values);
    if (c.smem) {
      const int nbytes = c.n_values * c.es;
      for (int b = threadIdx.x; b < nbytes; b += blockDim.x) stab[b] = tab[b];
      __syncthreads();
      tab = stab;
    }
    const bool sm = c.smem != 0;
    switch (c.es) {
      case 1: gather<uint8_t>(c, tab, sm); break;
      case 2: gather<uint16_t>(c, tab, sm); break;
      case 4: gather<uint32_t>(c, tab, sm); break;
      default: gather<unsigned long long>(c, tab, sm); break;
    }
    return;
  }
  const unsigned* words = static_cast<const unsigned*>(c.src);
  int* out = static_cast<int*>(c.dst);
  const int bits = c.width, lanes = 32 / bits;
  const unsigned mask = bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < c.n;
       i += stride) {
    const unsigned w = __ldg(words + i / lanes);
    out[i] = (int)((w >> (bits * (int)(i % lanes))) & mask);
  }
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
  long long n_max = 0;
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
    } else if (c.width < 1 || c.width > 32) {
      return (int)cudaErrorInvalidValue;
    }
    if (c.n > n_max) n_max = c.n;
  }
  if (n_max == 0) return 0;
  long long blocks = (n_max + kThreads * 8 - 1) / (kThreads * 8);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  decode_kernel<<<dim3((unsigned)blocks, M), kThreads, smem, s>>>(t);
  return (int)cudaGetLastError();
}

}  // extern "C"
