// GF(2^8) bit-plane popcount accumulator for Hopper (sm_90a):
//     acc[b, bit*R + i, s] = sum_k sum_j bit_bit(T[i,k,j]) * bit_j(in[b,k,s])
// the raw counts before the mod 2 of the matrix apply, as int16 in the
// JAX package's bit-major row order (row bit*R + i is bit ``bit`` of
// output byte-row i).  T is the table K1 takes: T[i][k][j] = mat[i,k] (x)
// 2^j.  Counts from different column blocks of a matrix add, so a stripe
// split over ranks (the tp layout) sums its partials and packs once.
//
// Replaces chunky_bits_tpu/ops/pallas_kernels.py::_build_kernel
// (pack=False), reached through acc_m2_bitmajor: the per-device half of
// the contraction-sharded mesh encode (parallel/mesh.py::_wide_apply_fn).
//
// Bound on an H100: the bytes.  Each input byte is read once and 16 bytes
// are written per output byte-row and column (8 bit-rows of int16), so at
// one tp rank of BASELINE config 5 (8 parts, d/tp = 5 rows, p = 6, 4 MiB
// columns) the kernel moves 168 MB in and 3.2 GB out, ~1.0 ms at
// 3.35 TB/s; the int16 stores set the pace.  The bit-plane product behind
// it is 2 * 48 * 40 ops per column, 0.07 ms at the int8 tensor rate.
//
// Design (simple first): with W[o][k] the 8-bit mask whose bit j is bit
// ``bit`` of T[i][k][j] (o = bit*R + i), the count is
// sum_k popc(W[o][k] & x[k, s]).  Each block builds W for a tile of up to
// 64 output rows in shared memory, the byte repeated four times in a
// word.  A thread owns 8 adjacent columns of one part (two 32-bit words
// per input row, read through L1 for every output row) and counts the
// four columns of a word at once: AND with W, then a SWAR popcount per
// byte lane (each lane <= 8).  Byte lanes take up to 31 rows (<= 248)
// before they are widened into 16-bit lanes, which hold 8K <= 32760.
// Each output row's 8 counts leave as one 16-byte store.  A masked byte
// path covers S not a multiple of 8 and pointers not 8-byte aligned.  No
// tensor cores: ~12 integer ops per row, input row and 4 columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads per block, 8 columns each
constexpr int kTileRows = 64;     // output rows per block (gridDim.z)
constexpr int kByteLaneRows = 31; // input rows summed in 8-bit lanes

__device__ __forceinline__ uint32_t popc_bytes(uint32_t v) {
  v = v - ((v >> 1) & 0x55555555u);
  v = (v & 0x33333333u) + ((v >> 2) & 0x33333333u);
  return (v + (v >> 4)) & 0x0F0F0F0Fu;
}

__device__ __forceinline__ void load8(const uint8_t* p, long long rem,
                                      bool vec, uint32_t& a, uint32_t& c) {
  if (vec) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    a = v.x;
    c = v.y;
    return;
  }
  a = 0u;
  c = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < rem) a |= static_cast<uint32_t>(p[q]) << (8 * q);
    if (q + 4 < rem) c |= static_cast<uint32_t>(p[q + 4]) << (8 * q);
  }
}

__device__ __forceinline__ void store8(int16_t* p, long long rem, bool vec,
                                       const uint32_t w[4]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q < rem) {
      p[q] = static_cast<int16_t>(w[q / 2] >> (16 * (q % 2)));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gf_acc_kernel(const uint8_t* __restrict__ table,
              const uint8_t* __restrict__ in, int16_t* __restrict__ out,
              int B, int K, int R, long long S, int vec) {
  extern __shared__ uint32_t w[];  // [rows][K], mask byte repeated x4
  const int r8 = 8 * R;
  const int row0 = blockIdx.z * kTileRows;
  const int rows = min(kTileRows, r8 - row0);
  for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x) {
    const int o = row0 + idx / K;
    const int k = idx % K;
    const int bit = o / R;
    const uint8_t* t = table + (static_cast<size_t>(o % R) * K + k) * 8;
    uint32_t m = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) m |= ((t[j] >> bit) & 1u) << j;
    w[idx] = m * 0x01010101u;
  }
  __syncthreads();

  const long long s0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (s0 >= S) return;
  const long long rem = S - s0;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* src = in + b * K * S + s0;
    int16_t* dst = out + (b * r8 + row0) * S + s0;
    for (int o = 0; o < rows; ++o) {
      const uint32_t* wo = w + o * K;
      // 16-bit lanes: lo holds columns 0, 2 (and 4, 6), hi 1, 3 (5, 7)
      uint32_t lo0 = 0u, hi0 = 0u, lo1 = 0u, hi1 = 0u;
      for (int k0 = 0; k0 < K; k0 += kByteLaneRows) {
        const int k1 = min(K, k0 + kByteLaneRows);
        uint32_t acc0 = 0u, acc1 = 0u;
        for (int k = k0; k < k1; ++k) {
          uint32_t a, c;
          load8(src + k * S, rem, vec, a, c);
          const uint32_t m = wo[k];
          acc0 += popc_bytes(a & m);
          acc1 += popc_bytes(c & m);
        }
        lo0 += acc0 & 0x00FF00FFu;
        hi0 += (acc0 >> 8) & 0x00FF00FFu;
        lo1 += acc1 & 0x00FF00FFu;
        hi1 += (acc1 >> 8) & 0x00FF00FFu;
      }
      const uint32_t words[4] = {
          __byte_perm(lo0, hi0, 0x5410), __byte_perm(lo0, hi0, 0x7632),
          __byte_perm(lo1, hi1, 0x5410), __byte_perm(lo1, hi1, 0x7632)};
      store8(dst + o * S, rem, vec, words);
    }
  }
}

}  // namespace

// table: u8[R, K, 8] on the device; in: u8[B, K, S]; out: i16[B, 8R, S].
// K <= 4095 keeps every count inside its 16-bit lane.  Launches on
// ``stream``, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a K the
// lanes cannot hold).
extern "C" int cb_gf_acc(const void* table, const void* in, void* out,
                         int B, int K, int R, long long S, void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  if (K <= 0 || K > 4095) return static_cast<int>(cudaErrorInvalidValue);
  const int r8 = 8 * R;
  const int tile = r8 < kTileRows ? r8 : kTileRows;
  const size_t smem = static_cast<size_t>(tile) * K * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = S % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long chunks = (S + 7) / 8;
  const dim3 grid(static_cast<unsigned>((chunks + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B < 65535 ? B : 65535),
                  static_cast<unsigned>((r8 + kTileRows - 1) / kTileRows));
  gf_acc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(in),
      static_cast<int16_t*>(out), B, K, R, S, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cb_gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
