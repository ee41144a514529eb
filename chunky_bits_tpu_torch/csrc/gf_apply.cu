// GF(2^8) matrix apply for Hopper (sm_90a):
//     out[b, i, s] = XOR_k mat[i, k] (x) in[b, k, s]
// the ErasureBackend.apply_matrix contract, for Reed-Solomon encode (parity
// rows) and decode (host-inverted rows) alike.
//
// Replaces chunky_bits_tpu/ops/pallas_kernels.py::_build_kernel (pack=True),
// the fused TPU kernel that unpacks bytes to bit-planes, multiplies them by
// the 0/1 bit-matrix on the MXU and packs the mod-2 result.  Its bit-major
// layout and 128-lane tiles are the TPU's own and are not carried over.
//
// Bound on an H100: each input byte is read once and each output byte
// written once, so at d=10 p=4, 128 parts of 1 MiB chunks the kernel moves
// 1.34 GB in + 0.54 GB out = 1.88 GB, about 0.56 ms at 3.35 TB/s.  The
// arithmetic is R*K GF multiply-adds per byte column.
//
// Design (simple first): multiplying by a constant c is GF(2)-linear, so
// c (x) x = XOR over bits j of x of (c (x) 2^j).  The wrapper passes that
// table, T[i][k][j] = mat[i,k] (x) 2^j (R*K*8 bytes, 320 B at d=10 p=4), and
// each block copies it to shared memory.  A thread owns 16 consecutive bytes
// of one part (four 32-bit words, bit-sliced: bit j of each byte spread to a
// 0x00/0xFF byte mask) and builds kRows output rows at a time by AND/XOR of
// the broadcast table bytes, so every shared-memory read is a broadcast.
// Per input byte and output row: 8 table reads and about 8 logic ops per
// 4 bytes.  A masked byte path covers S not a multiple of 16 and pointers
// not 16-byte aligned.  No tensor cores, TMA or wgmma yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;       // output rows held in registers per pass
constexpr int kThreads = 256;  // threads per block, 16 bytes each

__device__ __forceinline__ void load16(const uint8_t* p, long long rem,
                                       bool vec, uint32_t w[4]) {
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pos = 4 * j + q;
      const uint32_t byte = pos < rem ? p[pos] : 0u;
      word |= byte << (8 * q);
    }
    w[j] = word;
  }
}

__device__ __forceinline__ void store16(uint8_t* p, long long rem, bool vec,
                                        const uint32_t w[4]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pos = 4 * j + q;
      if (pos < rem) p[pos] = static_cast<uint8_t>(w[j] >> (8 * q));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ table,
                const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int B, int K, int R, int Rp, long long S, int vec) {
  // table rows padded with zeros to a multiple of kRows
  extern __shared__ uint8_t st[];
  const int n = Rp * K * 8;
  const int live = R * K * 8;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    st[i] = i < live ? table[i] : 0;
  }
  __syncthreads();

  const long long s0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 16;
  if (s0 >= S) return;
  const long long rem = S - s0;
  const int row_stride = K * 8;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* src = in + b * K * S + s0;
    uint8_t* dst = out + b * R * S + s0;
    for (int r0 = 0; r0 < R; r0 += kRows) {
      uint32_t acc[kRows][4];
#pragma unroll
      for (int ri = 0; ri < kRows; ++ri) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ri][j] = 0u;
      }
      for (int k = 0; k < K; ++k) {
        uint32_t w[4];
        load16(src + k * S, rem, vec, w);
        const uint8_t* t = st + r0 * row_stride + k * 8;
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          uint32_t m[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            m[j] = ((w[j] >> bit) & 0x01010101u) * 0xFFu;
          }
#pragma unroll
          for (int ri = 0; ri < kRows; ++ri) {
            const uint32_t c = t[ri * row_stride + bit] * 0x01010101u;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[ri][j] ^= m[j] & c;
          }
        }
      }
#pragma unroll
      for (int ri = 0; ri < kRows; ++ri) {
        if (r0 + ri < R) store16(dst + (r0 + ri) * S, rem, vec, acc[ri]);
      }
    }
  }
}

}  // namespace

// table: u8[R, K, 8] on the device; in: u8[B, K, S]; out: u8[B, R, S].
// Launches on ``stream``, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int cb_gf_apply(const void* table, const void* in, void* out,
                           int B, int K, int R, long long S, void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  const int Rp = (R + kRows - 1) / kRows * kRows;
  const size_t smem = static_cast<size_t>(Rp) * K * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = S % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long chunks = (S + 15) / 16;
  const dim3 grid(static_cast<unsigned>((chunks + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B < 65535 ? B : 65535));
  gf_apply_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out), B, K, R, Rp, S, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cb_gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
