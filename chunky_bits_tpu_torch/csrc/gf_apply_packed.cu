// GF(2^8) matrix apply on the int8 tensor cores, for Hopper (sm_90a):
//     out[b, i, s] = XOR_k mat[i, k] (x) in[b, k, s]
// byte-identical to gf_apply.cu at every geometry the field-multiplexed form
// takes: 0 < R <= 8, 0 < K <= 15, S % 256 == 0 (gf_kernel.packed_geometry_ok).
//
// Replaces chunky_bits_tpu/ops/pallas_kernels.py::_build_packed_kernel, the
// TPU kernel that packs two data columns into one int8 bit-plane element (at
// bits 0 and 6) and splits the contraction of the bit-matrix product in two
// halves with a block-diagonal weight [2*8R, 8K], so that each 6-bit field
// holds a popcount of at most ceil(8K/2) <= 60 and the two fields never
// carry into each other inside the int32 sum.
//
// Bound on an H100 at [128, 10, 1 MiB] -> [128, 4, 1 MiB] (encode, and the
// 4-erasure decode, which has the same shape): the same bytes as K1, 1.34 GB
// read and 0.54 GB written, 1.88 GB, 0.561 ms at 3.35 TB/s.  Its tensor
// work, the block-diagonal product [64, 80] x [80, S/2] per part zeros
// included, is 6.9e11 int8 ops, 0.35 ms at 1,979 TOP/s.  Bytes bound it.
//
// Design: every operand of the product stays in registers, so nothing but
// the weight crosses shared memory.
// * The weight.  Output byte row i has its own 16-row tile: rows 0-7 are
//   its eight bits over the first half of the contraction (bit-plane rows
//   kk < 4K), rows 8-15 the same bits over the second half.  Bit b of
//   row i, contraction row kk = 8k + j, is bit b of T[i][k][j] =
//   mat[i,k] (x) 2^j.  A block lays the tiles out once, zero-padded to
//   k-steps of 32, in the order of the m16n8k32 A fragment, so a lane
//   fetches its four registers with one 16-byte load.
// * The bit-planes.  A warp takes 64 bytes of every shard row of one part,
//   four column blocks of 16 bytes, each one n=8 tile: packed column g of
//   a block is its bytes 2g (at bit 0) and 2g+1 (at bit 6).  Lane (g, t4)
//   of the B fragment holds contraction rows 4*t4 .. 4*t4+3 of a k-step,
//   that is bit-planes j0 .. j0+3 of one shard row, so it loads the two
//   bytes of its column and spreads four bits of each into four int8
//   elements with one multiply and a mask.
// * The product.  mma.sync m16n8k32 s8 x s8 -> s32, one per output row,
//   block and k-step; the sums stay in the accumulator registers.
// * The fields.  Accumulators c0 and c2 of lane (g, t4) are the two
//   contraction halves of bit g of packed column 2*t4 (c1, c3 of 2*t4+1),
//   so (c0 ^ c2) gives bit g of output bytes 4*t4 (bit 0) and 4*t4+1
//   (bit 6), and (c1 ^ c3) those of 4*t4+2 and 4*t4+3.  Three shuffles OR
//   the eight bits of a byte together across the lanes of one t4, and
//   lane g = 0 stores four output bytes.
// Where it falls short of the bound: the two-byte loads and the bit
// spreading are many instructions per byte, and the product does eight
// times the ops of the GF arithmetic itself; wgmma, TMA and wider loads
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kMaxR = 8;                  // output rows, the gate's largest
constexpr int kMaxSteps = 4;              // k-steps of 32 at the gate's K=15
constexpr int kBlocks = 4;                // n=8 column blocks per warp unit
constexpr int kUnitBytes = kBlocks * 16;  // bytes of a row per warp unit

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// bits 0..3 of x to bits 0, 8, 16, 24
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
gf_apply_packed_kernel(const uint8_t* __restrict__ table,
                       const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int B, int K, int R,
                       long long S, int vec) {
  extern __shared__ uint4 a_s[];  // [R][steps][32 lanes]
  const int K8 = 8 * K, kc = 4 * K;  // kc: the contraction split
  const int steps = (K8 + 31) / 32;
  // the weight in A-fragment order: register q of lane (g, t4) holds rows
  // g (q even) or g+8 (q odd), contraction columns 4*t4 .. 4*t4+3 (+16 for
  // q >= 2) of the k-step
  for (int e = threadIdx.x; e < R * steps * 32; e += blockDim.x) {
    const int l = e & 31, ks = (e >> 5) % steps, i = (e >> 5) / steps;
    const int g = l >> 2, t4 = l & 3;
    uint32_t reg[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = g + ((q & 1) ? 8 : 0);
      const int c0 = ks * 32 + t4 * 4 + ((q & 2) ? 16 : 0);
      uint32_t v = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int kk = c0 + x;
        if (kk < K8 && (r >= 8) == (kk >= kc)) {
          v |= ((table[(i * K + (kk >> 3)) * 8 + (kk & 7)] >> (r & 7)) & 1u)
               << (8 * x);
        }
      }
      reg[q] = v;
    }
    a_s[e] = make_uint4(reg[0], reg[1], reg[2], reg[3]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int j0 = (t4 & 1) * 4;  // first bit-plane of the lane's B rows
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long chunks = S / kUnitBytes;
  const long long units = chunks * B;
  for (long long u = static_cast<long long>(blockIdx.x) *
                         (blockDim.x >> 5) + (threadIdx.x >> 5);
       u < units; u += warps) {
    const long long b = u / chunks;
    const long long s0 = (u % chunks) * kUnitBytes;
    const uint8_t* src = in + b * K * S + s0;
    uint8_t* dst = out + b * R * S + s0;
    // every load of the unit first, so they are in flight together; B
    // register h of k-step ks covers shard row 4*ks + 2*h + t4/2
    uint32_t raw[kBlocks][kMaxSteps][2];
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
#pragma unroll
      for (int ks = 0; ks < kMaxSteps; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = ks * 4 + h * 2 + (t4 >> 1);
          uint32_t v = 0;
          if (ks < steps && k < K) {
            const uint8_t* p = src + k * S + 16 * nb + 2 * g;
            v = vec ? *reinterpret_cast<const uint16_t*>(p)
                    : (static_cast<uint32_t>(p[0]) |
                       (static_cast<uint32_t>(p[1]) << 8));
          }
          raw[nb][ks][h] = v;
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      int acc[kMaxR][4];
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
      }
#pragma unroll
      for (int ks = 0; ks < kMaxSteps; ++ks) {
        if (ks < steps) {
          uint32_t bf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t v = raw[nb][ks][h];
            bf[h] = spread4((v >> j0) & 15u) |
                    (spread4((v >> (8 + j0)) & 15u) << 6);
          }
#pragma unroll
          for (int i = 0; i < kMaxR; ++i) {
            if (i < R) {
              mma_s8(acc[i], a_s[(i * steps + ks) * 32 + lane], bf[0], bf[1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < R) {
          const uint32_t x0 = static_cast<uint32_t>(acc[i][0] ^ acc[i][2]);
          const uint32_t x1 = static_cast<uint32_t>(acc[i][1] ^ acc[i][3]);
          uint32_t v = ((x0 & 1u) | (((x0 >> 6) & 1u) << 8) |
                        ((x1 & 1u) << 16) | (((x1 >> 6) & 1u) << 24))
                       << g;
          v |= __shfl_xor_sync(0xffffffffu, v, 4);
          v |= __shfl_xor_sync(0xffffffffu, v, 8);
          v |= __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) {
            uint8_t* p = dst + i * S + 16 * nb + 4 * t4;
            if (vec) {
              *reinterpret_cast<uint32_t*>(p) = v;
            } else {
              p[0] = static_cast<uint8_t>(v);
              p[1] = static_cast<uint8_t>(v >> 8);
              p[2] = static_cast<uint8_t>(v >> 16);
              p[3] = static_cast<uint8_t>(v >> 24);
            }
          }
        }
      }
    }
  }
}

}  // namespace

// table: u8[R, K, 8] on the device; in: u8[B, K, S]; out: u8[B, R, S].
// Refuses geometries outside 0 < R <= 8, 0 < K <= 15, S % 256 == 0 with
// cudaErrorInvalidValue.  Launches on ``stream``, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch.
extern "C" int cb_gf_apply_packed(const void* table, const void* in,
                                  void* out, int B, int K, int R,
                                  long long S, void* stream) {
  if (R <= 0 || R > kMaxR || K <= 0 || K > 15 || S < 0 || S % 256 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || S == 0) return 0;
  const int steps = (8 * K + 31) / 32;
  const size_t smem = static_cast<size_t>(R) * steps * 32 * sizeof(uint4);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gf_apply_packed_kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long warps_needed =
      static_cast<long long>(B) * (S / kUnitBytes);
  const long long blocks_needed = (warps_needed + kThreads / 32 - 1) /
                                  (kThreads / 32);
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(
      blocks_needed < slots ? blocks_needed : slots);
  const bool vec = reinterpret_cast<uintptr_t>(in) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  gf_apply_packed_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out), B, K, R, S, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cb_gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
