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
// Design: the count is the int8 product M2 @ bits on the tensor cores,
// A = M2 [8R x 8K] (0/1, columns k*8 + j) and B = the data's bit-planes,
// one mma.sync.m16n8k32 s8 x s8 -> s32 per 16 output rows, 8 columns and
// 4 input rows.
// * The weight.  A block lays out the A fragments of its (up to) 64
//   output rows once, zero-padded to 16 rows and to k-steps of 4 input
//   rows, in shared memory in fragment order (one 16-byte load per lane
//   and mma), as gf_apply_packed.cu does.  K beyond 128 rows is taken in
//   chunks of 32 k-steps, each chunk adding its counts to the output.
// * The bit-planes.  A warp takes 32 columns of one part: four n=8 tiles,
//   tile q's column n being data column 8*(n/2) + 2q + n%2.  Lane (g, t4)
//   of the B fragment then needs bytes 2q + g%2 of the 8-byte group g/2:
//   one 8-byte load per input row, a byte permute for its four bytes, and
//   per tile one multiply and a mask to spread four bits of a byte into
//   four int8 elements.  Each input byte is loaded once per column tile,
//   not once per output row, and each B fragment serves every row tile.
//   The loads of up to 6 k-steps (24 input rows) are issued together, so
//   a unit waits for device memory once, not once per k-step.
// * The stores.  With that column order, lane (g, t4) holds the counts of
//   8 adjacent columns, 8*t4 .. 8*t4 + 7, of rows g and g + 8: one
//   16-byte int16 store each, the four lanes of a row covering 64
//   contiguous bytes.  The int32 sums (<= 8K <= 32760) become int16 with
//   one byte permute per pair.
// A masked byte path covers S not a multiple of 8 and pointers not 8-byte
// (output: 16-byte) aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kTileRows = 64;    // output rows per block (gridDim.z)
constexpr int kRowTiles = kTileRows / 16;
constexpr int kTiles = 4;        // n=8 column tiles per warp unit
constexpr int kUnitCols = 8 * kTiles;
constexpr int kChunkSteps = 32;  // k-steps (4 input rows each) per chunk
constexpr int kLoadSteps = 6;    // k-steps whose loads are issued together

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// bits 0..3 of x (x < 16) to bits 0, 8, 16, 24
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x204081u) & 0x01010101u;
}

// the 8 bytes at p (masked: rem bytes are in the row, none unless ok)
__device__ __forceinline__ uint2 load8(const uint8_t* p, long long rem,
                                       bool ok, bool vec) {
  uint2 v = make_uint2(0u, 0u);
  if (ok && rem > 0) {
    if (vec) return *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < rem) v.x |= static_cast<uint32_t>(p[q]) << (8 * q);
      if (q + 4 < rem) v.y |= static_cast<uint32_t>(p[q + 4]) << (8 * q);
    }
  }
  return v;
}

// the lane's four bytes (2q + odd for q = 0..3) of an 8-byte group, at the
// lane's four bit-planes j0 .. j0+3 (the low nibble of each byte)
__device__ __forceinline__ uint32_t nibbles(uint2 v, uint32_t sel, int j0) {
  return (__byte_perm(v.x, v.y, sel) >> j0) & 0x0F0F0F0Fu;
}

// kRT: row tiles of 16 the block holds accumulators for (1..kRowTiles)
template <int kRT>
__global__ void __launch_bounds__(kThreads)
gf_acc_kernel(const uint8_t* __restrict__ table,
              const uint8_t* __restrict__ in, int16_t* __restrict__ out,
              int B, int K, int R, long long S, int vec) {
  extern __shared__ uint4 a_s[];  // [row tile][k-step of chunk][32 lanes]
  const int r8 = 8 * R;
  const int row0 = blockIdx.z * kTileRows;
  const int tiles = min(kRT, (r8 - row0 + 15) / 16);
  const int steps = (K + 3) / 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int j0 = (t4 & 1) * 4;
  const uint32_t sel = (g & 1) ? 0x7531u : 0x6420u;
  const long long chunks = (S + kUnitCols - 1) / kUnitCols;
  const long long units = chunks * B;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);

  for (int c0 = 0; c0 < steps; c0 += kChunkSteps) {
    const int cs = min(kChunkSteps, steps - c0);
    __syncthreads();  // the previous chunk's weight is no longer read
    // register q of lane (g, t4) holds rows g (q even) or g+8 (q odd),
    // contraction columns 4*t4 .. 4*t4+3 (+16 for q >= 2) of the k-step;
    // contraction column c is bit c%8 of input row c/8
    for (int e = threadIdx.x; e < tiles * cs * 32; e += blockDim.x) {
      const int l = e & 31, ks = (e >> 5) % cs, mt = (e >> 5) / cs;
      const int lg = l >> 2, lt = l & 3;
      uint32_t reg[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = row0 + mt * 16 + lg + ((q & 1) ? 8 : 0);
        const int c = (c0 + ks) * 32 + lt * 4 + ((q & 2) ? 16 : 0);
        uint32_t v = 0;
        if (o < r8) {
          const int bit = o / R, i = o % R;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int k = (c + x) >> 3, j = (c + x) & 7;
            if (k < K) {
              v |= ((table[(static_cast<size_t>(i) * K + k) * 8 + j] >> bit)
                    & 1u) << (8 * x);
            }
          }
        }
        reg[q] = v;
      }
      a_s[e] = make_uint4(reg[0], reg[1], reg[2], reg[3]);
    }
    __syncthreads();

    for (long long u = static_cast<long long>(blockIdx.x) *
                           (blockDim.x >> 5) + (threadIdx.x >> 5);
         u < units; u += warps) {
      const long long b = u / chunks;
      const long long s0 = (u % chunks) * kUnitCols;
      const long long col = s0 + 8 * (g >> 1);  // the lane's 8-byte group
      const uint8_t* src = in + b * K * S + col;
      int acc[kRT][kTiles][4];
#pragma unroll
      for (int mt = 0; mt < kRT; ++mt) {
#pragma unroll
        for (int q = 0; q < kTiles; ++q) {
          acc[mt][q][0] = acc[mt][q][1] = acc[mt][q][2] = acc[mt][q][3] = 0;
        }
      }
      // B register h of k-step ks covers input row 4*ks + 2*h + t4/2; the
      // loads of up to kLoadSteps k-steps are in flight together
      for (int kb = 0; kb < cs; kb += kLoadSteps) {
        uint2 raw[kLoadSteps][2];
#pragma unroll
        for (int ks = 0; ks < kLoadSteps; ++ks) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 4 * (c0 + kb + ks) + 2 * h + (t4 >> 1);
            raw[ks][h] = load8(src + static_cast<long long>(k) * S, S - col,
                               kb + ks < cs && k < K, vec);
          }
        }
#pragma unroll
        for (int ks = 0; ks < kLoadSteps; ++ks) {
          if (kb + ks < cs) {
            const uint32_t n0 = nibbles(raw[ks][0], sel, j0);
            const uint32_t n1 = nibbles(raw[ks][1], sel, j0);
            uint32_t bf[kTiles][2];
#pragma unroll
            for (int q = 0; q < kTiles; ++q) {
              bf[q][0] = spread4(__byte_perm(n0, 0u, 0x4440u | q));
              bf[q][1] = spread4(__byte_perm(n1, 0u, 0x4440u | q));
            }
#pragma unroll
            for (int mt = 0; mt < kRT; ++mt) {
              if (mt < tiles) {
                const uint4 a = a_s[(mt * cs + kb + ks) * 32 + lane];
#pragma unroll
                for (int q = 0; q < kTiles; ++q) {
                  mma_s8(acc[mt][q], a, bf[q][0], bf[q][1]);
                }
              }
            }
          }
        }
      }
      // lane (g, t4) holds rows g (c0, c1) and g+8 (c2, c3) at columns
      // 8*t4 + 2q (c0, c2) and 8*t4 + 2q + 1 (c1, c3) of the unit
      const long long oc = s0 + 8 * t4;
      const long long rem = S - oc;
#pragma unroll
      for (int mt = 0; mt < kRT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + mt * 16 + g + 8 * h;
          if (mt < tiles && row < r8 && rem > 0) {
            uint32_t w[kTiles];
#pragma unroll
            for (int q = 0; q < kTiles; ++q) {
              w[q] = __byte_perm(static_cast<uint32_t>(acc[mt][q][2 * h]),
                                 static_cast<uint32_t>(acc[mt][q][2 * h + 1]),
                                 0x5410u);
            }
            int16_t* dst = out + (b * r8 + row) * S + oc;
            if (vec) {
              uint4* p = reinterpret_cast<uint4*>(dst);
              if (c0 > 0) {  // a later chunk adds to the earlier counts
                const uint4 old = *p;
                w[0] = __vadd2(w[0], old.x);
                w[1] = __vadd2(w[1], old.y);
                w[2] = __vadd2(w[2], old.z);
                w[3] = __vadd2(w[3], old.w);
              }
              *p = make_uint4(w[0], w[1], w[2], w[3]);
            } else {
#pragma unroll
              for (int x = 0; x < 8; ++x) {
                if (x < rem) {
                  int16_t v = static_cast<int16_t>(w[x / 2] >> (16 * (x % 2)));
                  if (c0 > 0) v = static_cast<int16_t>(v + dst[x]);
                  dst[x] = v;
                }
              }
            }
          }
        }
      }
    }
  }
}

// table: u8[R, K, 8] on the device; in: u8[B, K, S]; out: i16[B, 8R, S].
// K <= 4095 keeps every count inside int16.  Launches on ``stream``,
// allocates nothing, does not synchronise; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a K int16 cannot hold).
template <int kRT>
cudaError_t launch(const uint8_t* table, const uint8_t* in, int16_t* out,
                   int B, int K, int R, long long S, cudaStream_t stream) {
  const int r8 = 8 * R;
  const int steps = (K + 3) / 4;
  const int cs = steps < kChunkSteps ? steps : kChunkSteps;
  const size_t smem = static_cast<size_t>(kRT) * cs * 32 * sizeof(uint4);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gf_acc_kernel<kRT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gf_acc_kernel<kRT>, kThreads, smem);
  if (e != cudaSuccess) return e;
  const bool vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(in) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long units =
      static_cast<long long>(B) * ((S + kUnitCols - 1) / kUnitCols);
  const long long blocks_needed = (units + kThreads / 32 - 1) /
                                  (kThreads / 32);
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(
      static_cast<unsigned>(blocks_needed < slots ? blocks_needed : slots), 1,
      static_cast<unsigned>((r8 + kTileRows - 1) / kTileRows));
  gf_acc_kernel<kRT><<<grid, kThreads, smem, stream>>>(table, in, out, B, K,
                                                       R, S, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// table: u8[R, K, 8] on the device; in: u8[B, K, S]; out: i16[B, 8R, S].
// K <= 4095 keeps every count inside int16.  Launches on ``stream``,
// allocates nothing, does not synchronise; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a K int16 cannot hold).
extern "C" int cb_gf_acc(const void* table, const void* in, void* out,
                         int B, int K, int R, long long S, void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  if (K <= 0 || K > 4095) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* x = static_cast<const uint8_t*>(in);
  auto* o = static_cast<int16_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  // a block's accumulators cover its rows: 8R rows in tiles of 16
  switch (8 * R >= kTileRows ? kRowTiles : (8 * R + 15) / 16) {
    case 1: return static_cast<int>(launch<1>(t, x, o, B, K, R, S, st));
    case 2: return static_cast<int>(launch<2>(t, x, o, B, K, R, S, st));
    case 3: return static_cast<int>(launch<3>(t, x, o, B, K, R, S, st));
    default: return static_cast<int>(launch<4>(t, x, o, B, K, R, S, st));
  }
}

extern "C" const char* cb_gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
