// GF(2^8) matrix apply for Hopper (sm_90a):
//     out[b, i, s] = XOR_k mat[i, k] (x) in[b, k, s]
// the ErasureBackend.apply_matrix contract, for Reed-Solomon encode (parity
// rows) and decode (host-inverted rows) alike.
//
// Replaces chunky_bits_tpu/ops/pallas_kernels.py::_build_kernel (pack=True),
// the fused TPU kernel that unpacks bytes to bit-planes, multiplies them by
// the 0/1 bit-matrix on the MXU and packs the mod-2 result.
//
// Bound on an H100: the bytes.  Each input byte is read once and each
// output byte written once, so at d=10 p=4, 128 parts of 1 MiB chunks the
// kernel moves 1.34 GB in + 0.54 GB out = 1.88 GB, 0.561 ms at 3.35 TB/s.
// The GF(2) product behind it, 8R x 8K bits per column, is 0.04 ms with
// its AND-POPC MACs at eight times the int8 tensor rate (a b1 mma takes
// k = 256 where an s8 one takes k = 32).  The design takes the per-bit work off the integer
// pipe so that the bytes, not the arithmetic, set the pace.
//
// Design: the product on the binary tensor cores.  Multiplying by a
// constant is GF(2)-linear, so bit b of output byte i is the parity of
// popc(W[(i, b)] & x), x being the column's 8K input bits and W the 0/1
// bit-matrix (row (i, b), column (k, j) = bit b of T[i][k][j], T the
// wrapper's table of mat[i, k] (x) 2^j: the rows of bit_matrix_bitmajor).
// One mma.sync.m16n8k256 .b1 and.popc takes 16 rows of W, 8 columns and
// 32 input rows (k = 8 * row + bit), so the data's own bytes are the B
// operand: the 32-bit register of one column and four input rows is those
// four bytes, put together by a 4 x 4 byte transpose (8 PRMTs for four
// columns).  Nothing is expanded bit by bit.
// * The weight.  A block builds the A fragments of its output rows from T
//   once, in shared memory in fragment order (16 bytes per lane, m-tile
//   and k-step of 32 input rows); with one k-step (K <= 32) a warp keeps
//   them in registers.  Row 16 mt + 8 h + g of a pass of 8 output
//   byte-rows is bit s + 4 (g / 4) of byte-row 4 (mt / 2) + g % 4, where
//   s = 2 (mt % 2) + h (tests/test_torch_gf.py models the same map), so
//   lane (g, t4) of the C fragment holds 4 of the 8 bits of its bytes and
//   lane g ^ 4 the other 4.  R <= 4 takes 2 m-tiles, R <= 8 takes 4, a
//   larger R one pass of 8 byte-rows per gridDim.z.
// * The columns.  A warp takes units of 256 columns of one part, stepping
//   over the parts without a division.  Lane (g, t4) loads 32 bytes at
//   column 32 g of input rows 4 t4 .. 4 t4 + 3 (and 16 + those when
//   K > 16); sub-unit v (0..7) uses word v, so n-tile q's column n is
//   data column 32 n + 4 v + q.  For K > 32 a sub-unit loads each
//   k-step's words as it uses them and reads that k-step's weight
//   fragments from shared memory.
// * The epilogue, per sub-unit and group of 4 byte-rows.  The counts of 4
//   n-tiles are packed into the bytes of one word by two saturating
//   cvt.pack conversions (a count is at most 8 K < 256 for K < 32; for
//   K >= 32 each count is masked to its parity first), masked to their
//   parities, shifted to their bit and added; one shuffle with lane ^ 16
//   swaps the half-bytes.  Each lane then holds 4 output bytes per
//   sub-unit, 32 contiguous bytes per unit, stored as two 16-byte words.
// Units of 256 columns (32 bytes a lane) were faster than units of 128
// and of 512.  Keeping the next unit's loads in flight (a second
// register set, or a cp.async ring in shared memory) and more warps per
// SM (fewer registers) were both slower on the card.
// A masked byte path (a template instance of its own) covers S not a
// multiple of 16 and pointers not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kUnitCols = 256;  // columns per warp unit
constexpr int kLaneCols = kUnitCols / 8;  // input columns a lane loads
constexpr int kVecs = kLaneCols / 16;     // its 16-byte words per row
constexpr int kPassRows = 8;    // output byte-rows per pass (gridDim.z)
constexpr int kMaxSteps = 8;    // k-steps of 32 input rows: K <= 255
constexpr int kMaxDevices = 64; // devices whose launch shape is cached

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// the 16 bytes at p (masked: rem bytes are in the row, none unless ok)
__device__ __forceinline__ uint4 load16(const uint8_t* p, long long rem,
                                        bool ok, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || rem <= 0) return v;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    if (x < rem) w[x / 4] |= static_cast<uint32_t>(p[x]) << (8 * (x % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 4 bytes at p (masked as load16)
__device__ __forceinline__ uint32_t load4(const uint8_t* p, long long rem,
                                          bool ok, bool vec) {
  if (!ok || rem <= 0) return 0u;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0u;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (x < rem) w |= static_cast<uint32_t>(p[x]) << (8 * x);
  }
  return w;
}

__device__ __forceinline__ void store16(uint8_t* p, long long rem, bool vec,
                                        const uint32_t w[4]) {
  if (rem <= 0) return;
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    if (x < rem) p[x] = static_cast<uint8_t>(w[x / 4] >> (8 * (x % 4)));
  }
}

// the low bytes of four counts below 256, as bytes 0..3 of one word
__device__ __forceinline__ uint32_t pack4(uint32_t c0, uint32_t c1,
                                          uint32_t c2, uint32_t c3) {
  uint32_t t, z;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(t) : "r"(c3), "r"(c2), "r"(0u));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(z) : "r"(c1), "r"(c0), "r"(t));
  return z;
}

// a warp's unit of work: part b, columns kUnitCols c .. kUnitCols (c + 1) - 1
struct Unit {
  long long b, c;
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// B fragments of four n-tiles from one word of four input rows: byte q of
// w[r] is column q of row r; B register q holds column q of rows 0..3
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&bq)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140u);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362u);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140u);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362u);
  bq[0] = __byte_perm(t0, t2, 0x5410u);
  bq[1] = __byte_perm(t0, t2, 0x7632u);
  bq[2] = __byte_perm(t1, t3, 0x5410u);
  bq[3] = __byte_perm(t1, t3, 0x7632u);
}

// kU: groups of 4 output byte-rows per pass (1 or 2), 2 kU m-tiles;
// kH: 1 (K <= 16) or 2 (K <= 32) halves of one k-step held in registers,
// a unit's words all loaded before its products; 0 (K > 32): the k-steps'
// words loaded as each sub-unit needs them
template <int kU, int kH, bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ table,
                const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int B, int K, int R, long long S) {
  constexpr int kMT = 2 * kU;
  constexpr int kHR = kH > 0 ? kH : 1;
  extern __shared__ uint4 a_s[];  // [m-tile][k-step][32 lanes]
  const int steps = (K + 31) / 32;
  const int byte0 = blockIdx.z * kPassRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int hi = g >> 2;

  // register q of lane (g, t4) holds row g + 8 (q % 2), bits 32 t4 ..
  // 32 t4 + 31 (+128 for q >= 2) of the k-step: input rows 4 t4 + x
  // (+16), bit j at bit 8 x + j
  for (int e = threadIdx.x; e < kMT * steps * 32; e += blockDim.x) {
    const int l = e & 31, ks = (e >> 5) % steps, mt = (e >> 5) / steps;
    const int lg = l >> 2, lt = l & 3;
    const int i = byte0 + 4 * (mt >> 1) + (lg & 3);
    uint32_t reg[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int bit = 2 * (mt & 1) + (q & 1) + 4 * (lg >> 2);
      uint32_t v = 0u;
      if (i < R) {
        for (int x = 0; x < 4; ++x) {
          const int k = 32 * ks + 4 * lt + 16 * (q >> 1) + x;
          if (k < K) {
            const uint8_t* t = table + (static_cast<size_t>(i) * K + k) * 8;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              v |= ((static_cast<uint32_t>(t[j]) >> bit) & 1u) << (8 * x + j);
            }
          }
        }
      }
      reg[q] = v;
    }
    a_s[e] = make_uint4(reg[0], reg[1], reg[2], reg[3]);
  }
  __syncthreads();

  uint4 a1[kMT];  // the one k-step's fragments (kH > 0)
  if (kH > 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) a1[mt] = a_s[mt * 32 + lane];
  }
  const bool upper = K > 16;   // rows 16..31 of a k-step are in use
  const bool mask = kH != 1 && K >= 32;  // counts may carry past a byte

  // a warp's units: part b, column chunk c; it steps by the grid's warps
  // without dividing (quotient and remainder of the step taken once)
  const long long chunks = (S + kUnitCols - 1) / kUnitCols;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long step_b = warps / chunks, step_c = warps % chunks;
  const long long first = static_cast<long long>(blockIdx.x) *
                              (blockDim.x >> 5) + (threadIdx.x >> 5);
  Unit at{first / chunks, first % chunks};
  auto next = [&](Unit x) {
    x.b += step_b;
    x.c += step_c;
    if (x.c >= chunks) {
      x.c -= chunks;
      ++x.b;
    }
    return x;
  };

  // input rows 16 h + 4 t4 + r of unit x, the lane's 32 columns at 32 g
  // (zero past the rows, the columns or the parts)
  auto load = [&](Unit x, uint4 (&raw)[kHR][4][kVecs]) {
    const long long col = x.c * kUnitCols + kLaneCols * g;
    const uint8_t* src = in + x.b * K * S + col;
#pragma unroll
    for (int h = 0; h < kHR; ++h) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 16 * h + 4 * t4 + r;
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          raw[h][r][j] = load16(src + static_cast<long long>(k) * S + 16 * j,
                                S - col - 16 * j, x.b < B && k < K, kVec);
        }
      }
    }
  };
  // unit x's products, parities and stores; fetch(ks, h, r, v) gives
  // word v of input row 32 ks + 16 h + 4 t4 + r
  auto unit = [&](Unit x, auto&& fetch) {
    uint32_t outw[kU][4 * kVecs];
#pragma unroll
    for (int v = 0; v < 4 * kVecs; ++v) {
      // B fragments of the k-steps: all of them in registers for one
      // k-step, else one k-step at a time inside the row groups
      uint32_t bq[2][4];
      auto fragments = [&](int ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h >= (kH > 0 ? kH : 2) || (h == 1 && !upper)) {
            bq[h][0] = bq[h][1] = bq[h][2] = bq[h][3] = 0u;
            continue;
          }
          uint32_t w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) w[r] = fetch(ks, h, r, v);
          transpose4(w, bq[h]);
        }
      };
      if (kH > 0) fragments(0);
#pragma unroll
      for (int gu = 0; gu < kU; ++gu) {
        int acc[2][4][4];  // m-tiles 2 gu, 2 gu + 1
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[m][q][0] = acc[m][q][1] = acc[m][q][2] = acc[m][q][3] = 0;
          }
        }
        for (int ks = 0; ks < (kH > 0 ? 1 : steps); ++ks) {
          if (kH == 0) fragments(ks);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int mt = 2 * gu + m;
            const uint4 a =
                kH > 0 ? a1[mt] : a_s[(mt * steps + ks) * 32 + lane];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              mma_b1(acc[m][q], a, bq[0][q], bq[1][q]);
            }
          }
        }
        // lane (g, t4): acc[m][q][2 h + e] is row 16 (2 gu + m) + 8 h + g,
        // column 2 t4 + e of n-tile q: bit s + 4 hi (s = 2 m + h) of
        // byte-row 4 gu + g % 4 at data column 16 (2 t4 + e) + 4 v + q
        uint32_t part[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t p = 0u;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t c[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              c[q] = static_cast<uint32_t>(acc[s >> 1][q][2 * (s & 1) + e]);
              if (mask) c[q] &= 1u;
            }
            const uint32_t z = pack4(c[0], c[1], c[2], c[3]);
            p += (z & 0x01010101u) << s;
          }
          part[e] = p << (4 * hi);
        }
        // lane g keeps the columns of e = hi; lane g ^ 4 has the other
        // half-bytes of the same byte-row and columns
        const uint32_t keep = hi ? part[1] : part[0];
        const uint32_t send = hi ? part[0] : part[1];
        outw[gu][v] = keep | __shfl_xor_sync(0xFFFFFFFFu, send, 16);
      }
    }
    const long long oc = x.c * kUnitCols + 2 * kLaneCols * t4 +
                         kLaneCols * hi;
#pragma unroll
    for (int gu = 0; gu < kU; ++gu) {
      const int i = byte0 + 4 * gu + (g & 3);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        if (i < R) {
          store16(out + (x.b * R + i) * S + oc + 16 * j, S - oc - 16 * j,
                  kVec, &outw[gu][4 * j]);
        }
      }
    }
  };

  if constexpr (kH > 0) {
    uint4 ra[kHR][4][kVecs];
    for (; at.b < B; at = next(at)) {
      load(at, ra);
      unit(at, [&](int, int h, int r, int v) {
        return word(ra[h][r][v >> 2], v & 3);
      });
    }
  } else {
    for (; at.b < B; at = next(at)) {
      const long long col = at.c * kUnitCols + kLaneCols * g;
      const uint8_t* src = in + at.b * K * S + col;
      unit(at, [&](int ks, int h, int r, int v) {
        const int k = 32 * ks + 16 * h + 4 * t4 + r;
        return load4(src + static_cast<long long>(k) * S + 4 * v,
                     S - col - 4 * v, k < K, kVec);
      });
    }
  }
}

template <int kU, int kH, bool kVec>
cudaError_t launch(const uint8_t* table, const uint8_t* in, uint8_t* out,
                   int B, int K, int R, long long S, cudaStream_t stream) {
  const int steps = (K + 31) / 32;
  const size_t smem = static_cast<size_t>(2 * kU) * steps * 32 * sizeof(uint4);
  // the card's SMs and the blocks an SM holds, asked once per device and
  // k-step count (a one-part launch is a few microseconds of card time)
  static int sms_of[kMaxDevices];
  static int per_sm_of[kMaxDevices][kMaxSteps + 1];
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if (dev < kMaxDevices && sms_of[dev] > 0 && per_sm_of[dev][steps] > 0) {
    sms = sms_of[dev];
    per_sm = per_sm_of[dev][steps];
  } else {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gf_apply_kernel<kU, kH, kVec>, kThreads, smem);
    if (e != cudaSuccess) return e;
    per_sm = per_sm > 0 ? per_sm : 1;
    if (dev < kMaxDevices) {
      sms_of[dev] = sms;
      per_sm_of[dev][steps] = per_sm;
    }
  }
  const long long units =
      static_cast<long long>(B) * ((S + kUnitCols - 1) / kUnitCols);
  const long long blocks_needed = (units + kThreads / 32 - 1) /
                                  (kThreads / 32);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const dim3 grid(
      static_cast<unsigned>(blocks_needed < slots ? blocks_needed : slots), 1,
      static_cast<unsigned>((R + kPassRows - 1) / kPassRows));
  gf_apply_kernel<kU, kH, kVec><<<grid, kThreads, smem, stream>>>(
      table, in, out, B, K, R, S);
  return cudaGetLastError();
}

// the instantiation for R and K: 4 or 8 byte-rows a pass, 1 or 2 halves
// of one k-step in registers (K <= 16, K <= 32) or k-steps loaded as they
// are used; the 16-byte path where S and both pointers allow it
template <bool kVec>
cudaError_t dispatch(const uint8_t* t, const uint8_t* x, uint8_t* o, int B,
                     int K, int R, long long S, cudaStream_t st) {
  const int h = K <= 16 ? 1 : K <= 32 ? 2 : 0;
  if (R <= 4) {
    return h == 1 ? launch<1, 1, kVec>(t, x, o, B, K, R, S, st)
           : h == 2 ? launch<1, 2, kVec>(t, x, o, B, K, R, S, st)
                    : launch<1, 0, kVec>(t, x, o, B, K, R, S, st);
  }
  return h == 1 ? launch<2, 1, kVec>(t, x, o, B, K, R, S, st)
         : h == 2 ? launch<2, 2, kVec>(t, x, o, B, K, R, S, st)
                  : launch<2, 0, kVec>(t, x, o, B, K, R, S, st);
}

}  // namespace

// table: u8[R, K, 8] on the device; in: u8[B, K, S]; out: u8[B, R, S].
// K <= 255.  Launches on ``stream``, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a K outside 1..255).
extern "C" int cb_gf_apply(const void* table, const void* in, void* out,
                           int B, int K, int R, long long S, void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  if (K <= 0 || K > 255) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* x = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = S % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return static_cast<int>(vec ? dispatch<true>(t, x, o, B, K, R, S, st)
                              : dispatch<false>(t, x, o, B, K, R, S, st));
}

extern "C" const char* cb_gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
