// SHA-256 (FIPS 180-4) of every shard row, for Hopper (sm_90a).
//
// Replaces chunky_bits_tpu/ops/sha256_jax.py (make_sha256_aligned,
// _build_sha256_fn, sha256_rows_device): the batched device SHA that the
// JAX backend fuses with the GF transform on its ingest dispatch.  Its
// host-built tail (_split_tail) and fori_loop layout worked around one JAX
// build; here the padding is done in the kernel and the digests are the
// same bytes.
//
// Rows come from up to two sources so the fused ingest hashes data and
// parity in one launch without concatenating them: ``a`` is u8[P, ga, S],
// ``b`` is u8[P, gb, S], and the digest of row j of part p lands at
// out[p, j, :] (j < ga) or out[p, ga + j', :] for row j' of ``b``, i.e.
// out is u8[P, ga + gb, 32].  Plain rows are P = N, ga = 1, gb = 0.
//
// Bound on an H100: SHA-256 is a dependent chain along each row, so the
// unit of parallel work is a row: one thread per row.  At the fused ingest
// shape (1,792 rows of 1 MiB) that is 56 warps for 132 SMs, each thread
// walking 16,385 compressions of 1,400 instructions (3-input LOP3 and
// IADD3, funnel shifts; sha256.OPS_PER_BLOCK): 4.1e10 int32 operations,
// ~2.5 ms at 132 SMs x 64 lanes x 1.98 GHz, against 1.88 GB of reads
// (~0.56 ms at 3.35 TB/s).  The
// kernel is latency-bound on that chain and is expected to be slow; the
// loads of block n+1 are issued before block n's compression to hide
// their latency.  Rotates are __funnelshift_r, constants in __constant__.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0u, 0x0123);
}

__device__ __forceinline__ void compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = hh + S1 + ch + kK[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

__global__ void __launch_bounds__(kThreads)
sha256_rows_kernel(const uint8_t* __restrict__ a, int ga,
                   const uint8_t* __restrict__ b, int gb, long long P,
                   long long S, int vec, uint8_t* __restrict__ out) {
  const int g = ga + gb;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= P * g) return;
  const long long part = t / g;
  const int j = static_cast<int>(t - part * g);
  const uint8_t* row = j < ga ? a + (part * ga + j) * S
                              : b + (part * gb + (j - ga)) * S;

  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  const long long full = S / 64;
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
    uint4 nxt[4];
    if (full > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) nxt[q] = p[q];
    }
    for (long long blk = 0; blk < full; ++blk) {
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[4 * q + 0] = bswap(nxt[q].x);
        w[4 * q + 1] = bswap(nxt[q].y);
        w[4 * q + 2] = bswap(nxt[q].z);
        w[4 * q + 3] = bswap(nxt[q].w);
      }
      if (blk + 1 < full) {
#pragma unroll
        for (int q = 0; q < 4; ++q) nxt[q] = p[(blk + 1) * 4 + q];
      }
      compress(h, w);
    }
  } else {
    for (long long blk = 0; blk < full; ++blk) {
      const uint8_t* p = row + blk * 64;
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        w[i] = (static_cast<uint32_t>(p[4 * i]) << 24) |
               (static_cast<uint32_t>(p[4 * i + 1]) << 16) |
               (static_cast<uint32_t>(p[4 * i + 2]) << 8) |
               static_cast<uint32_t>(p[4 * i + 3]);
      }
      compress(h, w);
    }
  }

  // FIPS 180-4 tail: the rem < 64 leftover bytes, 0x80, zeros, and the bit
  // length as a big-endian u64 closing the last block (one or two blocks)
  const long long rem = S - full * 64;
  const uint8_t* p = row + full * 64;
  const int nb = rem + 9 <= 64 ? 1 : 2;
  const unsigned long long bits = static_cast<unsigned long long>(S) * 8ull;
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pos = blk * 64 + 4 * i + q;
        const uint32_t byte = pos < rem ? p[pos] : (pos == rem ? 0x80u : 0u);
        word = (word << 8) | byte;
      }
      w[i] = word;
    }
    if (blk == nb - 1) {
      w[14] = static_cast<uint32_t>(bits >> 32);
      w[15] = static_cast<uint32_t>(bits);
    }
    compress(h, w);
  }

  uint8_t* o = out + t * 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[4 * i + 0] = static_cast<uint8_t>(h[i] >> 24);
    o[4 * i + 1] = static_cast<uint8_t>(h[i] >> 16);
    o[4 * i + 2] = static_cast<uint8_t>(h[i] >> 8);
    o[4 * i + 3] = static_cast<uint8_t>(h[i]);
  }
}

}  // namespace

// a: u8[P, ga, S]; b: u8[P, gb, S] (may be null when gb == 0);
// out: u8[P, ga + gb, 32].  Launches on ``stream``, allocates nothing, does
// not synchronise; returns cudaGetLastError() after the launch.
extern "C" int cb_sha256_rows(const void* a, int ga, const void* b, int gb,
                              long long P, long long S, void* out,
                              void* stream) {
  const long long n = P * (ga + gb);
  if (n <= 0) return 0;
  const bool vec = S % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   (gb == 0 || reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sha256_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), ga, static_cast<const uint8_t*>(b), gb,
      P, S, vec ? 1 : 0, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cb_sha256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
