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
// unit of parallel work is a row, a lane each.  All lanes of the card
// busy, the fused ingest's 1,792 rows of 1 MiB (16,385 compressions of
// ~1,400 instructions each, sha256.OPS_PER_BLOCK) would take ~2.5 ms; but
// 1,792 rows fill only 56 warps, one per SM sub-partition at most, so
// what bounds the kernel is the instruction stream of the warp that runs
// the rounds: at most one instruction a cycle, and one ALU instruction
// every other cycle (the pipe is 16 lanes wide), ~1,550 cycles for a
// compression's 64 rounds as compiled here (chip_smoke.py reads them from
// the SASS).
//
// Design: warp specialisation.  A block of three warps serves 32 rows, a
// lane a row; the warps sit on different sub-partitions of the SM.
// * Two producers (warps 1 and 2, alternate message blocks) load each
//   row's blocks (16-byte loads, two of their blocks ahead in registers),
//   byte-swap them, expand the schedule W[16..63], add K[t], and write
//   the 64 words K[t] + W[t] of each row into a ring of shared-memory
//   slots, kSlots blocks deep, laid out [t/4][lane][4] so a lane reads
//   four words with one conflict-free 16-byte load.  One producer warp
//   alone is slower than the consumer.  The producers also build the
//   FIPS 180-4 tail blocks (the leftover bytes, 0x80, zeros and the bit
//   length; one or two blocks) and take unaligned rows byte by byte, so
//   the consumer has one path.
// * The consumer (warp 0) runs only the 64 rounds and the feed-forward.
//   A sub-partition's integer (ALU) pipe is 16 lanes wide, so a warp
//   issues an ALU instruction at most every other cycle, and the rounds'
//   rotates, XORs, Ch and Maj (10 a round) must go there.  The sum
//   d + h + K + W, off the chain, goes to the FMA pipe as IMAD
//   (x * one + y, ``one`` a kernel argument equal to 1, which the
//   compiler cannot fold), taking the ALU pipe's idle cycles; the adds
//   on the chain stay 3-input IADD3, whose latency is the shorter.
//   e' = (d + h + K + W) + Σ1 + Ch and a' = e' + Σ0 + (Maj - d), so each
//   chain is three deep a round.
// * The hand-off is two named barriers per slot: "full" (the producer
//   arrives, the consumer waits) and "empty" (the other way round).
// Named barriers 1..kSlots are "full", kSlots+1..2*kSlots "empty".

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

constexpr int kRows = 32;            // rows per block, a lane each
constexpr int kProducers = 2;        // producer warps, alternate blocks
constexpr int kThreads = 32 * (1 + kProducers);  // warp 0 consumer
constexpr int kSlots = 4;            // ring depth, in message blocks
constexpr int kSlotWords = 64 * kRows;
static_assert(kSlots % kProducers == 0, "a slot has one producer");

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0u, 0x0123);
}

// a + b on the FMA pipe (IMAD a * one + b; ``one`` is 1 but unknown to
// the compiler), leaving the ALU pipe to the rotates and logic ops
__device__ __forceinline__ uint32_t madd(uint32_t a, uint32_t b,
                                         uint32_t one) {
  return a * one + b;
}

// a slot's barriers join the consumer and the producer of the slot: 64
// threads (slot s is filled by producer s % kProducers)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// the producer's half of one message block: schedule, + K, into the slot
__device__ __forceinline__ void produce(uint32_t w[16], uint4* slot,
                                        int lane, uint32_t one) {
#pragma unroll
  for (int t4 = 0; t4 < 16; ++t4) {
    uint32_t kw[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = 4 * t4 + x;
      uint32_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        const uint32_t w15 = w[(t - 15) & 15];
        const uint32_t w2 = w[(t - 2) & 15];
        const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        wt = madd(madd(w[t & 15], s0, one), madd(w[(t - 7) & 15], s1, one),
                  one);
        w[t & 15] = wt;
      }
      kw[x] = madd(wt, kK[t], one);
    }
    slot[t4 * kRows + lane] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
  }
}

// message block ``blk`` of a row of S bytes that is not 16-byte aligned,
// or a tail block (blk >= S / 64), byte by byte with the FIPS padding
__device__ __forceinline__ void bytes_block(const uint8_t* row, long long S,
                                            long long blk, long long total,
                                            uint32_t w[16]) {
  const long long base = blk * 64;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long pos = base + 4 * i + q;
      const uint32_t byte =
          pos < S ? row[pos] : (pos == S ? 0x80u : 0u);
      word = (word << 8) | byte;
    }
    w[i] = word;
  }
  if (blk == total - 1) {
    const unsigned long long bits = static_cast<unsigned long long>(S) * 8ull;
    w[14] = static_cast<uint32_t>(bits >> 32);
    w[15] = static_cast<uint32_t>(bits);
  }
}

__global__ void __launch_bounds__(kThreads)
sha256_rows_kernel(const uint8_t* __restrict__ a, int ga,
                   const uint8_t* __restrict__ b, int gb, long long P,
                   long long S, int vec, uint32_t one,
                   uint8_t* __restrict__ out) {
  __shared__ uint4 ring[kSlots][kSlotWords / 4];
  const int g = ga + gb;
  const long long n = P * g;
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * kRows + lane;
  const long long full = S / 64;
  const long long total = (S + 9 + 63) / 64;  // blocks with the padding

  if (threadIdx.x >= 32) {
    // producer pr takes blocks pr, pr + kProducers, ...; a lane past the
    // last row hashes the last row again
    const int pr = (threadIdx.x >> 5) - 1;
    const long long r = t < n ? t : n - 1;
    const long long part = r / g;
    const int j = static_cast<int>(r - part * g);
    const uint8_t* row = j < ga ? a + (part * ga + j) * S
                                : b + (part * gb + (j - ga)) * S;
    const uint4* p = reinterpret_cast<const uint4*>(row);
    uint4 cur[4], nxt[4];  // the producer's next two full blocks
    if (vec) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (pr < full) cur[q] = p[pr * 4 + q];
        if (pr + kProducers < full) nxt[q] = p[(pr + kProducers) * 4 + q];
      }
    }
    for (long long blk = pr; blk < total; blk += kProducers) {
      uint32_t w[16];
      if (vec && blk < full) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[4 * q + 0] = bswap(cur[q].x);
          w[4 * q + 1] = bswap(cur[q].y);
          w[4 * q + 2] = bswap(cur[q].z);
          w[4 * q + 3] = bswap(cur[q].w);
          cur[q] = nxt[q];
        }
        if (blk + 2 * kProducers < full) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            nxt[q] = p[(blk + 2 * kProducers) * 4 + q];
          }
        }
      } else {
        bytes_block(row, S, blk, total, w);
      }
      const int s = static_cast<int>(blk % kSlots);
      if (blk >= kSlots) bar_sync(1 + kSlots + s);  // slot read out
      produce(w, ring[s], lane, one);
      bar_arrive(1 + s);  // slot full
    }
    return;
  }

  // consumer: the rounds
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  for (long long blk = 0; blk < total; ++blk) {
    const int s = static_cast<int>(blk % kSlots);
    bar_sync(1 + s);  // slot full
    const uint4* slot = ring[s];
    uint32_t A = h[0], B = h[1], C = h[2], D = h[3];
    uint32_t E = h[4], F = h[5], G = h[6], H = h[7];
#pragma unroll
    for (int t4 = 0; t4 < 16; ++t4) {
      const uint4 kw4 = slot[t4 * kRows + lane];
      const uint32_t kw[4] = {kw4.x, kw4.y, kw4.z, kw4.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        // d + h + K + W, off the chain, goes to the FMA pipe; the rest,
        // the rotates, XORs, Ch, Maj and the two chain adds, to the ALU
        // pipe: e' = (d + h + K + W) + s1 + ch and a' = e' + s0 + (maj - d)
        // are three deep after e and a
        const uint32_t dhk = madd(D, madd(H, kw[x], one), one);
        const uint32_t s1 = rotr(E, 6) ^ rotr(E, 11) ^ rotr(E, 25);
        const uint32_t ch = (E & F) ^ (~E & G);
        const uint32_t s0 = rotr(A, 2) ^ rotr(A, 13) ^ rotr(A, 22);
        const uint32_t maj = (A & B) ^ (A & C) ^ (B & C);
        const uint32_t md = maj - D;
        H = G; G = F; F = E; E = dhk + s1 + ch;
        D = C; C = B; B = A; A = E + s0 + md;
      }
    }
    if (blk + kSlots < total) bar_arrive(1 + kSlots + s);  // slot read out
    h[0] += A; h[1] += B; h[2] += C; h[3] += D;
    h[4] += E; h[5] += F; h[6] += G; h[7] += H;
  }
  if (t < n) {
    uint4* o = reinterpret_cast<uint4*>(out + t * 32);
    o[0] = make_uint4(bswap(h[0]), bswap(h[1]), bswap(h[2]), bswap(h[3]));
    o[1] = make_uint4(bswap(h[4]), bswap(h[5]), bswap(h[6]), bswap(h[7]));
  }
}

}  // namespace

// a: u8[P, ga, S]; b: u8[P, gb, S] (may be null when gb == 0);
// out: u8[P, ga + gb, 32], 16-byte aligned.  Launches on ``stream``,
// allocates nothing, does not synchronise; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a misaligned ``out``).
extern "C" int cb_sha256_rows(const void* a, int ga, const void* b, int gb,
                              long long P, long long S, void* out,
                              void* stream) {
  const long long n = P * (ga + gb);
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = S % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   (gb == 0 || reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  sha256_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), ga, static_cast<const uint8_t*>(b), gb,
      P, S, vec ? 1 : 0, 1u, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cb_sha256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
