// Native GF(2^8) erasure codec + SHA-256 hashing engine — the host codec
// of chunky_bits_tpu_torch (ops/cpu_backend.py builds it with g++ and binds
// it with ctypes; it is host C++, not a CUDA kernel).
//
// Same role as the reference's `reed-solomon-erasure` crate plus its `sha2`
// dependency (CPU SIMD GF(2^8) tables: Cargo.toml:21, used at
// src/file/file_part.rs:161,302; per-shard SHA-256: file_part.rs:185):
// applies a GF(2^8) matrix to a batch of stacked shards, and content-hashes
// shards.  Field is 0x11d with generator 2, identical to
// chunky_bits_tpu_torch/ops/gf256.py — the Python side cross-checks the tables at
// load time, and tests cross-check SHA-256 against hashlib.
//
// The GF inner loop dispatches at runtime: on GFNI+AVX-512 hosts a single
// gf2p8affineqb applies the 8x8 bit-matrix of "multiply by c" to 64 bytes
// per instruction (the constant-multiplier map is GF(2)-linear, so it works
// for the 0x11d field even though the ISA's gf2p8mulb is hardwired to the
// AES polynomial); otherwise the classic nibble-table pshufb trick under
// AVX2 (c*x = T_c[x>>4 << 4] ^ T_c[x&15]); full-table scalar elsewhere.
// The GFNI path self-verifies against the scalar tables at startup and
// disables itself on any mismatch.  SHA-256 uses the SHA-NI extension when
// the CPU has it (runtime dispatch) and a portable scalar path otherwise.
// `cb_encode_hash` fuses parity + per-shard hashing in one pass per batch
// item while the shard bytes are cache-hot.  Batch items are fanned across
// std::threads.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__) || defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

uint8_t MUL[256][256];

bool init_tables() {
    uint8_t exp_t[512];
    int log_t[256] = {0};
    int x = 1;
    for (int i = 0; i < 255; i++) {
        exp_t[i] = static_cast<uint8_t>(x);
        log_t[x] = i;
        x <<= 1;
        if (x & 0x100) x ^= 0x11d;
    }
    for (int i = 255; i < 512; i++) exp_t[i] = exp_t[i - 255];
    for (int a = 0; a < 256; a++) {
        for (int b = 0; b < 256; b++) {
            MUL[a][b] = (a && b)
                ? exp_t[(log_t[a] + log_t[b]) % 255]
                : 0;
        }
    }
    return true;
}

const bool kInited = init_tables();

// ---- GFNI path: multiply-by-c as an 8x8 GF(2) affine transform ----
//
// gf2p8affineqb computes out_bit[i] = parity(A.byte[7-i] & x) per data
// byte (empirically probed + verified on this convention), so the matrix
// qword for constant c packs bit (7-k) of c*2^j at byte k, bit j.

// Compiler gate, not just arch: the GFNI intrinsics + target attribute
// need GCC 10 / clang 10 here — on older toolchains the whole GFNI
// block must vanish or the native build fails (and the `native`
// backend raises).  Runtime detection of the GFNI
// *feature* goes through raw CPUID below, because
// __builtin_cpu_supports("gfni") itself only parses from GCC 11.
#if defined(__x86_64__) && \
    ((defined(__clang__) && __clang_major__ >= 10) || \
     (!defined(__clang__) && defined(__GNUC__) && __GNUC__ >= 10))
#define CB_HAVE_GFNI 1
#endif

#ifdef CB_HAVE_GFNI
#include <cpuid.h>
bool cpu_has_gfni() {
    unsigned int eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    return (ecx >> 8) & 1u;  // CPUID.(7,0):ECX.GFNI[bit 8]
}

uint64_t GFNI_MAT[256];

uint64_t gfni_matrix(uint8_t c) {
    uint8_t col[8];
    for (int j = 0; j < 8; j++) col[j] = MUL[c][1 << j];
    uint64_t a = 0;
    for (int k = 0; k < 8; k++) {
        uint8_t row = 0;
        for (int j = 0; j < 8; j++)
            row |= static_cast<uint8_t>(((col[j] >> (7 - k)) & 1) << j);
        a |= static_cast<uint64_t>(row) << (8 * k);
    }
    return a;
}

__attribute__((target("avx512f,avx512bw,avx512vl,gfni")))
bool gfni_self_test() {
    // spot-verify the instruction semantics against the scalar tables;
    // a convention mismatch (or emulator quirk) disables the path
    const uint8_t cs[] = {1, 2, 3, 0x1d, 0x53, 0x8e, 0xff};
    for (uint8_t c : cs) {
        __m128i a = _mm_set1_epi64x(
            static_cast<long long>(GFNI_MAT[c]));
        for (int x = 0; x < 256; x += 17) {
            __m128i v = _mm_set1_epi8(static_cast<char>(x));
            __m128i r = _mm_gf2p8affine_epi64_epi8(v, a, 0);
            if (static_cast<uint8_t>(_mm_extract_epi8(r, 0))
                    != MUL[c][x])
                return false;
        }
    }
    return true;
}

bool init_gfni() {
    // avx512* go through the builtin (it checks OS XSAVE state too, and
    // those names parse on every toolchain that passed the gate above);
    // only "gfni" needs the raw-CPUID fallback.
    if (!(__builtin_cpu_supports("avx512f")
          && __builtin_cpu_supports("avx512bw")
          && __builtin_cpu_supports("avx512vl")
          && cpu_has_gfni()))
        return false;
    for (int c = 0; c < 256; c++)
        GFNI_MAT[c] = gfni_matrix(static_cast<uint8_t>(c));
    return gfni_self_test();
}

const bool kGfni = init_gfni();

__attribute__((target("avx512f,avx512bw,avx512vl,gfni")))
size_t mul_row_xor_gfni(uint8_t c, const uint8_t* src, uint8_t* dst,
                        size_t n) {
    __m512i a = _mm512_set1_epi64(static_cast<long long>(GFNI_MAT[c]));
    size_t i = 0;
    for (; i + 64 <= n; i += 64) {
        __m512i v = _mm512_loadu_si512(src + i);
        __m512i r = _mm512_gf2p8affine_epi64_epi8(v, a, 0);
        __m512i d = _mm512_loadu_si512(dst + i);
        _mm512_storeu_si512(dst + i, _mm512_xor_si512(d, r));
    }
    return i;  // caller finishes the tail with the scalar table
}
#else
const bool kGfni = false;
size_t mul_row_xor_gfni(uint8_t, const uint8_t*, uint8_t*, size_t) {
    return 0;
}
#endif

// ---- runtime GF table-tier selection ----
//
// The byte-level table kernels come in three tiers: GFNI (2), AVX2
// nibble-pshufb (1, only when the build compiled AVX2 in), scalar
// full-table (0).  The active tier is runtime-selectable so the
// config-12 A/B (chip_smoke.py's host_codec group) can A/B the scheduled-XOR engine against every tier a
// deployment might actually run (a generic -O3 fallback build has no
// pshufb path at all), and tests can pin the scalar path.

#ifdef __AVX2__
constexpr int kGfCompiledSimd = 1;
#else
constexpr int kGfCompiledSimd = 0;
#endif

int g_gf_best = kGfni ? 2 : kGfCompiledSimd;
int g_gf_level = g_gf_best;

void xor_row(const uint8_t* src, uint8_t* dst, size_t n) {
    size_t i = 0;
#ifdef __AVX2__
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(src + i));
        __m256i d = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(dst + i));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                            _mm256_xor_si256(d, v));
    }
#endif
    for (; i < n; i++) dst[i] ^= src[i];
}

void mul_row_xor(uint8_t c, const uint8_t* src, uint8_t* dst, size_t n) {
    const uint8_t* table = MUL[c];
    size_t i = 0;
    if (g_gf_level >= 2) {
        i = mul_row_xor_gfni(c, src, dst, n);
        for (; i < n; i++) dst[i] ^= table[src[i]];
        return;
    }
#ifdef __AVX2__
    if (g_gf_level < 1) {
        for (; i < n; i++) dst[i] ^= table[src[i]];
        return;
    }
    alignas(16) uint8_t lo[16], hi[16];
    for (int v = 0; v < 16; v++) {
        lo[v] = MUL[c][v];
        hi[v] = MUL[c][v << 4];
    }
    __m256i vlo = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(lo)));
    __m256i vhi = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(hi)));
    __m256i mask = _mm256_set1_epi8(0x0f);
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(src + i));
        __m256i l = _mm256_and_si256(v, mask);
        __m256i h = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
        __m256i r = _mm256_xor_si256(_mm256_shuffle_epi8(vlo, l),
                                     _mm256_shuffle_epi8(vhi, h));
        __m256i d = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(dst + i));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                            _mm256_xor_si256(d, r));
    }
#endif
    for (; i < n; i++) dst[i] ^= table[src[i]];
}

// One batch item: out[r, s] = mat[r, k] (x) shards[k, s] over GF(2^8).
//
// Blocked over the byte axis so each (r + k)-row working chunk stays in
// L2 across the whole coefficient grid: without blocking, every output
// row streams all k megabyte-scale input rows from DRAM again — r*k*3
// row-passes of memory traffic vs (k reads + r writes) with blocking
// (~9x less at d=10 p=4), which is what the byte-level kernels (GFNI /
// pshufb) are fast enough to expose.
//: byte-axis block size: (k + r) * BLK ~ 0.5-1 MiB << L2+L3, and a
//: multiple of 64 so SHA block boundaries align (encode_hash_one)
constexpr size_t kApplyBlk = 32768;

// One byte-range [off, off+len) of the coefficient grid.
void apply_block(const uint8_t* mat, size_t r, size_t k,
                 const uint8_t* shards, size_t s, uint8_t* out,
                 size_t off, size_t len) {
    for (size_t i = 0; i < r; i++) {
        uint8_t* dst = out + i * s + off;
        // zero here, not up front: a whole-buffer memset would
        // stream r*s bytes through cache before any accumulation,
        // evicting the very chunks the blocking keeps hot
        std::memset(dst, 0, len);
        for (size_t j = 0; j < k; j++) {
            uint8_t c = mat[i * k + j];
            if (c == 0) continue;
            const uint8_t* src = shards + j * s + off;
            if (c == 1) {
                xor_row(src, dst, len);
            } else {
                mul_row_xor(c, src, dst, len);
            }
        }
    }
}

void apply_one(const uint8_t* mat, size_t r, size_t k,
               const uint8_t* shards, size_t s, uint8_t* out) {
    for (size_t off = 0; off < s; off += kApplyBlk) {
        size_t len = s - off < kApplyBlk ? s - off : kApplyBlk;
        apply_block(mat, r, k, shards, s, out, off, len);
    }
}

// ---- SHA-256 ----

namespace sha256 {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

constexpr uint32_t H0[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};

inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

void transform_scalar(uint32_t* st, const uint8_t* p, size_t blocks) {
    uint32_t w[64];
    for (; blocks; blocks--, p += 64) {
        for (int i = 0; i < 16; i++) {
            w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16)
                 | (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
        }
        for (int i = 16; i < 64; i++) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18)
                        ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19)
                        ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
        uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
        for (int i = 0; i < 64; i++) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = h + S1 + ch + K[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            h = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        st[0] += a; st[1] += b; st[2] += c; st[3] += d;
        st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
}

#if defined(__x86_64__) && defined(__GNUC__)
#define CB_HAVE_SHANI 1
#include <cpuid.h>
// Runtime SHA-NI detection via raw CPUID (leaf 7, EBX bit 29).  The
// obvious __builtin_cpu_supports("sha") only parses from GCC 11 — on
// GCC 10 that builtin is a hard compile error that takes the whole
// native build (and the default backend) down with it, hence this
// hand-rolled check.
bool cpu_has_shani() {
    unsigned int eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    return (ebx >> 29) & 1u;
}
// Intel SHA extensions path; layout (ABEF/CDGH packing, per-4-round
// message recurrence) follows the standard published pattern.
__attribute__((target("sha,sse4.1,ssse3")))
void transform_shani(uint32_t* st, const uint8_t* p, size_t blocks) {
    const __m128i mask =
        _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    __m128i tmp = _mm_loadu_si128(reinterpret_cast<const __m128i*>(st));
    __m128i st1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(st + 4));
    tmp = _mm_shuffle_epi32(tmp, 0xB1);        // CDAB
    st1 = _mm_shuffle_epi32(st1, 0x1B);        // EFGH
    __m128i st0 = _mm_alignr_epi8(tmp, st1, 8);   // ABEF
    st1 = _mm_blend_epi16(st1, tmp, 0xF0);        // CDGH

    for (; blocks; blocks--, p += 64) {
        __m128i save0 = st0, save1 = st1;
        __m128i msgs[4];
        for (int i = 0; i < 4; i++) {
            msgs[i] = _mm_shuffle_epi8(
                _mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(p + 16 * i)),
                mask);
            __m128i m = _mm_add_epi32(
                msgs[i],
                _mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(K + 4 * i)));
            st1 = _mm_sha256rnds2_epu32(st1, st0, m);
            m = _mm_shuffle_epi32(m, 0x0E);
            st0 = _mm_sha256rnds2_epu32(st0, st1, m);
        }
        for (int i = 4; i < 16; i++) {
            __m128i w = _mm_sha256msg1_epu32(msgs[(i - 4) & 3],
                                             msgs[(i - 3) & 3]);
            w = _mm_add_epi32(
                w, _mm_alignr_epi8(msgs[(i - 1) & 3], msgs[(i - 2) & 3], 4));
            w = _mm_sha256msg2_epu32(w, msgs[(i - 1) & 3]);
            msgs[i & 3] = w;
            __m128i m = _mm_add_epi32(
                w, _mm_loadu_si128(
                       reinterpret_cast<const __m128i*>(K + 4 * i)));
            st1 = _mm_sha256rnds2_epu32(st1, st0, m);
            m = _mm_shuffle_epi32(m, 0x0E);
            st0 = _mm_sha256rnds2_epu32(st0, st1, m);
        }
        st0 = _mm_add_epi32(st0, save0);
        st1 = _mm_add_epi32(st1, save1);
    }

    tmp = _mm_shuffle_epi32(st0, 0x1B);        // FEBA
    st1 = _mm_shuffle_epi32(st1, 0xB1);        // DCHG
    st0 = _mm_blend_epi16(tmp, st1, 0xF0);     // DCBA
    st1 = _mm_alignr_epi8(st1, tmp, 8);        // HGFE
    _mm_storeu_si128(reinterpret_cast<__m128i*>(st), st0);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(st + 4), st1);
}
// Two independent streams interleaved through one instruction stream:
// sha256rnds2/msg1/msg2 have multi-cycle latency but single-cycle
// throughput, so a second chain hides the first one's latency (~1.6-1.8x
// one core).  Shards are independent, so pairs are free to come by.
__attribute__((target("sha,sse4.1,ssse3")))
void transform_shani_x2(uint32_t* stA_, const uint8_t* pA,
                        uint32_t* stB_, const uint8_t* pB, size_t blocks) {
    const __m128i mask =
        _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    __m128i tmpA = _mm_loadu_si128(reinterpret_cast<const __m128i*>(stA_));
    __m128i a1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(stA_ + 4));
    tmpA = _mm_shuffle_epi32(tmpA, 0xB1);
    a1 = _mm_shuffle_epi32(a1, 0x1B);
    __m128i a0 = _mm_alignr_epi8(tmpA, a1, 8);
    a1 = _mm_blend_epi16(a1, tmpA, 0xF0);
    __m128i tmpB = _mm_loadu_si128(reinterpret_cast<const __m128i*>(stB_));
    __m128i b1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(stB_ + 4));
    tmpB = _mm_shuffle_epi32(tmpB, 0xB1);
    b1 = _mm_shuffle_epi32(b1, 0x1B);
    __m128i b0 = _mm_alignr_epi8(tmpB, b1, 8);
    b1 = _mm_blend_epi16(b1, tmpB, 0xF0);

    for (; blocks; blocks--, pA += 64, pB += 64) {
        __m128i saveA0 = a0, saveA1 = a1, saveB0 = b0, saveB1 = b1;
        __m128i msgsA[4], msgsB[4];
        for (int i = 0; i < 4; i++) {
            msgsA[i] = _mm_shuffle_epi8(
                _mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(pA + 16 * i)),
                mask);
            msgsB[i] = _mm_shuffle_epi8(
                _mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(pB + 16 * i)),
                mask);
            __m128i kv = _mm_loadu_si128(
                reinterpret_cast<const __m128i*>(K + 4 * i));
            __m128i mA = _mm_add_epi32(msgsA[i], kv);
            __m128i mB = _mm_add_epi32(msgsB[i], kv);
            a1 = _mm_sha256rnds2_epu32(a1, a0, mA);
            b1 = _mm_sha256rnds2_epu32(b1, b0, mB);
            mA = _mm_shuffle_epi32(mA, 0x0E);
            mB = _mm_shuffle_epi32(mB, 0x0E);
            a0 = _mm_sha256rnds2_epu32(a0, a1, mA);
            b0 = _mm_sha256rnds2_epu32(b0, b1, mB);
        }
        for (int i = 4; i < 16; i++) {
            __m128i wA = _mm_sha256msg1_epu32(msgsA[(i - 4) & 3],
                                              msgsA[(i - 3) & 3]);
            __m128i wB = _mm_sha256msg1_epu32(msgsB[(i - 4) & 3],
                                              msgsB[(i - 3) & 3]);
            wA = _mm_add_epi32(
                wA,
                _mm_alignr_epi8(msgsA[(i - 1) & 3], msgsA[(i - 2) & 3], 4));
            wB = _mm_add_epi32(
                wB,
                _mm_alignr_epi8(msgsB[(i - 1) & 3], msgsB[(i - 2) & 3], 4));
            wA = _mm_sha256msg2_epu32(wA, msgsA[(i - 1) & 3]);
            wB = _mm_sha256msg2_epu32(wB, msgsB[(i - 1) & 3]);
            msgsA[i & 3] = wA;
            msgsB[i & 3] = wB;
            __m128i kv = _mm_loadu_si128(
                reinterpret_cast<const __m128i*>(K + 4 * i));
            __m128i mA = _mm_add_epi32(wA, kv);
            __m128i mB = _mm_add_epi32(wB, kv);
            a1 = _mm_sha256rnds2_epu32(a1, a0, mA);
            b1 = _mm_sha256rnds2_epu32(b1, b0, mB);
            mA = _mm_shuffle_epi32(mA, 0x0E);
            mB = _mm_shuffle_epi32(mB, 0x0E);
            a0 = _mm_sha256rnds2_epu32(a0, a1, mA);
            b0 = _mm_sha256rnds2_epu32(b0, b1, mB);
        }
        a0 = _mm_add_epi32(a0, saveA0);
        a1 = _mm_add_epi32(a1, saveA1);
        b0 = _mm_add_epi32(b0, saveB0);
        b1 = _mm_add_epi32(b1, saveB1);
    }

    tmpA = _mm_shuffle_epi32(a0, 0x1B);
    a1 = _mm_shuffle_epi32(a1, 0xB1);
    a0 = _mm_blend_epi16(tmpA, a1, 0xF0);
    a1 = _mm_alignr_epi8(a1, tmpA, 8);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(stA_), a0);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(stA_ + 4), a1);
    tmpB = _mm_shuffle_epi32(b0, 0x1B);
    b1 = _mm_shuffle_epi32(b1, 0xB1);
    b0 = _mm_blend_epi16(tmpB, b1, 0xF0);
    b1 = _mm_alignr_epi8(b1, tmpB, 8);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(stB_), b0);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(stB_ + 4), b1);
}
#endif

using TransformFn = void (*)(uint32_t*, const uint8_t*, size_t);

TransformFn pick_transform() {
#ifdef CB_HAVE_SHANI
    if (cpu_has_shani()) return transform_shani;
#endif
    return transform_scalar;
}

const TransformFn kTransform = pick_transform();

using Transform2Fn = void (*)(uint32_t*, const uint8_t*,
                              uint32_t*, const uint8_t*, size_t);

Transform2Fn pick_transform2() {
#ifdef CB_HAVE_SHANI
    if (cpu_has_shani()) return transform_shani_x2;
#endif
    return nullptr;
}

const Transform2Fn kTransform2 = pick_transform2();

// Pad/finalize: absorb the trailing `rem` bytes (rem < 64) plus the
// 0x80 pad and 64-bit big-endian bit length, then emit the digest.
void finalize(uint32_t st[8], const uint8_t* partial, size_t rem,
              uint64_t total_len, uint8_t out[32]) {
    uint8_t tail[128];
    std::memcpy(tail, partial, rem);
    tail[rem] = 0x80;
    size_t tail_len = rem + 1 <= 56 ? 64 : 128;
    std::memset(tail + rem + 1, 0, tail_len - rem - 1 - 8);
    uint64_t bits = total_len * 8;
    for (int i = 0; i < 8; i++) {
        tail[tail_len - 1 - i] = uint8_t(bits >> (8 * i));
    }
    kTransform(st, tail, tail_len / 64);
    for (int i = 0; i < 8; i++) {
        out[4 * i + 0] = uint8_t(st[i] >> 24);
        out[4 * i + 1] = uint8_t(st[i] >> 16);
        out[4 * i + 2] = uint8_t(st[i] >> 8);
        out[4 * i + 3] = uint8_t(st[i]);
    }
}

void digest(const uint8_t* data, size_t len, uint8_t out[32]) {
    uint32_t st[8];
    std::memcpy(st, H0, sizeof(st));
    size_t blocks = len / 64;
    kTransform(st, data, blocks);
    finalize(st, data + blocks * 64, len - blocks * 64, uint64_t(len), out);
}

// Hash two equal-length buffers through interleaved SHA-NI streams
// (falls back to two sequential digests without the extension).
void digest_pair(const uint8_t* a, const uint8_t* b, size_t len,
                 uint8_t outA[32], uint8_t outB[32]) {
    if (kTransform2 == nullptr) {
        digest(a, len, outA);
        digest(b, len, outB);
        return;
    }
    uint32_t stA[8], stB[8];
    std::memcpy(stA, H0, sizeof(stA));
    std::memcpy(stB, H0, sizeof(stB));
    size_t blocks = len / 64;
    kTransform2(stA, a, stB, b, blocks);
    finalize(stA, a + blocks * 64, len - blocks * 64, uint64_t(len), outA);
    finalize(stB, b + blocks * 64, len - blocks * 64, uint64_t(len), outB);
}

// Streaming SHA-256 over a file byte range without surfacing the bytes
// to the caller — the read+hash fusion for local chunk verification
// (verify reads every location of every chunk, reference
// src/file/file_part.rs:228-251).  `want` = UINT64_MAX hashes to EOF.
// Returns 0 ok, -1 open/read error, -2 file shorter than start+want.
int digest_file(const char* path, uint64_t start, uint64_t want,
                uint8_t out[32]) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (start != 0 && fseeko(f, static_cast<off_t>(start),
                             SEEK_SET) != 0) {
        std::fclose(f);
        return -1;
    }
    uint32_t st[8];
    std::memcpy(st, H0, sizeof(st));
    std::vector<uint8_t> buf(1 << 20);
    size_t rem = 0;  // partial block carried at buf[0..rem)
    uint64_t total = 0;
    const bool to_eof = want == UINT64_MAX;
    while (true) {
        size_t cap = buf.size() - rem;
        if (!to_eof) {
            uint64_t left = want - total;
            if (left < cap) cap = static_cast<size_t>(left);
        }
        if (cap == 0) break;
        size_t n = std::fread(buf.data() + rem, 1, cap, f);
        if (n == 0) {
            if (std::ferror(f)) {
                std::fclose(f);
                return -1;
            }
            break;  // EOF
        }
        total += n;
        size_t have = rem + n;
        size_t blocks = have / 64;
        kTransform(st, buf.data(), blocks);
        rem = have - blocks * 64;
        std::memmove(buf.data(), buf.data() + blocks * 64, rem);
    }
    std::fclose(f);
    if (!to_eof && total != want) return -2;
    finalize(st, buf.data(), rem, total, out);
    return 0;
}

}  // namespace sha256

// Fused encode+hash for one batch item, block-interleaved: each 32 KiB
// byte range runs the GF coefficient grid and then immediately feeds the
// (still L2-hot) data and fresh parity chunks into streaming SHA states
// — every byte crosses DRAM once for both jobs, where the sequential
// encode-then-hash shape re-reads all k+r rows for the hash pass.
void encode_hash_one(const uint8_t* mat, size_t r, size_t k,
                     const uint8_t* item, size_t s,
                     uint8_t* parity, uint8_t* hashes) {
    const size_t total = k + r;
    std::vector<uint32_t> st(total * 8);
    for (size_t j = 0; j < total; j++)
        std::memcpy(&st[j * 8], sha256::H0, 32);
    auto row = [&](size_t j) {
        return j < k ? item + j * s : parity + (j - k) * s;
    };
    size_t hashed = 0;  // bytes per row consumed by whole SHA blocks
    for (size_t off = 0; off < s; off += kApplyBlk) {
        size_t len = s - off < kApplyBlk ? s - off : kApplyBlk;
        if (r > 0) apply_block(mat, r, k, item, s, parity, off, len);
        size_t blocks = len / 64;  // short only on the final range
        if (blocks) {
            size_t j = 0;
            if (sha256::kTransform2 != nullptr) {
                for (; j + 1 < total; j += 2)
                    sha256::kTransform2(&st[j * 8], row(j) + off,
                                        &st[(j + 1) * 8],
                                        row(j + 1) + off, blocks);
            }
            for (; j < total; j++)
                sha256::kTransform(&st[j * 8], row(j) + off, blocks);
            hashed = off + blocks * 64;
        }
    }
    for (size_t j = 0; j < total; j++)
        sha256::finalize(&st[j * 8], row(j) + hashed, s - hashed,
                         static_cast<uint64_t>(s), hashes + j * 32);
}

// Run `fn(i)` for i in [0, n) across up to `nthreads` std::threads
// (<=0 => hardware concurrency).
template <typename Fn>
void parallel_for(size_t n, int nthreads, Fn fn) {
    size_t want = nthreads > 0
        ? static_cast<size_t>(nthreads)
        : static_cast<size_t>(std::thread::hardware_concurrency());
    if (want == 0) want = 1;
    size_t threads = want < n ? want : n;
    if (threads <= 1) {
        for (size_t i = 0; i < n; i++) fn(i);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (size_t t = 0; t < threads; t++) {
        pool.emplace_back([=]() {
            for (size_t i = t; i < n; i += threads) fn(i);
        });
    }
    for (auto& th : pool) th.join();
}

// ---- scheduled-XOR engine (ops/xor_schedule.py) ----
//
// Executes a pre-compiled XOR program over bit-planes: shards are
// transposed into 8 planes each (plane v, byte t8, bit b = bit v of
// shard byte 8*t8+b), the flat (dst, src, kind) op list runs as
// plane-wide XOR/copy/zero over an arena tiled to stay L1/L2-resident
// (arXiv:2108.02692's cache-tiling), and output planes transpose back
// to parity bytes — so every emitted byte is identical to the table
// codecs (the content-address invariant), while the per-byte k*r
// table work becomes wide XORs.
//
// Runtime dispatch discipline matches the SHA-NI/GFNI fixes above: no
// reliance on -march (the generic fallback build must still get SIMD
// here), raw-CPUID feature detection, AVX2 bodies behind a target
// attribute, SSE2 as the x86_64 baseline, portable scalar elsewhere —
// and the active level is forcible (cb_xor_set_impl) so the scalar
// fallback is pinned by a test, not trusted.
namespace xorsched {

// 8x8 bit-matrix transpose of a uint64 (byte i = row i, bit j = col
// j): the standard three delta-swaps; an involution, so it serves
// both directions (bytes -> planes and planes -> bytes).
inline uint64_t transpose8(uint64_t x) {
    uint64_t t;
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
    x = x ^ t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
    x = x ^ t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
    x = x ^ t ^ (t << 28);
    return x;
}

#if defined(__x86_64__) && defined(__GNUC__)
#define CB_XOR_X86 1
#include <cpuid.h>

// Raw-CPUID AVX2 detection (leaf 7 EBX bit 5) plus the OS half the
// feature bit alone doesn't prove: OSXSAVE (leaf 1 ECX bit 27) and
// XCR0 xmm+ymm state via xgetbv — an AVX2 CPU under an OS that never
// enables ymm state would fault on the first vector op.
bool cpu_has_avx2() {
    unsigned int eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    if (!((ebx >> 5) & 1u)) return false;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
    if (!((ecx >> 27) & 1u)) return false;  // OSXSAVE
    unsigned int lo = 0, hi = 0;
    __asm__ volatile("xgetbv" : "=a"(lo), "=d"(hi) : "c"(0));
    return (lo & 0x6) == 0x6;  // XMM + YMM state enabled
}

// two-lane transpose8 (SSE2 shifts are per-64-bit-lane already)
inline __m128i transpose8_x2(__m128i x) {
    const __m128i mA = _mm_set1_epi64x(0x00AA00AA00AA00AALL);
    const __m128i mC = _mm_set1_epi64x(0x0000CCCC0000CCCCLL);
    const __m128i mF = _mm_set1_epi64x(0x00000000F0F0F0F0LL);
    __m128i t;
    t = _mm_and_si128(_mm_xor_si128(x, _mm_srli_epi64(x, 7)), mA);
    x = _mm_xor_si128(x, _mm_xor_si128(t, _mm_slli_epi64(t, 7)));
    t = _mm_and_si128(_mm_xor_si128(x, _mm_srli_epi64(x, 14)), mC);
    x = _mm_xor_si128(x, _mm_xor_si128(t, _mm_slli_epi64(t, 14)));
    t = _mm_and_si128(_mm_xor_si128(x, _mm_srli_epi64(x, 28)), mF);
    x = _mm_xor_si128(x, _mm_xor_si128(t, _mm_slli_epi64(t, 28)));
    return x;
}
#endif

int detect_best() {
#ifdef CB_XOR_X86
    return cpu_has_avx2() ? 2 : 1;  // SSE2 is the x86_64 baseline
#else
    return 0;
#endif
}

const int kXorBest = detect_best();
int g_xor_level = kXorBest;  // 0 scalar / 1 sse2 / 2 avx2

// -- split: 8*tl shard bytes -> 8 planes of tl bytes (p0 + v*stride) --

void split_scalar(const uint8_t* src, size_t tl, uint8_t* p0,
                  size_t stride) {
    for (size_t t = 0; t < tl; t++) {
        uint64_t w;
        std::memcpy(&w, src + 8 * t, 8);
        w = transpose8(w);
        for (int v = 0; v < 8; v++)
            p0[v * stride + t] = static_cast<uint8_t>(w >> (8 * v));
    }
}

#ifdef CB_XOR_X86
// movemask reads bit 7 of each byte; add_epi8(x, x) shifts each byte
// left one bit with no cross-byte traffic, so eight mask+shift rounds
// peel plane 7 down to plane 0 — 2 plane bytes per 16 source bytes.
void split_sse2(const uint8_t* src, size_t tl, uint8_t* p0,
                size_t stride) {
    size_t t = 0;
    for (; t + 2 <= tl; t += 2) {
        __m128i x = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(src + 8 * t));
        for (int v = 7; v >= 0; v--) {
            uint16_t m = static_cast<uint16_t>(_mm_movemask_epi8(x));
            std::memcpy(p0 + v * stride + t, &m, 2);
            x = _mm_add_epi8(x, x);
        }
    }
    if (t < tl) split_scalar(src + 8 * t, tl - t, p0 + t, stride);
}

__attribute__((target("avx2")))
void split_avx2(const uint8_t* src, size_t tl, uint8_t* p0,
                size_t stride) {
    size_t t = 0;
    for (; t + 4 <= tl; t += 4) {
        __m256i x = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(src + 8 * t));
        for (int v = 7; v >= 0; v--) {
            uint32_t m = static_cast<uint32_t>(_mm256_movemask_epi8(x));
            std::memcpy(p0 + v * stride + t, &m, 4);
            x = _mm256_add_epi8(x, x);
        }
    }
    if (t < tl) split_sse2(src + 8 * t, tl - t, p0 + t, stride);
}
#endif

// -- pack: 8 planes of tl bytes -> 8*tl output bytes --

void pack_scalar(const uint8_t* p0, size_t stride, size_t tl,
                 uint8_t* dst) {
    for (size_t t = 0; t < tl; t++) {
        uint64_t w = 0;
        for (int v = 0; v < 8; v++)
            w |= static_cast<uint64_t>(p0[v * stride + t]) << (8 * v);
        w = transpose8(w);
        std::memcpy(dst + 8 * t, &w, 8);
    }
}

#ifdef CB_XOR_X86
// 16 plane-byte columns at a time: a 3-level punpck tower turns the 8
// plane rows into 16 byte-groups [p0[u]..p7[u]], each transposed as a
// 64-bit lane pair — SSE2-baseline, so even the no-AVX2 build packs
// at vector speed.
void pack_sse2(const uint8_t* p0, size_t stride, size_t tl,
               uint8_t* dst) {
    size_t t = 0;
    for (; t + 16 <= tl; t += 16) {
        __m128i x0 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 0 * stride + t));
        __m128i x1 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 1 * stride + t));
        __m128i x2 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 2 * stride + t));
        __m128i x3 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 3 * stride + t));
        __m128i x4 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 4 * stride + t));
        __m128i x5 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 5 * stride + t));
        __m128i x6 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 6 * stride + t));
        __m128i x7 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(p0 + 7 * stride + t));
        __m128i a0 = _mm_unpacklo_epi8(x0, x1);
        __m128i a1 = _mm_unpackhi_epi8(x0, x1);
        __m128i b0 = _mm_unpacklo_epi8(x2, x3);
        __m128i b1 = _mm_unpackhi_epi8(x2, x3);
        __m128i c0 = _mm_unpacklo_epi8(x4, x5);
        __m128i c1 = _mm_unpackhi_epi8(x4, x5);
        __m128i d0 = _mm_unpacklo_epi8(x6, x7);
        __m128i d1 = _mm_unpackhi_epi8(x6, x7);
        __m128i e0 = _mm_unpacklo_epi16(a0, b0);
        __m128i e1 = _mm_unpackhi_epi16(a0, b0);
        __m128i e2 = _mm_unpacklo_epi16(a1, b1);
        __m128i e3 = _mm_unpackhi_epi16(a1, b1);
        __m128i f0 = _mm_unpacklo_epi16(c0, d0);
        __m128i f1 = _mm_unpackhi_epi16(c0, d0);
        __m128i f2 = _mm_unpacklo_epi16(c1, d1);
        __m128i f3 = _mm_unpackhi_epi16(c1, d1);
        uint8_t* o = dst + 8 * t;
        __m128i g;
        g = transpose8_x2(_mm_unpacklo_epi32(e0, f0));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 0), g);
        g = transpose8_x2(_mm_unpackhi_epi32(e0, f0));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 16), g);
        g = transpose8_x2(_mm_unpacklo_epi32(e1, f1));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 32), g);
        g = transpose8_x2(_mm_unpackhi_epi32(e1, f1));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 48), g);
        g = transpose8_x2(_mm_unpacklo_epi32(e2, f2));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 64), g);
        g = transpose8_x2(_mm_unpackhi_epi32(e2, f2));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 80), g);
        g = transpose8_x2(_mm_unpacklo_epi32(e3, f3));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 96), g);
        g = transpose8_x2(_mm_unpackhi_epi32(e3, f3));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 112), g);
    }
    if (t < tl) pack_scalar(p0 + t, stride, tl - t, dst + 8 * t);
}
#endif

// -- the wide-XOR inner loop (the op list's hot kernel) --

void xor_planes_scalar(uint8_t* dst, const uint8_t* src, size_t n) {
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t a, b;
        std::memcpy(&a, dst + i, 8);
        std::memcpy(&b, src + i, 8);
        a ^= b;
        std::memcpy(dst + i, &a, 8);
    }
    for (; i < n; i++) dst[i] ^= src[i];
}

#ifdef CB_XOR_X86
void xor_planes_sse2(uint8_t* dst, const uint8_t* src, size_t n) {
    size_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m128i a = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(dst + i));
        __m128i b = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(src + i));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + i),
                         _mm_xor_si128(a, b));
    }
    for (; i < n; i++) dst[i] ^= src[i];
}

__attribute__((target("avx2")))
void xor_planes_avx2(uint8_t* dst, const uint8_t* src, size_t n) {
    size_t i = 0;
    for (; i + 32 <= n; i += 32) {
        __m256i a = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(dst + i));
        __m256i b = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(src + i));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + i),
                            _mm256_xor_si256(a, b));
    }
    for (; i < n; i++) dst[i] ^= src[i];
}
#endif

void split(const uint8_t* src, size_t tl, uint8_t* p0, size_t stride) {
#ifdef CB_XOR_X86
    if (g_xor_level >= 2) return split_avx2(src, tl, p0, stride);
    if (g_xor_level >= 1) return split_sse2(src, tl, p0, stride);
#endif
    split_scalar(src, tl, p0, stride);
}

void pack(const uint8_t* p0, size_t stride, size_t tl, uint8_t* dst) {
#ifdef CB_XOR_X86
    if (g_xor_level >= 1) return pack_sse2(p0, stride, tl, dst);
#endif
    pack_scalar(p0, stride, tl, dst);
}

void xor_planes(uint8_t* dst, const uint8_t* src, size_t n) {
#ifdef CB_XOR_X86
    if (g_xor_level >= 2) return xor_planes_avx2(dst, src, n);
    if (g_xor_level >= 1) return xor_planes_sse2(dst, src, n);
#endif
    xor_planes_scalar(dst, src, n);
}

//: arena budget: n_planes * tile bytes; 256 KiB keeps the whole
//: working set L2-resident on everything this targets while leaving
//: room for the source/dest streams
constexpr size_t kXorArenaBytes = 256u << 10;

// One batch item: run the whole op list per tile so every plane's
// tile stays cache-hot across the program (the paper's L1-residency
// reordering, realized as an outer tile loop).
void xor_exec_one(const int32_t* ops, size_t n_ops, size_t n_planes,
                  size_t k, size_t r, const uint8_t* item, size_t s,
                  uint8_t* out) {
    const size_t P = s / 8;
    size_t tile = P;
    if (n_planes * tile > kXorArenaBytes) {
        tile = kXorArenaBytes / n_planes;
        tile &= ~static_cast<size_t>(15);
        if (tile == 0) tile = 16;
    }
    std::vector<uint8_t> arena(n_planes * tile);
    uint8_t* A = arena.data();
    const size_t out_base = n_planes - 8 * r;
    for (size_t lo = 0; lo < P; lo += tile) {
        const size_t tl = P - lo < tile ? P - lo : tile;
        for (size_t j = 0; j < k; j++)
            split(item + j * s + 8 * lo, tl, A + (8 * j) * tile, tile);
        for (size_t o = 0; o < n_ops; o++) {
            const int32_t dst = ops[3 * o];
            const int32_t src = ops[3 * o + 1];
            const int32_t kind = ops[3 * o + 2];
            uint8_t* d = A + static_cast<size_t>(dst) * tile;
            if (kind == 1) {
                xor_planes(d, A + static_cast<size_t>(src) * tile, tl);
            } else if (kind == 0) {
                // slot recycling may hand a copy's dst the arena slot
                // its src freed on this very op — already in place
                const uint8_t* sp = A + static_cast<size_t>(src) * tile;
                if (d != sp) std::memcpy(d, sp, tl);
            } else {
                std::memset(d, 0, tl);
            }
        }
        for (size_t i = 0; i < r; i++)
            pack(A + (out_base + 8 * i) * tile, tile, tl,
                 out + i * s + 8 * lo);
    }
}

}  // namespace xorsched

}  // namespace

extern "C" {

// out[b, r, s] = mat[r, k] (x) shards[b, k, s]; nthreads <= 0 => hardware.
void cb_apply_matrix(const uint8_t* mat, size_t r, size_t k,
                     const uint8_t* shards, size_t b, size_t s,
                     uint8_t* out, int nthreads) {
    if (!kInited || r == 0 || b == 0 || s == 0) return;
    parallel_for(b, nthreads, [=](size_t i) {
        apply_one(mat, r, k, shards + i * k * s, s, out + i * r * s);
    });
}

// Table self-check hook: lets Python assert C++ and numpy agree on the field.
uint8_t cb_gf_mul(uint8_t a, uint8_t b) { return MUL[a][b]; }

// Force the byte-table kernel tier (0 scalar table / 1 AVX2 pshufb /
// 2 GFNI); clamped to what this build+CPU actually has.  Returns the
// effective tier.  The config-12 A/B uses this to A/B the XOR engine
// against every tier a deployment might run; output bytes are
// identical at every tier (the tiers are the same math).
int cb_gf_set_level(int level) {
    if (level > g_gf_best) level = g_gf_best;
    if (level == 1 && !kGfCompiledSimd) level = 0;
    if (level < 0) level = 0;
    g_gf_level = level;
    return level;
}

int cb_gf_get_level(void) { return g_gf_level; }

// Scheduled-XOR executor (ops/xor_schedule.py): run the compiled
// (dst, src, kind) op list over bit-planes of every batch item.
//   ops[n_ops, 3] int32 over arena ids [inputs 8k | temps | outputs 8r]
//   out[b, r, s] = the schedule's matrix (x) shards[b, k, s]
// s must be a multiple of 8 (the Python gate guarantees it); batch
// items fan across std::threads like cb_apply_matrix, so a HostPipeline
// slice calling with nthreads=1 keeps total host parallelism at the
// scheduler's worker count.
void cb_xor_exec(const int32_t* ops, size_t n_ops, size_t n_planes,
                 size_t k, size_t r, const uint8_t* shards, size_t b,
                 size_t s, uint8_t* out, int nthreads) {
    if (!kInited || b == 0 || r == 0 || s == 0 || (s % 8) != 0) return;
    parallel_for(b, nthreads, [=](size_t i) {
        xorsched::xor_exec_one(ops, n_ops, n_planes, k, r,
                               shards + i * k * s, s, out + i * r * s);
    });
}

// Force the XOR engine's kernel tier (0 scalar / 1 SSE2 / 2 AVX2);
// clamped to the detected ceiling.  Returns the effective tier — the
// forced-scalar identity test pins the fallback path with this.
int cb_xor_set_impl(int level) {
    if (level > xorsched::kXorBest) level = xorsched::kXorBest;
    if (level < 0) level = 0;
    xorsched::g_xor_level = level;
    return level;
}

int cb_xor_get_impl(void) { return xorsched::g_xor_level; }

// SHA-256 of one buffer (SHA-NI when available).
void cb_sha256(const uint8_t* data, size_t len, uint8_t* out) {
    sha256::digest(data, len, out);
}

// SHA-256 of a file byte range; len = UINT64_MAX hashes start..EOF.
// 0 ok, -1 I/O error, -2 short file.
int cb_sha256_file(const char* path, uint64_t start, uint64_t len,
                   uint8_t* out) {
    return sha256::digest_file(path, start, len, out);
}

// 1 when the SHA-NI fast path is active (introspection for tests/bench).
int cb_sha256_is_accelerated(void) {
#ifdef CB_HAVE_SHANI
    return sha256::kTransform == sha256::transform_shani ? 1 : 0;
#else
    return 0;
#endif
}

// Hash n contiguous rows of length s: out[i*32..] = sha256(rows[i*s..]).
void cb_sha256_rows(const uint8_t* rows, size_t n, size_t s,
                    uint8_t* out, int nthreads) {
    // Pairs of rows share one interleaved SHA-NI instruction stream.
    parallel_for((n + 1) / 2, nthreads, [=](size_t pi) {
        size_t i = 2 * pi;
        if (i + 1 < n) {
            sha256::digest_pair(rows + i * s, rows + (i + 1) * s, s,
                                out + i * 32, out + (i + 1) * 32);
        } else {
            sha256::digest(rows + i * s, s, out + i * 32);
        }
    });
}

// Fused ingest step: parity + per-shard content hashes in one pass per
// batch item, while the item's shards are cache-hot.
//   out_parity[b, r, s]       = mat[r, k] (x) shards[b, k, s]
//   out_hashes[b, k + r, 32]  = sha256 of each data then parity shard
void cb_encode_hash(const uint8_t* mat, size_t r, size_t k,
                    const uint8_t* shards, size_t b, size_t s,
                    uint8_t* out_parity, uint8_t* out_hashes, int nthreads) {
    if (!kInited || b == 0 || s == 0) return;
    parallel_for(b, nthreads, [=](size_t i) {
        encode_hash_one(mat, r, k, shards + i * k * s, s,
                        out_parity + i * r * s,
                        out_hashes + i * (k + r) * 32);
    });
}

}  // extern "C"
