// The tp reduction and pack of the wide-stripe layout for Hopper (sm_90a):
//     out[b, i, s] = sum_bit ((sum_t part_t[b, bit*R + i, s]) & 1) << bit
// tp int16 bit-major popcount partials [B, 8R, S] (gf_acc.cu's output, one
// per tp rank, all on one device) to the uint8 bytes [B, R, S].
//
// Not a TPU kernel: the counterpart of jax.lax.psum(acc, "tp")
// (chunky_bits_tpu/parallel/mesh.py:309,322) followed by pack_acc_bitmajor
// (chunky_bits_tpu/ops/pallas_kernels.py:350), which XLA fuses into one
// element-wise pass.
//
// Bound on an H100: the bytes.  Each partial is read once (16 bytes per
// output byte) and each byte written once, so at BASELINE config 5 (8 parts,
// p = 6, 4 MiB columns, tp = 4) the kernel moves 12.9 GB in + 0.2 GB out,
// 3.906 ms at 3.35 TB/s.
//
// Design: the parity of a sum is the XOR of the parities, so a thread
// XORs the tp partials' 16-byte words of 8 columns for the 8 bit-rows of
// one output byte-row (8 tp independent 16-byte loads in flight), moves
// bit 0 of each int16 to its bit with shifts, and writes 8 bytes.  The
// partials' pointers come as a kernel argument (no gather, no copy), read
// at constant indices so that they stay in the parameter space.  A
// scalar path covers S not a multiple of 8 and pointers not 16-byte (out:
// 8-byte) aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 8;

struct Parts {
  const int16_t* p[kMaxParts];
};

__global__ void __launch_bounds__(kThreads)
gf_acc_pack_kernel(Parts parts, int tp, uint8_t* __restrict__ out, int B,
                   int R, long long S, int vec) {
  const long long groups = (S + 7) / 8;  // 8 columns a thread
  const long long items = static_cast<long long>(B) * R * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long it = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       it < items; it += stride) {
    const long long s0 = (it % groups) * 8;
    const long long bi = it / groups;  // b * R + i
    const long long b = bi / R;
    const int i = static_cast<int>(bi % R);
    uint8_t* dst = out + bi * S + s0;
    if (vec) {
      // x[bit]: 8 int16 columns of bit-row bit*R + i, XOR over the parts
      uint4 x[8];
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) x[bit] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int t = 0; t < kMaxParts; ++t) {
        if (t < tp) {
          const int16_t* src = parts.p[t] + (b * 8 * R + i) * S + s0;
#pragma unroll
          for (int bit = 0; bit < 8; ++bit) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                src + static_cast<long long>(bit) * R * S));
            x[bit].x ^= v.x; x[bit].y ^= v.y; x[bit].z ^= v.z;
            x[bit].w ^= v.w;
          }
        }
      }
      // word w of y holds columns 2w (bits 0..7) and 2w + 1 (bits 16..23)
      uint32_t y[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        y[0] |= (x[bit].x & 0x00010001u) << bit;
        y[1] |= (x[bit].y & 0x00010001u) << bit;
        y[2] |= (x[bit].z & 0x00010001u) << bit;
        y[3] |= (x[bit].w & 0x00010001u) << bit;
      }
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(__byte_perm(y[0], y[1], 0x6420u),
                     __byte_perm(y[2], y[3], 0x6420u));
    } else {
      const long long n = S - s0 < 8 ? S - s0 : 8;
      for (int c = 0; c < n; ++c) {
        uint32_t byte = 0u;
        for (int bit = 0; bit < 8; ++bit) {
          const long long at =
              (b * 8 * R + static_cast<long long>(bit) * R + i) * S + s0 + c;
          uint32_t par = 0u;
#pragma unroll
          for (int t = 0; t < kMaxParts; ++t) {
            if (t < tp) par ^= static_cast<uint32_t>(parts.p[t][at]);
          }
          byte |= (par & 1u) << bit;
        }
        dst[c] = static_cast<uint8_t>(byte);
      }
    }
  }
}

}  // namespace

// parts: tp (1..8) pointers, each i16[B, 8R, S] on the device (a host array
// of device pointers); out: u8[B, R, S].  Launches on ``stream``,
// allocates nothing, does not synchronise; returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a tp outside 1..8).
extern "C" int cb_gf_acc_pack(const void* const* parts, int tp, void* out,
                              int B, int R, long long S, void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  if (tp <= 0 || tp > kMaxParts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts ps = {};
  bool aligned = S % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  for (int t = 0; t < tp; ++t) {
    ps.p[t] = static_cast<const int16_t*>(parts[t]);
    aligned = aligned && reinterpret_cast<uintptr_t>(parts[t]) % 16 == 0;
  }
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = static_cast<long long>(B) * R * ((S + 7) / 8);
  const long long needed = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  gf_acc_pack_kernel<<<static_cast<unsigned>(needed < cap ? needed : cap),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ps, tp, static_cast<uint8_t*>(out), B, R, S, aligned ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cb_gf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
