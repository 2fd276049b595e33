// The threefry2x32 counter hash of jax.random for Hopper (sm_90a): the bits
// behind every keyed draw of the port (repro_torch.random).
//
// Replaces: no Pallas kernel. In the JAX package XLA fuses jax.random's
// threefry2x32 (jax/_src/prng.py, _threefry2x32_lowering) into one kernel;
// the port's plain version (threefry2x32_plain in
// src/repro_torch/kernels/threefry.py) is about 120 elementwise launches of
// int64 tensors. Same function, bit for bit: for key words (k0, k1) and a
// counter pair (x0, x1), with k2 = k0 ^ k1 ^ 0x1BD11BDA,
//
//   x0 += k0; x1 += k1
//   5 times: 4 rounds  x0 += x1; x1 = rotl(x1, r) ^ x0
//            with r in {13, 15, 26, 6} (even groups), {17, 29, 16, 24} (odd)
//            then the injection x0 += ks[g+1]; x1 += ks[g+2] + g + 1
//
// (ks = k0, k1, k2, indices mod 3, g the group 0..4), all mod 2^32. Row r
// of the keys hashes the counters i = 0..n-1 as (hi(i), lo(i)); n < 2^32,
// so hi is 0. Modes (the wrapper allocates the output):
//   0 pair     out[r, i] = (x0, x1) as two int64        (split)
//   1 bits     out[r, i] = x0 ^ x1 as int64              (bits)
//   2 uniform  out[r, i] = max(lo, fma(f, span, lo)), float32, where f is
//              ((x0 ^ x1) >> 9 | 0x3F800000) as a float, minus 1; the
//              product and the sum are one fused multiply-add, rounded
//              once, as XLA compiles jax.random.uniform   (uniform)
//   3 fold     out[r] = the hash of the one pair (0, data[r])  (fold_in)
//   4 split_uniform  the uniforms of both halves of each key's split:
//              with (a, b) = split(keys[r]) (the hashes of the counters 0
//              and 1), out[r, i] = uniform(a)[i] for i < n and
//              out2[r, j] = uniform(b)[j] for j < n2 — a phase-1 row's
//              u and us in one launch (keyed_uniforms)
//   5 select   the partial Fisher-Yates draw of m = n2 of n indices a key
//              (core/distributed.py's shard_select_no_replace): for
//              t < m, (key, sub) = split(key), j = randint(sub, (), t, n),
//              swap idx[t] and idx[j]; out[r, t] = idx[t], int32. The m
//              splits form a chain, so one thread of a block walks it for
//              its key (6 hashes a step), on idx in a scratch row of out2
//
// What bounds it: integer operations. A counter takes 77 32-bit integer
// operations (20 rounds of an add, a funnel shift and a xor; 2 + 5 x 3
// additions of key words), plus 1 to 3 for the output, and writes 4 bytes
// (uniform) or 8 (bits). The H100 SXM issues 64 INT32 operations per SM a
// clock: 132 x 64 x 1.98 GHz = 16.7 T/s. At 512 x 10^4 uniforms that is
// 80 x 5.12e6 / 16.7e12 = 24.5 us against 20.5 MB / 3.35 TB/s = 6.1 us of
// stores.
//
// What the design does about it. One thread per counter keeps both words and
// the three key words in registers for the 20 rounds; a rotation is one
// funnel shift (__funnelshift_l); the injection constants ks + g + 1 fold
// into three-input adds. Blocks of 256 threads tile the counters of a row
// (blockIdx.x), rows run along blockIdx.y (looping past 65535 rows), so a
// block's stores are contiguous. Split_uniform tiles the n + n2 counters of
// a row the same way; two threads of a block hash the row's split into
// shared memory first, so a counter costs one hash as in the other modes.
// Select is sequential by nature: a block a key fills its index row
// together, then its first thread runs the m dependent steps in registers
// (m x 6 hashes) and writes idx[t] as soon as step t settles it (no later
// step touches a position below its own).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

// ((x0 ^ x1) >> 9 | 0x3F800000) as a float is in [1, 2); minus 1 is exact
__device__ __forceinline__ float to_uniform(uint32_t x0, uint32_t x1,
                                           float lo, float span) {
  const float f = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(lo, __fmaf_rn(f, span, lo));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    threefry2x32_kernel(const long long* __restrict__ keys, long long R,
                        long long n, void* __restrict__ out, float lo,
                        float span) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const uint32_t k0 = static_cast<uint32_t>(__ldg(keys + 2 * r));
    const uint32_t k1 = static_cast<uint32_t>(__ldg(keys + 2 * r + 1));
    uint32_t x0 = static_cast<uint32_t>(i >> 32);
    uint32_t x1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, x0, x1);
    const long long at = r * n + i;
    if (kMode == 0) {
      long long* o = static_cast<long long*>(out) + 2 * at;
      o[0] = x0;
      o[1] = x1;
    } else if (kMode == 1) {
      static_cast<long long*>(out)[at] = x0 ^ x1;
    } else {
      static_cast<float*>(out)[at] = to_uniform(x0, x1, lo, span);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    threefry2x32_fold_kernel(const long long* __restrict__ keys,
                             const long long* __restrict__ data, long long R,
                             long long* __restrict__ out) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (r >= R) return;
  uint32_t x0 = 0u;
  uint32_t x1 = static_cast<uint32_t>(__ldg(data + r));
  threefry2x32(static_cast<uint32_t>(__ldg(keys + 2 * r)),
               static_cast<uint32_t>(__ldg(keys + 2 * r + 1)), x0, x1);
  out[2 * r] = x0;
  out[2 * r + 1] = x1;
}

__global__ void __launch_bounds__(kThreads)
    threefry2x32_split_uniform_kernel(const long long* __restrict__ keys,
                                      long long R, long long n, long long n2,
                                      float* __restrict__ out,
                                      float* __restrict__ out2, float lo,
                                      float span) {
  __shared__ uint32_t half[4];  // (a, b) = split(keys[r])
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    if (threadIdx.x < 2) {
      uint32_t x0 = 0u, x1 = threadIdx.x;
      threefry2x32(static_cast<uint32_t>(__ldg(keys + 2 * r)),
                   static_cast<uint32_t>(__ldg(keys + 2 * r + 1)), x0, x1);
      half[2 * threadIdx.x] = x0;
      half[2 * threadIdx.x + 1] = x1;
    }
    __syncthreads();
    if (i < n + n2) {
      const bool second = i >= n;
      const long long c = second ? i - n : i;
      uint32_t x0 = static_cast<uint32_t>(c >> 32);
      uint32_t x1 = static_cast<uint32_t>(c);
      threefry2x32(half[second ? 2 : 0], half[second ? 3 : 1], x0, x1);
      if (second)
        out2[r * n2 + c] = to_uniform(x0, x1, lo, span);
      else
        out[r * n + c] = to_uniform(x0, x1, lo, span);
    }
    __syncthreads();  // the next row rewrites half
  }
}

// randint(key, (), lo, hi) of jax.random for lo < hi: split the key, 32
// bits from each half (counter 0), combined by jax's modulus construction
// in wrapping uint32 arithmetic
__device__ __forceinline__ uint32_t randint_offset(uint32_t k0, uint32_t k1,
                                                   uint32_t span) {
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  threefry2x32(k0, k1, a0, a1);
  threefry2x32(k0, k1, b0, b1);
  uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 0u;
  threefry2x32(a0, a1, h0, h1);
  threefry2x32(b0, b1, l0, l1);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  return (((h0 ^ h1) % span) * mult + (l0 ^ l1) % span) % span;
}

__global__ void __launch_bounds__(kThreads)
    threefry2x32_select_kernel(const long long* __restrict__ keys,
                               long long R, long long n, long long m,
                               int* __restrict__ out,
                               int* __restrict__ scratch) {
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    int* idx = scratch + r * n;
    for (long long i = threadIdx.x; i < n; i += kThreads)
      idx[i] = static_cast<int>(i);
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t k0 = static_cast<uint32_t>(__ldg(keys + 2 * r));
      uint32_t k1 = static_cast<uint32_t>(__ldg(keys + 2 * r + 1));
      for (long long t = 0; t < m; ++t) {
        uint32_t n0 = 0u, n1 = 0u, s0 = 0u, s1 = 1u;  // (key, sub) = split
        threefry2x32(k0, k1, n0, n1);
        threefry2x32(k0, k1, s0, s1);
        k0 = n0;
        k1 = n1;
        const long long j =
            t + randint_offset(s0, s1, static_cast<uint32_t>(n - t));
        const int vj = idx[j];
        idx[j] = idx[t];
        idx[t] = vj;
        out[r * m + t] = vj;
      }
    }
    __syncthreads();  // the next row's fill may not overtake this one
  }
}

}  // namespace

extern "C" int threefry2x32_launch(const void* keys, const void* data,
                                   void* out, long long R, long long n,
                                   int mode, float lo, float span,
                                   void* stream, void* out2, long long n2) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  if (R < 1 || mode < 0 || mode > 5) return static_cast<int>(
      cudaErrorInvalidValue);
  if (mode == 5) {
    if (out2 == nullptr || n2 < 1 || n2 > n || n >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    threefry2x32_select_kernel<<<static_cast<unsigned>(
                                     R < kMaxGridY ? R : kMaxGridY),
                                 kThreads, 0, s>>>(
        k, R, n, n2, static_cast<int*>(out), static_cast<int*>(out2));
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == 4) {
    if (out2 == nullptr || n < 0 || n2 < 0 || n + n2 < 1 ||
        n >= (1LL << 32) || n2 >= (1LL << 32))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(
        static_cast<unsigned>((n + n2 + kThreads - 1) / kThreads),
        static_cast<unsigned>(R < kMaxGridY ? R : kMaxGridY));
    threefry2x32_split_uniform_kernel<<<grid, kThreads, 0, s>>>(
        k, R, n, n2, static_cast<float*>(out), static_cast<float*>(out2), lo,
        span);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == 3) {
    if (data == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (R + kThreads - 1) / kThreads;
    threefry2x32_fold_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(k, static_cast<const long long*>(data),
                                    R, static_cast<long long*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  if (n < 1 || n >= (1LL << 32)) return static_cast<int>(
      cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(R < kMaxGridY ? R : kMaxGridY));
  switch (mode) {
    case 0:
      threefry2x32_kernel<0><<<grid, kThreads, 0, s>>>(k, R, n, out, lo,
                                                       span);
      break;
    case 1:
      threefry2x32_kernel<1><<<grid, kThreads, 0, s>>>(k, R, n, out, lo,
                                                       span);
      break;
    default:
      threefry2x32_kernel<2><<<grid, kThreads, 0, s>>>(k, R, n, out, lo,
                                                       span);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* threefry2x32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
