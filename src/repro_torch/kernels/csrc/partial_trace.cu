// Partial traces of the dense Theta for KrK-Picard's batch route, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernels partial_trace_A_pallas (body _kernel_A)
// and partial_trace_C_pallas (body _kernel_C) in
// src/repro/kernels/partial_trace.py. Same functions, same contract: with
// Theta4 the (N1, N2, N1, N2) row-major view of the N x N matrix Theta,
// N = N1 N2,
//
//   A[k, l] = sum_{u,v} Theta4[k, u, l, v] L2[v, u]          (N1 x N1)
//   C[u, v] = sum_{i,j} L1[i, j] Theta4[i, u, j, v]          (N2 x N2)
//
// for any N1, N2 (no divisibility), L1 and L2 not assumed symmetric. All
// offsets into Theta are 64-bit: N^2 passes 2^31 at N = 46,341.
//
// What bounds it: bytes. Each function reads Theta once (4 N^2 bytes) and
// does 2 N^2 floating-point operations on it, 0.5 per byte, far below the
// card's balance. At N = 10^4 Theta is 400 MB, eight times the 50 MB L2, so
// it streams from HBM: 0.119 ms at 3.35 TB/s is the least time for each of
// A and C. L1, L2 and the outputs are N1^2 + N2^2 floats, noise beside it.
//
// What the design does about it. The Pallas kernels tiled Theta into VMEM
// slabs and ran one matvec per slab on a sequential grid. Here every thread
// streams Theta along v, the contiguous axis, so each warp's loads coalesce:
//
// * A: one block per (k, l) pair (N1^2 blocks, 10^4 at N1 = 100). The
//   block's N2 x N2 slice Theta4[k, :, l, :] is N2 rows of N2 contiguous
//   floats. Its threads walk the slice flattened, j = u N2 + v, so all of
//   them are busy whatever N2 is, and read w = L2^T (transposed once by the
//   wrapper) at the same j, coalesced too. Then a block reduction.
// * C: one block per 1024 consecutive (u, v) elements of the plane and per
//   i, so the sum over (i, j) is split across blocks (N1 ceil(N2^2/1024)
//   blocks, 1000 at N = 100 x 100, against the 100 of one block per u). The
//   block loops over j, with L1[i, j] one broadcast load, and writes its
//   partial sum over j into an (N1, N2^2) scratch; a second kernel sums the
//   scratch over i. Both passes are deterministic (no atomics). The scratch
//   is N N2 floats, 4 MB at N = 10^4: 1% of Theta's traffic.
//
// Not done yet: one pass that reads Theta once for both A and C (the
// engine needs both from the same Theta on every sweep); TMA staging of
// Theta tiles; reusing w across several l in one block of A (every block
// now reads all of w from L2).

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPerThread = 4;   // (u, v) elements per thread in C's first pass

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum over the block (blockDim.x a multiple of 32); valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? red[lane] : 0.f;
    v = warp_sum(v);
  }
  return v;
}

// A[k, l]: block kl = k N1 + l; w[u N2 + v] = L2[v, u].
__global__ void partial_trace_A_kernel(const float* __restrict__ theta,
                                       const float* __restrict__ w,
                                       float* __restrict__ out, int N1,
                                       int N2) {
  const int kl = blockIdx.x;
  const int k = kl / N1, l = kl - k * N1;
  const size_t N = static_cast<size_t>(N1) * N2;
  const float* base = theta + static_cast<size_t>(k) * N2 * N +
                      static_cast<size_t>(l) * N2;
  const int M = N2 * N2;
  const int T = blockDim.x;
  const int du = T / N2, dv = T - du * N2;
  int u = threadIdx.x / N2, v = threadIdx.x - u * N2;   // j = u N2 + v
  float acc = 0.f;
#pragma unroll 4
  for (int j = threadIdx.x; j < M; j += T) {
    acc = fmaf(__ldg(base + static_cast<size_t>(u) * N + v), __ldg(w + j),
               acc);
    u += du;
    v += dv;
    if (v >= N2) {
      v -= N2;
      ++u;
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[kl] = s;
}

// part[i, q] = sum_j L1[i, j] Theta4[i, u, j, v], q = u N2 + v; block
// i * tiles + tile covers q in [tile kPerThread T, (tile + 1) kPerThread T).
__global__ void partial_trace_C_partial_kernel(const float* __restrict__ theta,
                                               const float* __restrict__ l1,
                                               float* __restrict__ part,
                                               int N1, int N2, int tiles) {
  const int i = blockIdx.x / tiles, tile = blockIdx.x - i * tiles;
  const int M = N2 * N2;
  const size_t N = static_cast<size_t>(N1) * N2;
  const int T = blockDim.x;
  const float* slab = theta + static_cast<size_t>(i) * N2 * N;  // [i, 0, 0, 0]
  size_t off[kPerThread];
  float acc[kPerThread];
  int q[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    q[r] = (tile * kPerThread + r) * T + threadIdx.x;
    const int qq = q[r] < M ? q[r] : M - 1;   // dead slots read a live address
    const int u = qq / N2, v = qq - u * N2;
    off[r] = static_cast<size_t>(u) * N + v;
    acc[r] = 0.f;
  }
  const float* l1row = l1 + static_cast<size_t>(i) * N1;
  for (int j = 0; j < N1; ++j) {
    const float c = __ldg(l1row + j);
    const float* t = slab + static_cast<size_t>(j) * N2;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r)
      acc[r] = fmaf(c, __ldg(t + off[r]), acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (q[r] < M) part[static_cast<size_t>(i) * M + q[r]] = acc[r];
}

// out[q] = sum_i part[i, q].
__global__ void partial_trace_C_sum_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int N1,
                                           int M) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= M) return;
  float s = 0.f;
  for (int i = 0; i < N1; ++i) s += __ldg(part + static_cast<size_t>(i) * M + q);
  out[q] = s;
}

bool bad_threads(int threads) {
  return threads < 32 || threads > 1024 || threads % 32 != 0;
}

}  // namespace

extern "C" int partial_trace_A_launch(const void* theta, const void* w,
                                      void* out, int N1, int N2, int threads,
                                      void* stream) {
  const long long blocks = static_cast<long long>(N1) * N1;
  if (N1 < 1 || N2 < 1 || bad_threads(threads) || blocks > INT_MAX ||
      static_cast<long long>(N2) * N2 > INT_MAX - threads)
    return static_cast<int>(cudaErrorInvalidValue);
  partial_trace_A_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(w),
      static_cast<float*>(out), N1, N2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int partial_trace_C_launch(const void* theta, const void* l1,
                                      void* part, void* out, int N1, int N2,
                                      int threads, void* stream) {
  const long long M = static_cast<long long>(N2) * N2;
  const long long per_block = static_cast<long long>(kPerThread) * threads;
  const long long tiles = (M + per_block - 1) / per_block;
  const long long blocks = tiles * N1;
  if (N1 < 1 || N2 < 1 || bad_threads(threads) || M > INT_MAX - per_block ||
      blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  partial_trace_C_partial_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                   s>>>(
      static_cast<const float*>(theta), static_cast<const float*>(l1),
      static_cast<float*>(part), N1, N2, static_cast<int>(tiles));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  partial_trace_C_sum_kernel<<<static_cast<unsigned>((M + threads - 1) / threads),
                               threads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), N1,
      static_cast<int>(M));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* partial_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
