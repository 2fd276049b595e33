// One step of fast greedy k-DPP MAP (Chen et al. 2018, Cholesky-update
// form) for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel greedy_map_update_pallas (body _kernel) in
// src/repro/kernels/greedy_map.py. Same function: for the chosen item j with
// conditional variance dj, kernel column lcol = L[:, j], Cholesky buffer C
// (N x k) and its row cj = C[j, :],
//
//   e[n]     = (lcol[n] - sum_t C[n, t] cj[t]) / sqrt(max(dj, 1e-12))
//   d_new[n] = d[n] - e[n]^2
//
// for every n < N, any N and k (no block divisibility). C is read through
// its two strides, so a caller may pass a row-major (N, k) buffer or the
// transposed view of a (k, N) buffer: the greedy loop
// (repro_torch.kernels.ops.greedy_map_kdpp) keeps C^T as (k, N) rows, which
// makes its per-step column write one contiguous row and this kernel's
// loads coalesce across n. cj is a separate copy, so nothing here reads C
// while the loop writes it. The elementwise tail uses round-to-nearest
// intrinsics (no fused multiply-add), as the plain version computes it.
//
// What bounds it: bytes. A step reads C once (4 N k bytes) plus lcol and d,
// and writes e and d_new: about 4 N (k + 4) bytes against 2 N k operations,
// 0.5 per byte. At N = 10^4, k = 200 that is 8.2 MB, 2.4 us at 3.35 TB/s;
// at k = 20, 0.96 MB and 0.29 us, below a launch's own cost. (C fits the
// 50 MB L2, so across the steps of one MAP call it is mostly read from L2.)
//
// What the design does about it. The Pallas kernel streamed (bn, k) tiles of
// C through VMEM on a sequential grid. Here one block covers 32 consecutive
// items (the lanes of each warp) and its 8 warps split the k columns, so
// each warp reads 32 neighbouring items of one column: 128 contiguous bytes
// with the loop's (k, N) layout. There are ceil(N / 32) blocks (313 at
// N = 10^4) for the 132 SMs. The 8 partial sums of an item meet in shared
// memory and warp 0 finishes the item.
//
// Not done yet: one persistent kernel for all k steps (the masked argmax
// and the update fused, no host round trip per step), the column offset of
// the live prefix only (steps t < k read t columns, not k).

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kItems = 32;   // items per block: the lanes of a warp
constexpr int kSlices = 8;   // warps per block, each a slice of the columns

__global__ void __launch_bounds__(kItems* kSlices)
    greedy_map_update_kernel(const float* __restrict__ lcol,
                             const float* __restrict__ C,
                             const float* __restrict__ cj,
                             const float* __restrict__ dj,
                             const float* __restrict__ d,
                             float* __restrict__ e, float* __restrict__ dnew,
                             int N, int k, long long stride_n,
                             long long stride_t) {
  __shared__ float part[kSlices][kItems + 1];
  const int lane = threadIdx.x, slice = threadIdx.y;
  const int n = blockIdx.x * kItems + lane;
  float acc = 0.f;
  if (n < N) {
    const float* row = C + static_cast<long long>(n) * stride_n;
#pragma unroll 4
    for (int t = slice; t < k; t += kSlices)
      acc = fmaf(__ldg(row + static_cast<long long>(t) * stride_t),
                 __ldg(cj + t), acc);
  }
  part[slice][lane] = acc;
  __syncthreads();
  if (slice != 0 || n >= N) return;
  float proj = 0.f;
#pragma unroll
  for (int s = 0; s < kSlices; ++s) proj = __fadd_rn(proj, part[s][lane]);
  float v = __ldg(dj);
  v = v < 1e-12f ? 1e-12f : v;        // max(dj, 1e-12); a NaN stays NaN
  const float en = __fdiv_rn(__fsub_rn(__ldg(lcol + n), proj), __fsqrt_rn(v));
  e[n] = en;
  dnew[n] = __fsub_rn(__ldg(d + n), __fmul_rn(en, en));
}

}  // namespace

extern "C" int greedy_map_update_launch(const void* lcol, const void* C,
                                        const void* cj, const void* dj,
                                        const void* d, void* e, void* dnew,
                                        int N, int k, long long stride_n,
                                        long long stride_t, void* stream) {
  if (N < 1 || N > INT_MAX - kItems || k < 0 || stride_n < 0 || stride_t < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (N + kItems - 1) / kItems;
  greedy_map_update_kernel<<<blocks, dim3(kItems, kSlices), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lcol), static_cast<const float*>(C),
      static_cast<const float*>(cj), static_cast<const float*>(dj),
      static_cast<const float*>(d), static_cast<float*>(e),
      static_cast<float*>(dnew), N, k, stride_n, stride_t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_map_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
