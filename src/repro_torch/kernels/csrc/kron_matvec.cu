// Batched Kronecker matrix-vector product for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel kron_matvec_pallas (body _kernel) in
// src/repro/kernels/kron_matvec.py. Same function, by the vec-trick:
//
//   Y[b] = (A kron B) X[b] = vec(A . mat(X[b]) . B^T)
//
// with A (N1 x N1), B (N2 x N2), X (batch, N1 N2) and mat(X[b]) its
// row-major (N1, N2) view; float32 or bfloat16 inputs (all three of one
// type), every product accumulated in float32, the output in X's type.
// T = mat(X[b]) . B^T is kept in float32 between the two products, as the
// Pallas kernel keeps it (its preferred_element_type), so bfloat16 rounds
// once, at the output. Any N1, N2 and batch: the tiles mask their ragged
// edges (the JAX wrapper padded to 128 for the TPU's matrix unit).
//
// What bounds it: operations. A call does 2 batch (N1 N2^2 + N1^2 N2)
// floating-point operations on 4 (N1^2 + N2^2 + 2 batch N1 N2) bytes (fp32).
// At N1 = N2 = 100, batch 64: 256 MFLOP, 3.8 us at 67 TFLOP/s (fp32 on the
// CUDA cores; the port keeps TF32 off), against 5.2 MB, 1.6 us at 3.35 TB/s.
//
// What the design does about it, for now: a plain tiled product on the CUDA
// cores, correct first and fast later. One templated kernel computes a
// batched product Out[b] = P[b] . Q[b] of strided operands in 64 x 64
// output tiles with a depth of 16: 256 threads, each 4 x 4 outputs held in
// registers (rows ty + 16 r, columns tx + 16 c, so shared-memory reads are
// conflict-free and the stores of a half warp coalesce), both operand tiles
// staged in shared memory as float32, the loads coalesced along whichever
// stride is 1. Two launches of it make one call: T[b] = mat(X[b]) . B^T
// into a (batch, N1, N2) float32 scratch, then Y[b] = A . T[b]. At 100 x
// 100 the 64 x 64 tiles cover 128 x 128, so 39% of the tile work is masked.
//
// Not done yet: tensor cores (wgmma on TF32 or bf16, which would change the
// rounding), TMA staging, one launch for both products with T kept on chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;   // 16 x 16, each 4 x 4 outputs
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Out[b, m, n] = sum_k P[b, m, k] Q[b, k, n]; Out is contiguous (batch, M,
// N). Strides are in elements; a batch stride of 0 shares one operand.
template <typename TP, typename TQ, typename TO>
__global__ void __launch_bounds__(kThreads)
    batched_gemm_kernel(const TP* __restrict__ P, long long p_sb,
                        long long p_sm, long long p_sk,
                        const TQ* __restrict__ Q, long long q_sb,
                        long long q_sk, long long q_sn, TO* __restrict__ out,
                        int batch, int M, int N, int K) {
  __shared__ float Ps[kBK][kBM + 4];   // Ps[k][m]
  __shared__ float Qs[kBK][kBN + 4];   // Qs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const TP* Pb = P + b * p_sb;
    const TQ* Qb = Q + b * q_sb;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      // stage the P tile (kBM x kBK), consecutive threads on the unit stride
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        int m, kk;
        if (p_sk == 1) { m = i / kBK; kk = i % kBK; }
        else { kk = i / kBM; m = i % kBM; }
        const int gm = m0 + m, gk = k0 + kk;
        Ps[kk][m] = (gm < M && gk < K) ? load_f(Pb + gm * p_sm + gk * p_sk)
                                       : 0.f;
      }
      // stage the Q tile (kBK x kBN)
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        int n, kk;
        if (q_sn == 1) { kk = i / kBN; n = i % kBN; }
        else { n = i / kBK; kk = i % kBK; }
        const int gn = n0 + n, gk = k0 + kk;
        Qs[kk][n] = (gn < N && gk < K) ? load_f(Qb + gk * q_sk + gn * q_sn)
                                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], q[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Ps[kk][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) q[c] = Qs[kk][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], q[c], acc[r][c]);
      }
      __syncthreads();
    }
    TO* ob = out + static_cast<long long>(b) * M * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gm = m0 + ty + 16 * r;
      if (gm >= M) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gn = n0 + tx + 16 * c;
        if (gn < N) store_f(ob + static_cast<long long>(gm) * N + gn,
                            acc[r][c]);
      }
    }
  }
}

template <typename TP, typename TQ, typename TO>
cudaError_t batched_gemm(const TP* P, long long p_sb, long long p_sm,
                         long long p_sk, const TQ* Q, long long q_sb,
                         long long q_sk, long long q_sn, TO* out, int batch,
                         int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM,
                  batch < kMaxGridYZ ? batch : kMaxGridYZ);
  batched_gemm_kernel<TP, TQ, TO><<<grid, kThreads, 0, s>>>(
      P, p_sb, p_sm, p_sk, Q, q_sb, q_sk, q_sn, out, batch, M, N, K);
  return cudaGetLastError();
}

// T[b] = mat(X[b]) . B^T (float32 scratch), then Y[b] = A . T[b].
template <typename T>
cudaError_t kron_matvec(const T* A, const T* B, const T* X, float* tmp, T* Y,
                        int N1, int N2, int batch, cudaStream_t s) {
  const long long plane = static_cast<long long>(N1) * N2;
  // P = mat(X[b]): (N1, N2), row stride N2; Q[u, v] = B[v, u].
  cudaError_t e = batched_gemm<T, T, float>(X, plane, N2, 1, B, 0, 1, N2,
                                            tmp, batch, N1, N2, N2, s);
  if (e != cudaSuccess) return e;
  // P = A: (N1, N1); Q = T[b]: (N1, N2), row stride N2.
  return batched_gemm<T, float, T>(A, 0, N1, 1, tmp, plane, N2, 1, Y, batch,
                                   N1, N2, N1, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (A, B, X and Y all of it).
extern "C" int kron_matvec_launch(const void* A, const void* B,
                                  const void* X, void* tmp, void* Y, int N1,
                                  int N2, int batch, int dtype,
                                  void* stream) {
  if (N1 < 1 || N2 < 1 || batch < 1 || N1 > kMaxGridYZ * kBM ||
      N2 > INT_MAX - kBN || static_cast<long long>(N1) * N2 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = kron_matvec(static_cast<const float*>(A),
                    static_cast<const float*>(B),
                    static_cast<const float*>(X), static_cast<float*>(tmp),
                    static_cast<float*>(Y), N1, N2, batch, s);
  else if (dtype == 1)
    e = kron_matvec(static_cast<const __nv_bfloat16*>(A),
                    static_cast<const __nv_bfloat16*>(B),
                    static_cast<const __nv_bfloat16*>(X),
                    static_cast<float*>(tmp),
                    static_cast<__nv_bfloat16*>(Y), N1, N2, batch, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* kron_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
