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
// once, at the output. Any N1, N2 and batch (the JAX wrapper padded to 128
// for the TPU's matrix unit).
//
// What bounds it (chip_smoke.py km_bound). For a dense X, operations: a call
// does 2 batch (N1 N2^2 + N1^2 N2) of them on 4 (N1^2 + N2^2 + 2 batch N1 N2)
// bytes (fp32). At N1 = N2 = 100, batch 64: 256 MFLOP, 3.8 us at 67 TFLOP/s
// (fp32 on the CUDA cores; the port keeps TF32 off), against 5.2 MB, 1.6 us
// at 3.35 TB/s; in bfloat16 T = X . B^T is priced at the tensor-core rate and
// A . T at the fp32 rate, 2.0 us. For the eigenvector path's one-hot batch
// (one non-zero per X[b]), bytes: its 46 rows need 0.93 MFLOP, while X, A,
// B and Y are 3.8 MB, 1.1 us.
//
// The design, route 1 (one launch, T on chip). A block owns one batch entry
// b and a tile of VT columns v of Y, VT = 4 ceil(ceil(N2 / ceil(N2 / 32)) /
// 4): 28 at N2 = 100, tiles of 28, 28, 28 and 16 columns, 256 blocks at
// batch 64, no column quad masked. 256 threads; registers capped at 128 so
// that 2 blocks share an SM.
//   1. It copies B[v-tile, :] once (cp.async), and mat(X[b]) through
//      registers, 10 loads of 16 bytes in flight a thread; each thread
//      flags the rows of the non-zeros it copies, and warp 0 lists the
//      flagged rows in order.
//   2. It starts the copy of A's listed columns (Ac[k][r] = A[k][list[r]];
//      all of A by cp.async when every row is listed, a 4-byte cp.async
//      gather in float32), to land while T is computed.
//   3. T[rows, v-tile] = mat(X[b])[rows] . B[v-tile, :]^T for the listed
//      rows only, into float32 shared memory (as TsT[c][r]). float32: on the
//      CUDA cores, a thread 4 x 4 outputs from 4 + 4 float4 loads a 4 u; up
//      to 4 listed rows, a warp an output with its lanes splitting u and a
//      shuffle tree. bfloat16: on the tensor cores, mma.sync m16n8k16 (bf16
//      x bf16 -> f32, each product exact in float32), a warp per 16 x 8 tile.
//   4. Y[:, v-tile] = A[:, rows] . T[rows, v-tile] on the CUDA cores in
//      float32 (T is never rounded to bfloat16), a thread 4 x 4 outputs.
// T never goes to device memory: no scratch and one launch. A dense X lists
// every row and does the dense arithmetic; a one-hot X[b] lists one row,
// so Y[:, v-tile] = A[:, i] (x B[v-tile, u]) is one rounded product per
// output (the other terms of each sum are exact zeros), the same one the
// gather route computes. Skipping a zero row is exact only when A and B are
// finite (0 . Inf is NaN in a dense sum), so the first time a block would
// skip a row it reads A and its B tile once and flags (__syncthreads_or) an
// Inf or a NaN there; a flagged block lists every row of every entry and
// does the dense product, which spreads them as the Pallas kernel's
// X . B^T then A . T does. Row strides are padded so that the four-wide
// and mma fragment loads meet no bank conflicts. Shared memory at 100 x 100:
// 103 KB in float32, 70 KB in bfloat16.
//
// What holds it back at 100 x 100: the two float32 products. An SM's 4
// schedulers share one shared-memory port that serves a four-wide load a
// quarter warp a cycle, so a 4 x 4 tile's loads take twice its FMAs' issue
// time; 8 x 4 tiles halve the threads with work and ran slower. Then the
// staging of mat(X[b]), which each of the 4 column tiles of one b repeats.
//
// Route 2 (two passes through HBM), taken when route 1's shared memory
// (fused_geom below: mat(X[b]), A, the B tile and T, about 8 N1 N2 bytes in
// float32 at N1 = N2) exceeds the device's opt-in limit per block (227 KB on
// the H100: N1 = N2 up to 153 in float32, 200 in bfloat16). The route is
// decided once per shape, dtype and device: kron_matvec_route answers it (and,
// for route 1, raises the kernel's dynamic shared-memory cap to the device's
// opt-in limit), the caller keeps the answer and hands it to every
// kron_matvec_launch, which makes no device query. Route 2 is one templated
// tiled product Out[b] = P[b] . Q[b] of strided operands in 64 x 64 output
// tiles with a depth of 16, 256 threads each 4 x 4 outputs in registers,
// launched twice: T[b] = mat(X[b]) . B^T into a (batch, N1, N2) float32
// scratch that the wrapper allocates for this route only, then Y[b] = A .
// T[b]. All on the CUDA cores.
//
// Not done yet: TMA staging; wgmma for A . T (T is float32, so only as
// 3xTF32); a persistent grid that keeps A and mat(X[b]) on chip across the
// column tiles of one b; tensor cores on route 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// Route 2: two passes of a batched tiled product
// ---------------------------------------------------------------------------

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
cudaError_t kron_matvec_two_pass(const T* A, const T* B, const T* X,
                                 float* tmp, T* Y, int N1, int N2, int batch,
                                 cudaStream_t s) {
  const long long plane = static_cast<long long>(N1) * N2;
  // P = mat(X[b]): (N1, N2), row stride N2; Q[u, v] = B[v, u].
  cudaError_t e = batched_gemm<T, T, float>(X, plane, N2, 1, B, 0, 1, N2,
                                            tmp, batch, N1, N2, N2, s);
  if (e != cudaSuccess) return e;
  // P = A: (N1, N1); Q = T[b]: (N1, N2), row stride N2.
  return batched_gemm<T, float, T>(A, 0, N1, 1, tmp, plane, N2, 1, Y, batch,
                                   N1, N2, N1, s);
}

// ---------------------------------------------------------------------------
// Route 1: one launch, T in shared memory, zero rows skipped
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256, kFWarps = kFThreads / 32;
constexpr int kFBlocksPerSM = 2;   // registers capped at 128 a thread
constexpr int kMaxVT = 32;         // columns of Y a block owns, at most
constexpr int kInFlight = 10;      // loads a thread issues before it stores

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The smallest p >= round_up(n, q) with p % mod == rem.
__host__ __device__ constexpr int pad_stride(int n, int q, int mod, int rem) {
  return round_up(n, q) + ((rem - round_up(n, q) % mod) % mod + mod) % mod;
}

__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// Shapes and the shared-memory layout of route 1, computed on the host.
struct Geom {
  int N1, N2, batch;
  int VT;       // columns of Y a block owns, a multiple of 4
  int Kp;       // depth of T's product, zero-padded (to 4 fp32, 16 bf16)
  int XS;       // row stride of Xs and Bs, elements
  int BR;       // rows of Bs and of TsT (VT, rounded up to 8 for the mma)
  int AS;       // row stride of Ac (elements) and of TsT (floats)
  int vx, va;   // bytes a copy moves for rows of X and B, and of A (0: one
                // element at a time, through registers)
  int off_ac, off_bs, off_ts, off_list, off_flag, off_nr, smem;   // bytes
};

// Route 1's geometry; returns false when its shared memory passes `limit`.
template <typename T>
bool fused_geom(int N1, int N2, int batch, long long limit, Geom* g) {
  const bool bf = sizeof(T) == 2;
  const int tiles = (N2 + kMaxVT - 1) / kMaxVT;
  g->N1 = N1;
  g->N2 = N2;
  g->batch = batch;
  g->VT = round_up((N2 + tiles - 1) / tiles, 4);
  g->Kp = round_up(N2, bf ? 16 : 4);
  // XS / 4 and AS / 4 odd: the 16-byte (8-byte) loads of 8 (16)
  // consecutive rows hit distinct banks; bfloat16 XS % 64 == 8: so do the
  // mma fragment loads of 8 rows x 4 words
  g->XS = bf ? pad_stride(N2, 16, 64, 8) : pad_stride(N2, 4, 8, 4);
  g->BR = bf ? round_up(g->VT, 8) : g->VT;
  g->AS = pad_stride(N1, 4, 8, 4);
  g->vx = g->va = 0;
  long long off = align16(static_cast<long long>(N1) * g->XS * sizeof(T));
  g->off_ac = static_cast<int>(off < INT_MAX ? off : 0);
  off += align16(static_cast<long long>(N1) * g->AS * sizeof(T));
  g->off_bs = static_cast<int>(off < INT_MAX ? off : 0);
  off += align16(static_cast<long long>(g->BR) * g->XS * sizeof(T));
  g->off_ts = static_cast<int>(off < INT_MAX ? off : 0);
  off += align16(static_cast<long long>(g->BR) * g->AS * 4);
  g->off_list = static_cast<int>(off < INT_MAX ? off : 0);
  off += align16(4LL * N1);
  g->off_flag = static_cast<int>(off < INT_MAX ? off : 0);
  off += align16(4LL * N1);
  g->off_nr = static_cast<int>(off < INT_MAX ? off : 0);
  off += 16;
  g->smem = static_cast<int>(off < INT_MAX ? off : 0);
  return off <= limit;
}

// The widest piece (16, 8 or 4 bytes) that divides the address bits `at`,
// the source rows' bytes and the destination's row stride; 0 if none does.
inline int copy_bytes(uintptr_t at, long long row_bytes, long long ds_bytes) {
  for (int v = 16; v >= 4; v /= 2)
    if (at % v == 0 && row_bytes % v == 0 && ds_bytes % v == 0) return v;
  return 0;
}

template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(V));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copies dst[i][u] = src[i][u], i < rows, u < cols (row strides
// ss and ds in elements; each row a whole number of V-byte pieces, both
// sides aligned to V); cp_async_wait_all and a barrier complete them.
template <int V, typename T>
__device__ __forceinline__ void copy_async(const T* src, int ss, T* dst,
                                           int ds, int rows, int cols) {
  constexpr int ev = V / sizeof(T);
  const int nv = cols / ev;
  for (int e = threadIdx.x; e < rows * nv; e += kFThreads) {
    const int i = e / nv, u = (e - i * nv) * ev;
    cp_async<V>(dst + i * ds + u, src + static_cast<long long>(i) * ss + u);
  }
}

// The bits of a piece that make a value non-zero (all but the signs).
template <typename T>
__device__ __forceinline__ uint32_t magnitude(uint32_t w) {
  return w & (sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu);
}
template <typename T>
__device__ __forceinline__ uint32_t magnitude(const uint4& v) {
  return magnitude<T>(v.x | v.y | v.z | v.w);
}
template <typename T>
__device__ __forceinline__ uint32_t magnitude(const uint2& v) {
  return magnitude<T>(v.x | v.y);
}

// dst[i][u] = src[i][u] as copy_async does, but through registers,
// kInFlight independent loads a thread before its stores, so that it can
// set flag[i] = 1 for each row that holds a non-zero.
template <typename V, typename T>
__device__ __forceinline__ void copy_flagged(const T* __restrict__ src,
                                             int ss, T* dst, int ds,
                                             int rows, int cols, int* flag) {
  constexpr int ev = sizeof(V) / sizeof(T);
  const int nv = cols / ev, total = rows * nv;
  for (int base = threadIdx.x; base < total;
       base += kFThreads * kInFlight) {
    V v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int e = base + j * kFThreads, i = e / nv;
      if (e < total)
        v[j] = __ldg(reinterpret_cast<const V*>(
                         src + static_cast<long long>(i) * ss) + (e - i * nv));
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int e = base + j * kFThreads, i = e / nv;
      if (e < total) {
        reinterpret_cast<V*>(dst + i * ds)[e - i * nv] = v[j];
        if (magnitude<T>(v[j]) != 0u) flag[i] = 1;
      }
    }
  }
}

// The same element by element (rows that are no whole number of 4-byte
// pieces); flag may be null.
template <typename T>
__device__ __forceinline__ void copy_elems(const T* __restrict__ src,
                                           int ss, T* dst, int ds, int rows,
                                           int cols, int* flag) {
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total;
       base += kFThreads * kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int e = base + j * kFThreads, i = e / cols;
      if (e < total)
        v[j] = load_f(src + static_cast<long long>(i) * ss + (e - i * cols));
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int e = base + j * kFThreads, i = e / cols;
      if (e < total) {
        store_f(dst + i * ds + (e - i * cols), v[j]);
        if (flag != nullptr && v[j] != 0.f) flag[i] = 1;
      }
    }
  }
}

// mat(X[b]) into Xs, flagging its rows that hold a non-zero.
template <typename T>
__device__ __forceinline__ void stage_flagged(const T* src, int ss, T* dst,
                                              int ds, int rows, int cols,
                                              int vbytes, int* flag) {
  switch (vbytes) {
    case 16: copy_flagged<uint4>(src, ss, dst, ds, rows, cols, flag); break;
    case 8: copy_flagged<uint2>(src, ss, dst, ds, rows, cols, flag); break;
    case 4: copy_flagged<unsigned>(src, ss, dst, ds, rows, cols, flag); break;
    default: copy_elems(src, ss, dst, ds, rows, cols, flag);
  }
}

template <typename T>
__device__ __forceinline__ void copy_rows(const T* src, int ss, T* dst,
                                          int ds, int rows, int cols,
                                          int vbytes) {
  switch (vbytes) {
    case 16: copy_async<16>(src, ss, dst, ds, rows, cols); break;
    case 8: copy_async<8>(src, ss, dst, ds, rows, cols); break;
    case 4: copy_async<4>(src, ss, dst, ds, rows, cols); break;
    default: copy_elems(src, ss, dst, ds, rows, cols,
                        static_cast<int*>(nullptr));
  }
}

// dst[i][u] = 0 for i < rows, u in [u0, u1)
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int ds, int rows, int u0,
                                          int u1) {
  const int w = u1 - u0;
  for (int e = threadIdx.x; e < rows * w; e += kFThreads)
    store_f(dst + e / w * ds + u0 + e % w, 0.f);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bfloat16 is the high half of its float32
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// acc[i][j] = sum over u < K (a multiple of 4) of P[po[i] + u] Q[qo[j] + u]
// for i < RM, j < 4, on the CUDA cores in float32: RM + 4 four-wide loads a
// 4 u for 16 RM FMAs. Callers hand neighbouring lanes rows XS or AS apart,
// which puts their loads on distinct banks.
template <int RM, typename TP>
__device__ __forceinline__ void dot_tile(const TP* P, const int* po,
                                         const float* Q, const int* qo,
                                         int K, float acc[RM][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int u = 0; u < K; u += 4) {
    float4 p[RM], q[4];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = load4(P + po[i] + u);
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = load4(Q + qo[j] + u);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(p[i].x, q[j].x, acc[i][j]);
        acc[i][j] = fmaf(p[i].y, q[j].y, acc[i][j]);
        acc[i][j] = fmaf(p[i].z, q[j].z, acc[i][j]);
        acc[i][j] = fmaf(p[i].w, q[j].w, acc[i][j]);
      }
  }
}

// Rows of a thread's tile of T and of Y. One shared-memory port serves
// the SM's 4 schedulers, a four-wide load a quarter warp a cycle, so at
// RM = 4 the loads take twice the FMAs' issue time (1.5x at RM = 8); but
// at 100 x 28 outputs a block, RM = 8 leaves 3 warps of a block busy, too
// few to hide the loads' latency, and ran slower on the H100.
constexpr int kRM = 4;
constexpr int kFewRows = 4;  // up to this many listed rows, T goes by warps

// T[r][c] = sum_u Xs[list[r]][u] Bs[c][u] into TsT[c][r] (float32, CUDA
// cores), for c < 4 CQ (columns past the live ones come out zero). A
// thread owns rows r = ro + R i (i < kRM, R = nr / kRM rounded up) and columns
// c = cq + CQ j (j < 4); rows past nr read the last listed row and are not
// stored. Up to kFewRows rows, so few tiles would leave most threads idle
// along a 4 N2-long chain each; there a warp takes one output at a time,
// its lanes split u and a shuffle tree sums them (for a one-hot row every
// term but one is zero, so the sum is still that one product).
__device__ __forceinline__ void t_product_f32(const float* Xs,
                                              const float* Bs, float* TsT,
                                              const int* list, const Geom& g,
                                              int nr, int CQ) {
  if (nr <= kFewRows) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int o = warp; o < nr * 4 * CQ; o += kFWarps) {
      const int r = o / (4 * CQ), c = o - r * 4 * CQ;
      const float* x = Xs + list[r] * g.XS;
      const float* bc = Bs + c * g.XS;
      float acc = 0.f;
      for (int u = lane; u < g.N2; u += 32) acc = fmaf(x[u], bc[u], acc);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (lane == 0) TsT[c * g.AS + r] = acc;
    }
    return;
  }
  const int R = (nr + kRM - 1) / kRM;
  for (int p = threadIdx.x; p < R * CQ; p += kFThreads) {
    const int ro = p / CQ, cq = p - ro * CQ;
    int xo[kRM], bo[4];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ro + R * i;
      xo[i] = list[r < nr ? r : nr - 1] * g.XS;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) bo[j] = (cq + CQ * j) * g.XS;
    float acc[kRM][4];
    dot_tile<kRM>(Xs, xo, Bs, bo, g.Kp, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ro + R * i;
      if (r < nr)
#pragma unroll
        for (int j = 0; j < 4; ++j) TsT[(cq + CQ * j) * g.AS + r] = acc[i][j];
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) . B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// T for the listed rows on the tensor cores into TsT[c][r]: a warp per 16 x
// 8 tile of T. Fragments of m16n8k16 (PTX ISA): lane = 4 gid + tq; A holds
// rows gid and gid + 8 at columns 2 tq (+1) and 2 tq + 8 (+1); B column gid
// at rows 2 tq (+1) and 2 tq + 8 (+1); D rows gid, gid + 8 at columns 2 tq,
// 2 tq + 1.
__device__ __forceinline__ void t_product_bf16(const __nv_bfloat16* Xs,
                                               const __nv_bfloat16* Bs,
                                               float* TsT, const int* list,
                                               const Geom& g, int nr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int nt = g.BR / 8, tiles = (nr + 15) / 16 * nt;
  for (int tile = warp; tile < tiles; tile += kFWarps) {
    const int m0 = tile / nt * 16, n0 = tile % nt * 8;
    const int rlo = m0 + gid, rhi = rlo + 8;
    const bool lo = rlo < nr, hi = rhi < nr;
    const __nv_bfloat16* xlo = Xs + (lo ? list[rlo] : 0) * g.XS + 2 * tq;
    const __nv_bfloat16* xhi = Xs + (hi ? list[rhi] : 0) * g.XS + 2 * tq;
    const __nv_bfloat16* bp = Bs + (n0 + gid) * g.XS + 2 * tq;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k0 = 0; k0 < g.Kp; k0 += 16) {
      mma_bf16(d, lo ? ld32(xlo + k0) : 0u, hi ? ld32(xhi + k0) : 0u,
               lo ? ld32(xlo + k0 + 8) : 0u, hi ? ld32(xhi + k0 + 8) : 0u,
               ld32(bp + k0), ld32(bp + k0 + 8));
    }
    float* col = TsT + (n0 + 2 * tq) * g.AS;
    if (lo) col[rlo] = d[0], col[g.AS + rlo] = d[1];
    if (hi) col[rhi] = d[2], col[g.AS + rhi] = d[3];
  }
}

// Y[k][c] = sum over the listed rows r of Ac[k][r] T[r][c] (float32, CUDA
// cores). A thread owns rows k = ko + KR i (i < kRM, KR = N1 / kRM rounded
// up) and columns c = cq + CQ j (j < 4).
template <typename T>
__device__ __forceinline__ void y_product(const T* Ac, const float* TsT,
                                          T* Yb, const Geom& g, int nr4,
                                          int CQ, int live_c) {
  const int KR = (g.N1 + kRM - 1) / kRM;
  for (int p = threadIdx.x; p < KR * CQ; p += kFThreads) {
    const int ko = p / CQ, cq = p - ko * CQ;
    int ao[kRM], to[4];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int k = ko + KR * i;
      ao[i] = (k < g.N1 ? k : g.N1 - 1) * g.AS;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) to[j] = (cq + CQ * j) * g.AS;
    float acc[kRM][4];
    dot_tile<kRM>(Ac, ao, TsT, to, nr4, acc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int k = ko + KR * i;
      if (k < g.N1)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cq + CQ * j < live_c)
            store_f(Yb + static_cast<long long>(k) * g.N2 + cq + CQ * j,
                    acc[i][j]);
    }
  }
}

// Non-zero when a piece holds an Inf or a NaN (exponent bits all set).
template <typename T>
__device__ __forceinline__ unsigned nonfinite_bits(uint32_t w) {
  if constexpr (sizeof(T) == 4) return (w & 0x7f800000u) == 0x7f800000u;
  return (w & 0x7f80u) == 0x7f80u || (w & 0x7f800000u) == 0x7f800000u;
}
template <typename T>
__device__ __forceinline__ unsigned nonfinite_bits(const uint4& v) {
  return nonfinite_bits<T>(v.x) | nonfinite_bits<T>(v.y) |
         nonfinite_bits<T>(v.z) | nonfinite_bits<T>(v.w);
}

// Non-zero when one of the n elements at p holds an Inf or a NaN: 16-byte
// pieces, kInFlight loads a thread in flight, where p is 16-byte aligned,
// the rest one by one. This thread's share only.
template <typename T>
__device__ __forceinline__ unsigned nonfinite_in(const T* __restrict__ p,
                                                 int n) {
  unsigned bad = 0;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const int nv = n / static_cast<int>(16 / sizeof(T));
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    for (int base = threadIdx.x; base < nv; base += kFThreads * kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int e = base + j * kFThreads;
        v[j] = e < nv ? __ldg(pv + e) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) bad |= nonfinite_bits<T>(v[j]);
    }
    done = nv * static_cast<int>(16 / sizeof(T));
  }
  for (int e = done + threadIdx.x; e < n; e += kFThreads)
    bad |= !isfinite(load_f(p + e));
  return bad;
}

// 1 in every thread when A (N1 x N1) or the B tile Bt (rows x N2, rows
// contiguous) holds an Inf or a NaN, else 0. A barrier.
template <typename T>
__device__ __forceinline__ int any_nonfinite(const T* __restrict__ A,
                                             int N1,
                                             const T* __restrict__ Bt,
                                             int rows, int N2) {
  const unsigned bad = nonfinite_in(A, N1 * N1) | nonfinite_in(Bt, rows * N2);
  return __syncthreads_or(bad != 0u);
}

template <typename T>
__global__ void __launch_bounds__(kFThreads, kFBlocksPerSM)
    kron_matvec_fused_kernel(const T* __restrict__ A,
                             const T* __restrict__ B,
                             const T* __restrict__ X, T* __restrict__ Y,
                             const Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);                  // mat(X[b])
  T* Ac = reinterpret_cast<T*>(smem + g.off_ac);       // A[:, rows]
  T* Bs = reinterpret_cast<T*>(smem + g.off_bs);       // B[v-tile, :]
  float* TsT = reinterpret_cast<float*>(smem + g.off_ts);  // T[rows, tile]^T
  int* list = reinterpret_cast<int*>(smem + g.off_list);
  int* flag = reinterpret_cast<int*>(smem + g.off_flag);
  int* s_nr = reinterpret_cast<int*>(smem + g.off_nr);
  const int N1 = g.N1, N2 = g.N2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int v0 = blockIdx.x * g.VT;
  const int live_c = N2 - v0 < g.VT ? N2 - v0 : g.VT;
  const int CQ = (live_c + 3) / 4;      // live column quads

  // B[v-tile, :] once (its copies complete with the first X[b]'s), zero
  // past the live columns and past N2
  copy_rows(B + static_cast<long long>(v0) * N2, N2, Bs, g.XS, live_c, N2,
            g.vx);
  zero_cols(Bs, g.XS, live_c, N2, g.Kp);
  zero_cols(Bs + live_c * g.XS, g.XS, g.BR - live_c, 0, g.Kp);
  for (int i = tid; i < N1; i += kFThreads) flag[i] = 0;
  int nonfinite = -1;     // A or the B tile holds an Inf or a NaN; -1 unread

  for (int b = blockIdx.y; b < g.batch; b += gridDim.y) {
    __syncthreads();      // the previous entry's reads are done
    // 1. stage mat(X[b]); each thread flags the rows of the non-zeros it
    //    copies
    stage_flagged(X + static_cast<long long>(b) * N1 * N2, N2, Xs, g.XS, N1,
                  N2, g.vx, flag);
    zero_cols(Xs, g.XS, N1, N2, g.Kp);
    cp_async_wait_all();                 // B's copies, on the first entry
    __syncthreads();
    // 2. list the flagged rows in order (warp 0)
    if (warp == 0) {
      int n = 0;
      for (int base = 0; base < N1; base += 32) {
        const int i = base + lane;
        const bool f = i < N1 && flag[i];
        const unsigned m = __ballot_sync(0xffffffffu, f);
        if (f) list[n + __popc(m & ((1u << lane) - 1u))] = i;
        if (i < N1) flag[i] = 0;         // for the next entry
        n += __popc(m);
      }
      if (lane == 0) *s_nr = n;
    }
    __syncthreads();
    int nr = *s_nr;
    if (nr < N1) {          // a zero row would be skipped (block-uniform)
      if (nonfinite < 0)
        nonfinite = any_nonfinite(A, N1, B + static_cast<long long>(v0) * N2,
                                  live_c, N2);
      if (nonfinite) {      // dense, so that 0 . Inf and NaN spread
        for (int i = tid; i < N1; i += kFThreads) list[i] = i;
        nr = N1;
        __syncthreads();
      }
    }
    const int nr4 = round_up(nr, 4);
    // 3. A's listed columns, Ac[k][r] = A[k][list[r]], columns nr .. nr4
    //    zero: every row copied in flight while T is computed, or
    //    gathered now
    if (nr == N1) {
      copy_rows(A, N1, Ac, g.AS, N1, N1, g.va);
    } else if constexpr (sizeof(T) == 4) {
      for (int e = tid; e < N1 * nr; e += kFThreads) {
        const int k = e / nr, r = e - k * nr;
        cp_async<4>(Ac + k * g.AS + r,
                    A + static_cast<long long>(k) * N1 + list[r]);
      }
    } else {
      for (int base = tid; base < N1 * nr; base += kFThreads * kInFlight) {
        float v[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int e = base + j * kFThreads, k = e / nr;
          if (e < N1 * nr)
            v[j] = load_f(A + static_cast<long long>(k) * N1 +
                          list[e - k * nr]);
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int e = base + j * kFThreads, k = e / nr;
          if (e < N1 * nr) store_f(Ac + k * g.AS + e - k * nr, v[j]);
        }
      }
    }
    zero_cols(Ac, g.AS, N1, nr, nr4);
    // 4. T[rows, v-tile] into TsT[c][r]; columns nr .. nr4 zero
    if constexpr (sizeof(T) == 2)
      t_product_bf16(Xs, Bs, TsT, list, g, nr);
    else
      t_product_f32(Xs, Bs, TsT, list, g, nr, CQ);
    zero_cols(TsT, g.AS, g.BR, nr, nr4);
    cp_async_wait_all();
    __syncthreads();
    // 5. Y[:, v-tile] = A[:, rows] . T[rows, v-tile]
    y_product(Ac, TsT, Y + static_cast<long long>(b) * N1 * N2 + v0, g, nr4,
              CQ, live_c);
  }
}

// The opt-in shared memory a block of the current device may use.
cudaError_t smem_limit(long long* limit) {
  int dev = 0, v = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  *limit = v;
  return e;
}

template <typename T>
cudaError_t kron_matvec_fused(const T* A, const T* B, const T* X, T* Y,
                              const Geom& g, cudaStream_t s) {
  const dim3 grid((g.N2 + g.VT - 1) / g.VT,
                  g.batch < kMaxGridYZ ? g.batch : kMaxGridYZ);
  kron_matvec_fused_kernel<T><<<grid, kFThreads, g.smem, s>>>(A, B, X, Y, g);
  return cudaGetLastError();
}

// 0: route 1 (one launch); 1: route 2 (two passes, needs the scratch). On
// route 1 the kernel's dynamic shared-memory cap becomes the current
// device's opt-in limit, which serves every shape of the route.
template <typename T>
cudaError_t route_of(int N1, int N2, int* route) {
  long long limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return e;
  Geom g;
  *route = fused_geom<T>(N1, N2, 1, limit, &g) ? 0 : 1;
  if (*route == 0)
    e = cudaFuncSetAttribute(kron_matvec_fused_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(limit));
  return e;
}

template <typename T>
cudaError_t kron_matvec(const T* A, const T* B, const T* X, float* tmp, T* Y,
                        int N1, int N2, int batch, int route,
                        cudaStream_t s) {
  if (route == 1) {
    if (tmp == nullptr) return cudaErrorInvalidValue;
    return kron_matvec_two_pass(A, B, X, tmp, Y, N1, N2, batch, s);
  }
  Geom g;
  if (route != 0 || !fused_geom<T>(N1, N2, batch, INT_MAX, &g))
    return cudaErrorInvalidValue;
  const long long es = sizeof(T);
  g.vx = copy_bytes(reinterpret_cast<uintptr_t>(X) |
                        reinterpret_cast<uintptr_t>(B),
                    N2 * es, g.XS * es);
  g.va = copy_bytes(reinterpret_cast<uintptr_t>(A), N1 * es, g.AS * es);
  return kron_matvec_fused(A, B, X, Y, g, s);
}

bool shape_ok(int N1, int N2, int batch) {
  return N1 >= 1 && N2 >= 1 && batch >= 1 && N1 <= kMaxGridYZ * kBM &&
         N2 <= INT_MAX - kBN && static_cast<long long>(N1) * N2 <= INT_MAX;
}

}  // namespace

// Route for these factor sizes and dtype (0 float32, 1 bfloat16) on the
// current device: *route = 0 for one launch with T on chip, 1 for two passes
// through a (batch, N1, N2) float32 scratch. Ask once per shape, dtype and
// device before launching (route 0 needs the shared-memory cap it sets).
// Returns a CUDA error code.
extern "C" int kron_matvec_route(int N1, int N2, int dtype, int* route) {
  if (!shape_ok(N1, N2, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0)
    e = route_of<float>(N1, N2, route);
  else if (dtype == 1)
    e = route_of<__nv_bfloat16>(N1, N2, route);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// dtype: 0 float32, 1 bfloat16 (A, B, X and Y all of it). route: what
// kron_matvec_route gave for N1, N2 and dtype on this device. tmp: the
// float32 scratch of route 2, ignored (and may be null) on route 1.
extern "C" int kron_matvec_launch(const void* A, const void* B,
                                  const void* X, void* tmp, void* Y, int N1,
                                  int N2, int batch, int dtype, int route,
                                  void* stream) {
  if (!shape_ok(N1, N2, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = kron_matvec(static_cast<const float*>(A),
                    static_cast<const float*>(B),
                    static_cast<const float*>(X), static_cast<float*>(tmp),
                    static_cast<float*>(Y), N1, N2, batch, route, s);
  else if (dtype == 1)
    e = kron_matvec(static_cast<const __nv_bfloat16*>(A),
                    static_cast<const __nv_bfloat16*>(B),
                    static_cast<const __nv_bfloat16*>(X),
                    static_cast<float*>(tmp),
                    static_cast<__nv_bfloat16*>(Y), N1, N2, batch, route,
                    s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* kron_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
