// Fast greedy k-DPP MAP (Chen et al. 2018, Cholesky-update form) for Hopper
// (sm_90a): one update step (greedy_map_update_kernel), and the whole
// selection of k items, every step of it, for a batch of matrices in one
// launch (greedy_map_kdpp_kernel).
//
// ---- The step kernel --------------------------------------------------------
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
// transposed view of a (k, N) buffer (C^T as (k, N) rows makes a column
// write one contiguous row and this kernel's loads coalesce across n). cj
// is a separate copy, so nothing here reads C while a caller writes it. The
// elementwise tail uses round-to-nearest intrinsics (no fused
// multiply-add), as the plain version computes it.
//
// What bounds it: bytes. A step reads C once (4 N k bytes) plus lcol and d,
// and writes e and d_new: about 4 N (k + 4) bytes against 2 N k operations,
// 0.5 per byte. At N = 10^4, k = 200 that is 8.2 MB, 2.4 us at 3.35 TB/s;
// at k = 20, 0.96 MB and 0.29 us, below a launch's own cost.
//
// What the design does about it. The Pallas kernel streamed (bn, k) tiles of
// C through VMEM on a sequential grid. Here one block covers 32 consecutive
// items (the lanes of each warp) and its 8 warps split the k columns, so
// each warp reads 32 neighbouring items of one column: 128 contiguous bytes
// with a (k, N) layout. There are ceil(N / 32) blocks (313 at N = 10^4) for
// the 132 SMs. The 8 partial sums of an item meet in shared memory and
// warp 0 finishes the item.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
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

// ---- The whole selection: greedy_map_kdpp_kernel ------------------------------
//
// Replaces: greedy_map_update_pallas together with the scan around it
// (src/repro/kernels/ops.py greedy_map_kdpp, vmapped over (batch, KV head)
// by src/repro/serve/kv_compaction.py). For each matrix L_h (N x N) of a
// batch and one k in 1..N, the reference's picks, step by step:
//
//   d = diag L, chosen = {}, eps = 1e-8 max(max diag L, 1e-30)
//   for t < k:
//     j  = argmax(where(chosen, -inf, d)), the first maximum, NaN the largest
//     ok = d[j] > eps
//     e  = ok ? (L[:, j] - C[:, :t] C[j, :t]) / sqrt(max(d[j], eps, 1e-12))
//             : 0
//     d  = ok ? max(d - e^2, 0) : d;  C[:, t] = e;  chosen += {j}
//     picks[t] = j
//
// Every item is updated, chosen or not, as in the reference, so d[j] is the
// reference's even where a pick meets only -inf scores. The dot runs over
// the live prefix only, t columns at step t (the reference's unwritten
// columns are zeros): the same sum in another order. L is read by columns,
// L[:, j], never by rows: a kernel matrix from a float32 product need not be
// bitwise symmetric.
//
// What bounds it. Bytes: the diagonal and k columns of L read once (4 N
// (k + 1) a matrix), the picks written; C stays on chip or in L2. Operations:
// N k (k - 1) for the dots and about 6 N k for the rest: at N = 10^4, k = 200
// 0.41 GFLOP, 6.1 us at 67 TFLOP/s on the whole card. But the k steps are a
// serial chain, each ending in an argmax over all N items on which the next
// step depends, so a matrix's floor is k times the latency of one step (its
// cluster-wide argmax, one column gathered, the update), far above both.
//
// What the design does about it: one persistent thread-block cluster per
// matrix runs all k steps, with no host round trip and no launch per step.
// A cluster has CS CTAs of 512 threads, CS the least power of two that
// leaves a CTA at most 128 items, at most 16: 1 up to N = 128, 4 at N = 512,
// 16 from N = 1921 on. CS depends on N alone (and on what the card grants,
// see the plan below), so a matrix's arithmetic is the same whatever the
// batch. CTA r owns items [r n_per, (r + 1) n_per), n_per = ceil(N / CS),
// and keeps their d, chosen flags and column of L in shared memory. A step:
//   1. each thread's best (key, d) over its items, where key = the score's
//      ordered bits (NaN above +inf, -0 as +0) << 32 | (2^32 - 1 - item), so
//      that the largest key is the first maximum; warp shuffles, then the
//      warps' bests through shared memory, give the CTA's candidate, which
//      warp 0 stores into its slot of every CTA's inbox (distributed shared
//      memory, double-buffered);
//   2. one cluster barrier (release / acquire); every warp reads the CS
//      candidates from its own CTA's inbox and reduces them to the same
//      winner j and d[j]. The inbox of step t is written again at step
//      t + 2, after its readers have passed the barrier of step t + 1, so
//      one cluster barrier a step suffices. (Stores before the barrier, not
//      remote loads after it: the round trip leaves the serial chain.);
//   3. each CTA copies L[n, j] of its items into shared memory (cp.async, all
//      loads in flight together) and C[j, :t] from the owner of j;
//   4. each CTA updates its items: the dot over the live prefix by quads of
//      four neighbouring items (one float4 load a column) split over S =
//      min(4, 512 / quads) slices of the columns (n_pad = n_per rounded up to
//      32; S = 3 at N = 10^4, 4 at N = 512; partial sums added in slice
//      order), then the tail with round-to-nearest intrinsics as the plain
//      version computes it, and e into column t of C.
// C lives in the CTAs' shared memory, k rows of n_pad + 4 floats a CTA (the
// 4 spread a column's reads over 8 banks), where that fits the opt-in limit
// (the LM head, N = 512, k = 120: 63 KB in each CTA of 4; N = 10^4, k = 20:
// 52 KB in each of 16); otherwise in an (H, k, CS n_pad) float32 scratch in
// device memory, CTA r's block at column r n_pad, read past L1 (ld.cg),
// which stays in L2 (8 MB at N = 10^4, k = 200). Many loads in flight a
// thread matter there: on an H100 (700 W) a first version with one scalar
// column load an item at a time took 19 us a step at N = 10^4, k = 200,
// more than twice these quads' (PERF.md). Column t is written at step t and
// read from step t + 1 on, behind a barrier, so nothing reads a column while
// its owner writes it. A barrier before the first step lets the pushes of step 0 find
// every CTA running, and a last one keeps every CTA's shared memory alive
// until the others' last reads. greedy_map_kdpp_plan halves CS when the
// occupancy query grants no cluster of that size, and fails when none fits;
// the wrapper then raises. tools/greedy_map_steps.py gives the SM cycles of
// each part of a step.

namespace {

constexpr int kMapThreads = 512;
constexpr int kMapWarps = kMapThreads / 32;
constexpr int kMapItems = 128;    // items a CTA at most, below the cap on CS
constexpr int kMapCluster = 16;   // the largest cluster (non-portable size)
constexpr int kMapSlices = 4;     // column slices of the dot at most
constexpr int kMapStaticSmem = 1024;   // static shared memory, with margin

struct Cand {                     // a candidate: its key and its item's d
  unsigned long long key;
  float d;
  float pad;
};

struct MapLayout {                // a CTA's dynamic shared memory, in bytes
  int n_per, n_pad, c_ld, k_pad, quads, slices;
  long long off_d, off_lc, off_cj, off_part, off_c, off_chosen, bytes;
};

__host__ __device__ inline MapLayout map_layout(int N, int k, int cs,
                                                bool c_smem) {
  MapLayout g;
  g.n_per = (N + cs - 1) / cs;
  g.n_pad = (g.n_per + 31) / 32 * 32;
  g.c_ld = g.n_pad + 4;            // C's rows in shared memory: float4-aligned,
                                   // a column read 4-way bank-conflicted
  g.k_pad = (k + 3) / 4 * 4;
  g.quads = g.n_pad / 4;
  const int s = kMapThreads / g.quads;
  g.slices = s < 1 ? 1 : (s > kMapSlices ? kMapSlices : s);
  long long off =
      (2 * kMapCluster + kMapWarps) * static_cast<long long>(sizeof(Cand));
  g.off_d = off;
  off += 4LL * g.n_pad;
  g.off_lc = off;
  off += 4LL * g.n_pad;
  g.off_cj = off;
  off += 4LL * g.k_pad;
  g.off_part = off;
  off += g.slices > 1 ? 4LL * g.slices * g.n_pad : 0;
  g.off_c = off;
  off += c_smem ? 4LL * k * g.c_ld : 0;
  g.off_chosen = off;
  off += g.n_pad;
  g.bytes = (off + 15) / 16 * 16;
  return g;
}

__device__ __forceinline__ unsigned long long cand_key(float x, int n) {
  unsigned b;
  if (x != x) {
    b = 0xFFFFFFFFu;                  // every NaN above +inf
  } else {
    if (x == 0.f) x = 0.f;            // -0 ties with +0, as in argmax
    b = __float_as_uint(x);
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return (static_cast<unsigned long long>(b) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(n));
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long k2 = __shfl_xor_sync(0xFFFFFFFFu, c.key, o);
    const float d2 = __shfl_xor_sync(0xFFFFFFFFu, c.d, o);
    if (k2 > c.key) {
      c.key = k2;
      c.d = d2;
    }
  }
  return c;
}

// sums over s = sl, sl + S, ... < t of C[item, s] cj[s] for the four items
// of a quad; c points at the quad's column 0 in a (k, ldc) block, this
// CTA's in shared memory or the matrix's scratch (16-byte aligned rows)
template <bool kCSmem>
__device__ __forceinline__ float4 quad_dot(const float* c, long long ldc,
                                           const float* cj, int sl, int S,
                                           int t) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* row = c + sl * ldc;
  const long long step = S * ldc;
#pragma unroll 4
  for (int s = sl; s < t; s += S, row += step) {
    const float4* p = reinterpret_cast<const float4*>(row);
    const float4 v = kCSmem ? *p : __ldcg(p);
    const float w = cj[s];
    acc.x = fmaf(v.x, w, acc.x);
    acc.y = fmaf(v.y, w, acc.y);
    acc.z = fmaf(v.z, w, acc.z);
    acc.w = fmaf(v.w, w, acc.w);
  }
  return acc;
}

// item il's update from its dot acc: e into column t of C, d and the
// chosen flag, and the item's key folded into this thread's best
__device__ __forceinline__ void finish_item(int il, float acc, bool ok,
                                            float den, int n, int j,
                                            float* d, const float* lc,
                                            float* c_t, unsigned char* chosen,
                                            Cand& best) {
  float dn = d[il], e = 0.f;
  if (ok) {
    e = __fdiv_rn(__fsub_rn(lc[il], acc), den);
    dn = __fsub_rn(dn, __fmul_rn(e, e));
    dn = dn < 0.f ? 0.f : dn;           // max(., 0); a NaN stays NaN
    d[il] = dn;
  }
  c_t[il] = e;
  if (n == j) chosen[il] = 1;
  const unsigned long long key = cand_key(chosen[il] ? -INFINITY : dn, n);
  if (key > best.key) best = Cand{key, dn, 0.f};
}

template <bool kCSmem>
__global__ void __launch_bounds__(kMapThreads)
    greedy_map_kdpp_kernel(const float* __restrict__ L,
                           float* __restrict__ Cg, int* __restrict__ picks,
                           int N, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kMapWarps];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const MapLayout g = map_layout(N, k, cs, kCSmem);
  Cand* inbox = reinterpret_cast<Cand*>(smem);    // [2][kMapCluster]
  Cand* wbest = inbox + 2 * kMapCluster;           // [kMapWarps]
  float* d = reinterpret_cast<float*>(smem + g.off_d);
  float* lc = reinterpret_cast<float*>(smem + g.off_lc);
  float* cj = reinterpret_cast<float*>(smem + g.off_cj);
  float* part = reinterpret_cast<float*>(smem + g.off_part);
  float* Cs = reinterpret_cast<float*>(smem + g.off_c);
  unsigned char* chosen = smem + g.off_chosen;

  const long long ld = N;
  const long long ldc = kCSmem ? g.c_ld : static_cast<long long>(cs) * g.n_pad;
  const long long h = blockIdx.x / cs;
  const float* Lh = L + h * ld * ld;
  // this CTA's (k, n_pad) block of C: in shared memory, or columns
  // [rank n_pad, (rank + 1) n_pad) of the matrix's (k, cs n_pad) scratch
  float* Cb = kCSmem ? Cs : Cg + h * k * ldc + rank * g.n_pad;
  int* ph = picks + h * k;
  const int lo = rank * g.n_per;
  const int n_loc = max(0, min(N - lo, g.n_per));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // eps = 1e-8 max(max diag L, 1e-30); a NaN on the diagonal makes it NaN
  float mx = -INFINITY;
  int nan = 0;
  for (int n = tid; n < N; n += kMapThreads) {
    const float v = __ldg(Lh + n * (ld + 1));
    if (v != v)
      nan = 1;
    else
      mx = fmaxf(mx, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  if (lane == 0) red[warp] = mx;
  nan = __syncthreads_or(nan);
  mx = red[0];
  for (int w = 1; w < kMapWarps; ++w) mx = fmaxf(mx, red[w]);
  const float eps =
      nan ? __int_as_float(0x7FC00000) : __fmul_rn(1e-8f, fmaxf(mx, 1e-30f));

  Cand best = {0ull, 0.f, 0.f};       // key 0: below every real score
  for (int il = tid; il < n_loc; il += kMapThreads) {
    const float v = __ldg(Lh + (lo + il) * (ld + 1));
    d[il] = v;
    chosen[il] = 0;
    const unsigned long long key = cand_key(v, lo + il);
    if (key > best.key) best = Cand{key, v, 0.f};
  }
  cluster.sync();                     // every CTA runs: its inbox may be written

  for (int t = 0; t < k; ++t) {
    // 1. this CTA's candidate
    best = warp_best(best);
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    Cand* box = inbox + (t & 1) * kMapCluster;
    if (warp == 0) {                  // pushed into every CTA's inbox
      Cand c = {0ull, 0.f, 0.f};
      if (lane < kMapWarps) c = wbest[lane];
      c = warp_best(c);
      if (lane < cs) *cluster.map_shared_rank(box + rank, lane) = c;
    }
    // 2. the cluster's winner, in every warp, from this CTA's inbox
    cluster.sync();
    Cand w = {0ull, 0.f, 0.f};
    if (lane < cs) w = box[lane];
    w = warp_best(w);
    const int j = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(w.key));
    const bool ok = w.d > eps;        // uniform over the cluster
    if (rank == 0 && tid == 0) ph[t] = j;
    // 3. L[:, j] of this CTA's items and C[j, :t]
    if (ok) {
      for (int il = tid; il < n_loc; il += kMapThreads)
        __pipeline_memcpy_async(lc + il, Lh + (lo + il) * ld + j, 4);
      __pipeline_commit();
      const int owner = j / g.n_per;
      const int jl = j - owner * g.n_per;
      if constexpr (kCSmem) {
        const float* Cown = cluster.map_shared_rank(Cs, owner) + jl;
        for (int s = tid; s < t; s += kMapThreads) cj[s] = Cown[s * ldc];
      } else {
        const float* Cown = Cg + h * k * ldc + owner * g.n_pad + jl;
        for (int s = tid; s < t; s += kMapThreads)
          cj[s] = __ldcg(Cown + s * ldc);
      }
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    // 4. the update of this CTA's items, and their next best
    float den = 1.f;
    if (ok) {
      const float v = w.d < 1e-12f ? 1e-12f : w.d;   // d[j] > eps here
      den = __fsqrt_rn(v);
    }
    best = Cand{0ull, 0.f, 0.f};
    float* c_t = Cb + t * ldc;        // column t of C, this CTA's items
    if (g.slices == 1) {              // a thread finishes its own quads
      for (int q = tid; q < g.quads; q += kMapThreads) {
        const float4 a = ok ? quad_dot<kCSmem>(Cb + 4 * q, ldc, cj, 0, 1, t)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        const int i0 = 4 * q;
        if (i0 < n_loc)
          finish_item(i0, a.x, ok, den, lo + i0, j, d, lc, c_t, chosen, best);
        if (i0 + 1 < n_loc)
          finish_item(i0 + 1, a.y, ok, den, lo + i0 + 1, j, d, lc, c_t,
                      chosen, best);
        if (i0 + 2 < n_loc)
          finish_item(i0 + 2, a.z, ok, den, lo + i0 + 2, j, d, lc, c_t,
                      chosen, best);
        if (i0 + 3 < n_loc)
          finish_item(i0 + 3, a.w, ok, den, lo + i0 + 3, j, d, lc, c_t,
                      chosen, best);
      }
    } else {                          // slices meet in shared memory
      if (ok) {
        for (int idx = tid; idx < g.slices * g.quads; idx += kMapThreads) {
          const int sl = idx / g.quads, q = idx - sl * g.quads;
          *reinterpret_cast<float4*>(part + sl * g.n_pad + 4 * q) =
              quad_dot<kCSmem>(Cb + 4 * q, ldc, cj, sl, g.slices, t);
        }
        __syncthreads();
      }
      for (int il = tid; il < n_loc; il += kMapThreads) {
        float acc = 0.f;
        if (ok) {
          acc = part[il];
          for (int sl = 1; sl < g.slices; ++sl)
            acc = __fadd_rn(acc, part[sl * g.n_pad + il]);
        }
        finish_item(il, acc, ok, den, lo + il, j, d, lc, c_t, chosen, best);
      }
    }
  }
  cluster.sync();                     // no CTA leaves while others read it
}

const void* map_kernel(bool c_smem) {
  return c_smem ? reinterpret_cast<const void*>(&greedy_map_kdpp_kernel<true>)
                : reinterpret_cast<const void*>(&greedy_map_kdpp_kernel<false>);
}

cudaLaunchConfig_t map_config(int cs, int H, long long bytes,
                              cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs) * H);
  cfg.blockDim = dim3(kMapThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t map_attributes(bool c_smem, int cs, long long bytes) {
  const void* fn = map_kernel(c_smem);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace

// The launch plan of an (N, k) selection on the current device: out[0] the
// cluster size, out[1] 1 when C lives in shared memory, out[2] threads a CTA,
// out[3] column slices, out[4] items a CTA, out[5] the dynamic shared memory
// of a CTA in bytes, out[6] the clusters of that shape the card can hold at
// once, out[7] the row stride of the device scratch of C (cs n_pad floats;
// 0 when C lives in shared memory). Starts from the cluster size of the
// design note and halves it while
// the occupancy query grants none; an error when not even one CTA fits.
extern "C" int greedy_map_kdpp_plan(int N, int k, int* out) {
  if (N < 1 || N > (1 << 30) || k < 1 || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cs = 1;
  while (cs < kMapCluster && (N + cs - 1) / cs > kMapItems) cs *= 2;
  for (; cs >= 1; cs /= 2) {
    const bool c_smem =
        map_layout(N, k, cs, true).bytes + kMapStaticSmem <= optin;
    const MapLayout g = map_layout(N, k, cs, c_smem);
    if (g.bytes + kMapStaticSmem > optin) continue;
    if (map_attributes(c_smem, cs, g.bytes) != cudaSuccess) {
      cudaGetLastError();             // not granted: try a smaller cluster
      continue;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = map_config(cs, 1, g.bytes, &attr, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, map_kernel(c_smem), &cfg) !=
        cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (clusters < 1) continue;
    const int fields[8] = {cs, c_smem ? 1 : 0, kMapThreads, g.slices,
                           g.n_per, static_cast<int>(g.bytes), clusters,
                           c_smem ? 0 : cs * g.n_pad};
    for (int i = 0; i < 8; ++i) out[i] = fields[i];
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

// One launch: the k picks of each of the H matrices L (H, N, N), row-major,
// into picks (H, k) int32, under a plan of greedy_map_kdpp_plan (cluster size
// cs, C in shared memory or in the scratch C of H k (cs n_pad) floats).
extern "C" int greedy_map_kdpp_launch(const void* L, void* C, void* picks,
                                      int H, int N, int k, int cs,
                                      int c_smem, void* stream) {
  if (H < 1 || N < 1 || N > (1 << 30) || k < 1 || k > N || cs < 1 ||
      cs > kMapCluster || static_cast<long long>(cs) * H > INT_MAX ||
      (!c_smem && C == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const MapLayout g = map_layout(N, k, cs, c_smem != 0);
  cudaError_t err = map_attributes(c_smem != 0, cs, g.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = map_config(cs, H, g.bytes, &attr, stream);
  const float* Lf = static_cast<const float*>(L);
  float* Cf = static_cast<float*>(C);
  int* pf = static_cast<int*>(picks);
  err = c_smem ? cudaLaunchKernelEx(&cfg, greedy_map_kdpp_kernel<true>, Lf,
                                    Cf, pf, N, k)
               : cudaLaunchKernelEx(&cfg, greedy_map_kdpp_kernel<false>, Lf,
                                    Cf, pf, N, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_map_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
