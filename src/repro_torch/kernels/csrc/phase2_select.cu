// Phase-2 projection-DPP selection for Hopper (sm_90a), one thread block
// per sample.
//
// Replaces: the Pallas TPU kernel phase2_select_pallas (body _phase2_kernel)
// in src/repro/kernels/phase2_select.py. Same function, same contract: for
// each sample b, over the canonical factor pair G1 (N1, k), Gr (Nr, k),
//
//   norms[n1, nr] = sum_c G1[n1, c]^2 Gr[nr, c]^2
//   for t < k_eff[b] while total > MASS_EPS:
//     csum = inclusive cumsum of norms, total = csum[N-1], r = us[b, t] * total
//     i    = the item whose CDF interval holds r
//     w    = G1[i / Nr] * Gr[i % Nr]; q = CGS2(w against the k x k basis B)
//     B[:, t] = q / |q| (or 0 when |q|^2 <= EPS); picks[b, t] = i
//     norms = max(norms - (G1 diag(q) Gr^T)^2, 0); norms[i] = 0
//
// with picks (B, k) int32, -1 in padded and dead slots.
//
// What bounds it: per live step the norms downdate costs about 2 N k
// floating-point operations (one k-long dot product per item) and the scan
// and search O(N); CGS2 is O(k^2). All of it is fp32 outside the tensor
// cores (67 TFLOP/s on an H100 SXM), so the bound is operations, not bytes:
// the inputs are only (N1 + Nr) k floats per sample. The steps of one sample
// are sequential; only the batch and the N items of a step are parallel.
//
// What the design does about it: the Pallas grid (batch, k_max, 2, n_tiles)
// ran in order on one TPU core with state in VMEM. Here the step loop runs
// inside one block per sample, so the batch fills the SMs and nothing
// crosses blocks. Each thread owns one contiguous chunk of the N items for
// the whole run: it downdates its chunk and sums it in the same pass, so the
// next step's block-wide scan needs only one partial per thread (warp
// shuffles, then the warp totals) and the index search is a block reduction
// over the chunks. norms never leaves the thread that owns it, so it needs
// no synchronisation; it lives in a (B, N) float32 scratch tensor that the
// wrapper allocates (2.5 MB at B = 64, N = 10^4: resident in the 50 MB L2),
// which keeps the kernel correct for any N. The basis B, the row w and the
// scan partials live in shared memory (9 KB at k = 48). Not done yet:
// norms in shared memory, a thread-block cluster to spread one sample over
// several SMs (batch 1 uses one SM of 132), tensor cores for the downdate.
//
// Index rule: i is the first item with csum > r and norms > 0, or the last
// item with norms > 0 when r lies past every such csum. On a monotone
// cumsum this is the reference's min(#(csum <= r), N - 1); the mass guard
// keeps a rounding step between two chunks' offsets from ever selecting a
// zero-mass (already selected) item.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr float kEps = 1e-30f;      // EPS in repro_torch.kernels.phase2_select
constexpr float kMassEps = 1e-6f;   // MASS_EPS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum over the block; every thread gets the same value (same order).
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();                      // red may still be read elsewhere
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

// Exclusive scan of one value per thread in thread order; *total gets the
// block total, identical in every thread.
__device__ float block_exclusive_scan(float v, float* red, float* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  float excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = 0.f;
  __syncthreads();
  if (lane == 31) red[wid] = inc;
  __syncthreads();
  float off = 0.f, tot = 0.f;
  for (int w = 0; w < nw; ++w) {
    if (w < wid) off += red[w];
    tot += red[w];
  }
  *total = tot;
  return off + excl;
}

// The pick: the smallest candidate over the block, else the largest
// positive-mass index.
__device__ int block_pick(int cand, int lastpos, int* redi) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    cand = min(cand, __shfl_xor_sync(kFull, cand, o));
    lastpos = max(lastpos, __shfl_xor_sync(kFull, lastpos, o));
  }
  __syncthreads();
  if (lane == 0) {
    redi[wid] = cand;
    redi[32 + wid] = lastpos;
  }
  __syncthreads();
  int c = INT_MAX, l = -1;
  for (int w = 0; w < nw; ++w) {
    c = min(c, redi[w]);
    l = max(l, redi[32 + w]);
  }
  return c != INT_MAX ? c : l;
}

// out[c] = x[c] - sum_j B[c, j] (sum_c' B[c', j] x[c']): one Gram-Schmidt
// pass against the basis, zero columns included.
__device__ void gs_pass(const float* basis, const float* x, float* coef,
                        float* out, int k) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < k; ++c) s = fmaf(basis[c * k + j], x[c], s);
    coef[j] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s = fmaf(basis[c * k + j], coef[j], s);
    out[c] = x[c] - s;
  }
  __syncthreads();
}

__global__ void phase2_select_kernel(const float* __restrict__ us,
                                     const int* __restrict__ keff,
                                     const float* __restrict__ G1,
                                     const float* __restrict__ Gr,
                                     float* __restrict__ norms_all,
                                     int* __restrict__ picks,
                                     int N1, int Nr, int k) {
  extern __shared__ float smem[];
  float* basis = smem;              // k x k, basis[c * k + j] = B[c, j]
  float* w = basis + k * k;         // gathered row, then CGS2 result
  float* coef = w + k;              // B^T x
  float* q = coef + k;              // first CGS pass, then the new column
  float* red = q + k;               // 32 warp partials
  int* redi = reinterpret_cast<int*>(red + 32);   // 64 ints

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = N1 * Nr;
  const float* g1 = G1 + static_cast<size_t>(b) * N1 * k;
  const float* gr = Gr + static_cast<size_t>(b) * Nr * k;
  float* norms = norms_all + static_cast<size_t>(b) * n;
  int* pk = picks + static_cast<size_t>(b) * k;
  const float* u = us + static_cast<size_t>(b) * k;
  const int ke = max(0, min(keff[b], k));

  for (int j = tid; j < k; j += nt) pk[j] = -1;
  for (int j = tid; j < k * k; j += nt) basis[j] = 0.f;

  const int chunk = (n + nt - 1) / nt;
  const int lo = min(tid * chunk, n);
  const int hi = min(lo + chunk, n);

  float part = 0.f;                 // sum of this thread's chunk
  for (int x = lo; x < hi; ++x) {
    const int i1 = x / Nr, ir = x - i1 * Nr;
    const float* a = g1 + static_cast<size_t>(i1) * k;
    const float* c = gr + static_cast<size_t>(ir) * k;
    float acc = 0.f;
    for (int cc = 0; cc < k; ++cc) acc = fmaf(a[cc] * a[cc], c[cc] * c[cc], acc);
    norms[x] = acc;
    part += acc;
  }
  __syncthreads();

  for (int t = 0; t < ke; ++t) {
    float total;
    const float off = block_exclusive_scan(part, red, &total);
    if (!(total > kMassEps)) break;   // collapsed: this slot and later stay -1
    const float r = u[t] * total;
    int cand = INT_MAX, lastpos = -1;
    float run = off;
    for (int x = lo; x < hi; ++x) {
      const float v = norms[x];
      run += v;
      if (v > 0.f) {
        lastpos = x;
        if (run > r && cand == INT_MAX) cand = x;
      }
    }
    const int pick = block_pick(cand, lastpos, redi);
    const int p1 = pick / Nr, pr = pick - p1 * Nr;
    for (int c = tid; c < k; c += nt)
      w[c] = g1[static_cast<size_t>(p1) * k + c] * gr[static_cast<size_t>(pr) * k + c];
    __syncthreads();
    gs_pass(basis, w, coef, q, k);    // q = w - B (B^T w)
    gs_pass(basis, q, coef, w, k);    // w = q - B (B^T q): CGS2
    float sq = 0.f;
    for (int c = tid; c < k; c += nt) sq = fmaf(w[c], w[c], sq);
    const float qn2 = block_sum(sq, red);
    const float inv = qn2 > kEps ? 1.f / sqrtf(fmaxf(qn2, kEps)) : 0.f;
    for (int c = tid; c < k; c += nt) {
      const float v = qn2 > kEps ? w[c] * inv : 0.f;
      q[c] = v;
      basis[c * k + t] = v;
    }
    if (tid == 0) pk[t] = pick;
    __syncthreads();
    if (t + 1 >= ke) break;           // no later step reads the downdate
    part = 0.f;
    for (int x = lo; x < hi; ++x) {
      const int i1 = x / Nr, ir = x - i1 * Nr;
      const float* a = g1 + static_cast<size_t>(i1) * k;
      const float* c = gr + static_cast<size_t>(ir) * k;
      float ct = 0.f;
      for (int cc = 0; cc < k; ++cc) ct = fmaf(a[cc] * q[cc], c[cc], ct);
      const float v = x == pick ? 0.f : fmaxf(norms[x] - ct * ct, 0.f);
      norms[x] = v;
      part += v;
    }
  }
}

}  // namespace

extern "C" int phase2_select_launch(const void* us, const void* keff,
                                    const void* G1, const void* Gr,
                                    void* norms, void* picks, int B, int N1,
                                    int Nr, int k, int threads,
                                    void* stream) {
  if (B < 1 || N1 < 1 || Nr < 1 || k < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(k) * k + 4 * static_cast<size_t>(k) + 32) *
                          sizeof(float) + 64 * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        phase2_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  phase2_select_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(us), static_cast<const int*>(keff),
      static_cast<const float*>(G1), static_cast<const float*>(Gr),
      static_cast<float*>(norms), static_cast<int*>(picks), N1, Nr, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* phase2_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
