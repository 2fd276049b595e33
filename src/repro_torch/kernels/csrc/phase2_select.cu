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
// cores (67 TFLOP/s on an H100 SXM, 0.51 TFLOP/s an SM), so the bound is
// operations, not bytes: the inputs are only (N1 + Nr) k floats per sample.
// The steps of one sample are sequential; only the batch and the N items of
// a step are parallel, so a sample's floor is its steps on one SM.
//
// Route "on_chip" (phase2_select_kernel_onchip), taken whenever its layout
// fits a block's shared memory (onchip_geom; 89 KB at 100 x 100, k = 46,
// two blocks an SM). The Pallas grid (batch, k_max, 2, n_tiles) ran in
// order on one TPU core with state in VMEM; here the step loop runs inside
// one block per sample and everything a step reads stays in shared memory
// for the whole run: G1^T (k, N1p) and Gr^T (k, Pr), k-major, loaded once;
// the norms as an (N1p, Pr) grid whose padding stays zero (a zero-mass
// item is never picked); the basis, w, q and the scan partials. A step:
//   1. Downdate as a register-tiled product: a thread owns 4 rows of G1 by
//      TN rows of Gr (TN in 4, 8, 12, 16, the least that gives every tile a
//      thread: 4 x 12 at 100 x 100, 225 tiles), and per c reads one float4
//      of G1^T and TN / 4 of Gr^T, all lanes of a quarter warp on distinct
//      banks, for 4 TN FMAs. c runs in order and each term is
//      fmaf(G1 q, Gr, ct), as the global route rounds it. The same pass
//      writes max(norms - ct^2, 0) back, 0 at the pick; the init is the
//      same product of the squares.
//   2. Scan and search, after a barrier: a thread owns a contiguous chunk
//      of the grid of odd length (lanes 32 banks apart, so no conflicts),
//      sums it, a block scan gives its offset and the total, and it walks
//      its chunk for the first item with csum > r and mass > 0.
//   3. Gather w from the two shared factors, and CGS2 (gs_pass).
// 256 threads: at 100 x 100 the 225 tiles take one thread each, and with
// 128 registers and 89 KB two blocks share an SM, so the service's flush at
// B = 512 runs in two waves of 264; 512 threads would halve the tile and
// double the shared-memory loads per FMA. Not done yet: a thread-block
// cluster to spread one sample over several SMs (batch 1 uses one SM of
// 132), tensor cores for the downdate.
//
// Route "global" (phase2_select_kernel), for shapes past the shared memory
// (large N, or k up to 236 on an H100): each thread owns one contiguous
// chunk of the N items for the whole run, downdates it from rows of G1 and
// Gr in device memory and sums it in the same pass; norms lives in a (B, N)
// float32 scratch the wrapper allocates, resident in the 50 MB L2. The
// basis, w and the scan partials live in shared memory.
//
// Route "global_basis" (the same kernel), for k whose k x k basis passes a
// block's shared memory (the KronDPP batch selector's 32 x 32 documents
// draw k_max 333): the basis moves to a (B, 2, k, k) float32 scratch in
// device memory, B and its transpose, so that both Gram-Schmidt loops read
// consecutive addresses across a warp (the first reads B[c, j] along j,
// the second B^T[j, c] along c); w, q and the partials stay in shared
// memory. Every sum runs in the order of the "global" route, so the two
// routes give the same bits on a shape both take.
//
// Index rule (both routes): i is the first item with csum > r and
// norms > 0, or the last item with norms > 0 when r lies past every such
// csum. On a monotone cumsum this is the reference's min(#(csum <= r),
// N - 1); the mass guard keeps a rounding step between two chunks' offsets
// from ever selecting a zero-mass (already selected) item.

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
// pass against the basis, zero columns included. basis_t, when given, is
// B^T (basis_t[j * k + c] = B[c, j]), read by the second loop in place of
// basis: the same values in the same order.
__device__ void gs_pass(const float* basis, const float* basis_t,
                        const float* x, float* coef, float* out, int k) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < k; ++c) s = fmaf(basis[c * k + j], x[c], s);
    coef[j] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.f;
    if (basis_t != nullptr)
      for (int j = 0; j < k; ++j) s = fmaf(basis_t[j * k + c], coef[j], s);
    else
      for (int j = 0; j < k; ++j) s = fmaf(basis[c * k + j], coef[j], s);
    out[c] = x[c] - s;
  }
  __syncthreads();
}

// basis_all: null on the "global" route (the basis in shared memory); the
// (B, 2, k, k) scratch of B and B^T on the "global_basis" route.
__global__ void phase2_select_kernel(const float* __restrict__ us,
                                     const int* __restrict__ keff,
                                     const float* __restrict__ G1,
                                     const float* __restrict__ Gr,
                                     float* __restrict__ norms_all,
                                     float* __restrict__ basis_all,
                                     int* __restrict__ picks,
                                     int N1, int Nr, int k) {
  extern __shared__ float smem[];
  const size_t kk = static_cast<size_t>(k) * k;
  // basis[c * k + j] = B[c, j]; basis_t[j * k + c] = B[c, j] (global only)
  float* basis = basis_all != nullptr
                     ? basis_all + 2 * kk * blockIdx.x : smem;
  float* basis_t = basis_all != nullptr ? basis + kk : nullptr;
  float* w = basis_all != nullptr ? smem : smem + kk;   // gathered row,
                                                        // then CGS2 result
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
  for (size_t j = tid; j < kk; j += nt) basis[j] = 0.f;
  if (basis_t != nullptr)
    for (size_t j = tid; j < kk; j += nt) basis_t[j] = 0.f;

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
    gs_pass(basis, basis_t, w, coef, q, k);    // q = w - B (B^T w)
    gs_pass(basis, basis_t, q, coef, w, k);    // w = q - B (B^T q): CGS2
    float sq = 0.f;
    for (int c = tid; c < k; c += nt) sq = fmaf(w[c], w[c], sq);
    const float qn2 = block_sum(sq, red);
    const float inv = qn2 > kEps ? 1.f / sqrtf(fmaxf(qn2, kEps)) : 0.f;
    for (int c = tid; c < k; c += nt) {
      const float v = qn2 > kEps ? w[c] * inv : 0.f;
      q[c] = v;
      basis[c * k + t] = v;
      if (basis_t != nullptr) basis_t[t * k + c] = v;
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


// ---------------------------------------------------------------------------
// Route "on_chip"
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;       // THREADS in phase2_select.py
constexpr int kTileRows = 4;        // TILE_ROWS
constexpr int kTileCols[] = {4, 8, 12, 16};   // TILE_COLS

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The on-chip layout (phase2_select.py onchip_geometry): floats from the
// start of shared memory, every offset a multiple of 4.
struct Geom {
  int tn;        // Gr rows of a thread's tile
  int n1p, pr;   // N1 and Nr padded to the tile
  int tiles_j;   // tiles along Gr
  int tiles;     // tiles in all
  int off_grt, off_norms, off_basis;   // floats
  long long smem;                      // bytes
};

Geom onchip_geom(int N1, int Nr, int k) {
  Geom g;
  const int rows = (N1 + kTileRows - 1) / kTileRows;
  g.tn = kTileCols[3];
  for (int t : kTileCols)
    if (static_cast<long long>(rows) * ((Nr + t - 1) / t) <= kThreads) {
      g.tn = t;
      break;
    }
  g.n1p = rows * kTileRows;
  g.pr = round_up(Nr, g.tn);
  g.tiles_j = g.pr / g.tn;
  g.tiles = rows * g.tiles_j;
  const long long kk = k;
  const long long floats = kk * g.n1p + kk * g.pr +
                           static_cast<long long>(g.n1p) * g.pr + kk * kk +
                           3 * kk + 32;
  g.smem = 4 * floats + 4 * 64;
  // offsets in floats, meaningful for a layout that fits a block
  g.off_grt = static_cast<int>(kk * g.n1p);
  g.off_norms = static_cast<int>(kk * (g.n1p + g.pr));
  g.off_basis = static_cast<int>(kk * (g.n1p + g.pr) +
                                 static_cast<long long>(g.n1p) * g.pr);
  return g;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] = sum over c (in order) of fmaf(a_i, g_j, acc): a_i =
// G1[i0 + i, c] q[c], g_j = Gr[j0 + j, c] (the downdate's ct), or, with
// kSquare, a_i = G1[i0 + i, c]^2, g_j = Gr[j0 + j, c]^2 (the init).
template <int TN, bool kSquare>
__device__ __forceinline__ void tile_product(const float* g1t, int n1p,
                                             const float* grt, int pr,
                                             const float* q, int k, int i0,
                                             int j0, float acc[4][TN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < k; ++c) {
    const float4 a4 = lds4(g1t + c * n1p + i0);
    float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float g[TN];
#pragma unroll
    for (int v = 0; v < TN / 4; ++v) {
      const float4 g4 = lds4(grt + c * pr + j0 + 4 * v);
      g[4 * v] = g4.x;
      g[4 * v + 1] = g4.y;
      g[4 * v + 2] = g4.z;
      g[4 * v + 3] = g4.w;
    }
    if constexpr (kSquare) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a[i] * a[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) g[j] = g[j] * g[j];
    } else {
      const float qc = q[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a[i] * qc;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
  }
}

// The init (kInit: norms = the product of the squares) or one downdate
// (norms = max(norms - ct^2, 0), 0 at grid cell `pick`) over every tile.
template <int TN, bool kInit>
__device__ void tile_pass(const float* g1t, const float* grt, float* norms,
                          const float* q, int k, const Geom& g, int pick) {
  for (int tile = threadIdx.x; tile < g.tiles; tile += blockDim.x) {
    const int ti = tile / g.tiles_j;
    const int i0 = ti * 4, j0 = (tile - ti * g.tiles_j) * TN;
    float acc[4][TN];
    tile_product<TN, kInit>(g1t, g.n1p, grt, g.pr, q, k, i0, j0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = norms + (i0 + i) * g.pr + j0;
#pragma unroll
      for (int v = 0; v < TN / 4; ++v) {
        float4 o;
        if constexpr (kInit) {
          o = make_float4(acc[i][4 * v], acc[i][4 * v + 1],
                          acc[i][4 * v + 2], acc[i][4 * v + 3]);
        } else {
          o = lds4(row + 4 * v);
          o.x = fmaxf(o.x - acc[i][4 * v] * acc[i][4 * v], 0.f);
          o.y = fmaxf(o.y - acc[i][4 * v + 1] * acc[i][4 * v + 1], 0.f);
          o.z = fmaxf(o.z - acc[i][4 * v + 2] * acc[i][4 * v + 2], 0.f);
          o.w = fmaxf(o.w - acc[i][4 * v + 3] * acc[i][4 * v + 3], 0.f);
        }
        *reinterpret_cast<float4*>(row + 4 * v) = o;
      }
    }
    if constexpr (!kInit) {
      const int di = pick / g.pr - i0, dj = pick % g.pr - j0;
      if (di >= 0 && di < 4 && dj >= 0 && dj < TN) norms[pick] = 0.f;
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 2)
    phase2_select_kernel_onchip(const float* __restrict__ us,
                                const int* __restrict__ keff,
                                const float* __restrict__ G1,
                                const float* __restrict__ Gr,
                                int* __restrict__ picks, int N1, int Nr,
                                int k, const Geom g) {
  extern __shared__ __align__(16) float smem[];
  float* g1t = smem;                  // g1t[c * n1p + i1] = G1[i1, c]
  float* grt = smem + g.off_grt;      // grt[c * pr + ir] = Gr[ir, c]
  float* norms = smem + g.off_norms;  // norms[i1 * pr + ir]
  float* basis = smem + g.off_basis;  // k x k, basis[c * k + j] = B[c, j]
  float* w = basis + k * k;           // gathered row, then CGS2 result
  float* coef = w + k;                // B^T x
  float* q = coef + k;                // first CGS pass, then the new column
  float* red = q + k;                 // 32 warp partials
  int* redi = reinterpret_cast<int*>(red + 32);   // 64 ints

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* g1 = G1 + static_cast<size_t>(b) * N1 * k;
  const float* gr = Gr + static_cast<size_t>(b) * Nr * k;
  int* pk = picks + static_cast<size_t>(b) * k;
  const float* u = us + static_cast<size_t>(b) * k;
  const int ke = max(0, min(keff[b], k));

  // the factors, transposed and zero-padded, once (coalesced reads)
  for (int e = tid; e < g.n1p * k; e += nt) {
    const int i1 = e / k, c = e - i1 * k;
    g1t[c * g.n1p + i1] = i1 < N1 ? g1[e] : 0.f;
  }
  for (int e = tid; e < g.pr * k; e += nt) {
    const int ir = e / k, c = e - ir * k;
    grt[c * g.pr + ir] = ir < Nr ? gr[e] : 0.f;
  }
  for (int j = tid; j < k; j += nt) pk[j] = -1;
  for (int j = tid; j < k * k; j += nt) basis[j] = 0.f;
  __syncthreads();
  tile_pass<TN, true>(g1t, grt, norms, q, k, g, -1);

  // scan ownership: a contiguous chunk of odd length a thread
  const int n = g.n1p * g.pr;
  const int chunk = ((n + nt - 1) / nt) | 1;
  const int lo = min(tid * chunk, n);
  const int hi = min(lo + chunk, n);

  for (int t = 0; t < ke; ++t) {
    __syncthreads();                  // the norms of this step are written
    float part = 0.f;
    int lastpos = -1;
    for (int x = lo; x < hi; ++x) {
      const float v = norms[x];
      part += v;
      if (v > 0.f) lastpos = x;
    }
    float total;
    const float off = block_exclusive_scan(part, red, &total);
    if (!(total > kMassEps)) break;   // collapsed: this slot and later stay -1
    const float r = u[t] * total;
    int cand = INT_MAX;
    float run = off;
    for (int x = lo; x < hi; ++x) {
      const float v = norms[x];
      run += v;
      if (v > 0.f && run > r) {
        cand = x;
        break;
      }
    }
    const int pick = block_pick(cand, lastpos, redi);   // a grid cell
    const int p1 = pick / g.pr, pr = pick - p1 * g.pr;
    for (int c = tid; c < k; c += nt)
      w[c] = g1t[c * g.n1p + p1] * grt[c * g.pr + pr];
    __syncthreads();
    gs_pass(basis, nullptr, w, coef, q, k);    // q = w - B (B^T w)
    gs_pass(basis, nullptr, q, coef, w, k);    // w = q - B (B^T q): CGS2
    float sq = 0.f;
    for (int c = tid; c < k; c += nt) sq = fmaf(w[c], w[c], sq);
    const float qn2 = block_sum(sq, red);
    const float inv = qn2 > kEps ? 1.f / sqrtf(fmaxf(qn2, kEps)) : 0.f;
    for (int c = tid; c < k; c += nt) {
      const float v = qn2 > kEps ? w[c] * inv : 0.f;
      q[c] = v;
      basis[c * k + t] = v;
    }
    if (tid == 0) pk[t] = p1 * Nr + pr;
    __syncthreads();
    if (t + 1 >= ke) break;           // no later step reads the downdate
    tile_pass<TN, false>(g1t, grt, norms, q, k, g, pick);
  }
}

template <int TN>
cudaError_t launch_onchip(const float* us, const int* keff, const float* G1,
                          const float* Gr, int* picks, int B, int N1, int Nr,
                          int k, const Geom& g, cudaStream_t s) {
  phase2_select_kernel_onchip<TN><<<B, kThreads, g.smem, s>>>(
      us, keff, G1, Gr, picks, N1, Nr, k, g);
  return cudaGetLastError();
}

// The global kernel's shared memory: the basis (when it lives there), w,
// coef, q, 32 warp partials, then 64 ints.
size_t global_smem(int k, bool basis_in_smem) {
  const size_t kk = basis_in_smem ? static_cast<size_t>(k) * k : 0;
  return (kk + 4 * static_cast<size_t>(k) + 32) * sizeof(float) +
         64 * sizeof(int);
}

}  // namespace

// The opt-in shared memory a block of the current device may use, in
// *limit; both kernels' dynamic shared-memory caps become that limit, so
// that a launch configures nothing. Ask once per device before launching.
// Returns a CUDA error code.
extern "C" int phase2_select_prepare(int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(phase2_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(phase2_select_kernel_onchip<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(phase2_select_kernel_onchip<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(phase2_select_kernel_onchip<12>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(phase2_select_kernel_onchip<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
  return static_cast<int>(e);
}

// The on-chip route's shared memory in bytes for these sizes, in *bytes
// (the host's route decision must agree with it).
extern "C" int phase2_select_onchip_bytes(int N1, int Nr, int k,
                                          long long* bytes) {
  if (N1 < 1 || Nr < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *bytes = onchip_geom(N1, Nr, k).smem;
  return 0;
}

// route: 0 on_chip, 1 global, 2 global_basis (what phase2_select_route gave
// for N1, Nr and k on this device, after phase2_select_prepare). norms: the
// global routes' float32 scratch, (B, N1 Nr) norms, followed on the
// global_basis route by the (B, 2, k, k) basis; ignored (and may be null)
// on the on-chip route, which takes threads = 256 only.
extern "C" int phase2_select_launch(const void* us, const void* keff,
                                    const void* G1, const void* Gr,
                                    void* norms, void* picks, int B, int N1,
                                    int Nr, int k, int threads, int route,
                                    void* stream) {
  if (B < 1 || N1 < 1 || Nr < 1 || k < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(us);
  const int* ke = static_cast<const int*>(keff);
  const float* g1 = static_cast<const float*>(G1);
  const float* gr = static_cast<const float*>(Gr);
  int* pk = static_cast<int*>(picks);
  if (route == 0) {
    if (threads != kThreads) return static_cast<int>(cudaErrorInvalidValue);
    const Geom g = onchip_geom(N1, Nr, k);
    switch (g.tn) {
      case 4: return launch_onchip<4>(u, ke, g1, gr, pk, B, N1, Nr, k, g, s);
      case 8: return launch_onchip<8>(u, ke, g1, gr, pk, B, N1, Nr, k, g, s);
      case 12:
        return launch_onchip<12>(u, ke, g1, gr, pk, B, N1, Nr, k, g, s);
      default:
        return launch_onchip<16>(u, ke, g1, gr, pk, B, N1, Nr, k, g, s);
    }
  }
  if ((route != 1 && route != 2) || norms == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* nm = static_cast<float*>(norms);
  float* bs = route == 2
                  ? nm + static_cast<size_t>(B) * N1 * Nr : nullptr;
  phase2_select_kernel<<<B, threads, global_smem(k, route == 1), s>>>(
      u, ke, g1, gr, nm, bs, pk, N1, Nr, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* phase2_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
