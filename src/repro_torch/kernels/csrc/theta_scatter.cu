// The dense Theta of a batch of subsets, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package's theta_matrix_kron
// (src/repro/core/krk_picard.py) builds one dense N x N matrix per subset
// and takes their mean: n N^2 floats, 400 GB at N = 10^4 and n = 1000. The
// port sums into one N x N buffer, which PyTorch's
// index_put_(accumulate=True) did over all n k^2 slot pairs before this
// kernel. Padded slots hold index 0, so every padded x padded pair of every
// subset targeted Theta[0, 0]: at k_max 46 and E|Y| 20, ~0.69 M duplicates
// of one key, which PyTorch's sorted accumulate hands to one thread (163 ms
// of a 199 ms learning sweep on an H100).
//
// What it computes. With idx (n, k) ground-set indices, mask (n, k) and
// inv (n, k, k) the subsets' inverses,
//
//   Theta[i, j] = (1/n) sum of inv[s, a, b] over the (s, a, b) with
//                 mask[s, a], mask[s, b], idx[s, a] = i, idx[s, b] = j,
//
// each entry's terms added from 0 in (s, a, b) order, then divided by n (a
// true division). The wrapper hands it keys = idx where mask, N elsewhere
// (n k int32), the keys sorted stably and the slot s k + a of each sorted
// key: the real slots of item i, in subset order, are one run of the
// sorted keys. A padded slot is never read, added or written, whatever
// index it holds; a real slot whose index lies outside [0, N) adds nothing.
//
// Bitwise: on finite inverses Theta equals the plain version's
// (theta_scatter_plain: the accumulating index_put_ over every pair, then a
// division by a tensor n) bit for bit where that sums in (s, a, b) order,
// as the CPU's serial index_put_ does (one thread, or under PyTorch's
// grain): the same terms in the same order from the same 0, no fused
// multiply-add, the same correctly rounded division; the padded pairs'
// zeros change no finite sum. The card's index_put_ sums a run of 32 or
// more equal keys (padded pairs included) as a warp tree, so the plain
// version on the card agrees to rounding only. (A non-finite inverse
// differs besides: there the plain version's NaN * 0 of a padded pair
// lands in row and column idx[s, pad] too.) A subset that repeats an item
// is no DPP sample, but gives the plain version's sum too: the repeats of
// row i are walked one after the other, and a chunk's lanes that hit one
// column are summed by the lowest of them in lane order
// (__match_any_sync). chip_smoke.py phase 9 checks both.
//
// What bounds it: bytes. Theta is written once, 4 N^2 bytes: 400 MB at
// N = 10^4, 0.119 ms at 3.35 TB/s. The keys, the slots and the real
// inverse entries it reads are under 10 MB at n = 1000, k = 46.
//
// What the design does about it. One warp owns row i and writes all of it,
// so no entry is written twice, no atomic is needed and the zero fill is
// the row's own write. The row passes through a 4 KB slice of shared memory
// at a time (1024 floats): the warp zeroes the slice, walks i's real slots
// in subset order (their run of the sorted keys, found by a 32-way search)
// and adds inv[s, a, b] into the slice for every real b of subset s whose
// index falls in it, then writes the slice over n to the row, coalesced.
// Rows of items in no subset (~e^-2 of them at E|Y| 20) are written as
// zeros straight away.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // rows (warps) a block
constexpr int kSliceBytes = 4096;    // a warp's slice of its row

// First position p of sorted[0, m) with sorted[p] >= v (m if none), by the
// whole warp: each round probes 32 positions, so 4 rounds at m = 46,000.
__device__ long long lower_bound_warp(const int* __restrict__ sorted,
                                      long long m, int v, int lane) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool less = p < hi && __ldg(sorted + p) < v;
    const int c = __popc(__ballot_sync(kFull, less));
    if (c == 0) {
      hi = lo;
    } else {
      const long long top = lo + c * step;
      lo += (c - 1) * step + 1;
      if (top < hi) hi = top;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
theta_scatter_kernel(const int* __restrict__ keys,
                     const int* __restrict__ sorted,
                     const long long* __restrict__ slot_of,
                     const T* __restrict__ inv, T* __restrict__ theta, int N,
                     int k, long long slots, T n) {
  constexpr int kSlice = kSliceBytes / static_cast<int>(sizeof(T));
  __shared__ T slices[kWarps][kSlice];
  __shared__ T terms[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;                  // the whole warp leaves together
  T* slice = slices[warp];
  T* term = terms[warp];
  T* row = theta + static_cast<size_t>(i) * N;
  const long long first = lower_bound_warp(sorted, slots, i, lane);
  if (first == slots || __ldg(sorted + first) != i) {
    const T zero = T(0) / n;           // NaN at n = 0, as the plain version
    for (int j = lane; j < N; j += 32) row[j] = zero;
    return;
  }
  for (int t0 = 0; t0 < N; t0 += kSlice) {
    const int w = min(kSlice, N - t0);
    for (int j = lane; j < w; j += 32) slice[j] = T(0);
    __syncwarp();
    for (long long o = first; o < slots && __ldg(sorted + o) == i; ++o) {
      const long long slot = __ldg(slot_of + o);     // s k + a
      const int* cols = keys + (slot / k) * k;       // subset s's keys
      const T* v = inv + slot * k;                   // inv[s, a, :]
      for (int b0 = 0; b0 < k; b0 += 32) {
        const int b = b0 + lane;
        int at = -1 - lane;                          // matches no other lane
        T x = T(0);
        if (b < k) {
          const int j = __ldg(cols + b);
          if (j >= t0 && j < t0 + w) {
            at = j - t0;
            x = __ldg(v + b);
          }
        }
        // lanes of one column (a repeated item) add in lane order, b's
        const unsigned same = __match_any_sync(kFull, at);
        term[lane] = x;
        __syncwarp();
        if (at >= 0 && lane == __ffs(same) - 1) {
          T acc = slice[at];
          for (unsigned m = same; m; m &= m - 1) acc += term[__ffs(m) - 1];
          slice[at] = acc;
        }
        __syncwarp();
      }
    }
    for (int j = lane; j < w; j += 32) row[t0 + j] = slice[j] / n;
    __syncwarp();
  }
}

template <typename T>
int launch(const void* keys, const void* sorted, const void* slot_of,
           const void* inv, void* theta, int N, int k, long long slots,
           int n, cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(N) + kWarps - 1) / kWarps;
  theta_scatter_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                            stream>>>(
      static_cast<const int*>(keys), static_cast<const int*>(sorted),
      static_cast<const long long*>(slot_of), static_cast<const T*>(inv),
      static_cast<T*>(theta), N, k, slots, static_cast<T>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Theta (N x N, 4- or 8-byte floats as dtype_bytes says) of n subsets of
// k slots: keys, sorted (slots int32 each), slot_of (slots int64), inv
// (slots x k). slots = n k; an empty batch (slots 0) gives zeros over n.
extern "C" int theta_scatter_launch(const void* keys, const void* sorted,
                                    const void* slot_of, const void* inv,
                                    void* theta, int N, int k,
                                    long long slots, int n, int dtype_bytes,
                                    void* stream) {
  if (N < 1 || k < 0 || n < 0 || slots != static_cast<long long>(n) * k)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4)
    return launch<float>(keys, sorted, slot_of, inv, theta, N, k, slots, n,
                         s);
  if (dtype_bytes == 8)
    return launch<double>(keys, sorted, slot_of, inv, theta, N, k, slots, n,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* theta_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
