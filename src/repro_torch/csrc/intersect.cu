// Batched sorted-list set intersection for the intersection lane, sm_90a.
//
// Three kernels, one per strategy of repro_torch.kernels.intersect.ops. Each
// takes two int32 (E, W) row-major arrays u and v whose rows are sorted
// neighbour lists, and writes the int32 (E,) per-row count. Any E >= 1 and
// W >= 1 are accepted: a block masks its own ragged edge, so callers never
// pad rows to a tile multiple. Row offsets are 64-bit (E * W passes 2^31 on
// the largest buckets).
//
// Sentinel contract (kept exactly): in-row padding is n (u) and n + 1 (v);
// whole padding rows are -1 (u) and -2 (v). Broadcast counts all equal
// pairs; probe counts the u elements whose lower bound in v hits; bitmap
// ignores ids outside [0, num_bits) on both sides.
//
// The C interface takes raw device pointers, ints and a cudaStream_t passed
// as void*, and returns cudaGetLastError() after the launch, so a refused
// launch is reported to the caller instead of being lost.
//
// Bound, all three: the function must read u and v once and write the
// counts, 2*E*W*4 + 4*E bytes, against 3.35 TB/s of HBM on an H100 SXM; the
// (4194304, 512) bucket of the scale-18 R-MAT is about 5.1 ms. The least
// compare work, a merge of two sorted rows, is about 2*W steps a row and is
// far below the bytes at these widths.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads per block, all kernels
constexpr int kSlab = 1024;      // K1: v values staged per pass
constexpr int kProbeStage = 8192;  // K2: widest v row staged in shared memory

// Rows a block handles and threads per row, for a per-row extent `w` (the
// width, or the bitmap's word count when that is larger). Narrow rows are
// packed several to a block so that every thread has work; a row of 256 or
// more takes a block of its own.
struct Tiling {
  int rows;
  int tpr;
};

inline Tiling tiling_for(int w) {
  const int rows = w >= kThreads ? 1 : kThreads / w;
  return {rows, kThreads / rows};
}

// ---------------------------------------------------------------------------
// K1 — broadcast compare.
// Replaces repro/kernels/intersect/intersect.py _intersect_kernel
// (intersect_counts_pallas). The TPU kernel compared a (TE, W) u tile with
// 128-lane slabs of v in VMEM. Here a block takes `rows` rows; v is staged
// in shared memory in slabs of at most kSlab values, and each thread compares
// its u elements against the whole slab. O(W^2) compares a row, so the
// kernel is compare-bound past small W; the auto cost model only gives it
// rows narrower than 64, where one slab holds the row and each u element
// is read once from global memory per slab.
// ---------------------------------------------------------------------------
__global__ void broadcast_counts_kernel(const int* __restrict__ u,
                                        const int* __restrict__ v,
                                        int* __restrict__ out, int E, int W,
                                        int rows, int tpr) {
  __shared__ int sv[kSlab];
  __shared__ int rcount[kThreads];
  const int lr = threadIdx.x / tpr;
  const int lane = threadIdx.x - lr * tpr;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + lr;
  const bool active = lr < rows && row < E;
  const int slab = min(W, kSlab);  // rows * slab <= kSlab by the tiling
  if (threadIdx.x < rows) rcount[threadIdx.x] = 0;
  int cnt = 0;
  for (int c0 = 0; c0 < W; c0 += slab) {
    const int cw = min(slab, W - c0);
    __syncthreads();  // the previous slab is consumed
    for (int i = threadIdx.x; i < rows * cw; i += blockDim.x) {
      const int r = i / cw;
      const int k = i - r * cw;
      if (row0 + r < E) sv[r * slab + k] = v[(row0 + r) * W + c0 + k];
    }
    __syncthreads();
    if (active) {
      const int* s = sv + lr * slab;
      const int* ur = u + row * W;
      for (int j = lane; j < W; j += tpr) {
        const int x = ur[j];
        for (int k = 0; k < cw; ++k) cnt += (s[k] == x);
      }
    }
  }
  if (active && cnt) atomicAdd(&rcount[lr], cnt);
  __syncthreads();
  if (threadIdx.x < rows && row0 + threadIdx.x < E)
    out[row0 + threadIdx.x] = rcount[threadIdx.x];
}

// ---------------------------------------------------------------------------
// K2 — binary probe.
// Replaces repro/kernels/intersect/probe.py _probe_kernel
// (intersect_counts_probe_pallas). The TPU kernel ran a fixed-round
// branchless lower bound on all TE*W lanes in lockstep. Here each thread
// takes u elements of its row and runs a lower-bound search in the sorted v
// row, which the block stages in shared memory when W <= kProbeStage (else
// the search reads global memory). A hit is lo < W && v[lo] == x. O(W log W)
// shared-memory reads a row against 8*W bytes from HBM: the staging keeps
// the search's log W re-reads off HBM, so HBM traffic is the bound's.
// ---------------------------------------------------------------------------
__global__ void probe_counts_kernel(const int* __restrict__ u,
                                    const int* __restrict__ v,
                                    int* __restrict__ out, int E, int W,
                                    int rows, int tpr, int staged) {
  extern __shared__ int smem[];
  int* rcount = smem;     // rows
  int* sv = smem + rows;  // rows * W when staged
  const int lr = threadIdx.x / tpr;
  const int lane = threadIdx.x - lr * tpr;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + lr;
  const bool active = lr < rows && row < E;
  if (threadIdx.x < rows) rcount[threadIdx.x] = 0;
  if (staged) {
    for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
      const int r = i / W;
      if (row0 + r < E) sv[i] = v[row0 * W + i];
    }
  }
  __syncthreads();
  int cnt = 0;
  if (active) {
    const int* vr = staged ? sv + lr * W : v + row * W;
    const int* ur = u + row * W;
    for (int j = lane; j < W; j += tpr) {
      const int x = ur[j];
      int lo = 0, hi = W;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (vr[mid] < x) lo = mid + 1; else hi = mid;
      }
      cnt += (lo < W && vr[lo] == x);
    }
  }
  if (active && cnt) atomicAdd(&rcount[lr], cnt);
  __syncthreads();
  if (threadIdx.x < rows && row0 + threadIdx.x < E)
    out[row0 + threadIdx.x] = rcount[threadIdx.x];
}

// ---------------------------------------------------------------------------
// K3 — packed bitmap.
// Replaces repro/kernels/intersect/bitmap.py _bitmap_kernel
// (intersect_counts_bitmap_pallas, body _pack_and_probe). The TPU kernel
// summed first-occurrence bits word by word into (TE, num_bits/32) words.
// Here each row owns num_bits/32 words of shared memory (8 KB at the 65536
// cap): clear, atomicOr the bit of every in-range v (OR is idempotent, so
// no first-occurrence pass), sync, then test every in-range u. One HBM read
// of u and v a row; the bitmap never leaves the SM.
// ---------------------------------------------------------------------------
__global__ void bitmap_counts_kernel(const int* __restrict__ u,
                                     const int* __restrict__ v,
                                     int* __restrict__ out, int E, int W,
                                     int num_bits, int rows, int tpr) {
  extern __shared__ unsigned int words[];  // rows * nwords, then rcount
  const int nwords = num_bits >> 5;
  int* rcount = reinterpret_cast<int*>(words + rows * nwords);
  const int lr = threadIdx.x / tpr;
  const int lane = threadIdx.x - lr * tpr;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + lr;
  const bool active = lr < rows && row < E;
  unsigned int* bits = words + lr * nwords;
  if (lr < rows)
    for (int k = lane; k < nwords; k += tpr) bits[k] = 0u;
  if (threadIdx.x < rows) rcount[threadIdx.x] = 0;
  __syncthreads();
  if (active) {
    const int* vr = v + row * W;
    for (int j = lane; j < W; j += tpr) {
      const int x = vr[j];
      if (x >= 0 && x < num_bits) atomicOr(&bits[x >> 5], 1u << (x & 31));
    }
  }
  __syncthreads();
  int cnt = 0;
  if (active) {
    const int* ur = u + row * W;
    for (int j = lane; j < W; j += tpr) {
      const int x = ur[j];
      if (x >= 0 && x < num_bits) cnt += (bits[x >> 5] >> (x & 31)) & 1u;
    }
  }
  if (active && cnt) atomicAdd(&rcount[lr], cnt);
  __syncthreads();
  if (threadIdx.x < rows && row0 + threadIdx.x < E)
    out[row0 + threadIdx.x] = rcount[threadIdx.x];
}

inline unsigned int blocks_for(int E, int rows) {
  return (unsigned int)((E + (long long)rows - 1) / rows);
}

}  // namespace

extern "C" {

int tc_broadcast_counts(const int* u, const int* v, int* out, int E, int W,
                        void* stream) {
  const Tiling t = tiling_for(W);
  broadcast_counts_kernel<<<blocks_for(E, t.rows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      u, v, out, E, W, t.rows, t.tpr);
  return static_cast<int>(cudaGetLastError());
}

int tc_probe_counts(const int* u, const int* v, int* out, int E, int W,
                    void* stream) {
  const Tiling t = tiling_for(W);
  const int staged = W <= kProbeStage ? 1 : 0;
  const size_t smem = sizeof(int) * (t.rows + (staged ? (size_t)t.rows * W : 0));
  probe_counts_kernel<<<blocks_for(E, t.rows), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      u, v, out, E, W, t.rows, t.tpr, staged);
  return static_cast<int>(cudaGetLastError());
}

int tc_bitmap_counts(const int* u, const int* v, int* out, int E, int W,
                     int num_bits, void* stream) {
  const int nwords = num_bits >> 5;
  const Tiling t = tiling_for(W > nwords ? W : nwords);
  const size_t smem = sizeof(unsigned int) * ((size_t)t.rows * nwords + t.rows);
  bitmap_counts_kernel<<<blocks_for(E, t.rows), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      u, v, out, E, W, num_bits, t.rows, t.tpr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
