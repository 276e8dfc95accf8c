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
// far below the bytes at these widths. K2 also skips the rows whose id
// ranges cannot meet, so it is held against the bytes it must read: whole
// rows where the ranges overlap, the row ends elsewhere (about 3.3 ms on
// that bucket, whose whole padding rows are 37 % of it).

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;    // threads per block, all kernels
constexpr int kSlab = 1024;      // K1: v values staged per pass

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
// K2 — binary probe, as a persistent, pipelined merge-path count.
// Replaces repro/kernels/intersect/probe.py:61 _probe_kernel
// (intersect_counts_probe_pallas), which ran a fixed-round branchless lower
// bound on all TE*W lanes of a VMEM tile in lockstep. The function is kept:
// for each row, the number of u elements whose lower bound in the sorted v
// row holds an equal value (each duplicate in u counted; duplicates in v
// change nothing). Both rows must be sorted ascending, u too: the TPU
// kernel searched each u element on its own and took any u, but the range
// test and the merge read u's order (a caller that drops u ids in place,
// as a labeled triangle query does, sorts each row again).
//
// Bound: bytes. A row pair whose id ranges overlap must be read whole
// (2*W*4 bytes); one whose ranges cannot meet only at its four ends. At
// 2*W merge steps a row the compare work is far below the bytes.
//
// Design, against what held the one-block-a-row kernel back:
// - Loads overlapped with compute: a team of tw warps (1 up to W = 1024,
//   then 2, 4 or 8, so that a lane merges at most ~kProbeMaxSteps elements)
//   owns a ring of kProbeStages row-pair slots in shared memory, filled by
//   cp.async while it merges the oldest slot. 16-byte copies when both base
//   pointers are 16-byte aligned and W % 4 == 0; else 4-byte copies, so odd
//   W and views that start mid-allocation take the same ring.
// - A persistent grid: as many 256-thread blocks as fit on the device's SMs
//   at once (SM count, shared-memory cap and occupancy read once per
//   device and shared-memory size, then kept); team g takes the
//   32-row batches g, g + G, g + 2G, ... of the bucket.
// - Rows that cannot meet are never loaded: a batch's row ends (u[0],
//   u[W-1], v[0], v[W-1]) are read one batch ahead, a lane a row; a row with
//   u[0] > v[W-1] or u[W-1] < v[0] gets its 0 at once and no slot. Whole
//   padding rows (-1 against -2) fail the test, so the pow2 row padding
//   costs its row ends only.
// - Merge path instead of a search per element. Two warp-wide searches
//   (32 lanes probe at once) first cut the merge to the elements that can
//   meet, which drops both rows' in-row padding from the work (not from
//   the reads). Each lane then takes an equal, odd-length slice of the
//   merge of the cut rows in which u wins ties (so the v cursor sits at
//   u's lower bound whenever u is taken), finds its start by one co-rank
//   search, and merges the slice sequentially. The odd slice length puts
//   lanes that walk a run of one row in different shared-memory banks.
//   Counts are summed by shuffles, across a team's warps through shared
//   memory.
// - Rows too wide for kProbeStages slots in a block's shared memory (W past
//   ~9.6K) are merged straight from global memory by the same code.
// ---------------------------------------------------------------------------

constexpr int kProbeStages = 3;      // ring slots a team
constexpr int kProbeBatch = 32;      // rows whose ends a warp tests at once
constexpr int kProbeMaxSteps = 64;   // merge steps a lane, at most, picks tw
constexpr int kProbePartials = 16;   // ints: each team's [2][tw] partials

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// All threads of one team: the warp itself, or a named barrier (ids 1..8).
__device__ __forceinline__ void team_sync(int tw, int team) {
  if (tw == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(tw * 32)
                 : "memory");
  }
}

// The first index in [0, L) whose element is > x (L if none), found by the
// warp's 32 lanes probing evenly spaced positions: two rounds at L = 512,
// three at 8192. Every lane of the warp calls it with the same a, L and x.
__device__ __forceinline__ int warp_upper_bound(const int* a, int L, int x,
                                                int lane) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const long long p = lo + (long long)lane * step;
    const bool le = p < hi && a[p] <= x;
    const int k = __popc(__ballot_sync(0xffffffffu, le));
    if (k == 0) return lo;
    const int base = lo + (k - 1) * step;
    lo = base + 1;
    hi = min(base + step, hi);
  }
  return lo;
}

// This lane's share of one row's count. The merge is first cut to the
// elements that can meet: v up to u's last element (no v above it is a
// hit's lower bound), then u up to that v's last (no u above it can hit);
// this drops the in-row padding of both rows. The lane then takes its
// slice [d0, d1) of the merge of the two prefixes in which u wins ties,
// and counts the u elements that meet an equal v at the v cursor, i.e. at
// their lower bound.
__device__ __forceinline__ int merge_slice_count(const int* us, const int* vs,
                                                 int W, int tl, int T,
                                                 int lane) {
  const int nv = warp_upper_bound(vs, W, us[W - 1], lane);
  if (nv == 0) return 0;
  const int nu = warp_upper_bound(us, W, vs[nv - 1], lane);
  if (nu == 0) return 0;
  const long long total = (long long)nu + nv;
  const long long per = ((total + T - 1) / T) | 1;
  const long long d0 = tl * per;
  if (d0 >= total) return 0;
  const long long d1 = d0 + per < total ? d0 + per : total;
  // co-rank: the first i with us[i] > vs[d0 - 1 - i]
  int lo = static_cast<int>(d0 > nv ? d0 - nv : 0);
  int hi = static_cast<int>(d0 < nu ? d0 : nu);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (us[mid] <= vs[d0 - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  int i = lo;
  int j = static_cast<int>(d0 - lo);
  int ui = us[min(i, nu - 1)];
  int vj = vs[min(j, nv - 1)];
  int cnt = 0;
  for (int s = static_cast<int>(d1 - d0); s > 0; --s) {
    // after the cut v's last element is the merge's last, so v is never
    // exhausted while u is not: a taken u meets vj, a real v element
    const bool take_u = i < nu && ui <= vj;
    cnt += take_u && ui == vj;
    if (take_u) ++i; else ++j;
    const int* next = take_u ? us + min(i, nu - 1) : vs + min(j, nv - 1);
    const int x = *next;
    if (take_u) ui = x; else vj = x;
  }
  return cnt;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
probe_merge_kernel(const int* __restrict__ u, const int* __restrict__ v,
                   int* __restrict__ out, int E, int W, int tw, int vec16) {
  extern __shared__ __align__(16) int psmem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int T = tw * 32;
  const int team = warp / tw;
  const int twarp = warp - team * tw;
  const int tl = twarp * 32 + lane;
  const int teams = kThreads / T;
  int* partial = psmem + team * 2 * tw;
  int* ring = kStaged ? psmem + kProbePartials +
                            (size_t)team * kProbeStages * 2 * (size_t)W
                      : nullptr;
  const long long Wl = W;
  const int nbatch = (E + kProbeBatch - 1) / kProbeBatch;
  const int G = gridDim.x * teams;

  // The issue cursor: batch ib, its live rows not yet issued, and the ends
  // of batch ib + G, loaded one batch ahead.
  int ib = blockIdx.x * teams + team - G;
  unsigned imask = 0u;
  int e0 = 0, e1 = 0, e2 = 0, e3 = 0;
  bool ev = false;
  auto load_ends = [&](int b) {
    const long long row = (long long)b * kProbeBatch + lane;
    ev = b < nbatch && row < E;
    if (ev) {
      const int* ur = u + row * Wl;
      const int* vr = v + row * Wl;
      e0 = ur[0];
      e1 = ur[W - 1];
      e2 = vr[0];
      e3 = vr[W - 1];
    }
  };
  auto next_row = [&]() -> int {
    while (imask == 0u) {
      ib += G;
      if (ib >= nbatch) return -1;
      const bool live = ev && !(e0 > e3 || e1 < e2);
      imask = __ballot_sync(0xffffffffu, live);
      if (twarp == 0 && ev && !live) out[(long long)ib * kProbeBatch + lane] = 0;
      load_ends(ib + G);
    }
    const int bit = __ffs(imask) - 1;
    imask &= imask - 1u;
    return ib * kProbeBatch + bit;
  };
  auto issue = [&](int row, int slot) {
    if (kStaged && row >= 0) {
      int* su = ring + (size_t)slot * 2 * W;
      int* sv = su + W;
      const int* gu = u + row * Wl;
      const int* gv = v + row * Wl;
      if (vec16) {
        for (int c = tl * 4; c < W; c += T * 4) {
          cp_async16(su + c, gu + c);
          cp_async16(sv + c, gv + c);
        }
      } else {
        for (int c = tl; c < W; c += T) {
          cp_async4(su + c, gu + c);
          cp_async4(sv + c, gv + c);
        }
      }
    }
    cp_async_commit();
  };

  load_ends(ib + G);
  int q[kProbeStages - 1];  // rows in flight, oldest first
#pragma unroll
  for (int s = 0; s < kProbeStages - 1; ++s) {
    q[s] = next_row();
    issue(q[s], s);
  }
  int slot = 0;
  int pend = -1;  // tw > 1: the row whose warp partials wait to be summed
  int par = 0;
  for (;;) {
    cp_async_wait<kProbeStages - 2>();  // this thread's copies of q[0]
    team_sync(tw, team);                // everyone's; the last slot is free
    if (pend >= 0 && tl == 0) {
      int sum = 0;
      for (int w = 0; w < tw; ++w) sum += partial[(par ^ 1) * tw + w];
      out[pend] = sum;
    }
    pend = -1;
    const int row = q[0];
    if (row < 0) break;
    const int fill = slot == 0 ? kProbeStages - 1 : slot - 1;
#pragma unroll
    for (int s = 0; s < kProbeStages - 2; ++s) q[s] = q[s + 1];
    q[kProbeStages - 2] = next_row();
    issue(q[kProbeStages - 2], fill);

    const int* us = kStaged ? ring + (size_t)slot * 2 * W : u + row * Wl;
    const int* vs = kStaged ? us + W : v + row * Wl;
    int cnt = merge_slice_count(us, vs, W, tl, T, lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (tw == 1) {
      if (lane == 0) out[row] = cnt;
    } else {
      if (lane == 0) partial[par * tw + twarp] = cnt;
      pend = row;
      par ^= 1;
    }
    slot = slot == kProbeStages - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
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

// K2's launch facts, read from the driver once and kept: a device's SM
// count and opt-in shared-memory cap (on first sight of a device both
// routes' dynamic shared-memory limit is raised to that cap), and the
// blocks an SM holds for each (device, route, shared bytes). A launch then
// makes no driver query but cudaGetDevice.
struct ProbeDevice {
  int sms = 0;
  int optin = 0;
};

struct ProbeOccupancy {
  int dev;
  bool staged;
  size_t smem;
  int per_sm;
};

using ProbeKernel = void (*)(const int*, const int*, int*, int, int, int,
                             int);

inline ProbeKernel probe_kernel(bool staged) {
  return staged ? probe_merge_kernel<true> : probe_merge_kernel<false>;
}

constexpr int kProbeDevices = 64;     // devices whose facts are kept
constexpr int kProbeOccupancies = 64; // (device, route, bytes) kept

std::mutex probe_facts_mu;
ProbeDevice probe_devices[kProbeDevices];
ProbeOccupancy probe_occupancies[kProbeOccupancies];
int probe_occupancy_count = 0;

cudaError_t probe_device(int dev, ProbeDevice* out) {
  std::lock_guard<std::mutex> lock(probe_facts_mu);
  const bool kept = dev >= 0 && dev < kProbeDevices;
  if (kept && probe_devices[dev].sms > 0) {
    *out = probe_devices[dev];
    return cudaSuccess;
  }
  ProbeDevice d;
  cudaError_t err =
      cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_kernel(true),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_kernel(false),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.optin);
  if (err != cudaSuccess) return err;
  if (kept) probe_devices[dev] = d;
  *out = d;
  return cudaSuccess;
}

cudaError_t probe_blocks_per_sm(int dev, bool staged, size_t smem,
                                int* per_sm) {
  std::lock_guard<std::mutex> lock(probe_facts_mu);
  for (int i = 0; i < probe_occupancy_count; ++i) {
    const ProbeOccupancy& o = probe_occupancies[i];
    if (o.dev == dev && o.staged == staged && o.smem == smem) {
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, probe_kernel(staged), kThreads, smem);
  if (err == cudaSuccess && probe_occupancy_count < kProbeOccupancies)
    probe_occupancies[probe_occupancy_count++] = {dev, staged, smem, *per_sm};
  return err;
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
  int tw = 1;  // warps a team: a lane merges at most ~kProbeMaxSteps elements
  while (tw < kThreads / 32 && 2LL * W > (long long)tw * 32 * kProbeMaxSteps)
    tw <<= 1;
  const int teams = kThreads / 32 / tw;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  ProbeDevice d;
  if (err == cudaSuccess) err = probe_device(dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t base = sizeof(int) * kProbePartials;
  const size_t ring = sizeof(int) * (size_t)teams * kProbeStages * 2 * W;
  const bool staged = base + ring <= (size_t)d.optin;
  const size_t smem = staged ? base + ring : base;
  const int vec16 = W % 4 == 0 && ((reinterpret_cast<size_t>(u) |
                                    reinterpret_cast<size_t>(v)) & 15) == 0;
  int per_sm = 0;
  err = probe_blocks_per_sm(dev, staged, smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long batches = (E + (long long)kProbeBatch - 1) / kProbeBatch;
  const long long wanted = (batches + teams - 1) / teams;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * d.sms;
  const unsigned int grid =
      (unsigned int)(wanted < resident ? wanted : resident);
  const ProbeKernel kernel = probe_kernel(staged);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, out, E, W, tw, vec16);
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
