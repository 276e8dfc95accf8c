// Batched set intersection for the intersection lane, sm_90a.
//
// Three kernels, one per strategy of repro_torch.kernels.intersect.ops, and
// the probe strategy's second form on the forward CSR (probe_csr_kernel,
// further down, which reads each row pair from the CSR instead). Each of
// the three takes two int32 (E, W) row-major arrays u and v and writes the
// int32 (E,) per-row count. Any E >= 1 and W >= 1 are accepted: a kernel
// masks its own ragged edge, so callers never pad rows to a tile multiple.
// Row offsets are 64-bit (E * W passes 2^31 on the largest buckets).
//
// What each reads of the rows' order: broadcast (K1) counts all equal
// (u[j], v[k]) pairs and takes any rows, unsorted and with duplicates; probe
// (K2) needs both rows sorted ascending; bitmap (K3) counts the u elements,
// with multiplicity, whose id lies in [0, num_bits) and occurs in v, and
// takes any u (its plain version packs v by first occurrences, so equal v
// ids must be adjacent there; the kernel ORs bits and does not need it).
// The engine's sentinels (in-row padding n for u and n + 1 for v, whole
// padding rows -1 and -2) never match under any of the three.
//
// The C interface takes raw device pointers, ints and a cudaStream_t passed
// as void*, and returns cudaGetLastError() after the launch, so a refused
// launch is reported to the caller instead of being lost.
//
// Bound, all three: the function must read u and v once and write the
// counts, 2*E*W*4 + 4*E bytes, against 3.35 TB/s of HBM on an H100 SXM; the
// (4194304, 512) bucket of the scale-18 R-MAT is about 5.1 ms, the grid's
// (33554432, 8) about 0.68 ms. K1 and K3 read every row, since their
// functions are exact for any input. The least compare work, a merge of two
// sorted rows, is about 2*W steps a row and is far below the bytes at these
// widths. K2 also skips the rows whose id ranges cannot meet, so it is held
// against the bytes it must read: whole rows where the ranges overlap, the
// row ends elsewhere (about 3.3 ms on that bucket, whose whole padding rows
// are 37 % of it).

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kThreads = 256;    // threads per block of K1 and K2
constexpr int kSlab = 1024;      // K1's slab route: v values staged per pass

// K1's slab route: rows a block handles and threads per row, for a width
// `w`. Narrow rows are packed several to a block so that every thread has
// work; a row of 256 or more takes a block of its own.
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
// 128-lane slabs of v in VMEM. The function is kept: each row's count of
// all equal (u[j], v[k]) pairs, for any rows (unsorted, duplicates counted
// pair by pair). Two routes, by width:
//
// W < kRegMaxWidth (64, the auto cost model's broadcast cut-off, so every
// width auto gives K1): broadcast_reg_kernel, in registers.
// - Bound: bytes. Every row must be read; at W = 8 a row is 64 bytes for
//   64 compares, so HBM's rate, not the ALUs, sets the pace, and the
//   kernel's job is to keep enough bytes in flight.
// - Groups of G lanes, G = ceil(W/4) rounded up to a power of two, own a
//   row; lane g of a group holds u and v ids 4g .. 4g + 3 in registers, so a
//   warp takes 32/G rows at once (a tile). At W = 8 that is 16 rows, 512
//   contiguous bytes of u and of v, read by one 16-byte load a lane of each.
//   The 16-byte route needs W % 4 == 0 and both base pointers 16-byte
//   aligned; else each id is read by a 4-byte load (odd W, views that start
//   mid-allocation). The tail past W is masked by predicates: any int32 can
//   be a real id, so no filler value would do.
// - Compares: each lane takes the group's v quads in turn by __shfl_sync
//   over the group, 16 compares a step, then the group sums by shuffles and
//   its first lane writes the count. Where every lane of a group holds ids
//   (ceil(W/4) a power of two: W = 8, 16, 32, ...) a lane starts with its
//   own quad and rotates through the others, G steps; else only the first
//   ceil(W/4) lanes hold ids and every lane takes those in turn, so no step
//   is spent on an empty quad. No shared memory, no block barrier, no
//   atomics.
// - A persistent grid sized by occupancy: warp w takes tiles w, w + NW, ...
//   and keeps the loads of its next kDepth tiles in flight in registers
//   while it compares the current one. Every lane of a warp runs the same
//   number of iterations (rows past E are predicated off, never branched
//   around), so the full-mask shuffles are always converged.
//
// W >= 64 arrives only when broadcast is forced: broadcast_counts_kernel, the
// first port's kernel. A block takes `rows` rows; v is staged in shared
// memory in slabs of at most kSlab values, and each thread compares its u
// elements against the whole slab. O(W^2) compares a row, so it is
// compare-bound there.
// ---------------------------------------------------------------------------

constexpr int kRegMaxWidth = 64;  // K1's register route takes W below this
constexpr int kRegDepth = 2;      // K1: tiles a warp keeps loading ahead

template <bool kVec16>
__device__ __forceinline__ int4 load_quad(const int* __restrict__ p,
                                          long long row, long long W, int c0,
                                          int n) {
  int4 q = make_int4(0, 0, 0, 0);
  if (n <= 0) return q;
  const int* r = p + row * W + c0;
  if constexpr (kVec16) return __ldcs(reinterpret_cast<const int4*>(r));
  q.x = __ldcs(r);
  if (n > 1) q.y = __ldcs(r + 1);
  if (n > 2) q.z = __ldcs(r + 2);
  if (n > 3) q.w = __ldcs(r + 3);
  return q;
}

// Equal pairs between a u quad with nu valid ids and a v quad with nv.
template <bool kVec16>
__device__ __forceinline__ int quad_pairs(const int4& a, int nu,
                                          const int4& b, int nv) {
  if constexpr (kVec16) {  // W % 4 == 0: a quad is whole or empty
    const int cnt = (a.x == b.x) + (a.x == b.y) + (a.x == b.z) + (a.x == b.w)
                  + (a.y == b.x) + (a.y == b.y) + (a.y == b.z) + (a.y == b.w)
                  + (a.z == b.x) + (a.z == b.y) + (a.z == b.z) + (a.z == b.w)
                  + (a.w == b.x) + (a.w == b.y) + (a.w == b.z) + (a.w == b.w);
    return nu > 0 && nv > 0 ? cnt : 0;
  } else {
    auto row = [&](int x, bool live) {
      return live ? (nv > 0 && x == b.x) + (nv > 1 && x == b.y)
                  + (nv > 2 && x == b.z) + (nv > 3 && x == b.w) : 0;
    };
    return row(a.x, nu > 0) + row(a.y, nu > 1) + row(a.z, nu > 2) +
           row(a.w, nu > 3);
  }
}

// Lane `src`'s quad, within groups of G lanes.
template <int G>
__device__ __forceinline__ int4 shfl_quad(const int4& q, int src) {
  return make_int4(__shfl_sync(0xffffffffu, q.x, src, G),
                   __shfl_sync(0xffffffffu, q.y, src, G),
                   __shfl_sync(0xffffffffu, q.z, src, G),
                   __shfl_sync(0xffffffffu, q.w, src, G));
}

template <int G, bool kVec16>
__global__ void __launch_bounds__(kThreads)
broadcast_reg_kernel(const int* __restrict__ u, const int* __restrict__ v,
                     int* __restrict__ out, int E, int W) {
  constexpr int R = 32 / G;  // rows a warp takes per tile
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int r = lane / G;
  const long long Wl = W;
  // ids in this lane's quad (the same for every row, so computed once)
  const int mine = max(0, min(4, W - 4 * g));
  const int quads = (W + 3) / 4;  // group lanes that hold ids
  const long long nw = (long long)gridDim.x * (kThreads / 32);
  const long long w0 = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long ntiles = (E + R - 1) / R;

  int4 bu[kRegDepth], bv[kRegDepth];
#pragma unroll
  for (int d = 0; d < kRegDepth; ++d) {
    const long long row = (w0 + d * nw) * R + r;
    const int n = row < E ? mine : 0;
    bu[d] = load_quad<kVec16>(u, row, Wl, 4 * g, n);
    bv[d] = load_quad<kVec16>(v, row, Wl, 4 * g, n);
  }
  for (long long t = w0; t < ntiles; t += kRegDepth * nw) {
#pragma unroll
    for (int d = 0; d < kRegDepth; ++d) {
      const int4 cu = bu[d];
      const int4 cv = bv[d];
      const long long row = (t + d * nw) * R + r;
      const int nu = row < E ? mine : 0;
      {  // refill the slot with the tile kRegDepth ahead
        const long long ahead = (t + (kRegDepth + d) * nw) * R + r;
        const int n = ahead < E ? mine : 0;
        bu[d] = load_quad<kVec16>(u, ahead, Wl, 4 * g, n);
        bv[d] = load_quad<kVec16>(v, ahead, Wl, 4 * g, n);
      }
      int cnt = 0;
      if (quads == G) {  // every lane of a group holds ids: rotate them
        cnt = quad_pairs<kVec16>(cu, nu, cv, mine);
#pragma unroll 7
        for (int s = 1; s < G; ++s) {
          const int src = (g + s) & (G - 1);
          cnt += quad_pairs<kVec16>(cu, nu, shfl_quad<G>(cv, src),
                                    max(0, min(4, W - 4 * src)));
        }
      } else {  // only the first `quads` lanes do: each lane takes them in turn
#pragma unroll 4
        for (int s = 0; s < quads; ++s)
          cnt += quad_pairs<kVec16>(cu, nu, shfl_quad<G>(cv, s),
                                    min(4, W - 4 * s));
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      if (g == 0 && row < E) out[row] = cnt;
    }
  }
}

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
// K2 on the forward CSR — probe_csr_kernel.
// Replaces repro/kernels/intersect/probe.py:61 _probe_kernel
// (intersect_counts_probe_pallas) as probe_merge_kernel does, for the
// resident buckets of a plan prepped on the device: the same function,
// each row's count of N+(src) ids found in N+(dst), but the rows are read
// where they live, in the forward-oriented CSR (row_ptr, col), at their
// real lengths (each cut to the bucket width W), instead of from the
// bucket's padded (E, W) copies. An empty forward row gives 0 without a
// load; no padding id is read. The rows are a simple graph's: sorted, each
// id once, so the count is also that of N+(dst) ids found in N+(src). The
// caller launches the bucket's real rows only (its padding rows carry
// src = dst = 0, which read as CSR rows would count |N+(0)|).
//
// Bound: bytes. The least is the graph read once (4 bytes an undirected
// edge and 4 a row offset). A design that reuses nothing reads each live
// edge's two rows, (d+(src) + d+(dst)) * 4 bytes, with 8 bytes of
// endpoints and 4 of count an edge: on the scale-19 Kronecker graph's
// widest bucket 10.5 GB, against 26.7 GB of padded must-read. Two reuses
// bring the reads toward the first bound:
// - A bucket keeps CSR order, so src repeats in runs (21.6 rows a run on
//   that bucket). A warp builds a set of N+(src) in its shared memory once
//   a run, and each row of the run streams only N+(dst) past it.
// - The N+(dst) of a bucket are few and hot (16,655 distinct vertices,
//   14 MB on that bucket, against 50 MB of L2). They are read by ordinary
//   cached loads; the streamed endpoints and counts are read and written
//   evict-first (__ldcs, __stcs), so they do not push the hot rows out.
// Why a set and not probe_merge_kernel's merge path: with the rows at
// their real lengths the merge's chain of dependent shared-memory steps,
// not the bytes, set the time (on that bucket 6.8 of 7.8 ms with the row
// copies left out). A lookup per N+(dst) id is independent of the others:
// each lane loads kCsrUnroll ids of the row at once, 32 lanes a warp, and
// looks each up. The set (CsrSet) is a table of 4-slot buckets, read by
// one 16-byte load a lookup, behind a filter word a bucket that turns
// away most ids the set lacks with one 4-byte load. On that bucket, L2
// flushed: a linear-probing table alone took 5.5 ms, with a filter 4.7,
// with buckets 4.0, without the per-id range test 3.5, with one hash for
// bucket and filter 3.4; the buckets without the filter 3.7, and an exact
// bitmap of all n ids shared by a block (runs are short: its syncs and
// idle warps) 5.9. The time goes to instructions a looked-up id, and to
// the warp waiting for its longest probe chain. A row stops once every
// lane's ids pass the largest id of N+(src).
// The grid is persistent; warp g takes the batches g, g + G, ... of 32
// rows (fewer where 32 would leave warps idle); a batch's endpoints are
// read two batches ahead and their CSR offsets one batch ahead, a lane a
// row, and its counts are written by one coalesced store. A set longer
// than the table (W past kCsrMaxSlots / 2) is built and probed in pieces,
// and none is kept across rows.
// ---------------------------------------------------------------------------

constexpr int kCsrUnroll = 4;        // N+(dst) ids a lane loads at once
constexpr int kCsrMaxSlots = 4096;   // a warp's table, at most (16 KB)
constexpr int kCsrEmpty = -1;        // a free slot (ids are >= 0)

// log2 of the slots a set of len ids takes: at least twice len, at least
// 32 (8 buckets), a power of two.
__host__ __device__ __forceinline__ int csr_table_bits(long long len) {
  int bits = 5;
  while ((1LL << bits) < 2 * len) ++bits;
  return bits;
}

// Ints a warp's table and filter take for tables of up to 2^bits slots:
// the slots, and a filter word a 4-slot bucket.
__host__ __device__ __forceinline__ int csr_warp_ints(int bits) {
  return (1 << bits) + (1 << (bits - 2));
}

// A warp's set of N+(src) ids: a table of 2^bits slots in buckets of 4,
// each filled from its first slot, a full bucket spilling into the next;
// and in front of it a filter word a bucket, in which each id sets one bit,
// so that most lookups of ids the set lacks end at one load. One hash of
// the id picks both its home bucket (top bits) and its filter bit (the
// next five).
struct CsrSet {
  int* table;
  unsigned* filter;
  int bits;

  __device__ __forceinline__ unsigned hash(int x) const {
    return static_cast<unsigned>(x) * 0x9E3779B1u;
  }
  __device__ __forceinline__ unsigned bucket(unsigned h) const {
    return h >> (34 - bits);
  }
  __device__ __forceinline__ unsigned flag(unsigned h) const {
    return 1u << (h >> (29 - bits) & 31u);
  }
};

// The warp's 32 lanes clear the set's slots and filter words.
__device__ __forceinline__ void csr_clear(const CsrSet& set, int lane) {
  for (int i = lane; i < (1 << set.bits); i += 32) set.table[i] = kCsrEmpty;
  for (int i = lane; i < (1 << (set.bits - 2)); i += 32) set.filter[i] = 0u;
}

// The warp's 32 lanes add the len ids at g to the cleared set.
__device__ __forceinline__ void csr_build(const CsrSet& set,
                                          const int* __restrict__ g, int len,
                                          int lane) {
  const unsigned mask = (1u << (set.bits - 2)) - 1u;  // buckets
  for (int i0 = 0; i0 < len; i0 += 32 * kCsrUnroll) {
    int x[kCsrUnroll];
#pragma unroll
    for (int j = 0; j < kCsrUnroll; ++j) {
      const int i = i0 + j * 32 + lane;
      x[j] = i < len ? g[i] : kCsrEmpty;
    }
#pragma unroll
    for (int j = 0; j < kCsrUnroll; ++j) {
      if (x[j] == kCsrEmpty) continue;
      const unsigned h = set.hash(x[j]);
      atomicOr(set.filter + set.bucket(h), set.flag(h));
      for (unsigned b = set.bucket(h);; b = (b + 1u) & mask) {
        int k = 0;
        while (k < 4 && atomicCAS(set.table + 4 * b + k, kCsrEmpty, x[j]) !=
                            kCsrEmpty)
          ++k;
        if (k < 4) break;
      }
    }
  }
}

// This lane's count of the len sorted ids at g that the set holds; hi is
// the set's largest id.
__device__ __forceinline__ int csr_probe(const CsrSet& set,
                                         const int* __restrict__ g, int len,
                                         int hi, int lane) {
  const unsigned mask = (1u << (set.bits - 2)) - 1u;  // buckets
  const int4* buckets = reinterpret_cast<const int4*>(set.table);
  int cnt = 0;
  for (int i0 = 0; i0 < len; i0 += 32 * kCsrUnroll) {
    int x[kCsrUnroll];
#pragma unroll
    for (int j = 0; j < kCsrUnroll; ++j) {
      const int i = i0 + j * 32 + lane;
      x[j] = i < len ? g[i] : 0x7fffffff;
    }
    unsigned home[kCsrUnroll];
    unsigned maybe = 0u;  // ids the filter passes
#pragma unroll
    for (int j = 0; j < kCsrUnroll; ++j) {
      const unsigned h = set.hash(x[j]);
      home[j] = set.bucket(h);
      maybe |= static_cast<unsigned>((set.filter[home[j]] & set.flag(h)) != 0u)
               << j;
    }
#pragma unroll
    for (int j = 0; j < kCsrUnroll; ++j) {
      if (!(maybe >> j & 1u)) continue;
      for (unsigned b = home[j];; b = (b + 1u) & mask) {
        const int4 t = buckets[b];
        if (t.x == x[j] || t.y == x[j] || t.z == x[j] || t.w == x[j]) {
          ++cnt;
          break;
        }
        if (t.w == kCsrEmpty) break;  // a free slot: x would be here
      }
    }
    // the ids are sorted: once every lane's last is past hi, so is the rest
    if (__all_sync(0xffffffffu, x[kCsrUnroll - 1] > hi)) break;
  }
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
probe_csr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                 const int* __restrict__ src, const int* __restrict__ dst,
                 int* __restrict__ out, int E, int W, int max_bits,
                 int batch) {
  extern __shared__ __align__(16) int csr_sets[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* base = csr_sets + (size_t)warp * csr_warp_ints(max_bits);
  CsrSet set{base, reinterpret_cast<unsigned*>(base + (1 << max_bits)),
             max_bits};
  csr_clear(set, lane);
  __syncwarp();
  const int nbatch = (E + batch - 1) / batch;
  const int G = gridDim.x * (kThreads / 32);
  const int first = blockIdx.x * (kThreads / 32) + warp;

  // a lane a row: batch ib + 2G's endpoints (s_), ib + G's CSR offsets (r_)
  bool sv = false, rv = false;
  int s_src = 0, s_dst = 0;
  int r_a0 = 0, r_a1 = 0, r_b0 = 0, r_b1 = 0;
  auto fetch = [&](int b) {
    rv = sv;
    if (rv) {
      r_a0 = row_ptr[s_src];
      r_a1 = row_ptr[s_src + 1];
      r_b0 = row_ptr[s_dst];
      r_b1 = row_ptr[s_dst + 1];
    }
    const long long row = (long long)b * batch + lane;
    sv = b < nbatch && lane < batch && row < E;
    if (sv) {
      s_src = __ldcs(src + row);
      s_dst = __ldcs(dst + row);
    }
  };
  fetch(first);
  fetch(first + G);

  int t_a0 = -1;    // the N+(src) the set holds, by its offset in col
  int hi = -1;      // its largest id
  for (int ib = first; ib < nbatch; ib += G) {
    const bool cv = rv;
    const int c_a0 = r_a0, c_lu = min(r_a1 - r_a0, W);
    const int c_b0 = r_b0, c_lv = min(r_b1 - r_b0, W);
    fetch(ib + 2 * G);
    int mine = 0;
    unsigned live = __ballot_sync(0xffffffffu, cv && c_lu > 0 && c_lv > 0);
    while (live) {
      const int bit = __ffs(live) - 1;
      live &= live - 1u;
      const int a0 = __shfl_sync(0xffffffffu, c_a0, bit);
      const int lu = __shfl_sync(0xffffffffu, c_lu, bit);
      const int b0 = __shfl_sync(0xffffffffu, c_b0, bit);
      const int lv = __shfl_sync(0xffffffffu, c_lv, bit);
      int cnt = 0;
      if (lu <= (1 << max_bits) / 2) {
        if (a0 != t_a0) {  // a new run of src: its set replaces the last
          __syncwarp();
          csr_clear(set, lane);
          set.bits = csr_table_bits(lu);
          t_a0 = a0;
          hi = col[a0 + lu - 1];
          __syncwarp();
          csr_build(set, col + a0, lu, lane);
          __syncwarp();
        }
        cnt = csr_probe(set, col + b0, lv, hi, lane);
      } else {  // longer than the table: in pieces, none kept
        const int piece = (1 << max_bits) / 2;
        for (int c = 0; c < lu; c += piece) {
          const int len = min(piece, lu - c);
          __syncwarp();
          csr_clear(set, lane);
          set.bits = max_bits;
          __syncwarp();
          csr_build(set, col + a0 + c, len, lane);
          __syncwarp();
          cnt += csr_probe(set, col + b0, lv, col[a0 + c + len - 1], lane);
        }
        t_a0 = -1;
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == bit) mine = cnt;
    }
    if (cv) __stcs(out + (long long)ib * batch + lane, mine);
  }
}

// ---------------------------------------------------------------------------
// K3 — packed bitmap.
// Replaces repro/kernels/intersect/bitmap.py _bitmap_kernel
// (intersect_counts_bitmap_pallas, body _pack_and_probe). The TPU kernel
// summed first-occurrence bits word by word into (TE, num_bits/32) words.
// The function is kept: each row's count of the u elements, with
// multiplicity, whose id lies in [0, num_bits) and occurs in v.
//
// Bound: bytes (every row is read once; a row costs O(W) shared-memory
// operations, far below its bytes).
//
// Design, against what held the one-bitmap-a-row kernel back (each row
// cleared all num_bits/32 words and passed two block barriers, so a W = 8
// row cleared ~135 words for each id it tested):
// - One bitmap a warp, num_bits/32 words of shared memory (8 KB at the
//   65536 cap), zeroed once at the start of the launch. A warp takes whole
//   rows: it sets v's in-range bits with atomicOr (two lanes can hit one
//   word; OR is idempotent, so duplicates need no first-occurrence pass),
//   __syncwarp, tests u's in-range ids, __syncwarp, clears only the words
//   that v set by walking v again from registers, __syncwarp. A row costs
//   O(W) and no block barrier; the last barrier keeps the clear apart from
//   the next row's set.
// - Lane l holds ids l, l + 32, ... of the row: K a lane, K = ceil(W/32)
//   rounded up to a power of two, at most kBitmapMaxK (8: more registers
//   a thread cost more in occupancy than the chunks below cost in loads).
//   Rows wider than 32 * kBitmapMaxK take further chunks of the row
//   inline; their clear zeroes the whole bitmap where it has at most
//   kClearAllWords words an id of the row (stores are cheaper than reading
//   v again from L2), else walks v again.
// - A persistent grid of kBitmapThreads-thread blocks, sized by occupancy
//   at the launch's shared bytes: warp w takes rows w, w + NW, ... and
//   issues the next row's loads of u and v before the current row's set
//   and test. Ids outside [0, num_bits) are masked, so padding lanes load
//   -1.
// - Ids equal to the row's last id are set and cleared by its last slot
//   alone: the engine's rows end in a run of the padding sentinel, which
//   its n + 2 bits cover, and the run's atomicOr to one word would
//   otherwise be serialized lane by lane.
// ---------------------------------------------------------------------------

constexpr int kBitmapThreads = 128;  // K3: 4 warps, 4 bitmaps a block
constexpr int kBitmapMaxK = 8;       // K3: ids a lane holds, at most
constexpr int kClearAllWords = 4;    // K3: words an id, at most, to clear all

template <int K>
__device__ __forceinline__ void load_ids(const int* __restrict__ p,
                                         long long row, long long E,
                                         long long W, int c0, int lane,
                                         int (&x)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + lane + 32 * k;
    x[k] = row < E && c < W ? __ldg(p + row * W + c) : -1;
  }
}

template <int K>
__global__ void __launch_bounds__(kBitmapThreads)
bitmap_warp_kernel(const int* __restrict__ u, const int* __restrict__ v,
                   int* __restrict__ out, int E, int W, int num_bits) {
  extern __shared__ unsigned int bsmem[];
  constexpr int C = 32 * K;  // ids of a row a lane's registers hold
  const int lane = threadIdx.x & 31;
  const int nwords = num_bits >> 5;
  unsigned int* bits = bsmem + (size_t)(threadIdx.x >> 5) * nwords;
  const unsigned int ubits = static_cast<unsigned int>(num_bits);
  for (int k = lane; k < nwords; k += 32) bits[k] = 0u;
  __syncwarp();
  const long long Wl = W;
  const long long nw = (long long)gridDim.x * (kBitmapThreads / 32);
  const bool wide = W > C;
  const bool clear_all = wide && nwords <= kClearAllWords * W;

  // An id equal to the row's last one is left to the last slot: a sorted
  // row's padding run (in range when num_bits covers the sentinels, as the
  // engine's n + 2 does) would otherwise send all its lanes' atomicOr to
  // one word, one after another.
  int last = -1;
  auto owns = [&](int x, int c) { return x != last || c == W - 1; };
  auto set = [&](int x, int c) {
    if (static_cast<unsigned int>(x) < ubits && owns(x, c))
      atomicOr(&bits[x >> 5], 1u << (x & 31));
  };
  auto test = [&](int x) -> int {
    return static_cast<unsigned int>(x) < ubits ? (bits[x >> 5] >> (x & 31)) & 1u : 0;
  };
  auto clear = [&](int x, int c) {
    if (static_cast<unsigned int>(x) < ubits && owns(x, c)) bits[x >> 5] = 0u;
  };
  auto load_last = [&](long long r) {
    return r < E ? __ldg(v + r * Wl + W - 1) : -1;
  };

  long long row = (long long)blockIdx.x * (kBitmapThreads / 32) + (threadIdx.x >> 5);
  int nu[K], nv[K];
  load_ids<K>(u, row, E, Wl, 0, lane, nu);
  load_ids<K>(v, row, E, Wl, 0, lane, nv);
  int nlast = load_last(row);
  for (; row < E; row += nw) {
    int cu[K], cv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cu[k] = nu[k];
      cv[k] = nv[k];
    }
    load_ids<K>(u, row + nw, E, Wl, 0, lane, nu);  // the next row, ahead
    load_ids<K>(v, row + nw, E, Wl, 0, lane, nv);
    last = nlast;
    nlast = load_last(row + nw);
#pragma unroll
    for (int k = 0; k < K; ++k) set(cv[k], lane + 32 * k);
    for (int c0 = C; c0 < W; c0 += C) {
      int x[K];
      load_ids<K>(v, row, E, Wl, c0, lane, x);
#pragma unroll
      for (int k = 0; k < K; ++k) set(x[k], c0 + lane + 32 * k);
    }
    __syncwarp();
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) cnt += test(cu[k]);
    for (int c0 = C; c0 < W; c0 += C) {
      int x[K];
      load_ids<K>(u, row, E, Wl, c0, lane, x);
#pragma unroll
      for (int k = 0; k < K; ++k) cnt += test(x[k]);
    }
    __syncwarp();
    if (clear_all) {
      for (int k = lane; k < nwords; k += 32) bits[k] = 0u;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) clear(cv[k], lane + 32 * k);
      for (int c0 = C; c0 < W; c0 += C) {
        int x[K];
        load_ids<K>(v, row, E, Wl, c0, lane, x);
#pragma unroll
        for (int k = 0; k < K; ++k) clear(x[k], c0 + lane + 32 * k);
      }
    }
    __syncwarp();
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) out[row] = cnt;
  }
}

// K1's slab route: blocks of `rows` rows that cover E rows.
inline unsigned int blocks_for(int E, int rows) {
  return (unsigned int)((E + (long long)rows - 1) / rows);
}

// Launch facts of the persistent kernels (K1's register route, K2, K3),
// asked of the CUDA runtime once and kept: a device's SM count and opt-in
// shared-memory cap (on first sight of a device, K2's and K3's dynamic
// shared-memory limit is raised to that cap, before any launch there), and
// the blocks an SM holds for each (device, kernel, shared bytes). A launch
// then makes no runtime query but cudaGetDevice.
struct DeviceFacts {
  int sms = 0;
  int optin = 0;
};

struct Occupancy {
  int dev;
  const void* fn;
  size_t smem;
  int per_sm;
};

using ProbeKernel = void (*)(const int*, const int*, int*, int, int, int,
                             int);
using BroadcastKernel = void (*)(const int*, const int*, int*, int, int);
using BitmapKernel = void (*)(const int*, const int*, int*, int, int, int);

inline ProbeKernel probe_kernel(bool staged) {
  return staged ? probe_merge_kernel<true> : probe_merge_kernel<false>;
}

template <bool kVec16>
inline BroadcastKernel broadcast_reg_for(int groups) {
  switch (groups) {
    case 1: return broadcast_reg_kernel<1, kVec16>;
    case 2: return broadcast_reg_kernel<2, kVec16>;
    case 4: return broadcast_reg_kernel<4, kVec16>;
    case 8: return broadcast_reg_kernel<8, kVec16>;
    default: return broadcast_reg_kernel<16, kVec16>;
  }
}

// K1's register route for W < kRegMaxWidth: groups of ceil(W/4) lanes,
// rounded up to a power of two.
inline int reg_groups(int W) {
  int groups = 1;
  while (groups * 4 < W) groups <<= 1;
  return groups;
}

// K3's instances, K = 1, 2, 4, ..., kBitmapMaxK.
const BitmapKernel kBitmapKernels[] = {
    bitmap_warp_kernel<1>, bitmap_warp_kernel<2>, bitmap_warp_kernel<4>,
    bitmap_warp_kernel<kBitmapMaxK>};
static_assert(kBitmapMaxK == 8, "kBitmapKernels lists K = 1 ... kBitmapMaxK");

// K3's instance: K = ceil(W/32) ids a lane, rounded up to a power of two,
// at most kBitmapMaxK.
inline BitmapKernel bitmap_kernel(int W) {
  int i = 0;
  while ((32 << i) < W && (1 << i) < kBitmapMaxK) ++i;
  return kBitmapKernels[i];
}

constexpr int kDevices = 64;      // devices whose facts are kept
constexpr int kOccupancies = 64;  // (device, kernel, bytes) kept

std::mutex facts_mu;
DeviceFacts devices[kDevices];
Occupancy occupancies[kOccupancies];
int occupancy_count = 0;

cudaError_t device_facts(int dev, DeviceFacts* out) {
  std::lock_guard<std::mutex> lock(facts_mu);
  const bool kept = dev >= 0 && dev < kDevices;
  if (kept && devices[dev].sms > 0) {
    *out = devices[dev];
    return cudaSuccess;
  }
  DeviceFacts d;
  cudaError_t err =
      cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  auto optin = [&](const void* fn) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 d.optin);
  };
  optin(reinterpret_cast<const void*>(probe_kernel(true)));
  optin(reinterpret_cast<const void*>(probe_kernel(false)));
  optin(reinterpret_cast<const void*>(probe_csr_kernel));
  for (const BitmapKernel fn : kBitmapKernels)
    optin(reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return err;
  if (kept) devices[dev] = d;
  *out = d;
  return cudaSuccess;
}

cudaError_t blocks_per_sm(int dev, const void* fn, int threads, size_t smem,
                          int* per_sm) {
  std::lock_guard<std::mutex> lock(facts_mu);
  for (int i = 0; i < occupancy_count; ++i) {
    const Occupancy& o = occupancies[i];
    if (o.dev == dev && o.fn == fn && o.smem == smem) {
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, smem);
  if (err == cudaSuccess && occupancy_count < kOccupancies)
    occupancies[occupancy_count++] = {dev, fn, smem, *per_sm};
  return err;
}

cudaError_t current_device(int* dev, DeviceFacts* d) {
  const cudaError_t err = cudaGetDevice(dev);
  return err == cudaSuccess ? device_facts(*dev, d) : err;
}

// A persistent grid: as many blocks of `threads` as an SM of device `dev`
// holds of `fn` at `smem` shared bytes, times the SMs, but no more than
// `wanted`.
cudaError_t persistent_grid(int dev, const DeviceFacts& d, const void* fn,
                            int threads, size_t smem, long long wanted,
                            unsigned int* grid) {
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm(dev, fn, threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * d.sms;
  *grid = (unsigned int)(wanted < resident ? wanted : resident);
  return cudaSuccess;
}

inline bool aligned16(const int* u, const int* v) {
  return ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(v)) & 15) == 0;
}

}  // namespace

extern "C" {

int tc_broadcast_counts(const int* u, const int* v, int* out, int E, int W,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W >= kRegMaxWidth) {  // forced broadcast on wide rows: the slab kernel
    const Tiling t = tiling_for(W);
    broadcast_counts_kernel<<<blocks_for(E, t.rows), kThreads, 0, st>>>(
        u, v, out, E, W, t.rows, t.tpr);
    return static_cast<int>(cudaGetLastError());
  }
  const int groups = reg_groups(W);
  const BroadcastKernel kernel =
      W % 4 == 0 && aligned16(u, v) ? broadcast_reg_for<true>(groups)
                                    : broadcast_reg_for<false>(groups);
  const long long tiles = (E + 32LL / groups - 1) / (32 / groups);
  int dev = 0;
  DeviceFacts d;
  unsigned int grid = 0;
  cudaError_t err = current_device(&dev, &d);
  if (err == cudaSuccess)
    err = persistent_grid(dev, d, reinterpret_cast<const void*>(kernel),
                          kThreads, 0, (tiles + kThreads / 32 - 1) / (kThreads / 32),
                          &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, 0, st>>>(u, v, out, E, W);
  return static_cast<int>(cudaGetLastError());
}

int tc_probe_counts(const int* u, const int* v, int* out, int E, int W,
                    void* stream) {
  int tw = 1;  // warps a team: a lane merges at most ~kProbeMaxSteps elements
  while (tw < kThreads / 32 && 2LL * W > (long long)tw * 32 * kProbeMaxSteps)
    tw <<= 1;
  const int teams = kThreads / 32 / tw;
  int dev = 0;
  DeviceFacts d;
  cudaError_t err = current_device(&dev, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t base = sizeof(int) * kProbePartials;
  const size_t ring = sizeof(int) * (size_t)teams * kProbeStages * 2 * W;
  const bool staged = base + ring <= (size_t)d.optin;
  const size_t smem = staged ? base + ring : base;
  const int vec16 = W % 4 == 0 && aligned16(u, v);
  const ProbeKernel kernel = probe_kernel(staged);
  const long long batches = (E + (long long)kProbeBatch - 1) / kProbeBatch;
  unsigned int grid = 0;
  err = persistent_grid(dev, d, reinterpret_cast<const void*>(kernel), kThreads,
                        smem, (batches + teams - 1) / teams, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, out, E, W, tw, vec16);
  return static_cast<int>(cudaGetLastError());
}

// K2 on the forward CSR: out[e] = |N+(src[e]) ∩ N+(dst[e])| for the E rows
// of a bucket of width W, each row read from col at
// [row_ptr[x], row_ptr[x + 1]), at most W ids.
int tc_probe_csr_counts(const int* row_ptr, const int* col, const int* src,
                        const int* dst, int* out, int E, int W,
                        void* stream) {
  // a warp's table: 2W slots, at most kCsrMaxSlots
  const int max_bits = csr_table_bits(std::min(W, kCsrMaxSlots / 2));
  const size_t smem = sizeof(int) * (kThreads / 32) * csr_warp_ints(max_bits);
  const void* fn = reinterpret_cast<const void*>(probe_csr_kernel);
  int dev = 0, per_sm = 0;
  DeviceFacts d;
  cudaError_t err = current_device(&dev, &d);
  if (err == cudaSuccess)
    err = blocks_per_sm(dev, fn, kThreads, smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rows a warp takes at once: 32, or fewer where that leaves warps idle
  const long long warps = (long long)(per_sm > 0 ? per_sm : 1) * d.sms *
                          (kThreads / 32);
  const int batch = (int)std::min<long long>(
      kProbeBatch, std::max<long long>(1, (E + warps - 1) / warps));
  const long long batches = (E + (long long)batch - 1) / batch;
  unsigned int grid = 0;
  err = persistent_grid(dev, d, fn, kThreads, smem,
                        (batches + kThreads / 32 - 1) / (kThreads / 32),
                        &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  probe_csr_kernel<<<grid, kThreads, smem, st>>>(row_ptr, col, src, dst, out,
                                                 E, W, max_bits, batch);
  return static_cast<int>(cudaGetLastError());
}

int tc_bitmap_counts(const int* u, const int* v, int* out, int E, int W,
                     int num_bits, void* stream) {
  constexpr int warps = kBitmapThreads / 32;
  const size_t smem = sizeof(unsigned int) * (size_t)warps * (num_bits >> 5);
  const BitmapKernel kernel = bitmap_kernel(W);
  int dev = 0;
  DeviceFacts d;
  unsigned int grid = 0;
  cudaError_t err = current_device(&dev, &d);
  if (err == cudaSuccess)
    err = persistent_grid(dev, d, reinterpret_cast<const void*>(kernel),
                          kBitmapThreads, smem,
                          (E + (long long)warps - 1) / warps, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBitmapThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, out, E, W, num_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
