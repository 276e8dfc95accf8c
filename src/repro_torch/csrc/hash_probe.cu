// Per-vertex hash-table probe for the TRUST-style hash lane (K5), sm_90a,
// over a compact table of chains.
//
// Replaces repro/kernels/hash_tc/probe.py:91 _hash_probe_kernel
// (hash_probe_counts_pallas). For every row e of a bucket it counts the
// candidates w of w_lists[e] before row_end[e] found in their chain of the
// anchor u = clamp(src[e], 0, n - 1):
//
//     out[e] = #{ j < row_end[e] : 0 <= w < n and w in chain(u, w & (B-1)) },
//     w = w_lists[e, j],
//     chain(u, b) = chain_vals[chain_ptr[u*B + b] : chain_ptr[u*B + b + 1]]
//
// over an (E, W) int32 candidate array (in-row sentinel n + 1, whole
// padding rows -2), (E,) int32 anchors and row ends, (n*B + 1,) int32
// chain offsets and (nnz,) int32 chain ids. A candidate counts once if any
// id of its chain equals it. The reference's dense (n, B, D) table holds
// the same chains padded to the longest one; the wrappers compact it.
//
// What the TPU kernel did and why it does not carry over: it kept the whole
// flattened dense table in VMEM (about 8 MB at n = 8192) and gathered each
// row's (B, D) slice in registers. On the R-MAT scale-17 path that table is
// (131072, 512, 64) int32, 16 GiB, for 1,864,319 ids: R-MAT ids cluster in
// their low bits, so a few chains are long (51) and almost all are empty.
//
// Bound: bytes. The function must read each row's candidates up to its row
// end (about a fifth of the padded arrays on that path), each row's anchor
// and row end, and the offsets and ids of the chains its valid probes
// name; it writes the (E,) counts. The compares (up to a chain's first
// match, else its length) are far below the bytes at the card's 32-bit
// rate. What holds the kernel back on the card is neither: it is the
// instructions a warp issues while its lanes walk chains of different
// lengths (each step waits for the lane with the longest chain).
//
// Design:
// - One warp owns a contiguous slice of rows (64, or down to 8 in small
//   buckets, so that they still spread over every SM). Rows of a bucket
//   come in src order, so neighbouring rows share an anchor (about 8 to 17
//   a run on the scale-17 path). When the anchor changes the warp stages
//   its chains in shared memory: each chain's local bounds packed in one
//   word (start in the low, end in the high 16 bits; B words) and its ids
//   (2 KB + at most 2 KB at B = 512, in the warp's `cap` ints). A valid
//   probe then costs one shared-memory read for its bounds and reads its
//   chain four ids at a time (four independent loads, one latency), and
//   stops at the first match.
// - Global route: an anchor whose bounds and ids exceed `cap` (every
//   anchor from B = 2048 on; one with more ids than B, as in a compacted
//   dense table), or whose run of rows in the batch has fewer candidate
//   slots than B / 8 (staging all B bounds would read more sectors than
//   its probes name), is probed by the same loop through chain_ptr and
//   chain_vals where they lie.
// - Candidates are read only up to the row end, 128 at a time: lane l takes
//   j0 + l, + 32, + 64, + 96 (coalesced 4-byte loads, any alignment), so a
//   short row spreads over all 32 lanes, at most ceil(end / 32) candidates a
//   lane. The warp's next chunk (of this row or the next) is loaded into
//   registers while it probes this one.
// - A batch of 32 rows' anchors and row ends is read a lane a row, one
//   batch ahead; a row with row end 0 (every whole padding row) gets its 0
//   at once and reads nothing more.
// - No atomics: a row's hits are summed by __reduce_add_sync and one lane
//   stores them. Offsets into chain_ptr are 64-bit (u*B passes 2^31 when
//   n*B does); chain_ptr values (< nnz) fit int32, as the builder checks.
// - 64 registers a thread at most (4 blocks, 32 warps an SM): the chain
//   walk is latency-bound, and more warps hide more of it (at 48 registers,
//   5 blocks, the W = 128 buckets ran slower).
//
// The C interface takes raw device pointers, ints and a cudaStream_t passed
// as void*, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;     // 32 warps an SM: at most 64 registers
constexpr int kBatch = 32;        // rows whose anchors and ends a warp reads at once
constexpr int kSliceRows = 64;    // contiguous rows a warp owns, at most
constexpr int kChunk = 128;       // candidates a warp reads at once, 4 a lane
constexpr int kRunLong = 1 << 30; // a run that reaches past its batch
// about two waves of 132 SMs' resident warps: small buckets take slices of
// fewer rows, down to 8, so that they still spread over every SM
constexpr long long kTargetWarps = 8192;
// staged ints a warp, at most: with the 4 ints of padding past the last
// warp's room a block takes at most 48 KB (8 warps * 1535 + 4 ints), the
// limit without opt-in, and 4 blocks fit an SM at the cap
constexpr int kCapMax = (48 * 1024 / 4 - 4) / kWarps;

struct Item {
  long long row;  // row index, -1 when the slice is done
  int u;          // its anchor, clamped into [0, n)
  int end;        // its row end, clamped into [1, W]
  int j0;         // the chunk's first candidate
  int run;        // candidate slots of its run of rows that share the
                  // anchor, within its batch (kRunLong past the batch)
};

// This lane's four candidates of the chunk at j0 of a row (j0 + lane, + 32,
// + 64, + 96), -1 past the end.
__device__ __forceinline__ int4 load_chunk(const int* __restrict__ wrow,
                                           int j0, int end, int lane) {
  const int j = j0 + lane;
  int4 c = make_int4(-1, -1, -1, -1);
  if (j < end) c.x = __ldg(wrow + j);
  if (j + 32 < end) c.y = __ldg(wrow + j + 32);
  if (j + 64 < end) c.z = __ldg(wrow + j + 64);
  if (j + 96 < end) c.w = __ldg(wrow + j + 96);
  return c;
}

// 1 if x is a valid probe found in its chain. Staged (kShared): bnd[b]
// packs chain b's local bounds (start in the low, end in the high 16 bits)
// and ids holds the anchor's ids. Global: bnd is the anchor's B + 1 offsets
// into ids, the whole chain_vals. The chain is read four ids a step.
template <bool kShared>
__device__ __forceinline__ int probe1(int x, const int* bnd, const int* ids,
                                      int n, int mask) {
  if ((unsigned)x >= (unsigned)n) return 0;
  const int b = x & mask;
  int lo, hi;
  if (kShared) {
    const unsigned w = (unsigned)bnd[b];
    lo = (int)(w & 0xffffu);
    hi = (int)(w >> 16);
  } else {
    lo = __ldg(bnd + b);
    hi = __ldg(bnd + b + 1);
  }
  for (; lo < hi; lo += 4) {
    int a[4];
    if (kShared) {
      // the loads are not bounded: up to 3 ids past the chain are read (the
      // next chain's, another warp's room, or the 4 ints of padding past the
      // last warp's) and masked out of the compare instead
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = ids[lo + j];
      if ((a[0] == x) | (lo + 1 < hi && a[1] == x) |
          (lo + 2 < hi && a[2] == x) | (lo + 3 < hi && a[3] == x))
        return 1;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = lo + j < hi ? __ldg(ids + lo + j) : ~x;
      if (a[0] == x || a[1] == x || a[2] == x || a[3] == x) return 1;
    }
  }
  return 0;
}

// The hits among a lane's four candidates, walked one after another: a
// warp's step then waits for the longest of 32 chains, not of 128.
template <bool kShared>
__device__ __forceinline__ int probe4(const int4 c, const int* bnd,
                                      const int* ids, int n, int mask) {
  return probe1<kShared>(c.x, bnd, ids, n, mask) +
         probe1<kShared>(c.y, bnd, ids, n, mask) +
         probe1<kShared>(c.z, bnd, ids, n, mask) +
         probe1<kShared>(c.w, bnd, ids, n, mask);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
hash_probe_compact_kernel(const int* __restrict__ w_lists,
                          const int* __restrict__ src,
                          const int* __restrict__ row_end,
                          const int* __restrict__ chain_ptr,
                          const int* __restrict__ chain_vals,
                          int* __restrict__ out, int E, int W, int n, int B,
                          int slice, int cap) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 =
      ((long long)blockIdx.x * kWarps + warp) * (long long)slice;
  if (r0 >= E) return;  // whole warps leave together
  const long long r1 = r0 + slice < E ? r0 + slice : E;
  const int nbatch = (int)((r1 - r0 + kBatch - 1) / kBatch);
  int* s_bnd = smem + warp * cap;  // B packed chain bounds, then the ids
  int* s_ids = s_bnd + B;
  const int mask = B - 1;
  const long long Wl = W;

  // The cursor: batch bi, its live rows not yet started, and this lane's
  // (anchor, end) of batch bi and of batch bi + 1.
  int bi = -1;
  unsigned live = 0u;
  int m_src = 0, m_end = 0, p_src = 0, p_end = 0;
  auto load_meta = [&](int b, int& s, int& e) {
    const long long row = r0 + (long long)b * kBatch + lane;
    s = 0;
    e = 0;
    if (b < nbatch && row < r1) {
      s = src[row];
      e = row_end[row];
      e = e < 0 ? 0 : (e > W ? W : e);
    }
  };
  load_meta(0, p_src, p_end);
  auto next_item = [&](Item& it) {
    if (it.row >= 0 && it.j0 + kChunk < it.end) {
      it.j0 += kChunk;
      return;
    }
    while (live == 0u) {
      if (++bi >= nbatch) {
        it.row = -1;
        return;
      }
      m_src = p_src;
      m_end = p_end;
      load_meta(bi + 1, p_src, p_end);
      const long long row = r0 + (long long)bi * kBatch + lane;
      live = __ballot_sync(0xffffffffu, m_end > 0);
      if (row < r1 && m_end == 0) out[row] = 0;
    }
    const int bit = __ffs(live) - 1;
    live &= live - 1u;
    const int s = __shfl_sync(0xffffffffu, m_src, bit);
    // the rows from this one on that share its anchor, and their slots
    const unsigned other =
        ~__ballot_sync(0xffffffffu, m_src == s) & (0xffffffffu << bit);
    const int stop = other ? __ffs(other) - 1 : 32;
    const int slots = __reduce_add_sync(
        0xffffffffu, lane >= bit && lane < stop ? m_end : 0);
    it.row = r0 + (long long)bi * kBatch + bit;
    it.u = s < 0 ? 0 : (s >= n ? n - 1 : s);
    it.end = __shfl_sync(0xffffffffu, m_end, bit);
    it.j0 = 0;
    it.run = stop == 32 && bi + 1 < nbatch ? kRunLong : slots;
  };

  Item cur;
  cur.row = -1;
  next_item(cur);
  if (cur.row < 0) return;
  int4 cc = load_chunk(w_lists + cur.row * Wl, 0, cur.end, lane);
  int staged_u = -1;  // the anchor whose chains the warp reads now
  bool staged = false;
  int hits = 0;
  for (;;) {
    Item nxt = cur;
    next_item(nxt);
    int4 nc = make_int4(-1, -1, -1, -1);
    if (nxt.row >= 0)  // in flight while this chunk probes
      nc = load_chunk(w_lists + nxt.row * Wl, nxt.j0, nxt.end, lane);
    if (cur.u != staged_u) {
      const int* gp = chain_ptr + (long long)cur.u * B;
      const int base = __ldg(gp);
      const int deg = __ldg(gp + B) - base;
      // stage when it fits and the run reads enough of the B + 1 offsets
      // to pay for copying them all (a probe's offsets are a sector)
      staged = (long long)B + deg <= cap && cur.run >= B / 8;
      staged_u = cur.u;
      if (staged) {
        __syncwarp();  // every lane is done with the previous anchor
        for (int i = lane; i < B; i += 32)
          s_bnd[i] = (__ldg(gp + i) - base) | ((__ldg(gp + i + 1) - base) << 16);
        for (int k = lane; k < deg; k += 32)
          s_ids[k] = __ldg(chain_vals + base + k);
        __syncwarp();
      }
    }
    if (staged) {
      hits += probe4<true>(cc, s_bnd, s_ids, n, mask);
    } else {
      hits += probe4<false>(cc, chain_ptr + (long long)cur.u * B, chain_vals,
                            n, mask);
    }
    if (nxt.row != cur.row) {
      hits = __reduce_add_sync(0xffffffffu, hits);
      if (lane == 0) out[cur.row] = hits;
      hits = 0;
    }
    if (nxt.row < 0) break;
    cur = nxt;
    cc = nc;
  }
}

}  // namespace

extern "C" int tc_hash_probe_compact(const int* w_lists, const int* src,
                                     const int* row_end, const int* chain_ptr,
                                     const int* chain_vals, int* out, int E,
                                     int W, int n, int B, void* stream) {
  if (E <= 0) return 0;
  if (n <= 0 || W < 0 || B < 1 || (B & (B - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // a warp's staging room: B packed bounds and as many ids as B (a full row
  // at load factor 1), at most kCapMax
  long long want = 2LL * B;
  const int cap = (int)(want < kCapMax ? want : kCapMax);
  const size_t smem = sizeof(int) * ((size_t)kWarps * cap + 4);
  long long slice = ((long long)E + kTargetWarps - 1) / kTargetWarps;
  slice = slice < 8 ? 8 : (slice > kSliceRows ? kSliceRows : slice);
  const long long slices = ((long long)E + slice - 1) / slice;
  const unsigned blocks = (unsigned)((slices + kWarps - 1) / kWarps);
  hash_probe_compact_kernel<<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      w_lists, src, row_end, chain_ptr, chain_vals, out, E, W, n, B,
      (int)slice, cap);
  return (int)cudaGetLastError();
}
