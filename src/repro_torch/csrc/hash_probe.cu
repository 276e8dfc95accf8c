// Per-vertex hash-table probe for the TRUST-style hash lane (K5), sm_90a.
//
// Replaces repro/kernels/hash_tc/probe.py _hash_probe_kernel
// (hash_probe_counts_pallas). For every row e of a bucket it counts the
// candidates w of w_lists[e] found in the anchor's hash row table[src[e]]:
//
//     out[e] = #{ j : 0 <= w < n and any_d table[u, w & (B-1), d] == w },
//     w = w_lists[e, j], u = clamp(src[e], 0, n - 1)
//
// over an (E, W) int32 candidate array (in-row sentinel n + 1, whole padding
// rows -2), an (E,) int32 anchor array and an (n, B, D) int32 table whose
// empty slots hold -1. A candidate counts once if any of its bucket's D
// slots equals it. Out-of-range candidates (the sentinels, negative padding)
// probe nothing and read nothing.
//
// What the TPU kernel did and why it does not carry over: it kept the whole
// flattened table in VMEM (about 8 MB at n = 8192) and gathered each row's
// (B, D) slice in registers. On the R-MAT scale-17 path the table is
// (131072, 512, 64) int32, 16 GiB, and one anchor's (B, D) slice is 128 KB
// (256 KB at D = 128, past the 227 KB a block can use), so here the table
// stays in HBM and no slice is staged in shared memory.
//
// Bound: the function must read w_lists and src once, write the (E,)
// counts, and read the (B * D * 4)-byte table rows of the distinct anchors
// of its real rows; its compares are (valid probes) * D at the card's
// 32-bit rate. On the scale-17 path the bytes term decides (about 4.9 GB of
// candidates plus up to 16 GiB of table rows at 3.35 TB/s, against
// 1.6e10 compares at 67 T/s).
//
// Design: one warp per row, eight rows per 256-thread block. The lanes
// stride over the row's W candidates (coalesced reads of w_lists); each
// lane reads its candidate's D slots at ((int64)u * B + (w & (B-1))) * D
// from global memory, as 16-byte loads when D % 4 == 0 and the table is
// 16-byte aligned, and stops at the first slot that matches. The warp sums
// its hits with __reduce_add_sync and lane 0 stores the row's count: no
// atomics, no padding of E. Rows of a bucket come in src order, so
// consecutive rows share an anchor and the 50 MB L2 serves most repeated
// table reads. Table offsets are 64-bit: the scale-17 table has 2^32
// elements.
//
// Later work: stopping a chain at its first empty slot (sound only for
// tables made by build_hash_table), staging the anchor's rows in shared
// memory, and a compact table.
//
// The C interface takes raw device pointers, ints and a cudaStream_t passed
// as void*, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int* __restrict__ w_lists, const int* __restrict__ src,
                  const int* __restrict__ table, int* __restrict__ out,
                  int E, int W, int n, int B, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= E) return;  // whole warps leave together

  int u = src[row];
  u = u < 0 ? 0 : (u >= n ? n - 1 : u);
  const int* trow = table + (int64_t)u * B * D;
  const int* wrow = w_lists + row * W;
  const int mask = B - 1;

  int hits = 0;
  for (int j = lane; j < W; j += 32) {
    const int w = wrow[j];
    if (w < 0 || w >= n) continue;
    const int* slot = trow + (int64_t)(w & mask) * D;
    bool hit = false;
    if (kVec4) {
      const int4* s4 = reinterpret_cast<const int4*>(slot);
      for (int d = 0; d < D / 4; ++d) {
        const int4 q = s4[d];
        if (q.x == w || q.y == w || q.z == w || q.w == w) {
          hit = true;
          break;
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        if (slot[d] == w) {
          hit = true;
          break;
        }
      }
    }
    hits += hit ? 1 : 0;
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0) out[row] = hits;
}

}  // namespace

extern "C" int tc_hash_probe_counts(const int* w_lists, const int* src,
                                    const int* table, int* out, int E, int W,
                                    int n, int B, int D, void* stream) {
  if (E <= 0) return 0;
  if (n <= 0 || W < 0 || D < 0 || B < 1 || (B & (B - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      (unsigned)(((int64_t)E + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool vec4 = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(table) & 15) == 0);
  if (vec4)
    hash_probe_kernel<true><<<blocks, kThreads, 0, s>>>(w_lists, src, table,
                                                        out, E, W, n, B, D);
  else
    hash_probe_kernel<false><<<blocks, kThreads, 0, s>>>(w_lists, src, table,
                                                         out, E, W, n, B, D);
  return (int)cudaGetLastError();
}
