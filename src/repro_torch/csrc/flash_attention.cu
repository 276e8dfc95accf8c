// Forward flash attention (K6), sm_90a.
//
// Replaces repro/kernels/flash_attention/flash_attention.py _flash_kernel
// (flash_attention_pallas). It computes what flash_attention_ref computes:
//
//     out[b, s, h] = sum_t softmax_t(L[b, s, h, t]) * v[b, t, h / G]
//     L = mask(softcap((q[b, s, h] . k[b, t, h / G]) * scale))
//
// for q (B, S, Hq, hd) against k, v (B, T, Hkv, hd), G = Hq / Hkv (q head h
// reads kv head h / G: contiguous groups); the output is in q's type.
// softcap(x) = tanh(x / cap) * cap when cap is given. The mask is the TPU
// kernel's, widened by a bidirectional prefix: key t is valid for query s
// when ((!causal || s - t >= 0) && s - t < window) || t < prefix (the VLM's
// image tokens, which every query sees; prefix = 0 is the TPU kernel's
// mask exactly, and prefix <= T); masked logits are the finite -1e30 and
// the running max starts at -1e30, as in the TPU kernel, so a tile whose
// keys are all masked for a row adds p = 1 entries that the first valid
// key's alpha = exp(-1e30 - m) = 0 wipes exactly, and a row with no valid
// key at all averages v over all T keys, as the materialised softmax does. Keys past T
// (the ragged tail of the last tile) take -INFINITY: they never count. The
// output is acc / max(l, 1e-30).
//
// What bounds it: the operations. At the serving path's shapes (B = 2,
// S = T = 6144, 8 q heads over 4 kv heads, hd = 256, bf16) a global layer has
// 2 * 8 * 18.9M unmasked (query, key) pairs at 4 * hd flops each, 0.31
// TFLOP: 0.31 ms at the bf16 tensor-core rate (989 TFLOP/s), 4.6 ms at the
// fp32 CUDA-core rate (67 TFLOP/s), against 0.05 ms to read q, k, v once and
// write the output. At whisper-medium's head dim 64 (16/16 heads, batch 4)
// the encoder (1500 x 1500, not causal) is bound by its operations too
// (0.037 ms), while the cross-attention (64 queries over the 1500 encoder
// frames) and a decode step's one-query cross-attention are bound by their
// bytes (0.0076 and 0.0073 ms to read K and V): 64 (batch, head) pairs of
// at most 64 rows, which one block each would spread over 64 of the 132 SMs.
//
// Two kernels, chosen by the input type, with no fallback between them:
//
// * bf16 and fp16: flash_fwd_wgmma_kernel, on the tensor cores. A block of
//   one producer warpgroup and up to three consumer warpgroups owns 64 x
//   (consumers) (query, head) rows of one (batch, kv head): row r is the
//   pair (r / G, r % G) of the S * G rows, so the G q heads that share a kv
//   head share every K/V tile. One producer thread streams K and V through
//   a ring of key tiles by TMA (4-d tensor maps over (hd, Hkv, T, B),
//   128-byte swizzle, so a 128- or 256-wide head loads as 64-column slabs;
//   keys past T arrive as zeros), signalled by mbarriers. Each consumer
//   warpgroup takes 64 rows; it stages its Q rows once with 16-byte loads
//   into the same swizzled layout (any G, a ragged S), then per tile: S =
//   Q K^T by wgmma m64n<keys>k16 (fp32 accumulators); scale, softcap (the
//   precise tanhf), mask and the online softmax in fp32 registers (a row's
//   four threads combine max over shuffles; the -1e30 sentinel gives x - m
//   = 0, never -inf - -inf); P rounded once to q's type in registers,
//   where the S accumulator's layout is the A-register layout of the next
//   product, so P never touches shared memory; O = O * alpha + P V by wgmma
//   m64n<hd>k16 with V read as an MN-major B (the transpose bit). The one
//   rounding beyond the fp32 arithmetic is P to bf16 (fp16), which the TPU
//   kernel's default-precision dot also makes. The plan of each head dim
//   (struct Plan below) is a compile-time choice:
//   - hd 256 (PR 16, unchanged): 2 consumers (128 rows), 64-key tiles, a
//     2-stage ring, each tile's Q K^T, softmax and P V in turn; Q 64 KB +
//     K 2 x 32 KB + V 2 x 32 KB = 192 KB, one block an SM, consumers at 240
//     registers (setmaxnreg) for the (64, 256) fp32 O, the producer at 24.
//   - hd 128: 3 consumers (192 rows), 64-key tiles, a 4-stage ring
//     (176 KB), consumers at 160 registers.
//   - hd 64: 3 consumers (192 rows, 12 consumer warps an SM), 128-key
//     tiles, a 3-stage ring (120 KB), consumers at 160 registers.
//   Both overlap the softmax with the tensor cores: tile i + 1's Q K^T and
//   tile i's P V are issued together, the softmax of tile i + 1 runs while
//   P V is in flight, and O takes its rescale after (wgmma.wait_group 1,
//   then 0); and the consumer warpgroups issue their products in turn
//   (named barriers), so that one's softmax runs under the next one's
//   products. At hd 64 a tile's Q K^T is 4 k16 steps against its softmax
//   (an exp2 a logit on the 16-a-clock MUFU, as many cycles as the two
//   products), so the softmax is the larger part and hiding it under the
//   products is what the plan is for. Their softmax runs in the log2
//   domain (one ex2 a logit; on a tile whose keys are all valid for every
//   row of the warp the scale joins the exponent's FFMA and the mask is
//   skipped) and skips the rescale when no row's max moved. Issuing tile
//   i + 2's Q K^T with tile i's P V (two S buffers) was slower at every
//   shape measured and was dropped.
//   The caller also picks rows a block (64 x consumers: one consumer when S
//   * G <= 64, so no warpgroup computes padding) and a number of parts: with
//   parts > 1 each block's key range is cut on tile boundaries into parts
//   (blockIdx.z); each part writes its unnormalised fp32 O, its m and its l
//   to a workspace, and flash_merge_kernel combines them by log-sum-exp.
//   A part visits exactly the keys the one-pass kernel would, so masked
//   parts and rows with no valid key give its result (see the merge).
//   That fills the card where few blocks walk a long key range (a decode
//   step's cross-attention at batch 1: 16 blocks over 12 tiles, 6 x 16
//   blocks over 2 when split). Whisper's cross-attention at batch 4 keeps
//   one pass: its 64 blocks already read K and V at the rate the split
//   reached (both bound by their bytes).
// * fp32: flash_fwd_kernel, on the CUDA cores (fp32 arithmetic throughout).
//   A block of 128 threads owns 32 rows; Q rows are staged once in shared
//   memory as fp32; K and V stream through shared memory 32 keys at a time
//   (16-byte global loads). Per tile: S = Q K^T as 4-row x 2-key register
//   patches, stored transposed; the online softmax 4 threads a row; O = O *
//   alpha + P V, hd / 16 rows x 4 columns of the accumulator a thread.
//   Shared memory 104 KB at hd = 256 (two blocks an SM).
//
// Both visit only the tiles that hold a valid key for some row of the block:
// tiles wholly past the causal diagonal or wholly before the window are
// skipped, which is exact (see above). A block that holds a row with no
// valid key visits every tile, so such rows average all T keys. With a
// prefix every block starts at key 0 and reads at least the prefix's
// tiles; with a window too, the valid keys [0, prefix) and [s - window + 1,
// s] are two intervals, and the tiles between them, wholly masked for a
// row, add exactly 0 once key 0 has set its running max. Blocks run
// heaviest-first (the causal diagonal's last rows first). Any S and T are
// taken; tail rows and keys are masked. hd is a compile-time 64, 128 or 256.
//
// The C interface takes raw device pointers, ints, floats and a
// cudaStream_t passed as void*, and returns a CUDA error code: that of a
// tensor-map encoding it refused, else cudaGetLastError() after the launch
// (after each launch when a split launch runs the merge too).

#include <cuda.h>  // CUtensorMap (its encoder is looked up through cudart)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The keys [begin, end) that a block of `rows` rows from r0 must visit;
// begin is a multiple of `keys` (the tile). The instance without the prefix
// mask is the code that ran before the prefix existed.
template <bool kPrefix>
__device__ __forceinline__ void key_range(int64_t r0, int rows, int64_t n_rows,
                                          int G, int T, int causal, int window,
                                          int prefix, int keys, int64_t* begin,
                                          int64_t* end) {
  const int64_t s_lo = r0 / G;
  const int64_t s_hi = min64(n_rows - 1, r0 + rows - 1) / G;
  int64_t k_begin = max64(0, s_lo - window + 1);
  int64_t k_end = causal ? min64(T, s_hi + 1) : (int64_t)T;
  if (s_hi - window + 1 > (int64_t)T - 1) {  // a row with no valid key
    k_begin = 0;
    k_end = T;
  }
  if constexpr (kPrefix) {  // every row sees [0, prefix)
    k_begin = 0;
    k_end = max64(k_end, prefix);
  }
  *begin = (k_begin / keys) * keys;
  *end = k_end;
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // (query, head) rows of a block
constexpr int kKeys = 32;  // keys of a K/V tile

// Copy `rows` rows of HD floats (row i at src_row(i)) into shared memory
// rows of stride `ld`, zero-filling rows whose source is null. 16-byte loads.
template <int HD, typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int rows,
                                           RowFn src_row) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    const float* src = src_row(r);
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        src == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                       : *reinterpret_cast<const float4*>(src + c);
  }
}

template <int HD>
struct Smem {
  static constexpr int kLdQK = HD + 4;    // padded: conflict-free float4 reads
  static constexpr int kLdP = kRows + 4;  // P^T rows, float4-aligned
  static constexpr int kQ = kRows * kLdQK;
  static constexpr int kK = kKeys * kLdQK;
  static constexpr int kV = kKeys * HD;
  static constexpr int kP = kKeys * kLdP;
  static constexpr int kFloats = kQ + kK + kV + kP + 2 * kRows;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int HD, bool kPrefix>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int T_, int Hq, int Hkv, int causal, int window, int prefix,
                 float scale, int has_cap, float cap) {
  using L = Smem<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [kRows][kLdQK]
  float* Ks = Qs + L::kQ;       // [kKeys][kLdQK]
  float* Vs = Ks + L::kK;       // [kKeys][HD]
  float* Pt = Vs + L::kV;       // [kKeys][kLdP]: logits, then p, transposed
  float* alpha_s = Pt + L::kP;  // [kRows]
  float* l_s = alpha_s + kRows; // [kRows]

  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;  // b * Hkv + kv head
  const int b = bh / Hkv;
  const int hkv = bh % Hkv;
  const int64_t n_rows = (int64_t)S * G;
  const int64_t r0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kRows;  // heavy first

  // a row's query position and q / out offset (elements)
  auto row_q = [&](int r) -> int64_t { return (r0 + r) / G; };
  auto row_off = [&](int r) -> int64_t {
    const int64_t gr = r0 + r;
    const int64_t s = gr / G;
    const int h = hkv * G + (int)(gr % G);
    return ((int64_t)b * S + s) * Hq * HD + (int64_t)h * HD;
  };

  int64_t k_begin, k_end;  // keys this block must visit
  key_range<kPrefix>(r0, kRows, n_rows, G, T_, causal, window, prefix, kKeys,
                     &k_begin, &k_end);

  stage_rows<HD>(Qs, L::kLdQK, kRows, [&](int r) -> const float* {
    return r0 + r < n_rows ? q + row_off(r) : nullptr;
  });

  // phase-1 mapping: rows ty + 8i (i < 4), keys tx + 16j (j < 2)
  const int tx = tid & 15, ty = tid >> 4;
  int64_t qpos1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos1[i] = row_q(ty + 8 * i);
  // softmax mapping: row sr, keys 8 * part .. + 7
  const int sr = tid >> 2, part = tid & 3;
  float m_run = kMasked, l_run = 0.f;
  // phase-3 mapping: rows pr0 .. pr0 + RP - 1, columns 4 * cg .. + 3
  constexpr int kColGroups = HD / 4;
  constexpr int RP = HD / 16;  // kRows * kColGroups / kThreads
  const int cg = tid % kColGroups;
  const int pr0 = (tid / kColGroups) * RP;
  float acc[RP][4];
#pragma unroll
  for (int i = 0; i < RP; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const float* kb = k + ((int64_t)b * T_ * Hkv + hkv) * HD;
  const float* vb = v + ((int64_t)b * T_ * Hkv + hkv) * HD;
  const int64_t key_stride = (int64_t)Hkv * HD;

  for (int64_t kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<HD>(Ks, L::kLdQK, kKeys, [&](int j) -> const float* {
      return kt + j < T_ ? kb + (kt + j) * key_stride : nullptr;
    });
    stage_rows<HD>(Vs, HD, kKeys, [&](int j) -> const float* {
      return kt + j < T_ ? vb + (kt + j) * key_stride : nullptr;
    });
    __syncthreads();

    // 1. logits
    {
      float s_acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s_acc[i][0] = s_acc[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[4], kv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 8 * i) * L::kLdQK + d);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::kLdQK + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            s_acc[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                           qv[i].z * kv[j].z + qv[i].w * kv[j].w;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int64_t key = kt + c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s_acc[i][j] * scale;
          if (has_cap) x = tanhf(x / cap) * cap;
          const int64_t qk = qpos1[i] - key;
          bool ok = (!causal || qk >= 0) && qk < window;
          if constexpr (kPrefix) ok = ok || key < prefix;
          Pt[c * L::kLdP + ty + 8 * i] = key >= T_ ? -INFINITY : (ok ? x : kMasked);
        }
      }
    }
    __syncthreads();

    // 2. online softmax over the tile's keys, 4 threads a row
    {
      float* col = Pt + sr;
      float m_tile = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) m_tile = fmaxf(m_tile, col[(8 * part + c) * L::kLdP]);
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
      const float m_new = fmaxf(m_run, m_tile);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float* p = col + (8 * part + c) * L::kLdP;
        const float e = expf(*p - m_new);
        *p = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (part == 0) alpha_s[sr] = alpha;
    }
    __syncthreads();

    // 3. acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const float a = alpha_s[pr0 + i];
      acc[i][0] *= a;
      acc[i][1] *= a;
      acc[i][2] *= a;
      acc[i][3] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 vv = *reinterpret_cast<const float4*>(Vs + j * HD + 4 * cg);
      const float* prow = Pt + j * L::kLdP + pr0;
#pragma unroll
      for (int i4 = 0; i4 < RP; i4 += 4) {
        const float4 p = *reinterpret_cast<const float4*>(prow + i4);
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i4 + e][0] += pv[e] * vv.x;
          acc[i4 + e][1] += pv[e] * vv.y;
          acc[i4 + e][2] += pv[e] * vv.z;
          acc[i4 + e][3] += pv[e] * vv.w;
        }
      }
    }
  }

  __syncthreads();
  if (part == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int r = pr0 + i;
    if (r0 + r >= n_rows) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    *reinterpret_cast<float4*>(out + row_off(r) + 4 * cg) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                    acc[i][3] * inv);
  }
}

template <int HD, bool kPrefix>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int Hq, int Hkv, int causal, int window, int prefix,
           float scale, int has_cap, float cap, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::kBytes;
  static bool configured = false;  // once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, kPrefix>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int64_t n_rows = (int64_t)S * (Hq / Hkv);
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)(B * Hkv));
  flash_fwd_kernel<HD, kPrefix><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_, Hq, Hkv,
      causal, window, prefix, scale, has_cap, cap);
  return (int)cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kSlab = 64;              // 16-bit columns of a 128-byte swizzled row
constexpr int kQSlabBytes = 64 * 128;  // a 64-row slab of Q
constexpr float kLog2e = 1.4426950408889634f;

// The plan of each head dim, chosen at compile time. A block is one
// producer warpgroup (one thread issues TMA) and up to kConsumers consumer
// warpgroups of 64 rows (wgmma's M); K and V stream through a ring of
// kStages tiles of kKeys keys. The launch may run fewer consumers than
// kConsumers (rows a block = 64 x consumers, picked by the caller) and may
// split each block's key range into parts (blockIdx.z) merged by
// flash_merge_kernel; overlapping plans only. kOverlap: false runs each
// tile's Q K^T, softmax and P V in turn; true issues tile i + 1's Q K^T
// with tile i's P V and runs tile i + 1's softmax while P V is in flight.
// kPingPong (overlapping plans): the consumer warpgroups issue their
// products in turn (named barriers 4 + w), so that one's softmax runs
// while the next one's products do.
template <int HD>
struct Plan;

// Head dim 256: PR 16's plan and loop (128 rows, one part), unchanged.
template <>
struct Plan<256> {
  static constexpr int kConsumers = 2;
  static constexpr int kKeys = 64;
  static constexpr int kStages = 2;
  static constexpr uint32_t kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kMinBlocks = 1;
  static constexpr bool kOverlap = false;
};

// Head dim 128: a third consumer warpgroup (192 rows a block), 64-key
// tiles and a four-stage ring (Q 48 KB + 4 x (K 16 KB + V 16 KB) = 176
// KB); a consumer thread holds o[64], s[32] and P[16] within 160
// registers. On the served layers (causal, S = 256 or 512) the blocks
// are few and short, and a third warpgroup a block beat 128-key tiles.
template <>
struct Plan<128> {
  static constexpr int kConsumers = 3;
  static constexpr int kKeys = 64;
  static constexpr int kStages = 4;
  static constexpr uint32_t kProducerRegs = 24, kConsumerRegs = 160;
  static constexpr int kMinBlocks = 1;
  static constexpr bool kOverlap = true;
  static constexpr bool kPingPong = true;
};

// Head dim 64: a third consumer warpgroup (192 rows a block, 12 consumer
// warps an SM), 128-key tiles (half the max, rescale and barrier work a
// key of 64-key ones) and a three-stage ring (a stage is 32 KB: Q 24 KB +
// 96 KB). A consumer thread holds o[32], s[64] and P[32] at once within
// 160 registers (512 threads: 128 at launch, 24 for the producer, 160 for
// each consumer).
template <>
struct Plan<64> {
  static constexpr int kConsumers = 3;
  static constexpr int kKeys = 128;
  static constexpr int kStages = 3;
  static constexpr uint32_t kProducerRegs = 24, kConsumerRegs = 160;
  static constexpr int kMinBlocks = 1;
  static constexpr bool kOverlap = true;
  static constexpr bool kPingPong = true;
};

template <int HD>
struct Layout {
  using P = Plan<HD>;
  static constexpr int kThreads = 128 * (1 + P::kConsumers);
  static constexpr int kSlabs = HD / kSlab;
  static constexpr int kQTile = kSlabs * kQSlabBytes;  // a warpgroup's Q rows
  static constexpr int kKVSlab = P::kKeys * 128;       // 64 columns of a tile
  static constexpr int kTile = kSlabs * kKVSlab;       // one K or V tile
  static constexpr int kRing = 2 * P::kStages * kTile;
  static constexpr size_t bytes(int n_wg) {  // + the 1024-byte alignment
    return (size_t)n_wg * kQTile + kRing + 3 * P::kStages * 8 + 1024;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-column x kKeys-key box of a (hd, Hkv, T, B) tensor map into shared
// memory; its bytes complete the transaction count of the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int key, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head),
         "r"(key), "r"(batch), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions (they are written when wait_group returns).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x in one MUFU instruction (flushes subnormals; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The wgmma instructions (generated operand lists): d[] is the fp32
// accumulator, TY the 16-bit input type.
#define K6_D32 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31])

#define K6_D64 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
    "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define K6_D128 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
    "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
    "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
    "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
    "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
    "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
    "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
    "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
    "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
    "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
    "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
    "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
    "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
    "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
    "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define K6_QK64(TY) \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31}, " \
    "%32, %33, p, 1, 1, 0, 0;\n}\n"

#define K6_QK128(TY) \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
    "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
    "%60, %61, %62, %63}, " \
    "%64, %65, p, 1, 1, 0, 0;\n}\n"

#define K6_PV64(TY) \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31}, " \
    "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

#define K6_PV128(TY) \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
    "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
    "%60, %61, %62, %63}, " \
    "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"

#define K6_PV256(TY) \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
    "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
    "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
    "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
    "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
    "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
    "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
    "%120, %121, %122, %123, %124, %125, %126, %127}, " \
    "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"

// S = Q K^T for one k16 step over N keys: A and B from shared memory, both
// K-major.
template <typename T, int N>
__device__ __forceinline__ void mma_qk(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, uint32_t accumulate) {
  constexpr bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (N == 64 && bf16)
    asm volatile(K6_QK64("bf16") : K6_D32 : "l"(da), "l"(db), "r"(accumulate));
  else if constexpr (N == 64)
    asm volatile(K6_QK64("f16") : K6_D32 : "l"(da), "l"(db), "r"(accumulate));
  else if constexpr (bf16)
    asm volatile(K6_QK128("bf16") : K6_D64 : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile(K6_QK128("f16") : K6_D64 : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V for one k16 step: P (A) from registers, V (B) from shared memory
// as an MN-major operand (the transpose bit); N = HD.
#define K6_A "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one)
template <typename T, int HD>
__device__ __forceinline__ void mma_pv(float (&d)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  const uint32_t one = 1;
  constexpr bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (HD == 64 && bf16)
    asm volatile(K6_PV64("bf16") : K6_D32 : K6_A);
  else if constexpr (HD == 64)
    asm volatile(K6_PV64("f16") : K6_D32 : K6_A);
  else if constexpr (HD == 128 && bf16)
    asm volatile(K6_PV128("bf16") : K6_D64 : K6_A);
  else if constexpr (HD == 128)
    asm volatile(K6_PV128("f16") : K6_D64 : K6_A);
  else if constexpr (bf16)
    asm volatile(K6_PV256("bf16") : K6_D128 : K6_A);
  else
    asm volatile(K6_PV256("f16") : K6_D128 : K6_A);
}
#undef K6_A

// Two fp32 values rounded to one 16-bit pair, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// Issue S = Q K^T of one tile (HD / 16 k16 steps, four to a 64-column
// slab) and commit it as one group; the caller waits.
template <typename T, int HD, int kKeys>
__device__ __forceinline__ void issue_qk(float (&s)[kKeys / 2],
                                         uint32_t q_smem, uint32_t k_smem) {
  constexpr uint32_t kKVSlab = kKeys * 128;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    mma_qk<T, kKeys>(
        s, smem_desc(q_smem + (ks / 4) * kQSlabBytes + (ks % 4) * 32, 16, 1024),
        smem_desc(k_smem + (ks / 4) * kKVSlab + (ks % 4) * 32, 16, 1024),
        ks > 0);
  wgmma_commit();
}

// Issue O += P V of one tile (kKeys / 16 k16 steps of 16 keys, 2048 bytes
// of each slab; V's slabs are the N direction (LBO), its 8-key row groups
// the K (SBO)) and commit it as one group.
template <typename T, int HD, int kKeys>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p16)[kKeys / 16][4],
                                         uint32_t v_smem) {
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks)
    mma_pv<T, HD>(o, p16[ks], smem_desc(v_smem + ks * 2048, kKeys * 128, 1024));
  wgmma_commit();
}

// The online softmax of one tile in the log2 domain (the overlap plans):
// x = logit * log2 e, masked keys the sentinel -1e30 (keys past T -inf),
// m the running max of x from -1e30, p = 2^(x - m). On return s holds p,
// m and l (this thread's part of the row sum) are updated and alpha is the
// factor the accumulator must take. The mask is skipped for a tile whose
// keys are all valid for every row of the warp. Accumulator element j is
// the thread's row h = (j / 2) % 2 at key column
// 8 * (j / 4) + 2 * (lane % 4) + j % 2.
template <bool kPrefix, int kN>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kN], float (&m)[2], float (&l)[2], float (&alpha)[2], int kt,
    int lane, const int (&lo)[2], const int (&hi)[2], int T_, int prefix,
    float scale_l2, int has_cap, float scale_inv_cap, float cap_l2) {
  constexpr int kKeys = 2 * kN;
  bool full = kt >= max(lo[0], lo[1]) && kt + kKeys - 1 <= min(hi[0], hi[1]);
  if constexpr (kPrefix) full = full || kt + kKeys <= prefix;
  full = __all_sync(0xffffffffu, full);
  // a full tile without a softcap keeps the raw logits: the max commutes
  // with the positive scale, which then joins the exponent's FFMA
  const bool fused = full && !has_cap;
  if (!fused) {
    if (has_cap) {
#pragma unroll
      for (int j = 0; j < kN; ++j) s[j] = tanhf(s[j] * scale_inv_cap) * cap_l2;
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) s[j] *= scale_l2;
    }
    if (!full) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int h = (j >> 1) & 1;
        const int key = kt + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        bool ok = key >= lo[h] && key <= hi[h];
        if constexpr (kPrefix) ok = ok || key < prefix;
        s[j] = ok ? s[j] : (key >= T_ ? -INFINITY : kMasked);
      }
    }
  }
  float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int h = (j >> 1) & 1;
    m_tile[h] = fmaxf(m_tile[h], s[j]);
  }
  const float c = fused ? scale_l2 : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(0xffffffffu, m_tile[h], 1));
    m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(0xffffffffu, m_tile[h], 2));
    const float m_new = fmaxf(m[h], m_tile[h] * c);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int h = (j >> 1) & 1;
    const float p = ex2(fmaf(s[j], c, -m[h]));
    l[h] += p;
    s[j] = p;
  }
}

// P in q's type: k16 step ks takes key columns 16 ks .. 16 ks + 15, which
// are accumulator elements 8 ks .. 8 ks + 7 in A's register order
template <typename T, int kN>
__device__ __forceinline__ void pack_p(uint32_t (&p16)[kN / 8][4],
                                       const float (&s)[kN]) {
#pragma unroll
  for (int ks = 0; ks < kN / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p16[ks][r] = pack2<T>(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
}

template <typename T, int HD, bool kPrefix>
__global__ void __launch_bounds__(Layout<HD>::kThreads, Plan<HD>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const T* __restrict__ q, T* __restrict__ out,
                       float* __restrict__ ws, int S, int T_, int Hq, int Hkv,
                       int causal, int window, int prefix, float scale,
                       int has_cap, float cap) {
  using P = Plan<HD>;
  using L = Layout<HD>;
  constexpr int kKeys = P::kKeys;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  // consumer warpgroups of this launch (rows a block = 64 x n_wg)
  const int n_wg = P::kOverlap ? (int)(blockDim.x / 128) - 1 : P::kConsumers;
  const int rows = 64 * n_wg;
  const uint32_t k_ring = base + n_wg * L::kQTile;  // [stage] at + kTile * stage
  const uint32_t v_ring = k_ring + kStages * L::kTile;
  const uint32_t full_k = v_ring + kStages * L::kTile;  // [stage] at + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;
  const int G = Hq / Hkv;
  const int bh = blockIdx.y;  // b * Hkv + kv head
  const int b = bh / Hkv;
  const int hkv = bh % Hkv;
  const int64_t n_rows = (int64_t)S * G;
  const int64_t r0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * rows;  // heavy first
  int64_t k_begin, k_end;
  key_range<kPrefix>(r0, rows, n_rows, G, T_, causal, window, prefix, kKeys,
                     &k_begin, &k_end);
  // this block's part of its key range: tiles [t0, t1) of the n_all tiles
  // (one part, all of them, unless the launch splits the keys)
  const int n_all = (int)((k_end - k_begin + kKeys - 1) / kKeys);
  const int t0 = (int)((int64_t)n_all * blockIdx.z / gridDim.z);
  const int n_tiles = (int)((int64_t)n_all * (blockIdx.z + 1) / gridDim.z) - t0;
  const int64_t k_first = k_begin + (int64_t)t0 * kKeys;
  // consumer warpgroups that hold a real row (the others stop at once)
  const int live_wg =
      P::kOverlap ? (int)min64(n_wg, (n_rows - r0 + 63) / 64) : P::kConsumers;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * live_wg);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::kProducerRegs));
    if (threadIdx.x == 0) {
      if constexpr (P::kOverlap) {  // fetch the descriptors while Q loads
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&tm_k)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&tm_v)) : "memory");
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        const int key = (int)(k_first + (int64_t)i * kKeys);
        mbar_expect_tx(full_k + 8 * st, L::kTile);
#pragma unroll
        for (int c = 0; c < L::kSlabs; ++c)
          tma_load(k_ring + st * L::kTile + c * L::kKVSlab, &tm_k,
                   full_k + 8 * st, c * kSlab, hkv, key, b);
        mbar_expect_tx(full_v + 8 * st, L::kTile);
#pragma unroll
        for (int c = 0; c < L::kSlabs; ++c)
          tma_load(v_ring + st * L::kTile + c * L::kKVSlab, &tm_v,
                   full_v + 8 * st, c * kSlab, hkv, key, b);
      }
    }
    return;
  }

  // consumers: warpgroup 1 + w takes rows 64 w .. 64 w + 63 of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::kConsumerRegs));
  const int cw = wg - 1;
  if constexpr (P::kOverlap) {
    if (cw >= live_wg) return;  // only padding rows
  }
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int64_t rw0 = r0 + 64 * (int64_t)cw;
  const uint32_t q_smem = base + cw * L::kQTile;

  auto row_off = [&](int64_t gr) -> int64_t {  // q / out offset of a row
    const int64_t s = gr / G;
    const int h = hkv * G + (int)(gr % G);
    return ((int64_t)b * S + s) * Hq * HD + (int64_t)h * HD;
  };

  // stage this warpgroup's 64 Q rows (zeros past S * G), swizzled as TMA
  // would: 16-byte chunk j of row r at chunk (j ^ r) % 8 of its slab's row
  {
    constexpr int kChunks = HD / 8;
    for (int i = t; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks, j = i % kChunks;
      const int64_t gr = rw0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < n_rows)
        val = *reinterpret_cast<const uint4*>(q + row_off(gr) + j * 8);
      *reinterpret_cast<uint4*>(smem + (q_smem - base) + (j / 8) * kQSlabBytes +
                                r * 128 + (((j % 8) ^ (r & 7)) << 4)) = val;
    }
    // generic-proxy writes, read next by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");
  }

  // a thread's two rows: 16 * warp + lane / 4 and 8 more; their valid keys
  // [lo, hi] (the mask, with [0, prefix) besides), their out offsets
  int lo[2], hi[2];
  int64_t off[2];
  bool real[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t gr = rw0 + 16 * warp + lane / 4 + 8 * h;
    real[h] = gr < n_rows;
    const int s = real[h] ? (int)(gr / G) : 0;
    lo[h] = s - (window - 1);  // s - t < window
    hi[h] = causal ? min(s, T_ - 1) : T_ - 1;
    off[h] = real[h] ? row_off(gr) : 0;
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // l: this thread's part

  if constexpr (!P::kOverlap) {
    // PR 16's loop: each tile's Q K^T, its softmax and its P V in turn
    const float inv_cap = has_cap ? 1.f / cap : 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int kt = (int)(k_first + (int64_t)i * kKeys);
      const uint32_t k_smem = k_ring + st * L::kTile;
      const uint32_t v_smem = v_ring + st * L::kTile;

      // S = Q K^T: HD / 16 steps of k16, four to a 64-column slab
      float s_acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s_acc[j] = 0.f;
      mbar_wait(full_k + 8 * st, parity);
      fence_regs(s_acc);
      wgmma_fence();
      issue_qk<T, HD, kKeys>(s_acc, q_smem, k_smem);
      wgmma_wait_all();
      fence_regs(s_acc);

      // scale, softcap and mask: accumulator element j is the thread's row
      // h = (j / 2) % 2 at key column 8 * (j / 4) + 2 * (lane % 4) + j % 2
      float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j >> 1) & 1;
        const int key = kt + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        float x = s_acc[j] * scale;
        if (has_cap) x = tanhf(x * inv_cap) * cap;
        if constexpr (kPrefix)
          x = ((key >= lo[h] && key <= hi[h]) || key < prefix)
                  ? x : (key >= T_ ? -INFINITY : kMasked);
        else
          x = (key >= lo[h] && key <= hi[h]) ? x
              : (key >= T_ ? -INFINITY : kMasked);
        s_acc[j] = x;
        m_tile[h] = fmaxf(m_tile[h], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(0xffffffffu, m_tile[h], 1));
        m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(0xffffffffu, m_tile[h], 2));
        const float m_new = fmaxf(m[h], m_tile[h]);
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j >> 1) & 1;
        const float p = exp2f((s_acc[j] - m[h]) * kLog2e);
        l[h] += p;
        s_acc[j] = p;
      }
      uint32_t p16[4][4];
      pack_p<T, 32>(p16, s_acc);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        o[4 * c] *= alpha[0];
        o[4 * c + 1] *= alpha[0];
        o[4 * c + 2] *= alpha[1];
        o[4 * c + 3] *= alpha[1];
      }

      // O += P V
      mbar_wait(full_v + 8 * st, parity);
      fence_regs(o);
      wgmma_fence();
      issue_pv<T, HD, kKeys>(o, p16, v_smem);
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // the stage is free
    }
  } else {
    // tile i + 1's Q K^T and tile i's P V run on the tensor cores while
    // tile i + 1's softmax runs; the accumulator takes tile i + 1's rescale
    // once its P V is done (m is then in the log2 domain)
    constexpr int kN = kKeys / 2;  // accumulator floats a thread of S
    const float scale_l2 = scale * kLog2e;
    const float scale_inv_cap = has_cap ? scale / cap : 0.f;
    const float cap_l2 = cap * kLog2e;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (!real[h]) lo[h] = -(1 << 30), hi[h] = 1 << 30;  // padding: any key
    uint32_t p16[kN / 8][4];
    float alpha[2] = {1.f, 1.f};
    auto rescale = [&]() {  // o *= alpha, unless no row's max moved
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          o[4 * c] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
      }
    };
    if (n_tiles > 0) {
      // ping-pong: warpgroup w waits at barrier 4 + w for w - 1 to have
      // issued, issues, and lets w + 1 go; the last lets 0 go first and
      // skips its final arrival, so every barrier phase has 256 threads
      const bool turns = P::kPingPong && live_wg > 1;
      const uint32_t bar_me = 4 + cw, bar_next = 4 + (cw + 1) % live_wg;
      auto my_turn = [&]() {
        if (turns) asm volatile("bar.sync %0, 256;\n" ::"r"(bar_me) : "memory");
      };
      auto next_turn = [&](bool last) {
        if (turns && !(last && cw == live_wg - 1))
          asm volatile("bar.arrive %0, 256;\n" ::"r"(bar_next) : "memory");
      };
      if (turns && cw == live_wg - 1)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4) : "memory");
      float s[kN];
      const int kt0 = (int)k_first;
#pragma unroll
      for (int j = 0; j < kN; ++j) s[j] = 0.f;
      mbar_wait(full_k, 0);
      fence_regs(s);
      my_turn();
      wgmma_fence();
      issue_qk<T, HD, kKeys>(s, q_smem, k_ring);
      next_turn(false);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile<kPrefix>(s, m, l, alpha, kt0, lane, lo, hi, T_, prefix,
                            scale_l2, has_cap, scale_inv_cap, cap_l2);
      pack_p<T, kN>(p16, s);
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % kStages, sp = (i - 1) % kStages;
        mbar_wait(full_k + 8 * st, (i / kStages) & 1);
        mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
        my_turn();
        wgmma_fence();
        issue_qk<T, HD, kKeys>(s, q_smem, k_ring + st * L::kTile);
        issue_pv<T, HD, kKeys>(o, p16, v_ring + sp * L::kTile);
        next_turn(false);
        wgmma_wait<1>();  // Q K^T of tile i is done; P V of i - 1 may run on
        fence_regs(s);
        softmax_tile<kPrefix>(s, m, l, alpha,
                              (int)(k_first + (int64_t)i * kKeys), lane, lo,
                              hi, T_, prefix, scale_l2, has_cap, scale_inv_cap,
                              cap_l2);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p16);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * sp);  // stage i - 1 is free
        rescale();
        pack_p<T, kN>(p16, s);
      }
      const int sl = (n_tiles - 1) % kStages;
      mbar_wait(full_v + 8 * sl, ((n_tiles - 1) / kStages) & 1);
      my_turn();
      wgmma_fence();
      issue_pv<T, HD, kKeys>(o, p16, v_ring + sl * L::kTile);
      next_turn(true);
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sl);
    }
  }

  // epilogue: l over the row's four threads; element 4 c + 2 h + e of o is
  // row h, column 8 c + 2 (lane % 4) + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (!P::kOverlap || gridDim.z == 1) {
    // one part: acc / max(l, 1e-30), rounded once to T
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!real[h]) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      T* row = out + off[h] + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<uint32_t*>(row + 8 * c) =
            pack2<T>(o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
    }
  } else {
    // a part of the keys: its unnormalised fp32 o, m (log2 domain) and l
    // at (part, out row) of the workspace, for flash_merge_kernel
    const int64_t n_out = (int64_t)(gridDim.y / Hkv) * S * Hq;
    float* wo = ws + (int64_t)blockIdx.z * n_out * HD;
    float* wm = ws + (int64_t)gridDim.z * n_out * HD + blockIdx.z * n_out;
    float* wl = wm + (int64_t)gridDim.z * n_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!real[h]) continue;
      const int64_t row = off[h] / HD;
      float* dst = wo + row * HD + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<float2*>(dst + 8 * c) =
            make_float2(o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
      if ((lane & 3) == 0) {
        wm[row] = m[h];
        wl[row] = l[h];
      }
    }
  }
}

// The merge of a split launch: out row r = sum_p w_p o_p / max(sum_p w_p
// l_p, 1e-30), w_p = 2^(m_p - max_p m_p), rounded once to T. A part whose
// keys are all masked for the row (m_p = -1e30) gets w_p = 0 beside a part
// with a valid key, and 1 when no part has one: the one-pass kernel's
// alpha = 0 wipe and its uniform average alike. One thread takes four
// columns of a row. Bound by its bytes: parts x (hd + 2) floats read and hd
// 16-bit values written a row, most of it still in L2 from the parts.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                   int64_t n_out, int parts) {
  constexpr int kQuads = HD / 4;
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int64_t row = i / kQuads;
  if (row >= n_out) return;
  const int col = (int)(i % kQuads) * 4;
  const float* wm = ws + (int64_t)parts * n_out * HD;
  const float* wl = wm + (int64_t)parts * n_out;
  float mx = -INFINITY;
  for (int p = 0; p < parts; ++p) mx = fmaxf(mx, wm[p * n_out + row]);
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < parts; ++p) {
    const float w = ex2(wm[p * n_out + row] - mx);
    lsum += w * wl[p * n_out + row];
    const float4 x =
        *reinterpret_cast<const float4*>(ws + (p * n_out + row) * HD + col);
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  *reinterpret_cast<uint2*>(out + row * HD + col) =
      make_uint2(pack2<T>(acc.x * inv, acc.y * inv),
                 pack2<T>(acc.z * inv, acc.w * inv));
}

}  // namespace hopper

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The (hd, Hkv, T, B) tensor map of k or v, read in 64-column x kKeys-key
// boxes with the 128-byte swizzle; keys past T read as zeros. The encoder
// refuses a base that is not 16-byte aligned or a stride that is not a
// multiple of 16 bytes (the wrapper checks both first).
template <typename T, int HD>
int kv_tensor_map(CUtensorMap* map, const void* ptr, int B, int T_, int Hkv) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)Hkv, (cuuint64_t)T_,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * sizeof(T), (cuuint64_t)Hkv * HD * sizeof(T),
                                 (cuuint64_t)T_ * Hkv * HD * sizeof(T)};
  const cuuint32_t box[4] = {hopper::kSlab, 1, hopper::Plan<HD>::kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType ty = std::is_same_v<T, __nv_bfloat16>
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = encode(map, ty, 4, const_cast<void*>(ptr), dims, strides,
                            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// rows: (query, head) rows a block, 64 x consumer warpgroups (the plan's
// kConsumers at most; head dim 256 takes only its 128); parts: pieces of
// each block's key range (1: none; more needs ws, parts x B S Hq x (hd + 2)
// floats, and launches flash_merge_kernel after).
template <typename T, int HD, bool kPrefix>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* ws, int B, int S, int T_, int Hq, int Hkv, int causal,
                 int window, int prefix, float scale, int has_cap, float cap,
                 int rows, int parts, cudaStream_t stream) {
  using P = hopper::Plan<HD>;
  using L = hopper::Layout<HD>;
  const int n_wg = rows / 64;
  if (rows % 64 != 0 || n_wg < 1 || n_wg > P::kConsumers || parts < 1 ||
      parts > 65535 || (parts > 1 && ws == nullptr) ||
      (!P::kOverlap && (n_wg != P::kConsumers || parts != 1)))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = L::bytes(n_wg);
  static bool configured = false;  // once per instance, for the most rows
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        hopper::flash_fwd_wgmma_kernel<T, HD, kPrefix>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::bytes(P::kConsumers));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tm_k, tm_v;
  int err = kv_tensor_map<T, HD>(&tm_k, k, B, T_, Hkv);
  if (err == 0) err = kv_tensor_map<T, HD>(&tm_v, v, B, T_, Hkv);
  if (err != 0) return err;
  const int64_t n_rows = (int64_t)S * (Hq / Hkv);
  const dim3 grid((unsigned)((n_rows + rows - 1) / rows), (unsigned)(B * Hkv),
                  (unsigned)parts);
  hopper::flash_fwd_wgmma_kernel<T, HD, kPrefix>
      <<<grid, 128 * (1 + n_wg), bytes, stream>>>(
      tm_k, tm_v, static_cast<const T*>(q), static_cast<T*>(out),
      static_cast<float*>(ws), S, T_, Hq, Hkv, causal, window, prefix, scale,
      has_cap, cap);
  err = (int)cudaGetLastError();
  if (err != 0 || parts == 1) return err;
  const int64_t n_out = (int64_t)B * S * Hq;
  const int64_t threads = n_out * (HD / 4);
  hopper::flash_merge_kernel<T, HD><<<(unsigned)((threads + 255) / 256), 256,
                                      0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), n_out, parts);
  return (int)cudaGetLastError();
}

// One instance of each kernel with the prefix mask and one without, so a
// launch without a prefix runs the code it ran before the prefix existed.
template <int HD, bool kPrefix>
int launch_typed(int dtype, const void* q, const void* k, const void* v,
                 void* out, void* ws, int B, int S, int T_, int Hq, int Hkv,
                 int causal, int window, int prefix, float scale, int has_cap,
                 float cap, int rows, int parts, cudaStream_t s) {
  switch (dtype) {
    case 0:  // the CUDA-core kernel has one plan: no rows, no parts
      if (parts != 1) return (int)cudaErrorInvalidValue;
      return fp32::launch<HD, kPrefix>(q, k, v, out, B, S, T_, Hq, Hkv,
                                       causal, window, prefix, scale, has_cap,
                                       cap, s);
    case 1:
      return launch_wgmma<__nv_bfloat16, HD, kPrefix>(
          q, k, v, out, ws, B, S, T_, Hq, Hkv, causal, window, prefix, scale,
          has_cap, cap, rows, parts, s);
    case 2:
      return launch_wgmma<__half, HD, kPrefix>(
          q, k, v, out, ws, B, S, T_, Hq, Hkv, causal, window, prefix, scale,
          has_cap, cap, rows, parts, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           void* ws, int B, int S, int T_, int Hq, int Hkv, int causal,
           int window, int prefix, float scale, int has_cap, float cap,
           int rows, int parts, cudaStream_t s) {
  if (prefix > 0)
    return launch_typed<HD, true>(dtype, q, k, v, out, ws, B, S, T_, Hq, Hkv,
                                  causal, window, prefix, scale, has_cap, cap,
                                  rows, parts, s);
  return launch_typed<HD, false>(dtype, q, k, v, out, ws, B, S, T_, Hq, Hkv,
                                 causal, window, 0, scale, has_cap, cap, rows,
                                 parts, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out alike). Keys
// below prefix (0 <= prefix <= T; 0: none) are valid for every query. rows
// and parts are the 16-bit kernel's launch plan (see launch_wgmma; the fp32
// kernel ignores rows and takes parts = 1); ws is the workspace of a split
// launch (parts > 1), else null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* ws, int dtype, int B,
                                   int S, int T, int Hq, int Hkv, int hd,
                                   int causal, int window, int prefix,
                                   float scale, int has_cap, float cap,
                                   int rows, int parts, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 1 || prefix < 0 ||
      prefix > T || B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(dtype, q, k, v, out, ws, B, S, T, Hq, Hkv, causal,
                        window, prefix, scale, has_cap, cap, rows, parts, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, ws, B, S, T, Hq, Hkv, causal,
                         window, prefix, scale, has_cap, cap, rows, parts, s);
    case 256:
      return launch<256>(dtype, q, k, v, out, ws, B, S, T, Hq, Hkv, causal,
                         window, prefix, scale, has_cap, cap, rows, parts, s);
  }
  return (int)cudaErrorInvalidValue;
}
