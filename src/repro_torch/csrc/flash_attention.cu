// Forward flash attention (K6), sm_90a.
//
// Replaces repro/kernels/flash_attention/flash_attention.py _flash_kernel
// (flash_attention_pallas). It computes what flash_attention_ref computes:
//
//     out[b, s, h] = sum_t softmax_t(L[b, s, h, t]) * v[b, t, h / G]
//     L = mask(softcap((q[b, s, h] . k[b, t, h / G]) * scale))
//
// for q (B, S, Hq, hd) against k, v (B, T, Hkv, hd), G = Hq / Hkv (q head h
// reads kv head h / G: contiguous groups), in fp32 whatever the input type
// (fp32, bf16 or fp16; the output is in q's type). softcap(x) = tanh(x /
// cap) * cap when cap is given. The mask is the TPU kernel's: key t is valid
// for query s when (!causal || s - t >= 0) && s - t < window; masked logits
// are the finite -1e30 and the running max starts at -1e30, as in the TPU
// kernel, so a tile whose keys are all masked for a row adds p = 1 entries
// that the first valid key's alpha = exp(-1e30 - m) = 0 wipes exactly, and
// a row with no valid key at all averages v over all T keys, as the
// materialised softmax does. Keys past T (the ragged tail of the last tile)
// take -INFINITY: they never count. The output is acc / max(l, 1e-30).
//
// What bounds it: the operations. At the serving path's shapes (B = 2,
// S = T = 6144, 8 q heads over 4 kv heads, hd = 256, bf16) a global layer has
// 2 * 8 * 18.9M unmasked (query, key) pairs at 4 * hd flops each, 0.31
// TFLOP: 0.31 ms at the bf16 tensor-core rate (989 TFLOP/s), 4.6 ms at the
// fp32 CUDA-core rate (67 TFLOP/s) this kernel runs at, against 0.05 ms to
// read q, k, v once and write the output.
//
// Design (right first; fast is later work: wgmma on bf16 tiles, TMA, bf16
// P). A block of 128 threads owns 32 rows of one (batch, kv head): row r is
// the (query, group head) pair r0 + r of the S * G rows, so the G q heads
// that share a kv head share each K/V tile. Q rows are staged once in shared
// memory as fp32; K and V stream through shared memory 32 keys at a time,
// converted to fp32 on the way in (16-byte global loads). Per tile:
//   1. S = Q K^T: each thread a 4-row x 2-key patch, float4 reads of padded
//      rows, then scale, softcap and the mask, stored transposed;
//   2. online softmax: 4 threads a row (max and sum over shuffles), the
//      running (m, l) in registers, alpha in shared memory;
//   3. O = O * alpha + P V: each thread hd / 16 rows x 4 columns of the
//      accumulator in registers (64 floats at hd = 256).
// Only tiles that hold a valid key for some row of the block are visited:
// tiles wholly past the causal diagonal or wholly before the window are
// skipped, which is exact (see above). A block that holds a row with no
// valid key visits every tile, so such rows average all T keys. Blocks run
// heaviest-first (the causal diagonal's last rows first). Any S and T are
// taken; tail rows and keys are masked. hd is a compile-time 64, 128 or
// 256. Shared memory: 104 KB at hd = 256 (two blocks an SM), set with
// cudaFuncSetAttribute.
//
// The C interface takes raw device pointers, ints, floats and a
// cudaStream_t passed as void*, and returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // (query, head) rows of a block
constexpr int kKeys = 32;  // keys of a K/V tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// Copy `rows` rows of HD elements (row i at src_row(i)) into fp32 shared
// memory rows of stride `ld`, zero-filling rows whose source is null. 16-byte
// loads: 16 / sizeof(T) elements each.
template <typename T, int HD, typename RowFn>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int rows,
                                           RowFn src_row) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const T* src = src_row(r);
    float* d = dst + r * ld + c;
    if (src == nullptr) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = 0.f;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(d + e) =
            make_float4(to_float(t[e]), to_float(t[e + 1]), to_float(t[e + 2]),
                        to_float(t[e + 3]));
    }
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int T_,
                 int Hq, int Hkv, int causal, int window, float scale,
                 int has_cap, float cap) {
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

  // keys this block must visit
  const int64_t s_lo = r0 / G;
  const int64_t s_hi = min64(n_rows - 1, r0 + kRows - 1) / G;
  int64_t k_begin = max64(0, s_lo - window + 1);
  int64_t k_end = causal ? min64(T_, s_hi + 1) : (int64_t)T_;
  if (s_hi - window + 1 > (int64_t)T_ - 1) {  // a row with no valid key
    k_begin = 0;
    k_end = T_;
  }
  k_begin = (k_begin / kKeys) * kKeys;

  stage_rows<T, HD>(Qs, L::kLdQK, kRows, [&](int r) -> const T* {
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

  const T* kb = k + ((int64_t)b * T_ * Hkv + hkv) * HD;
  const T* vb = v + ((int64_t)b * T_ * Hkv + hkv) * HD;
  const int64_t key_stride = (int64_t)Hkv * HD;

  for (int64_t kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, HD>(Ks, L::kLdQK, kKeys, [&](int j) -> const T* {
      return kt + j < T_ ? kb + (kt + j) * key_stride : nullptr;
    });
    stage_rows<T, HD>(Vs, HD, kKeys, [&](int j) -> const T* {
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
          const bool ok = (!causal || qk >= 0) && qk < window;
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
    T* o = out + row_off(r) + 4 * cg;
    o[0] = from_float<T>(acc[i][0] * inv);
    o[1] = from_float<T>(acc[i][1] * inv);
    o[2] = from_float<T>(acc[i][2] * inv);
    o[3] = from_float<T>(acc[i][3] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int Hq, int Hkv, int causal, int window, float scale,
           int has_cap, float cap, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::kBytes;
  static bool configured = false;  // once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int64_t n_rows = (int64_t)S * (Hq / Hkv);
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)(B * Hkv));
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_, Hq, Hkv, causal,
      window, scale, has_cap, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                int B, int S, int T_, int Hq, int Hkv, int causal, int window,
                float scale, int has_cap, float cap, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, T_, Hq, Hkv, causal, window,
                           scale, has_cap, cap, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, T_, Hq, Hkv, causal, window,
                            scale, has_cap, cap, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, T_, Hq, Hkv, causal, window,
                            scale, has_cap, cap, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out alike).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int dtype, int B, int S, int T,
                                   int Hq, int Hkv, int hd, int causal,
                                   int window, float scale, int has_cap,
                                   float cap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 1 || B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_hd<float>(hd, q, k, v, out, B, S, T, Hq, Hkv, causal,
                                window, scale, has_cap, cap, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, T, Hq, Hkv,
                                        causal, window, scale, has_cap, cap, s);
    case 2:
      return dispatch_hd<__half>(hd, q, k, v, out, B, S, T, Hq, Hkv, causal,
                                 window, scale, has_cap, cap, s);
  }
  return (int)cudaErrorInvalidValue;
}
