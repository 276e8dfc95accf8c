// Fused masked block-SpGEMM for the matrix lane (K4), sm_90a.
//
// Replaces repro/kernels/masked_spgemm/masked_spgemm.py _masked_spgemm_kernel
// (masked_spgemm_pallas). For every tile triple t of the matrix lane's
// schedule it computes
//
//     out[t] = sum_ij A[t,i,j] * (L[t] @ U[t])[i,j]
//
// over three float32 (T, B, B) row-major stacks holding 0/1, and writes one
// float32 per triple. What the TPU kernel kept out of HBM stays out of it
// here: the B x B product lives only in registers and is reduced against
// the mask in the epilogue; nothing but the (T,) partials is written.
//
// Exactness: products are 0/1, every element of L @ U is an integer <= B,
// and every partial sum is an integer <= B^3 <= 2^24, so float32 holds each
// value exactly and any summation order gives the same bits as the plain
// torch version (tolerance 0).
//
// Bound: the function must read the three stacks once and write the
// partials, 3*T*B*B*4 + 4*T bytes: at B = 128 (orkut-like, T = 90,025,
// 17.7 GB) about 5.28 ms at 3.35 TB/s on an H100 SXM; at B = 32 (road-like,
// T = 39,987, 0.49 GB) about 0.15 ms. Its 2*T*B^3 operations are exact in
// bf16 on the tensor cores (0.378 TFLOP at B = 128: 0.38 ms at 989 TFLOP/s),
// so the kernel is bytes-bound at both tile sizes. This first version runs
// the product on the CUDA cores in float32 (at least ~5.6 ms at 67 TFLOP/s
// for orkut-like); tensor cores are later work.
//
// Design: one block of 256 threads (a 16 x 16 grid) per triple. The output
// is walked in TM x TM tiles (TM = 16, 32, 64 or 128, the smallest that
// covers B, capped at 128; B up to 256 takes up to four output tiles). Each
// thread keeps an RM x RM patch of the product in registers (RM = TM / 16),
// at rows ty + 16 r and columns tx + 16 c, so a warp's shared-memory reads
// are broadcasts (L) or consecutive words (U) and its mask reads are 64-byte
// runs. K is walked in chunks of KC = 32: L[i0:i0+TM, k0:k0+KC] and
// U[k0:k0+KC, j0:j0+TM] are staged in shared memory (33 KB at TM = 128),
// with the ragged edge masked to zero, so any B from 1 to 256 works. The
// epilogue multiplies the patch by the matching A elements, and the block
// reduces: warp shuffles, then shared memory, then one store per triple. No
// atomics across blocks, no L @ U in global memory, any T >= 1.
//
// The C interface takes raw device pointers, ints and a cudaStream_t passed
// as void*, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kKC = 32;        // K chunk staged per pass
constexpr int kMaxBlock = 256;

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
masked_spgemm_kernel(const float* __restrict__ L, const float* __restrict__ U,
                     const float* __restrict__ A, float* __restrict__ out,
                     int B) {
  constexpr int RM = TM / 16;
  __shared__ float ls[TM][kKC + 1];  // +1: row-strided stores stay conflict-free
  __shared__ float us[kKC][TM];
  __shared__ float warp_sums[kThreads / 32];

  const size_t base = (size_t)blockIdx.x * B * B;
  const float* Lt = L + base;
  const float* Ut = U + base;
  const float* At = A + base;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float total = 0.f;

  for (int i0 = 0; i0 < B; i0 += TM) {
    for (int j0 = 0; j0 < B; j0 += TM) {
      float acc[RM][RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RM; ++c) acc[r][c] = 0.f;

      for (int k0 = 0; k0 < B; k0 += kKC) {
        __syncthreads();  // the previous chunk is consumed
        for (int e = threadIdx.x; e < TM * kKC; e += kThreads) {
          const int r = e / kKC, k = e % kKC;
          const int gi = i0 + r, gk = k0 + k;
          ls[r][k] = (gi < B && gk < B) ? Lt[(size_t)gi * B + gk] : 0.f;
        }
        for (int e = threadIdx.x; e < kKC * TM; e += kThreads) {
          const int k = e / TM, c = e % TM;
          const int gk = k0 + k, gj = j0 + c;
          us[k][c] = (gk < B && gj < B) ? Ut[(size_t)gk * B + gj] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kKC; ++k) {
          float a[RM], b[RM];
#pragma unroll
          for (int r = 0; r < RM; ++r) a[r] = ls[ty + 16 * r][k];
#pragma unroll
          for (int c = 0; c < RM; ++c) b[c] = us[k][tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int c = 0; c < RM; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
      }

      // epilogue: mask the patch by A and fold it into the thread's sum
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int gi = i0 + ty + 16 * r;
        if (gi >= B) continue;
#pragma unroll
        for (int c = 0; c < RM; ++c) {
          const int gj = j0 + tx + 16 * c;
          if (gj < B) total = fmaf(acc[r][c], At[(size_t)gi * B + gj], total);
        }
      }
    }
  }

  // block reduction: warp shuffles, shared memory, one store per triple
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(0xffffffffu, total, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    out[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" int tc_masked_spgemm(const float* l, const float* u, const float* a,
                                float* out, int T, int B, void* stream) {
  if (T <= 0) return 0;
  if (B < 1 || B > kMaxBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 16)
    masked_spgemm_kernel<16><<<T, kThreads, 0, s>>>(l, u, a, out, B);
  else if (B <= 32)
    masked_spgemm_kernel<32><<<T, kThreads, 0, s>>>(l, u, a, out, B);
  else if (B <= 64)
    masked_spgemm_kernel<64><<<T, kThreads, 0, s>>>(l, u, a, out, B);
  else
    masked_spgemm_kernel<128><<<T, kThreads, 0, s>>>(l, u, a, out, B);
  return (int)cudaGetLastError();
}
