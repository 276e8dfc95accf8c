// Fused masked block-SpGEMM for the matrix lane (K4), sm_90a.
//
// Replaces repro/kernels/masked_spgemm/masked_spgemm.py _masked_spgemm_kernel
// (masked_spgemm_pallas). For every tile triple t of the matrix lane's
// schedule it computes
//
//     out[t] = sum_ij A[a_index[t], i, j] * (L[l_index[t]] @ U[u_index[t]])[i, j]
//
// over (n, B, B) row-major tile arrays holding 0/1 (the unique tiles of the
// schedule: L, U and A may be the same array, and the main path passes U as
// A) read through three (T,) int32 index vectors, and writes one float32 per
// triple at the triple's own position t. What the TPU kernel kept out of HBM
// stays out of it here: the B x B product lives only in registers and is
// reduced against the mask in the epilogue; nothing but the (T,) partials is
// written, and the (T, B, B) stacks the TPU kernel read are never gathered.
//
// Exactness: 0 and 1 are exact in bf16, products are 0/1, every element of
// L @ U is an integer <= B, and every partial sum is an integer <= B^3 <=
// 2^24, so fp32 accumulation holds each value exactly and any summation
// order gives the same bits as the plain torch version (tolerance 0).
//
// What bounds it: the operations. The function must read each distinct tile
// that the triples name once and the indices, and write the partials; for
// orkut-like (T = 90,025 at B = 128, 4,059 unique L and U tiles) that is
// 0.27 GB in bf16, 0.08 ms at 3.35 TB/s, against 2 * T * B^3 = 0.378 TFLOP,
// 0.38 ms at the bf16 tensor-core rate (989 TFLOP/s).
//
// Two kernels, chosen by the tiles' type, with no fallback between them:
//
// * bf16 at B = 128: masked_spgemm_wgmma_kernel, on the tensor cores. A
//   persistent grid (one block an SM, at most T blocks) walks the launch
//   order: block b takes positions b, b + grid, ... of `order` (the identity
//   when it is null), so the blocks that run together take neighbouring
//   positions, and an order sorted by (a_index, l_index) lets them share
//   their A and L tiles in L2. A block has three warpgroups. One producer
//   thread loads each triple's indices and streams its L, U and A tiles by
//   TMA into a 2-stage ring (3-d tensor maps over each (n, B, B) array with
//   the tile index outermost, 128-byte swizzle, so a 128-wide tile is two
//   64-column slabs of 16 KB; a stage is 96 KB), signalled by mbarriers.
//   Two consumer warpgroups take 64 of the 128 output rows each: eight
//   wgmma m64n128k16 along K, L as a K-major A operand and U as an MN-major
//   B operand (the transpose bit), into 64 fp32 registers a thread. The
//   epilogue multiplies each accumulator element by A at the same (i, j),
//   read from the staged A tile through the swizzle that TMA wrote (4-byte
//   reads, conflict-free), sums in fp32 (the thread's 64 products, warp
//   shuffles, the eight consumer warps through shared memory) and stores
//   once per triple; each warp releases the stage after it has read A.
// * fp32, any B from 1 to 256: masked_spgemm_kernel, on the CUDA cores. One
//   block of 256 threads (a 16 x 16 grid) per triple reads its three tiles
//   through the indices. The output is walked in TM x TM tiles (TM = 16, 32,
//   64 or 128, the smallest that covers B, capped at 128; B up to 256 takes
//   up to four output tiles). Each thread keeps an RM x RM patch of the
//   product in registers (RM = TM / 16), at rows ty + 16 r and columns
//   tx + 16 c. K is walked in chunks of KC = 32 staged in shared memory (33
//   KB at TM = 128), with the ragged edge masked to zero. The epilogue
//   multiplies the patch by the matching A elements, and the block reduces:
//   warp shuffles, then shared memory, then one store per triple.
//
// Neither kernel checks an index against its array: the indices are checked
// once on the host where the schedule makes them. (A TMA load past the end
// of an array reads zeros.)
//
// The C interface takes raw device pointers, ints and a cudaStream_t passed
// as void*, and returns a CUDA error code: that of a tensor-map encoding it
// refused, else cudaGetLastError() after the launch.

#include <cuda.h>  // CUtensorMap (its encoder is looked up through cudart)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 256;

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kKC = 32;        // K chunk staged per pass

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
masked_spgemm_kernel(const float* __restrict__ L, const float* __restrict__ U,
                     const float* __restrict__ A,
                     const int* __restrict__ l_index,
                     const int* __restrict__ u_index,
                     const int* __restrict__ a_index, float* __restrict__ out,
                     int B) {
  constexpr int RM = TM / 16;
  __shared__ float ls[TM][kKC + 1];  // +1: row-strided stores stay conflict-free
  __shared__ float us[kKC][TM];
  __shared__ float warp_sums[kThreads / 32];

  const size_t tile = (size_t)B * B;
  const float* Lt = L + (size_t)l_index[blockIdx.x] * tile;
  const float* Ut = U + (size_t)u_index[blockIdx.x] * tile;
  const float* At = A + (size_t)a_index[blockIdx.x] * tile;
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

int launch(const float* l, const float* u, const float* a, const int* li,
           const int* ui, const int* ai, float* out, int T, int B,
           cudaStream_t s) {
  if (B <= 16)
    masked_spgemm_kernel<16><<<T, kThreads, 0, s>>>(l, u, a, li, ui, ai, out, B);
  else if (B <= 32)
    masked_spgemm_kernel<32><<<T, kThreads, 0, s>>>(l, u, a, li, ui, ai, out, B);
  else if (B <= 64)
    masked_spgemm_kernel<64><<<T, kThreads, 0, s>>>(l, u, a, li, ui, ai, out, B);
  else
    masked_spgemm_kernel<128><<<T, kThreads, 0, s>>>(l, u, a, li, ui, ai, out, B);
  return (int)cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kRowsWG = 64;    // output rows of a consumer warpgroup (M)
constexpr int kConsumerWarps = 8;
constexpr int kStages = 2;
constexpr int kSlab = 64;  // bf16 columns of a 128-byte swizzled row

template <int B>
struct Smem {
  static_assert(B == 2 * kRowsWG, "two consumer warpgroups own the B rows");
  static constexpr int kSlabs = B / kSlab;
  static constexpr int kSlabBytes = B * 128;           // B rows of 128 bytes
  static constexpr int kTile = kSlabs * kSlabBytes;    // one (B, B) tile
  static constexpr int kL = 0, kU = kTile, kA = 2 * kTile;  // in a stage
  static constexpr int kStage = 3 * kTile;
  static constexpr int kBars = kStages * kStage;       // full, empty
  static constexpr int kRed = kBars + 2 * kStages * 8;  // [2][warps] floats
  static constexpr size_t kBytes = kRed + 2 * kConsumerWarps * 4 + 1024;
};

// The helpers below are twins of those in flash_attention.cu (namespace
// hopper there); each source is built and hashed on its own.
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

// One 64-column x B-row slab of tile `tile` of an (n, B, B) tensor map into
// shared memory; its bytes complete the transaction count of the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int tile) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(0),
         "r"(tile), "r"(bar)
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions (they are written when wait_group returns).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D += L U for one k16 step: L (A) K-major and U (B) MN-major (the transpose
// bit), both from shared memory; d[] is the (64, 128) fp32 accumulator.
__device__ __forceinline__ void mma_lu(float (&d)[64], uint64_t da,
                                       uint64_t db, uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int B>
__global__ void __launch_bounds__(kThreads, 1)
masked_spgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_l,
                           const __grid_constant__ CUtensorMap tm_u,
                           const __grid_constant__ CUtensorMap tm_a,
                           const int* __restrict__ l_index,
                           const int* __restrict__ u_index,
                           const int* __restrict__ a_index,
                           const int* __restrict__ order,
                           float* __restrict__ out, int T) {
  using S = Smem<B>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the slabs to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + S::kBars;  // [stage] at + 8 * stage
  const uint32_t empty = full + 8 * kStages;
  float* red = reinterpret_cast<float*>(smem + S::kRed);

  // this block's positions in the launch order: blockIdx.x + i * gridDim.x
  const int n_mine = (T - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_mine; ++i) {
        const int st = i % kStages;
        const int p = (int)blockIdx.x + i * (int)gridDim.x;
        const int t = order != nullptr ? order[p] : p;
        const int li = l_index[t], ui = u_index[t], ai = a_index[t];
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        const uint32_t stage = base + st * S::kStage;
        mbar_expect_tx(full + 8 * st, S::kStage);
#pragma unroll
        for (int c = 0; c < S::kSlabs; ++c) {
          const uint32_t slab = c * S::kSlabBytes;
          tma_load(stage + S::kL + slab, &tm_l, full + 8 * st, c * kSlab, li);
          tma_load(stage + S::kU + slab, &tm_u, full + 8 * st, c * kSlab, ui);
          tma_load(stage + S::kA + slab, &tm_a, full + 8 * st, c * kSlab, ai);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 takes rows 0-63 of the product, 2 rows 64-127
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128;  // 0-255 over the consumers
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  // a thread's two rows of A: 64 cw + 16 warp + lane / 4 and 8 more
  const int r0 = kRowsWG * cw + 16 * warp + lane / 4;

  for (int i = 0; i < n_mine; ++i) {
    const int st = i % kStages;
    const uint32_t stage = base + st * S::kStage;
    const uint32_t l_smem = stage + S::kL + cw * kRowsWG * 128;
    const uint32_t u_smem = stage + S::kU;

    float d[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) d[j] = 0.f;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    fence_regs(d);
    wgmma_fence();
    // B / 16 steps of k16: L's step walks 32 bytes within a 64-column slab
    // (SBO: eight rows of 128 bytes); U's step is 16 rows (2048 bytes) of
    // each slab, its slabs the N direction (LBO), its 8-row groups the K
    // direction (SBO)
#pragma unroll
    for (int ks = 0; ks < B / 16; ++ks) {
      const uint32_t step = (ks / 4) * S::kSlabBytes + (ks % 4) * 32;
      mma_lu(d, smem_desc(l_smem + step, 16, 1024),
             smem_desc(u_smem + ks * 2048, S::kSlabBytes, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);

    // epilogue: accumulator element j is row r0 + 8 ((j / 2) % 2) at column
    // 8 (j / 4) + 2 (lane % 4) + j % 2; A's element (r, col) lies in slab
    // col / 64, row r, 16-byte chunk ((col % 64) / 8) ^ (r % 8), as TMA's
    // 128-byte swizzle wrote it. The two columns of a pair are one 4-byte
    // read; a warp's eight rows read eight distinct chunks of their rows.
    const uint8_t* a_tile = smem + (stage - base) + S::kA;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < B / 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const uint32_t pair = *reinterpret_cast<const uint32_t*>(
            a_tile + (c / 8) * S::kSlabBytes + r * 128 +
            (((c % 8) ^ (r & 7)) << 4) + 4 * (lane & 3));
        sum = fmaf(d[4 * c + 2 * h], __uint_as_float(pair << 16), sum);
        sum = fmaf(d[4 * c + 2 * h + 1], __uint_as_float(pair & 0xFFFF0000u),
                   sum);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // L, U and A are read

#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    // the eight consumer warps through shared memory, double-buffered by
    // i % 2, so one barrier a triple suffices
    float* slot = red + (i & 1) * kConsumerWarps;
    if (lane == 0) slot[tid / 32] = sum;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (tid == 0) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) total += slot[w];
      const int p = (int)blockIdx.x + i * (int)gridDim.x;
      out[order != nullptr ? order[p] : p] = total;
    }
  }
}

}  // namespace hopper

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
// (the twin of flash_attention.cu's encode_tiled).
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

// The (B, B, n) tensor map (columns innermost) of an (n, B, B) bf16 tile
// array, read in 64-column x B-row boxes with the 128-byte swizzle. The
// encoder refuses a base that is not 16-byte aligned (the wrapper checks).
template <int B>
int tile_tensor_map(CUtensorMap* map, const void* ptr, int n) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)B, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)B * 2, (cuuint64_t)B * B * 2};
  const cuuint32_t box[3] = {hopper::kSlab, (cuuint32_t)B, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int B>
int launch_wgmma(const void* l, int n_l, const void* u, int n_u,
                 const void* a, int n_a, const int* li, const int* ui,
                 const int* ai, const int* order, float* out, int T,
                 cudaStream_t stream) {
  constexpr size_t bytes = hopper::Smem<B>::kBytes;
  static bool configured = false;  // once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        hopper::masked_spgemm_wgmma_kernel<B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tm_l, tm_u, tm_a;
  int err = tile_tensor_map<B>(&tm_l, l, n_l);
  if (err == 0) err = tile_tensor_map<B>(&tm_u, u, n_u);
  if (err == 0) err = tile_tensor_map<B>(&tm_a, a, n_a);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = T < sms ? T : sms;  // one block an SM
  hopper::masked_spgemm_wgmma_kernel<B><<<grid, hopper::kThreads, bytes, stream>>>(
      tm_l, tm_u, tm_a, li, ui, ai, order, out, T);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 tiles, any 1 <= B <= 256: the CUDA-core kernel, one block a triple.
extern "C" int tc_masked_spgemm(const float* l, const float* u, const float* a,
                                const int* l_index, const int* u_index,
                                const int* a_index, float* out, int T, int B,
                                void* stream) {
  if (T <= 0) return 0;
  if (B < 1 || B > kMaxBlock) return (int)cudaErrorInvalidValue;
  return fp32::launch(l, u, a, l_index, u_index, a_index, out, T, B,
                      static_cast<cudaStream_t>(stream));
}

// bf16 tiles: the tensor-core kernel, one instance for each B of the switch
// (WGMMA_BLOCKS in the wrapper). n_l, n_u and n_a are the arrays' tile
// counts; order is a (T,) launch order or null.
extern "C" int tc_masked_spgemm_wgmma(const void* l, int n_l, const void* u,
                                      int n_u, const void* a, int n_a,
                                      const int* l_index, const int* u_index,
                                      const int* a_index, const int* order,
                                      float* out, int T, int B, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 128:
      return launch_wgmma<128>(l, n_l, u, n_u, a, n_a, l_index, u_index,
                               a_index, order, out, T, s);
  }
  return (int)cudaErrorInvalidValue;
}
