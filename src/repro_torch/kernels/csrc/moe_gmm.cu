// Batched expert matmul (MoE expert compute) for Hopper (sm_90a):
//   out[e] = x[e] @ w[e]   for every expert e,
//   x (E, C, K), w (E, K, N), out (E, C, N), all fp32 or all bf16,
//   contiguous; the product accumulated in fp32 and cast once at the end.
//
// Replaces the Pallas TPU kernel `moe_gmm` (`_gmm_kernel`) of
// src/repro/kernels/moe_gmm.py.  That kernel walks the grid (E, C/bc, N/bn,
// K/bk) with an fp32 VMEM accumulator carried over the sequential K axis;
// here one block owns one (expert, row tile, column tile) and K is a loop
// inside the block, so nothing is carried between blocks.  Any C, K and N:
// the ragged edge of every axis is masked (zero-filled on load, not
// stored), where the Pallas wrapper asserts they divide its 128-blocks.
//
// Bound on an H100 SXM at olmoe-1b-7b's shapes (64 experts, d 2048,
// expert ff 1024, bf16): bytes, at both.
//   * prefill, C = cap = 320: (64, 320, 2048) x (64, 2048, 1024) is 85.9
//     GFLOP over 394.3 MB (w 268.4 MB, x 83.9 MB, out 41.9 MB), 218
//     FLOP/byte, under the card's ridge of ~295: 0.1177 ms at 3.35 TB/s
//     against 0.0869 ms at 989 TFLOP/s.
//   * decode, C = 8: the same weights and 2 MB of x and out, 271.6 MB,
//     0.0811 ms; the tensor cores are almost idle.
// What the design does about it:
//   * Every weight byte is read from device memory about once: the grid's
//     fastest axis is the row tile, so the blocks that share a (expert,
//     column tile) slice of w run together and the later ones find it in
//     the L2.  The row tile follows C: 64 rows, or 16 when C <= 16 (at
//     decode rows 8-15 are masked), not 128 rows of which 120 would be
//     padding.
//   * Tiles of x (BM x 32) and w (32 x 128) are copied into shared memory
//     by 16-byte cp.async, 3 stages deep (4 for the 16-row tile, whose
//     blocks are all weight stream), so that the next tiles are in flight
//     while one is multiplied.
//   * bf16: the tensor cores, mma.sync m16n8k16 with fp32 accumulators (a
//     product of two bf16 values is exact in fp32).  x's fragments come
//     from ldmatrix, w's, stored K-major with N contiguous, from
//     ldmatrix.trans.  Rows of both tiles are padded by 16 bytes, so that
//     the 8 row addresses of each ldmatrix phase hit distinct banks.
//   * fp32: the FMA pipes, never TF32 (which keeps ~3 decimal digits); 64 x
//     64 tiles, a 4 x 4 patch per thread.  Not the served dtype.
//   * wgmma, TMA and a persistent schedule are the way to the bound; this
//     is the simple tensor-core kernel that comes first.
// Numerics: every output element sums its K products in one fixed order
// (k tiles in order, the tensor core's fixed order within a tile), no
// atomics and no split of K across blocks, so two calls are bitwise
// equal.  The build uses --fmad=false; the fp32 path contracts through
// explicit fmaf.
//
// C interface (ctypes): moe_gmm_fwd returns cudaGetLastError() after its
// launch, 0 on success; dtype codes are 0 = fp32, 1 = bf16.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;   // 4 warps
constexpr int kBN = 128;        // columns of a bf16 tile
constexpr int kBK = 32;         // depth of a staged bf16 k tile
constexpr int kPad = 8;         // 16 bytes of bf16 at the end of each row
constexpr int kLdX = kBK + kPad;
constexpr int kLdW = kBN + kPad;

// 16 bytes global -> shared without registers; zero-filled when !valid
// (src then only needs to be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b: one m16n8k16 bf16 tensor-core product with fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 tile shapes: BM rows, 4 warps as WM x WN, each warp owning
// (BM / WM) x (kBN / WN) of the tile as MT x NT mma tiles of 16 x 8.
template <int BM>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int WM = 2, WN = 2, kStages = 3;
};
template <>
struct Tile<16> {
  static constexpr int WM = 1, WN = 4, kStages = 4;
};

// Block (row tile, column tile, expert).  kVec: K and N are multiples of 8
// and x, w 16-byte aligned, so every 16-byte piece of a row lies wholly
// inside or wholly outside the matrix and is copied by cp.async; otherwise
// elements are copied one at a time through registers.
template <int BM, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int C, int K, int N) {
  using TL = Tile<BM>;
  constexpr int kStages = TL::kStages;
  constexpr int kWarpM = BM / TL::WM, kWarpN = kBN / TL::WN;
  constexpr int MT = kWarpM / 16, NT = kWarpN / 8;
  static_assert(TL::WM * TL::WN * 32 == kThreads, "4 warps");
  static_assert(NT % 2 == 0, "w fragments come in pairs of n8 tiles");
  constexpr int kXElems = BM * kLdX, kWElems = kBK * kLdW;
  __shared__ __align__(16) __nv_bfloat16 Xs[kStages][kXElems];
  __shared__ __align__(16) __nv_bfloat16 Ws[kStages][kWElems];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const long long e = blockIdx.z;
  const __nv_bfloat16* xe = x + e * C * K;
  const __nv_bfloat16* we = w + e * K * N;
  const int wm0 = (warp / TL::WN) * kWarpM, wn0 = (warp % TL::WN) * kWarpN;
  const int nk = (K + kBK - 1) / kBK;

  auto stage = [&](int slot, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* xs = Xs[slot];
    __nv_bfloat16* ws = Ws[slot];
    if constexpr (kVec) {
      for (int i = tid; i < BM * kBK / 8; i += kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bool ok = m0 + r < C && k0 + c < K;
        cp_async16(xs + r * kLdX + c,
                   ok ? xe + static_cast<long long>(m0 + r) * K + k0 + c : xe,
                   ok);
      }
      for (int i = tid; i < kBK * kBN / 8; i += kThreads) {
        const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(ws + r * kLdW + c,
                   ok ? we + static_cast<long long>(k0 + r) * N + n0 + c : we,
                   ok);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        xs[r * kLdX + c] =
            m0 + r < C && k0 + c < K
                ? xe[static_cast<long long>(m0 + r) * K + k0 + c]
                : zero;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        ws[r * kLdW + c] =
            k0 + r < K && n0 + c < N
                ? we[static_cast<long long>(k0 + r) * N + n0 + c]
                : zero;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();     // tile kt has landed
    __syncthreads();            // ... for every thread; slot kt-1 is free
    if (kt + kStages - 1 < nk)
      stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_commit();
    const __nv_bfloat16* xs = Xs[kt % kStages];
    const __nv_bfloat16* ws = Ws[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xs + (wm0 + mt * 16 + (lane & 15)) * kLdX + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];          // b0, b1 of n8 tile 2np, then of 2np + 1
        ldmatrix_x4_trans(b, ws + (kk + (lane & 15)) * kLdW + wn0 +
                                 np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // accumulator i of an mma tile: row g (+8 for i >= 2), column 2 t4 + i % 2
  const int g = lane >> 2, t4 = lane & 3;
  __nv_bfloat16* oe = out + e * C * N;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm0 + mt * 16 + g + 8 * half;
      if (r >= C) continue;
      __nv_bfloat16* orow = oe + static_cast<long long>(r) * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = n0 + wn0 + nt * 8 + 2 * t4;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (pairs && c + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < N) orow[c] = __float2bfloat16_rn(v0);
          if (c + 1 < N) orow[c + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// fp32 on the FMA pipes: a 64 x 64 tile of 256 threads, each a 4 x 4 patch
// (rows ty + 16 i, columns tx + 16 j), over k tiles of 16 staged in shared
// memory (x transposed, so that a k step reads one row of each).
constexpr int kF32Tile = 64, kF32K = 16, kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
moe_gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int C, int K, int N) {
  __shared__ float Xt[kF32K][kF32Tile + 1];
  __shared__ float Wt[kF32K][kF32Tile];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kF32Tile, n0 = blockIdx.y * kF32Tile;
  const long long e = blockIdx.z;
  const float* xe = x + e * C * K;
  const float* we = w + e * K * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kF32K) {
    for (int i = tid; i < kF32Tile * kF32K; i += kF32Threads) {
      const int r = i / kF32K, c = i % kF32K;   // x: k fastest
      Xt[c][r] = m0 + r < C && k0 + c < K
                     ? xe[static_cast<long long>(m0 + r) * K + k0 + c]
                     : 0.0f;
      const int kr = i / kF32Tile, nc = i % kF32Tile;   // w: n fastest
      Wt[kr][nc] = k0 + kr < K && n0 + nc < N
                       ? we[static_cast<long long>(k0 + kr) * N + n0 + nc]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = Xt[kk][ty + 16 * i];
        bv[i] = Wt[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* oe = out + e * C * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) oe[static_cast<long long>(r) * N + c] = acc[i][j];
    }
  }
}

template <int BM, bool kVec>
cudaError_t launch_bf16(const void* x, const void* w, void* out, int E, int C,
                        int K, int N, cudaStream_t stream) {
  const dim3 grid((C + BM - 1) / BM, (N + kBN - 1) / kBN, E);
  moe_gmm_bf16_kernel<BM, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, K, N);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch_bf16(const void* x, const void* w, void* out, int E,
                          int C, int K, int N, cudaStream_t stream) {
  return C <= 16 ? launch_bf16<16, kVec>(x, w, out, E, C, K, N, stream)
                 : launch_bf16<64, kVec>(x, w, out, E, C, K, N, stream);
}

}  // namespace

extern "C" {

int moe_gmm_fwd(const void* x, const void* w, void* out, int E, int C, int K,
                int N, int dtype, void* stream) {
  if (E < 0 || C < 0 || K < 0 || N < 0 || E > 65535)
    return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: {
      const dim3 grid((C + kF32Tile - 1) / kF32Tile,
                      (N + kF32Tile - 1) / kF32Tile, E);
      moe_gmm_f32_kernel<<<grid, kF32Threads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), C, K, N);
      return cudaGetLastError();
    }
    case kBF16: {
      const bool vec = K % 8 == 0 && N % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
      return vec ? dispatch_bf16<true>(x, w, out, E, C, K, N, s)
                 : dispatch_bf16<false>(x, w, out, E, C, K, N, s);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
