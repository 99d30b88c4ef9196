// Batched expert matmul (MoE expert compute) for Hopper (sm_90a):
//   out[e] = x[e] @ w[e]   for every expert e,
//   x (E, C, K), w (E, K, N), out (E, C, N), all fp32 or all bf16,
//   contiguous; the product accumulated in fp32 and cast once at the end.
//
// Replaces the Pallas TPU kernel `moe_gmm` (`_gmm_kernel`) of
// src/repro/kernels/moe_gmm.py.  That kernel walks the grid (E, C/bc, N/bn,
// K/bk) with an fp32 VMEM accumulator carried over the sequential K axis;
// here a block owns whole output tiles and K is a loop inside the block, so
// nothing is carried between blocks.  Any C, K and N.
//
// Bound on an H100 SXM at olmoe-1b-7b's shapes (64 experts, d 2048,
// expert ff 1024, bf16): bytes, at both.
//   * prefill, C = cap = 320: (64, 320, 2048) x (64, 2048, 1024) is 85.9
//     GFLOP over 394.3 MB (w 268.4 MB, x 83.9 MB, out 41.9 MB), 218
//     FLOP/byte, under the card's ridge of ~295: 0.1177 ms at 3.35 TB/s
//     against 0.0869 ms at 989 TFLOP/s -- close enough that the tensor
//     cores must run near their peak rate as well.
//   * decode, C = 8: the same weights and 2 MB of x and out, 271.6 MB,
//     0.0811 ms; the tensor cores are almost idle.
//
// Four routes, which the wrapper picks from dtype, shape and alignment:
//   * bf16 with K and N multiples of 8 (K > 0) and x, w 16-byte aligned --
//     what TMA needs of base pointers and strides -- on wgmma fed by TMA
//     (helpers in hopper.cuh), one kernel template in two instances chosen
//     by C alone:
//       - kWgmma (C > 8): the prefill tile, 128 columns of w x 160 rows of x;
//       - kWgmmaDecode (C <= 8): the decode tile, a weight stream.
//   * kMmaSync: other bf16 calls (ragged K or N, unaligned views, K = 0),
//     on mma.sync m16n8k16, masking every ragged edge.
//   * kFma: fp32, on the FMA pipes, never TF32 (which keeps ~3 decimal
//     digits); not the served dtype.
//
// The wgmma kernel computes the swapped product out^T = w^T . x^T:
//   * wgmma m64nBCk16 with A = a 64-column slice of w (N contiguous: an
//     MN-major operand, the transpose bit) and B = BC rows of x (K-major),
//     so the rows of x are wgmma's N, which is any multiple of 8 up to 256,
//     where as A they would come in 64-row slabs.  C = 320 (olmoe's cap at
//     a 2048-token prefill) is two tiles of BC = 160: nothing is padded,
//     where 128-row tiles of x would compute 384 rows (a 64-row slab of the
//     third wholly past C, and a warpgroup idle while its partner works)
//     and 64-row tiles would read every w tile five times from the L2.  At
//     decode BC = 8, the 8 slots: nothing is spent on the 56 empty rows a
//     64-row tile of x would compute.
//   * TMA maps x as the 4-D tensor (K, C, E, 1), w as (N, K, E, 1) and out
//     as (N, C, E, 1), so a box that runs past C, K or N inside one expert
//     arrives zero-filled and never reads the next expert, and a stored box
//     is clipped at C and N: no masking in the kernel.  Boxes are 64
//     columns (128-byte rows, the 128-byte swizzle): x (64 k, BC rows), w
//     (64 n, 64 k), out (64 n, BC rows).
//   * Persistent: one block per SM walks the work items (expert, column
//     tile of w, row tile of x), the row tile fastest, with a stride of the
//     grid, so the blocks that share an expert's w slice run side by side
//     and read it from HBM once (the others find it in the L2), and x[e] is
//     read by that expert's column tiles in the same window.
//   * Warp-specialised: one thread of a producer warpgroup issues every TMA
//     load into a ring of stages (k = 64 each), each with a full (TMA
//     bytes) and an empty (consumer warps) mbarrier; the producer runs
//     ahead across items, so the next item's first stages load during the
//     current item's last products and its epilogue.  The consumers keep
//     one k-stage of products in flight (wgmma wait 1) and release a stage
//     when its products have completed.
//   * Epilogue: each consumer warpgroup rounds its fp32 sums to bf16 into
//     shared memory in the layout of a swizzled out box and one thread
//     stores the box by TMA, which runs on while the next item's products
//     start; stores straight from registers, 4 bytes a thread at scattered
//     rows, kept the tensor cores idle while they drained.
//   * Prefill tile: 128 columns of w x 160 rows of x.  Two consumer
//     warpgroups share each item ("cooperative"), each one 64-column slice
//     of w against all 160 rows (one m64n160k16 product a k-step, 80 fp32
//     accumulators a thread, within the 168 registers a thread of a
//     384-thread block has).  Two warpgroups taking whole 128 x 160 items
//     in turn ("ping-pong", so one's epilogue runs under the other's
//     products) need 160 accumulators: with a producer warpgroup that
//     spills, and without one (the consumers issuing the loads) a single
//     warpgroup's products did not keep the tensor cores busy.  5 stages
//     of 36 KB (4 left the loads exposed) and two 20 KB out boxes.
//   * Decode tile: 256 columns of w (four slices) x the 8 rows of x, four
//     m64n8k16 products a k-step, one consumer warpgroup; 6 stages of 33
//     KB, about 200 KB of weights in flight on each SM to keep HBM busy.
// The mma.sync kernel (kMmaSync): one block per (row tile, 128-column
// tile, expert); tiles of x (BM x 32) and w (32 x 128) staged element by
// element (its calls have ragged rows or unaligned pointers) into two
// buffers; x's fragments from ldmatrix, w's from ldmatrix.trans, rows
// padded by 16 bytes against bank conflicts.
// Numerics: every output element sums its K products in one fixed order
// (k tiles in order, the tensor core's fixed order within a tile), no
// atomics and no split of K across blocks, so two calls are bitwise
// equal.  The build uses --fmad=false; the fp32 path contracts through
// explicit fmaf.
//
// C interface (ctypes): moe_gmm_fwd returns cudaGetLastError() after its
// launch, 0 on success, 1000 + a CUresult when the driver refuses a tensor
// map, cudaErrorInvalidValue for a route the operands do not meet.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

// Routes of the C interface, chosen by the wrapper from dtype, shape and
// alignment alone (repro_torch.kernels.moe_gmm.route).
enum Route { kFma = 0, kMmaSync = 1, kWgmma = 2, kWgmmaDecode = 3 };

constexpr int kThreads = 128;   // 4 warps
constexpr int kBN = 128;        // columns of a bf16 tile
constexpr int kBK = 32;         // depth of a staged bf16 k tile
constexpr int kMmaStages = 2;   // k tiles staged by the mma.sync kernel
constexpr int kPad = 8;         // 16 bytes of bf16 at the end of each row
constexpr int kLdX = kBK + kPad;
constexpr int kLdW = kBN + kPad;

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
  static constexpr int WM = 2, WN = 2;
};
template <>
struct Tile<16> {
  static constexpr int WM = 1, WN = 4;
};

// Block (row tile, column tile, expert); elements are copied one at a
// time through registers, zero past C, K and N.
template <int BM>
__global__ void __launch_bounds__(kThreads)
moe_gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int C, int K, int N) {
  using TL = Tile<BM>;
  constexpr int kWarpM = BM / TL::WM, kWarpN = kBN / TL::WN;
  constexpr int MT = kWarpM / 16, NT = kWarpN / 8;
  static_assert(TL::WM * TL::WN * 32 == kThreads, "4 warps");
  static_assert(NT % 2 == 0, "w fragments come in pairs of n8 tiles");
  constexpr int kXElems = BM * kLdX, kWElems = kBK * kLdW;
  __shared__ __align__(16) __nv_bfloat16 Xs[kMmaStages][kXElems];
  __shared__ __align__(16) __nv_bfloat16 Ws[kMmaStages][kWElems];

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
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  if (nk > 0) stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();            // tile kt is staged; slot kt-1 is free
    if (kt + 1 < nk) stage((kt + 1) % kMmaStages, kt + 1);
    const __nv_bfloat16* xs = Xs[kt % kMmaStages];
    const __nv_bfloat16* ws = Ws[kt % kMmaStages];
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

template <int BM>
cudaError_t launch_bf16(const void* x, const void* w, void* out, int E, int C,
                        int K, int N, cudaStream_t stream) {
  const dim3 grid((C + BM - 1) / BM, (N + kBN - 1) / kBN, E);
  moe_gmm_bf16_kernel<BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, K, N);
  return cudaGetLastError();
}



// ---- bf16 on wgmma, fed by TMA (kWgmma, kWgmmaDecode) ----------------------

namespace tma {

constexpr int kBK = 64;                 // k per stage: one 128-byte row
constexpr int kRowBytes = 128;          // = the swizzle
constexpr int kSlice = 64;              // w columns (out^T rows) per box
constexpr int kWSlice = kBK * kRowBytes;        // 8 KB
constexpr int kDecodeRows = 8;          // C <= 8 takes the decode tile
constexpr int kMaxDevices = 64;

// The two tiles of out^T = w^T . x^T: kConsumers warpgroups, each owning
// kWgSlices 64-column slices of w (64 rows of out^T each, one wgmma
// m64nBCk16 per slice and k-step), against the same BC rows of x.
template <bool kDecode>
struct Shape {
  static constexpr int kBC = kDecode ? kDecodeRows : 160;    // x rows
  static constexpr int kConsumers = kDecode ? 1 : 2;
  static constexpr int kWgSlices = kDecode ? 4 : 1;
  static constexpr int kBN = kSlice * kConsumers * kWgSlices;   // w cols
  static constexpr int kThreads = 128 * (kConsumers + 1);   // + producer
  static constexpr int kStages = kDecode ? 6 : 5;
  static constexpr int kXBytes = kBC * kRowBytes;
  static constexpr int kStageBytes = kXBytes + (kBN / kSlice) * kWSlice;
  // one out box (64 columns x BC rows) a slice, staged for the TMA store
  static constexpr int kOutSlice = kBC * kRowBytes;
  static constexpr int kOutBytes = kConsumers * kWgSlices * kOutSlice;
  // 1024 bytes of slack to align the ring, the ring, the out boxes, full
  // and empty a stage
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kOutBytes + 16 * kStages;
  static_assert(kXBytes % 1024 == 0 && kStageBytes % 1024 == 0,
                "tile bases stay 1024-byte aligned");
};

// Work item w of n_ct row tiles (of x) and n_nt column tiles (of w) an
// expert: the row tile fastest, then the column tile, then the expert.
struct Item {
  int e, nt, ct;
};

__device__ __forceinline__ Item item_of(int w, int n_ct, int n_nt) {
  return {w / (n_ct * n_nt), (w / n_ct) % n_nt, w % n_ct};
}

template <bool kDecode>
__global__ void __launch_bounds__(Shape<kDecode>::kThreads, 1)
moe_gmm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap omap, int C, int K,
                   int N, int n_ct, int n_nt, int n_items) {
  using S = Shape<kDecode>;
  constexpr int kBC = S::kBC;
  extern __shared__ uint8_t smem_tc[];
  uint8_t* ring = smem_tc + ((1024 - (hopper::smem_addr(smem_tc) & 1023)) &
                             1023);   // [stage]{x tile, w slices}
  uint8_t* obox = ring + S::kStages * S::kStageBytes;   // [wg][slice]
  uint64_t* full = reinterpret_cast<uint64_t*>(obox + S::kOutBytes);
  uint64_t* empty = full + S::kStages;
  const int nk = (K + kBK - 1) / kBK;
  const int G = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * S::kConsumers);   // lane 0 a warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * S::kConsumers) {
    // ---- producer: one thread keeps the ring full, across items ----
    if (threadIdx.x == 128 * S::kConsumers) {
      hopper::tma_prefetch(&xmap);
      hopper::tma_prefetch(&wmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x; w < n_items; w += G) {
        const Item it = item_of(w, n_ct, n_nt);
        for (int kt = 0; kt < nk; ++kt) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&full[stage], S::kStageBytes);
          uint8_t* xs = ring + stage * S::kStageBytes;
          uint8_t* ws = xs + S::kXBytes;
          hopper::tma_load_4d(xs, &xmap, &full[stage], kt * kBK,
                              it.ct * kBC, it.e, 0);
#pragma unroll
          for (int j = 0; j < S::kBN / kSlice; ++j)
            hopper::tma_load_4d(ws + j * kWSlice, &wmap, &full[stage],
                                it.nt * S::kBN + j * kSlice, kt * kBK, it.e,
                                0);
          if (++stage == S::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns w slices [wg kWgSlices, ...) of every
  // item ----
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) hopper::tma_prefetch(&omap);
  // acc[s]: out^T rows 64 (wg kWgSlices + s) + 16 warp + lane / 4 + 8 ((i
  // / 2) % 2) of the item, columns (x rows) 8 (i / 4) + 2 (lane % 4) + i %
  // 2.  In an out box (64 columns x BC rows of out, laid out as the
  // 128-byte swizzle lays out a box: row q at 128 q, its 16-byte chunk c
  // at (c ^ q % 8)), element i lies at 1024 (i / 4) + box_off[i % 4].
  uint32_t box_off[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = 16 * warp + lane / 4 + 8 * (u / 2);
    const int q = 2 * (lane % 4) + u % 2;
    box_off[u] = q * kRowBytes + (((n / 8) ^ q) * 16) + (n % 8) * 2;
  }
  float acc[S::kWgSlices][kBC / 2];
#pragma unroll
  for (int s = 0; s < S::kWgSlices; ++s)
#pragma unroll
    for (int i = 0; i < kBC / 2; ++i) acc[s][i] = 0.0f;
  uint8_t* my_box = obox + wg * S::kWgSlices * S::kOutSlice;
  int stage = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x; w < n_items; w += G) {
    const Item it = item_of(w, n_ct, n_nt);
    int prev = -1;              // the stage whose products are in flight
    for (int kt = 0; kt < nk; ++kt) {
      hopper::mbar_wait(&full[stage], phase);
      const uint32_t xs = hopper::smem_addr(ring + stage * S::kStageBytes);
      const uint32_t ws = xs + S::kXBytes + wg * S::kWgSlices * kWSlice;
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
        for (int s = 0; s < S::kWgSlices; ++s)
          hopper::wgmma_ss_ta<kBC>(
              acc[s],
              hopper::smem_desc<kRowBytes>(ws + s * kWSlice + j * 16 *
                                           kRowBytes, kWSlice,
                                           8 * kRowBytes),
              hopper::smem_desc<kRowBytes>(xs + 32 * j, 16, 8 * kRowBytes),
              kt > 0 || j > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();    // the previous stage's products are done
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < S::kWgSlices; ++s) hopper::fence_regs(acc[s]);
    if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);

    // epilogue: one bf16 rounding of each fp32 sum into this warpgroup's
    // out boxes once its previous stores have read them, then one TMA
    // store a box, which clips at C and N and runs on while the next
    // item's products start
    if (tid == 0) hopper::bulk_wait_read<0>();
    hopper::named_barrier(1 + wg, 128);
#pragma unroll
    for (int s = 0; s < S::kWgSlices; ++s)
#pragma unroll
      for (int i = 0; i < kBC / 2; ++i)
        *reinterpret_cast<__nv_bfloat16*>(my_box + s * S::kOutSlice +
                                          1024 * (i / 4) + box_off[i % 4]) =
            __float2bfloat16_rn(acc[s][i]);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S::kWgSlices; ++s) {
        const int n0 = it.nt * S::kBN + kSlice * (wg * S::kWgSlices + s);
        if (n0 < N)
          hopper::tma_store_4d(&omap, my_box + s * S::kOutSlice, n0,
                               it.ct * kBC, it.e, 0);
      }
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();
}

// The SM count of the current device, asked once per device.
int sm_count() {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int count = dev < kMaxDevices ? sms[dev] : 0;
  if (count == 0) {
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return 0;
    if (dev < kMaxDevices) sms[dev] = count;
  }
  return count;
}

template <bool kDecode>
int launch(const void* x, const void* w, void* out, int E, int C, int K,
           int N, cudaStream_t stream) {
  using S = Shape<kDecode>;
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 b = sizeof(__nv_bfloat16);
  CUtensorMap xm, wm, om;
  const u64 xdims[4] = {u64(K), u64(C), u64(E), 1};
  const u64 xstrides[3] = {u64(K) * b, u64(C) * K * b, u64(E) * C * K * b};
  const u32 xbox[4] = {u32(kBK), u32(S::kBC), 1, 1};
  const u64 wdims[4] = {u64(N), u64(K), u64(E), 1};
  const u64 wstrides[3] = {u64(N) * b, u64(K) * N * b, u64(E) * K * N * b};
  const u32 wbox[4] = {u32(kSlice), u32(kBK), 1, 1};
  const u64 odims[4] = {u64(N), u64(C), u64(E), 1};
  const u64 ostrides[3] = {u64(N) * b, u64(C) * N * b, u64(E) * C * N * b};
  const u32 obox[4] = {u32(kSlice), u32(S::kBC), 1, 1};
  int err = hopper::encode_bf16_4d(&xm, x, xdims, xstrides, xbox, kRowBytes);
  if (err == 0)
    err = hopper::encode_bf16_4d(&wm, w, wdims, wstrides, wbox, kRowBytes);
  if (err == 0)
    err = hopper::encode_bf16_4d(&om, out, odims, ostrides, obox, kRowBytes);
  if (err != 0) return err;

  const long long n_ct = (C + S::kBC - 1) / S::kBC;
  const long long n_nt = (N + S::kBN - 1) / S::kBN;
  const long long n_items = E * n_ct * n_nt;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t set = cudaFuncSetAttribute(
      moe_gmm_tma_kernel<kDecode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (set != cudaSuccess) return set;
  const int n_sm = sm_count();          // one block per SM, persistent
  if (n_sm <= 0) return cudaErrorInvalidDevice;
  const int G = n_items < n_sm ? static_cast<int>(n_items) : n_sm;
  moe_gmm_tma_kernel<kDecode><<<G, S::kThreads, S::kSmem, stream>>>(
      xm, wm, om, C, K, N, static_cast<int>(n_ct), static_cast<int>(n_nt),
      static_cast<int>(n_items));
  return cudaGetLastError();
}

}  // namespace tma

}  // namespace

extern "C" {

// route: kFma (fp32), kMmaSync, kWgmma or kWgmmaDecode (bf16).  The wgmma
// routes need K > 0 and K, N multiples of 8, x and w 16-byte aligned, and
// kWgmmaDecode C <= 8; a call that does not meet its route's needs is
// refused (cudaErrorInvalidValue), never run on another route.
int moe_gmm_fwd(const void* x, const void* w, void* out, int E, int C, int K,
                int N, int route, void* stream) {
  if (E < 0 || C < 0 || K < 0 || N < 0 || E > 65535)
    return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  switch (route) {
    case kFma: {
      const dim3 grid((C + kF32Tile - 1) / kF32Tile,
                      (N + kF32Tile - 1) / kF32Tile, E);
      moe_gmm_f32_kernel<<<grid, kF32Threads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), C, K, N);
      return cudaGetLastError();
    }
    case kMmaSync:
      return C <= 16 ? launch_bf16<16>(x, w, out, E, C, K, N, s)
                     : launch_bf16<64>(x, w, out, E, C, K, N, s);
    case kWgmma:
    case kWgmmaDecode: {
      if (K == 0 || K % 8 != 0 || N % 8 != 0 || !aligned)
        return cudaErrorInvalidValue;
      if (route == kWgmmaDecode) {
        if (C > tma::kDecodeRows) return cudaErrorInvalidValue;
        return tma::launch<true>(x, w, out, E, C, K, N, s);
      }
      return tma::launch<false>(x, w, out, E, C, K, N, s);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
