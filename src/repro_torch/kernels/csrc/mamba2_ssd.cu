// Mamba2 SSD (state space dual) chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mamba2_ssd` (`_ssd_kernel`) of
// src/repro/kernels/mamba2_ssd.py.  Per (batch, head) and chunk of length l:
//   xd = x * dt,  dA = dt * a,  cums = cumsum(dA)
//   y  = ((C B^T) o L) xd + exp(cums) o (C state^T),
//        L[i, j] = exp(cums_i - cums_j) for i >= j, else 0
//   state <- exp(cums_l) state + xd^T (B o exp(cums_l - cums))
//   x (b, s, h, p), dt (b, s, h), B and C (b, s, n), all fp32 or all bf16;
//   A (h,) fp32; optional initial state (b, h, p, n) fp32 (zeros if NULL);
//   y (b, s, h, p) in x's dtype, final state (b, h, p, n) fp32; contiguous.
//
// Bound on an H100 SXM: bytes.  zamba2-2.7b's prefill call (s = 2048, 80
// heads, p = n = 64, chunk 256, bf16) moves 44.1 MB (x and y 21 MB each)
// -- 0.0132 ms at 3.35 TB/s -- and its lower-triangle work is about 8 GFLOP,
// 0.0081 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Two routes, which the wrapper picks from dtype, shape and alignment
// (repro_torch.kernels.mamba2_ssd.route):
//   * kWgmma: bf16 with p in {64, 128}, n a multiple of 16 up to 128, a
//     chunk that is a multiple of 64 (up to 256) and x, B, C, y 16-byte
//     aligned -- the tensor cores, fed by TMA (helpers in hopper.cuh);
//   * kFma: everything else (fp32, and the other bf16 shapes) -- one block
//     per (batch, head, p-tile) walking the chunks in order, on the FMA
//     pipes (mamba2_ssd_kernel below, unchanged since it was first written).
//
// kWgmma is the chunk-parallel SSD of the Mamba2 paper (arXiv:2405.21060
// section 6) in three launches, not the Pallas kernel's grid-carried scan:
// Hopper has no sequential grid axis, and blocks that carry the state
// through the chunks (kFma) leave the SMs with long serial chains.
//   1. mamba2_ssd_chunk_state_kernel, one block per (b, chunk, head), a
//      warpgroup per 64 rows p, all chunks at once: TMA brings x's (l x p) and
//      B's (l x n) tiles; the cumsum of dA; w_j dt_j = exp(cums_l - cums_j)
//      dt_j; the chunk's own state Sc = (x o w o dt)^T . B on wgmma, A from
//      registers (x read transposed by ldmatrix.trans, scaled, split into bf16
//      hi + lo), B straight from its tile (n contiguous: the transpose bit).
//      Sc goes to fp32 scratch (b, nc, h, p, n), the cums to (b, nc, h, l).
//   2. mamba2_ssd_state_pass_kernel, one thread per state element (b, h,
//      p, n), in fp32 in chunk order: the state entering chunk c is stored
//      as bf16 hi and lo, then state <- exp(cums_c,l) state + Sc[c], from
//      the initial state; the last is the final state.
//   3. mamba2_ssd_chunk_out_kernel, one block per (b, chunk, head), launched as
//      a programmatic dependent of pass 2, so its loads of C, B and x (which
//      pass 2 does not write) overlap pass 2; only the carried state waits for
//      it (griddepcontrol.wait).  C comes one 64-row slab at a time into a slot
//      per warpgroup, B and x a slab each, each load on its own mbarrier in the
//      order of first use.  The warpgroups take the slabs largest first, so
//      both get the same number of lower-triangle tiles at l = 256 (4 + 1, 3 +
//      2); a warpgroup's second C slab loads while it finishes its first.  Per
//      slab: acc = exp(cums_i) C . (hi + lo)^T (wgmma, both operands K-major);
//      per tile at or below the diagonal S = C . B^T (wgmma), P = S o L o dt_j
//      in registers (L by ex2.approx, masked on the diagonal tile) as bf16 hi +
//      lo A fragments of acc += P . x (wgmma with A from registers, x
//      N-contiguous through the transpose bit) -- flash_attention.cu's pattern,
//      dt folded into P so x goes in unscaled.  y leaves from registers in
//      bf16, each row's 16-byte pieces gathered by a transpose within each quad
//      of lanes.
//   Shared memory: 98 KB a block at zamba2's shape (two blocks an SM), 226
//   KB at p = n = 128, l = 256.  C . B^T is still computed once per head:
//   B and C are shared by all heads, but it is a third of pass 3's
//   products, and sharing it would need two heads' accumulators a thread.
// Numerics of kWgmma: every product sums in fp32, and every tensor-core
// operand that the plain version keeps in fp32 -- the chunk-state operand
// x o w o dt, the carried state, P -- goes in as a bf16 pair hi = bf16(v),
// lo = bf16(v - hi), two products into one accumulator (~2^-17 relative).
// Rounded once, the chunk-state operand moves the final state by 2.8e-3 of
// its largest value at zamba2's shape, above the 1e-3 gate decode relies
// on, and P and the carried state put y outside its elementwise 2e-2 gate
// (PERF.md section 6, "what was hard").
//
// kFma: fp32 everywhere inside, as the Pallas kernel and the plain version;
// p and n in {8, 16, 32, 64, 128}; any chunk from 1 to 256 (a ragged last
// chunk is masked, though the wrapper keeps the JAX contract s % chunk ==
// 0).  What the design does:
//   * Parallelism.  Rows of the state and columns of y for different p are
//     independent; only C B^T, L and the cumsums are shared across p.  So
//     one block of 256 threads owns (batch, head, p-tile of 32 -- p itself
//     when p is 8 or 16): 160 blocks for zamba2's 80 heads of p = 64, one
//     wave at two blocks per SM.  Each block walks the chunks in a loop
//     with the state of its p-tile in shared memory: Hopper has no
//     sequential grid axis.  Every block recomputes C B^T for its chunk (B
//     and C are shared by all heads): the price of the parallelism, paid on
//     the FMA pipes, and the first thing a faster version would share.
//     (Tiles of 16 -- 320 blocks, two waves, twice the recompute -- took
//     1.74 ms at zamba2's shape on an H100 SXM at 700 W, tiles of 32 1.07.)
//   * Shared memory.  At l = 256 the (l x l) fp32 C B^T o L would take 256
//     KB, more than a block can have.  The chunk is cut into row blocks and
//     column blocks of 64: for each row block the C rows are staged
//     (transposed, fp32), and for each column block at or below the
//     diagonal the B rows; tiles above the diagonal, where L is 0, are
//     never computed.  The (64 x 64) tile of C B^T o L goes through shared
//     memory into the product with xd, which stays staged for the whole
//     chunk (l x p-tile).  The last row block visits every column block, so
//     the state update reads the B tiles staged for it.  About 97 KB at
//     n = 64, 140 KB at n = 128, raised per launch above the 48 KB default.
//   * Register tiling.  Each thread owns a 4 x 4 patch of the C B^T tile
//     (two 16-byte shared loads per 16 FMAs), a 2 x 4 patch of y (1 x 4 or
//     1 x 2 for the narrower p-tiles), and one column p x n p-tile / 256
//     rows of the state update, so that xd * exp(cums_l - cums) is
//     computed once per step for all of them.
// Numerics: fp32 everywhere inside.  The cumsum is a fixed-order block scan
// (shuffles within a warp, then the warp totals added in warp order), no
// atomics anywhere, so two calls are bitwise equal.  The build uses
// --fmad=false: the dot products (C B^T, the tile times xd, C state^T and
// the state update's sum over the chunk) contract on purpose, through
// explicit fmaf; every other product and sum rounds on its own, as the
// plain version's elementwise operations do.  expf (not __expf).
//
// Both routes are deterministic: no atomics, no split of a sum across
// blocks, fixed orders, so two calls are bitwise equal.
//
// C interface (ctypes): mamba2_ssd_fwd returns cudaGetLastError() after
// its launches, 0 on success, 1000 + a CUresult when the driver refuses a
// tensor map; dtype codes are 0 = fp32, 1 = bf16, route codes 0 = kFma, 1 =
// kWgmma.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRB = 64;         // rows (and columns) of a chunk tile
constexpr int kMaxChunk = 256;  // one scan element per thread
constexpr int kPad = 4;         // keeps transposed rows 16-byte aligned
constexpr int kStride = kRB + kPad;
static_assert(kMaxChunk == kThreads, "the scan gives each thread one step");
static_assert(kRB * kRB == 16 * kThreads, "4 x 4 tile patch per thread");

enum DType { kF32 = 0, kBF16 = 1 };
// Routes of the C interface, chosen by the wrapper from dtype, shape and
// alignment alone (repro_torch.kernels.mamba2_ssd.route).
enum Route { kFma = 0, kWgmma = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N consecutive floats of shared memory at p (aligned to N's vector width).
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      float4 t = *reinterpret_cast<const float4*>(p + j);
      out[j] = t.x; out[j + 1] = t.y; out[j + 2] = t.z; out[j + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      float2 t = *reinterpret_cast<const float2*>(p + j);
      out[j] = t.x; out[j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = p[j];
  }
}

constexpr int smem_floats(int N, int PT) {
  return 2 * N * kStride        // Ct, Bt
         + kRB * kStride        // Ss
         + kMaxChunk * PT       // xd
         + N * PT               // stT
         + 4 * kMaxChunk        // dts, cums, ec, w
         + kThreads / 32;       // warp totals of the scan
}

// Block x: ((b * H + h) * (P / PT) + p-tile).
template <typename T, int N, int PT>
__global__ void __launch_bounds__(kThreads)
mamba2_ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ init,
                  T* __restrict__ y, float* __restrict__ fin, int S, int H,
                  int P, int chunk) {
  // y patch of a thread: RY rows x QP columns of the (kRB x PT) row block
  constexpr int RY = PT == 32 ? 2 : 1;
  constexpr int QP = PT / (4 * RY);
  constexpr int NCG = PT / QP;                          // column groups
  static_assert(kRB / RY * NCG == kThreads, "one y patch per thread");
  // state entries of a thread: one column p, NS rows k (256 % PT == 0)
  constexpr int NS = (PT * N + kThreads - 1) / kThreads;
  static_assert(kThreads % PT == 0, "a thread keeps its state column");
  extern __shared__ float4 smem_raw[];
  float* Ct = reinterpret_cast<float*>(smem_raw);  // [N][kStride] C^T rows
  float* Bt = Ct + N * kStride;                    // [N][kStride] B^T cols
  float* Ss = Bt + N * kStride;                    // [kRB j][kStride i]
  float* xd = Ss + kRB * kStride;                  // [kMaxChunk][PT]
  float* stT = xd + kMaxChunk * PT;                // [N][PT] state^T
  float* dts = stT + N * PT;                       // [kMaxChunk] dt
  float* cums = dts + kMaxChunk;                   // cumsum(dt * a)
  float* ec = cums + kMaxChunk;                    // exp(cums)
  float* w = ec + kMaxChunk;                       // exp(cums_l - cums)
  float* wsum = w + kMaxChunk;                     // [kThreads / 32]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_pt = P / PT;
  const int p0 = (blockIdx.x % n_pt) * PT;
  const int h = (blockIdx.x / n_pt) % H;
  const int b = blockIdx.x / (n_pt * H);
  const float a = A[h];
  const long long st_base = ((long long)b * H + h) * P;   // row of (b,h,0)

  const int rg = tid >> 4, cg = tid & 15;   // tile patch: rows 4rg, cols 4cg
  const int ai = (tid / NCG) * RY;          // first y row of this thread
  const int pc = (tid % NCG) * QP;          // its first y column
  const int sp = tid % PT;                  // its state column
  const int sk = tid / PT;                  // its first state row

  for (int idx = tid; idx < PT * N; idx += kThreads) {
    const int p = idx / N, k = idx % N;     // k fastest: coalesced reads
    stT[k * PT + p] = init ? init[(st_base + p0 + p) * N + k] : 0.0f;
  }

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int l = min(chunk, S - c0);
    const int nb = (l + kRB - 1) / kRB;
    __syncthreads();            // the previous chunk's readers are done

    // dt, and the inclusive scan of dA = dt * a over the chunk
    float v = 0.0f, dtv = 0.0f;
    if (tid < l) {
      dtv = to_float(dt[((long long)b * S + c0 + tid) * H + h]);
      v = dtv * a;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    dts[tid] = dtv;
    __syncthreads();
    float pre = 0.0f;
    for (int k = 0; k < warp; ++k) pre += wsum[k];      // fixed order
    v += pre;
    cums[tid] = v;
    __syncthreads();
    const float cl = cums[l - 1];
    ec[tid] = tid < l ? expf(v) : 0.0f;
    w[tid] = tid < l ? expf(cl - v) : 0.0f;
    for (int idx = tid; idx < nb * kRB * PT; idx += kThreads) {
      const int j = idx / PT, p = idx % PT;
      xd[idx] = j < l ? to_float(x[(((long long)b * S + c0 + j) * H + h) *
                                       P + p0 + p]) * dts[j]
                      : 0.0f;
    }

    float st_acc[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) st_acc[q] = 0.0f;

    for (int rb = 0; rb < nb; ++rb) {
      const int i0 = rb * kRB;
      for (int idx = tid; idx < kRB * N; idx += kThreads) {
        const int i = idx / N, k = idx % N;
        Ct[k * kStride + i] =
            i0 + i < l ? to_float(Cm[((long long)b * S + c0 + i0 + i) * N + k])
                       : 0.0f;
      }
      __syncthreads();

      // the carried state's term: exp(cums_i) * (C_i . state_p)
      float acc[RY][QP];
      {
        float t[RY][QP];
#pragma unroll
        for (int r = 0; r < RY; ++r)
#pragma unroll
          for (int q = 0; q < QP; ++q) t[r][q] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[RY], sv[QP];
          load_n<RY>(Ct + k * kStride + ai, cv);
          load_n<QP>(stT + k * PT + pc, sv);
#pragma unroll
          for (int r = 0; r < RY; ++r)
#pragma unroll
            for (int q = 0; q < QP; ++q) t[r][q] = fmaf(cv[r], sv[q], t[r][q]);
        }
#pragma unroll
        for (int r = 0; r < RY; ++r) {
          const float e = i0 + ai + r < l ? ec[i0 + ai + r] : 0.0f;
#pragma unroll
          for (int q = 0; q < QP; ++q) acc[r][q] = e * t[r][q];
        }
      }

      for (int cb = 0; cb <= rb; ++cb) {
        const int j0 = cb * kRB;
        for (int idx = tid; idx < kRB * N; idx += kThreads) {
          const int j = idx / N, k = idx % N;
          Bt[k * kStride + j] =
              j0 + j < l
                  ? to_float(Bm[((long long)b * S + c0 + j0 + j) * N + k])
                  : 0.0f;
        }
        __syncthreads();

        // this thread's 4 x 4 patch of C B^T, times L, into Ss
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float av[4], bv[4];
          load_n<4>(Ct + k * kStride + 4 * rg, av);
          load_n<4>(Bt + k * kStride + 4 * cg, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i0 + 4 * rg + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j0 + 4 * cg + j;
            const float L =
                row < l && col <= row ? expf(cums[row] - cums[col]) : 0.0f;
            Ss[(4 * cg + j) * kStride + 4 * rg + i] = s[i][j] * L;
          }
        }

        // the last row block visits every column block: the state update
        // sums xd_j,p * w_j * B_j,k over this block's j, for this thread's
        // column p and rows k = sk + q * (kThreads / PT)
        if (rb == nb - 1) {
          for (int j = 0; j < kRB; ++j) {
            const float xw = xd[(j0 + j) * PT + sp] * w[j0 + j];
#pragma unroll
            for (int q = 0; q < NS; ++q) {
              const int k = sk + q * (kThreads / PT);
              if (k < N)
                st_acc[q] = fmaf(xw, Bt[k * kStride + j], st_acc[q]);
            }
          }
        }
        __syncthreads();

        // y rows of this row block += (C B^T o L) tile . xd of this block
#pragma unroll 4
        for (int j = 0; j < kRB; ++j) {
          float sv[RY], xv[QP];
          load_n<RY>(Ss + j * kStride + ai, sv);
          load_n<QP>(xd + (j0 + j) * PT + pc, xv);
#pragma unroll
          for (int r = 0; r < RY; ++r)
#pragma unroll
            for (int q = 0; q < QP; ++q) acc[r][q] = fmaf(sv[r], xv[q], acc[r][q]);
        }
        __syncthreads();        // Bt and Ss are restaged next
      }

#pragma unroll
      for (int r = 0; r < RY; ++r) {
        if (i0 + ai + r < l) {
          T* dst = y + (((long long)b * S + c0 + i0 + ai + r) * H + h) * P +
                   p0 + pc;
#pragma unroll
          for (int q = 0; q < QP; ++q) store(dst + q, acc[r][q]);
        }
      }
    }

    // state <- exp(cums_l) * state + the chunk's contribution (every
    // reader of the old state passed a barrier since its read)
    const float decay = expf(cl);
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int k = sk + q * (kThreads / PT);
      if (k < N) stT[k * PT + sp] = stT[k * PT + sp] * decay + st_acc[q];
    }
  }

  __syncthreads();
  for (int idx = tid; idx < PT * N; idx += kThreads) {
    const int p = idx / N, k = idx % N;
    fin[(st_base + p0 + p) * N + k] = stT[k * PT + p];
  }
}

template <typename T, int N, int PT>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* fin, int Bsz,
           int S, int H, int P, int chunk, cudaStream_t stream) {
  const int smem = smem_floats(N, PT) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_ssd_kernel<T, N, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Bsz * H * (P / PT));
  mamba2_ssd_kernel<T, N, PT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(fin), S, H, P, chunk);
  return cudaGetLastError();
}

template <typename T, int PT>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, void* y, void* fin, int Bsz,
             int S, int H, int P, int N, int chunk, cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, 8, PT>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, chunk, s);
    case 16: return launch<T, 16, PT>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, chunk, s);
    case 32: return launch<T, 32, PT>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, chunk, s);
    case 64: return launch<T, 64, PT>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, chunk, s);
    case 128: return launch<T, 128, PT>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_p(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, void* y, void* fin, int Bsz,
             int S, int H, int P, int N, int chunk, cudaStream_t s) {
  switch (P) {
    case 8:
      return launch_n<T, 8>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, N, chunk, s);
    case 16:
      return launch_n<T, 16>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, N, chunk, s);
    case 32: case 64: case 128:
      return launch_n<T, 32>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, N, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---- bf16 on wgmma, fed by TMA: the chunk-parallel SSD (kWgmma) -----------

namespace tc {

constexpr int kSlab = 64;                       // rows of a slab (wgmma M)
constexpr int kMaxSlabs = kMaxChunk / kSlab;
constexpr int kXRowBytes = 128;                 // a row of 64 p of x
constexpr int kXSlice = kSlab * kXRowBytes;     // a slab of one x slice
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * 128, "two warpgroups");

// Column slices of a (rows x N) bf16 tile of C, B or the carried state, as
// flash_attention.cu cuts its tiles: 64 columns under the 128-byte swizzle
// where N allows, else 16 under the 32-byte one (N = 16, 32, 48, 80, ...).
template <int N>
struct Cols {
  static constexpr int kCols = N % 64 == 0 ? 64 : 16;
  static constexpr int kRowBytes = 2 * kCols;           // = the swizzle
  static constexpr int kSlices = N / kCols;
  static constexpr int kSteps = kCols / 16;             // k-steps a slice
};

// Descriptor of k-step kk (16 columns) of a K-major tile of `rows` rows
// cut into Cols<N> slices, each `rows` x kRowBytes.
template <int N>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int rows,
                                                int kk) {
  using L = Cols<N>;
  return hopper::smem_desc<L::kRowBytes>(
      base + (kk / L::kSteps) * rows * L::kRowBytes + 32 * (kk % L::kSteps),
      16, 8 * L::kRowBytes);
}

// The inclusive cumsum of dt_j * a over the chunk into cums[0, l), in the
// order of mamba2_ssd_kernel's scan (and ref._block_cumsum): a
// Hillis-Steele scan within each group of 32 positions (one warp), then the
// totals of the groups before it added in group order; dt_j into dts[j]
// (0 past l).  kT threads, warp w taking the groups w, w + kT / 32, ...
// Ends with __syncthreads.
template <int kT>
__device__ __forceinline__ void chunk_scan(const __nv_bfloat16* dt,
                                           long long row0, int H, int h,
                                           float a, int l, float* cums,
                                           float* dts, float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int gr = warp; gr < kMaxChunk / 32; gr += kT / 32) {
    const int j = 32 * gr + lane;
    float dtv = 0.0f, v = 0.0f;
    if (j < l) {
      dtv = __bfloat162float(dt[(row0 + j) * H + h]);
      v = dtv * a;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[gr] = v;
    cums[j] = v;
    dts[j] = dtv;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kMaxChunk; j += kT) {
    float pre = 0.0f;
    for (int k = 0; k < j / 32; ++k) pre += wsum[k];     // fixed order
    cums[j] += pre;
  }
  __syncthreads();
}

// Pass 1.  Block ((b * nc + c) * H + h), one warpgroup per 64 rows p of
// Sc = (x o w o dt)^T . B: A from registers -- x^T by ldmatrix.trans from
// x's TMA tile, scaled by w_j dt_j and split into hi + lo bf16 -- and B
// straight from its TMA tile (j rows, n contiguous: the transpose bit).
template <int P, int N>
__global__ void __launch_bounds__(2 * P)
mamba2_ssd_chunk_state_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __nv_bfloat16* __restrict__ dt,
                   const float* __restrict__ A, float* __restrict__ sc,
                   float* __restrict__ cums_out, int S, int H, int l) {
  using L = Cols<N>;
  constexpr int kT = 2 * P;
  extern __shared__ uint8_t smem_ssd[];
  uint8_t* xs = hopper::align1024(smem_ssd);          // [p slice][l rows][128 B]
  uint8_t* bsm = xs + (P / 64) * l * kXRowBytes;  // [slice][l rows][row B]
  float* cums = reinterpret_cast<float*>(bsm + l * N * 2);   // [kMaxChunk]
  float* wd = cums + kMaxChunk;               // dt_j, then w_j dt_j
  float* wsum = wd + kMaxChunk;               // [kMaxChunk / 32]
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsum + kMaxChunk / 32);

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int nc = S / l;
  const int h = blk % H, c = (blk / H) % nc, b = blk / (H * nc);
  const long long row0 = static_cast<long long>(b) * S + c * l;

  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, l * (P + N) * 2);
#pragma unroll
    for (int s = 0; s < P / 64; ++s)
      hopper::tma_load_4d(xs + s * l * kXRowBytes, &xmap, bar, 64 * s, h,
                          c * l, b);
#pragma unroll
    for (int s = 0; s < L::kSlices; ++s)
      hopper::tma_load_4d(bsm + s * l * L::kRowBytes, &bmap, bar,
                          L::kCols * s, c * l, b, 0);
  }

  chunk_scan<kT>(dt, row0, H, h, A[h], l, cums, wd, wsum);
  for (int j = tid; j < l; j += kT) {
    wd[j] = expf(cums[l - 1] - cums[j]) * wd[j];
    cums_out[static_cast<long long>(blk) * l + j] = cums[j];
  }
  __syncthreads();

  // k-step kk (positions j0 = 16 kk ...): ldmatrix matrix m = lane / 8 is
  // rows j0 + 8 (m / 2) + lane % 8 of x, 16-byte chunk 2 warp + m % 2 of
  // the warpgroup's 128-byte slice, so register m holds, transposed, the
  // A fragment's (row 16 warp + lane / 4 + 8 (m % 2), columns j0 + 8 (m /
  // 2) + 2 (lane % 4) + {0, 1}).
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q = lane % 4, m = lane / 8;
  const int jr = 8 * (m / 2) + lane % 8, pc = 2 * warp + m % 2;
  const uint32_t xa = hopper::smem_addr(xs) + wg * l * kXRowBytes;
  const uint32_t ba = hopper::smem_addr(bsm);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  uint32_t hi0[4] = {}, lo0[4] = {}, hi1[4] = {}, lo1[4] = {};
  // one k-step: the fragments into (hi, lo), two products; then wait for
  // the step before, whose fragments (phi, plo) may be rewritten next
  auto step = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4],
                  uint32_t (&phi)[4], uint32_t (&plo)[4]) {
    const int j = 16 * kk + jr;
    uint32_t raw[4];
    hopper::ldmatrix_x4_trans(raw, xa + j * kXRowBytes + ((pc ^ (j % 8)) * 16));
    const float2 w[2] = {
        *reinterpret_cast<const float2*>(wd + 16 * kk + 2 * q),
        *reinterpret_cast<const float2*>(wd + 16 * kk + 8 + 2 * q)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
      const float v0 = xv.x * w[r / 2].x, v1 = xv.y * w[r / 2].y;
      const __nv_bfloat162 hb = __floats2bfloat162_rn(v0, v1);
      const float2 hf = __bfloat1622float2(hb);
      hi[r] = *reinterpret_cast<const uint32_t*>(&hb);
      lo[r] = hopper::pack_bf16(v0 - hf.x, v1 - hf.y);
    }
    const uint64_t db = hopper::smem_desc<L::kRowBytes>(
        ba + kk * 16 * L::kRowBytes, l * L::kRowBytes, 8 * L::kRowBytes);
    hopper::wgmma_fence();
    hopper::wgmma_rs_tb<N>(acc, hi, db);
    hopper::wgmma_rs_tb<N>(acc, lo, db);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_frag(phi);
    hopper::fence_frag(plo);
  };
  hopper::mbar_wait(bar, 0);
  for (int kk = 0; kk < l / 16; kk += 2) {      // l / 16 is even
    step(kk, hi0, lo0, hi1, lo1);
    step(kk + 1, hi1, lo1, hi0, lo0);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_frag(hi1);
  hopper::fence_frag(lo1);

  // acc[i]: p row 16 warp + lane / 4 + 8 ((i / 2) % 2) of the warpgroup's
  // 64, n column 8 (i / 4) + 2 q + i % 2
  float* dst = sc + static_cast<long long>(blk) * P * N;
  const int prow = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int row = prow + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * q;
    *reinterpret_cast<float2*>(dst + row * N + col) =
        make_float2(acc[i], acc[i + 1]);
  }
}

// Pass 2.  Thread ((b * H + h) * PN + e) carries state element e = p N + n
// of (b, h) through the chunks; the state entering chunk c goes to st_in
// as hi = bf16(state) and, n_state elements on, lo = bf16(state - hi).
__global__ void __launch_bounds__(kThreads)
mamba2_ssd_state_pass_kernel(const float* __restrict__ sc,
                  const float* __restrict__ cums,
                  const float* __restrict__ init,
                  __nv_bfloat16* __restrict__ st_in,
                  float* __restrict__ fin, int Bsz, int H, int nc, int l,
                  int PN) {
  const long long n_state = static_cast<long long>(Bsz) * nc * H * PN;
  // pass 3 may start now: it reads nothing of this pass before its
  // griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(Bsz) * H * PN) return;
  const int e = static_cast<int>(idx % PN);
  const int h = static_cast<int>((idx / PN) % H);
  const int b = static_cast<int>(idx / (static_cast<long long>(PN) * H));
  float state = init ? init[idx] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    const long long blk = (static_cast<long long>(b) * nc + c) * H + h;
    const __nv_bfloat16 hi = __float2bfloat16_rn(state);
    st_in[blk * PN + e] = hi;
    st_in[n_state + blk * PN + e] =
        __float2bfloat16_rn(state - __bfloat162float(hi));
    state = state * expf(cums[blk * l + l - 1]) + sc[blk * PN + e];
  }
  fin[idx] = state;
}

template <int P, int N>
struct OutTile {
  using L = Cols<N>;
  static constexpr int kCBSlab = kSlab * N * 2;     // a slab of C or of B
  static constexpr int kXSlab = kSlab * P * 2;      // a slab of x
  static constexpr int kStBytes = P * N * 2;        // carried state, bf16
  // 1024 bytes of slack to align the tiles; a C slab for each warpgroup,
  // B and x of l / 64 slabs, the carried state's hi and lo; log2(e) cums
  // and dt of the chunk; the barriers (the state, each C slot, B and x of
  // each slab)
  static int smem(int l) {
    return 1024 + 2 * kCBSlab + (l / kSlab) * (kCBSlab + kXSlab) +
           2 * kStBytes + kMaxChunk * 6 + 8 * (3 + kMaxSlabs);
  }
};

// Pass 3.  Block ((b * nc + c) * H + h).
template <int P, int N>
__global__ void __launch_bounds__(kThreads, P == 64 ? 2 : 1)
mamba2_ssd_chunk_out_kernel(const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap smap,
                 const __nv_bfloat16* __restrict__ dt,
                 const float* __restrict__ cums_in,
                 __nv_bfloat16* __restrict__ y, int S, int H, int l) {
  using L = Cols<N>;
  using O = OutTile<P, N>;
  const int nb = l / kSlab;
  extern __shared__ uint8_t smem_ssd[];
  uint8_t* cs = hopper::align1024(smem_ssd);  // [wg][slice][64 rows][row bytes]
  uint8_t* bs = cs + 2 * O::kCBSlab;      // [slab][slice][64 rows][row B]
  uint8_t* xs = bs + nb * O::kCBSlab;     // [slab][p slice][64 rows][128 B]
  uint8_t* st = xs + nb * O::kXSlab;      // [hi, lo][slice][P rows][row B]
  float* g = reinterpret_cast<float*>(st + 2 * O::kStBytes);  // log2(e) cums
  __nv_bfloat16* dts = reinterpret_cast<__nv_bfloat16*>(g + kMaxChunk);
  // bars[0]: the carried state; bars[1 + w]: C slot of warpgroup w (its
  // first slab, then its second); bars[3 + t]: B and x of slab t
  uint64_t* bars = reinterpret_cast<uint64_t*>(dts + kMaxChunk);

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int nc = S / l;
  const int h = blk % H, c = (blk / H) % nc, b = blk / (H * nc);
  const int c0 = c * l;
  const int Bsz = static_cast<int>(gridDim.x) / (H * nc);

  // a C slab into warpgroup w's slot (one thread)
  auto load_c = [&](int w, int r) {
    hopper::mbar_expect_tx(&bars[1 + w], O::kCBSlab);
#pragma unroll
    for (int s = 0; s < L::kSlices; ++s)
      hopper::tma_load_4d(cs + w * O::kCBSlab + s * kSlab * L::kRowBytes,
                          &cmap, &bars[1 + w], L::kCols * s, c0 + kSlab * r,
                          b, 0);
  };
  if (tid == 0) {
    for (int r = 0; r < 3 + nb; ++r) hopper::mbar_init(&bars[r], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    // C of each warpgroup's first slab (nb - 1, nb - 2), B and x of every
    // slab, then, once pass 2 has completed (this grid may start while it
    // runs: programmatic dependent launch), the carried state
    load_c(0, nb - 1);
    if (nb > 1) load_c(1, nb - 2);
    for (int t = 0; t < nb; ++t) {
      uint64_t* bar = &bars[3 + t];
      hopper::mbar_expect_tx(bar, O::kCBSlab + O::kXSlab);
#pragma unroll
      for (int s = 0; s < L::kSlices; ++s)
        hopper::tma_load_4d(bs + t * O::kCBSlab + s * kSlab * L::kRowBytes,
                            &bmap, bar, L::kCols * s, c0 + kSlab * t, b, 0);
#pragma unroll
      for (int s = 0; s < P / 64; ++s)
        hopper::tma_load_4d(xs + t * O::kXSlab + s * kXSlice, &xmap, bar,
                            64 * s, h, c0 + kSlab * t, b);
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");
    hopper::mbar_expect_tx(&bars[0], 2 * O::kStBytes);
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int s = 0; s < L::kSlices; ++s)
        hopper::tma_load_4d(st + part * O::kStBytes + s * P * L::kRowBytes,
                            &smap, &bars[0], L::kCols * s, 0, h,
                            (part * Bsz + b) * nc + c);
  }
  if (tid < l) {
    g[tid] = cums_in[static_cast<long long>(blk) * l + tid] * kLog2e;
    dts[tid] = dt[(static_cast<long long>(b) * S + c0 + tid) * H + h];
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;      // rows r0 and r0 + 8 of a slab
  const uint32_t sa = hopper::smem_addr(st);
  const uint32_t ca = hopper::smem_addr(cs + wg * O::kCBSlab);
  // this warpgroup's slabs: largest first, each to the warpgroup with
  // fewer tiles so far (4 + 1 and 3 + 2 at l = 256); its C slot holds the
  // first, then the second
  int mine[2] = {-1, -1}, n_mine = 0;
  {
    int load0 = 0, load1 = 0;
    for (int r = nb - 1; r >= 0; --r) {
      const int owner = load1 < load0 ? 1 : 0;
      if (owner) load1 += r + 1; else load0 += r + 1;
      if (owner == wg) {
        if (n_mine == 0) mine[0] = r; else mine[1] = r;
        ++n_mine;
      }
    }
  }
  for (int k = 0; k < n_mine; ++k) {
    const int r = k == 0 ? mine[0] : mine[1];
    const int i0 = kSlab * r + r0;          // chunk positions i0, i0 + 8
    float acc[P / 2];
    // acc = C . (state hi + lo)^T, each row times exp(cums_i)
    hopper::mbar_wait(&bars[1 + wg], k);
    hopper::mbar_wait(&bars[0], 0);
    hopper::wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hopper::wgmma_ss<P>(acc, kmajor_desc<N>(ca, kSlab, kk),
                            kmajor_desc<N>(sa + part * O::kStBytes, P, kk),
                            part || kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    const float gi[2] = {g[i0], g[i0 + 8]};
    const float ei[2] = {hopper::exp2_approx(gi[0]),
                         hopper::exp2_approx(gi[1])};
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[i] *= ei[(i / 2) % 2];

    for (int t = 0; t <= r; ++t) {
      // S = C . B^T of column slab t
      hopper::mbar_wait(&bars[3 + t], 0);
      float s[kSlab / 2];
      const uint32_t ba = hopper::smem_addr(bs + t * O::kCBSlab);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        hopper::wgmma_ss<kSlab>(s, kmajor_desc<N>(ca, kSlab, kk),
                                kmajor_desc<N>(ba, kSlab, kk), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if (t == r && k + 1 < n_mine) {
        // the slot's last reader is done: bring in the second slab's C
        // while this slab finishes
        hopper::named_barrier(1 + wg, 128);
        if (tid % 128 == 0) load_c(wg, mine[1]);
      }
      // P = S o L o dt_j as bf16 hi + lo A fragments: element i of s is
      // row r0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 quad + i % 2
      uint32_t ph[kSlab / 16][4], pl[kSlab / 16][4];
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          const int i = 8 * kk + 2 * t4;
          const int hh = t4 % 2;
          const int j = kSlab * t + 8 * (i / 4) + 2 * quad;
          const float2 d2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dts + j));
          float pe = s[i] * hopper::exp2_approx(gi[hh] - g[j]) * d2.x;
          float po = s[i + 1] * hopper::exp2_approx(gi[hh] - g[j + 1]) * d2.y;
          if (t == r) {                     // the diagonal tile: j <= i
            pe = j <= i0 + 8 * hh ? pe : 0.0f;
            po = j + 1 <= i0 + 8 * hh ? po : 0.0f;
          }
          const __nv_bfloat162 hb = __floats2bfloat162_rn(pe, po);
          const float2 hf = __bfloat1622float2(hb);
          ph[kk][t4] = *reinterpret_cast<const uint32_t*>(&hb);
          pl[kk][t4] = hopper::pack_bf16(pe - hf.x, po - hf.y);
        }
      }
      // acc += P . x of slab t, hi then lo
      const uint32_t xa = hopper::smem_addr(xs + t * O::kXSlab);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        const uint64_t dx = hopper::smem_desc<128>(
            xa + kk * 16 * kXRowBytes, kXSlice, 8 * kXRowBytes);
        hopper::wgmma_rs_tb<P>(acc, ph[kk], dx);
        hopper::wgmma_rs_tb<P>(acc, pl[kk], dx);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        hopper::fence_frag(ph[kk]);
        hopper::fence_frag(pl[kk]);
      }
    }

    // y in bf16: row r0 + 8 hh holds, in lane q of its quad, the column
    // pairs 8 cc + 2 q; a transpose within the quad gives lane q the 8
    // columns of pair groups cc = 4 g + q, one 16-byte store each
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      __nv_bfloat16* dst =
          y + ((static_cast<long long>(b) * S + c0 + i0 + 8 * hh) * H + h) *
                  P;
#pragma unroll
      for (int gq = 0; gq < P / 32; ++gq) {
        uint32_t v[4], out[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = hopper::pack_bf16(acc[4 * (4 * gq + u) + 2 * hh],
                                   acc[4 * (4 * gq + u) + 2 * hh + 1]);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          // lane q reads lane (q + d) % 4's pair for its group 4 gq + q,
          // which that lane sends as its v[(its q - d) % 4]
          const int send = (quad - d + 4) % 4, from = (quad + d) % 4;
          const uint32_t sv = send == 0 ? v[0] : send == 1 ? v[1]
                            : send == 2 ? v[2] : v[3];
          const uint32_t rv =
              __shfl_sync(0xffffffffu, sv, (lane & ~3) | from);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u == from) out[u] = rv;
        }
        *reinterpret_cast<uint4*>(dst + 8 * (4 * gq + quad)) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  }
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* fin, void* sc,
           void* cums, void* st_in, int Bsz, int S, int H, int l,
           cudaStream_t stream) {
  using L = Cols<N>;
  using O = OutTile<P, N>;
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 e = sizeof(__nv_bfloat16);
  const int nc = S / l;
  // x as (p, h, s, b): pass 1 takes the chunk's l rows a box, pass 3 64;
  // B and C as (n, s, b, 1); state_in (b, nc, h, p, n) as (n, p, h, b nc)
  const u64 xdims[4] = {u64(P), u64(H), u64(S), u64(Bsz)};
  const u64 xstrides[3] = {P * e, u64(H) * P * e, u64(S) * H * P * e};
  const u32 xbox_l[4] = {64, 1, u32(l), 1};
  const u32 xbox[4] = {64, 1, u32(kSlab), 1};
  const u64 bdims[4] = {u64(N), u64(S), u64(Bsz), 1};
  const u64 bstrides[3] = {N * e, u64(S) * N * e, u64(Bsz) * S * N * e};
  const u32 bbox_l[4] = {u32(L::kCols), u32(l), 1, 1};
  const u32 bbox[4] = {u32(L::kCols), u32(kSlab), 1, 1};
  // the carried states (2, b, nc, h, p, n), hi then lo, as (n, p, h, 2 b nc)
  const u64 sdims[4] = {u64(N), u64(P), u64(H), 2 * u64(Bsz) * nc};
  const u64 sstrides[3] = {N * e, u64(P) * N * e, u64(H) * P * N * e};
  const u32 sbox[4] = {u32(L::kCols), u32(P), 1, 1};
  CUtensorMap xm_l, bm_l, xm, cm, bm, sm;
  int err = hopper::encode_bf16_4d(&xm_l, x, xdims, xstrides, xbox_l, 128);
  if (err == 0)
    err = hopper::encode_bf16_4d(&bm_l, Bm, bdims, bstrides, bbox_l,
                                 L::kRowBytes);
  if (err == 0)
    err = hopper::encode_bf16_4d(&xm, x, xdims, xstrides, xbox, 128);
  if (err == 0)
    err = hopper::encode_bf16_4d(&cm, Cm, bdims, bstrides, bbox,
                                 L::kRowBytes);
  if (err == 0)
    err = hopper::encode_bf16_4d(&bm, Bm, bdims, bstrides, bbox,
                                 L::kRowBytes);
  if (err == 0)
    err = hopper::encode_bf16_4d(&sm, st_in, sdims, sstrides, sbox,
                                 L::kRowBytes);
  if (err != 0) return err;

  const int smem1 = 1024 + (P / 64) * l * kXRowBytes + l * N * 2 +
                    2 * kMaxChunk * 4 + (kMaxChunk / 32) * 4 + 8;
  const int smem3 = O::smem(l);
  cudaError_t got = cudaFuncSetAttribute(
      mamba2_ssd_chunk_state_kernel<P, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (got == cudaSuccess)
    got = cudaFuncSetAttribute(mamba2_ssd_chunk_out_kernel<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem3);
  if (got != cudaSuccess) return got;
  const int blocks = Bsz * nc * H;
  const auto* dtp = static_cast<const __nv_bfloat16*>(dt);
  mamba2_ssd_chunk_state_kernel<P, N><<<blocks, 2 * P, smem1, stream>>>(
      xm_l, bm_l, dtp, static_cast<const float*>(A), static_cast<float*>(sc),
      static_cast<float*>(cums), S, H, l);
  got = cudaGetLastError();
  if (got != cudaSuccess) return got;
  const long long n_state = static_cast<long long>(Bsz) * H * P * N;
  mamba2_ssd_state_pass_kernel<<<
      static_cast<int>((n_state + kThreads - 1) / kThreads), kThreads, 0,
      stream>>>(
      static_cast<const float*>(sc), static_cast<const float*>(cums),
      static_cast<const float*>(init), static_cast<__nv_bfloat16*>(st_in),
      static_cast<float*>(fin), Bsz, H, nc, l, P * N);
  got = cudaGetLastError();
  if (got != cudaSuccess) return got;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem3;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  got = cudaLaunchKernelEx(&cfg, mamba2_ssd_chunk_out_kernel<P, N>, cm, bm,
                           xm, sm, dtp,
                           static_cast<const float*>(cums),
                           static_cast<__nv_bfloat16*>(y), S, H, l);
  if (got != cudaSuccess) return got;
  return cudaGetLastError();
}

// launch<P, N> for the state widths kWgmma takes.
template <int P>
int with_n(int N, const void* x, const void* dt, const void* A,
           const void* Bm, const void* Cm, const void* init, void* y,
           void* fin, void* sc, void* cums, void* st_in, int Bsz, int S,
           int H, int l, cudaStream_t s) {
#define SSD_TC_N(n)                                                         \
  case n:                                                                   \
    return launch<P, n>(x, dt, A, Bm, Cm, init, y, fin, sc, cums, st_in,    \
                        Bsz, S, H, l, s);
  switch (N) {
    SSD_TC_N(16) SSD_TC_N(32) SSD_TC_N(48) SSD_TC_N(64)
    SSD_TC_N(80) SSD_TC_N(96) SSD_TC_N(112) SSD_TC_N(128)
    default: return cudaErrorInvalidValue;
  }
#undef SSD_TC_N
}

}  // namespace tc

}  // namespace

extern "C" {

// init may be NULL (a zero initial state).  route: kFma, or kWgmma with the
// wrapper's scratch -- sc (b, nc, h, p, n) fp32, cums (b, nc, h, chunk)
// fp32, st_in (b, nc, h, p, n) bf16 -- which kFma ignores (NULL).  A call
// that does not meet kWgmma's needs is refused (cudaErrorInvalidValue),
// never run on kFma.
int mamba2_ssd_fwd(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* init, void* y,
                   void* fin, int Bsz, int S, int H, int P, int N, int chunk,
                   int dtype, int route, void* sc, void* cums, void* st_in,
                   void* stream) {
  if (Bsz <= 0 || H <= 0) return 0;
  if (S < 0 || chunk < 1 || chunk > kMaxChunk) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kWgmma) {
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(Cm) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(y) % 16 == 0;
    if (dtype != kBF16 || !aligned || N % 16 != 0 || N > 128 ||
        chunk % tc::kSlab != 0 || S % chunk != 0 || !sc || !cums || !st_in)
      return cudaErrorInvalidValue;
    if (S == 0) return 0;
    switch (P) {
      case 64:
        return tc::with_n<64>(N, x, dt, A, Bm, Cm, init, y, fin, sc, cums,
                              st_in, Bsz, S, H, chunk, s);
      case 128:
        return tc::with_n<128>(N, x, dt, A, Bm, Cm, init, y, fin, sc, cums,
                               st_in, Bsz, S, H, chunk, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (route != kFma) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_p<float>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S, H, P, N,
                             chunk, s);
    case kBF16:
      return launch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, fin, Bsz, S,
                                     H, P, N, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
