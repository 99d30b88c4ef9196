// Mamba2 SSD (state space dual) chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mamba2_ssd` (`_ssd_kernel`) of
// src/repro/kernels/mamba2_ssd.py.  For each (batch, head) it walks the
// chunks in order, carrying the (p x n) fp32 state.  Per chunk of length l:
//   xd = x * dt,  dA = dt * a,  cums = cumsum(dA)
//   y  = ((C B^T) o L) xd + exp(cums) o (C state^T),
//        L[i, j] = exp(cums_i - cums_j) for i >= j, else 0
//   state <- exp(cums_l) state + xd^T (B o exp(cums_l - cums))
//   x (b, s, h, p), dt (b, s, h), B and C (b, s, n), all fp32 or all bf16;
//   A (h,) fp32; optional initial state (b, h, p, n) fp32 (zeros if NULL);
//   y (b, s, h, p) in x's dtype, final state (b, h, p, n) fp32; contiguous.
//   p and n in {8, 16, 32, 64, 128}; any chunk from 1 to 256 (a ragged
//   last chunk is masked, though the wrapper keeps the JAX contract
//   s % chunk == 0).
//
// Bound on an H100 SXM: bytes.  zamba2-2.7b's prefill call (s = 2048, 80
// heads, p = n = 64, chunk 256, bf16) moves 44.1 MB (x and y 21 MB each)
// -- 0.0132 ms at 3.35 TB/s -- and its lower-triangle work is about 8 GFLOP,
// 0.0081 ms at the 989 TFLOP/s bf16 tensor-core peak.  This kernel runs on
// the fp32 FMA pipes (67 TFLOP/s), in fp32 throughout as the Pallas kernel
// and the plain version do; tensor cores (mma / wgmma) and TMA are a later
// step.  What the design does:
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
// C interface (ctypes): mamba2_ssd_fwd returns cudaGetLastError() after
// its launch, 0 on success; dtype codes are 0 = fp32, 1 = bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRB = 64;         // rows (and columns) of a chunk tile
constexpr int kMaxChunk = 256;  // one scan element per thread
constexpr int kPad = 4;         // keeps transposed rows 16-byte aligned
constexpr int kStride = kRB + kPad;
static_assert(kMaxChunk == kThreads, "the scan gives each thread one step");
static_assert(kRB * kRB == 16 * kThreads, "4 x 4 tile patch per thread");

enum DType { kF32 = 0, kBF16 = 1 };

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

}  // namespace

extern "C" {

// init may be NULL (a zero initial state).
int mamba2_ssd_fwd(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* init, void* y,
                   void* fin, int Bsz, int S, int H, int P, int N, int chunk,
                   int dtype, void* stream) {
  if (Bsz <= 0 || H <= 0) return 0;
  if (S < 0 || chunk < 1 || chunk > kMaxChunk) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
