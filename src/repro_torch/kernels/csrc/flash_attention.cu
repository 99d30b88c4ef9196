// Flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_attn_kernel`) of
// src/repro/kernels/flash_attention.py: tiled attention with the online
// softmax, GQA (query head h reads kv head h / rep), causal and
// sliding-window masks, fp32 accumulation, output in the input dtype.
//   q (B, S, H, D), k and v (B, T, Hkv, D), o (B, S, H, D), contiguous,
//   fp32 or bf16; D in {16, 32, 64, 80, 128}; any S and T.
// Per key tile, for each query row: s = (q . k) * 1/sqrt(D) in fp32, masked
// to NEG_INF; m_new = max(m, max s); p = exp(s - m_new), 0 where masked;
// alpha = 0 where m is still NEG_INF, else exp(m - m_new); l = l * alpha +
// sum p; acc = acc * alpha + p . v.  At the end l == 0 becomes 1 and
// acc / l is stored in the input dtype -- what `_attn_kernel` computes.
//
// Bound on an H100 SXM: operations.  granite-3-2b's prefill call (S = T =
// 2048, 32 heads over 8 kv heads, D = 64, causal) does 2 * 2 * S^2 * D * H
// / 2 = 17.18 GFLOP on 20.97 MB of q, k, v and o: 0.0174 ms at the 989
// TFLOP/s bf16 tensor-core peak against 0.0063 ms for the bytes.  This
// kernel runs on the fp32 FMA pipes (67 TFLOP/s, 0.26 ms at best), which
// keeps fp32 inputs exact to fp32 and bf16 inputs in fp32 throughout, as
// the Pallas kernel and the plain version do; tensor cores (mma / wgmma)
// are a later step.  What the design does for the FMA pipes:
//   * One block of 128 threads owns 64 query rows of ONE kv head: the rows
//     are (position, head) pairs over the `rep` query heads that share
//     that kv head, so each K/V tile staged in shared memory serves all of
//     them.  One launch covers every (batch, kv head, head chunk, position
//     tile); a loop inside the block over key tiles of 64 takes the place
//     of the TPU's sequential key-block grid axis, with m, l and the fp32
//     accumulator in registers.
//   * Both products are register-tiled like a GEMM: each thread owns 8
//     rows x 4 score columns of the (64 x 64) score tile and 8 rows x D/16
//     output columns, so every shared-memory load feeds 4-8 FMAs.  The 16
//     threads that share a row sit in one half-warp, so row max and row
//     sum are four xor shuffles.  Q, K and P are kept transposed in shared
//     memory so that a thread's 8 rows or 4 columns are one or two 16-byte
//     loads.  Register use stays near 140 at D = 128: no thread holds a
//     whole query row.
//   * Causal and window bounds give each block its first and last key
//     tile, so fully masked tiles are never loaded (the Pallas kernel's
//     `pl.when(run)`); masking inside a tile is per element, which also
//     covers the ragged last tile of any T and the ragged last position
//     tile of any S.  Heavy (late) position tiles are scheduled first.
//   * Shared memory (Q^T, K^T, V, P^T in fp32) is 30-120 KB by D, above
//     the 48 KB default from D = 64 on, so each launch raises the
//     kernel's dynamic limit.
// Deterministic: no atomics, fixed orders of every sum, so two calls are
// bitwise equal.  expf (not __expf), explicit fmaf.
//
// C interface (ctypes): flash_attention_fwd returns cudaGetLastError()
// after its launch, 0 on success; dtype codes are 0 = fp32, 1 = bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 64;       // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 4 warps; warp w owns rows [16w, 16w + 16)
constexpr int kTM = 8;          // rows per thread
constexpr int kTN = kBK / 16;   // score columns per thread
constexpr int kPad = 4;         // keeps transposed rows 16-byte aligned
constexpr int kRowStride = kRows + kPad;
constexpr int kKeyStride = kBK + kPad;
constexpr float kNegInf = -1e30f;

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

constexpr int smem_floats(int D) {
  return D * kRowStride + D * kKeyStride + kBK * D + kBK * kRowStride;
}

// Block (x, y): x walks the position tiles, last first; y = ((b * Hkv + g)
// * n_hchunks + hc).  Row i of the block is position p0 + i / hpb of query
// head g * rep + hc * hpb + i % hpb, valid for i < hpb * ppb and pos < S.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Tk, int H, int Hkv, int hpb, int ppb,
                       int n_hchunks, int causal, int window, float scale) {
  constexpr int DC = D / 16;    // output columns per thread
  extern __shared__ float4 smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);   // [D][kRowStride]
  float* Kt = Qt + D * kRowStride;                  // [D][kKeyStride]
  float* Vs = Kt + D * kKeyStride;                  // [kBK][D]
  float* Pt = Vs + kBK * D;                         // [kBK][kRowStride]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + 8 * (lane >> 4);   // this thread's rows
  const int cg = lane & 15;                            // its column group
  const int c0 = cg * kTN;                             // score columns
  const int d0 = cg * DC;                              // output columns

  const int rep = H / Hkv;
  const int ptile = gridDim.x - 1 - blockIdx.x;
  const int p0 = ptile * ppb;
  const int hc = blockIdx.y % n_hchunks;
  const int g = (blockIdx.y / n_hchunks) % Hkv;
  const int b = blockIdx.y / (n_hchunks * Hkv);
  const int h0 = g * rep + hc * hpb;
  const int n_rows = hpb * ppb;

  // stage this block's query rows, transposed, in fp32
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int pos = p0 + i / hpb;
    float x = 0.0f;
    if (i < n_rows && pos < S)
      x = to_float(q[((long long)(b * S + pos) * H + h0 + i % hpb) * D + d]);
    Qt[d * kRowStride + i] = x;
  }

  int pos[kTM];
  float m[kTM], l[kTM], acc[kTM][DC];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + i;
    pos[i] = (r < n_rows && p0 + r / hpb < S) ? p0 + r / hpb : -1;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  // key tiles that can hold an unmasked element for some row of the block
  const int q_lo = p0;
  const int q_hi = min(p0 + ppb, S) - 1;
  int kt_begin = 0, kt_end = (Tk + kBK - 1) / kBK;
  if (window >= 0) kt_begin = max(0, q_lo - window + 1) / kBK;
  if (causal) kt_end = min(kt_end, q_hi / kBK + 1);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();            // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int kk = idx / D, d = idx % D;
      const int key = k0 + kk;
      float kx = 0.0f, vx = 0.0f;
      if (key < Tk) {
        const long long off = ((long long)(b * Tk + key) * Hkv + g) * D + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      Kt[d * kKeyStride + kk] = kx;
      Vs[kk * D + d] = vx;
    }
    __syncthreads();

    // scores: s = Q_tile . K_tile^T over this thread's 8 x 4 patch
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kTM], bk[kTN];
      load_n<kTM>(Qt + d * kRowStride + r0, a);
      load_n<kTN>(Kt + d * kKeyStride + c0, bk);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // mask, online softmax, P^T to shared memory
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      bool ok[kTN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = k0 + c0 + j;
        ok[j] = pos[i] >= 0 && key < Tk && (!causal || key <= pos[i]) &&
                (window < 0 || key > pos[i] - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        Pt[(c0 + j) * kRowStride + r0 + i] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = m[i] == kNegInf ? 0.0f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P_tile . V_tile over this thread's 8 x D/16 patch
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], bv[DC];
      load_n<kTM>(Pt + kk * kRowStride + r0, a);
      load_n<DC>(Vs + kk * D + d0, bv);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (pos[i] < 0) continue;
    const int r = r0 + i;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    T* dst = o + ((long long)(b * S + pos[i]) * H + h0 + r % hpb) * D + d0;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(dst + j, acc[i][j] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
  const int rep = H / Hkv;
  int hpb = 1;                  // the largest divisor of rep up to kRows
  for (int c = 1; c <= rep && c <= kRows; ++c)
    if (rep % c == 0) hpb = c;
  const int ppb = kRows / hpb;
  const int n_hchunks = rep / hpb;
  const int smem = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + ppb - 1) / ppb, B * Hkv * n_hchunks);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, Hkv, hpb, ppb,
      n_hchunks, causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tk, int H, int Hkv, int D, int causal, int window,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, Hkv, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tk, H, Hkv, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, Hkv, causal, window, s);
    case 80: return launch<T, 80>(q, k, v, o, B, S, Tk, H, Hkv, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, Hkv, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// window < 0: no sliding window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Tk, int H, int Hkv, int D,
                        int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(q, k, v, o, B, S, Tk, H, Hkv, D, causal, window,
                             s);
    case kBF16:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, Hkv, D, causal,
                                     window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
