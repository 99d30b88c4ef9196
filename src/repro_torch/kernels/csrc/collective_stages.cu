// Level-B collective-stage kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of src/repro/kernels/collective_stages.py:
//   * fused_combine   (`_combine_kernel`, `_combine_scaled_kernel`):
//       out = acc + dequant(got), or dequant(got) alone (accumulate = 0),
//       where dequant(got) = cast_to_acc(got) or cast_to_acc(float(got) * s);
//   * quantize_wire   (`_quant_kernel`):
//       q = int8(clip(rint(x / s), -127, 127));
//   * dequantize_wire (`_dequant_kernel`):
//       out = cast_to_out(float(q) * s).
// `s` is a 0-d fp32 tensor on the device, read through a pointer: the
// scale of a round is computed on the device and never visits the host.
//
// Bound on an H100 SXM: memory.  Every element is touched once, with one
// or two flops; a ring round at the main path's chunk of 236,152,960 fp32
// elements moves 12 bytes an element (read acc and got, write out), about
// 2.83 GB or 0.85 ms at 3.35 TB/s.  The design keeps loads in flight and
// nothing else:
//   * 1-D input of any length (the TPU's (32k, 128) tile padding is
//     dropped), a grid-stride loop over tiles of kThreads * kUnroll
//     elements.  Each thread issues its kUnroll loads of a tile before any
//     store, neighbouring threads on neighbouring addresses, so a warp's
//     loads coalesce and each thread keeps several in flight; the tail is
//     masked element by element.
//   * fused_combine moves every array in 16-byte vectors: a thread's
//     vector is V = 16 / (the narrower of acc's and got's element size)
//     elements -- 4 fp32, 8 bf16 or 16 int8 of the narrower, one or more
//     16-byte loads of the wider -- and kVecUnroll vectors of a tile are
//     loaded before any is stored.  Ring chunks are views at any offset
//     into a flat buffer, so the first `head` elements (up to where out
//     is 16-byte aligned) and the ragged tail are done one at a time, by
//     the first threads of the grid.  Its grid is one tile a block, not
//     kBlocksPerSM blocks a SM looping over tiles: the hardware's block
//     scheduler balances the streams better than the fixed loop did.  When
//     acc, got and out are not all 16-byte aligned at the same element
//     (views at mutually misaligned offsets), the call takes the
//     element-at-a-time kernel above.
//   * The grid is kBlocksPerSM blocks per SM (full occupancy at 256
//     threads), capped by the work.
//   * With accumulate = 0, `acc` is never read.  `out` may be `acc` itself
//     (the in-place ring update): every element is read before it is
//     written, by the same thread.
//   * Rounding follows the plain PyTorch version exactly: __fmul_rn for the
//     dequantisation, the cast to the acc type (__float2bfloat16_rn for
//     bf16), then __fadd_rn in fp32 and one rounding to the acc type;
//     __fdiv_rn and rintf (round half to even) in the quantisation.  With
//     --fmad=false nothing contracts to an FMA, so every variant equals
//     the plain version bitwise.
//
// C interface (ctypes): every function returns cudaGetLastError() after
// its launch, 0 on success; dtype codes are 0 = fp32, 1 = bf16, 2 = int8.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecUnroll = 2;   // vectors a thread loads before it stores
constexpr int64_t kMaxBlocks = 0x7fffffff;   // the grid's x extent
constexpr int kBlocksPerSM = 8;
constexpr int kMaxDevices = 64;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// `v` rounded to T and widened back to fp32 (exact for T = float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// One element of the combine, rounded as the plain version rounds it.
template <typename A, bool kScaled, bool kAccumulate>
__device__ __forceinline__ A combine_one(float a, float g, float s) {
  float v = round_to<A>(kScaled ? __fmul_rn(g, s) : g);
  if (kAccumulate) v = __fadd_rn(a, v);
  return from_float<A>(v);
}

template <typename A, typename G, bool kScaled, bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const A* acc, const G* __restrict__ got,
               const float* __restrict__ scale, A* out, int64_t n) {
  const float s = kScaled ? *scale : 1.0f;
  const int64_t tile = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t step = static_cast<int64_t>(gridDim.x) * tile;
  for (int64_t base = blockIdx.x * tile; base < n; base += step) {
    float g[kUnroll], a[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      if (i < n) {
        g[j] = to_float(got[i]);
        if (kAccumulate) a[j] = to_float(acc[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      if (i < n)
        out[i] = combine_one<A, kScaled, kAccumulate>(
            kAccumulate ? a[j] : 0.0f, g[j], s);
    }
  }
}

// V elements of T from (or to) 16-byte aligned memory, as V * sizeof(T) /
// 16 vector accesses.
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int q = 0; q < V / kPer; ++q) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
    T e[kPer];
    memcpy(e, &raw, 16);
#pragma unroll
    for (int j = 0; j < kPer; ++j) f[q * kPer + j] = to_float(e[j]);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int q = 0; q < V / kPer; ++q) {
    uint4 raw;
    memcpy(&raw, v + q * kPer, 16);
    reinterpret_cast<uint4*>(p)[q] = raw;
  }
}

template <typename A, typename G>
struct Vec {
  static constexpr int kBytes = sizeof(A) < sizeof(G) ? sizeof(A) : sizeof(G);
  static constexpr int V = 16 / kBytes;     // elements a vector
};

// Elements [0, head) and [head + n_vec * V, n) one at a time by the first
// threads of the grid; vectors i of elements [head + V i, head + V i + V)
// in a grid-stride loop over tiles of kThreads * kVecUnroll vectors.
// acc + head, got + head and out + head are 16-byte aligned.
template <typename A, typename G, bool kScaled, bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
combine_vec_kernel(const A* acc, const G* __restrict__ got,
                   const float* __restrict__ scale, A* out, int64_t n,
                   int64_t head, int64_t n_vec) {
  constexpr int V = Vec<A, G>::V;
  const float s = kScaled ? *scale : 1.0f;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t tail = head + n_vec * V;
  if (t < head)
    out[t] = combine_one<A, kScaled, kAccumulate>(
        kAccumulate ? to_float(acc[t]) : 0.0f, to_float(got[t]), s);
  if (tail + t < n)
    out[tail + t] = combine_one<A, kScaled, kAccumulate>(
        kAccumulate ? to_float(acc[tail + t]) : 0.0f, to_float(got[tail + t]),
        s);
  const A* av = acc + head;
  const G* gv = got + head;
  A* ov = out + head;
  const int64_t tile = static_cast<int64_t>(kThreads) * kVecUnroll;
  const int64_t step = static_cast<int64_t>(gridDim.x) * tile;
  for (int64_t base = blockIdx.x * tile; base < n_vec; base += step) {
    float g[kVecUnroll][V], a[kVecUnroll][V];
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const int64_t v = base + u * kThreads + threadIdx.x;
      if (v < n_vec) {
        load_vec(gv + v * V, g[u]);
        if (kAccumulate) load_vec(av + v * V, a[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const int64_t v = base + u * kThreads + threadIdx.x;
      if (v < n_vec) {
        A r[V];
#pragma unroll
        for (int k = 0; k < V; ++k)
          r[k] = combine_one<A, kScaled, kAccumulate>(
              kAccumulate ? a[u][k] : 0.0f, g[u][k], s);
        store_vec(ov + v * V, r);
      }
    }
  }
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const X* __restrict__ x, const float* __restrict__ scale,
                int8_t* __restrict__ q, int64_t n) {
  const float s = *scale;
  const int64_t tile = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t step = static_cast<int64_t>(gridDim.x) * tile;
  for (int64_t base = blockIdx.x * tile; base < n; base += step) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      if (i < n) v[j] = to_float(x[i]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      if (i < n) {
        const float r = rintf(__fdiv_rn(v[j], s));
        q[i] = static_cast<int8_t>(
            static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
      }
    }
  }
}

template <typename D>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scale, D* __restrict__ out,
                  int64_t n) {
  const float s = *scale;
  const int64_t tile = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t step = static_cast<int64_t>(gridDim.x) * tile;
  for (int64_t base = blockIdx.x * tile; base < n; base += step) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      if (i < n) v[j] = to_float(q[i]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      if (i < n) out[i] = from_float<D>(__fmul_rn(v[j], s));
    }
  }
}

// Blocks for `n` elements: one tile each, at most kBlocksPerSM per SM.
int grid_for(int64_t n) {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int count = dev < kMaxDevices ? sms[dev] : 0;
  if (count == 0) {
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
    if (dev < kMaxDevices) sms[dev] = count;
  }
  const int64_t tile = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t want = (n + tile - 1) / tile;
  const int64_t cap = static_cast<int64_t>(count) * kBlocksPerSM;
  return static_cast<int>(want < cap ? want : cap);
}

// The vector kernel when acc (if read), got and out are 16-byte aligned at
// one element, else the element-at-a-time kernel.
template <typename A, typename G, bool kScaled, bool kAccumulate>
int run_combine(const void* acc, const void* got, const void* scale,
                void* out, int64_t n, cudaStream_t s) {
  constexpr int V = Vec<A, G>::V;
  const auto mis = [](const void* p, int64_t elems, int64_t size) {
    return (reinterpret_cast<uintptr_t>(p) + elems * size) % 16;
  };
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  int64_t head = static_cast<int64_t>((16 - o % 16) % 16 / sizeof(A));
  if (head > n) head = n;
  const bool aligned = o % sizeof(A) == 0 &&
                       mis(out, head, sizeof(A)) == 0 &&
                       mis(got, head, sizeof(G)) == 0 &&
                       (!kAccumulate || mis(acc, head, sizeof(A)) == 0);
  if (aligned) {
    const int64_t n_vec = (n - head) / V;
    // one tile a block (the grid-stride loop only past kMaxBlocks)
    const int64_t tile = static_cast<int64_t>(kThreads) * kVecUnroll;
    const int64_t want = (n_vec + tile - 1) / tile;
    const int grid = static_cast<int>(want < 1            ? 1
                                      : want < kMaxBlocks ? want
                                                          : kMaxBlocks);
    combine_vec_kernel<A, G, kScaled, kAccumulate><<<grid, kThreads, 0, s>>>(
        static_cast<const A*>(acc), static_cast<const G*>(got),
        static_cast<const float*>(scale), static_cast<A*>(out), n, head,
        n_vec);
  } else {
    combine_kernel<A, G, kScaled, kAccumulate>
        <<<grid_for(n), kThreads, 0, s>>>(
            static_cast<const A*>(acc), static_cast<const G*>(got),
            static_cast<const float*>(scale), static_cast<A*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename G>
int combine_variant(const void* acc, const void* got, const void* scale,
                    void* out, int64_t n, bool accumulate, cudaStream_t s) {
  if (scale != nullptr) {
    return accumulate ? run_combine<A, G, true, true>(acc, got, scale, out, n, s)
                      : run_combine<A, G, true, false>(acc, got, scale, out, n, s);
  }
  return accumulate ? run_combine<A, G, false, true>(acc, got, scale, out, n, s)
                    : run_combine<A, G, false, false>(acc, got, scale, out, n, s);
}

template <typename A>
int combine_got(const void* acc, const void* got, const void* scale,
                void* out, int64_t n, int got_dtype, bool accumulate,
                cudaStream_t s) {
  switch (got_dtype) {
    case kF32:
      return combine_variant<A, float>(acc, got, scale, out, n, accumulate, s);
    case kBF16:
      return combine_variant<A, __nv_bfloat16>(acc, got, scale, out, n,
                                               accumulate, s);
    case kI8:
      return combine_variant<A, int8_t>(acc, got, scale, out, n, accumulate,
                                        s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int fused_combine(const void* acc, const void* got, const void* scale,
                  void* out, long long n, int acc_dtype, int got_dtype,
                  int accumulate, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (acc_dtype) {
    case kF32:
      return combine_got<float>(acc, got, scale, out, n, got_dtype,
                                accumulate != 0, s);
    case kBF16:
      return combine_got<__nv_bfloat16>(acc, got, scale, out, n, got_dtype,
                                        accumulate != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int quantize_wire(const void* x, const void* scale, void* q, long long n,
                  int x_dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  int8_t* qp = static_cast<int8_t*>(q);
  switch (x_dtype) {
    case kF32:
      quantize_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const float*>(x), sc, qp, n);
      break;
    case kBF16:
      quantize_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), sc, qp, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dequantize_wire(const void* q, const void* scale, void* out, long long n,
                    int out_dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  switch (out_dtype) {
    case kF32:
      dequantize_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
          qp, sc, static_cast<float*>(out), n);
      break;
    case kBF16:
      dequantize_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(
          qp, sc, static_cast<__nv_bfloat16*>(out), n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
