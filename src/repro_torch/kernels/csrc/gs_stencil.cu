// Fused Gauss–Seidel block stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gs_stencil` (`_gs_kernel`) of
// src/repro/kernels/collective_stages.py.  One call over an (H, W) block
// and its four halo vectors produces
//   * the 4-point update  new = 0.25 * (((up + down) + left) + right),
//   * the fp32 L1 residual  sum |new - old|  (over the unrounded fp32 new),
//   * the four new boundary edges (top, bottom, left, right) for the next
//     halo exchange, written from the same `new` values as the block.
//
// Bound on an H100 SXM: memory.  A 1024 x 1024 fp32 call must read the
// block (4 MiB) and write the new block (4 MiB) plus 16 KiB of halos and
// edges: about 8.4 MB, 2.5 us at 3.35 TB/s; its 5 flops a point are
// 5.2 MFLOP, 0.08 us at 67 TFLOP/s.  At this block size the launch
// overhead (a few us for the two launches) dominates, so the design stays
// simple:
//   * Pass 1: a 2-D grid of CTAs of 32 x 8 threads, each CTA one 32-column
//     x 32-row tile, each thread one column and four rows.  Neighbouring
//     threads read neighbouring addresses; the four neighbour reads of a
//     point hit L1/L2, so device memory sees the block about once.  Halo
//     values come from the four vectors at the block border.  Threads on
//     the border rows and columns also write the edge vectors.
//   * Every thread sums its |new - old| in row order, the CTA reduces in a
//     fixed tree (warp shuffles, then shared memory) into
//     partials[blockIdx]; pass 2, one CTA, sums the partials in a fixed
//     order.  No atomics: the residual is bitwise reproducible across runs.
//   * The sum and the scale use __fadd_rn / __fmul_rn, so no FMA
//     contraction changes the rounding: block and edges match the plain
//     PyTorch version bitwise.
//
// C interface (ctypes): every function returns cudaGetLastError() after
// its launches, 0 on success.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTileW = 32;             // columns per CTA = threads in x
constexpr int kThreadsY = 8;           // threads in y
constexpr int kRowsPerThread = 4;
constexpr int kTileH = kThreadsY * kRowsPerThread;
constexpr int kThreads = kTileW * kThreadsY;
constexpr int kReduceThreads = 1024;   // pass 2

__device__ __forceinline__ float load(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Fixed-order tree sum of one value per thread; the result is valid in
// thread 0.  `scratch` holds one float per warp.
template <int kBlockThreads>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  constexpr int kWarps = kBlockThreads / 32;
  if (warp == 0) {
    v = lane < kWarps ? scratch[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_stencil_kernel(const T* __restrict__ block, const T* __restrict__ top,
                  const T* __restrict__ left, const T* __restrict__ bottom,
                  const T* __restrict__ right, T* __restrict__ out,
                  T* __restrict__ top_edge, T* __restrict__ bottom_edge,
                  T* __restrict__ left_edge, T* __restrict__ right_edge,
                  float* __restrict__ partials, int H, int W) {
  __shared__ float scratch[kThreads / 32];
  const int j = blockIdx.x * kTileW + threadIdx.x;
  const int i0 = blockIdx.y * kTileH + threadIdx.y * kRowsPerThread;
  float acc = 0.0f;
  if (j < W) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = i0 + k;
      if (i >= H) break;
      const int idx = i * W + j;
      const float c = load(block, idx);
      const float up = i > 0 ? load(block, idx - W) : load(top, j);
      const float down = i < H - 1 ? load(block, idx + W) : load(bottom, j);
      const float lf = j > 0 ? load(block, idx - 1) : load(left, i);
      const float rt = j < W - 1 ? load(block, idx + 1) : load(right, i);
      const float v =
          __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(up, down), lf), rt));
      store(out, idx, v);
      if (i == 0) store(top_edge, j, v);
      if (i == H - 1) store(bottom_edge, j, v);
      if (j == 0) store(left_edge, i, v);
      if (j == W - 1) store(right_edge, i, v);
      acc = __fadd_rn(acc, fabsf(__fsub_rn(v, c)));
    }
  }
  const float total = block_sum<kThreads>(acc, scratch);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kReduceThreads)
sum_partials_kernel(const float* __restrict__ partials, int n,
                    float* __restrict__ res) {
  __shared__ float scratch[kReduceThreads / 32];
  float acc = 0.0f;
  for (int k = threadIdx.x; k < n; k += kReduceThreads)
    acc = __fadd_rn(acc, partials[k]);
  const float total = block_sum<kReduceThreads>(acc, scratch);
  if (threadIdx.x == 0) res[0] = total;
}

template <typename T>
int launch(const void* block, const void* top, const void* left,
           const void* bottom, const void* right, void* out, void* top_edge,
           void* bottom_edge, void* left_edge, void* right_edge,
           void* partials, void* res, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  gs_stencil_kernel<T><<<grid, dim3(kTileW, kThreadsY), 0, s>>>(
      static_cast<const T*>(block), static_cast<const T*>(top),
      static_cast<const T*>(left), static_cast<const T*>(bottom),
      static_cast<const T*>(right), static_cast<T*>(out),
      static_cast<T*>(top_edge), static_cast<T*>(bottom_edge),
      static_cast<T*>(left_edge), static_cast<T*>(right_edge),
      static_cast<float*>(partials), H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), grid.x * grid.y,
      static_cast<float*>(res));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Length of the `partials` scratch vector the wrapper allocates.
int gs_stencil_num_partials(int H, int W) {
  return ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
}

int gs_stencil_f32(const void* block, const void* top, const void* left,
                   const void* bottom, const void* right, void* out,
                   void* top_edge, void* bottom_edge, void* left_edge,
                   void* right_edge, void* partials, void* res, int H, int W,
                   void* stream) {
  return launch<float>(block, top, left, bottom, right, out, top_edge,
                       bottom_edge, left_edge, right_edge, partials, res, H,
                       W, stream);
}

int gs_stencil_bf16(const void* block, const void* top, const void* left,
                    const void* bottom, const void* right, void* out,
                    void* top_edge, void* bottom_edge, void* left_edge,
                    void* right_edge, void* partials, void* res, int H, int W,
                    void* stream) {
  return launch<__nv_bfloat16>(block, top, left, bottom, right, out, top_edge,
                               bottom_edge, left_edge, right_edge, partials,
                               res, H, W, stream);
}

}  // extern "C"
