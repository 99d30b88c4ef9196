// Fused Gauss–Seidel block stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gs_stencil` (`_gs_kernel`) of
// src/repro/kernels/collective_stages.py.  One call over an (H, W) block
// and its four halo vectors produces
//   * the 4-point update  new = 0.25 * (((up + down) + left) + right),
//   * the fp32 L1 residual  sum |new - old|  (over the unrounded fp32 new),
//   * the four new boundary edges (top, bottom, left, right) for the next
//     halo exchange, written from the same `new` values as the block,
// in ONE launch.
//
// Bound on an H100 SXM: memory.  A 1024 x 1024 fp32 call must read the
// block (4 MiB) and write the new block (4 MiB) plus 16 KiB of halos and
// edges: 8.42 MB, 2.51 us at 3.35 TB/s; its 6 flops a point are 6.3
// MFLOP, 0.09 us at 67 TFLOP/s.  At that size the whole call is a few
// memory latencies long, so what counts is how much is in flight at once
// and how little the call adds around the bytes:
//   * 16-byte accesses ("vec" route).  A thread owns kVec adjacent columns
//     (4 fp32, 8 bf16) of a strip of kRows rows.  It issues all its loads
//     of the strip -- rows i0-1 .. i0+kRows, one 16-byte vector each --
//     before its first add, then walks down the strip with rows i-1, i
//     and i+1 in registers.  Left and right neighbours come from the
//     adjacent lanes (__shfl_up_sync / __shfl_down_sync); lanes 0 and 31
//     load the one column beyond the warp's span, or read the left/right
//     halo at the block's border.  The rows above and below a strip are
//     read again by the neighbouring strips, from the L2: device memory
//     sees the block once.  Stores are 16-byte; the edges are written from
//     the same `new` values.  Block loads and stores carry the streaming
//     hint (__ldcs / __stcs): the main path reads each block once an
//     iteration and its new block only in the next one.
//   * Grid.  A CTA is kWarps data warps stacked in rows, 32 * kVec columns
//     by kWarps * kRows rows, and one accounting warp.  The 1024^2 fp32
//     block is 8 x 32 = 256 CTAs of 288 threads, all resident at once (two
//     on most of the 132 SMs), each data thread with its 6 vectors (96
//     bytes) in flight: 3.1 MB requested in the first microsecond, more
//     than the ~2.3 MB (3.35 TB/s x ~0.7 us of latency) the card needs in
//     flight to run at its memory rate.  Strips of 2, 8 or 16 rows and
//     CTAs of 4 or 16 data warps were no faster on the card (probes, not
//     in the repo): the call is not short of bytes in flight.
//   * The "scalar" route is the same kernel with kVec = 1: any W, any
//     alignment (17 x 5, 1000 x 1023, a block at an odd offset).  Halos
//     are always read with scalar loads, so they need no alignment.
//   * One launch.  Each CTA's accounting warp draws a ticket with
//     atomicAdd as the CTA starts.  The CTA that draws the last ticket
//     started after every other CTA of the grid, so all of them are
//     running or done: it may wait for them, and it sums the residual.
//     Each data warp sums its |new - old| in a fixed tree, leaves the sum
//     in shared memory, arrives at a named barrier without waiting and
//     stores its rows.  Every other CTA's accounting warp waits there,
//     sums the warp sums in a fixed tree and writes the CTA's partial into
//     a 64-bit word of its own, flagged ready in the same store (relaxed,
//     device scope: no fence).  The elected accounting warp polls the
//     other CTAs' words while its own data warps work, adds its own
//     partial, sums them in index order in a fixed tree, writes the
//     residual and puts the words and the ticket back to zero.  No value
//     passes through an atomic, so the residual is bitwise repeatable,
//     and every launch leaves its ticket and words at zero, so a captured
//     CUDA graph replays as it ran.  The residual still costs about two
//     L2 round trips after the last CTA's data arrives (its partial out,
//     the elected warp's poll back): a ticket drawn at the end behind a
//     fence, the elected warp polling only after its own data, and every
//     CTA gathering the words before its ticket returns were each as slow
//     or slower on the card (probes, not in the repo).
//   * Concurrent calls.  The Gauss–Seidel main path launches this kernel
//     from 4 rank streams at once, so a ticket and its partial words must
//     not be shared between calls that may overlap.  Both live in
//     __device__ arrays (zero when the module loads, so no memset is ever
//     launched, not even under graph capture); the wrapper gives each
//     (device, stream) a ticket slot of its own and each (device, stream,
//     number of CTAs) a range of words of its own, handed out once under
//     a lock.  Launches on one stream run in order, so reusing them is
//     safe; PyTorch hands out streams from a fixed pool, so the table
//     stays small.  A captured graph keeps the slot of the stream it was
//     captured on: replay it where no other call on that stream runs at
//     the same time.
//   * The sum and the scale use __fadd_rn / __fmul_rn (and the build
//     passes --fmad=false), so no FMA contraction changes the rounding:
//     block and edges match the plain PyTorch version bitwise.  Only the
//     residual's order differs from it; that order is, term by term:
//       1. each thread, rows in order, then its kVec columns in order
//          (cells outside the block add nothing);
//       2. the warp's shuffle-down tree (offsets 16, 8, 4, 2, 1) to lane 0;
//       3. the CTA's kWarps warp sums, by the same tree in the accounting
//          warp (lanes beyond kWarps hold 0) -> partial blockIdx.y *
//          gridDim.x + blockIdx.x;
//       4. in the elected CTA's accounting warp, lane l sums partials l,
//          l + 32, ... in order, then step 2's tree.
//     `collective_stages.residual_in_kernel_order` computes it in the same
//     order with tensor operations; chip_smoke.py holds the kernel to it
//     bitwise.
//
// C interface (ctypes): every function returns a CUDA error code after
// its launch, 0 on success.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

// kRows and kWarps are GS_ROWS and GS_WARPS of collective_stages.py.
constexpr int kRows = 4;              // rows of a thread's strip
constexpr int kWarps = 8;             // data warps of a CTA, stacked in rows
constexpr int kThreads = 32 * (kWarps + 1);   // + the accounting warp
constexpr int kBarrier = 1;           // named barrier (0 is __syncthreads)
constexpr int kSlots = 4096;          // tickets: one per (device, stream)
constexpr int kPoolWords = 1 << 19;   // partial words of all streams' calls
constexpr int kPoll = 16;             // partial words a lane holds at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kReady = 1ull << 32;

// One ticket per slot, and the partials of every call, one 64-bit word a
// CTA: the fp32 sum in the low half, kReady set once it is written.  Both
// are zero at module load, and every launch leaves its ticket and its
// words at zero again.
__device__ unsigned int g_tickets[kSlots];
__device__ unsigned long long g_partials[kPoolWords];

// Relaxed accesses at device scope: a partial and its flag travel in one
// 64-bit word, so no fence is needed between them.
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long w) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// bf16 pairs packed in a 32-bit word: element 0 in the low half.  A bf16
// is the top half of the fp32 with the same value, so these are exact.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// kVec consecutive elements at p, any alignment (the halos, and the
// block on the scalar route).
template <typename T, int kVec>
__device__ __forceinline__ void load_scalars(const T* __restrict__ p,
                                             float (&v)[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = to_f(p[k]);
}

// kVec consecutive elements of the block at p (16-byte aligned when
// kVec * sizeof(T) == 16).
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[kVec]) {
  if constexpr (kVec * sizeof(T) == 16 && sizeof(T) == 4) {
    const float4 u = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (kVec * sizeof(T) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_lo(w[k]);
      v[2 * k + 1] = bf16_hi(w[k]);
    }
  } else {
    load_scalars<T, kVec>(p, v);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[kVec]) {
  if constexpr (kVec * sizeof(T) == 16 && sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (kVec * sizeof(T) == 16) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]),
                      bf16_pack(v[4], v[5]), bf16_pack(v[6], v[7])));
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) p[k] = from_f<T>(v[k]);
  }
}

// The shuffle-down tree of a warp; the sum is valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return v;
}

// The data warps hand their sums to the accounting warp through shared
// memory: each arrives at a named barrier without waiting, and goes on to
// its stores; the accounting warp waits there for all of them.
__device__ __forceinline__ void barrier_arrive() {
  asm volatile("bar.arrive %0, %1;" ::"r"(kBarrier), "r"(kThreads)
               : "memory");
}
__device__ __forceinline__ void barrier_wait() {
  asm volatile("bar.sync %0, %1;" ::"r"(kBarrier), "r"(kThreads)
               : "memory");
}

// The CTA's partial: the accounting warp's tree over the data warps' sums
// (lanes beyond kWarps at 0), valid in every lane.
__device__ __forceinline__ float cta_partial(const float* scratch) {
  const int lane = threadIdx.x;
  barrier_wait();
  return __shfl_sync(kFull, warp_sum(lane < kWarps ? scratch[lane] : 0.0f),
                     0);
}

// The accounting warp.  At the CTA's start it draws a ticket; the CTA
// that draws the last one started after every other CTA of the grid, so
// all of them are running or done and it may wait for them.  Every other
// CTA writes its partial into its word and is done.  The elected CTA
// gathers the other CTAs' words while its own data warps work, then adds
// its own partial: lane l sums partials l, l + 32, ... in that order, and
// the lanes' tree gives the residual; the words go back to zero.
__device__ __forceinline__ void account(const float* scratch,
                                        unsigned long long* __restrict__ words,
                                        float* __restrict__ res, int slot) {
  const int lane = threadIdx.x;
  const unsigned int n = gridDim.x * gridDim.y;
  const unsigned int pid = blockIdx.y * gridDim.x + blockIdx.x;
  unsigned int ticket = 0;
  if (lane == 0) ticket = atomicAdd(&g_tickets[slot], 1u);
  if (__shfl_sync(kFull, ticket, 0) != n - 1) {
    const float total = cta_partial(scratch);
    if (lane == 0) store_word(words + pid, kReady | __float_as_uint(total));
    return;
  }
  if (lane == 0) g_tickets[slot] = 0u;   // every ticket is drawn
  float part = 0.0f;
  for (unsigned int chunk = 0; chunk < n; chunk += 32 * kPoll) {
    unsigned long long w[kPoll];       // this lane's words of the chunk
#pragma unroll
    for (int j = 0; j < kPoll; ++j) {
      const unsigned int k = chunk + lane + 32 * j;
      w[j] = k >= n || k == pid ? kReady : kReady - 1;   // 0 or not read
    }
    for (bool ready = false; !ready;) {   // one L2 round trip a pass
#pragma unroll
      for (int j = 0; j < kPoll; ++j)
        if (!(w[j] & kReady)) w[j] = load_word(words + chunk + lane + 32 * j);
      ready = true;
#pragma unroll
      for (int j = 0; j < kPoll; ++j) ready = ready && (w[j] & kReady);
    }
    if (pid - chunk < 32 * kPoll) {     // this CTA's own partial
      const float total = cta_partial(scratch);
#pragma unroll
      for (int j = 0; j < kPoll; ++j)
        if (chunk + lane + 32 * j == pid)
          w[j] = kReady | __float_as_uint(total);
    }
#pragma unroll
    for (int j = 0; j < kPoll; ++j)
      part = __fadd_rn(part, __uint_as_float(static_cast<unsigned int>(w[j])));
  }
  for (unsigned int k = lane; k < n; k += 32) store_word(words + k, 0ull);
  part = warp_sum(part);
  if (lane == 0) *res = part;
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
gs_stencil_kernel(const T* __restrict__ block, const T* __restrict__ top,
                  const T* __restrict__ left, const T* __restrict__ bottom,
                  const T* __restrict__ right, T* __restrict__ out,
                  T* __restrict__ edges, float* __restrict__ res, int slot,
                  int offset, int H, int W) {
  __shared__ float scratch[kWarps];
  if (threadIdx.y == kWarps) {
    account(scratch, g_partials + offset, res, slot);
    return;
  }
  const int lane = threadIdx.x;
  const int c0 = (blockIdx.x * 32 + lane) * kVec;           // first column
  const int i0 = (blockIdx.y * kWarps + threadIdx.y) * kRows;  // first row
  const bool active = c0 < W;
  const bool at_left = c0 == 0;
  const bool at_right = c0 + kVec == W;
  const size_t w = static_cast<size_t>(W);

  // All loads of the strip first: rows i0-1 .. i0+kRows (row -1 is the top
  // halo, row H the bottom one), then the column beyond each end of the
  // warp's span.
  float rows[kRows + 2][kVec];
#pragma unroll
  for (int r = 0; r < kRows + 2; ++r) {
    const int i = i0 - 1 + r;
    if (active && i < 0) {
      load_scalars<T, kVec>(top + c0, rows[r]);
    } else if (active && i < H) {
      load_vec<T, kVec>(block + i * w + c0, rows[r]);
    } else if (active && i == H) {
      load_scalars<T, kVec>(bottom + c0, rows[r]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) rows[r][k] = 0.0f;
    }
  }
  float beyond_left[kRows], beyond_right[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    beyond_left[r] = 0.0f;
    beyond_right[r] = 0.0f;
    if (active && i < H) {
      if (at_left) beyond_left[r] = to_f(left[i]);
      else if (lane == 0) beyond_left[r] = to_f(block[i * w + c0 - 1]);
      if (at_right) beyond_right[r] = to_f(right[i]);
      else if (lane == 31) beyond_right[r] = to_f(block[i * w + c0 + kVec]);
    }
  }

  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    const float(&up)[kVec] = rows[r];
    const float(&c)[kVec] = rows[r + 1];
    const float(&down)[kVec] = rows[r + 2];
    const float from_left = __shfl_up_sync(kFull, c[kVec - 1], 1);
    const float from_right = __shfl_down_sync(kFull, c[0], 1);
    const float lf0 = (at_left || lane == 0) ? beyond_left[r] : from_left;
    const float rtN = (at_right || lane == 31) ? beyond_right[r] : from_right;
    float v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float lf = e == 0 ? lf0 : c[e - 1];
      const float rt = e == kVec - 1 ? rtN : c[e + 1];
      v[e] = __fmul_rn(0.25f,
                       __fadd_rn(__fadd_rn(__fadd_rn(up[e], down[e]), lf),
                                 rt));
    }
    if (active && i < H) {
      store_vec<T, kVec>(out + i * w + c0, v);
      if (i == 0) store_vec<T, kVec>(edges + c0, v);
      if (i == H - 1) store_vec<T, kVec>(edges + w + c0, v);
      if (at_left) edges[2 * w + i] = from_f<T>(v[0]);
      if (at_right) edges[2 * w + H + i] = from_f<T>(v[kVec - 1]);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc = __fadd_rn(acc, fabsf(__fsub_rn(v[e], c[e])));
    }
  }

  acc = warp_sum(acc);
  if (lane == 0) scratch[threadIdx.y] = acc;
  barrier_arrive();
}

inline dim3 grid_of(int H, int W, int vec) {
  return dim3((W + 32 * vec - 1) / (32 * vec),
              (H + kWarps * kRows - 1) / (kWarps * kRows));
}

template <typename T, int kVec>
int launch(const void* block, const void* top, const void* left,
           const void* bottom, const void* right, void* out, void* edges,
           void* res, int H, int W, int slot, int offset, cudaStream_t s) {
  gs_stencil_kernel<T, kVec><<<grid_of(H, W, kVec), dim3(32, kWarps + 1), 0,
                               s>>>(
      static_cast<const T*>(block), static_cast<const T*>(top),
      static_cast<const T*>(left), static_cast<const T*>(bottom),
      static_cast<const T*>(right), static_cast<T*>(out),
      static_cast<T*>(edges), static_cast<float*>(res), slot, offset, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  route: 0 "scalar", 1 "vec" (W a multiple
// of 16 / sizeof(T) and a 16-byte aligned block).

// The number of partial words a call needs: one a CTA.
int gs_stencil_num_partials(int H, int W, int dtype, int route) {
  const int vec = route == 1 ? (dtype == 0 ? 4 : 8) : 1;
  const dim3 g = grid_of(H, W, vec);
  return static_cast<int>(g.x * g.y);
}

// The number of ticket slots and of partial words: the wrapper's slot
// must be below the first, and its words [offset, offset + n) inside the
// second.
int gs_stencil_num_slots() { return kSlots; }
int gs_stencil_pool_words() { return kPoolWords; }

// block (H, W) and halos top (W), left (H), bottom (W), right (H) in; the
// new block and `edges` (top W, bottom W, left H, right H, one buffer) in
// the block's dtype, the fp32 residual `res` out.  Ticket `slot` and the
// partial words from `offset` on are used only by launches on `stream`.
int gs_stencil_fwd(const void* block, const void* top, const void* left,
                   const void* bottom, const void* right, void* out,
                   void* edges, void* res, int H, int W, int dtype, int route,
                   int slot, int offset, void* stream) {
  if (H < 1 || W < 1 || slot < 0 || slot >= kSlots || dtype < 0 ||
      dtype > 1 || route < 0 || route > 1 ||
      (route == 1 && W % (dtype == 0 ? 4 : 8)) || offset < 0 ||
      offset > kPoolWords - gs_stencil_num_partials(H, W, dtype, route))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return route == 1
        ? launch<float, 4>(block, top, left, bottom, right, out, edges, res,
                           H, W, slot, offset, s)
        : launch<float, 1>(block, top, left, bottom, right, out, edges, res,
                           H, W, slot, offset, s);
  return route == 1
      ? launch<__nv_bfloat16, 8>(block, top, left, bottom, right, out, edges,
                                 res, H, W, slot, offset, s)
      : launch<__nv_bfloat16, 1>(block, top, left, bottom, right, out, edges,
                                 res, H, W, slot, offset, s);
}

}  // extern "C"
