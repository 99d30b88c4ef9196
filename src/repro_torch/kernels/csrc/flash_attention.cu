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
// TFLOP/s bf16 tensor-core peak against 0.0063 ms for the bytes.
//
// Both instances share the block's shape of work:
//   * A block owns query rows of ONE kv head: the rows are (position,
//     head) pairs over the `rep` query heads that share that kv head (hpb
//     heads x ppb positions), so each K/V tile staged in shared memory
//     serves all of them.  A loop inside the block over key tiles takes the
//     place of the TPU's sequential key-block grid axis, with m, l and the
//     fp32 accumulator in registers.
//   * Causal and window bounds give each block its first and last key
//     tile, so fully masked tiles are never loaded (the Pallas kernel's
//     `pl.when(run)`); masking inside a tile is per element, which also
//     covers the ragged last tile of any T and the ragged last position
//     tile of any S.  Heavy (late) position tiles are scheduled first:
//     fp32 by the order of its grid, bf16 by the order in which its
//     persistent blocks walk them.
//   * Deterministic: no atomics, no split of the key axis, fixed orders of
//     every sum, so two calls are bitwise equal.
//
// bf16 (the served dtype): the tensor cores, fed by TMA through a
// warp-specialised pipeline (helpers in hopper.cuh).  At the served shapes
// the softmax's instruction stream, not the products, sets its time
// (PERF.md section 6).
//   * 384 threads: warpgroups 0 and 1 each own 64 of a work item's 128
//     query rows; one thread of warpgroup 2 issues every load.  setmaxnreg
//     gives the producer 40 registers and each consumer 232.
//   * Persistent: one block per SM walks the items (position tile, head
//     group), heaviest first, in a snake over the blocks, so the next
//     item's Q and first K/V tiles load while the current one finishes.
//   * TMA: q seen as the 4-D tensor (D, H, S, B) and k, v as (D, Hkv, T,
//     B), so a box past S or T reads zeros and never the next batch's rows.
//     Tiles are cut into column slices, one box each, whose rows are the
//     swizzle's width: 64 columns under the 128-byte swizzle at D = 64 and
//     128, 16 under the 32-byte one at D = 16, 32 and 80 (a 160-byte row
//     fits no swizzle; 128 bytes measured faster than 32 where both fit).
//     The q box (cols, hpb, ppb, 1) lands in exactly the item's (position,
//     head) row order; a k or v box is (cols, 1, BK, 1) for a key tile of
//     BK = 128 (64 at D = 128, where 128 keys spill).  Q is loaded once an
//     item, released after the item's last Q . K^T; K and V go through a
//     ring of 2-4 stages, each with a full (TMA bytes) and an empty (8
//     consumer warps) mbarrier.
//   * S = Q . K^T: wgmma m64nBKk16, A = Q and B = K both K-major in shared
//     memory (D contiguous), one k-step per 32 bytes of a slice, fp32
//     accumulators.
//   * O += P . V: wgmma m64nDk16 with A = P from registers -- the fp32 S
//     fragment rounded to bf16 pairs in place, since the accumulator layout
//     of 16 score columns is the A layout of the next product -- and B = V,
//     N-contiguous in shared memory (the transpose bit).  l sums the fp32 p
//     before that rounding, as the reference does; the rounding of P is
//     the one place where the bf16 instance differs from the reference
//     beyond summation order (the same choice SDPA makes).
//   * The mask runs only on tiles that cross the diagonal, the window edge
//     or T for some row of the warpgroup, as two compares of each column
//     against bounds computed once per row.  The softmax runs in
//     base 2 on raw scores: p = 2^(s c - m c), c = log2(e) / sqrt(D), one
//     FFMA and one ex2.approx.ftz each (exp2f wraps the same instruction
//     in a denormal path that cost more than the products).  A stage is
//     released after the product that reads its V has completed.
// fp32: the FMA pipes, which keeps fp32 inputs exact to fp32 (TF32 would
// not hold the fp32 tolerance); not the served dtype.
//   * One block of 128 threads owns 64 query rows.  Both products are
//     register-tiled like a GEMM: each thread owns 8 rows x 4 score columns
//     of the (64 x 64) score tile and 8 rows x D/16 output columns, so
//     every shared-memory load feeds 4-8 FMAs.  The 16 threads that share
//     a row sit in one half-warp, so row max and row sum are four xor
//     shuffles.  Q, K and P are kept transposed in shared memory so that a
//     thread's 8 rows or 4 columns are one or two 16-byte loads.
//   * Shared memory (Q^T, K^T, V, P^T in fp32) is 30-120 KB by D, above
//     the 48 KB default from D = 64 on, so each launch raises the
//     kernel's dynamic limit.  expf (not __expf), explicit fmaf.
//
// C interface (ctypes): flash_attention_fwd returns cudaGetLastError()
// after its launch, 0 on success, 1000 + a CUresult when the driver
// refuses a tensor map; dtype codes are 0 = fp32, 1 = bf16.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

// ---- fp32: the FMA pipes ---------------------------------------------------

namespace f32 {


constexpr int kRows = 64;       // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 4 warps; warp w owns rows [16w, 16w + 16)
constexpr int kTM = 8;          // rows per thread
constexpr int kTN = kBK / 16;   // score columns per thread
constexpr int kPad = 4;         // keeps transposed rows 16-byte aligned
constexpr int kRowStride = kRows + kPad;
constexpr int kKeyStride = kBK + kPad;
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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


}  // namespace f32

// ---- bf16: wgmma, TMA and a warp-specialised K/V pipeline ------------------

namespace bf16 {

constexpr int kRows = 128;              // query rows per block
constexpr int kConsumers = 2;           // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmemBudget = 200 * 1024;   // Q and the K/V ring

template <int D>
struct Tile {
  // keys per tile: at D = 128 a 128-key tile needs more than the
  // consumers' 232 registers (S, P and O at once) and spills
  static constexpr int kBK = D == 128 ? 64 : 128;
  // column slices: 64 columns under the 128-byte swizzle where D allows,
  // else 16 under the 32-byte one (D = 16, 32, 80)
  static constexpr int kCols = D % 64 == 0 ? 64 : 16;
  static constexpr int kRowBytes = 2 * kCols;           // = the swizzle
  static constexpr int kSlices = D / kCols;
  static constexpr int kQSlice = kRows * kRowBytes;     // bytes
  static constexpr int kKVSlice = kBK * kRowBytes;
  static constexpr int kQBytes = kSlices * kQSlice;
  static constexpr int kKVBytes = kSlices * kKVSlice;   // one K or V tile
  static constexpr int kFit = (kSmemBudget - kQBytes) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // 1024 bytes of slack to align the tiles, then Q, the K ring, the V
  // ring and the barriers (Q, full and empty per stage)
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (2 + 2 * kStages);
};

// The work is cut into items of one (position tile, head group): group =
// ((b * Hkv + g) * n_hchunks + hc), hc the chunk of hpb query heads of kv
// head g.  Row i of an item is position p0 + i / hpb of query head h0 + i %
// hpb, valid for i < hpb * ppb and pos < S.  Items are numbered heaviest
// (latest positions) first, w = (n_ptiles - 1 - ptile) * n_groups + group.
struct Item {
  int b, g, p0, h0, kt_begin, kt_end;   // [kt_begin, kt_end): key tiles
};

template <int BK>
__device__ __forceinline__ Item item_of(int w, int n_groups, int n_ptiles,
                                        int S, int Tk, int H, int Hkv,
                                        int hpb, int ppb, int n_hchunks,
                                        int causal, int window) {
  Item it;
  const int group = w % n_groups;
  it.g = (group / n_hchunks) % Hkv;
  it.b = group / (n_hchunks * Hkv);
  it.p0 = (n_ptiles - 1 - w / n_groups) * ppb;
  it.h0 = it.g * (H / Hkv) + (group % n_hchunks) * hpb;
  // key tiles that can hold an unmasked element for some row of the item
  const int q_hi = min(it.p0 + ppb, S) - 1;
  it.kt_begin = window >= 0 ? max(0, it.p0 - window + 1) / BK : 0;
  it.kt_end = (Tk + BK - 1) / BK;
  if (causal) it.kt_end = min(it.kt_end, q_hi / BK + 1);
  return it;
}

// The persistent grid of G blocks walks the items in a snake, block b
// taking w = b, 2G - 1 - b, 2G + b, ...: with items heaviest first, every
// block gets about the same work.  Item r of this block, or >= n_items.
__device__ __forceinline__ int item_at(int r, int G) {
  const int b = static_cast<int>(blockIdx.x);
  return r * G + ((r & 1) ? G - 1 - b : b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int S, int Tk,
                            int H, int Hkv, int hpb, int ppb, int n_hchunks,
                            int n_groups, int n_ptiles, int causal,
                            int window, float scale_log2) {
  using C = Tile<D>;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_tc[];
  uint8_t* sq = smem_tc + ((1024 - (hopper::smem_addr(smem_tc) & 1023)) &
                           1023);
  uint8_t* sk = sq + C::kQBytes;                  // [stage][slice][BK][32 B]
  uint8_t* sv = sk + C::kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv +
                                                 C::kStages * C::kKVBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + C::kStages;
  const int n_items = n_groups * n_ptiles;
  const int G = gridDim.x;
  const int n_rows = hpb * ppb;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 4 * kConsumers);   // lane 0 of each warp
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ---- producer: one thread keeps the loads in flight.  An item's Q
    // waits until the consumers have issued the last product that reads
    // the previous item's, so it lands during that item's last tile. ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * kConsumers) {
      hopper::tma_prefetch(&qmap);
      hopper::tma_prefetch(&kmap);
      hopper::tma_prefetch(&vmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0; item_at(r, G) < n_items; ++r) {
        const Item it = item_of<BK>(item_at(r, G), n_groups, n_ptiles, S, Tk,
                                    H, Hkv, hpb, ppb, n_hchunks, causal,
                                    window);
        hopper::mbar_wait(q_empty, (r & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, C::kSlices * n_rows * C::kRowBytes);
        for (int j = 0; j < C::kSlices; ++j)
          hopper::tma_load_4d(sq + j * C::kQSlice, &qmap, q_full,
                              C::kCols * j, it.h0, it.p0, it.b);
        for (int kt = it.kt_begin; kt < it.kt_end; ++kt) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&full[stage], 2 * C::kKVBytes);
          uint8_t* ks = sk + stage * C::kKVBytes;
          uint8_t* vs = sv + stage * C::kKVBytes;
          for (int j = 0; j < C::kSlices; ++j) {
            hopper::tma_load_4d(ks + j * C::kKVSlice, &kmap, &full[stage],
                                C::kCols * j, it.g, kt * BK, it.b);
            hopper::tma_load_4d(vs + j * C::kKVSlice, &vmap, &full[stage],
                                C::kCols * j, it.g, kt * BK, it.b);
          }
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) ----
    hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int r0 = 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
    const uint32_t q_base = hopper::smem_addr(sq) + wg * 64 * C::kRowBytes;
    const int w_first = 64 * wg;            // the warpgroup's rows
    const int w_last = min(64 * wg + 63, n_rows - 1);
    int stage = 0;
    uint32_t phase = 0;
    for (int r = 0; item_at(r, G) < n_items; ++r) {
      const Item it = item_of<BK>(item_at(r, G), n_groups, n_ptiles, S, Tk,
                                  H, Hkv, hpb, ppb, n_hchunks, causal,
                                  window);
      // rows r0 and r0 + 8: position (-1: none) and the keys the mask
      // keeps, lo < key <= hi, both less 2 * quad (this thread's first
      // column)
      int pos[2], lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + 8 * h;
        pos[h] = (i < n_rows && it.p0 + i / hpb < S) ? it.p0 + i / hpb : -1;
        hi[h] = pos[h] < 0 ? -1 : (causal ? min(pos[h], Tk - 1) : Tk - 1);
        lo[h] = window >= 0 ? pos[h] - window : -1;
        hi[h] -= 2 * quad;
        lo[h] -= 2 * quad;
      }
      // a tile needs the mask when it crosses the diagonal, the window
      // edge or T for some valid row of the warpgroup
      const bool w_any = w_first <= w_last && it.p0 + w_first / hpb < S;
      const int w_lo = it.p0 + w_first / hpb;
      const int w_hi = min(it.p0 + w_last / hpb, S - 1);

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
      float m[2] = {kNegInf, kNegInf};      // in raw (unscaled) scores
      float l[2] = {0.0f, 0.0f};            // this thread's columns only

      hopper::mbar_wait(q_full, r & 1);
      if (it.kt_begin >= it.kt_end && lane == 0) hopper::mbar_arrive(q_empty);
      for (int kt = it.kt_begin; kt < it.kt_end; ++kt) {
        const int k0 = kt * BK;
        const uint32_t ks = hopper::smem_addr(sk + stage * C::kKVBytes);
        const uint32_t vs = hopper::smem_addr(sv + stage * C::kKVBytes);
        hopper::mbar_wait(&full[stage], phase);

        // raw scores s = Q . K^T in D/16 k-steps of 32 bytes; the scale is
        // folded into the exponent below
        float s[BK / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          const int sl = j / (C::kCols / 16);         // the slice, and 32
          const int in = 32 * (j % (C::kCols / 16));  // bytes a step in it
          hopper::wgmma_ss<BK>(
              s,
              hopper::smem_desc<C::kRowBytes>(
                  q_base + sl * C::kQSlice + in, 16, 8 * C::kRowBytes),
              hopper::smem_desc<C::kRowBytes>(
                  ks + sl * C::kKVSlice + in, 16, 8 * C::kRowBytes),
              j);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (kt + 1 == it.kt_end && lane == 0) hopper::mbar_arrive(q_empty);

        const bool masked = !w_any || k0 + BK > Tk ||
                            (causal && k0 + BK - 1 > w_lo) ||
                            (window >= 0 && k0 <= w_hi - window);
        if (masked) {
          const int tlo[2] = {lo[0] - k0, lo[1] - k0};
          const int thi[2] = {hi[0] - k0, hi[1] - k0};
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int c = 8 * (i / 4) + i % 2;   // key - k0 - 2 * quad
            const int h = (i / 2) % 2;
            s[i] = c > tlo[h] && c <= thi[h] ? s[i] : kNegInf;
          }
        }

        // online softmax in base 2, p = 2^(s c - m c) with c = log2(e) /
        // sqrt(D) (one FFMA); the 4 threads of a quad share a row
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
        float alpha[2], mc[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          alpha[h] = m[h] == kNegInf
                         ? 0.0f
                         : hopper::exp2_approx((m[h] - mx[h]) * scale_log2);
          m[h] = mx[h];
          mc[h] = mx[h] * scale_log2;
          l[h] *= alpha[h];
        }
        uint32_t pa[BK / 16][4];            // P as wgmma A fragments
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int i = 8 * kk + 2 * t;   // elements i, i + 1 of row t % 2
            const int h = t % 2;
            float pe = hopper::exp2_approx(fmaf(s[i], scale_log2, -mc[h]));
            float po =
                hopper::exp2_approx(fmaf(s[i + 1], scale_log2, -mc[h]));
            if (masked) {                   // 0 where masked, also while m
              pe = s[i] == kNegInf ? 0.0f : pe;      // is still NEG_INF
              po = s[i + 1] == kNegInf ? 0.0f : po;
            }
            l[h] += pe + po;
            pa[kk][t] = hopper::pack_bf16(pe, po);
          }
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

        // acc += P . V over the BK/16 key steps
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_rs_tb<D>(
              acc, pa[kk],
              hopper::smem_desc<C::kRowBytes>(vs + kk * 16 * C::kRowBytes,
                                              C::kKVSlice,
                                              8 * C::kRowBytes));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (lane == 0) hopper::mbar_arrive(&empty[stage]);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pos[h] < 0) continue;
        const float li = l[h] == 0.0f ? 1.0f : l[h];
        __nv_bfloat16* dst =
            o + ((long long)(it.b * S + pos[h]) * H + it.h0 +
                 (r0 + 8 * h) % hpb) * D + 2 * quad;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
              __floats2bfloat162_rn(acc[4 * c + 2 * h] / li,
                                    acc[4 * c + 2 * h + 1] / li);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
  using C = Tile<D>;
  if (Tk <= 0)                  // no key: every row's l is 0, o = 0
    return cudaMemsetAsync(o, 0, sizeof(__nv_bfloat16) * B * S * H * D,
                           stream);
  const int rep = H / Hkv;
  int hpb = 1;                  // the largest divisor of rep up to kRows
  for (int c = 1; c <= rep && c <= kRows; ++c)
    if (rep % c == 0) hpb = c;
  const int ppb = kRows / hpb;
  const int n_hchunks = rep / hpb;
  const int n_ptiles = (S + ppb - 1) / ppb;

  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 e = sizeof(__nv_bfloat16);
  CUtensorMap qm, km, vm;
  const u64 qdims[4] = {u64(D), u64(H), u64(S), u64(B)};
  const u64 qstrides[3] = {D * e, u64(H) * D * e, u64(S) * H * D * e};
  const u32 qbox[4] = {u32(C::kCols), u32(hpb), u32(ppb), 1};
  const u64 kdims[4] = {u64(D), u64(Hkv), u64(Tk), u64(B)};
  const u64 kstrides[3] = {D * e, u64(Hkv) * D * e, u64(Tk) * Hkv * D * e};
  const u32 kbox[4] = {u32(C::kCols), 1, u32(C::kBK), 1};
  const int sw = C::kRowBytes;
  int err = hopper::encode_bf16_4d(&qm, q, qdims, qstrides, qbox, sw);
  if (err == 0)
    err = hopper::encode_bf16_4d(&km, k, kdims, kstrides, kbox, sw);
  if (err == 0)
    err = hopper::encode_bf16_4d(&vm, v, kdims, kstrides, kbox, sw);
  if (err != 0) return err;

  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (set != cudaSuccess) return set;
  int dev = 0, n_sm = 0;                // one block per SM, persistent
  cudaError_t got = cudaGetDevice(&dev);
  if (got == cudaSuccess)
    got = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (got != cudaSuccess) return got;
  const int n_groups = B * Hkv * n_hchunks;
  const int n_items = n_groups * n_ptiles;
  const int G = n_items < n_sm ? n_items : n_sm;
  flash_attention_bf16_kernel<D><<<G, kThreads, C::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, Tk, H, Hkv, hpb, ppb,
      n_hchunks, n_groups, n_ptiles, causal, window,
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace bf16

// f(std::integral_constant<int, D>{}) for a head dim the kernels take.
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
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
      return with_head_dim(D, [&](auto d) {
        return f32::launch<float, decltype(d)::value>(
            q, k, v, o, B, S, Tk, H, Hkv, causal, window, s);
      });
    case kBF16:
      return with_head_dim(D, [&](auto d) {
        return bf16::launch<decltype(d)::value>(q, k, v, o, B, S, Tk, H, Hkv,
                                              causal, window, s);
      });
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
