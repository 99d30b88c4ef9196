// Chunkwise stabilised mLSTM (xLSTM matrix memory), forward, for Hopper
// (sm_90a), from a zero initial state.
//
// Replaces the Pallas TPU kernel `mlstm_chunk` (`_kernel`) of
// src/repro/kernels/mlstm_chunk.py.  Per (batch, head) and chunk of length
// l, with lf = log sigmoid(f) and F its inclusive cumsum over the chunk:
//   a[i,j]  = (F_i - F_j) + i_j for j <= i     (masked above the diagonal)
//   m_new_i = max(max_j a[i,j], F_i + m)
//   S       = (q k^T) o exp(a - m_new)          (0 above the diagonal)
//   num     = S v + (q C) s,  den = rowsum(S) + (q.n) s,  s = exp(F + m - m_new)
//   y       = num / max(|den|, exp(-m_new))
//   C <- C exp(F_l + m - m_l) + (k o w)^T v,  n likewise,  m <- m_new_l,
//   w_j = exp(((i_j + F_l) - F_j) - m_new_l).
//   q, k, v (b, s, h, d), all fp32 or all bf16; i and f gate logits
//   (b, s, h) fp32; y (b, s, h, d) in q's dtype; final C (b, h, d, d),
//   n (b, h, d), m (b, h) fp32; contiguous, q, k and v 16-byte aligned.
//
// Bound on an H100 SXM at xlstm-350m's prefill call ((1, 2048, 4, 512),
// chunk 256, bf16): bytes ~37.8 MB (q, k, v, y 33.6 MB, the final C 4.2
// MB), 0.0113 ms at 3.35 TB/s; operations ~10.75 GFLOP over the lower
// triangles (q k^T and S v, q C and the k^T v update), 0.0109 ms at the
// 989 TFLOP/s bf16 tensor-core peak.
//
// Two routes, which the wrapper picks from dtype, shape and alignment
// (repro_torch.kernels.mlstm_chunk.route):
//   * kWgmma: bf16 with d a multiple of 64 up to 512, a chunk that is a
//     multiple of 64 up to 256, and q, k, v, y 16-byte aligned -- the
//     tensor cores, fed by TMA (helpers in hopper.cuh);
//   * kFma: everything else (fp32, and the other bf16 shapes) -- one block
//     per (batch, head, column tile of C) walking the chunks in order
//     (mlstm_chunk_kernel below, unchanged since it was first written).
//
// kWgmma is the chunk-parallel mLSTM in four launches on one stream, not
// the Pallas kernel's grid-carried scan: the state recurrence is the SSD's
// (mamba2_ssd.cu) with a (d x d) state, a normaliser n and a scalar
// stabiliser chain per (b, h), and once that chain is known every chunk's
// own state can be formed at once.
//   0. mlstm_gates_kernel, one block per (b, chunk, head): F (the
//      fixed-order block scan), the masked row maxima, the stabiliser
//      entering the chunk (the chain m <- max(m_local[l - 1], F[l - 1] + m)
//      over the chunks before it, each rescanned by a warp of its own for
//      its total and its last row's maximum), then m_new, scin = exp(m_in -
//      m_new), w_end, i and the chunk's decay into fp32 scratch (b, nc, h,
//      5, l) and (b, nc, h); the final m.
//   1. mlstm_chunk_state_kernel, one block per (b, chunk, head, 128 x NT
//      tile of the state), a programmatic dependent of pass 0, released
//      once pass 0 has its gates in (its first k and v then load while
//      pass 0 computes): K_c = (k o w_end)^T v on wgmma, A from registers
//      (k read transposed by ldmatrix.trans, scaled, split into bf16 hi +
//      lo), v N-contiguous through the transpose bit, 64 positions at a
//      time through a two-stage ring (two blocks an SM); n_c from the
//      unrounded fp32 products.  Fp32 scratch (b, nc, h, d, d).
//   2. mlstm_state_pass_kernel, one thread per 4 elements of (b, h, d, d)
//      and of n, in fp32 in chunk order: C <- C decay_c + K_c; the C
//      entering each chunk after the first goes out as a bf16 hi + lo
//      pair, the n entering it in fp32; the last state is the final C, n.
//   3. mlstm_chunk_out_kernel, one warpgroup a block per (b, chunk, head,
//      column tile of NT, pair of row slabs of 64: nb - 1 - p and p, so
//      every block has the same number of lower-triangle tiles), a
//      programmatic dependent of pass 2: the slab's q stays in shared
//      memory, k, v and the carried state stream through a three-stage
//      TMA ring, thread 0 refilling a stage as soon as its products have
//      completed; S = q k^T and P . v (P as hi + lo register fragments)
//      for each key tile at or below the diagonal -- before
//      griddepcontrol.wait, so while pass 2 ends -- then q . (C_hi +
//      C_lo)[:, cols] and q.n.  q k^T is formed d / NT times per (head,
//      chunk): 4x at d = 512, not 32x.  The gates and n are read through
//      the L1, which leaves the shared memory to the tiles.
//   NT = 128 where d is a multiple of 128, else 64.  Shared memory: pass 1
//   66 KB, pass 3 113 KB at d = 512 (two blocks an SM each, the SM's whole
//   228 KB as shared memory; pass 3's 256 blocks at xlstm's shape in one
//   wave).  Scratch (from the wrapper): K_c, n_c, the n entering each chunk
//   and the gates in one fp32 buffer, the carried states (2, b, nc, h, d,
//   d) in bf16.
//   At xlstm's shape the four launches take about 0.12 ms on an H100 SXM at
//   700 W (chip_smoke.py phase 18; the kFma kernel 1.08 ms), 11x the bound:
//   by their shapes they move ~190 MB (the chunk states out and in, the
//   carried states out and in, k and q re-read per column tile), and pass
//   3's blocks are bound by the latency of each ring stage's load,
//   products and barrier, one stage at a time.  Variants
//   that were slower (probes not in the repo): pass 3 with two warpgroups
//   of one block sharing each round's key tiles and carried state (fewer
//   bytes, but the warpgroups wait for each other at every stage, one
//   block an SM); issuing a stage's products before waiting for the
//   previous stage's (a stage is then held longer, and fewer loads are in
//   flight); refilling a stage only once the next products were issued.
// Numerics of kWgmma: every product sums in fp32, and every tensor-core
// operand that the plain version keeps in fp32 -- k o w_end, the carried
// C, P -- goes in as a bf16 pair hi = bf16(v), lo = bf16(v - hi), two
// products into one accumulator (~2^-17 relative); q k^T takes bf16 q and k
// as they are (their products are exact in fp32).  Rounded once, any one of
// the three puts y outside its elementwise 2e-2 gate
// (tests/test_torch_mlstm.py test_wgmma_splits_are_needed).  den sums the
// fp32 P, never the rounded one; n and m come from the fp32 gate math.
// exp(a - m_new) is ex2.approx of its log2e multiple (a and a - m_new
// rounded as the plain version rounds them); the gates use expf.
//
// kFma: fp32 everywhere inside but the bf16 inputs of q k^T; d a multiple
// of 16 from 16 to 512; chunks 1 to 256 (a ragged last chunk is masked,
// though the wrapper keeps the JAX contract s % chunk == 0).  What the
// design does:
//   * d = 512 does not fit.  One head's C is 1 MiB of fp32 and one chunk's
//     q or k 512 KB.  So one block of 256 threads owns (batch, head,
//     column tile of 16 of C): its 16 columns of C and of y (d x 16 fp32,
//     32 KB at d = 512), the whole n, and a chunk's v columns (l x 16).
//     It loops over the chunks (Hopper has no sequential grid axis).  At
//     xlstm's shape that is 4 x 32 = 128 blocks, one wave on 132 SMs.
//   * The price: every column tile recomputes the same q k^T (d / 16
//     times, 32x at d = 512), its row sums, the gates' stabiliser chain
//     and n.  q k^T is formed in 64 x 64 tiles, only those at or below the
//     diagonal, accumulated over d in slices of 128.  For bf16 inputs it
//     runs on the tensor cores (mma.sync m16n8k16, fp32 accumulators: the
//     products of two bf16 values are exact in fp32, so only the order of
//     the sums differs from an fp32 dot product); for fp32 inputs on the
//     FMA pipes.  The slices are copied with cp.async into two buffers, the
//     next in flight while the current one is multiplied.  The weighted
//     tile goes through shared memory into S v.  Computing q k^T once per
//     (head, chunk) is the first thing a faster version would change.
//   * The state products stay fp32 (C is fp32), on the FMA pipes: q C and
//     q.n in a pass of their own over the chunk's q, and the k^T v update
//     over (64 x 256) k tiles, each thread with a 4 x 4 patch, so that
//     each value read from shared memory feeds 4 or 5 FMAs (shared-memory
//     reads, not FMAs, bounded these loops with a patch of 1 x 4).
//   * Shared memory: at d = 512 about 140 KB a block for bf16 (208 KB for
//     fp32), raised per launch above the 48 KB default.
//   At xlstm's shape it takes 1.08 ms on an H100 SXM at 700 W, about 95x
//   its bound (chip_smoke.py phase 18).
//   * No -inf arithmetic.  The stabiliser starts at -1e30, padded steps
//     carry i = -1e30, masked weights are 0: nothing forms inf - inf.
// Numerics of kFma: fp32 everywhere but the bf16 inputs of q k^T.  The cumsum is
// a fixed-order block scan (shuffles within a warp, then the warp totals
// added in warp order), the plain version's order; no atomics, so two
// calls are bitwise equal.  The build uses --fmad=false: dot products
// contract on purpose through explicit fmaf; every other product and sum
// rounds on its own, in the Pallas body's order.  expf and log1pf (not the
// fast intrinsics).
//
// Both routes are deterministic: no atomics, no split of a sum across
// blocks, fixed orders, so two calls are bitwise equal.
//
// C interface (ctypes): mlstm_chunk_fwd returns cudaGetLastError() after
// its launches, 0 on success, 1000 + a CUresult when the driver refuses a
// tensor map; dtype codes are 0 = fp32, 1 = bf16, route codes 0 = kFma, 1 =
// kWgmma.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRB = 64;         // rows (and columns) of a chunk tile
constexpr int kMaxChunk = 256;  // one gate step per thread
constexpr int kE = 16;          // columns of C and y a block owns
constexpr int kKC = 128;        // depth of a staged q / k slice
constexpr int kMaxD = 512;
constexpr int kSS = kRB + 1;    // Ss rows: odd, so a tile's stores spread
constexpr float kNeg = -1e30f;
static_assert(kMaxChunk == kThreads, "the scan gives each thread one step");
static_assert(kRB * kRB == 16 * kThreads, "4 x 4 tile patch per thread");
static_assert(kRB * kE == 4 * kThreads, "4 y columns per thread");

enum DType { kF32 = 0, kBF16 = 1 };
// Routes of the C interface, chosen by the wrapper from dtype, shape and
// alignment alone (repro_torch.kernels.mlstm_chunk.route).
enum Route { kFma = 0, kWgmma = 1 };

// A staged (kRB x kKC) slice of T, row-major, rows padded by one 16-byte
// vector (so that the tensor-core fragment loads of 8 rows hit 32 banks).
template <typename T>
struct Slice {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLd = kKC + kVec;
  static constexpr int kElems = kRB * kLd;
  static constexpr int kPerThread = kRB * kKC / kVec / kThreads;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
// 4 consecutive bf16 of shared memory (8-byte aligned) as floats
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&out)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// 16 bytes of global memory at p (16-byte aligned) as floats: 4 fp32 or 8
// bf16.
__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    out[2 * e] = f.x; out[2 * e + 1] = f.y;
  }
}

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

template <typename T>
int smem_bytes(int D) {
  return 4 * Slice<T>::kElems * static_cast<int>(sizeof(T))  // q, k x 2
         + static_cast<int>(sizeof(float)) *
               (D * kE               // Cs
                + D                  // ns
                + kMaxChunk * kE     // vs
                + kRB * kSS          // Ss
                + 5 * kMaxChunk      // igs, lfc, mnew, scin, wend
                + kRB                // dsum
                + kThreads / 32);    // warp totals of the scan
}

// Block x: (b * H + h) * (D / kE) + column tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, T* __restrict__ y,
                   float* __restrict__ Cf, float* __restrict__ nf,
                   float* __restrict__ mf, int S, int H, int D, int chunk) {
  using SL = Slice<T>;
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem_raw[];
  T* Qb = reinterpret_cast<T*>(smem_raw);          // [2][kRB][kLd] q slices
  T* Kb = Qb + 2 * SL::kElems;                     // [2][kRB][kLd] k slices
  float* Cs = reinterpret_cast<float*>(Kb + 2 * SL::kElems);  // [D][kE]
  float* ns = Cs + D * kE;                         // [D] n
  float* vs = ns + D;                              // [kMaxChunk][kE] v
  float* Ss = vs + kMaxChunk * kE;                 // [kRB col][kSS row]
  float* igs = Ss + kRB * kSS;                     // [kMaxChunk] i
  float* lfc = igs + kMaxChunk;                    // cumsum(log sigmoid f)
  float* mnew = lfc + kMaxChunk;                   // row stabilisers
  float* scin = mnew + kMaxChunk;                  // exp(m_in - m_new)
  float* wend = scin + kMaxChunk;                  // end-of-chunk weights
  float* dsum = wend + kMaxChunk;                  // [kRB] row sums of S
  float* wsum = dsum + kRB;                        // [kThreads / 32]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_et = D / kE;
  const int et = blockIdx.x % n_et;
  const int e0 = et * kE;
  const int bh = blockIdx.x / n_et;                // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const long long row0 = (long long)b * S;         // (b, position 0)
  const long long row_stride = (long long)H * D;   // one position

  // a thread's y row in each row block (and C row in each row group of
  // the update) and its first of 4 columns
  const int yr = tid >> 2;
  const int yc = (tid & 3) * 4;
  // q k^T tile: the FMA path's 4 x 4 patch (rows 4rg, cols 4cg); the
  // tensor-core path's warp tile of 16 rows x 32 columns and the fragment
  // coordinates g (row) and t4 (column pair) of the lane
  const int rg = tid >> 4, cg = tid & 15;
  const int wr = 16 * (warp >> 1), wc = 32 * (warp & 1);
  const int g = lane >> 2, t4 = lane & 3;

  int l = 0;                    // the current chunk's length
  long long base = 0;           // its first element, (b, c0, h, 0)
  // rows [r0, r0 + kRB) of X from column col0, a (kRB x kKC) slice, into
  // dst with cp.async (zeros past l and past D)
  auto stage = [&](T* dst, const T* X, int r0, int col0) {
#pragma unroll
    for (int u = 0; u < SL::kPerThread; ++u) {
      const int vi = tid + u * kThreads;
      const int r = vi / (kKC / SL::kVec);
      const int c = (vi % (kKC / SL::kVec)) * SL::kVec;
      const bool ok = r0 + r < l && col0 + c < D;
      const T* src = ok ? X + base + (r0 + r) * row_stride + col0 + c : X;
      cp_async16(dst + r * SL::kLd + c, src, ok);
    }
  };
  // rows [r0, r0 + kRB) of X from column col0, kWide columns, into dst
  // (row stride kLdW) -- the update's k tiles
  constexpr int kWide = 4 * kRB;
  constexpr int kLdW = kWide + SL::kVec;
  static_assert(kRB * kLdW <= 4 * SL::kElems, "a wide tile fits the slices");
  auto stage_wide = [&](T* dst, const T* X, int r0, int col0) {
#pragma unroll
    for (int u = 0; u < kRB * kWide / SL::kVec / kThreads; ++u) {
      const int vi = tid + u * kThreads;
      const int r = vi / (kWide / SL::kVec);
      const int c = (vi % (kWide / SL::kVec)) * SL::kVec;
      const bool ok = r0 + r < l && col0 + c < D;
      const T* src = ok ? X + base + (r0 + r) * row_stride + col0 + c : X;
      cp_async16(dst + r * kLdW + c, src, ok);
    }
  };

  for (int idx = tid; idx < D * kE; idx += kThreads) Cs[idx] = 0.0f;
  for (int idx = tid; idx < D; idx += kThreads) ns[idx] = 0.0f;
  float m_carry = kNeg;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    l = min(chunk, S - c0);
    base = ((row0 + c0) * H + h) * D;
    const int nb = (l + kRB - 1) / kRB;
    __syncthreads();            // the previous chunk's readers are done

    // gates, and the inclusive scan of log sigmoid(f) over the chunk
    float lf = 0.0f, igv = kNeg;
    if (tid < l) {
      const long long gi = (row0 + c0 + tid) * H + h;
      const float fv = fg[gi];
      igv = ig[gi];
      lf = fminf(fv, 0.0f) - log1pf(expf(-fabsf(fv)));
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, lf, off);
      if (lane >= off) lf += u;
    }
    if (lane == 31) wsum[warp] = lf;
    igs[tid] = igv;
    // this block's v columns of the chunk, fp32 (zeros past l)
    {
      constexpr int kV = SL::kVec;
      constexpr int kN = kMaxChunk * kE / kV / kThreads;
      float vreg[kN][kV];
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        const int vi = tid + r * kThreads;
        const int j = vi / (kE / kV), e = (vi % (kE / kV)) * kV;
        if (j < l) {
          load_vec(v + base + j * row_stride + e0 + e, vreg[r]);
        } else {
#pragma unroll
          for (int x = 0; x < kV; ++x) vreg[r][x] = 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kN; ++r)
#pragma unroll
        for (int x = 0; x < kV; ++x) vs[(tid + r * kThreads) * kV + x] = vreg[r][x];
    }
    __syncthreads();
    float pre = 0.0f;
    for (int w = 0; w < warp; ++w) pre += wsum[w];      // fixed order
    lfc[tid] = lf + pre;
    __syncthreads();

    // the stabiliser of each row: the masked row maximum of a (the masked
    // entries, -1e30, count where the row has any), then m_new
    if (tid < l) {
      const float fi = lfc[tid];
      float mx = (fi - lfc[0]) + igs[0];
      for (int j = 1; j <= tid; ++j) mx = fmaxf(mx, (fi - lfc[j]) + igs[j]);
      if (tid < l - 1) mx = fmaxf(mx, kNeg);
      const float m_in = fi + m_carry;
      const float mn = fmaxf(mx, m_in);
      mnew[tid] = mn;
      scin[tid] = expf(m_in - mn);
    }
    __syncthreads();
    const float total = lfc[l - 1];
    const float m_end = mnew[l - 1];
    wend[tid] = tid < l ? expf(((igs[tid] + total) - lfc[tid]) - m_end)
                        : 0.0f;

    // q C and q.n with the chunk's incoming state, for this thread's row yr
    // of every row block (4 rows x 4 columns a thread: each loaded value
    // feeds 4 or 5 FMAs), the chunk's q slices staged as one
    // (kMaxChunk x kKC) slice over the q and k buffers
    float inter[4][4], qn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qn[i] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) inter[i][e] = 0.0f;
    }
    for (int dk0 = 0; dk0 < D; dk0 += kKC) {
      __syncthreads();          // the previous readers of the buffers
      for (int rr = 0; rr < nb; ++rr) stage(Qb + rr * SL::kElems, q, rr * kRB, dk0);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const int kd = min(kKC, D - dk0);
      for (int kk = 0; kk < kd; ++kk) {
        float cv[4];
        load4(Cs + (dk0 + kk) * kE + yc, cv);
        const float nv = ns[dk0 + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = to_float(Qb[(i * kRB + yr) * SL::kLd + kk]);
#pragma unroll
          for (int e = 0; e < 4; ++e) inter[i][e] = fmaf(qv, cv[e], inter[i][e]);
          qn[i] = fmaf(qv, nv, qn[i]);
        }
      }
    }
    __syncthreads();            // the buffers are restaged next

    for (int rb = 0; rb < nb; ++rb) {
      const int i0 = rb * kRB;
      float local[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int cb = 0; cb <= rb; ++cb) {
        const int j0 = cb * kRB;
        float s[4][4];          // FMA: patch [i][j]; mma: [n8 tile][frag]
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
        const int nd = (D + kKC - 1) / kKC;
        stage(Qb, q, i0, 0);
        stage(Kb, k, j0, 0);
        cp_commit();
        for (int sd = 0; sd < nd; ++sd) {
          const int dk0 = sd * kKC;
          const T* Q = Qb + (sd & 1) * SL::kElems;
          const T* K = Kb + (sd & 1) * SL::kElems;
          if (sd + 1 < nd) {    // the next slice flies during this one
            stage(Qb + ((sd + 1) & 1) * SL::kElems, q, i0, dk0 + kKC);
            stage(Kb + ((sd + 1) & 1) * SL::kElems, k, j0, dk0 + kKC);
            cp_commit();
            cp_wait<1>();
          } else {
            cp_wait<0>();
          }
          __syncthreads();
          if constexpr (kTensor) {
#pragma unroll
            for (int kk = 0; kk < kKC; kk += 16) {
              const T* A = Q + (wr + g) * SL::kLd + kk + 2 * t4;
              const uint32_t a[4] = {
                  *reinterpret_cast<const uint32_t*>(A),
                  *reinterpret_cast<const uint32_t*>(A + 8 * SL::kLd),
                  *reinterpret_cast<const uint32_t*>(A + 8),
                  *reinterpret_cast<const uint32_t*>(A + 8 * SL::kLd + 8)};
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const T* Bp = K + (wc + 8 * nt + g) * SL::kLd + kk + 2 * t4;
                mma_bf16(s[nt], a, *reinterpret_cast<const uint32_t*>(Bp),
                         *reinterpret_cast<const uint32_t*>(Bp + 8));
              }
            }
          } else {
#pragma unroll 4
            for (int kk = 0; kk < kKC; ++kk) {
              float av[4], bv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                av[i] = to_float(Q[(4 * rg + i) * SL::kLd + kk]);
                bv[i] = to_float(K[(4 * cg + i) * SL::kLd + kk]);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
            }
          }
          __syncthreads();      // this buffer is restaged next
        }

        // q k^T weighted by exp(a - m_new) (0 above the diagonal) into Ss
        auto weigh = [&](int r, int c, float val) {
          const int row = i0 + r, col = j0 + c;
          const float w =
              row < l && col <= row
                  ? expf(((lfc[row] - lfc[col]) + igs[col]) - mnew[row])
                  : 0.0f;
          Ss[c * kSS + r] = val * w;
        };
        if constexpr (kTensor) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              weigh(wr + g + 8 * (x >> 1), wc + 8 * nt + 2 * t4 + (x & 1),
                    s[nt][x]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) weigh(4 * rg + i, 4 * cg + j, s[i][j]);
        }
        __syncthreads();

        // row sums of the tile, added tile by tile; y += S v
        if (tid < kRB) {
          float t = 0.0f;
          for (int j = 0; j < kRB; ++j) t += Ss[j * kSS + tid];
          dsum[tid] = cb == 0 ? t : dsum[tid] + t;
        }
#pragma unroll 4
        for (int j = 0; j < kRB; ++j) {
          const float sv = Ss[j * kSS + yr];
          float vv[4];
          load4(vs + (j0 + j) * kE + yc, vv);
#pragma unroll
          for (int e = 0; e < 4; ++e) local[e] = fmaf(sv, vv[e], local[e]);
        }
        __syncthreads();        // Ss is rewritten next
      }

      const int row = i0 + yr;
      if (row < l) {
        // this row block's entries of inter and qn (selects, no indexing)
        float in_e[4], q_n = qn[0];
#pragma unroll
        for (int e = 0; e < 4; ++e) in_e[e] = inter[0][e];
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          if (rb == i) {
            q_n = qn[i];
#pragma unroll
            for (int e = 0; e < 4; ++e) in_e[e] = inter[i][e];
          }
        }
        const float sc = scin[row];
        const float den = fmaxf(fabsf(dsum[yr] + q_n * sc),
                                expf(-mnew[row]));
        T* dst = y + base + row * row_stride + e0 + yc;
#pragma unroll
        for (int e = 0; e < 4; ++e) store(dst + e, (local[e] + in_e[e] * sc) / den);
      }
    }

    // C <- C * decay + (k o w)^T v and n <- n * decay + (k o w)^T 1, in
    // groups of kWide rows of C, 4 consecutive rows x 4 columns a thread;
    // the k tiles (kRB positions x kWide columns) staged by cp.async
    const float decay = expf((total + m_carry) - m_end);
    const int ur = 4 * yr;                  // the thread's first C row
    for (int d0 = 0; d0 < D; d0 += kWide) {
      float acc[4][4], nacc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        nacc[i] = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      }
      for (int j0 = 0; j0 < l; j0 += kRB) {
        __syncthreads();        // the previous readers of the buffers
        stage_wide(Qb, k, j0, d0);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
#pragma unroll 2
        for (int j = 0; j < kRB; ++j) {
          const float w = wend[j0 + j];
          float vv[4], kv[4];
          load4(vs + (j0 + j) * kE + yc, vv);
          load4(Qb + j * kLdW + ur, kv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float kw = kv[i] * w;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(kw, vv[e], acc[i][e]);
            nacc[i] += kw;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = d0 + ur + i;
        if (r < D) {
          float* c = Cs + r * kE + yc;
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] = c[e] * decay + acc[i][e];
          if ((tid & 3) == 0) ns[r] = ns[r] * decay + nacc[i];
        }
      }
    }
    m_carry = m_end;
  }

  __syncthreads();
  const long long st = (long long)bh * D;          // row (b, h, 0) of C, n
  for (int idx = tid; idx < D * kE; idx += kThreads) {
    const int r = idx / kE, e = idx % kE;
    Cf[(st + r) * D + e0 + e] = Cs[idx];
  }
  if (et == 0) {
    for (int idx = tid; idx < D; idx += kThreads) nf[st + idx] = ns[idx];
    if (tid == 0) mf[bh] = m_carry;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* y, void* Cf, void* nf, void* mf, int Bsz,
           int S, int H, int D, int chunk, cudaStream_t stream) {
  const int smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Bsz * H * (D / kE));
  mlstm_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<T*>(y),
      static_cast<float*>(Cf), static_cast<float*>(nf),
      static_cast<float*>(mf), S, H, D, chunk);
  return cudaGetLastError();
}

// ---- bf16 on wgmma, fed by TMA: the chunk-parallel mLSTM (kWgmma) ---------

namespace tc {

constexpr int kSlab = 64;                         // rows of a slab (wgmma M)
constexpr int kRowBytes = 128;                    // 64 bf16: a slice's row
constexpr int kSliceBytes = kSlab * kRowBytes;    // 64 rows of one slice
constexpr int kStageBytes = 2 * kSliceBytes;      // one ring stage
constexpr int kStages = 3;                        // pass 3's ring
constexpr float kLog2e = 1.4426950408889634f;

// Descriptor of k-step kk (16 columns) of a K-major tile of 64 rows cut
// into 64-column slices of kSliceBytes, one after the other.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  return hopper::smem_desc<128>(base + (kk / 4) * kSliceBytes + 32 * (kk % 4),
                                16, 8 * kRowBytes);
}

// Descriptor of k-step kk (16 rows) of an MN-major tile of `rows` rows cut
// into 64-column slices of rows x 128 bytes, one after the other.
__device__ __forceinline__ uint64_t mn_desc(uint32_t base, int rows, int kk) {
  return hopper::smem_desc<128>(base + kk * 16 * kRowBytes, rows * kRowBytes,
                                8 * kRowBytes);
}

// v0, v1 as bf16 hi = bf16(v) and lo = bf16(v - hi), each a register of two.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(hb);
  hi = *reinterpret_cast<const uint32_t*>(&hb);
  lo = hopper::pack_bf16(v0 - hf.x, v1 - hf.y);
}

// Scratch of the gates: per (b, c, h) = (b nc + c) H + h, kGates rows of l.
enum Gate { kF = 0, kMnew = 1, kScin = 2, kWend = 3, kI = 4, kGates = 5 };

// Pass 0.  Block ((b nc + c) H + h), 1024 threads.  The stabiliser entering
// chunk c depends on every earlier chunk only through its total F[l - 1]
// and its last row's maximum, so each warp scans one of chunks 0 .. c (32
// at a time, loads all in flight) for those two numbers; the chain m <-
// max(m_local[l - 1], F[l - 1] + m) runs over them in order; then four
// threads a row form the chunk's masked row maxima m_local, and m_new,
// scin = exp(m_in - m_new), w_end, i and the decay follow -- the operations,
// in order, of mlstm_chunk_kernel's gate steps (a maximum is exact in any
// order).
constexpr int kGateThreads = 1024;

__global__ void __launch_bounds__(kGateThreads)
mlstm_gates_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                   float* __restrict__ gate, float* __restrict__ decay,
                   float* __restrict__ mf, int S, int H, int l) {
  constexpr int kWarps = kGateThreads / 32, kGroups = kMaxChunk / 32;
  __shared__ float Fs[kMaxChunk], Is[kMaxChunk];
  __shared__ float tot[kWarps], mlast[kWarps], mc_s, ml_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = S / l, ng = l / 32;
  const int bch = blockIdx.x;
  const int h = bch % H, c = (bch / H) % nc, b = bch / (H * nc);
  float m = kNeg;                             // thread 0's chain
  for (int c0 = 0; c0 <= c; c0 += kWarps) {
    const int cc = c0 + warp;
    if (cc <= c) {
      // F and i of chunk cc at positions 32 g + lane: the scan of
      // _block_cumsum, each group's Hillis-Steele scan plus the totals of
      // the groups before it, added in order
      float Fv[kGroups], Iv[kGroups], pre = 0.0f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {       // all loads in flight first
        Fv[g] = 0.0f;
        Iv[g] = kNeg;
        if (g < ng) {
          const long long gi = (static_cast<long long>(b) * S +
                                static_cast<long long>(cc) * l + 32 * g +
                                lane) * H + h;
          Fv[g] = fg[gi];
          Iv[g] = ig[gi];
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (g < ng) {
          const float fv = Fv[g];
          float lf = fminf(fv, 0.0f) - log1pf(expf(-fabsf(fv)));
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, lf, off);
            if (lane >= off) lf += u;
          }
          Fv[g] = lf + pre;
          pre += __shfl_sync(0xffffffffu, lf, 31);
        }
      }
      if (cc == c) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (g < ng) {
            Fs[32 * g + lane] = Fv[g];
            Is[32 * g + lane] = Iv[g];
          }
        }
      } else {
        // the last row's maximum (it has no masked entries)
        float total = Fv[0];
#pragma unroll
        for (int g = 1; g < kGroups; ++g)
          if (g == ng - 1) total = Fv[g];
        total = __shfl_sync(0xffffffffu, total, 31);
        float mx = (total - Fv[0]) + Iv[0];
#pragma unroll
        for (int g = 1; g < kGroups; ++g)
          if (g < ng) mx = fmaxf(mx, (total - Fv[g]) + Iv[g]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lane == 0) {
          tot[warp] = total;
          mlast[warp] = mx;
        }
      }
    }
    // pass 1 may start once the gates are in (its k and v loads would
    // hold up these): it reads nothing of this pass before its
    // griddepcontrol.wait
    if (c0 == 0) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    __syncthreads();
    if (tid == 0)
      for (int w = 0; w < kWarps && c0 + w < c; ++w)
        m = fmaxf(mlast[w], tot[w] + m);
    __syncthreads();            // the next 32 chunks rewrite tot and mlast
  }
  if (tid == 0) mc_s = m;
  // the masked row maxima of chunk c, four threads a row (j = p mod 4);
  // the entries above the diagonal, -1e30, count where the row has any,
  // and a part with no entries adds only -1e30, which no row's maximum is
  // below
  const int i = tid >> 2, p = tid & 3;
  float mx = kNeg;
  if (i < l) {
    const float fi = Fs[i];
    for (int j = p; j <= i; j += 4) mx = fmaxf(mx, (fi - Fs[j]) + Is[j]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (i == l - 1 && p == 0) ml_s = mx;
  __syncthreads();
  if (i >= l || p != 0) return;
  const float mc = mc_s;
  const float fi = Fs[i];
  const float m_in = fi + mc;
  const float mn = fmaxf(mx, m_in);
  const float total = Fs[l - 1];
  const float m_end = fmaxf(ml_s, total + mc);
  float* gp = gate + static_cast<long long>(bch) * kGates * l;
  gp[kF * l + i] = fi;
  gp[kMnew * l + i] = mn;
  gp[kScin * l + i] = expf(m_in - mn);
  gp[kWend * l + i] = expf(((Is[i] + total) - fi) - m_end);
  gp[kI * l + i] = Is[i];
  if (i == 0) {
    decay[bch] = expf((total + mc) - m_end);
    if (c == nc - 1) mf[b * H + h] = m_end;
  }
}

// Pass 1.  Block (((b nc + c) H + h) nK + ti) nV + tj: the chunk's own
// state K_c = (k o w_end)^T . v for rows [128 ti, +128) and columns [NT tj,
// +NT) of (d x d), a warpgroup per 64 rows: A from registers -- k^T by
// ldmatrix.trans from k's TMA tile, scaled by w_end and split into bf16
// hi + lo -- and B straight from v's tile (the transpose bit).  Blocks of
// tj = 0 also sum n_c = sum_j k_j w_end_j in fp32, in order.  k and v come
// 64 positions at a time through a ring of two stages, the first ones
// loaded before pass 0 has ended; two blocks an SM.
template <int NT>
struct StateStage {
  static constexpr int kK = 2 * kSliceBytes;          // 64 rows of k
  static constexpr int kBytes = kK + (NT / 64) * kSliceBytes;
  static int smem() { return 1024 + 2 * kBytes + kMaxChunk * 4 + 8 * 2; }
};

template <int NT>
__global__ void __launch_bounds__(256, 2)
mlstm_chunk_state_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ gate,
                         float* __restrict__ kc, float* __restrict__ ncs,
                         int S, int H, int D, int l) {
  using St = StateStage<NT>;
  extern __shared__ uint8_t smem_ml[];
  uint8_t* ring = hopper::align1024(smem_ml);   // [2][k: 2 slices, v: NT / 64][64][128 B]
  float* wd = reinterpret_cast<float*>(ring + 2 * St::kBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(wd + kMaxChunk);

  const int tid = threadIdx.x;
  const int nK = (D + 127) / 128, nV = D / NT, nc = S / l, nb = l / kSlab;
  int blk = blockIdx.x;
  const int tj = blk % nV;
  blk /= nV;
  const int ti = blk % nK;
  const int bch = blk / nK;
  const int h = bch % H, c = (bch / H) % nc, b = bch / (H * nc);
  const int dk0 = 128 * ti, dv0 = NT * tj;
  const int kslices = min(2, (D - dk0) / 64);
  // 64 positions (group t) of k and v into stage t % 2 (one thread)
  auto load = [&](int t) {
    uint8_t* st = ring + (t % 2) * St::kBytes;
    uint64_t* bar = &bars[t % 2];
    hopper::mbar_expect_tx(bar, (kslices + NT / 64) * kSliceBytes);
    for (int s = 0; s < kslices; ++s)
      hopper::tma_load_4d(st + s * kSliceBytes, &kmap, bar, dk0 + 64 * s, h,
                          c * l + kSlab * t, b);
    for (int s = 0; s < NT / 64; ++s)
      hopper::tma_load_4d(st + St::kK + s * kSliceBytes, &vmap, bar,
                          dv0 + 64 * s, h, c * l + kSlab * t, b);
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(2, nb); ++t) load(t);
  // w_end is pass 0's
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int j = tid; j < l; j += 256)
    wd[j] = gate[(static_cast<long long>(bch) * kGates + kWend) * l + j];
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const bool rows = 64 * wg < D - dk0;        // this warpgroup has rows
  const bool nsum = tj == 0 && tid < 128 && dk0 + tid < D;
  // k-step kk (positions j0 = 16 kk ...): ldmatrix matrix m = lane / 8 is
  // rows j0 + 8 (m / 2) + lane % 8 of k, 16-byte chunk 2 warp + m % 2 of
  // the warpgroup's 128-byte slice, so register m holds, transposed, the
  // A fragment's (row 16 warp + lane / 4 + 8 (m % 2), columns j0 + 8 (m /
  // 2) + 2 (lane % 4) + {0, 1}).
  const int q = lane % 4, m = lane / 8;
  const int jr = 8 * (m / 2) + lane % 8, pc = 2 * warp + m % 2;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  float n = 0.0f;
  uint32_t hi0[4] = {}, lo0[4] = {}, hi1[4] = {}, lo1[4] = {};
  for (int t = 0; t < nb; ++t) {
    const uint8_t* st = ring + (t % 2) * St::kBytes;
    hopper::mbar_wait(&bars[t % 2], (t / 2) & 1);
    if (rows) {
      const uint32_t xa = hopper::smem_addr(st) + wg * kSliceBytes;
      const uint32_t ba = hopper::smem_addr(st + St::kK);
      // one k-step: the fragments into (hi, lo), two products; then wait
      // for the step before, whose fragments (phi, plo) may be rewritten
      auto step = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4],
                      uint32_t (&phi)[4], uint32_t (&plo)[4]) {
        const int j = 16 * kk + jr;
        uint32_t raw[4];
        hopper::ldmatrix_x4_trans(raw, xa + j * kRowBytes + ((pc ^ (j % 8)) * 16));
        const float* w = wd + kSlab * t + 16 * kk + 2 * q;
        const float2 w2[2] = {*reinterpret_cast<const float2*>(w),
                              *reinterpret_cast<const float2*>(w + 8)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 kv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
          split_pair(kv.x * w2[r / 2].x, kv.y * w2[r / 2].y, hi[r], lo[r]);
        }
        const uint64_t db = mn_desc(ba, kSlab, kk);
        hopper::wgmma_fence();
        hopper::wgmma_rs_tb<NT>(acc, hi, db);
        hopper::wgmma_rs_tb<NT>(acc, lo, db);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_frag(phi);
        hopper::fence_frag(plo);
      };
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; kk += 2) {
        step(kk, hi0, lo0, hi1, lo1);
        step(kk + 1, hi1, lo1, hi0, lo0);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_frag(hi1);
      hopper::fence_frag(lo1);
    }
    if (nsum) {
      // n_c for column dk0 + tid: each k_j w_j rounded, then summed in order
      const int s = tid / 64, cc = tid % 64;
      const uint8_t* col = st + s * kSliceBytes + (cc % 8) * 2;
      for (int j = 0; j < kSlab; ++j) {
        const __nv_bfloat16 kv = *reinterpret_cast<const __nv_bfloat16*>(
            col + j * kRowBytes + (((cc / 8) ^ (j % 8)) * 16));
        n += __bfloat162float(kv) * wd[kSlab * t + j];
      }
    }
    __syncthreads();              // the stage's readers are done
    if (tid == 0 && t + 2 < nb) load(t + 2);
  }
  if (rows) {
    // acc[i]: row 16 warp + lane / 4 + 8 ((i / 2) % 2) of the warpgroup's
    // 64, column 8 (i / 4) + 2 q + i % 2 of the NT
    float* dst = kc + static_cast<long long>(bch) * D * D;
    const int row0 = dk0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
    for (int i = 0; i < NT / 2; i += 2) {
      const int row = row0 + 8 * ((i / 2) % 2);
      const int col = dv0 + 8 * (i / 4) + 2 * q;
      *reinterpret_cast<float2*>(dst + static_cast<long long>(row) * D +
                                 col) = make_float2(acc[i], acc[i + 1]);
    }
  }
  if (nsum) ncs[static_cast<long long>(bch) * D + dk0 + tid] = n;
}

// Pass 2.  Thread ((b H + h) E + 4 e4) / 4, E = D D + D, carries elements
// 4 e4 .. 4 e4 + 3 of (b, h)'s state -- C for e < D D, n after -- through
// the chunks in fp32: the C entering chunk c > 0 goes to st_in as hi =
// bf16(C) and, n_state elements on, lo = bf16(C - hi); the n entering it to
// n_in in fp32 (chunk 0's, zero, is not read); then x <- x decay_c + (K_c
// or n_c).  The last is the final state.  (D is a multiple of 64, so no 4
// straddle C and n.)
__global__ void __launch_bounds__(kThreads)
mlstm_state_pass_kernel(const float* __restrict__ kc,
                        const float* __restrict__ ncs,
                        const float* __restrict__ decay,
                        __nv_bfloat16* __restrict__ st_in,
                        float* __restrict__ n_in, float* __restrict__ Cf,
                        float* __restrict__ nf, int Bsz, int H, int D,
                        int nc) {
  // pass 3 may start now: it reads nothing of this pass before its
  // griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long DD = static_cast<long long>(D) * D, E = DD + D;
  const long long idx =
      4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (idx >= static_cast<long long>(Bsz) * H * E) return;
  const long long e = idx % E;
  const long long bh = idx / E;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const long long n_state = static_cast<long long>(Bsz) * nc * H * DD;
  const bool is_c = e < DD;
  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < nc; ++c) {
    const long long bch = (static_cast<long long>(b) * nc + c) * H + h;
    const float dec = decay[bch];
    const float4 add = is_c
        ? *reinterpret_cast<const float4*>(kc + bch * DD + e)
        : *reinterpret_cast<const float4*>(ncs + bch * D + (e - DD));
    if (c == 0) {
      // the zero state entering chunk 0: pass 3 does not read it
    } else if (is_c) {
      uint32_t hi[2], lo[2];
      split_pair(x[0], x[1], hi[0], lo[0]);
      split_pair(x[2], x[3], hi[1], lo[1]);
      *reinterpret_cast<uint2*>(st_in + bch * DD + e) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(st_in + n_state + bch * DD + e) =
          make_uint2(lo[0], lo[1]);
    } else {
      *reinterpret_cast<float4*>(n_in + bch * D + (e - DD)) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    x[0] = x[0] * dec + add.x;
    x[1] = x[1] * dec + add.y;
    x[2] = x[2] * dec + add.z;
    x[3] = x[3] * dec + add.w;
  }
  float* out = is_c ? Cf + bh * DD + e : nf + bh * D + (e - DD);
  *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
}

// Pass 3's shared memory: 1024-aligned, the q slab (D / 64 slices) and the
// ring, then the barriers (the q slab, then one a ring stage); the gates
// and n are read through the L1.  Two blocks an SM leave each 115,712
// bytes (228 KB less 1 KB reserved a block), 992 more than the tiles and
// barriers take at d = 512, which the alignment may use.
constexpr int kOutSmemMax = 115712;
inline int out_smem(int D) {
  return min(kOutSmemMax, 1024 + (D / 64) * kSliceBytes +
                              kStages * kStageBytes + 8 * (1 + kStages));
}

// Pass 3.  Block ((((b nc + c) H + h) nct + ct) npair + pr), one warpgroup:
// y's columns [NT ct, +NT) for the rows of slabs nb - 1 - pr and pr (one
// slab when they coincide), so every block has the same number of
// lower-triangle tiles (4 + 1 and 3 + 2 at l = 256).  The slab's q stays
// in shared memory; k (two 64-column slices an item), v and the carried
// state's hi and lo (64 rows of d an item) stream through a ring of
// kStages, one thread issuing each item's TMA loads once its stage is free.
// Per slab: for each key tile t at or below the diagonal, S = q . k_t^T
// (wgmma), P = S o exp(F_i - F_j + i_j - m_new_i) (masked on the diagonal
// tile) as bf16 hi + lo A fragments, acc += P . v_t (wgmma), den += rowsum
// of the fp32 P; then, after griddepcontrol.wait (pass 2's carried state),
// acc2 = q . (C_hi + C_lo)[:, cols] (wgmma), acc += scin acc2 and den +=
// scin q.n; y = acc / max(|den|, exp(-m_new)) in bf16.  Everything before
// the wait -- the key tiles -- can run while pass 2 ends.
template <int NT>
__global__ void __launch_bounds__(128, 2)
mlstm_chunk_out_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap smap,
                       const float* __restrict__ gate,
                       const float* __restrict__ n_in,
                       __nv_bfloat16* __restrict__ y, int S, int H, int D,
                       int l) {
  extern __shared__ uint8_t smem_ml[];
  uint8_t* qs = hopper::align1024(smem_ml);   // [D / 64][64 rows][128 B]
  uint8_t* ring = qs + (D / 64) * kSliceBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);

  const int tid = threadIdx.x;
  const int nb = l / kSlab, npair = (nb + 1) / 2, nct = D / NT;
  const int nc = S / l;
  int blk = blockIdx.x;
  const int pr = blk % npair;
  blk /= npair;
  const int ct = blk % nct;
  const int bch = blk / nct;
  const int h = bch % H, c = (bch / H) % nc, b = bch / (H * nc);
  const int Bsz = static_cast<int>(gridDim.x) / (npair * nct * H * nc);
  const int c0 = c * l;
  const int slabs[2] = {nb - 1 - pr, pr};
  const int nslab = nb - 1 - pr == pr ? 1 : 2;
  const int ds = D / 64;                      // 64-column slices of d
  const int nki = (ds + 1) / 2;               // k items of a key tile
  // items of a slab: its key tiles' k and v, then the carried state's
  auto slab_items = [&](int r) {
    return (r + 1) * (nki + 1) + (c > 0 ? 2 * ds : 0);
  };
  const int n_items =
      slab_items(slabs[0]) + (nslab == 2 ? slab_items(slabs[1]) : 0);

  bool waited = false;                        // thread 0's griddepcontrol
  // Thread 0's cursor over the items, which it issues in order: per slab
  // (pk of the pair), for each key tile pt its k items then its v item (pu
  // = nki), then (c > 0) the carried state's hi and lo for each 64 rows of d
  // (pa counts them).
  int pk = 0, pt = 0, pu = 0, pa = -1;
  auto issue = [&](int i) {
    uint64_t* bar = &bars[1 + i % kStages];
    uint8_t* dst = ring + (i % kStages) * kStageBytes;
    if (pa < 0) {
      if (pu < nki) {
        const int ns = min(2, ds - 2 * pu);
        hopper::mbar_expect_tx(bar, ns * kSliceBytes);
        for (int s = 0; s < ns; ++s)
          hopper::tma_load_4d(dst + s * kSliceBytes, &kmap, bar,
                              64 * (2 * pu + s), h, c0 + kSlab * pt, b);
      } else {
        hopper::mbar_expect_tx(bar, (NT / 64) * kSliceBytes);
        for (int s = 0; s < NT / 64; ++s)
          hopper::tma_load_4d(dst + s * kSliceBytes, &vmap, bar,
                              NT * ct + 64 * s, h, c0 + kSlab * pt, b);
      }
      if (++pu > nki) {
        pu = 0;
        if (++pt > (pk == 0 ? slabs[0] : slabs[1])) {
          pt = 0;
          if (c > 0) pa = 0; else ++pk;
        }
      }
      return;
    }
    if (!waited) {
      asm volatile("griddepcontrol.wait;" ::: "memory");
      waited = true;
    }
    hopper::mbar_expect_tx(bar, (NT / 64) * kSliceBytes);
    for (int sl = 0; sl < NT / 64; ++sl)
      hopper::tma_load_4d(dst + sl * kSliceBytes, &smap, bar,
                          NT * ct + 64 * sl, 64 * (pa / 2), h,
                          ((pa % 2) * Bsz + b) * nc + c);
    if (++pa == 2 * ds) {
      pa = -1;
      ++pk;
    }
  };
  auto load_q = [&](int r) {
    hopper::mbar_expect_tx(&bars[0], ds * kSliceBytes);
    for (int s = 0; s < ds; ++s)
      hopper::tma_load_4d(qs + s * kSliceBytes, &qmap, &bars[0], 64 * s, h,
                          c0 + kSlab * r, b);
  };
  if (tid == 0) {
    uint32_t avail;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(avail));
    // the tiles and barriers within what was allocated
    if (reinterpret_cast<uint8_t*>(bars + 1 + kStages) > smem_ml + avail)
      __trap();
    for (int s = 0; s < 1 + kStages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_q(slabs[0]);
    for (int i = 0; i < min(kStages, n_items); ++i) issue(i);
  }
  // the gates (pass 0's, complete before pass 2 began): F and i of the
  // chunk, m_new and scin of its rows
  const float* gp = gate + static_cast<long long>(bch) * kGates * l;
  const float* gF = gp + kF * l;
  const float* gI = gp + kI * l;

  int it = 0;                                 // the next item to consume
  auto acquire = [&]() {
    hopper::mbar_wait(&bars[1 + it % kStages], (it / kStages) & 1);
    return hopper::smem_addr(ring + (it % kStages) * kStageBytes);
  };
  // after the products that read the item have completed in every thread
  auto release = [&]() {
    __syncthreads();
    if (tid == 0 && it + kStages < n_items) issue(it + kStages);
    ++it;
  };

  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;        // rows r0 and r0 + 8 of a slab
  const uint32_t qa = hopper::smem_addr(qs);
  for (int k = 0; k < nslab; ++k) {
    const int r = slabs[k];
    const int i0 = kSlab * r + r0;            // chunk positions i0, i0 + 8
    const float fi[2] = {__ldg(gF + i0), __ldg(gF + i0 + 8)};
    const float mi[2] = {__ldg(gp + kMnew * l + i0),
                         __ldg(gp + kMnew * l + i0 + 8)};
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    float dsum[2] = {0.0f, 0.0f};
    hopper::mbar_wait(&bars[0], k & 1);

    for (int t = 0; t <= r; ++t) {
      // S = q . k_t^T over d
      float s[kSlab / 2];
      for (int u = 0; u < nki; ++u) {
        const uint32_t ka = acquire();
        const int steps = 4 * min(2, ds - 2 * u);
        hopper::wgmma_fence();
        for (int kk = 0; kk < steps; ++kk)
          hopper::wgmma_ss<kSlab>(s, kmajor_desc(qa, 8 * u + kk),
                                  kmajor_desc(ka, kk), u | kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        release();
      }
      // P = S o exp(a - m_new) as bf16 hi + lo A fragments: element e of s
      // is row r0 + 8 ((e / 2) % 2), column 8 (e / 4) + 2 quad + e % 2
      uint32_t ph[kSlab / 16][4], pl[kSlab / 16][4];
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          const int e = 8 * kk + 2 * t4;
          const int hh = t4 % 2;
          const int j = kSlab * t + 8 * (e / 4) + 2 * quad;
          const float2 Fj = __ldg(reinterpret_cast<const float2*>(gF + j));
          const float2 Ij = __ldg(reinterpret_cast<const float2*>(gI + j));
          const float fj[2] = {Fj.x, Fj.y}, ij[2] = {Ij.x, Ij.y};
          float p[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float a = (fi[hh] - fj[x]) + ij[x];
            const float pv =
                s[e + x] * hopper::exp2_approx((a - mi[hh]) * kLog2e);
            // the diagonal tile: j <= i
            p[x] = t < r || j + x <= i0 + 8 * hh ? pv : 0.0f;
            dsum[hh] += p[x];
          }
          split_pair(p[0], p[1], ph[kk][t4], pl[kk][t4]);
        }
      }
      // acc += P . v_t, hi then lo
      const uint32_t va = acquire();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        const uint64_t dv = mn_desc(va, kSlab, kk);
        hopper::wgmma_rs_tb<NT>(acc, ph[kk], dv);
        hopper::wgmma_rs_tb<NT>(acc, pl[kk], dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        hopper::fence_frag(ph[kk]);
        hopper::fence_frag(pl[kk]);
      }
      release();
    }

    float sc[2] = {0.0f, 0.0f}, qn[2] = {0.0f, 0.0f};
    if (c > 0) {
      // pass 2's carried state and n
      asm volatile("griddepcontrol.wait;" ::: "memory");
      {
        // q.n, two threads a row, each half of d in order; 16-byte chunks
        // of the swizzled q slab.  Row R's sum lands in lanes 2 R % 32 and
        // the next of the warp whose accumulators hold row R.
        const int row = tid / 2, half = tid % 2;
        const float* nrow = n_in + static_cast<long long>(bch) * D;
        float dot = 0.0f;
        for (int ch = half * (D / 16); ch < (half + 1) * (D / 16); ++ch) {
          const int col = 8 * ch;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              qs + (col / 64) * kSliceBytes + row * kRowBytes +
              ((((col % 64) / 8) ^ (row % 8)) * 16));
          const __nv_bfloat162* q2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float4 n4[2] = {
              __ldg(reinterpret_cast<const float4*>(nrow + col)),
              __ldg(reinterpret_cast<const float4*>(nrow + col + 4))};
          const float nv[8] = {n4[0].x, n4[0].y, n4[0].z, n4[0].w,
                               n4[1].x, n4[1].y, n4[1].z, n4[1].w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float2 qf = __bfloat1622float2(q2[x]);
            dot = fmaf(qf.x, nv[2 * x], dot);
            dot = fmaf(qf.y, nv[2 * x + 1], dot);
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        qn[0] = __shfl_sync(0xffffffffu, dot, 2 * (lane / 4));
        qn[1] = __shfl_sync(0xffffffffu, dot, 2 * (lane / 4) + 16);
      }
      sc[0] = __ldg(gp + kScin * l + i0);
      sc[1] = __ldg(gp + kScin * l + i0 + 8);
      // acc2 = q . (C_hi + C_lo)[:, cols], 64 rows of d an item
      float acc2[NT / 2];
      for (int s = 0; s < ds; ++s) {
        for (int part = 0; part < 2; ++part) {
          const uint32_t ca = acquire();
          hopper::wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            hopper::wgmma_ss_tb<NT>(acc2, kmajor_desc(qa, 4 * s + k4),
                                    mn_desc(ca, kSlab, k4), s | part | k4);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc2);
          release();
        }
      }
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] += acc2[i] * sc[(i / 2) % 2];
    }
    // the q slab's last reader is done: bring in the next slab's q while
    // this one's y is stored
    if (k + 1 < nslab) {
      __syncthreads();
      if (tid == 0) load_q(slabs[k + 1]);
    }

    float den[2];                             // 1 / the floored denominator
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float d = dsum[hh];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (c > 0) d += qn[hh] * sc[hh];
      den[hh] = 1.0f / fmaxf(fabsf(d), expf(-mi[hh]));
    }
    // y in bf16: row r0 + 8 hh holds, in lane q of its quad, the column
    // pairs 8 cc + 2 q; a transpose within the quad gives lane q the 8
    // columns of pair groups cc = 4 g + q, one 16-byte store each
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      __nv_bfloat16* dst =
          y + ((static_cast<long long>(b) * S + c0 + i0 + 8 * hh) * H + h) *
                  D + NT * ct;
#pragma unroll
      for (int gq = 0; gq < NT / 32; ++gq) {
        uint32_t v[4], out[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = hopper::pack_bf16(acc[4 * (4 * gq + u) + 2 * hh] * den[hh],
                                   acc[4 * (4 * gq + u) + 2 * hh + 1] *
                                       den[hh]);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          // lane q reads lane (q + dd) % 4's pair for its group 4 gq + q,
          // which that lane sends as its v[(its q - dd) % 4]
          const int send = (quad - dd + 4) % 4, from = (quad + dd) % 4;
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

template <int NT>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* y, void* Cf, void* nf, void* mf, void* work,
           void* st_in, int Bsz, int S, int H, int D, int l,
           cudaStream_t stream) {
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 e = sizeof(__nv_bfloat16);
  const int nc = S / l;
  const long long bch = static_cast<long long>(Bsz) * nc * H;
  float* kc = static_cast<float*>(work);                 // (b, nc, h, d, d)
  float* ncs = kc + bch * D * D;                         // (b, nc, h, d)
  float* n_in = ncs + bch * D;                           // (b, nc, h, d)
  float* gate = n_in + bch * D;                          // (b, nc, h, 5, l)
  float* decay = gate + bch * kGates * l;                // (b, nc, h)
  // q, k, v as (d, h, s, b), 64 x 64 boxes; the carried states (2, b, nc,
  // h, d, d), hi then lo, as (d, d, h, 2 b nc)
  const u64 dims[4] = {u64(D), u64(H), u64(S), u64(Bsz)};
  const u64 strides[3] = {D * e, u64(H) * D * e, u64(S) * H * D * e};
  const u32 box[4] = {64, 1, u32(kSlab), 1};
  const u64 sdims[4] = {u64(D), u64(D), u64(H), 2 * u64(Bsz) * nc};
  const u64 sstrides[3] = {D * e, u64(D) * D * e, u64(H) * D * D * e};
  const u32 sbox[4] = {64, u32(kSlab), 1, 1};
  CUtensorMap qm, km, vm, sm;
  int err = hopper::encode_bf16_4d(&qm, q, dims, strides, box, 128);
  if (err == 0) err = hopper::encode_bf16_4d(&km, k, dims, strides, box, 128);
  if (err == 0) err = hopper::encode_bf16_4d(&vm, v, dims, strides, box, 128);
  if (err == 0)
    err = hopper::encode_bf16_4d(&sm, st_in, sdims, sstrides, sbox, 128);
  if (err != 0) return err;

  const int smem1 = StateStage<NT>::smem();
  const int smem3 = out_smem(D);
  cudaError_t got = cudaFuncSetAttribute(
      mlstm_chunk_state_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (got == cudaSuccess)
    got = cudaFuncSetAttribute(mlstm_chunk_out_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem3);
  // the whole of the SM's 228 KB as shared memory: two blocks an SM
  if (got == cudaSuccess)
    got = cudaFuncSetAttribute(mlstm_chunk_state_kernel<NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (got == cudaSuccess)
    got = cudaFuncSetAttribute(mlstm_chunk_out_kernel<NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (got != cudaSuccess) return got;

  mlstm_gates_kernel<<<static_cast<unsigned>(bch), kGateThreads, 0,
                       stream>>>(
      static_cast<const float*>(ig), static_cast<const float*>(fg), gate,
      decay, static_cast<float*>(mf), S, H, l);
  got = cudaGetLastError();
  if (got != cudaSuccess) return got;

  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const int nK = (D + 127) / 128, nV = D / NT;
  cfg.gridDim = dim3(static_cast<unsigned>(bch * nK * nV));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem1;
  got = cudaLaunchKernelEx(&cfg, mlstm_chunk_state_kernel<NT>, km, vm,
                           static_cast<const float*>(gate), kc, ncs, S, H, D,
                           l);
  if (got != cudaSuccess) return got;

  const long long n_thr = static_cast<long long>(Bsz) * H *
                          (static_cast<long long>(D) * D + D) / 4;
  mlstm_state_pass_kernel<<<static_cast<unsigned>((n_thr + kThreads - 1) /
                                                  kThreads),
                            kThreads, 0, stream>>>(
      kc, ncs, decay, static_cast<__nv_bfloat16*>(st_in), n_in,
      static_cast<float*>(Cf), static_cast<float*>(nf), Bsz, H, D, nc);
  got = cudaGetLastError();
  if (got != cudaSuccess) return got;

  const int nb = l / kSlab;
  cfg.gridDim = dim3(static_cast<unsigned>(bch * (D / NT) * ((nb + 1) / 2)));
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem3;
  got = cudaLaunchKernelEx(&cfg, mlstm_chunk_out_kernel<NT>, qm, km, vm, sm,
                           static_cast<const float*>(gate),
                           static_cast<const float*>(n_in),
                           static_cast<__nv_bfloat16*>(y), S, H, D, l);
  if (got != cudaSuccess) return got;
  return cudaGetLastError();
}

}  // namespace tc


}  // namespace

extern "C" {

// route: kFma, or kWgmma with the wrapper's scratch -- work, fp32, b nc h
// (d d + 2 d + 5 chunk + 1) elements; st_in, bf16, 2 b nc h d d -- which
// kFma ignores (NULL).  A call that does not meet kWgmma's needs is refused
// (cudaErrorInvalidValue), never run on kFma.
int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                    const void* ig, const void* fg, void* y, void* Cf,
                    void* nf, void* mf, int Bsz, int S, int H, int D,
                    int chunk, int dtype, int route, void* work, void* st_in,
                    void* stream) {
  if (Bsz <= 0 || H <= 0) return 0;
  if (S < 1 || chunk < 1 || chunk > kMaxChunk) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kWgmma) {
    const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(y) % 16 == 0;
    if (dtype != kBF16 || !aligned || D % 64 != 0 || D < 64 || D > kMaxD ||
        chunk % tc::kSlab != 0 || S % chunk != 0 || !work || !st_in)
      return cudaErrorInvalidValue;
    if (D % 128 == 0)
      return tc::launch<128>(q, k, v, ig, fg, y, Cf, nf, mf, work, st_in,
                             Bsz, S, H, D, chunk, s);
    return tc::launch<64>(q, k, v, ig, fg, y, Cf, nf, mf, work, st_in, Bsz,
                          S, H, D, chunk, s);
  }
  if (route != kFma || D < kE || D > kMaxD || D % kE != 0)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch<float>(q, k, v, ig, fg, y, Cf, nf, mf, Bsz, S, H, D,
                           chunk, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, ig, fg, y, Cf, nf, mf, Bsz, S,
                                   H, D, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
