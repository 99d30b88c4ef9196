// Chunkwise stabilised mLSTM (xLSTM matrix memory), forward, for Hopper
// (sm_90a), from a zero initial state.
//
// Replaces the Pallas TPU kernel `mlstm_chunk` (`_kernel`) of
// src/repro/kernels/mlstm_chunk.py.  For each (batch, head) it walks the
// chunks in order, carrying the (d x d) matrix memory C, the normaliser n
// and the stabiliser m.  Per chunk of length l, with lf = log sigmoid(f)
// and F its inclusive cumsum over the chunk:
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
//   d a multiple of 16 from 16 to 512; chunks 1 to 256 (a ragged last
//   chunk is masked, though the wrapper keeps the JAX contract
//   s % chunk == 0).
//
// Bound on an H100 SXM at xlstm-350m's prefill call ((1, 2048, 4, 512),
// chunk 256, bf16): bytes ~37.8 MB (q, k, v, y 33.6 MB, the final C 4.2
// MB), 0.0113 ms at 3.35 TB/s; operations ~10.75 GFLOP over the lower
// triangles (q k^T and S v, q C and the k^T v update), 0.0109 ms at the
// 989 TFLOP/s bf16 tensor-core peak.  What the design does:
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
// Numerics: fp32 everywhere but the bf16 inputs of q k^T.  The cumsum is
// a fixed-order block scan (shuffles within a warp, then the warp totals
// added in warp order), the plain version's order; no atomics, so two
// calls are bitwise equal.  The build uses --fmad=false: dot products
// contract on purpose through explicit fmaf; every other product and sum
// rounds on its own, in the Pallas body's order.  expf and log1pf (not the
// fast intrinsics).
//
// C interface (ctypes): mlstm_chunk_fwd returns cudaGetLastError() after
// its launch, 0 on success; dtype codes are 0 = fp32, 1 = bf16.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

}  // namespace

extern "C" {

int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                    const void* ig, const void* fg, void* y, void* Cf,
                    void* nf, void* mf, int Bsz, int S, int H, int D,
                    int chunk, int dtype, void* stream) {
  if (Bsz <= 0 || H <= 0) return 0;
  if (S < 1 || chunk < 1 || chunk > kMaxChunk || D < kE || D > kMaxD ||
      D % kE != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
