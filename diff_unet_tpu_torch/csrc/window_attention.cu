// Fused Swin window attention for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel diff_unet_tpu/ops/pallas_attention.py:115
// (_pallas_attn, entry fused_window_attention_qkv) and its custom_vjp
// backward, which recomputes reference_window_attention under jax.vjp. Per
// (window, head) the forward computes
//
//     out = softmax(q * Dh^-0.5 . k^T + bias[h] + region_mask) . v
//
// with region_mask = -100 where the shifted-window region ids of query and
// key differ (ids of window b are row b % nW of the (nW, N) int32 table; no
// dense mask exists anywhere). Both directions read the qkv Linear's output
// in place as a strided (BW, N, 3, H, Dh) view; the forward writes
// (BW, N, H, Dh) and the backward writes dqkv straight into the
// (BW, N, 3, H, Dh) layout, so no permute copy runs on either side.
//
// Numerics follow window_attention_plain and autograd through it: q is
// scaled and rounded to the working type, scores and softmax statistics are
// f32, the f32 bias and the -100 mask are added in f32, p is normalised and
// then rounded to the working type before P.V, products accumulate in f32.
// Backward: dP = dO.V^T rounds to the working type (the plain graph's
// p.float() cast), D = rowsum(P o dP) uses the f32 P, dS = P o (dP - D),
// dq = round(round(dS.K) * scale), dk = round(dS^T.qs), dv = round(P)^T.dO,
// dbias = sum over windows of dS (f32).
//
// What bounds it on an H100. At the 7^3 window (N = 343) and Dh = 16 a score
// costs 32 tensor-core FLOPs, one f32 bias value and one exponential: at
// stage 1 of serving the products need about 0.016 ms, the bytes 0.0275 ms,
// and the exponentials (BW.H.N^2 of them at 16 per clock per SM) about
// 0.06 ms. So the work is bound by the softmax's exponentials first and by
// bytes second, never by the products. What held the first kernel back was
// neither: it read the bias row by row from L2 in a pattern that touched 8
// cache lines per warp load, and that alone took 70% of its time.
//
// Design, bf16 (the serving and training type):
// - Forward: one CTA per (block of 96 query rows, head, run of windows), six
//   warps of 16 query rows (64 or 32 rows where the grid is small). The
//   block's f32 bias rows are copied into shared memory once, coalesced, and
//   serve every window of the run; K, V, the block's q rows and the region
//   ids of each window are copied by cp.async into one of two buffers while
//   the warps work on the other. QK^T and P.V run on the tensor cores with
//   mma.sync m16n8k16 (K = 16 is one k-step at Dh 16; Dh 4 and 8 are
//   zero-padded to 16), 64 keys a step. Pass 1 keeps a running max and sum
//   per row; pass 2 recomputes the score tile (cheap on the tensor cores),
//   forms p = round(exp(s - lse)) and feeds the m16n8 accumulators straight
//   back as the A fragment of P.V (V's B fragments by ldmatrix.trans). The
//   bias is read in the accumulator layout, 8 bytes a thread from rows
//   strided so a half warp hits distinct banks. A window whose region ids
//   are all equal skips the mask. With `lse` non-null (autograd only) it
//   writes the rows' log-sum-exp.
// - Backward: one CTA per (run of windows, head), eight warps; the windows
//   of a run go in turn. Phase A gives each warp 16 query rows: it
//   recomputes S and dP = dO.V^T by mma, takes D, then dS and dQ = dS.K (by
//   mma). Phase B gives each warp 16 keys and recomputes S^T and dP^T by mma
//   to form dK = dS^T.qs and dV = round(P)^T.dO, and adds dS^T into the
//   f32 dbias with float atomics, in its accumulator layout: a quad adds 32
//   contiguous bytes of a bias row (the sum's order, and so its last bits,
//   vary from run to run).
//
// Design, fp32 (exact FFMA on the CUDA cores; TF32 cannot hold 1e-4): one
// warp per query row with the lanes along the keys, so the bias row is read
// coalesced; K and V are staged in shared memory as f32 with an odd row
// stride. The backward has the same phases with a warp per query row
// (phase A) and a thread per key (phase B, whose dbias atomics are
// coalesced).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdMaxWarps = 6;     // bf16 forward: up to 6 x 16 rows a CTA
constexpr int kBwdWarps = 8;        // backward (both types)
constexpr int kF32Warps = 8;        // fp32 forward: 8 warps, 8 rows each
constexpr int kF32Rows = 64;        // query rows per fp32 forward CTA, at most

__device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// bf16 helpers: mma.sync m16n8k16 (bf16 in, f32 accumulate) and fragments.
// Fragment layout (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, by column):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8):             c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// Two n8 accumulator tiles side by side are the A fragment of the next
// product: a0 = (c0, c1) and a1 = (c2, c3) of the first, a2, a3 of the
// second.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// exp on the SFU (ex2.approx); its error is far below bf16's resolution
__device__ __forceinline__ float fast_exp(float x) { return __expf(x); }

// A fragment of rows r0.. and k-step ks from a row-major [row][ld] tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int r0, int ks, int g, int t) {
  const __nv_bfloat16* p = s + (r0 + g) * ld + ks * 16 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B fragment of n-tile n0.. and k-block k0 from an [n][ld] tile (k along ld)
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* s, int ld,
                                       int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = lds32(p);
  b1 = lds32(p + 8);
}

// Shared-memory row strides (in bf16) that make the fragment loads of the
// 8 row groups land on 8 distinct 4-bank groups: a stride of 4 mod 8 words.
__host__ __device__ __forceinline__ int nat_ld(int dhp) { return dhp + 8; }
__host__ __device__ __forceinline__ int tr_ld(int npad) { return npad + 8; }
// f32 bias rows: a stride of 8 mod 32 words keeps the float2 reads of a
// half warp (4 rows x 8 words) on distinct banks
__host__ __device__ __forceinline__ int bias_ld(int npad) { return npad + 8; }

// the two bf16 halves of a 32-bit word
__device__ __forceinline__ __nv_bfloat16 half_lo(uint32_t w) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu));
}
__device__ __forceinline__ __nv_bfloat16 half_hi(uint32_t w) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16));
}

// both bf16 halves times `scale`, rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  return pack_bf16(__bfloat162float(half_lo(w)) * scale,
                   __bfloat162float(half_hi(w)) * scale);
}

// Stage rows [0, npad) of one (window, slot, head) slice of a token-major
// bf16 tensor (row stride `tok`, Dh contiguous) into shared memory as a
// row-major [npad][nat_ld] tile and/or a transposed [DHP][tr_ld] tile,
// zero-filling rows >= n and columns >= DH; with `scale` the values are
// multiplied by it and rounded to bf16 (the plain version's q * scale).
template <int DH, int DHP>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* src,
                                           int64_t tok, int n, int npad,
                                           __nv_bfloat16* nat,
                                           __nv_bfloat16* tr, bool scaled,
                                           float scale) {
  constexpr int kChunks = DHP / 8;             // 8-wide chunks of a row
  const int ldn = nat_ld(DHP), ldt = tr_ld(npad);
  for (int e = threadIdx.x; e < npad * kChunks; e += blockDim.x) {
    const int j = e / kChunks;
    const int c = e - j * kChunks;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (j < n && c * 8 < DH) {
      const __nv_bfloat16* p = src + (int64_t)j * tok + c * 8;
      if (DH >= 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        w[0] = u.x;
        w[1] = u.y;
        w[2] = u.z;
        w[3] = u.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        w[0] = u.x;
        w[1] = u.y;
      }
      if (scaled) {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = scale_pair(w[i], scale);
      }
    }
    if (nat != nullptr)
      *reinterpret_cast<uint4*>(nat + j * ldn + c * 8) =
          make_uint4(w[0], w[1], w[2], w[3]);
    if (tr != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[(c * 8 + 2 * i) * ldt + j] = half_lo(w[i]);
        tr[(c * 8 + 2 * i + 1) * ldt + j] = half_hi(w[i]);
      }
    }
  }
}

__device__ __forceinline__ void stage_ids(const int* region_ids, int b,
                                          int n_windows, int n, int* ids) {
  if (region_ids == nullptr) return;
  const int* w_ids = region_ids + (int64_t)(b % n_windows) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) ids[j] = w_ids[j];
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores
// ---------------------------------------------------------------------------

// B fragment (k = 16 rows from r0, n = 8 columns from c0) of a row-major
// [row][ld] tile, by ldmatrix with transpose (16-byte aligned rows)
__device__ __forceinline__ void ldsm_b_trans(uint32_t& b0, uint32_t& b1,
                                             const __nv_bfloat16* s, int ld,
                                             int r0, int c0, int lane) {
  const uint32_t a = static_cast<uint32_t>(
      __cvta_generic_to_shared(s + (r0 + (lane & 15)) * ld + c0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(a));
}

// The (16 rows x 16 NC keys) score tile at key k0 of one warp: s[j][i] is
// n8 tile j, accumulator i (rows g, g+8 of the warp's 16; keys
// k0 + 8j + 2t + 0/1). q . k^T on the tensor cores, plus the f32 bias rows
// b0 (row g) and b1 (row g + 8) from shared memory, plus -100 between
// regions (MASK), -inf past n (TAIL).
template <int KS, int NC, bool MASK, bool TAIL>
__device__ __forceinline__ void score_tile(
    float (&s)[2 * NC][4], const uint32_t (&qa)[KS][4],
    const __nv_bfloat16* ks, int ldn, int k0, const float* b0,
    const float* b1, const int* ids, int id0, int id1, int n, int g, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t x0, x1;
      load_b(x0, x1, ks, ldn, k0 + 8 * j, kk * 16, g, t);
      mma16816(s[j], qa[kk], x0, x1);
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
    const int key = k0 + 8 * j + 2 * t;
    const float2 c0 = *reinterpret_cast<const float2*>(b0 + key);
    const float2 c1 = *reinterpret_cast<const float2*>(b1 + key);
    s[j][0] += c0.x;
    s[j][1] += c0.y;
    s[j][2] += c1.x;
    s[j][3] += c1.y;
    if (MASK) {
      const int2 kid = *reinterpret_cast<const int2*>(ids + key);
      if (kid.x != id0) s[j][0] += -100.f;
      if (kid.y != id0) s[j][1] += -100.f;
      if (kid.x != id1) s[j][2] += -100.f;
      if (kid.y != id1) s[j][3] += -100.f;
    }
    if (TAIL) {
      if (key >= n) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fold a score tile into each thread's running max m and sum l of
// exp(s - m) for its two rows.
template <int J>
__device__ __forceinline__ void row_stats(const float (&s)[J][4],
                                          float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < J; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    if (mx == -INFINITY) continue;
    const float mx2 = mx * kLog2e;
    float sum = m[r] == -INFINITY ? 0.f : l[r] * ex2(fmaf(m[r], kLog2e, -mx2));
#pragma unroll
    for (int j = 0; j < J; ++j)
      sum += ex2(fmaf(s[j][2 * r], kLog2e, -mx2)) +
             ex2(fmaf(s[j][2 * r + 1], kLog2e, -mx2));
    m[r] = mx;
    l[r] = sum;
  }
}

// o += round(exp(s - lse)) . V for a score tile of J n8 key tiles at k0;
// lse2 is the rows' log-sum-exp times log2(e)
template <int J, int NT>
__device__ __forceinline__ void accumulate_pv(float (&o)[NT][4],
                                              const float (&s)[J][4],
                                              const float (&lse2)[2],
                                              const __nv_bfloat16* vs,
                                              int ldn, int k0, int lane) {
#pragma unroll
  for (int c = 0; c < J / 2; ++c) {
    uint32_t pa[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * c + jj;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = ex2(fmaf(s[j][i], kLog2e, -lse2[i >> 1]));
      pa[2 * jj] = pack_bf16(p[0], p[1]);
      pa[2 * jj + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t x0, x1;
      ldsm_b_trans(x0, x1, vs, ldn, k0 + 16 * c, 8 * j, lane);
      mma16816(o[j], pa, x0, x1);
    }
  }
}

constexpr int kKeyBlock = 4;   // 16-key chunks a step (64 keys)

// One warp's 16 query rows of one window: pass 1 takes the row max m and
// the sum l of exp(s - m), pass 2 recomputes the score tiles and runs
// P = round(exp(s - m - log l)) . V on the tensor cores into o. Keys go 64
// a step, then 16 a step, then the ragged last 16.
template <int KS, int NT, bool MASK>
__device__ __forceinline__ void attend_rows(
    float (&o)[NT][4], float (&m)[2], float (&l)[2],
    const uint32_t (&qa)[KS][4], const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, int ldn, const float* b0, const float* b1,
    const int* ids, int id0, int id1, int n, int npad, int lane) {
  constexpr int KB = 16 * kKeyBlock;
  const int g = lane >> 2, t = lane & 3;
  const int nfull = n / 16 * 16;
  const int nblk = nfull / KB * KB;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < nblk; k0 += KB) {
    float s[2 * kKeyBlock][4];
    score_tile<KS, kKeyBlock, MASK, false>(s, qa, ks, ldn, k0, b0, b1, ids,
                                           id0, id1, n, g, t);
    row_stats(s, m, l);
  }
#pragma unroll 1
  for (int k0 = nblk; k0 < nfull; k0 += 16) {
    float s[2][4];
    score_tile<KS, 1, MASK, false>(s, qa, ks, ldn, k0, b0, b1, ids, id0,
                                   id1, n, g, t);
    row_stats(s, m, l);
  }
  if (nfull < npad) {
    float s[2][4];
    score_tile<KS, 1, MASK, true>(s, qa, ks, ldn, nfull, b0, b1, ids, id0,
                                  id1, n, g, t);
    row_stats(s, m, l);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      l[r] = (m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mn) * kLog2e)) +
             (mo == -INFINITY ? 0.f : lo * ex2((mo - mn) * kLog2e));
      m[r] = mn;
    }
  }
  const float lse2[2] = {(m[0] + logf(l[0])) * kLog2e,
                         (m[1] + logf(l[1])) * kLog2e};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < nblk; k0 += KB) {
    float s[2 * kKeyBlock][4];
    score_tile<KS, kKeyBlock, MASK, false>(s, qa, ks, ldn, k0, b0, b1, ids,
                                           id0, id1, n, g, t);
    accumulate_pv(o, s, lse2, vs, ldn, k0, lane);
  }
#pragma unroll 1
  for (int k0 = nblk; k0 < nfull; k0 += 16) {
    float s[2][4];
    score_tile<KS, 1, MASK, false>(s, qa, ks, ldn, k0, b0, b1, ids, id0,
                                   id1, n, g, t);
    accumulate_pv(o, s, lse2, vs, ldn, k0, lane);
  }
  if (nfull < npad) {
    float s[2][4];
    score_tile<KS, 1, MASK, true>(s, qa, ks, ldn, nfull, b0, b1, ids, id0,
                                  id1, n, g, t);
    accumulate_pv(o, s, lse2, vs, ldn, nfull, lane);
  }
}

// cp.async copies into shared memory; `bytes` below the copy size
// zero-fills the rest (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying `rows` token rows (row stride `tok`, Dh contiguous) into a
// row-major [rows][nat_ld] bf16 tile, zero past `valid` rows and past Dh.
template <int DH, int DHP>
__device__ __forceinline__ void stage_rows_async(const __nv_bfloat16* src,
                                                 int64_t tok, int valid,
                                                 int rows,
                                                 __nv_bfloat16* dst) {
  constexpr int kChunks = DHP / 8;
  const int ldn = nat_ld(DHP);
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int j = e / kChunks;
    const int c = e - j * kChunks;
    const bool ok = j < valid && c * 8 < DH;
    const __nv_bfloat16* p = ok ? src + (int64_t)j * tok + c * 8 : src;
    __nv_bfloat16* d = dst + j * ldn + c * 8;
    if (DH >= 8) {
      cp_async16(d, p, ok ? 16 : 0);
    } else {
      cp_async8(d, p, ok ? 2 * DH : 0);
      cp_async8(d + 4, src, 0);
    }
  }
}

// One CTA per (block of 16 * warps query rows, head, run of windows). The
// block's f32 bias rows are copied into shared memory once and serve every
// window of the run. K, V, the block's q rows and the region ids of each
// window are copied by cp.async into one of two buffers while the warps
// work on the other window's.
template <int DH, bool VEC>
__global__ void __launch_bounds__(kFwdMaxWarps * 32)
attn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const int* __restrict__ region_ids,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int bw, int n, int heads, int n_windows, int per_group,
                     float q_scale) {
  constexpr int DHP = DH < 16 ? 16 : DH;   // head dim padded to a k-step
  constexpr int KS = DHP / 16;             // k-steps of QK^T
  constexpr int NT = DHP / 8;              // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = round_up(n, 16);
  const int ldn = nat_ld(DHP), ldb = bias_ld(npad);
  const int warps = blockDim.x >> 5, rows_cta = 16 * warps;
  float* bs = reinterpret_cast<float*>(smem_raw);      // [rows_cta][ldb]
  // a window's buffer: K, V [npad][ldn], q [rows_cta][ldn], ids [npad]
  const int buf_elems = (2 * npad + rows_cta) * ldn + 2 * npad;
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(bs + rows_cta * ldb);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * rows_cta;
  const int c = heads * DH;
  const int64_t tok = 3 * (int64_t)c;
  const int first = blockIdx.z * per_group;
  const int w_end = min(bw, first + per_group);

  // the block's bias rows, by 16-byte copies where the rows are 16-byte
  // aligned (VEC: n a multiple of 4), else 4-byte ones
  for (int r = warp; r < rows_cta; r += warps) {
    const float* src = bias + ((int64_t)h * n + row0 + r) * n;
    for (int k = (VEC ? 4 : 1) * lane; k < npad; k += VEC ? 128 : 32) {
      const bool ok = row0 + r < n && k < n;
      if (VEC)
        cp_async16(bs + r * ldb + k, ok ? src + k : bias, ok ? 16 : 0);
      else
        cp_async4(bs + r * ldb + k, ok ? src + k : bias, ok ? 4 : 0);
    }
  }
  auto stage = [&](int b, __nv_bfloat16* buf) {
    const __nv_bfloat16* base = qkv + (int64_t)b * n * tok + (int64_t)h * DH;
    stage_rows_async<DH, DHP>(base + c, tok, n, npad, buf);
    stage_rows_async<DH, DHP>(base + 2 * c, tok, n, npad, buf + npad * ldn);
    stage_rows_async<DH, DHP>(base + (int64_t)row0 * tok, tok, n - row0,
                              rows_cta, buf + 2 * npad * ldn);
    if (region_ids != nullptr) {
      int* ids = reinterpret_cast<int*>(buf + (2 * npad + rows_cta) * ldn);
      const int* w_ids = region_ids + (int64_t)(b % n_windows) * n;
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        cp_async4(ids + j, w_ids + j, 4);
    }
    cp_async_commit();
  };
  stage(first, bufs);

  const int r0 = row0 + warp * 16;
  const int rows[2] = {r0 + g, r0 + g + 8};
  const float* b0 = bs + (warp * 16 + g) * ldb;
  const float* b1 = b0 + 8 * ldb;
#pragma unroll 1
  for (int b = first; b < w_end; ++b) {
    __nv_bfloat16* buf = bufs + ((b - first) & 1) * buf_elems;
    if (b + 1 < w_end) {
      stage(b + 1, bufs + ((b + 1 - first) & 1) * buf_elems);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const __nv_bfloat16* ks = buf;
    const __nv_bfloat16* vs = buf + npad * ldn;
    const __nv_bfloat16* qsm = buf + 2 * npad * ldn;
    int* ids = reinterpret_cast<int*>(buf + (2 * npad + rows_cta) * ldn);
    // a window whose region ids are all equal needs no mask
    int same = 1;
    if (region_ids != nullptr) {
      const int* w_ids = region_ids + (int64_t)(b % n_windows) * n;
      const int id0 = w_ids[0];
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        same &= ids[j] == id0;
    }
    const bool masked = !__syncthreads_and(same);
    if (r0 < n) {
      // q rows as A fragments, scaled and rounded to bf16
      uint32_t qa[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        load_a(qa[kk], qsm, ldn, warp * 16, kk, g, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], q_scale);
      }
      float o[NT][4], m[2], l[2];
      if (masked) {
        attend_rows<KS, NT, true>(o, m, l, qa, ks, vs, ldn, b0, b1, ids,
                                  rows[0] < n ? ids[rows[0]] : 0,
                                  rows[1] < n ? ids[rows[1]] : 0, n, npad,
                                  lane);
      } else {
        attend_rows<KS, NT, false>(o, m, l, qa, ks, vs, ldn, b0, b1, ids, 0,
                                   0, n, npad, lane);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= n) continue;
        if (lse != nullptr && t == 0)
          lse[((int64_t)b * heads + h) * n + rows[r]] = m[r] + logf(l[r]);
        __nv_bfloat16* op =
            out + ((int64_t)b * n + rows[r]) * c + (int64_t)h * DH;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < DH)
            *reinterpret_cast<uint32_t*>(op + col) =
                pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
        }
      }
    }
    __syncthreads();                 // this buffer is free for window b + 2
  }
}

// ---------------------------------------------------------------------------
// fp32 forward on the CUDA cores: a warp per query row, lanes along keys
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Stage one (window, slot, head) slice as f32 [n][DH + 1] (odd stride:
// lanes reading consecutive rows hit distinct banks), times `scale`.
template <int DH>
__device__ __forceinline__ void stage_f32(const float* src, int64_t tok,
                                          int n, float* dst, float scale) {
  for (int e = threadIdx.x; e < n * DH; e += blockDim.x) {
    const int j = e / DH;
    const int d = e - j * DH;
    dst[j * (DH + 1) + d] = src[(int64_t)j * tok + d] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
attn_fwd_f32_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const int* __restrict__ region_ids,
                    float* __restrict__ out, float* __restrict__ lse, int n,
                    int heads, int n_windows, int rows_cta, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 1;
  float* ks = reinterpret_cast<float*>(smem_raw);       // [n][LD]
  float* vs = ks + n * LD;                              // [n][LD]
  float* qs = vs + n * LD;                              // [rows_cta][LD]
  int* ids = reinterpret_cast<int*>(qs + rows_cta * LD);

  const int b = blockIdx.x;
  const int h = blockIdx.z;
  const int c = heads * DH;
  const int64_t tok = 3 * (int64_t)c;
  const float* base = qkv + (int64_t)b * n * tok + (int64_t)h * DH;
  const int row0 = blockIdx.y * rows_cta;
  const int nrows = min(rows_cta, n - row0);
  stage_f32<DH>(base + c, tok, n, ks, 1.f);
  stage_f32<DH>(base + 2 * c, tok, n, vs, 1.f);
  stage_f32<DH>(base + (int64_t)row0 * tok, tok, nrows, qs, q_scale);
  const bool masked = region_ids != nullptr;
  stage_ids(region_ids, b, n_windows, n, ids);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += kF32Warps) {
    const int i = row0 + r;
    float q[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = qs[r * LD + d];
    const float* brow = bias + ((int64_t)h * n + i) * n;
    const int my_id = masked ? ids[i] : 0;
    auto score = [&](int j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(q[d], ks[j * LD + d], s);
      s += brow[j];
      if (masked && ids[j] != my_id) s += -100.f;
      return s;
    };
    // pass 1: each lane's running max and sum, then the warp's
    float m = -INFINITY, l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float s = score(j);
      if (s > m) {
        l = l * expf(m - s) + 1.f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
    const float mw = warp_max(m);
    l = warp_sum(m == -INFINITY ? 0.f : l * expf(m - mw));
    const float inv = 1.f / l;
    if (lse != nullptr && lane == 0)
      lse[((int64_t)b * heads + h) * n + i] = mw + logf(l);
    // pass 2: o = sum_j p_j v_j per lane, then summed over the warp
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(score(j) - mw) * inv;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j * LD + d], acc[d]);
    }
    float mine = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float v = warp_sum(acc[d]);
      if (lane == d) mine = v;
    }
    if (lane < DH)
      out[((int64_t)b * n + i) * c + (int64_t)h * DH + lane] = mine;
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores
// ---------------------------------------------------------------------------

// Phase A tile: P (f32) and dP (rounded to bf16) of the warp's 16 query
// rows and the 16 NC keys from k0, in the accumulator layout (0 for padded
// rows and keys).
template <int KS, int NC>
__device__ __forceinline__ void prob_rows(
    float (&p)[2 * NC][4], float (&dp)[2 * NC][4],
    const uint32_t (&qa)[KS][4], const uint32_t (&da)[KS][4],
    const __nv_bfloat16* ks, const __nv_bfloat16* vs, int ldn, int k0,
    const float* bias_h, const int (&rows)[2], const bool (&rv)[2],
    const int* ids, const int (&my_id)[2], bool masked,
    const float (&row_lse)[2], int n, int g, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b0, b1;
      load_b(b0, b1, ks, ldn, k0 + 8 * j, kk * 16, g, t);
      mma16816(s, qa[kk], b0, b1);
      load_b(b0, b1, vs, ldn, k0 + 8 * j, kk * 16, g, t);
      mma16816(dp[j], da[kk], b0, b1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 8 * j + 2 * t + (i & 1);
      const int r = i >> 1;
      if (key < n && rv[r]) {
        float v = s[i] + bias_h[(int64_t)rows[r] * n + key];
        if (masked && ids[key] != my_id[r]) v += -100.f;
        p[j][i] = fast_exp(v - row_lse[r]);
        dp[j][i] = round_bf16(dp[j][i]);
      } else {
        p[j][i] = 0.f;
        dp[j][i] = 0.f;
      }
    }
  }
}

// dq += round(dS) . K over the 16 NC keys from k0 (K^T from shared memory)
template <int NC, int NT>
__device__ __forceinline__ void dq_update(float (&dq)[NT][4],
                                          const float (&p)[2 * NC][4],
                                          const float (&dp)[2 * NC][4],
                                          const float (&d)[2],
                                          const __nv_bfloat16* kst, int ldt,
                                          int k0, int g, int t) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    uint32_t sa[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * c + jj;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = p[j][i] * (dp[j][i] - d[i >> 1]);
      sa[2 * jj] = pack_bf16(ds[0], ds[1]);
      sa[2 * jj + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b0, b1;
      load_b(b0, b1, kst, ldt, 8 * j, k0 + 16 * c, g, t);
      mma16816(dq[j], sa, b0, b1);
    }
  }
}

// Phase B tile: P^T (f32) and dS^T of the warp's 16 keys and the 16 NC
// query rows from q0, in the accumulator layout; dS^T is added into the
// f32 dbias (a quad adds 32 contiguous bytes of a bias row).
template <int KS, int NC>
__device__ __forceinline__ void prob_keys(
    float (&p)[2 * NC][4], float (&ds)[2 * NC][4],
    const uint32_t (&ka)[KS][4], const uint32_t (&va)[KS][4],
    const __nv_bfloat16* qs, const __nv_bfloat16* dos, int ldn, int q0,
    const float* bias_h, float* dbias_h, const int (&keys)[2],
    const bool (&kv)[2], const int* ids, const int (&key_id)[2], bool masked,
    const float* lse_s, const float* dsum, int n, int g, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b0, b1;
      load_b(b0, b1, qs, ldn, q0 + 8 * j, kk * 16, g, t);
      mma16816(s, ka[kk], b0, b1);
      load_b(b0, b1, dos, ldn, q0 + 8 * j, kk * 16, g, t);
      mma16816(dp, va[kk], b0, b1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 8 * j + 2 * t + (i & 1);
      const int r = i >> 1;
      if (row < n && kv[r]) {
        float v = s[i] + bias_h[(int64_t)row * n + keys[r]];
        if (masked && ids[row] != key_id[r]) v += -100.f;
        p[j][i] = fast_exp(v - lse_s[row]);
        ds[j][i] = p[j][i] * (round_bf16(dp[i]) - dsum[row]);
        atomicAdd(dbias_h + (int64_t)row * n + keys[r], ds[j][i]);
      } else {
        p[j][i] = 0.f;
        ds[j][i] = 0.f;
      }
    }
  }
}

// dv += round(P^T) . dO and dk += round(dS^T) . qs over the 16 NC rows from
// q0 (dO^T and qs^T from shared memory)
template <int NC, int NT>
__device__ __forceinline__ void dkdv_update(float (&dk)[NT][4],
                                            float (&dv)[NT][4],
                                            const float (&p)[2 * NC][4],
                                            const float (&ds)[2 * NC][4],
                                            const __nv_bfloat16* dost,
                                            const __nv_bfloat16* qst, int ldt,
                                            int q0, int g, int t) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    uint32_t pa[4], sa[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * c + jj;
      pa[2 * jj] = pack_bf16(p[j][0], p[j][1]);
      pa[2 * jj + 1] = pack_bf16(p[j][2], p[j][3]);
      sa[2 * jj] = pack_bf16(ds[j][0], ds[j][1]);
      sa[2 * jj + 1] = pack_bf16(ds[j][2], ds[j][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b0, b1;
      load_b(b0, b1, dost, ldt, 8 * j, q0 + 16 * c, g, t);
      mma16816(dv[j], pa, b0, b1);
      load_b(b0, b1, qst, ldt, 8 * j, q0 + 16 * c, g, t);
      mma16816(dk[j], sa, b0, b1);
    }
  }
}

constexpr int kBwdStep = 2;    // 16-row / 16-key chunks a backward step

// Two CTAs an SM at Dh 16 (at most 128 registers a thread)
template <int DH>
__global__ void __launch_bounds__(kBwdWarps * 32, DH == 16 ? 2 : 1)
attn_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const int* __restrict__ region_ids,
                     const float* __restrict__ lse,
                     const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dqkv,
                     float* __restrict__ dbias, int bw, int n, int heads,
                     int n_windows, int per_group, float q_scale) {
  constexpr int DHP = DH < 16 ? 16 : DH;
  constexpr int KS = DHP / 16;
  constexpr int NT = DHP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = round_up(n, 16);
  const int ldn = nat_ld(DHP), ldt = tr_ld(npad);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + npad * ldn;
  __nv_bfloat16* vs = ks + npad * ldn;
  __nv_bfloat16* dos = vs + npad * ldn;
  __nv_bfloat16* qst = dos + npad * ldn;     // [DHP][ldt] transposed
  __nv_bfloat16* kst = qst + DHP * ldt;
  __nv_bfloat16* dost = kst + DHP * ldt;
  float* lse_s = reinterpret_cast<float*>(dost + DHP * ldt);   // [npad]
  float* dsum = lse_s + npad;                                  // D, [npad]
  int* ids = reinterpret_cast<int*>(dsum + npad);              // [n]

  const int h = blockIdx.y;
  const int c = heads * DH;
  const int64_t tok = 3 * (int64_t)c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool masked = region_ids != nullptr;
  const float* bias_h = bias + (int64_t)h * n * n;
  float* dbias_h = dbias + (int64_t)h * n * n;
  const int w_end = min(bw, (blockIdx.x + 1) * per_group);

#pragma unroll 1
  for (int b = blockIdx.x * per_group; b < w_end; ++b) {
    const __nv_bfloat16* base = qkv + (int64_t)b * n * tok + (int64_t)h * DH;
    __syncthreads();                 // the previous window is done with smem
    stage_bf16<DH, DHP>(base, tok, n, npad, qs, qst, true, q_scale);
    stage_bf16<DH, DHP>(base + c, tok, n, npad, ks, kst, false, 0.f);
    stage_bf16<DH, DHP>(base + 2 * c, tok, n, npad, vs, nullptr, false, 0.f);
    stage_bf16<DH, DHP>(dout + (int64_t)b * n * c + (int64_t)h * DH, c, n,
                        npad, dos, dost, false, 0.f);
    for (int j = threadIdx.x; j < npad; j += blockDim.x)
      lse_s[j] = j < n ? lse[((int64_t)b * heads + h) * n + j] : 0.f;
    stage_ids(region_ids, b, n_windows, n, ids);
    __syncthreads();

    // phase A: a warp per 16 query rows; D, then dS and dQ
#pragma unroll 1
    for (int r0 = warp * 16; r0 < npad; r0 += kBwdWarps * 16) {
      const int rows[2] = {r0 + g, r0 + g + 8};
      const bool rv[2] = {rows[0] < n, rows[1] < n};
      uint32_t qa[KS][4], da[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        load_a(qa[kk], qs, ldn, r0, kk, g, t);
        load_a(da[kk], dos, ldn, r0, kk, g, t);
      }
      const int my_id[2] = {masked && rv[0] ? ids[rows[0]] : 0,
                            masked && rv[1] ? ids[rows[1]] : 0};
      const float row_lse[2] = {lse_s[rows[0]], lse_s[rows[1]]};
      float d[2] = {0.f, 0.f};
      auto add_d = [&](const auto& p, const auto& dp) {
#pragma unroll
        for (int j = 0; j < (int)(sizeof(p) / sizeof(p[0])); ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            d[i >> 1] = fmaf(p[j][i], dp[j][i], d[i >> 1]);
      };
      int k0 = 0;
#pragma unroll 1
      for (; k0 + 16 * kBwdStep <= npad; k0 += 16 * kBwdStep) {
        float p[2 * kBwdStep][4], dp[2 * kBwdStep][4];
        prob_rows<KS, kBwdStep>(p, dp, qa, da, ks, vs, ldn, k0, bias_h, rows,
                                rv, ids, my_id, masked, row_lse, n, g, t);
        add_d(p, dp);
      }
      if (k0 < npad) {
        float p[2][4], dp[2][4];
        prob_rows<KS, 1>(p, dp, qa, da, ks, vs, ldn, k0, bias_h, rows, rv,
                         ids, my_id, masked, row_lse, n, g, t);
        add_d(p, dp);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
        if (t == 0) dsum[rows[r]] = d[r];
      }
      float dq[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[j][i] = 0.f;
#pragma unroll 1
      for (k0 = 0; k0 + 16 * kBwdStep <= npad; k0 += 16 * kBwdStep) {
        float p[2 * kBwdStep][4], dp[2 * kBwdStep][4];
        prob_rows<KS, kBwdStep>(p, dp, qa, da, ks, vs, ldn, k0, bias_h, rows,
                                rv, ids, my_id, masked, row_lse, n, g, t);
        dq_update<kBwdStep, NT>(dq, p, dp, d, kst, ldt, k0, g, t);
      }
      if (k0 < npad) {
        float p[2][4], dp[2][4];
        prob_rows<KS, 1>(p, dp, qa, da, ks, vs, ldn, k0, bias_h, rows, rv,
                         ids, my_id, masked, row_lse, n, g, t);
        dq_update<1, NT>(dq, p, dp, d, kst, ldt, k0, g, t);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!rv[r]) continue;
        __nv_bfloat16* dst = dqkv + ((int64_t)b * n + rows[r]) * tok +
                             (int64_t)h * DH;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < DH)
            *reinterpret_cast<uint32_t*>(dst + col) =
                pack_bf16(round_bf16(dq[j][2 * r]) * q_scale,
                          round_bf16(dq[j][2 * r + 1]) * q_scale);
        }
      }
    }
    __syncthreads();                 // D of every row is in shared memory

    // phase B: a warp per 16 keys; S^T and dP^T by rows, dK, dV, and dS^T
    // added into dbias
#pragma unroll 1
    for (int k0 = warp * 16; k0 < npad; k0 += kBwdWarps * 16) {
      const int keys[2] = {k0 + g, k0 + g + 8};
      const bool kv[2] = {keys[0] < n, keys[1] < n};
      uint32_t ka[KS][4], va[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        load_a(ka[kk], ks, ldn, k0, kk, g, t);
        load_a(va[kk], vs, ldn, k0, kk, g, t);
      }
      const int key_id[2] = {masked && kv[0] ? ids[keys[0]] : 0,
                             masked && kv[1] ? ids[keys[1]] : 0};
      float dk[NT][4], dv[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;
      int q0 = 0;
#pragma unroll 1
      for (; q0 + 16 * kBwdStep <= npad; q0 += 16 * kBwdStep) {
        float p[2 * kBwdStep][4], ds[2 * kBwdStep][4];
        prob_keys<KS, kBwdStep>(p, ds, ka, va, qs, dos, ldn, q0, bias_h,
                                dbias_h, keys, kv, ids, key_id, masked, lse_s,
                                dsum, n, g, t);
        dkdv_update<kBwdStep, NT>(dk, dv, p, ds, dost, qst, ldt, q0, g, t);
      }
      if (q0 < npad) {
        float p[2][4], ds[2][4];
        prob_keys<KS, 1>(p, ds, ka, va, qs, dos, ldn, q0, bias_h, dbias_h,
                         keys, kv, ids, key_id, masked, lse_s, dsum, n, g, t);
        dkdv_update<1, NT>(dk, dv, p, ds, dost, qst, ldt, q0, g, t);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!kv[r]) continue;
        __nv_bfloat16* dst = dqkv + ((int64_t)b * n + keys[r]) * tok +
                             (int64_t)h * DH;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < DH) {
            *reinterpret_cast<uint32_t*>(dst + c + col) =
                pack_bf16(dk[j][2 * r], dk[j][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(dst + 2 * c + col) =
                pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 backward on the CUDA cores
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kBwdWarps * 32)
attn_bwd_f32_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const int* __restrict__ region_ids,
                    const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dqkv,
                    float* __restrict__ dbias, int bw, int n, int heads,
                    int n_windows, int per_group, float q_scale) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [n][LD], q * scale
  float* ks = qs + n * LD;
  float* vs = ks + n * LD;
  float* dos = vs + n * LD;
  float* lse_s = dos + n * LD;                      // [n]
  float* dsum = lse_s + n;                          // [n]
  int* ids = reinterpret_cast<int*>(dsum + n);      // [n]

  const int h = blockIdx.y;
  const int c = heads * DH;
  const int64_t tok = 3 * (int64_t)c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool masked = region_ids != nullptr;
  const float* bias_h = bias + (int64_t)h * n * n;
  float* dbias_h = dbias + (int64_t)h * n * n;
  const int w_end = min(bw, (blockIdx.x + 1) * per_group);

#pragma unroll 1
  for (int b = blockIdx.x * per_group; b < w_end; ++b) {
    const float* base = qkv + (int64_t)b * n * tok + (int64_t)h * DH;
    __syncthreads();
    stage_f32<DH>(base, tok, n, qs, q_scale);
    stage_f32<DH>(base + c, tok, n, ks, 1.f);
    stage_f32<DH>(base + 2 * c, tok, n, vs, 1.f);
    stage_f32<DH>(dout + (int64_t)b * n * c + (int64_t)h * DH, c, n, dos,
                  1.f);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      lse_s[j] = lse[((int64_t)b * heads + h) * n + j];
    stage_ids(region_ids, b, n_windows, n, ids);
    __syncthreads();

    // phase A: a warp per query row, lanes along keys
    for (int i = warp; i < n; i += kBwdWarps) {
      float q[DH], o[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        q[d] = qs[i * LD + d];
        o[d] = dos[i * LD + d];
      }
      const float* brow = bias_h + (int64_t)i * n;
      const int my_id = masked ? ids[i] : 0;
      const float li = lse_s[i];
      auto pd = [&](int j, float& p, float& dp) {
        float s = 0.f;
        dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          s = fmaf(q[d], ks[j * LD + d], s);
          dp = fmaf(o[d], vs[j * LD + d], dp);
        }
        s += brow[j];
        if (masked && ids[j] != my_id) s += -100.f;
        p = expf(s - li);
      };
      float dsum_i = 0.f;
      for (int j = lane; j < n; j += 32) {
        float p, dp;
        pd(j, p, dp);
        dsum_i = fmaf(p, dp, dsum_i);
      }
      dsum_i = warp_sum(dsum_i);
      if (lane == 0) dsum[i] = dsum_i;
      float acc[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = 0.f;
      for (int j = lane; j < n; j += 32) {
        float p, dp;
        pd(j, p, dp);
        const float ds = p * (dp - dsum_i);
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, ks[j * LD + d], acc[d]);
      }
      float mine = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        const float v = warp_sum(acc[d]);
        if (lane == d) mine = v;
      }
      if (lane < DH)
        dqkv[((int64_t)b * n + i) * tok + (int64_t)h * DH + lane] =
            mine * q_scale;
    }
    __syncthreads();

    // phase B: a thread per key, along the rows; dS added into dbias
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float k[DH], v[DH], dk[DH], dv[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        k[d] = ks[j * LD + d];
        v[d] = vs[j * LD + d];
        dk[d] = dv[d] = 0.f;
      }
      const int key_id = masked ? ids[j] : 0;
      for (int i = 0; i < n; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          s = fmaf(qs[i * LD + d], k[d], s);
          dp = fmaf(dos[i * LD + d], v[d], dp);
        }
        s += bias_h[(int64_t)i * n + j];
        if (masked && ids[i] != key_id) s += -100.f;
        const float p = expf(s - lse_s[i]);
        const float ds = p * (dp - dsum[i]);
        atomicAdd(dbias_h + (int64_t)i * n + j, ds);
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dk[d] = fmaf(ds, qs[i * LD + d], dk[d]);
          dv[d] = fmaf(p, dos[i * LD + d], dv[d]);
        }
      }
      float* dst = dqkv + ((int64_t)b * n + j) * tok + (int64_t)h * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dst[c + d] = dk[d];
        dst[2 * c + d] = dv[d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

int smem_optin() {
  int dev = 0, bytes = 227 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  return bytes;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
cudaError_t forward_dh(const void* qkv, const void* bias,
                       const void* region_ids, void* out, void* lse, int bw,
                       int n, int heads, int n_windows, float q_scale,
                       int dtype, cudaStream_t stream) {
  const int* ids = static_cast<const int*>(region_ids);
  const float* b = static_cast<const float*>(bias);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    // 64 rows a CTA, or fewer where the grid would not fill the card
    // four times over
    int rows_cta = kF32Rows;
    while (rows_cta > 16 && (int64_t)bw * ((n + rows_cta - 1) / rows_cta) *
                                    heads < 4 * sm_count())
      rows_cta /= 2;
    const size_t smem = (size_t)(2 * n + rows_cta) * (DH + 1) * 4 +
                        (size_t)n * 4;
    auto kernel = attn_fwd_f32_kernel<DH>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bw, (n + rows_cta - 1) / rows_cta, heads);
    kernel<<<grid, kF32Warps * 32, smem, stream>>>(
        static_cast<const float*>(qkv), b, ids, static_cast<float*>(out), l,
        n, heads, n_windows, rows_cta, q_scale);
  } else {
    constexpr int DHP = DH < 16 ? 16 : DH;
    const int npad = (n + 15) / 16 * 16;
    const bool vec =
        n % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
    auto kernel = vec ? attn_fwd_bf16_kernel<DH, true>
                      : attn_fwd_bf16_kernel<DH, false>;
    // rows a CTA: 96 where that still gives two CTAs an SM, else 64 where
    // that gives one, else 32; runs of windows: about eight waves of CTAs
    // over the card, two window buffers where a run holds more than one
    const int sms = sm_count();
    auto blocks = [&](int w) { return (npad / 16 + w - 1) / w; };
    int warps = 2;
    size_t smem = 0;
    auto smem_for = [&](int nbuf) {
      return (size_t)16 * warps * bias_ld(npad) * 4 +
             (size_t)nbuf * ((2 * npad + 16 * warps) * nat_ld(DHP) * 2 +
                             npad * 4);
    };
    const int choices[2] = {kFwdMaxWarps, 4};
    for (int w : choices) {
      warps = w;
      if ((int64_t)bw * blocks(w) * heads >= (w == 4 ? 1 : 2) * sms &&
          smem_for(2) <= (size_t)smem_optin())
        break;
      warps = 2;
    }
    cudaError_t err = allow_smem(kernel, smem_for(2));
    if (err != cudaSuccess) return err;
    int resident = 1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        warps * 32,
                                                        smem_for(2));
    if (err != cudaSuccess) return err;
    const int64_t units = (int64_t)blocks(warps) * heads;
    int64_t groups = (8LL * sms * (resident > 0 ? resident : 1) + units - 1) /
                     units;
    groups = groups < bw ? groups : bw;
    const int per_group = (int)((bw + groups - 1) / groups);
    groups = (bw + per_group - 1) / per_group;
    smem = smem_for(per_group > 1 ? 2 : 1);
    dim3 grid(blocks(warps), heads, (unsigned)groups);
    kernel<<<grid, warps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), b, ids,
        static_cast<__nv_bfloat16*>(out), l, bw, n, heads, n_windows,
        per_group, q_scale);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t backward_dh(const void* qkv, const void* bias,
                        const void* region_ids, const void* lse,
                        const void* dout, void* dqkv, void* dbias, int bw,
                        int n, int heads, int n_windows, int groups,
                        float q_scale, int dtype, cudaStream_t stream) {
  const int per_group = (bw + groups - 1) / groups;
  const int* ids = static_cast<const int*>(region_ids);
  const float* b = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  float* db = static_cast<float*>(dbias);
  dim3 grid(groups, heads);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = (size_t)4 * n * (DH + 1) * 4 + (size_t)3 * n * 4;
    auto kernel = attn_bwd_f32_kernel<DH>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBwdWarps * 32, smem, stream>>>(
        static_cast<const float*>(qkv), b, ids, l,
        static_cast<const float*>(dout), static_cast<float*>(dqkv), db, bw,
        n, heads, n_windows, per_group, q_scale);
  } else {
    constexpr int DHP = DH < 16 ? 16 : DH;
    const int npad = (n + 15) / 16 * 16;
    const size_t smem = (size_t)4 * npad * nat_ld(DHP) * 2 +
                        (size_t)3 * DHP * tr_ld(npad) * 2 +
                        (size_t)2 * npad * 4 + (size_t)n * 4;
    auto kernel = attn_bwd_bf16_kernel<DH>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBwdWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), b, ids, l,
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<__nv_bfloat16*>(dqkv), db, bw, n, heads, n_windows,
        per_group, q_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. region_ids may be null (no shift mask);
// lse (f32 (BW, H, N)) is written only when non-null. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int window_attention_forward(const void* qkv, const void* bias,
                                        const void* region_ids, void* out,
                                        void* lse, int bw, int n, int heads,
                                        int head_dim, int n_windows,
                                        float q_scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 4:
      return forward_dh<4>(qkv, bias, region_ids, out, lse, bw, n, heads,
                           n_windows, q_scale, dtype, s);
    case 8:
      return forward_dh<8>(qkv, bias, region_ids, out, lse, bw, n, heads,
                           n_windows, q_scale, dtype, s);
    case 16:
      return forward_dh<16>(qkv, bias, region_ids, out, lse, bw, n, heads,
                            n_windows, q_scale, dtype, s);
    case 32:
      return forward_dh<32>(qkv, bias, region_ids, out, lse, bw, n, heads,
                            n_windows, q_scale, dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The gradients of window_attention_forward for qkv (written into dqkv,
// (BW, N, 3, H, Dh) in the working type) and the f32 bias (added into dbias,
// (H, N, N), which the caller zeroes), from the forward's lse and the output
// gradient dout ((BW, N, H, Dh)). `groups` CTAs per head each take a run of
// windows.
extern "C" int window_attention_backward(
    const void* qkv, const void* bias, const void* region_ids,
    const void* lse, const void* dout, void* dqkv, void* dbias, int bw, int n,
    int heads, int head_dim, int n_windows, int groups, float q_scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || groups < 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 4:
      return backward_dh<4>(qkv, bias, region_ids, lse, dout, dqkv, dbias, bw,
                            n, heads, n_windows, groups, q_scale, dtype, s);
    case 8:
      return backward_dh<8>(qkv, bias, region_ids, lse, dout, dqkv, dbias, bw,
                            n, heads, n_windows, groups, q_scale, dtype, s);
    case 16:
      return backward_dh<16>(qkv, bias, region_ids, lse, dout, dqkv, dbias,
                             bw, n, heads, n_windows, groups, q_scale, dtype,
                             s);
    case 32:
      return backward_dh<32>(qkv, bias, region_ids, lse, dout, dqkv, dbias,
                             bw, n, heads, n_windows, groups, q_scale, dtype,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
