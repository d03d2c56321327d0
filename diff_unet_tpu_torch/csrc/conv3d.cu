// 3x3x3 'same' conv3d over channels-last (NDHWC) tensors for Hopper
// (sm_90a), with a fused input prologue and a fused bias / LeakyReLU /
// instance-norm-statistics epilogue.
//
// Replaces four Pallas TPU kernels of diff_unet_tpu, which all compute one
// function on TPU-specific layouts:
//   ops/pallas_packed_conv.py  conv3x3_packed_aug            (pack-2 parts,
//                              bias, optional LeakyReLU epilogue)
//   ops/pallas_packed_conv.py  conv3x3_packed_aug_pipelined  (the same plus
//                              the input prologue lrelu(a*x+b)+c and the
//                              per-(sample, channel) sum / sum-of-squares)
//   ops/pallas_aug_conv.py     conv3x3_aug                   (pack-2 input
//                              through augmented 4C rows)
//   ops/pallas_conv.py         conv3d_same                   (27 tap matmuls
//                              over halo slabs, no bias)
// Here, for input parts whose channel concat is x (no concat is built):
//
//   u   = prologue(x) at in-bounds voxels, 0 in the halo   (rounded to T)
//   y   = sum_{tap, ci} u[voxel + tap, ci] * w[co, tap, ci] + bias[co]
//   y   = y >= 0 ? y : y * act_slope                      (act_slope 1: none)
//   out = T(y);  stats[n, 0, co] += y;  stats[n, 1, co] += y * y  (f32 y)
//
// What bounds it on an H100: at the 64+ channel levels the conv does
// 54*Cin operations per output value and needs each input value once from
// HBM, ~860 operations per byte at 64 channels against the ~295 at which
// bf16 turns operation-bound: tensor-core operations bound it. At the stems
// (1 and 1 + 15 input channels) it is bytes: 16 operand channels against
// 64 output channels per voxel.
//
// bf16 design (conv3d_wgmma_kernel), the algorithm of the TPU's
// conv3x3_packed_aug_pipelined brought to Hopper:
// - The work is bricks of 2 x 8 x 8 output voxels (z, y, x) of one sample
//   times BN (64 or 128) output channels: 128 GEMM rows, 64 for each of a
//   CTA's two consumer warpgroups (one z slice each). Ragged bricks mask
//   their rows out of the store and the statistics; a brick never spans
//   two samples, so the statistics take one atomic pair per (brick,
//   channel). Large grids run on persistent CTAs (two per SM at BN 64) that
//   walk the bricks, the producers already loading the next brick while
//   the consumers finish the last one.
// - The input arrives in chunks of 16 channels as a 4 x 10 x 10 halo tile,
//   laid out as two planes of 8 channels with 16 bytes per voxel: 8
//   consecutive x of one plane are one wgmma "core matrix" (no swizzle),
//   so each of the 27 taps is the same tile read at another start address
//   ((z+dz)*10 + y+dy)*10 + x+dx. The tile comes by TMA
//   (cp.async.bulk.tensor, one 5-D tensor map per input part, start
//   coordinates of -1 give the zero halo) into a two-stage ring. Parts
//   whose rows TMA cannot map (the stems: 1 and 15 channels) are gathered
//   by the producer warps into the same layout instead.
// - The prologue runs once per value: the producer warps rewrite each
//   arrived tile in place, in f32, at in-bounds voxels only (the halo
//   stays 0, which prologue(0) would not be).
// - Weights are packed by the wrapper as (Cout block, chunk, tap, 8-channel
//   half, BN, 8): each (chunk, dz) stage of 9 taps is one contiguous bulk
//   copy (the TMA engine's non-tensor mode) in the core-matrix layout, from
//   a warp of its own.
// - Consumers issue wgmma.mma_async m64nBNk16 from both operands in shared
//   memory, f32 accumulators in registers, one commit group per stage with
//   one group kept in flight.
// - Where the grid is too small for 132 SMs (12^3, 6^3) the chunk loop is
//   split across CTAs: f32 partial tiles go to a workspace, and the last
//   CTA of each tile (an atomic counter) adds them up and runs the
//   epilogue, so the statistics are taken once, from the finished sums.
// - Epilogue from the registers: bias, LeakyReLU, statistics by warp
//   shuffles and a shared-memory reduction, bf16 rounding staged through
//   shared memory for 16-byte coalesced stores.
// At BN 64 (96^3, 48^3) both operands come from shared memory at 4 KB per
// m64n64k16, which is as much as shared memory delivers in the MMA's time:
// that, not HBM, caps those shapes near half the tensor-core peak.
//
// float32 runs a true-fp32 FFMA implicit GEMM (64x64 tiles, 4x4 per
// thread, no TF32), with weights as (Cout_pad, K_pad), k = tap * Cin + ci.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxParts = 4;
constexpr int kThreads = 256;

struct ConvArgs {
  const void* part[kMaxParts];  // NDHWC, part_c[i] channels each
  int part_c[kMaxParts];
  int part_off[kMaxParts];      // first concat channel of each part
  int nparts;
  const void* wt;               // (cout_pad, k_pad), k = tap * cin + ci
  const float* bias;            // (cout) or null
  const float* pro_scale;       // (n, cin) or null: no prologue
  const float* pro_shift;       // (n, cin)
  const float* pro_const;       // (n, cin) or null
  float pro_slope;              // 1: no prologue activation
  float act_slope;              // 1: no epilogue activation
  void* out;                    // (m_total, cout)
  float* stats;                 // (n, 2, cout), zeroed, or null
  int n, d, h, w, cin, cout, k_total, k_pad, spatial;
  long long m_total;
};

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// One output row (voxel) of the tile, decoded once per block.
struct Row {
  long long vox;  // flat output voxel index, -1 beyond m_total
  int n, z, y, x;
};

__device__ __forceinline__ Row decode_row(const ConvArgs& a, long long m) {
  Row r;
  if (m >= a.m_total) {
    r.vox = -1;
    r.n = r.z = r.y = r.x = 0;
    return r;
  }
  r.vox = m;
  r.n = (int)(m / a.spatial);
  int s = (int)(m - (long long)r.n * a.spatial);
  r.x = s % a.w;
  s /= a.w;
  r.y = s % a.h;
  r.z = s / a.h;
  return r;
}

// The (tap, channel) of flat k, and which part holds the channel.
struct KPos {
  int dz, dy, dx;        // tap offsets in {-1, 0, 1}
  int ci;                // concat channel
  bool valid;            // k < k_total
};

__device__ __forceinline__ KPos decode_k(const ConvArgs& a, int k) {
  KPos p;
  p.valid = k < a.k_total;
  const int tap = k / a.cin;
  p.ci = k - tap * a.cin;
  const int tz = tap / 9, rem = tap - tz * 9, ty = rem / 3;
  p.dz = tz - 1;
  p.dy = ty - 1;
  p.dx = rem - ty * 3 - 1;
  return p;
}

__device__ __forceinline__ float prologue_one(const ConvArgs& a, int n, int ci,
                                              float v) {
  const int i = n * a.cin + ci;
  float u = v * a.pro_scale[i] + a.pro_shift[i];
  u = u >= 0.f ? u : u * a.pro_slope;
  if (a.pro_const) u += a.pro_const[i];
  return u;
}

// Element pointer of concat channel ci at input voxel vox (selects the part
// with constant-index parameter reads).
template <typename T>
__device__ __forceinline__ const T* elem_ptr(const ConvArgs& a, long long vox,
                                             int ci) {
  const void* base = a.part[0];
  int pc = a.part_c[0], po = 0;
#pragma unroll
  for (int i = 1; i < kMaxParts; ++i) {
    if (i < a.nparts && ci >= a.part_off[i]) {
      base = a.part[i];
      pc = a.part_c[i];
      po = a.part_off[i];
    }
  }
  return static_cast<const T*>(base) + vox * pc + (ci - po);
}

__device__ __forceinline__ bool inside(const ConvArgs& a, const Row& r,
                                       const KPos& p) {
  return r.vox >= 0 && p.valid &&
         (unsigned)(r.z + p.dz) < (unsigned)a.d &&
         (unsigned)(r.y + p.dy) < (unsigned)a.h &&
         (unsigned)(r.x + p.dx) < (unsigned)a.w;
}

__device__ __forceinline__ long long tap_vox(const ConvArgs& a, const Row& r,
                                             const KPos& p) {
  return r.vox + ((long long)p.dz * a.h + p.dy) * a.w + p.dx;
}

// 16 bytes of the A (input) tile: E = 16 / sizeof(T) consecutive k of one
// output row. VEC: every part's channel count is a multiple of E and the
// pointers are 16-byte aligned, so the E values are one tap and one part
// and load as one vector. Otherwise each value is gathered on its own.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_a(const ConvArgs& a, const Row& r,
                                        int k0) {
  constexpr int E = 16 / sizeof(T);
  union {
    uint4 u;
    T e[E];
  } v;
  v.u = make_uint4(0, 0, 0, 0);
  if (VEC) {
    const KPos p = decode_k(a, k0);
    if (!inside(a, r, p)) return v.u;
    v.u = *reinterpret_cast<const uint4*>(
        elem_ptr<T>(a, tap_vox(a, r, p), p.ci));
    if (a.pro_scale) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v.e[e] = from_f<T>(prologue_one(a, r.n, p.ci + e, to_f(v.e[e])));
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const KPos p = decode_k(a, k0 + e);
      if (!inside(a, r, p)) continue;
      const T x = *elem_ptr<T>(a, tap_vox(a, r, p), p.ci);
      v.e[e] = a.pro_scale
                   ? from_f<T>(prologue_one(a, r.n, p.ci, to_f(x)))
                   : x;
    }
  }
  return v.u;
}

// 16 bytes of the B (weight) tile: E consecutive k of output channel co.
template <typename T>
__device__ __forceinline__ uint4 load_b(const ConvArgs& a, int co, int k0) {
  return *reinterpret_cast<const uint4*>(static_cast<const T*>(a.wt) +
                                         (long long)co * a.k_pad + k0);
}

// Epilogue shared by both paths. cs holds the block's BM x BN f32 results
// (bias and activation applied), row stride LDC. Writes the rounded output
// (coalesced along channels) and adds the per-(sample, channel) sum and
// sum of squares to stats.
template <typename T, int BM, int BN, int LDC>
__device__ __forceinline__ void store_and_stats(const ConvArgs& a,
                                                const float* cs,
                                                long long m0, int n0) {
  const int t = threadIdx.x;
  T* out = static_cast<T*>(a.out);
  for (int idx = t; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx - r * BN;
    const long long m = m0 + r;
    const int co = n0 + c;
    if (m < a.m_total && co < a.cout)
      out[m * a.cout + co] = from_f<T>(cs[r * LDC + c]);
  }
  if (a.stats == nullptr) return;

  constexpr int RG = kThreads / BN;  // row groups per column
  constexpr int RPG = BM / RG;       // rows per group
  const int c = t % BN, g = t / BN, co = n0 + c;
  const long long last = (m0 + BM < a.m_total ? m0 + BM : a.m_total) - 1;
  const bool one_sample = (m0 / a.spatial) == (last / a.spatial);
  if (one_sample) {
    // block-uniform branch: reduce the row groups in shared memory, then
    // one atomic pair per column
    __shared__ float red[2][kThreads];
    float s = 0.f, s2 = 0.f;
    for (int r = g * RPG; r < (g + 1) * RPG; ++r) {
      if (m0 + r > last) break;
      const float v = cs[r * LDC + c];
      s += v;
      s2 += v * v;
    }
    red[0][t] = s;
    red[1][t] = s2;
    __syncthreads();
    if (g == 0 && co < a.cout) {
      for (int k = 1; k < RG; ++k) {
        s += red[0][k * BN + c];
        s2 += red[1][k * BN + c];
      }
      const int n = (int)(m0 / a.spatial);
      atomicAdd(&a.stats[(2 * n) * a.cout + co], s);
      atomicAdd(&a.stats[(2 * n + 1) * a.cout + co], s2);
    }
    return;
  }
  if (co >= a.cout) return;
  float s = 0.f, s2 = 0.f;
  int cur = -1;
  for (int r = g * RPG; r < (g + 1) * RPG; ++r) {
    const long long m = m0 + r;
    if (m > last) break;
    const int n = (int)(m / a.spatial);
    if (n != cur) {
      if (cur >= 0) {
        atomicAdd(&a.stats[(2 * cur) * a.cout + co], s);
        atomicAdd(&a.stats[(2 * cur + 1) * a.cout + co], s2);
      }
      cur = n;
      s = s2 = 0.f;
    }
    const float v = cs[r * LDC + c];
    s += v;
    s2 += v * v;
  }
  if (cur >= 0) {
    atomicAdd(&a.stats[(2 * cur) * a.cout + co], s);
    atomicAdd(&a.stats[(2 * cur + 1) * a.cout + co], s2);
  }
}

__device__ __forceinline__ float epilogue_value(const ConvArgs& a, float acc,
                                                int co) {
  float v = acc + ((a.bias != nullptr && co < a.cout) ? a.bias[co] : 0.f);
  return v >= 0.f ? v : v * a.act_slope;
}

// ---------------------------------------------------------------- fp32 path
namespace f32 {
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int LDS = BM + 4;   // transposed tiles [BK][BM + 4]
constexpr int LDC = BN + 4;
constexpr int SMEM_AB = 2 * 2 * BK * LDS * 4;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
}  // namespace f32

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3d_f32_kernel(const ConvArgs a) {
  using namespace f32;
  __shared__ __align__(16) unsigned char smem[SMEM];
  float* as = reinterpret_cast<float*>(smem);      // [2][BK][LDS]
  float* bs = as + 2 * BK * LDS;                   // [2][BK][LDS]
  float* cs = reinterpret_cast<float*>(smem);      // [BM][LDC] (epilogue)

  const int t = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int lr = t >> 2, lc = t & 3;               // loader row, 4-k chunk
  const Row r0 = decode_row(a, m0 + lr);
  const int tx = t & 15, ty = t >> 4;              // 4x4 micro-tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto store = [&](int buf, const uint4& ua, const uint4& ub) {
    const float* fa = reinterpret_cast<const float*>(&ua);
    const float* fb = reinterpret_cast<const float*>(&ub);
    float* A = as + buf * BK * LDS;
    float* B = bs + buf * BK * LDS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      A[(lc * 4 + e) * LDS + lr] = fa[e];
      B[(lc * 4 + e) * LDS + lr] = fb[e];
    }
  };

  const int kt_n = a.k_pad / BK;
  uint4 ra = load_a<float, VEC>(a, r0, lc * 4);
  uint4 rb = load_b<float>(a, n0 + lr, lc * 4);
  store(0, ra, rb);
  __syncthreads();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < kt_n;
    if (more) {
      const int k0 = (kt + 1) * BK + lc * 4;
      ra = load_a<float, VEC>(a, r0, k0);
      rb = load_b<float>(a, n0 + lr, k0);
    }
    const float* A = as + cur * BK * LDS;
    const float* B = bs + cur * BK * LDS;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(A + k * LDS + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(B + k * LDS + tx * 4);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    if (more) store(cur ^ 1, ra, rb);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx * 4 + j;
      cs[(ty * 4 + i) * LDC + col] = epilogue_value(a, acc[i][j], n0 + col);
    }
  __syncthreads();
  store_and_stats<float, BM, BN, LDC>(a, cs, m0, n0);
}

// ---------------------------------------------------------------- bf16 path
namespace hw {
// A CTA: two consumer warpgroups, one output z slice of 8 x 8 voxels each,
// and one producer warpgroup; its brick is 2 x 8 x 8 voxels.
constexpr int kConsumers = 256;
constexpr int kCtaThreads = kConsumers + 128;
constexpr int kHaloThreads = 96;         // producer threads on the halo
constexpr int BZ = 2, BY = 8, BX = 8;    // output brick (z, y, x)
constexpr int HZ = BZ + 2, HY = BY + 2, HX = BX + 2;
constexpr int HVOX = HZ * HY * HX;       // halo voxels
constexpr int PLANE = HVOX * 16;         // bytes of one 8-channel plane
constexpr int HALO_BYTES = 2 * PLANE;
constexpr int KC = 16;                   // channels per chunk
constexpr int kGather = 2;               // gathered voxels in flight
// ring stages: the halo (HS chunks), the weights (WS (chunk, dz) slabs)
constexpr int HS = 2, WS = 3;
// gathered voxels per producer thread (each fills one plane of its
// voxels), rounded up to whole batches
constexpr int kHaloItems =
    (HVOX + kHaloThreads / 2 * kGather - 1) / (kHaloThreads / 2 * kGather) *
    kGather;
template <int BN>
struct Cfg {
  // the rings, then the epilogue's own buffers (the rings fill for the
  // next brick meanwhile): the staged output and the statistics' reduction
  static constexpr bool kTwoPerSm = BN == 64;       // two CTAs share an SM
  static constexpr int W_BYTES = 9 * KC * BN * 2;    // one (chunk, dz) stage
  static constexpr int LDO = BN + 8;                 // staged output row
  static constexpr int OFF_W = HS * HALO_BYTES;
  static constexpr int OFF_STAGE = OFF_W + WS * W_BYTES;
  static constexpr int OFF_RED = OFF_STAGE + 64 * BZ * LDO * 2;
  static constexpr int OFF_BAR = OFF_RED + kConsumers / 32 * 2 * BN * 4;
  static constexpr int NBAR = 3 * HS + 2 * WS;
  static constexpr int SMEM = OFF_BAR + NBAR * 8 + 16;
  static_assert(!kTwoPerSm || 2 * (SMEM + 1024) <= 228 * 1024, "2 CTAs/SM");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};
}  // namespace hw

struct WArgs {
  CUtensorMap map[kMaxParts];   // box {8, 10, 10, 4, 1} of each part (TMA)
  const __nv_bfloat16* part[kMaxParts];
  int part_c[kMaxParts];
  int part_off[kMaxParts];
  int nparts;
  const __nv_bfloat16* wt;      // (cout_pad / BN, nchunk, 27, 2, BN, 8)
  const float* bias;            // (cout) or null
  const float* pro_scale;       // (n, cin) or null: no prologue
  const float* pro_shift;
  const float* pro_const;       // or null
  float pro_slope, act_slope;
  __nv_bfloat16* out;           // (n, d, h, w, cout)
  float* stats;                 // (n, 2, cout), zeroed, or null
  float* partial;               // split > 1: (tiles, split, 256, BN / 2)
  int* counter;                 // split > 1: (tiles), zeroed
  int n, d, h, w, cin, cout, nchunk, split, per_split, nzb, nyb, nxb;
  int nbricks;                  // n * nzb * nyb * nxb
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Wait until the phase of the given parity has completed. A wait of more
// than ~2^35 cycles (tens of seconds) traps: a lost arrival becomes a
// launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}
// Generic-proxy writes to shared memory, made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(hw::kConsumers) : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3), "r"(c4) : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// wgmma shared-memory descriptor, no swizzle: lbo steps between the two
// 8-channel core matrices of a k16 step, sbo between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of v across an asynchronous
// wgmma that writes it.
__device__ __forceinline__ void reg_fence(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// d += A * B for one m64nBNk16 step, A and B read from shared memory
// through their descriptors (K-major, no swizzle).
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da,
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Index of the barriers in shared memory.
struct Bars {
  uint32_t base;
  __device__ uint32_t halo_full(int s) const { return base + 8 * s; }
  __device__ uint32_t halo_ready(int s) const {
    return base + 8 * (hw::HS + s);
  }
  __device__ uint32_t halo_empty(int s) const {
    return base + 8 * (2 * hw::HS + s);
  }
  __device__ uint32_t w_full(int s) const {
    return base + 8 * (3 * hw::HS + s);
  }
  __device__ uint32_t w_empty(int s) const {
    return base + 8 * (3 * hw::HS + hw::WS + s);
  }
};

struct Brick {
  int n, z0, y0, x0;
};

__device__ __forceinline__ Brick decode_brick(const WArgs& a, int i) {
  Brick b;
  b.x0 = (i % a.nxb) * hw::BX;
  i /= a.nxb;
  b.y0 = (i % a.nyb) * hw::BY;
  i /= a.nyb;
  b.z0 = (i % a.nzb) * hw::BZ;
  b.n = i / a.nzb;
  return b;
}

__device__ __forceinline__ float prologue_f(const WArgs& a, float v, float sc,
                                            float sh, float cs) {
  float u = v * sc + sh;
  u = u >= 0.f ? u : u * a.pro_slope;
  return u + cs;
}

// The producer warpgroup. Its last warp streams the weights: for each
// 16-channel chunk of this CTA's split, three (dz) stages of 9 taps. The
// other three warps bring each chunk's halo tile (TMA, or gathered where
// TMA cannot map a part), apply the prologue to the arrived tile and mark
// it ready. The two streams wait on nothing of each other.
template <int BN, bool TMA>
__device__ void produce(const WArgs& a, unsigned char* smem,
                        const Bars& bar, int cb, int j0, int j1) {
  using namespace hw;
  using C = Cfg<BN>;
  const int pt = threadIdx.x - kConsumers;
  if (pt >= kHaloThreads) {
    if (pt != kHaloThreads) return;
    int wit = 0;
    for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
      for (int j = j0; j < j1; ++j) {
        for (int dz = 0; dz < 3; ++dz, ++wit) {
          const int ws = wit % WS;
          mbar_wait(bar.w_empty(ws), ((wit / WS) & 1) ^ 1);
          mbar_expect_tx(bar.w_full(ws), C::W_BYTES);
          bulk_load(smem_u32(smem + C::OFF_W + ws * C::W_BYTES),
                    a.wt + (((long long)cb * a.nchunk + j) * 27 + dz * 9) *
                               (2 * BN * 8),
                    C::W_BYTES, bar.w_full(ws));
        }
      }
    }
    return;
  }
  const int p = pt & 1;                 // the plane (8 channels) it fills
  int hit = 0;
  for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
    const Brick b = decode_brick(a, brick);
    for (int j = j0; j < j1; ++j, ++hit) {
      const int hs = hit % HS;
      const uint32_t hpar = (hit / HS) & 1;
      unsigned char* halo = smem + hs * HALO_BYTES;
      if (TMA) {
        if (pt == 0) {
          mbar_wait(bar.halo_empty(hs), hpar ^ 1);
          mbar_expect_tx(bar.halo_full(hs), HALO_BYTES);
          int pi = 0;
#pragma unroll
          for (int i = 1; i < kMaxParts; ++i)
            if (i < a.nparts && KC * j >= a.part_off[i]) pi = i;
          const int cl = KC * j - a.part_off[pi];
          for (int q = 0; q < 2; ++q)
            tma_load_5d(smem_u32(halo + q * PLANE), &a.map[pi],
                        bar.halo_full(hs), cl + 8 * q, b.x0 - 1, b.y0 - 1,
                        b.z0 - 1, b.n);
        }
      } else {
        // the loads of kGather voxels are issued before their stores, so
        // their latencies overlap (more would cost registers, and with them
        // the second CTA on the SM). Where the chunk's second plane is all
        // padding (Cin <= 16 j + 8: the stems) every thread gathers the
        // first plane and the second is zero-filled.
        const bool one_plane = KC * j + 8 >= a.cin;
        const int q = one_plane ? 0 : p;
        const int first = one_plane ? pt : pt >> 1;
        const int step = one_plane ? kHaloThreads : kHaloThreads / 2;
        mbar_wait(bar.halo_empty(hs), hpar ^ 1);
        if (one_plane) {
          for (int v = pt; v < HVOX; v += kHaloThreads)
            *reinterpret_cast<uint4*>(halo + PLANE + v * 16) =
                make_uint4(0, 0, 0, 0);
        }
        for (int k0 = 0; k0 < kHaloItems; k0 += kGather) {
          union {
            uint4 u;
            __nv_bfloat16 e[8];
          } val[kGather];
#pragma unroll
          for (int k = 0; k < kGather; ++k) {
            const int v = first + (k0 + k) * step;
            const int hz = v / (HY * HX), r = v - hz * HY * HX, hy = r / HX;
            const int gz = b.z0 - 1 + hz, gy = b.y0 - 1 + hy,
                      gx = b.x0 - 1 + r - hy * HX;
            val[k].u = make_uint4(0, 0, 0, 0);
            if (v >= HVOX || (unsigned)gz >= (unsigned)a.d ||
                (unsigned)gy >= (unsigned)a.h || (unsigned)gx >= (unsigned)a.w)
              continue;
            const long long vox =
                (((long long)b.n * a.d + gz) * a.h + gy) * a.w + gx;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int c = KC * j + 8 * q + e;
              if (c >= a.cin) break;
              const __nv_bfloat16* base = a.part[0];
              int pc = a.part_c[0], po = 0;
#pragma unroll
              for (int i = 1; i < kMaxParts; ++i) {
                if (i < a.nparts && c >= a.part_off[i]) {
                  base = a.part[i];
                  pc = a.part_c[i];
                  po = a.part_off[i];
                }
              }
              val[k].e[e] = base[vox * pc + (c - po)];
            }
          }
#pragma unroll
          for (int k = 0; k < kGather; ++k) {
            const int v = first + (k0 + k) * step;
            if (v >= HVOX) break;
            *reinterpret_cast<uint4*>(halo + q * PLANE + v * 16) = val[k].u;
          }
        }
      }
      if (TMA) mbar_wait(bar.halo_full(hs), hpar);
      if (a.pro_scale) {
        // other threads gathered the voxels this one rewrites
        if (!TMA)
          asm volatile("bar.sync 2, %0;" ::"n"(kHaloThreads) : "memory");
        // the prologue, once per value of the arrived tile; padding
        // channels (c >= cin) get scale, shift and const 0 and stay 0
        const int c0 = KC * j + 8 * p, k0 = b.n * a.cin + c0;
        float sc[8], sh[8], cs[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool real = c0 + e < a.cin;
          sc[e] = real ? a.pro_scale[k0 + e] : 0.f;
          sh[e] = real ? a.pro_shift[k0 + e] : 0.f;
          cs[e] = real && a.pro_const ? a.pro_const[k0 + e] : 0.f;
        }
#pragma unroll 3
        for (int v = pt >> 1; v < HVOX; v += kHaloThreads / 2) {
          const int hz = v / (HY * HX), r = v - hz * HY * HX, hy = r / HX;
          const int gz = b.z0 - 1 + hz, gy = b.y0 - 1 + hy,
                    gx = b.x0 - 1 + r - hy * HX;
          // the halo outside the volume stays 0
          if ((unsigned)gz >= (unsigned)a.d || (unsigned)gy >= (unsigned)a.h ||
              (unsigned)gx >= (unsigned)a.w)
            continue;
          union {
            uint4 u;
            __nv_bfloat16 e[8];
          } val;
          uint4* q = reinterpret_cast<uint4*>(halo + p * PLANE + v * 16);
          val.u = *q;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            val.e[e] = __float2bfloat16(prologue_f(
                a, __bfloat162float(val.e[e]), sc[e], sh[e], cs[e]));
          *q = val.u;
        }
      }
      fence_async_smem();
      mbar_arrive(bar.halo_ready(hs));
    }
  }
}

// One CTA walks the bricks blockIdx.x, blockIdx.x + gridDim.x, ... of
// the volume (each 2 x 8 x 8 voxels of one sample) for output channels
// [cb * BN, cb * BN + BN) and channel chunks [j0, j1) of blockIdx.z's
// split; its producers run ahead into the next brick while the consumers
// finish the last one.
template <int BN, bool TMA>
__global__ void __launch_bounds__(hw::kCtaThreads,
                                  hw::Cfg<BN>::kTwoPerSm ? 2 : 1)
conv3d_wgmma_kernel(const __grid_constant__ WArgs a) {
  using namespace hw;
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Bars bar{smem_u32(smem + C::OFF_BAR)};
  int* last_flag = reinterpret_cast<int*>(smem + C::OFF_BAR + C::NBAR * 8);
  const int t = threadIdx.x;
  const int cb = blockIdx.y, split = blockIdx.z;
  const int j0 = split * a.per_split;
  const int j1 = min(a.nchunk, j0 + a.per_split);
  if (t == 0) {
    for (int s = 0; s < HS; ++s) {
      mbar_init(bar.halo_full(s), 1);
      mbar_init(bar.halo_ready(s), kHaloThreads);
      mbar_init(bar.halo_empty(s), kConsumers / 32);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(bar.w_full(s), 1);
      mbar_init(bar.w_empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t >= kConsumers) {
    produce<BN, TMA>(a, smem, bar, cb, j0, j1);
    return;
  }

  // ---- consumers: warpgroup wg computes output z slice z0 + wg
  const int wg = t >> 7, warp = t >> 5, lane = t & 31;
  const uint32_t halo0 = smem_u32(smem), w0 = smem_u32(smem + C::OFF_W);
  int wit = 0, hit = 0;
  for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
    const Brick b = decode_brick(a, brick);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev_ws = -1, prev_hs = -1;
    for (int j = j0; j < j1; ++j, ++hit) {
      const int hs = hit % HS;
      const uint32_t hpar = (hit / HS) & 1;
      if (TMA) mbar_wait(bar.halo_full(hs), hpar);
      mbar_wait(bar.halo_ready(hs), hpar);
      const uint32_t hbase = halo0 + hs * HALO_BYTES;
      for (int dz = 0; dz < 3; ++dz, ++wit) {
        const int ws = wit % WS;
        mbar_wait(bar.w_full(ws), (wit / WS) & 1);
        const uint32_t wbase = w0 + ws * C::W_BYTES;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const uint64_t da = smem_desc(
              hbase + (((wg + dz) * HY + dy) * HX + dx) * 16, PLANE,
              HX * 16);
          const uint64_t db = smem_desc(wbase + tap * (2 * BN * 16), BN * 16,
                                        128);
          wgmma_bf16<BN>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // the previous stage's products are done: hand its buffers back
        if (prev_ws >= 0 && lane == 0) {
          mbar_arrive(bar.w_empty(prev_ws));
          if (prev_hs >= 0) mbar_arrive(bar.halo_empty(prev_hs));
        }
        prev_ws = ws;
        prev_hs = dz == 2 ? hs : -1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    if (prev_ws >= 0 && lane == 0) {
      mbar_arrive(bar.w_empty(prev_ws));
      mbar_arrive(bar.halo_empty(prev_hs));
    }
    // the last brick's epilogue is done with the staged output and the
    // reduction buffer
    consumers_sync();

    if (a.split > 1) {
      const long long tile = (long long)cb * a.nbricks + brick;
      float* mine = a.partial +
                    ((tile * a.split + split) * kConsumers + t) * (BN / 2);
#pragma unroll
      for (int i = 0; i < BN / 2; i += 4)
        *reinterpret_cast<float4*>(mine + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
      __threadfence();
      consumers_sync();
      if (t == 0) {
        const int done = atomicAdd(a.counter + tile, 1);
        *last_flag = done == a.split - 1;
        if (done == a.split - 1) a.counter[tile] = 0;
      }
      consumers_sync();
      if (!*last_flag) continue;
      __threadfence();
      for (int s = 0; s < a.split; ++s) {
        if (s == split) continue;
        const float* other =
            a.partial + ((tile * a.split + s) * kConsumers + t) * (BN / 2);
#pragma unroll
        for (int i = 0; i < BN / 2; i += 4) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(other + i));
          acc[i] += v.x;
          acc[i + 1] += v.y;
          acc[i + 2] += v.z;
          acc[i + 3] += v.w;
        }
      }
    }

    // ---- epilogue. Accumulator i of this thread: row 16 * (warp % 4) +
    // lane / 4 (+ 8 for i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4) +
    // i % 2; row r of a warpgroup's 64 is voxel (y, x) = (r / 8, r % 8).
    const int w4 = warp & 3;
    const int zo = b.z0 + wg, xo = b.x0 + (lane >> 2), yo = b.y0 + 2 * w4;
    const bool in_zx = zo < a.d && xo < a.w;
    const bool valid0 = in_zx && yo < a.h, valid1 = in_zx && yo + 1 < a.h;
    __nv_bfloat16* staged =
        reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_STAGE);  // [128][LDO]
    const int row0 = wg * 64 + 16 * w4 + (lane >> 2);
    // bias, LeakyReLU, the bf16 output staged; the statistics of the f32
    // values summed over the warp's 16 rows of each column by shuffles.
    // The gathered-halo instance reduces each column as it goes (fewer
    // live registers, which it needs for two CTAs an SM without spills);
    // the TMA instance keeps the partial sums and reduces them together.
    float* red = reinterpret_cast<float*>(smem + C::OFF_RED);  // [warps][2][BN]
    float sum[TMA ? BN / 4 : 1], sq[TMA ? BN / 4 : 1];
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * jj + 2 * (lane & 3) + q, co = cb * BN + col;
        const float bias = (a.bias && co < a.cout) ? a.bias[co] : 0.f;
        float v0 = acc[4 * jj + q] + bias, v1 = acc[4 * jj + 2 + q] + bias;
        v0 = v0 >= 0.f ? v0 : v0 * a.act_slope;
        v1 = v1 >= 0.f ? v1 : v1 * a.act_slope;
        staged[row0 * C::LDO + col] = __float2bfloat16(v0);
        staged[(row0 + 8) * C::LDO + col] = __float2bfloat16(v1);
        v0 = valid0 ? v0 : 0.f;
        v1 = valid1 ? v1 : 0.f;
        const int k = TMA ? 2 * jj + q : 0;
        sum[k] = v0 + v1;
        sq[k] = v0 * v0 + v1 * v1;
        if (!TMA && a.stats) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], m);
            sq[0] += __shfl_xor_sync(0xffffffffu, sq[0], m);
          }
          if (lane < 4) {
            red[(warp * 2) * BN + col] = sum[0];
            red[(warp * 2 + 1) * BN + col] = sq[0];
          }
        }
      }
    }
    if (TMA && a.stats) {
#pragma unroll
      for (int k = 0; k < BN / 4; ++k) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], m);
          sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], m);
        }
      }
      if (lane < 4) {
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 8 * jj + 2 * lane + q;
            red[(warp * 2) * BN + col] = sum[2 * jj + q];
            red[(warp * 2 + 1) * BN + col] = sq[2 * jj + q];
          }
      }
    }
    consumers_sync();
    if (a.stats && t < BN && cb * BN + t < a.cout) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < kConsumers / 32; ++k) {
        s += red[(2 * k) * BN + t];
        s2 += red[(2 * k + 1) * BN + t];
      }
      const int co = cb * BN + t;
      atomicAdd(&a.stats[(2 * b.n) * a.cout + co], s);
      atomicAdd(&a.stats[(2 * b.n + 1) * a.cout + co], s2);
    }
    // 16-byte stores of 8 channels, consecutive threads along a voxel's row
    const bool vec = a.cout % 8 == 0;
    for (int idx = t; idx < 64 * BZ * (BN / 8); idx += kConsumers) {
      const int r = idx / (BN / 8), cc = (idx % (BN / 8)) * 8;
      const int z = b.z0 + r / 64, y = b.y0 + (r % 64) / 8, x = b.x0 + r % 8;
      const int co = cb * BN + cc;
      if (z >= a.d || y >= a.h || x >= a.w || co >= a.cout) continue;
      __nv_bfloat16* dst =
          a.out + ((((long long)b.n * a.d + z) * a.h + y) * a.w + x) * a.cout +
          co;
      const __nv_bfloat16* src = staged + r * C::LDO + cc;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && co + e < a.cout; ++e) dst[e] = src[e];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime
// (the library is not linked against libcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Persistent CTAs: as many as fit on the card at once (two per SM at BN
// 64), shared by the (Cout block, split) pairs, each walking its share of
// the bricks. A small grid gets a CTA for each brick instead: its few
// waves would leave SMs idle in the last one.
constexpr int kPersistWaves = 8;
template <int BN, bool TMA>
cudaError_t launch_wgmma(const WArgs& a, int ncb, cudaStream_t s) {
  using C = hw::Cfg<BN>;
  static int sms = 0;
  auto kernel = conv3d_wgmma_kernel<BN, TMA>;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  // a CTA for each brick unless the tiles take more than kPersistWaves
  // waves of the card
  const int resident = sms * (C::kTwoPerSm ? 2 : 1);
  int ctas = a.nbricks;
  const long long tiles = (long long)a.nbricks * ncb * a.split;
  if (tiles > (long long)kPersistWaves * resident)
    ctas = max(1, resident / (ncb * a.split));
  const dim3 grid((unsigned)ctas, ncb, a.split);
  kernel<<<grid, hw::kCtaThreads, C::SMEM, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// float32 (FFMA). k_pad is a multiple of 32 and cout_pad of 64; wt is
// (cout_pad, k_pad) with zero padding. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int conv3x3_f32_forward(
    const void* p0, const void* p1, const void* p2, const void* p3, int c0,
    int c1, int c2, int c3, int nparts, const void* wt, const void* bias,
    const void* pro_scale, const void* pro_shift, const void* pro_const,
    float pro_slope, float act_slope, void* out, void* stats, int n, int d,
    int h, int w, int cout, int k_pad, int cout_pad, void* stream) {
  ConvArgs a;
  const void* ps[kMaxParts] = {p0, p1, p2, p3};
  const int cs[kMaxParts] = {c0, c1, c2, c3};
  if (nparts < 1 || nparts > kMaxParts) return (int)cudaErrorInvalidValue;
  bool vec = true;
  int off = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    const bool used = i < nparts;
    a.part[i] = used ? ps[i] : ps[0];
    a.part_c[i] = used ? cs[i] : 0;
    a.part_off[i] = off;
    if (used) {
      vec = vec && cs[i] % 4 == 0 && aligned16(ps[i]);
      off += cs[i];
    }
  }
  a.nparts = nparts;
  a.wt = wt;
  a.bias = static_cast<const float*>(bias);
  a.pro_scale = static_cast<const float*>(pro_scale);
  a.pro_shift = static_cast<const float*>(pro_shift);
  a.pro_const = static_cast<const float*>(pro_const);
  a.pro_slope = pro_slope;
  a.act_slope = act_slope;
  a.out = out;
  a.stats = static_cast<float*>(stats);
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.cin = off;
  a.cout = cout;
  a.k_total = 27 * off;
  a.k_pad = k_pad;
  a.spatial = d * h * w;
  a.m_total = (long long)n * d * h * w;
  if (a.m_total == 0) return (int)cudaSuccess;
  if (k_pad % 32 || k_pad < a.k_total || cout_pad % 64 || cout_pad < cout)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((a.m_total + f32::BM - 1) / f32::BM),
                  cout_pad / f32::BN);
  if (vec)
    conv3d_f32_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    conv3d_f32_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// bfloat16 (wgmma). wt is packed as (cout_pad / bn, nchunk, 27, 2, bn, 8)
// with nchunk = ceil(cin / 16) and zero padding; bn is 64 or 128; the
// chunks are split in `split` runs of `per_split` (split > 1 needs the
// partial workspace and zeroed counters, sized from the grid). tma 1: every
// part's channels are a multiple of 16 and its pointer 16-byte aligned, so
// the halo comes by TMA; 0: the producer warps gather it. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int conv3x3_bf16_forward(
    const void* p0, const void* p1, const void* p2, const void* p3, int c0,
    int c1, int c2, int c3, int nparts, const void* wt, const void* bias,
    const void* pro_scale, const void* pro_shift, const void* pro_const,
    float pro_slope, float act_slope, void* out, void* stats, void* partial,
    void* counter, int n, int d, int h, int w, int cout, int bn, int nchunk,
    int split, int per_split, int tma, void* stream) {
  WArgs a;   // holds four 64-byte-aligned tensor maps
  memset(&a, 0, sizeof(a));
  const void* ps[kMaxParts] = {p0, p1, p2, p3};
  const int cs[kMaxParts] = {c0, c1, c2, c3};
  if (nparts < 1 || nparts > kMaxParts || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  int off = 0;
  for (int i = 0; i < nparts; ++i) {
    a.part[i] = static_cast<const __nv_bfloat16*>(ps[i]);
    a.part_c[i] = cs[i];
    a.part_off[i] = off;
    off += cs[i];
    if (tma && (cs[i] % hw::KC || !aligned16(ps[i])))
      return (int)cudaErrorInvalidValue;
  }
  for (int i = nparts; i < kMaxParts; ++i) a.part_off[i] = off;
  a.nparts = nparts;
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.pro_scale = static_cast<const float*>(pro_scale);
  a.pro_shift = static_cast<const float*>(pro_shift);
  a.pro_const = static_cast<const float*>(pro_const);
  a.pro_slope = pro_slope;
  a.act_slope = act_slope;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.stats = static_cast<float*>(stats);
  a.partial = static_cast<float*>(partial);
  a.counter = static_cast<int*>(counter);
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.cin = off;
  a.cout = cout;
  a.nchunk = nchunk;
  a.split = split;
  a.per_split = per_split;
  a.nzb = (d + hw::BZ - 1) / hw::BZ;
  a.nyb = (h + hw::BY - 1) / hw::BY;
  a.nxb = (w + hw::BX - 1) / hw::BX;
  a.nbricks = n * a.nzb * a.nyb * a.nxb;
  if ((long long)n * d * h * w == 0) return (int)cudaSuccess;
  if (nchunk * hw::KC < off || split < 1 || per_split < 1 ||
      (long long)split * per_split < nchunk ||
      (split > 1 && (partial == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (tma) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
    for (int i = 0; i < nparts; ++i) {
      const cuuint64_t c = (cuuint64_t)cs[i];
      const cuuint64_t dims[5] = {c, (cuuint64_t)w, (cuuint64_t)h,
                                  (cuuint64_t)d, (cuuint64_t)n};
      const cuuint64_t strides[4] = {c * 2, c * 2 * w, c * 2 * w * h,
                                     c * 2 * w * h * d};
      const cuuint32_t box[5] = {8, hw::HX, hw::HY, hw::HZ, 1};
      const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
      const CUresult r = encode(
          &a.map[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
          const_cast<void*>(ps[i]), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    }
  }
  const int ncb = (cout + bn - 1) / bn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bn == 64)
    err = tma ? launch_wgmma<64, true>(a, ncb, s)
              : launch_wgmma<64, false>(a, ncb, s);
  else
    err = tma ? launch_wgmma<128, true>(a, ncb, s)
              : launch_wgmma<128, false>(a, ncb, s);
  return (int)err;
}
