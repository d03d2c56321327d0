// 3x3x3 'same' conv3d over channels-last (NDHWC) tensors as an implicit GEMM
// for Hopper (sm_90a), with a fused input prologue and a fused bias /
// LeakyReLU / instance-norm-statistics epilogue.
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
// GEMM view: M = N*D*H*W output voxels, N = Cout, K = 27*Cin flattened as
// (tap, channel) and zero-padded to the tile depth. The weights arrive as
// (Cout_pad, K_pad) in the compute type T with k contiguous.
//
// What bounds it on an H100: at the DiffUNet shapes the conv does 27*Cin
// multiply-adds (54*Cin operations) per output value and reads each input
// value ~once from HBM (27 taps hit L1/L2), so it is bound by tensor-core
// operations (bf16 needs ~295 operations per byte to be memory-bound; the
// 64-channel levels do ~860). What the design does about it: bf16 tiles go
// through the tensor cores with mma.sync m16n8k16 (f32 accumulate), 128x64
// output tiles per 256-thread block, the next K tile gathered into
// registers while the current one is multiplied (two shared-memory
// buffers, one barrier per K tile). The input prologue is applied in
// registers on the way to shared memory (once per gather, so 27 times per
// input value), and the epilogue reduces the instance-norm statistics from
// the f32 accumulators in shared memory, so neither the normalised
// activation nor a separate statistics pass ever touches HBM. Not yet done:
// wgmma, TMA and a deeper pipeline (the rate this kernel reaches is in
// PERF.md).
//
// float32 runs a true-fp32 FFMA path (64x64 tiles, 4x4 per thread), no TF32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
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

// ---------------------------------------------------------------- bf16 path
namespace bf16 {
constexpr int BM = 128, BN = 64, BK = 32;
constexpr int LDS = BK + 8;   // padded row: conflict-free fragment loads
constexpr int LDC = BN + 4;
constexpr int SMEM_AB = 2 * (BM + BN) * LDS * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
}  // namespace bf16

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3d_bf16_kernel(const ConvArgs a) {
  using namespace bf16;
  using T = __nv_bfloat16;
  __shared__ __align__(16) unsigned char smem[SMEM];
  T* as = reinterpret_cast<T*>(smem);              // [2][BM][LDS]
  T* bs = as + 2 * BM * LDS;                       // [2][BN][LDS]
  float* cs = reinterpret_cast<float*>(smem);      // [BM][LDC] (epilogue)

  const int t = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int lr = t >> 2, lc = t & 3;               // loader row, 8-k chunk
  const Row r0 = decode_row(a, m0 + lr);
  const Row r1 = decode_row(a, m0 + lr + 64);

  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int kt_n = a.k_pad / BK;
  uint4 ra0 = load_a<T, VEC>(a, r0, lc * 8);
  uint4 ra1 = load_a<T, VEC>(a, r1, lc * 8);
  uint4 rb = load_b<T>(a, n0 + lr, lc * 8);
  *reinterpret_cast<uint4*>(as + lr * LDS + lc * 8) = ra0;
  *reinterpret_cast<uint4*>(as + (lr + 64) * LDS + lc * 8) = ra1;
  *reinterpret_cast<uint4*>(bs + lr * LDS + lc * 8) = rb;
  __syncthreads();

  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < kt_n;
    if (more) {
      const int k0 = (kt + 1) * BK + lc * 8;
      ra0 = load_a<T, VEC>(a, r0, k0);
      ra1 = load_a<T, VEC>(a, r1, k0);
      rb = load_b<T>(a, n0 + lr, k0);
    }
    const T* A = as + cur * BM * LDS;
    const T* B = bs + cur * BN * LDS;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* p = A + (wm + i * 16 + g) * LDS + s * 16 + tg * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* p = B + (wn + j * 8 + g) * LDS + s * 16 + tg * 2;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    if (more) {
      T* An = as + (cur ^ 1) * BM * LDS;
      T* Bn = bs + (cur ^ 1) * BN * LDS;
      *reinterpret_cast<uint4*>(An + lr * LDS + lc * 8) = ra0;
      *reinterpret_cast<uint4*>(An + (lr + 64) * LDS + lc * 8) = ra1;
      *reinterpret_cast<uint4*>(Bn + lr * LDS + lc * 8) = rb;
    }
    __syncthreads();
  }

  // accumulators -> shared f32 tile (the A/B buffers are free after the
  // loop's last barrier)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm + i * 16 + g, col = wn + j * 8 + tg * 2;
      cs[row * LDC + col] = epilogue_value(a, acc[i][j][0], n0 + col);
      cs[row * LDC + col + 1] = epilogue_value(a, acc[i][j][1], n0 + col + 1);
      cs[(row + 8) * LDC + col] = epilogue_value(a, acc[i][j][2], n0 + col);
      cs[(row + 8) * LDC + col + 1] =
          epilogue_value(a, acc[i][j][3], n0 + col + 1);
    }
  __syncthreads();
  store_and_stats<T, BM, BN, LDC>(a, cs, m0, n0);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype 0: float32 (FFMA), 1: bfloat16 (tensor cores). k_pad is a multiple
// of 32 and cout_pad of 64; wt is (cout_pad, k_pad) in the compute type with
// zero padding. Returns the cudaError_t of the launch (0 on success).
extern "C" int conv3x3_forward(
    const void* p0, const void* p1, const void* p2, const void* p3, int c0,
    int c1, int c2, int c3, int nparts, const void* wt, const void* bias,
    const void* pro_scale, const void* pro_shift, const void* pro_const,
    float pro_slope, float act_slope, void* out, void* stats, int n, int d,
    int h, int w, int cout, int k_pad, int cout_pad, int dtype,
    void* stream) {
  ConvArgs a;
  const void* ps[kMaxParts] = {p0, p1, p2, p3};
  const int cs[kMaxParts] = {c0, c1, c2, c3};
  if (nparts < 1 || nparts > kMaxParts) return (int)cudaErrorInvalidValue;
  const int elems = dtype == 1 ? 8 : 4;   // values per 16-byte vector
  bool vec = true;
  int off = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    const bool used = i < nparts;
    a.part[i] = used ? ps[i] : ps[0];
    a.part_c[i] = used ? cs[i] : 0;
    a.part_off[i] = off;
    if (used) {
      vec = vec && cs[i] % elems == 0 && aligned16(ps[i]);
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
  if (dtype == 1) {
    const dim3 grid((unsigned)((a.m_total + bf16::BM - 1) / bf16::BM),
                    cout_pad / bf16::BN);
    if (vec)
      conv3d_bf16_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else
      conv3d_bf16_kernel<false><<<grid, kThreads, 0, s>>>(a);
  } else {
    const dim3 grid((unsigned)((a.m_total + f32::BM - 1) / f32::BM),
                    cout_pad / f32::BN);
    if (vec)
      conv3d_f32_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else
      conv3d_f32_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
