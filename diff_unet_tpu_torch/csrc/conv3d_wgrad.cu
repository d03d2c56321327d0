// Weight gradient of the 3x3x3 'same' conv of conv3d.cu, for Hopper
// (sm_90a):
//
//   dW[co, ci, tap] = sum_{n, p} g[n, p, co] * u[n, p + off(tap), ci]
//
// g (N, D, H, W, Cout) is the gradient at the conv's pre-activation
// output, in the compute dtype T; u is the conv's input after the prologue
// lrelu(x * scale + shift) + const, rounded to T, and 0 outside the volume.
// u is never built: the kernel reads the input parts (any channel counts,
// no concat) and applies the prologue on its load, as the forward kernel
// does. Products are summed in float32; dW is float32 (Cout, Cin, 27).
//
// No TPU kernel is replaced: the JAX package leaves the conv's weight
// gradient to jax.value_and_grad through flax nn.Conv. This is the weight
// half of the backward of the conv that replaces ops/pallas_packed_conv.py
// (conv3x3_packed_aug, conv3x3_packed_aug_pipelined),
// ops/pallas_aug_conv.py (conv3x3_aug) and ops/pallas_conv.py (conv3d_same).
//
// What bounds it on an H100: 54 * Cin * Cout operations per voxel against
// (Cin + Cout) values read, ~860 operations per byte at 64 channels in
// bf16: the tensor cores, as for the forward. At the stems (Cin 1 or 16)
// it is bytes. A GEMM with M = Cout, N = (tap, Cin), K = the voxels: its
// operand g^T is the same for every tap and input channel, so it can stay
// in registers, and shared memory then feeds only u. What holds it below
// the tensor cores' rate is shared memory and issue: each u value is read
// by the nine taps, and the prologue (a float32 lrelu-affine on every
// staged value) runs on the threads that issue the wgmmas.
//
// bf16 design (conv3d_wgrad_wgmma_kernel<CIB>), 256 threads:
// - A CTA owns 64 output channels x CIB (64; 16 for the stems) input
//   channels x the nine (y, x) taps of one z tap, and walks its share of
//   the voxel chunks. Its two warpgroups each compute four taps with all
//   CIB channels and half of the middle tap (m64n64k16 x 4 + m64n32k16;
//   the stems n16 + n8): 144 float32 accumulators a thread, which fit the
//   255 registers of a 256-thread CTA. (Nine m64n32 taps a warpgroup ran
//   at half the rate; a third warpgroup or producer warps cap the
//   registers at 168, and ptxas then serializes the wgmmas.)
// - wgmma.mma_async with A = g^T in registers, loaded once a k16 step by
//   ldmatrix.x4.trans and used by all five products; B = u from shared
//   memory through a descriptor with the transpose flag (channel-major),
//   each tap the same tile at another start row. Four k16 steps in flight
//   (A fragments in four buffers); a stage goes back to the ring once its
//   last step has retired.
// - A chunk is `slices` (sample, z) slices x ty rows x tx (8 or 16)
//   columns of output voxels: K = slices * ty * tx, in runs of 8 x, a k16
//   step two runs (the halves of a 16-wide row, or two 8-wide rows). At
//   96^3 and 48^3 it is 8 x 16 voxels of one slice (16 x 16 for the
//   stems); from 24^3 down whole slices (24 x 8; 12 x 16; four 6 x 8
//   slices), so at most 25% of a chunk is padding where a 16 x 8 patch of
//   one slice left 72% empty at 6^3. Only the slices whose z + dz lies in
//   the volume are enumerated.
// - g is staged voxel-major, 64 channels (128 bytes) a voxel, 128-byte
//   swizzled (ldmatrix without bank conflicts). u the same way at CIB 64:
//   each slice a (ty + 2) x (tx + 2) halo tile of 128-byte rows, one TMA
//   box (planes of 8 channels took eight boxes of 16-byte rows, which use
//   half of each 32-byte L2 sector); wgmma reads the swizzled rows from
//   any start row, since the swizzle follows the address bits. The stems'
//   two groups of 8 channels are planes of 16-byte voxel rows.
// - Thread 0 issues the TMA copies (cp.async.bulk.tensor, 5-D maps; start
//   coordinates of -1 give the zero halo, out-of-volume slices read zeros)
//   a ring ahead, into up to 8 stages (mbarriers: full, ready, empty).
//   Every thread prepares its share of the stage S - 2 chunks ahead of its
//   use, between two k16 steps: the prologue in place in float32 rounded
//   to bf16, at in-bounds voxels only (the halo stays 0), with the
//   prologue rows of the CTA's channels staged in shared memory; or a
//   gather of what TMA cannot map (the stems' 1 and 15 channels,
//   misaligned parts), the prologue applied on load.
// - The chunks are split across CTAs as far as filling 132 SMs pays for
//   its workspace (ops/conv3d.py: wgrad_plan). Each CTA stages its tile
//   through shared memory and writes 9 consecutive taps a (co, ci) to
//   its partial dW; a second pass sums the partials in split order. No
//   float atomics: the result is the same from run to run.
//
// float32 (conv3d_wgrad_tf32_kernel): 3xTF32 on the tensor cores. wgmma
// takes tf32 operands only K-major, and here K is the voxels while g and
// u (NDHWC) are channel-major, so it runs mma.sync m16n8k8 tf32 instead,
// each thread loading its own fragments with 32-bit shared-memory loads
// (row strides 8 mod 32 banks: no conflicts) and splitting each value x in
// registers into big = tf32(x) and small = tf32(x - big) (cvt.rna);
// three MMAs a product, A_big B_big + A_big B_small + A_small B_big, hold
// float32 accuracy (about 1e-6 relative, where one TF32 pass errs by
// 2^-11). A CTA owns 64 Cout x 32 Cin x the nine (y, x) taps of one z tap
// (8 warps, each two m16 tiles of Cout by one n8 tile of Cin at each tap:
// 72 float32 sums a thread). K comes in chunks through two cp.async
// stages: whole (sample, z) slices, as many as fit about 128 voxels, where
// a slice has at most 160 voxels (8^3: two, 4^3: eight, so a chunk is not
// mostly padding), else 16 x 8 (y, x) voxels of one slice; only the slices
// whose z + dz lies in the volume are enumerated, and each thread reads a
// voxel's u row through a table of the chunk's geometry, so no K step
// runs on padding but the last. The prologue is applied on load. What
// bounds it: three m16n8k8 MMAs and about 5 split instructions a loaded
// value, on 8 warps an SM; mma.sync does not reach wgmma's rate.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxParts = 4;

// The part that holds concat channel ci (constant-index parameter reads).
template <typename A>
__device__ __forceinline__ int part_index(const A& a, int ci) {
  int pi = 0;
#pragma unroll
  for (int i = 1; i < kMaxParts; ++i)
    if (i < a.nparts && ci >= a.part_off[i]) pi = i;
  return pi;
}

__device__ __forceinline__ float prologue_f(float x, float sc, float sh,
                                            float cs, float slope) {
  float u = x * sc + sh;
  u = u >= 0.f ? u : u * slope;
  return u + cs;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// --------------------------------------------------------------- bf16 path
namespace wg {
constexpr int kThreads = 256;               // two warpgroups
constexpr int kSteps = 4;                   // k16 steps in flight
constexpr int CO = 64;                      // output channels of a CTA
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 200 * 1024;
// the prologue's scale, shift and const rows of the CTA's channels, every
// sample: 3 x n x 64 float32 where they fit
constexpr int kTabBytes = 16 * 1024;
constexpr int kTabOffset = kRingBytes;
constexpr int kBarOffset = kRingBytes + kTabBytes;
constexpr int kSmem = 1024 + kBarOffset + 3 * kMaxStages * 8;
// the epilogue stages a CTA tile (64 x 64 x 9 float32) in the ring
static_assert(CO * (64 * 9 + 1) * 4 <= kRingBytes, "staged tile");
}  // namespace wg

struct GArgs {
  CUtensorMap gmap;                // g: box {64, tx, ty, 1, 1}, swizzled
  CUtensorMap umap[kMaxParts];     // parts: box {64, tx + 2, ty + 2, 1, 1}
                                   // swizzled (Cin tile 64), or {8, ...}
  const __nv_bfloat16* g;          // (n, d, h, w, cout)
  const __nv_bfloat16* part[kMaxParts];
  int part_c[kMaxParts];
  int part_off[kMaxParts];
  int part_tma[kMaxParts];         // channels and offset multiples of 8,
                                   // pointer aligned: TMA can map it
  int nparts;
  int g_tma;                       // cout a multiple of 8, g aligned
  const float* pro_scale;          // (n, cin) or null: no prologue
  const float* pro_shift;
  const float* pro_const;          // or null
  float pro_slope;
  float* out;                      // (split, cout, cin, 27)
  long long out_size;
  int n, d, h, w, cin, cout;
  // a chunk: `slices` (sample, z) slices x ty rows x tx columns
  int tx, ty, slices;
  int ux, uvs, usl;                // u halo row, slice tile, its stride
  int nyt, nxt, per_split, ncib;
  int stages, stage_bytes, g_bytes;
  int plane_bytes;                 // 8 channels of every u voxel of a stage
  uint32_t b_lbo, b_sbo;           // B descriptor strides, 16-byte units
  uint32_t ux_mul, uvs_mul;        // v / ux = umulhi(v, ux_mul), ...
  uint32_t nz_mul[2];              // i / (d - k) = umulhi(i, nz_mul[k])
  int tab;                         // the prologue rows staged in shared memory
};

__device__ __forceinline__ uint32_t mbar_at(uint32_t base, int kind,
                                            int s) {
  return base + 8 * (kind * wg::kMaxStages + s);
}
enum { kFull = 0, kReady = 1, kEmpty = 2 };

// The chunks of z tap dz enumerate the slices whose z + dz lies in the
// volume: valid slice i is sample i / (d - |dz|), z = i % (d - |dz|) plus 1
// when dz < 0.
struct GChunk {
  int y0, x0, slice0, nz;
};

template <class A>
__device__ __forceinline__ int nchunks(const A& a, int dz) {
  const int nz = a.d - (dz != 0);
  const int groups = (a.n * nz + a.slices - 1) / a.slices;
  return groups * a.nyt * a.nxt;
}

template <class A>
__device__ __forceinline__ GChunk gchunk_at(const A& a, int q, int dz) {
  GChunk c;
  c.x0 = (q % a.nxt) * a.tx;
  q /= a.nxt;
  c.y0 = (q % a.nyt) * a.ty;
  c.slice0 = (q / a.nyt) * a.slices;
  c.nz = a.d - (dz != 0);
  return c;
}

// sample and z of slice s of the chunk; n == a.n past the last slice (TMA
// then reads zeros)
template <class A>
__device__ __forceinline__ void slice_nz(const A& a, const GChunk& c, int s,
                                         int dz, int& n, int& z) {
  const int i = c.slice0 + s;
  // a z tap of a 2-deep volume (or the middle one of a 1-deep volume) has
  // one valid z a sample: 1 has no 32-bit reciprocal (magic(1) wraps to 0)
  n = c.nz == 1 ? i : (int)__umulhi(i, a.nz_mul[dz != 0]);
  z = i - n * c.nz + (dz < 0 ? 1 : 0);
  if (n >= a.n) n = a.n;
}

// d += A * B, m64nNk16: A (64 x 16) from registers, B (16 x N) from
// shared memory, channel-major (the transpose flag), through the
// descriptor {dlo, dhi}: its high word (strides, layout) is the same for
// every tap and step, so only the low word is formed per call
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint32_t dlo, uint32_t dhi);
template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t (&a)[4],
                                             uint32_t dlo, uint32_t dhi) {
  asm volatile(
      "{\n.reg .b64 db;\n.reg .pred p;\nmov.b64 db, {%8, %9};\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(dlo), "r"(dhi),
        "n"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t (&a)[4],
                                             uint32_t dlo, uint32_t dhi) {
  asm volatile(
      "{\n.reg .b64 db;\n.reg .pred p;\nmov.b64 db, {%12, %13};\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(dlo), "r"(dhi),
        "n"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t (&a)[4],
                                             uint32_t dlo, uint32_t dhi) {
  asm volatile(
      "{\n.reg .b64 db;\n.reg .pred p;\nmov.b64 db, {%20, %21};\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(dlo), "r"(dhi),
        "n"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4],
                                             uint32_t dlo, uint32_t dhi) {
  asm volatile(
      "{\n.reg .b64 db;\n.reg .pred p;\nmov.b64 db, {%36, %37};\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(dlo), "r"(dhi),
        "n"(1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void reg_fence_u(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

union Bf8 {
  uint4 u;
  __nv_bfloat16 e[8];
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The prologue on 8 bf16 values (a 16-byte piece), in float32, rounded to
// bf16 as the plain version rounds.
struct Pro8 {
  float sc[8], sf[8], cs[8];

  __device__ uint4 apply(uint4 v, float slope) const {
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = prologue_f(__uint_as_float(w[i] << 16), sc[2 * i],
                                  sf[2 * i], cs[2 * i], slope);
      const float hi =
          prologue_f(__uint_as_float(w[i] & 0xffff0000u), sc[2 * i + 1],
                     sf[2 * i + 1], cs[2 * i + 1], slope);
      const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The prologue rows of sample n, group grp (8 channels), from the
// shared-memory table [scale, shift, const][n][CIB].
template <int CIB>
__device__ __forceinline__ void load_pro8(const GArgs& a, uint32_t tab, int n,
                                          int grp, Pro8& pro) {
  const int rows = a.n * CIB;
  const uint32_t b = tab + (n * CIB + 8 * grp) * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 v0 = lds128(b + 16 * h);
    const uint4 v1 = lds128(b + rows * 4 + 16 * h);
    const uint4 v2 = lds128(b + rows * 8 + 16 * h);
    const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
    const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
    const uint32_t w2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pro.sc[4 * h + e] = __uint_as_float(w0[e]);
      pro.sf[4 * h + e] = __uint_as_float(w1[e]);
      pro.cs[4 * h + e] = __uint_as_float(w2[e]);
    }
  }
}

// 8 channels ci.. of voxel vox, gathered from the parts (0 beyond cin).
__device__ __forceinline__ uint4 gather8(const GArgs& a, long long vox,
                                         int ci) {
  Bf8 v;
  v.u = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ch = ci + e;
    if (ch >= a.cin) break;
    const int pi = part_index(a, ch);
    v.e[e] = a.part[pi][vox * a.part_c[pi] + (ch - a.part_off[pi])];
  }
  return v.u;
}

// The 8 channels of a thread's group: each one's part (null beyond cin)
// and its row stride, found once a kernel.
struct Chans8 {
  const __nv_bfloat16* ptr[8];
  int stride[8];
};

// A thread's share of preparing a stage: the 16-byte pieces (voxel, its 8
// channels) t / NPL, + 256 / NPL, ... of each slice's halo tile, in the
// 8-channel group t % NPL. A group TMA cannot map is gathered, with the
// prologue applied on load; a copied group gets the prologue in place, at
// in-bounds voxels only (the halo stays 0). SW: u's voxel rows hold all 64
// channels (128 bytes, swizzled); else each group is a plane of 16-byte
// voxel rows. Two pieces at a time, so their loads overlap.

template <int NPL, bool SW, int CIB>
__device__ __forceinline__ void prepare(const GArgs& a, unsigned char* stage,
                                        uint32_t tab, const GChunk& c, int dz,
                                        int ci0, int cob, bool gather,
                                        bool in_place, const Chans8& chans) {
  constexpr int VS = wg::kThreads / NPL;
  const int t = threadIdx.x;
  if (!a.g_tma) {
    // g gathered: 16-byte pieces (voxel, 8 channels), swizzled as TMA
    // would place them
    const int cc = t & 7, co = cob * wg::CO + 8 * cc;
    const int per = a.ty * a.tx, kvox = a.slices * per;
    for (int kv = t >> 3; kv < kvox; kv += wg::kThreads / 8) {
      const int s = kv / per, lk = kv - s * per;
      const int y = c.y0 + lk / a.tx, x = c.x0 + lk % a.tx;
      int n, z;
      slice_nz(a, c, s, dz, n, z);
      Bf8 v;
      v.u = make_uint4(0, 0, 0, 0);
      if (n < a.n && y < a.h && x < a.w) {
        const __nv_bfloat16* src =
            a.g + ((((long long)n * a.d + z) * a.h + y) * a.w + x) * a.cout;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (co + e < a.cout) v.e[e] = src[co + e];
      }
      *reinterpret_cast<uint4*>(stage + kv * 128 + ((cc ^ (kv & 7)) << 4)) =
          v.u;
    }
  }
  if (!gather && !in_place) return;
  const int grp = t % NPL, ci = ci0 + 8 * grp;
  const uint32_t u = smem_u32(stage + a.g_bytes) +
                     (SW ? 0 : grp * a.plane_bytes);
  Pro8 pro;
  int pro_n = -1;
  for (int s = 0; s < a.slices; ++s) {
    int n, z;
    slice_nz(a, c, s, dz, n, z);
    const bool nz_in = n < a.n;
    if (a.pro_scale && nz_in && pro_n != n) {
      pro_n = n;
      if (a.tab) {
        load_pro8<CIB>(a, tab, n, grp, pro);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool real = ci + e < a.cin;
          const int kk = n * a.cin + ci + e;
          pro.sc[e] = real ? a.pro_scale[kk] : 0.f;
          pro.sf[e] = real ? a.pro_shift[kk] : 0.f;
          pro.cs[e] = real && a.pro_const ? a.pro_const[kk] : 0.f;
        }
      }
    }
    const long long zrow = ((long long)n * a.d + z + dz) * a.h;
    const uint32_t srow = s * a.usl;
    for (int lv = t / NPL; lv < a.uvs; lv += 2 * VS) {
      int lvs[2] = {lv, lv + VS};
      bool in[2], live[2];
      uint32_t addr[2];
      long long vox[2];
      uint4 val[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int l = lvs[q];
        const int r = __umulhi(l, a.ux_mul), k = l - r * a.ux;
        const int y = c.y0 - 1 + r, x = c.x0 - 1 + k;
        live[q] = l < a.uvs;
        in[q] = live[q] && nz_in && (unsigned)y < (unsigned)a.h &&
                (unsigned)x < (unsigned)a.w;
        const uint32_t row = srow + l;       // slice tiles 1024-byte aligned
        addr[q] = SW ? u + row * 128 + ((grp ^ (l & 7)) << 4) : u + row * 16;
        vox[q] = (zrow + y) * a.w + x;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        val[q] = make_uint4(0, 0, 0, 0);
        if (in[q] && gather && !SW) {
          // planes (the stems): a piece's 8 loads issue together
          Bf8 v;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v.e[e] = chans.ptr[e] ? chans.ptr[e][vox[q] * chans.stride[e]]
                                  : __float2bfloat16(0.f);
          val[q] = v.u;
        } else if (in[q]) {
          val[q] = gather ? gather8(a, vox[q], ci) : lds128(addr[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (in[q] && a.pro_scale) val[q] = pro.apply(val[q], a.pro_slope);
        if (in[q] || (gather && live[q])) sts128(addr[q], val[q]);
      }
    }
  }
}

// blockIdx.x: the tile (Cout block, Cin block, z tap), the tap fastest, so
// the tiles of one split run together and share its chunks in L2;
// blockIdx.y: the split of the chunks. Every thread computes; thread 0
// also issues the TMA copies, a ring ahead, and every thread prepares its
// share of the next chunk (prepare) while the tensor cores work through
// the k16 steps already issued.
template <int CIB>
__global__ void __launch_bounds__(wg::kThreads, 1)
conv3d_wgrad_wgmma_kernel(const __grid_constant__ GArgs a) {
  constexpr int NPL = CIB / 8;           // 8-channel groups of the CTA
  constexpr int NACC = CIB / 2;          // accumulators of a tap
  constexpr int NB = wg::kSteps;
  constexpr bool SW = CIB == 64;         // u rows of 64 channels, swizzled
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(smem + wg::kBarOffset);
  const int t = threadIdx.x;
  int bx = blockIdx.x;
  const int dz = bx % 3 - 1;
  bx /= 3;
  const int cib = bx % a.ncib, cob = bx / a.ncib;
  const int ci0 = cib * CIB;
  const int q0 = blockIdx.y * a.per_split;
  const int nq = min(nchunks(a, dz), q0 + a.per_split) - q0;
  const int S = a.stages;
  // 8-channel groups by TMA, gathered, or zero. SW: the CTA's 64
  // channels come in one box a slice when one part holds them (channels
  // past the part read 0, so it must be the last part or hold them all);
  // else all 8 groups are gathered (zeros beyond cin). Planes: each group
  // from the part that holds it whole; groups beyond cin are zeroed once.
  uint32_t tma_mask = 0, gather_mask = 0;
  const int bpart = part_index(a, ci0);
  const bool box = SW && a.part_tma[bpart] &&
                   (ci0 + CIB <= a.part_off[bpart] + a.part_c[bpart] ||
                    bpart == a.nparts - 1);
#pragma unroll
  for (int p = 0; p < NPL; ++p) {
    const int c = ci0 + 8 * p;
    if (SW) {
      if (box && c < a.cin)
        tma_mask |= 1u << p;
      else if (!box)
        gather_mask |= 1u << p;
    } else if (c < a.cin) {
      if (a.part_tma[part_index(a, c)])
        tma_mask |= 1u << p;
      else
        gather_mask |= 1u << p;
    }
  }
  const uint32_t tma_bytes =
      (a.g_tma ? a.slices * a.ty * a.tx * 128 : 0) +
      (SW ? (box ? 8 : 0) : __popc(tma_mask)) * a.slices * a.uvs * 16;
  const bool pro_tma = a.pro_scale && tma_mask;
  const bool gather = (gather_mask >> (t % NPL)) & 1;
  const bool in_place = pro_tma && ((tma_mask >> (t % NPL)) & 1);
  // whether the threads prepare every stage (else TMA fills it alone)
  const bool prep = gather_mask || !a.g_tma || pro_tma;
  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(mbar_at(bars, kFull, s), 1);
      mbar_init(mbar_at(bars, kReady, s), wg::kThreads);
      mbar_init(mbar_at(bars, kEmpty, s), wg::kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int s = 0; s < S && !SW; ++s)
    for (int p = 0; p < NPL; ++p) {
      if (ci0 + 8 * p < a.cin) continue;
      uint4* dst = reinterpret_cast<uint4*>(smem + s * a.stage_bytes +
                                            a.g_bytes + p * a.plane_bytes);
      for (int v = t; v < a.slices * a.usl; v += wg::kThreads)
        dst[v] = make_uint4(0, 0, 0, 0);
    }
  // the prologue rows of the CTA's channels: [scale, shift, const][n][CIB]
  const uint32_t tab = smem_u32(smem + wg::kTabOffset);
  if (a.tab) {
    float* tp = reinterpret_cast<float*>(smem + wg::kTabOffset);
    const int rows = a.n * CIB;
    for (int i = t; i < 3 * rows; i += wg::kThreads) {
      const int which = i / rows, r = i - which * rows;
      const int n = r / CIB, ch = ci0 + r % CIB;
      const float* src = which == 0   ? a.pro_scale
                         : which == 1 ? a.pro_shift
                                      : a.pro_const;
      tp[i] = ch < a.cin && src ? src[n * a.cin + ch] : 0.f;
    }
  }
  fence_async_smem();
  __syncthreads();

  // chunk it into stage it % S, once chunk it - S has been handed back
  auto issue = [&](int it) {
    const int st = it % S;
    unsigned char* stage = smem + st * a.stage_bytes;
    unsigned char* us = stage + a.g_bytes;
    const GChunk c = gchunk_at(a, q0 + it, dz);
    const uint32_t full = mbar_at(bars, kFull, st);
    mbar_wait(mbar_at(bars, kEmpty, st), ((it / S) & 1) ^ 1);
    mbar_expect_tx(full, tma_bytes);
    for (int s = 0; s < a.slices; ++s) {
      int n, z;
      slice_nz(a, c, s, dz, n, z);
      if (a.g_tma)
        tma_load_5d(smem_u32(stage + s * a.ty * a.tx * 128), &a.gmap, full,
                    cob * wg::CO, c.x0, c.y0, z, n);
      if (SW && box)
        tma_load_5d(smem_u32(us + s * a.usl * 128), &a.umap[bpart], full,
                    ci0 - a.part_off[bpart], c.x0 - 1, c.y0 - 1, z + dz, n);
      for (int p = 0; p < NPL && !SW; ++p) {
        if (!((tma_mask >> p) & 1)) continue;
        const int pi = part_index(a, ci0 + 8 * p);
        tma_load_5d(smem_u32(us + p * a.plane_bytes + s * a.usl * 16),
                    &a.umap[pi], full, ci0 + 8 * p - a.part_off[pi],
                    c.x0 - 1, c.y0 - 1, z + dz, n);
      }
    }
  };
  // this thread's share of chunk it, then its arrival on ready
  Chans8 chans;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ch = ci0 + 8 * (t % NPL) + e, pi = part_index(a, ch);
    chans.ptr[e] = !SW && ch < a.cin ? a.part[pi] + (ch - a.part_off[pi])
                                      : nullptr;
    chans.stride[e] = a.part_c[pi];
  }
  auto prepare_chunk = [&](int it) {
    const int st = it % S;
    const uint32_t par = (it / S) & 1;
    // the copies landed (so chunk it - S was handed back), or it was
    if (pro_tma)
      mbar_wait(mbar_at(bars, kFull, st), par);
    else
      mbar_wait(mbar_at(bars, kEmpty, st), par ^ 1);
    prepare<NPL, SW, CIB>(a, smem + st * a.stage_bytes, tab,
                          gchunk_at(a, q0 + it, dz), dz, ci0, cob, gather,
                          in_place, chans);
    fence_async_smem();
    mbar_arrive(mbar_at(bars, kReady, st));
    __syncwarp();   // converged again for the warp-wide wgmma and ldmatrix
  };
  if (t == 0 && tma_bytes)
    for (int it = 0; it < min(S - 1, nq); ++it) issue(it);
  // a stage is prepared S - 2 chunks ahead of its use: the copies have
  // landed by then, and gathered loads' latency hides behind the chunks
  // between
  const int ahead = S - 2;
  if (prep)
    for (int it = 0; it < min(ahead, nq); ++it) prepare_chunk(it);

  // warpgroup wgi: the four taps 5 wgi .. 5 wgi + 3 of the nine (dy, dx)
  // with all CIB input channels, and half of the middle tap (4): channels
  // wgi * CIB / 2 ..
  constexpr int HN = CIB / 2;
  const int wgi = t >> 7, wq = (t >> 5) & 3, lane = t & 31;
  float acc[4][NACC], acch[HN / 2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[k][i] = 0.f;
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) acch[i] = 0.f;
  // The taps' start rows in a halo tile are (0, 1, 2, ux) for taps 0-3,
  // (ux + 2, 2 ux, 2 ux + 1, 2 ux + 2) for taps 5-8 and ux + 1 for the half
  // tap, whose channels start 64 bytes into a swizzled row, or at the
  // second plane
  const uint32_t hoff = SW ? wgi * 4 : wgi * (a.plane_bytes >> 4);
  // A = g^T: the lane's ldmatrix row (voxel 8 (mi >> 1) + r of the k16
  // step) and 16-byte column (8 output channels), swizzled
  const int mi = lane >> 3, r8 = lane & 7;
  const uint32_t a_lane =
      (8 * (mi >> 1) + r8) * 128 + (((2 * wq + (mi & 1)) ^ r8) << 4);
  const int rps = 16 / a.tx;               // rows of a k16 step
  const int sps = a.ty / rps;              // k16 steps of a slice
  const int steps = a.slices * sps;        // a multiple of NB
  const int ux = a.ux;
  uint32_t af[NB][4];
  int prev = -1;                           // stage still to hand back
  for (int it = 0; it < nq; ++it) {
    const int st = it % S;
    const uint32_t par = (it / S) & 1;
    if (tma_bytes) mbar_wait(mbar_at(bars, kFull, st), par);
    if (prep) mbar_wait(mbar_at(bars, kReady, st), par);
    __syncwarp();
    const uint32_t gbase = smem_u32(smem + st * a.stage_bytes) + a_lane;
    // B: SW, the 64 channels of each voxel row (128-byte swizzle, layout
    // type 1 in bits 62-63); else the 2 planes of 8 channels
    const uint64_t desc0 =
        smem_desc(smem_u32(smem + st * a.stage_bytes + a.g_bytes),
                  a.b_lbo << 4, a.b_sbo << 4) |
        (SW ? 1ull << 62 : 0ull);
    const uint32_t dlo0 = (uint32_t)desc0, dhi = (uint32_t)(desc0 >> 32);
    constexpr int VU = SW ? 8 : 1;         // 16-byte units of a voxel row
    for (int j = 0; j < steps; j += NB) {
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        const int jj = j + h;
        // the step NB back has retired: its A registers are free, and
        // after the first NB steps of a chunk so is the last chunk
        wgmma_wait<NB - 1>();
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence_u(af[h][e]);
        if (h == NB - 1 && j == 0) {
          if (prev >= 0 && lane == 0)
            mbar_arrive(mbar_at(bars, kEmpty, prev));
          prev = -1;
          // while the tensor cores work through the steps issued: the
          // copies of chunk it + S - 1 and this thread's share of the
          // preparation of chunk it + S - 2
          if (t == 0 && tma_bytes && it + S - 1 < nq) issue(it + S - 1);
          __syncwarp();
          if (prep && it + ahead < nq) prepare_chunk(it + ahead);
        }
        ldsm_x4_trans(af[h], gbase + jj * 2048);
        const int s = jj / sps;
        const int voff = s * a.usl + (jj - s * sps) * rps * ux;
        wgmma_fence();
        const uint32_t dlo = dlo0 + voff * VU;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int trow = wgi ? (k == 0 ? ux + 2 : 2 * ux + k - 1)
                               : (k == 3 ? ux : k);
          wgmma_rs<CIB>(acc[k], af[h], dlo + trow * VU, dhi);
        }
        wgmma_rs<HN>(acch, af[h], dlo + (ux + 1) * VU + hoff, dhi);
        wgmma_commit();
      }
    }
    prev = st;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < NACC; ++i) reg_fence(acc[k][i]);
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) reg_fence(acch[i]);
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence_u(af[h][e]);

  // ---- epilogue: the tile through shared memory (the ring is drained),
  // then 9 consecutive taps of each (co, ci) to this split's partial dW;
  // every (co, ci, tap) of the tile is written, zeros where nothing added
  constexpr int RS = CIB * 9 + 1;          // a staged Cout row, floats
  float* staged = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int row = 16 * wq + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      staged[row * RS + col * 9 + 5 * wgi + k] = acc[k][i];
    }
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) {
    const int row = 16 * wq + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = wgi * HN + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    staged[row * RS + col * 9 + 4] = acch[i];
  }
  __syncthreads();
  float* out = a.out + (long long)blockIdx.y * a.out_size;
  const int tap0 = (dz + 1) * 9;
  for (int idx = t; idx < wg::CO * CIB * 9; idx += wg::kThreads) {
    const int row = idx / (CIB * 9), rem = idx - row * (CIB * 9);
    const int co = cob * wg::CO + row, ci = ci0 + rem / 9;
    if (co < a.cout && ci < a.cin)
      out[((long long)co * a.cin + ci) * 27 + tap0 + rem % 9] =
          staged[row * RS + rem];
  }
}

// ------------------------------------------------------------ float32 path
// The prologue as the plain version and the forward kernel round it: the
// product and each sum rounded on their own (no FMA contraction).
__device__ __forceinline__ float prologue_rn(float x, float sc, float sh,
                                             float cs, float slope) {
  float u = __fadd_rn(__fmul_rn(x, sc), sh);
  u = u >= 0.f ? u : __fmul_rn(u, slope);
  return __fadd_rn(u, cs);
}

namespace tf {
constexpr int kThreads = 256;      // 8 warps: 2 along Cout x 4 along Cin
constexpr int CO = 64, CI = 32;    // a CTA tile's output and input channels
// row strides in floats, 8 mod 32: a fragment's 32 loads (4 rows x 8
// channels) hit 32 banks
constexpr int LDG = CO + 8;
constexpr int LDU = CI + 8;
constexpr int GP = CO / 4;         // 16-byte pieces of a g row
constexpr int UP = CI / 4;         // of a u row
constexpr int STAGES = 2;
constexpr int kMaxSmem = 227 * 1024;
}  // namespace tf

struct TArgs {
  const float* g;                  // (n, d, h, w, cout)
  const float* part[kMaxParts];    // NDHWC, part_c[i] channels each
  int part_c[kMaxParts];
  int part_off[kMaxParts];         // first concat channel of each part
  int part_vec[kMaxParts];         // 16-byte loads: channels and offset a
                                   // multiple of 4, pointer aligned
  int nparts;
  int g_vec;                       // cout a multiple of 4, g aligned
  const float* pro_scale;          // (n, cin) or null: no prologue
  const float* pro_shift;          // (n, cin)
  const float* pro_const;          // (n, cin) or null
  float pro_slope;                 // 1: no prologue activation
  float* out;                      // (split, cout, cin, 27)
  long long out_size;              // cout * cin * 27
  int n, d, h, w, cin, cout;
  // a chunk: `slices` (sample, z) slices x ty rows x tx columns, kv voxels
  // (K), k8 of them padded to the k8 step with zero rows of g
  int tx, ty, slices, kv, k8;
  int ux, uvs;                     // u's halo row and slice tile (voxels)
  int nyt, nxt, per_split, ncib;
  int stage_floats;                // a stage: g (k8 x LDG), u tiles
  int ring_floats;                 // the stages, or the staged tile
  uint32_t nz_mul[2];              // i / (d - k) = umulhi(i, nz_mul[k])
};

// A thread's fixed share of every chunk's copies: the 16-byte pieces of g
// rows t / GP, + kThreads / GP, ... (output channels co ..) and of u
// voxels t / UP, ... (input channels ci ..). It keeps the prologue rows of
// its channels for the sample pro_n.
struct TShare {
  int co, ci;
  const float* part;               // the part that holds ci (null: beyond)
  int pc, lc, vec;                 // its channels, ci's in it, cp.async
  int pro_n;
  float sc[4], sf[4], cs[4];

  __device__ TShare(const TArgs& a, int cob, int cib) {
    using namespace tf;
    const int t = threadIdx.x;
    co = cob * CO + (t % GP) * 4;
    ci = cib * CI + (t % UP) * 4;
    part = nullptr;
    pc = lc = vec = 0;
    if (ci < a.cin) {
      const int pi = part_index(a, ci);
      part = a.part[pi];
      pc = a.part_c[pi];
      lc = ci - a.part_off[pi];
      vec = a.part_vec[pi];
    }
    pro_n = -1;
  }

  __device__ void load_prologue(const TArgs& a, int n) {
    if (pro_n == n) return;
    pro_n = n;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool real = ci + e < a.cin;
      const int k = n * a.cin + ci + e;
      sc[e] = real ? a.pro_scale[k] : 0.f;
      sf[e] = real ? a.pro_shift[k] : 0.f;
      cs[e] = real && a.pro_const ? a.pro_const[k] : 0.f;
    }
  }
};

// u voxel l of a chunk's tiles: its slice, and whether it lies in the
// volume (vox: its flat index there).
__device__ __forceinline__ bool u_voxel(const TArgs& a, const GChunk& c,
                                        int l, int dz, int& n,
                                        long long& vox) {
  const int s = l / a.uvs, r = l - s * a.uvs;
  const int hy = r / a.ux;
  const int y = c.y0 - 1 + hy, x = c.x0 - 1 + (r - hy * a.ux);
  int z;
  slice_nz(a, c, s, dz, n, z);
  vox = (((long long)n * a.d + z + dz) * a.h + y) * a.w + x;
  return n < a.n && (unsigned)y < (unsigned)a.h &&
         (unsigned)x < (unsigned)a.w;
}

// Starts the copies of this thread's pieces of a chunk into a stage: 16
// bytes by cp.async where they are whole and aligned, zeros (st.shared)
// outside the volume, past the chunk's voxels and beyond the channels,
// and a gather (its prologue applied at once) where a part's channels do
// not allow 16-byte loads.
__device__ __forceinline__ void fetch_tf32(const TArgs& a, TShare& sh,
                                           const GChunk& c, int dz,
                                           float* gs, float* us) {
  using namespace tf;
  const int t = threadIdx.x, per = a.ty * a.tx;
  for (int k = t / GP; k < a.k8; k += kThreads / GP) {
    float* dst = gs + k * LDG + (t % GP) * 4;
    const float* src = nullptr;
    if (k < a.kv && sh.co < a.cout) {
      const int s = k / per, r = k - s * per;
      const int y = c.y0 + r / a.tx, x = c.x0 + r % a.tx;
      int n, z;
      slice_nz(a, c, s, dz, n, z);
      if (n < a.n && y < a.h && x < a.w)
        src = a.g + ((((long long)n * a.d + z) * a.h + y) * a.w + x) *
                        a.cout + sh.co;
    }
    if (src != nullptr && a.g_vec) {
      cp_async16(dst, src);
      continue;
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float* e4 = reinterpret_cast<float*>(&v);
    if (src != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (sh.co + e < a.cout) e4[e] = src[e];
    }
    *reinterpret_cast<float4*>(dst) = v;
  }
  for (int l = t / UP; l < a.slices * a.uvs; l += kThreads / UP) {
    float* dst = us + l * LDU + (t % UP) * 4;
    int n;
    long long vox;
    const bool in = sh.part != nullptr && u_voxel(a, c, l, dz, n, vox);
    if (in && sh.vec) {
      cp_async16(dst, sh.part + vox * sh.pc + sh.lc);
      continue;
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float* e4 = reinterpret_cast<float*>(&v);
    if (in) {
      if (a.pro_scale) sh.load_prologue(a, n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = sh.ci + e;
        if (ci >= a.cin) break;
        const int pi = part_index(a, ci);
        float val = a.part[pi][vox * a.part_c[pi] + (ci - a.part_off[pi])];
        if (a.pro_scale)
          val = prologue_rn(val, sh.sc[e], sh.sf[e], sh.cs[e], a.pro_slope);
        e4[e] = val;
      }
    }
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// The prologue on the u pieces this thread copied by cp.async, once they
// have arrived; the halo stays 0.
__device__ __forceinline__ void prologue_tf32(const TArgs& a, TShare& sh,
                                              const GChunk& c, int dz,
                                              float* us) {
  using namespace tf;
  if (sh.part == nullptr || !sh.vec) return;
  for (int l = threadIdx.x / UP; l < a.slices * a.uvs;
       l += kThreads / UP) {
    int n;
    long long vox;
    if (!u_voxel(a, c, l, dz, n, vox)) continue;
    sh.load_prologue(a, n);
    float4* p = reinterpret_cast<float4*>(us + l * LDU +
                                          (threadIdx.x % UP) * 4);
    float4 v = *p;
    float* e4 = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      e4[e] = prologue_rn(e4[e], sh.sc[e], sh.sf[e], sh.cs[e], a.pro_slope);
    *p = v;
  }
}

// x as tf32 big and small: big = tf32(x), small = tf32(x - big), each
// rounded to nearest, ties away (cvt.rna.tf32.f32); big's low 13 bits
// are cleared so that x - big is the remainder the tensor cores miss
// (they read neither operand's low 13 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  uint32_t b, r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(b) : "f"(x));
  b &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x - __uint_as_float(b)));
  big = b;
  small = r;
}

// d += A * B, m16n8k8 with tf32 operands, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One chunk on the tensor cores, 3xTF32: warp (wm, wn) adds A = g^T (its
// 32 output channels, two m16 tiles) times B = u (8 input channels at each
// of the nine (y, x) taps, one n8 tile a tap) over the chunk's k8 steps,
// every product A_big B_big + A_big B_small + A_small B_big. Each thread
// loads its own fragments (32-bit loads) and splits them in registers; u
// at tap (dy, dx) of voxel k is row tab[k] + dy ux + dx of the stage.
// Each k8 step's three MMAs make a sum of their own (the small products
// first), added to acc in float32 (round to nearest): the tensor cores
// align a sum to its largest term and drop the bits below, always toward
// zero, so a running sum kept in them drifts with its MMAs (a split's
// ~10^4 moved HybridMIM's L0 conv_1 dW by 1.8e-4 of its largest on an
// H100; 1.5e-6 with these sums).
__device__ __forceinline__ void mma_chunk_tf32(const TArgs& a,
                                               const float* gs,
                                               const float* us,
                                               const int* tab,
                                               float (&acc)[2][9][4]) {
  using namespace tf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane & 3, gc = lane >> 2;
  const float* ga = gs + gr * LDG + 32 * (warp & 1) + gc;
  const float* ub = us + 8 * (warp >> 1) + gc;
  const int ux = a.ux;
#pragma unroll 1
  for (int k0 = 0; k0 < a.k8; k0 += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* gk = ga + k0 * LDG + 16 * mi;
      const float f[4] = {gk[0], gk[8], gk[4 * LDG], gk[4 * LDG + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(f[e], ab[mi][e], as[mi][e]);
    }
    const int r0 = tab[k0 + gr], r1 = tab[k0 + gr + 4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * ux + tap % 3;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(ub[(r0 + off) * LDU], bb0, bs0);
      split_tf32(ub[(r1 + off) * LDU], bb1, bs1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, as[mi], bb0, bb1);
        mma_tf32(d, ab[mi], bs0, bs1);
        mma_tf32(d, ab[mi], bb0, bb1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][tap][e] += d[e];
      }
    }
  }
}

// blockIdx.x: the tile (Cout block, Cin block, z tap), the tap fastest, so
// the tiles of one split run together and share its chunks in L2;
// blockIdx.y: the split of the chunks, enumerated densely (gchunk_at). The
// chunks flow through two cp.async stages, one in flight while the other
// is multiplied.
__global__ void __launch_bounds__(tf::kThreads, 1)
conv3d_wgrad_tf32_kernel(const __grid_constant__ TArgs a) {
  using namespace tf;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  int* tab = reinterpret_cast<int*>(smem + a.ring_floats);
  const int t = threadIdx.x;
  int bx = blockIdx.x;
  const int dz = bx % 3 - 1;
  bx /= 3;
  const int cib = bx % a.ncib, cob = bx / a.ncib;
  const int q0 = blockIdx.y * a.per_split;
  const int nq = min(nchunks(a, dz), q0 + a.per_split) - q0;
  // voxel k's u row at tap (dy, dx) = (-1, -1), the same in every chunk
  // (padding k: row 0, times the zero rows of g)
  const int per = a.ty * a.tx;
  for (int k = t; k < a.k8; k += kThreads) {
    int row = 0;
    if (k < a.kv) {
      const int s = k / per, r = k - s * per;
      row = s * a.uvs + (r / a.tx) * a.ux + r % a.tx;
    }
    tab[k] = row;
  }
  TShare sh(a, cob, cib);
  float acc[2][9][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][tap][e] = 0.f;
  auto fetch = [&](int it) {
    if (it < nq) {
      float* gs = smem + (it % STAGES) * a.stage_floats;
      fetch_tf32(a, sh, gchunk_at(a, q0 + it, dz), dz, gs, gs + a.k8 * LDG);
    }
    cp_async_commit();             // an empty group past the last chunk
  };
  fetch(0);
  for (int it = 0; it < nq; ++it) {
    fetch(it + 1);                 // into the stage multiplied last round
    cp_async_wait<1>();            // chunk it has arrived
    float* gs = smem + (it % STAGES) * a.stage_floats;
    if (a.pro_scale)
      prologue_tf32(a, sh, gchunk_at(a, q0 + it, dz), dz, gs + a.k8 * LDG);
    __syncthreads();
    mma_chunk_tf32(a, gs, gs + a.k8 * LDG, tab, acc);
    __syncthreads();               // the stage may be refilled
  }
  cp_async_wait<0>();

  // ---- epilogue: the tile through shared memory (the stages are
  // drained), then 9 consecutive taps of each (co, ci) to this split's
  // partial dW, consecutive threads on consecutive (ci, tap), so a warp's
  // stores fill whole sectors; every (co, ci, tap) of the tile is
  // written, zeros where no chunk added. C fragment element e is row gc +
  // 8 (e / 2), column 2 gr + e % 2.
  constexpr int RS = CI * 9 + 1;           // a staged Cout row, floats
  __syncthreads();
  const int lane = t & 31, warp = t >> 5, gr = lane & 3, gc = lane >> 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 32 * (warp & 1) + 16 * mi + gc + 8 * (e >> 1);
      const int col = 8 * (warp >> 1) + 2 * gr + (e & 1);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        smem[row * RS + col * 9 + tap] = acc[mi][tap][e];
    }
  __syncthreads();
  float* out = a.out + (long long)blockIdx.y * a.out_size;
  const int tap0 = (dz + 1) * 9;
  for (int idx = t; idx < CO * CI * 9; idx += kThreads) {
    const int row = idx / (CI * 9), rem = idx - row * (CI * 9);
    const int co = cob * CO + row, ci = cib * CI + rem / 9;
    if (co < a.cout && ci < a.cin)
      out[((long long)co * a.cin + ci) * 27 + tap0 + rem % 9] =
          smem[row * RS + rem];
  }
}

// dW = the sum of the splits' partials, in split order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, long long size,
                                    int split) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < size; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += partial[k * size + i];
    out[i] = s;
  }
}

cudaError_t launch_tf32(const void* g, const void* const* ps, const int* cs,
                        int nparts, const float* pro_scale,
                        const float* pro_shift, const float* pro_const,
                        float pro_slope, float* out, int n, int d, int h,
                        int w, int cin, int cout, int split, int per_split,
                        int tx, int ty, int slices, cudaStream_t s) {
  using namespace tf;
  TArgs a;
  memset(&a, 0, sizeof(a));
  if (tx < 1 || ty < 1 || slices < 1) return cudaErrorInvalidValue;
  int off = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    const bool used = i < nparts;
    a.part[i] = static_cast<const float*>(used ? ps[i] : ps[0]);
    a.part_c[i] = used ? cs[i] : 0;
    a.part_off[i] = off;
    a.part_vec[i] = used && cs[i] % 4 == 0 && off % 4 == 0 && aligned16(ps[i]);
    if (used) off += cs[i];
  }
  a.nparts = nparts;
  a.g = static_cast<const float*>(g);
  a.g_vec = cout % 4 == 0 && aligned16(g);
  a.pro_scale = pro_scale;
  a.pro_shift = pro_shift;
  a.pro_const = pro_const;
  a.pro_slope = pro_slope;
  a.out = out;
  a.out_size = (long long)cout * cin * 27;
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.cout = cout;
  a.tx = tx;
  a.ty = ty;
  a.slices = slices;
  a.kv = slices * ty * tx;
  a.k8 = (a.kv + 7) / 8 * 8;
  a.ux = tx + 2;
  a.uvs = (ty + 2) * a.ux;
  a.nyt = (h + ty - 1) / ty;
  a.nxt = (w + tx - 1) / tx;
  a.per_split = per_split;
  a.ncib = (cin + CI - 1) / CI;
  a.stage_floats = a.k8 * LDG + slices * a.uvs * LDU;
  auto magic = [](int v) {
    return (uint32_t)((0x100000000ull + v - 1) / (unsigned)(v > 0 ? v : 1));
  };
  a.nz_mul[0] = magic(d);
  a.nz_mul[1] = magic(d - 1);
  a.ring_floats = max(STAGES * a.stage_floats, CO * (CI * 9 + 1));
  const long long smem = (long long)(a.ring_floats + a.k8) * 4;
  const long long nch =
      (long long)((n * d + slices - 1) / slices) * a.nyt * a.nxt;
  if (smem > kMaxSmem || (long long)split * per_split < nch)
    return cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3d_wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int ncob = (cout + CO - 1) / CO;
  const dim3 grid((unsigned)(ncob * a.ncib * 3), (unsigned)split);
  conv3d_wgrad_tf32_kernel<<<grid, kThreads, (size_t)smem, s>>>(a);
  return cudaGetLastError();
}

template <int CIB>
cudaError_t launch_wgmma(const GArgs& a, int ncob, int split,
                         cudaStream_t s) {
  static bool ready = false;
  auto kernel = conv3d_wgrad_wgmma_kernel<CIB>;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((unsigned)(ncob * a.ncib * 3), (unsigned)split);
  kernel<<<grid, wg::kThreads, wg::kSmem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* g, const void* const* ps, const int* cs,
                        int nparts, const float* pro_scale,
                        const float* pro_shift, const float* pro_const,
                        float pro_slope, float* out, int n, int d, int h,
                        int w, int cin, int cout, int split, int per_split,
                        int tx, int ty, int slices, int ci_tile,
                        cudaStream_t s) {
  GArgs a;   // holds 64-byte-aligned tensor maps
  memset(&a, 0, sizeof(a));
  if ((tx != 8 && tx != 16) || ty < 2 || ty % 2 || ty + 2 > 256 ||
      slices < 1 || (slices * ty * tx) % (16 * wg::kSteps) ||
      (ci_tile != 16 && ci_tile != 64))
    return cudaErrorInvalidValue;
  int off = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    const bool used = i < nparts;
    a.part[i] = static_cast<const __nv_bfloat16*>(used ? ps[i] : ps[0]);
    a.part_c[i] = used ? cs[i] : 0;
    a.part_off[i] = off;
    a.part_tma[i] =
        used && cs[i] % 8 == 0 && off % 8 == 0 && aligned16(ps[i]);
    if (used) off += cs[i];
  }
  a.nparts = nparts;
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.g_tma = cout % 8 == 0 && aligned16(g);
  a.pro_scale = pro_scale;
  a.pro_shift = pro_shift;
  a.pro_const = pro_const;
  a.pro_slope = pro_slope;
  a.out = out;
  a.out_size = (long long)cout * cin * 27;
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.cout = cout;
  a.tx = tx;
  a.ty = ty;
  a.slices = slices;
  a.ux = tx + 2;
  a.uvs = (ty + 2) * a.ux;
  a.usl = (a.uvs + 7) / 8 * 8;     // 128-byte aligned TMA destinations
  a.nyt = (h + ty - 1) / ty;
  a.nxt = (w + tx - 1) / tx;
  a.per_split = per_split;
  a.ncib = (cin + ci_tile - 1) / ci_tile;
  a.g_bytes = slices * ty * tx * 128;
  a.plane_bytes = slices * a.usl * 16;
  a.stage_bytes = (a.g_bytes + ci_tile / 8 * a.plane_bytes + 1023) / 1024 *
                  1024;
  a.stages = wg::kRingBytes / a.stage_bytes;
  if (a.stages > wg::kMaxStages) a.stages = wg::kMaxStages;
  // K runs: the second run of a k16 step is 8 voxels on (tx 16) or a row
  // down (tx 8). Planes (no swizzle, channel-major): LBO that K step, SBO
  // the next plane (8 channels); rows of 64 channels (128-byte swizzle):
  // SBO the K step, LBO unused (one swizzle atom spans the 64 channels)
  const int kstep = tx == 16 ? 8 : a.ux;
  a.b_lbo = ci_tile == 64 ? 1 : kstep;
  a.b_sbo = ci_tile == 64 ? kstep * 8 : a.plane_bytes / 16;
  auto magic = [](int v) {
    return (uint32_t)((0x100000000ull + v - 1) / (unsigned)(v > 0 ? v : 1));
  };
  a.ux_mul = magic(a.ux);
  a.uvs_mul = magic(a.uvs);
  a.nz_mul[0] = magic(d);
  a.nz_mul[1] = magic(d - 1);
  a.tab = pro_scale != nullptr && 3LL * n * ci_tile * 4 <= wg::kTabBytes;
  const int nvalid = n * d;
  const long long nch =
      (long long)((nvalid + slices - 1) / slices) * a.nyt * a.nxt;
  if (a.stages < 3 || (long long)split * per_split < nch ||
      a.plane_bytes / 16 >= (1 << 14))
    return cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  auto map = [&](CUtensorMap* m, const void* p, int c, cuuint32_t b0,
                 cuuint32_t b1, cuuint32_t b2, CUtensorMapSwizzle sw) {
    const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                                (cuuint64_t)d, (cuuint64_t)n};
    const cuuint64_t strides[4] = {(cuuint64_t)c * 2, (cuuint64_t)c * 2 * w,
                                   (cuuint64_t)c * 2 * w * h,
                                   (cuuint64_t)c * 2 * w * h * d};
    const cuuint32_t box[5] = {b0, b1, b2, 1, 1};
    return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                  const_cast<void*>(p), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (a.g_tma && !map(&a.gmap, g, cout, 64, tx, ty,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if (a.part_tma[i] &&
        !map(&a.umap[i], ps[i], cs[i], ci_tile == 64 ? 64 : 8, a.ux, ty + 2,
             ci_tile == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
  const int ncob = (cout + wg::CO - 1) / wg::CO;
  return ci_tile == 16 ? launch_wgmma<16>(a, ncob, split, s)
                       : launch_wgmma<64>(a, ncob, split, s);
}

}  // namespace

// dW (cout, cin, 3, 3, 3) float32 from g (n, d, h, w, cout) and the input
// parts (n, d, h, w, c_i), both bfloat16 (bf16 = 1) or float32, with the
// optional prologue (scale, shift, const: (n, cin) float32; pro_slope 1 for
// no activation). The chunks (`slices` (sample, z) slices x ty x tx
// output voxels; bf16 in Cin tiles of ci_tile, float32 of 32) are split in
// `split` runs of `per_split`; split > 1 needs the float32 workspace
// `partial` of split * cout * cin * 27 values. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int conv3x3_wgrad(
    const void* g, const void* p0, const void* p1, const void* p2,
    const void* p3, int c0, int c1, int c2, int c3, int nparts,
    const void* pro_scale, const void* pro_shift, const void* pro_const,
    float pro_slope, void* out, void* partial, int n, int d, int h, int w,
    int cout, int split, int per_split, int bf16, int tx, int ty, int slices,
    int ci_tile, void* stream) {
  const void* ps[kMaxParts] = {p0, p1, p2, p3};
  const int cs[kMaxParts] = {c0, c1, c2, c3};
  if (nparts < 1 || nparts > kMaxParts || split < 1 || per_split < 1 ||
      (split > 1 && partial == nullptr) || (pro_scale && !pro_shift))
    return (int)cudaErrorInvalidValue;
  int cin = 0;
  for (int i = 0; i < nparts; ++i) cin += cs[i];
  const long long size = (long long)cout * cin * 27;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (size == 0) return (int)cudaSuccess;
  if ((long long)n * d * h * w == 0)
    return (int)cudaMemsetAsync(out, 0, size * sizeof(float), s);
  float* dst = static_cast<float*>(split > 1 ? partial : out);
  const float* sc = static_cast<const float*>(pro_scale);
  const float* sh = static_cast<const float*>(pro_shift);
  const float* cc = static_cast<const float*>(pro_const);
  cudaError_t err;
  if (bf16) {
    err = launch_bf16(g, ps, cs, nparts, sc, sh, cc, pro_slope, dst, n, d, h,
                      w, cin, cout, split, per_split, tx, ty, slices,
                      ci_tile, s);
  } else {
    err = launch_tf32(g, ps, cs, nparts, sc, sh, cc, pro_slope, dst, n, d, h,
                      w, cin, cout, split, per_split, tx, ty, slices, s);
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long blocks = (size + 255) / 256;
  wgrad_reduce_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                        s>>>(static_cast<const float*>(partial),
                             static_cast<float*>(out), size, split);
  return (int)cudaGetLastError();
}

