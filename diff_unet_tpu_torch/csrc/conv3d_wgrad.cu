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
// float32 (conv3d_wgrad_f32_kernel): exact FFMA (TF32 would not hold the
// 1e-4 tolerance). A CTA owns 64 Cout x 32 Cin x the nine (y, x) taps of
// one z tap; K comes in chunks of 16 x 8 (y, x) voxels of one (sample, z)
// slice by cp.async into two shared-memory stages; each thread computes 4
// Cout x 18 (tap, Cin) values.
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

// ------------------------------------------------------------ float32 path
namespace f32 {
constexpr int kThreads = 256;
constexpr int CO_TILE = 64;        // output channels of a CTA tile
constexpr int CI_TILE = 32;        // input channels of a CTA tile
constexpr int PY = 16, PX = 8;     // output voxels (y, x) of a chunk
constexpr int KV = PY * PX;        // the GEMM's K per chunk
constexpr int UY = PY + 2, UX = PX + 2;   // u's tile: the y and x halo
constexpr int UV = UY * UX;        // input voxels of a chunk
constexpr int E = 4;               // values in 16 bytes
constexpr int GG = CO_TILE / E;    // 16-byte pieces: g row
constexpr int GU = CI_TILE / E;    // 16-byte pieces: u row
// row strides in shared memory: 16 bytes of padding keep the float4 reads
// free of bank conflicts
constexpr int LDG = CO_TILE + E;
constexpr int LDU = CI_TILE + E;
constexpr int G_ITEMS = KV * GG / kThreads;
constexpr int U_ITEMS = (UV * GU + kThreads - 1) / kThreads;
constexpr int STAGE = KV * LDG + UV * LDU;   // floats of a stage
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE * 4;
static_assert(KV * GG % kThreads == 0, "g tile pieces");
static_assert(kThreads % GG == 0 && kThreads % GU == 0, "fixed channels");
}  // namespace f32

struct WgArgs {
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
  int nyb, nxb, nchunk, per_split, ncib;
};

struct Chunk {
  int n, z, y0, x0;
};

__device__ __forceinline__ Chunk chunk_at(const WgArgs& a, int q) {
  Chunk c;
  c.x0 = (q % a.nxb) * f32::PX;
  q /= a.nxb;
  c.y0 = (q % a.nyb) * f32::PY;
  q /= a.nyb;
  c.z = q % a.d;
  c.n = q / a.d;
  return c;
}

// The first chunk at or after q whose input slice z + dz is in the volume.
__device__ __forceinline__ int valid_from(const WgArgs& a, int q, int dz) {
  const int per_z = a.nyb * a.nxb;
  while (q < a.nchunk) {
    const int z = (q / per_z) % a.d;
    if ((unsigned)(z + dz) < (unsigned)a.d) return q;
    q = (q / per_z + 1) * per_z;
  }
  return q;
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

// A thread's share of every chunk: its 16-byte pieces are pieces
// t + kThreads * i of each tile, which all hold the same 4 channels, so
// the channels, their part and the prologue columns are fixed per thread;
// only the voxels move. It keeps the prologue values of its channels for
// the sample pro_n.
struct Share {
  int gv0, uv0;         // first voxel of its g and u pieces
  int co;               // first output channel of its g pieces
  int ci;               // first input channel of its u pieces
  const float* part;    // the part that holds ci (null: beyond cin)
  int pc, lc;           // its channels, ci's channel in it
  int vec;              // u pieces by cp.async (else gathered)
  int pro_n;            // the sample of sc, sf, cs (-1: none yet)
  float sc[f32::E], sf[f32::E], cs[f32::E];

  __device__ Share(const WgArgs& a, int cob, int cib) {
    using namespace f32;
    const int t = threadIdx.x;
    gv0 = t / GG;
    uv0 = t / GU;
    co = cob * CO_TILE + (t % GG) * E;
    ci = cib * CI_TILE + (t % GU) * E;
    part = nullptr;
    pc = vec = lc = 0;
    if (ci < a.cin) {
      const int pi = part_index(a, ci);
      part = a.part[pi];
      pc = a.part_c[pi];
      vec = a.part_vec[pi];
      lc = ci - a.part_off[pi];
    }
    pro_n = -1;
  }

  // the prologue values of channels ci.. at sample n (0 beyond cin)
  __device__ void load_prologue(const WgArgs& a, int n) {
    pro_n = n;
#pragma unroll
    for (int e = 0; e < f32::E; ++e) {
      const bool real = ci + e < a.cin;
      const int k = n * a.cin + ci + e;
      sc[e] = real ? a.pro_scale[k] : 0.f;
      sf[e] = real ? a.pro_shift[k] : 0.f;
      cs[e] = real && a.pro_const ? a.pro_const[k] : 0.f;
    }
  }
};

// Starts the copies of this thread's pieces of a chunk into a stage: 16
// bytes by cp.async where they are whole and aligned, zeros (st.shared)
// outside the volume and beyond the channels, and a scalar gather (its
// prologue applied at once) where a part's channels do not allow 16-byte
// loads.
__device__ __forceinline__ void fetch_chunk(const WgArgs& a, Share& sh,
                                            const Chunk& c, int dz, float* gs,
                                            float* us) {
  using namespace f32;
  const long long gbase = ((long long)c.n * a.d + c.z) * a.h;
#pragma unroll
  for (int i = 0; i < G_ITEMS; ++i) {
    const int vox = sh.gv0 + kThreads / GG * i;
    const int y = c.y0 + vox / PX, x = c.x0 + vox % PX;
    float* dst = gs + vox * LDG + (threadIdx.x % GG) * E;
    const bool in = y < a.h && x < a.w && sh.co < a.cout;
    const float* src = a.g + ((gbase + y) * a.w + x) * a.cout + sh.co;
    if (in && a.g_vec) {
      cp_async16(dst, src);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float* e4 = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (in && sh.co + e < a.cout) e4[e] = src[e];
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
  const long long ubase = ((long long)c.n * a.d + c.z + dz) * a.h;
  if (a.pro_scale && !sh.vec && sh.pro_n != c.n) sh.load_prologue(a, c.n);
#pragma unroll
  for (int i = 0; i < U_ITEMS; ++i) {
    const int vox = sh.uv0 + kThreads / GU * i;
    if (vox >= UV) break;
    const int r = vox / UX;
    const int y = c.y0 - 1 + r, x = c.x0 - 1 + (vox - r * UX);
    float* dst = us + vox * LDU + (threadIdx.x % GU) * E;
    const bool in = sh.part != nullptr && (unsigned)y < (unsigned)a.h &&
                    (unsigned)x < (unsigned)a.w;
    const long long vx = (ubase + y) * a.w + x;
    if (in && sh.vec) {
      cp_async16(dst, sh.part + vx * sh.pc + sh.lc);
      continue;
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float* e4 = reinterpret_cast<float*>(&v);
    if (in) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int ci = sh.ci + e;
        if (ci >= a.cin) break;
        const int pi = part_index(a, ci);
        float val = a.part[pi][vx * a.part_c[pi] + (ci - a.part_off[pi])];
        if (a.pro_scale)
          val = prologue_f(val, sh.sc[e], sh.sf[e], sh.cs[e], a.pro_slope);
        e4[e] = val;
      }
    }
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// The prologue on the pieces this thread copied by cp.async, once they
// have arrived; the halo stays 0.
__device__ __forceinline__ void prologue_chunk(const WgArgs& a, Share& sh,
                                               const Chunk& c, float* us) {
  using namespace f32;
  if (sh.part == nullptr || !sh.vec) return;
  if (sh.pro_n != c.n) sh.load_prologue(a, c.n);
#pragma unroll
  for (int i = 0; i < U_ITEMS; ++i) {
    const int vox = sh.uv0 + kThreads / GU * i;
    if (vox >= UV) break;
    const int r = vox / UX;
    const int y = c.y0 - 1 + r, x = c.x0 - 1 + (vox - r * UX);
    if ((unsigned)y >= (unsigned)a.h || (unsigned)x >= (unsigned)a.w)
      continue;
    float4* p = reinterpret_cast<float4*>(
        us + vox * LDU + (threadIdx.x % GU) * E);
    float4 v = *p;
    float* e4 = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int e = 0; e < E; ++e)
      e4[e] = prologue_f(e4[e], sh.sc[e], sh.sf[e], sh.cs[e], a.pro_slope);
    *p = v;
  }
}

// One chunk on the CUDA cores: acc[i * 18 + q] is Cout 4 tm + i and column
// tn + 16 q: tap q / 2, input channel tn + 16 (q % 2).
__device__ __forceinline__ void ffma_chunk(const float* gs, const float* us,
                                           float* acc, int t) {
  using namespace f32;
  const int tm = t >> 4, tn = t & 15;
#pragma unroll 2
  for (int k = 0; k < KV; ++k) {
    const float4 av =
        *reinterpret_cast<const float4*>(gs + k * LDG + 4 * tm);
    const float ai[4] = {av.x, av.y, av.z, av.w};
    const int base = (k / PX) * UX + k % PX;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* ur = us + (base + (tap / 3) * UX + tap % 3) * LDU + tn;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float b = ur[16 * h];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i * 18 + 2 * tap + h] =
              fmaf(ai[i], b, acc[i * 18 + 2 * tap + h]);
      }
    }
  }
}

// blockIdx.x: the tile (Cout block, Cin block, z tap), the tap fastest, so
// the tiles of one split run together and share its chunks in L2;
// blockIdx.y: the split of the chunks. The chunks flow through two stages,
// one in flight while the other is multiplied.
__global__ void __launch_bounds__(f32::kThreads, 1)
conv3d_wgrad_f32_kernel(const WgArgs a) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int t = threadIdx.x;
  int bx = blockIdx.x;
  const int dz = bx % 3 - 1;
  bx /= 3;
  const int cib = bx % a.ncib, cob = bx / a.ncib;
  const int split = blockIdx.y;
  const int q1 = min(a.nchunk, (split + 1) * a.per_split);
  Share sh(a, cob, cib);

  float acc[72];
#pragma unroll
  for (int i = 0; i < 72; ++i) acc[i] = 0.f;
  // qi: the next chunk to fetch, into stage si; q: the chunk to multiply,
  // from stage s
  int qi = valid_from(a, split * a.per_split, dz), si = 0;
  int q = qi, s = 0;
  auto fetch = [&]() {
    if (qi < q1) {
      float* gs = smem + si * STAGE;
      fetch_chunk(a, sh, chunk_at(a, qi), dz, gs, gs + KV * LDG);
      qi = valid_from(a, qi + 1, dz);
    }
    cp_async_commit();          // an empty group past the last chunk
    si = si + 1 == STAGES ? 0 : si + 1;
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) fetch();
  while (q < q1) {
    fetch();                    // into the stage multiplied last round
    cp_async_wait<STAGES - 1>();     // chunk q has arrived
    float* gs = smem + s * STAGE;
    if (a.pro_scale) prologue_chunk(a, sh, chunk_at(a, q), gs + KV * LDG);
    __syncthreads();
    ffma_chunk(gs, gs + KV * LDG, acc, t);
    __syncthreads();            // the stage may be refilled
    s = s + 1 == STAGES ? 0 : s + 1;
    q = valid_from(a, q + 1, dz);
  }
  cp_async_wait<0>();

  // every (co, ci, tap) of the tile is written, zeros where no chunk added
  float* out = a.out + (long long)split * a.out_size;
  const int tap0 = (dz + 1) * 9;
  const int tm = t >> 4, tn = t & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q2 = 0; q2 < 18; ++q2) {
      const int co = cob * CO_TILE + 4 * tm + i;
      const int col = tn + 16 * q2;
      const int ci = cib * CI_TILE + col % CI_TILE;
      if (co < a.cout && ci < a.cin)
        out[((long long)co * a.cin + ci) * 27 + tap0 + col / CI_TILE] =
            acc[i * 18 + q2];
    }
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

__device__ __forceinline__ int nchunks(const GArgs& a, int dz) {
  const int nz = a.d - (dz != 0);
  const int groups = (a.n * nz + a.slices - 1) / a.slices;
  return groups * a.nyt * a.nxt;
}

__device__ __forceinline__ GChunk gchunk_at(const GArgs& a, int q, int dz) {
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
__device__ __forceinline__ void slice_nz(const GArgs& a, const GChunk& c,
                                         int s, int dz, int& n, int& z) {
  const int i = c.slice0 + s;
  n = __umulhi(i, a.nz_mul[dz != 0]);
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

cudaError_t launch_f32(const void* g, const void* const* ps, const int* cs,
                       int nparts, const float* pro_scale,
                       const float* pro_shift, const float* pro_const,
                       float pro_slope, float* out, int n, int d, int h,
                       int w, int cin, int cout, int split, int per_split,
                       cudaStream_t s) {
  using namespace f32;
  WgArgs a;
  memset(&a, 0, sizeof(a));
  int off = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    const bool used = i < nparts;
    a.part[i] = static_cast<const float*>(used ? ps[i] : ps[0]);
    a.part_c[i] = used ? cs[i] : 0;
    a.part_off[i] = off;
    a.part_vec[i] = used && cs[i] % E == 0 && off % E == 0 && aligned16(ps[i]);
    if (used) off += cs[i];
  }
  a.nparts = nparts;
  a.g = static_cast<const float*>(g);
  a.g_vec = cout % E == 0 && aligned16(g);
  a.pro_scale = pro_scale;
  a.pro_shift = pro_shift;
  a.pro_const = pro_const;
  a.pro_slope = pro_slope;
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.cout = cout;
  a.nyb = (h + PY - 1) / PY;
  a.nxb = (w + PX - 1) / PX;
  a.nchunk = n * d * a.nyb * a.nxb;
  a.per_split = per_split;
  a.ncib = (cin + CI_TILE - 1) / CI_TILE;
  a.out_size = (long long)cout * cin * 27;
  a.out = out;
  if ((long long)split * per_split < a.nchunk) return cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3d_wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int ncob = (cout + CO_TILE - 1) / CO_TILE;
  const dim3 grid((unsigned)(ncob * a.ncib * 3), (unsigned)split);
  conv3d_wgrad_f32_kernel<<<grid, kThreads, SMEM, s>>>(a);
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
// no activation). The chunks (bf16: `slices` (sample, z) slices x ty x tx
// output voxels, Cin tiles of ci_tile; float32: 16 x 8 (y, x) voxels of
// one slice, tx 8, ty 16, slices 1) are split in `split` runs of
// `per_split`; split > 1 needs the float32 workspace `partial` of split *
// cout * cin * 27 values. Returns the cudaError_t of the launches (0 on
// success).
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
    if (tx != f32::PX || ty != f32::PY || slices != 1)
      return (int)cudaErrorInvalidValue;
    err = launch_f32(g, ps, cs, nparts, sc, sh, cc, pro_slope, dst, n, d, h,
                     w, cin, cout, split, per_split, s);
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long blocks = (size + 255) / 256;
  wgrad_reduce_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                        s>>>(static_cast<const float*>(partial),
                             static_cast<float*>(out), size, split);
  return (int)cudaGetLastError();
}

