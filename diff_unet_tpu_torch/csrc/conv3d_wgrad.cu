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
// it is bytes.
//
// Design. A GEMM with M = Cout, N = (tap, Cin), K = the voxels. A CTA owns
// 64 output channels x 32 input channels x the nine (y, x) taps of one z
// tap: the nine taps read one staged input tile at nine offsets, and one
// staged g tile serves all of them. K comes in chunks of 16 x 8 (y, x)
// output voxels of one (sample, z) slice: g's 128 x 64 tile, and u's
// 18 x 10 voxels (the y and x halo) x 32 channels at the slice z + dz. A
// chunk whose slice z + dz lies outside the volume adds nothing and is
// skipped. Chunks arrive by cp.async in a ring of shared-memory stages
// (four in bf16, two in float32), the next ones in flight while one is
// multiplied; each thread applies the prologue to the pieces it copied
// once they have arrived (the stems' 1- and 15-channel parts, which
// 16-byte copies cannot take, are gathered by scalar loads). A thread's
// pieces of a tile hold fixed channels, so their part and prologue columns
// are found once, and the prologue rows are reread only when the sample
// changes.
// - bf16: mma.sync m16n8k16 on the tensor cores. g is voxel-major, so it
//   is the transposed A operand: ldmatrix.trans gives its fragments, and
//   u's (voxel-major B) too. 8 warps as 2 (Cout) x 4 (taps x Cin), each
//   32 x 72 of the 64 x 288 tile, two k steps' B fragments of an n8 tile
//   in one ldmatrix.x4.
// - float32: FFMA, each thread 4 Cout x 18 (tap, Cin) values.
// - The chunks are split across CTAs (grid.y) until the grid has about a
//   thousand CTAs; the CTAs of one split run at once and share their
//   chunks in L2. Each split writes its partial dW to a workspace and a
//   second pass sums the partials in split order: no float atomics, so the
//   result is the same from run to run.
// wgmma and TMA are left for later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxParts = 4;
constexpr int kThreads = 256;
constexpr int CO_TILE = 64;        // output channels of a CTA tile
constexpr int CI_TILE = 32;        // input channels of a CTA tile
constexpr int PY = 16, PX = 8;     // output voxels (y, x) of a chunk
constexpr int KV = PY * PX;        // the GEMM's K per chunk
constexpr int UY = PY + 2, UX = PX + 2;   // u's tile: the y and x halo
constexpr int UV = UY * UX;        // input voxels of a chunk

struct WgArgs {
  const void* g;                   // (n, d, h, w, cout)
  const void* part[kMaxParts];     // NDHWC, part_c[i] channels each
  int part_c[kMaxParts];
  int part_off[kMaxParts];         // first concat channel of each part
  int part_vec[kMaxParts];         // 16-byte loads: channels and offset a
                                   // multiple of E, pointer aligned
  int nparts;
  int g_vec;                       // cout a multiple of E, g aligned
  const float* pro_scale;          // (n, cin) or null: no prologue
  const float* pro_shift;          // (n, cin)
  const float* pro_const;          // (n, cin) or null
  float pro_slope;                 // 1: no prologue activation
  float* out;                      // (split, cout, cin, 27)
  long long out_size;              // cout * cin * 27
  int n, d, h, w, cin, cout;
  int nyb, nxb, nchunk, per_split, ncib;
};

template <typename T> struct Tr;
template <> struct Tr<float> {
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};
template <> struct Tr<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __nv_bfloat16 from_f(float v) {
    return __float2bfloat16(v);
  }
};

template <typename T>
struct Geo {
  static constexpr int E = 16 / sizeof(T);      // values in 16 bytes
  static constexpr int GG = CO_TILE / E;        // 16-byte pieces: g row
  static constexpr int GU = CI_TILE / E;        // 16-byte pieces: u row
  // row strides in shared memory: 16 bytes of padding keep ldmatrix and
  // the float4 reads free of bank conflicts
  static constexpr int LDG = CO_TILE + E;
  static constexpr int LDU = CI_TILE + E;
  static constexpr int G_ITEMS = KV * GG / kThreads;
  static constexpr int U_ITEMS = (UV * GU + kThreads - 1) / kThreads;
  static constexpr int STAGE = KV * LDG + UV * LDU;   // elements of a stage
  // one CTA an SM (its 72 accumulators a thread and the fragments need
  // more than the 128 registers of two): four stages in bf16, two in f32
  static constexpr int STAGES = sizeof(T) == 2 ? 4 : 2;
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(T);
  static_assert(KV * GG % kThreads == 0, "g tile pieces");
  static_assert(kThreads % GG == 0 && kThreads % GU == 0, "fixed channels");
};

struct Chunk {
  int n, z, y0, x0;
};

__device__ __forceinline__ Chunk chunk_at(const WgArgs& a, int q) {
  Chunk c;
  c.x0 = (q % a.nxb) * PX;
  q /= a.nxb;
  c.y0 = (q % a.nyb) * PY;
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

// The part that holds concat channel ci (constant-index parameter reads).
template <typename T>
__device__ __forceinline__ const T* part_of(const WgArgs& a, int ci, int& pc,
                                            int& po, int& vec) {
  const void* base = a.part[0];
  pc = a.part_c[0];
  po = 0;
  vec = a.part_vec[0];
#pragma unroll
  for (int i = 1; i < kMaxParts; ++i) {
    if (i < a.nparts && ci >= a.part_off[i]) {
      base = a.part[i];
      pc = a.part_c[i];
      po = a.part_off[i];
      vec = a.part_vec[i];
    }
  }
  return static_cast<const T*>(base);
}

template <typename T>
union Vec {
  uint4 u;
  T e[Geo<T>::E];
};

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

template <typename T>
__device__ __forceinline__ T prologue_one(float x, float sc, float sh,
                                          float cs, float slope) {
  float u = x * sc + sh;
  u = u >= 0.f ? u : u * slope;
  return Tr<T>::from_f(u + cs);
}

// A thread's share of every chunk: its 16-byte pieces are pieces
// t + kThreads * i of each tile, which all hold the same E channels, so
// the channels, their part and the prologue columns are fixed per thread;
// only the voxels move. It keeps the prologue values of its channels for
// the sample pro_n.
template <typename T>
struct Share {
  using G = Geo<T>;
  int gv0, uv0;         // first voxel of its g and u pieces
  int co;               // first output channel of its g pieces
  int ci;               // first input channel of its u pieces
  const T* part;        // the part that holds ci (null: beyond cin)
  int pc, lc;           // its channels, ci's channel in it
  int vec;              // u pieces by cp.async (else gathered)
  int pro_n;            // the sample of sc, sf, cs (-1: none yet)
  float sc[G::E], sf[G::E], cs[G::E];

  __device__ Share(const WgArgs& a, int cob, int cib) {
    const int t = threadIdx.x;
    gv0 = t / G::GG;
    uv0 = t / G::GU;
    co = cob * CO_TILE + (t % G::GG) * G::E;
    ci = cib * CI_TILE + (t % G::GU) * G::E;
    int po = 0;
    pc = vec = 0;
    part = ci < a.cin ? part_of<T>(a, ci, pc, po, vec) : nullptr;
    lc = ci - po;
    pro_n = -1;
  }

  // the prologue values of channels ci.. at sample n (0 beyond cin)
  __device__ void load_prologue(const WgArgs& a, int n) {
    pro_n = n;
#pragma unroll
    for (int e = 0; e < G::E; ++e) {
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
template <typename T>
__device__ __forceinline__ void fetch_chunk(const WgArgs& a, Share<T>& sh,
                                            const Chunk& c, int dz, T* gs,
                                            T* us) {
  using G = Geo<T>;
  const long long gbase = ((long long)c.n * a.d + c.z) * a.h;
#pragma unroll
  for (int i = 0; i < G::G_ITEMS; ++i) {
    const int vox = sh.gv0 + kThreads / G::GG * i;
    const int y = c.y0 + vox / PX, x = c.x0 + vox % PX;
    T* dst = gs + vox * G::LDG + (threadIdx.x % G::GG) * G::E;
    const bool in = y < a.h && x < a.w && sh.co < a.cout;
    const T* src = static_cast<const T*>(a.g) +
                   ((gbase + y) * a.w + x) * a.cout + sh.co;
    if (in && a.g_vec) {
      cp_async16(dst, src);
    } else {
      Vec<T> v;
      v.u = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < G::E; ++e)
        if (in && sh.co + e < a.cout) v.e[e] = src[e];
      *reinterpret_cast<uint4*>(dst) = v.u;
    }
  }
  const long long ubase = ((long long)c.n * a.d + c.z + dz) * a.h;
  if (a.pro_scale && !sh.vec && sh.pro_n != c.n) sh.load_prologue(a, c.n);
#pragma unroll
  for (int i = 0; i < G::U_ITEMS; ++i) {
    const int vox = sh.uv0 + kThreads / G::GU * i;
    if (vox >= UV) break;
    const int r = vox / UX;
    const int y = c.y0 - 1 + r, x = c.x0 - 1 + (vox - r * UX);
    T* dst = us + vox * G::LDU + (threadIdx.x % G::GU) * G::E;
    const bool in = sh.part != nullptr && (unsigned)y < (unsigned)a.h &&
                    (unsigned)x < (unsigned)a.w;
    const long long vx = (ubase + y) * a.w + x;
    if (in && sh.vec) {
      cp_async16(dst, sh.part + vx * sh.pc + sh.lc);
      continue;
    }
    Vec<T> v;
    v.u = make_uint4(0, 0, 0, 0);
    if (in) {
#pragma unroll
      for (int e = 0; e < G::E; ++e) {
        if (sh.ci + e >= a.cin) break;
        int pc, po, vec;
        const T* base = part_of<T>(a, sh.ci + e, pc, po, vec);
        T val = base[vx * pc + (sh.ci + e - po)];
        if (a.pro_scale)
          val = prologue_one<T>(Tr<T>::to_f(val), sh.sc[e], sh.sf[e],
                                sh.cs[e], a.pro_slope);
        v.e[e] = val;
      }
    }
    *reinterpret_cast<uint4*>(dst) = v.u;
  }
}

// The prologue, in float32 rounded to T, on the pieces this thread copied
// by cp.async, once they have arrived; the halo stays 0.
template <typename T>
__device__ __forceinline__ void prologue_chunk(const WgArgs& a, Share<T>& sh,
                                               const Chunk& c, T* us) {
  using G = Geo<T>;
  if (sh.part == nullptr || !sh.vec) return;
  if (sh.pro_n != c.n) sh.load_prologue(a, c.n);
#pragma unroll
  for (int i = 0; i < G::U_ITEMS; ++i) {
    const int vox = sh.uv0 + kThreads / G::GU * i;
    if (vox >= UV) break;
    const int r = vox / UX;
    const int y = c.y0 - 1 + r, x = c.x0 - 1 + (vox - r * UX);
    if ((unsigned)y >= (unsigned)a.h || (unsigned)x >= (unsigned)a.w)
      continue;
    Vec<T>* p = reinterpret_cast<Vec<T>*>(
        us + vox * G::LDU + (threadIdx.x % G::GU) * G::E);
    Vec<T> v = *p;
#pragma unroll
    for (int e = 0; e < G::E; ++e)
      v.e[e] = prologue_one<T>(Tr<T>::to_f(v.e[e]), sh.sc[e], sh.sf[e],
                               sh.cs[e], a.pro_slope);
    *p = v;
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One chunk on the tensor cores, two k16 steps (patch rows 4 s2 .. 4 s2 +
// 3) at a time: acc[(mi * 9 + ni) * 4 + e] is warp (wm, wn)'s m16n8 tile
// (mi, ni) of the 64 x 288 CTA tile. A = g^T: matrix li of a k step holds
// Cout rows 8 (li & 1) and voxels 8 (li >> 1). B = u at tap (dy, dx):
// matrix li holds the 8 voxels of patch row 4 s2 + li (column lr) of an n8
// tile of input channels, so one x4 serves both k steps.
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* gs,
                                          const __nv_bfloat16* us,
                                          float* acc, int warp, int lane) {
  constexpr int LDG = Geo<__nv_bfloat16>::LDG;
  constexpr int LDU = Geo<__nv_bfloat16>::LDU;
  const int wm = warp & 1, wn = warp >> 1;
  const int li = lane >> 3, lr = lane & 7;
#pragma unroll
  for (int s2 = 0; s2 < KV / 32; ++s2) {
    uint32_t af[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_trans(af[h][mi],
                      gs + (32 * s2 + 16 * h + 8 * (li >> 1) + lr) * LDG +
                          wm * 32 + mi * 16 + 8 * (li & 1));
#pragma unroll
    for (int ni = 0; ni < 9; ++ni) {
      const int col = wn * 72 + ni * 8;
      const int tap = col / CI_TILE, dy = tap / 3, dx = tap % 3;
      uint32_t bf[4];
      ldsm_x4_trans(bf, us + ((4 * s2 + li + dy) * UX + lr + dx) * LDU +
                            col % CI_TILE);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_bf16(acc + (mi * 9 + ni) * 4, af[h][mi], bf[2 * h],
                   bf[2 * h + 1]);
    }
  }
}

// One chunk on the CUDA cores: acc[i * 18 + q] is Cout 4 tm + i and column
// tn + 16 q: tap q / 2, input channel tn + 16 (q % 2).
__device__ __forceinline__ void ffma_chunk(const float* gs, const float* us,
                                           float* acc, int t) {
  constexpr int LDG = Geo<float>::LDG;
  constexpr int LDU = Geo<float>::LDU;
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
// blockIdx.y: the split of the chunks. The chunks flow through a ring of
// Geo<T>::STAGES stages, STAGES - 1 in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_wgrad_kernel(const WgArgs a) {
  using G = Geo<T>;
  constexpr int S = G::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  int bx = blockIdx.x;
  const int dz = bx % 3 - 1;
  bx /= 3;
  const int cib = bx % a.ncib, cob = bx / a.ncib;
  const int split = blockIdx.y;
  const int q1 = min(a.nchunk, (split + 1) * a.per_split);
  Share<T> sh(a, cob, cib);

  float acc[72];
#pragma unroll
  for (int i = 0; i < 72; ++i) acc[i] = 0.f;
  // qi: the next chunk to fetch, into stage si; q: the chunk to multiply,
  // from stage s
  int qi = valid_from(a, split * a.per_split, dz), si = 0;
  int q = qi, s = 0;
  auto fetch = [&]() {
    if (qi < q1) {
      T* gs = smem + si * G::STAGE;
      fetch_chunk<T>(a, sh, chunk_at(a, qi), dz, gs, gs + KV * G::LDG);
      qi = valid_from(a, qi + 1, dz);
    }
    cp_async_commit();          // an empty group past the last chunk
    si = si + 1 == S ? 0 : si + 1;
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) fetch();
  while (q < q1) {
    fetch();                    // into the stage multiplied last round
    cp_async_wait<S - 1>();     // chunk q has arrived
    T* gs = smem + s * G::STAGE;
    if (a.pro_scale)
      prologue_chunk<T>(a, sh, chunk_at(a, q), gs + KV * G::LDG);
    __syncthreads();
    if constexpr (sizeof(T) == 2)
      mma_chunk(gs, gs + KV * G::LDG, acc, warp, lane);
    else
      ffma_chunk(gs, gs + KV * G::LDG, acc, t);
    __syncthreads();            // the stage may be refilled
    s = s + 1 == S ? 0 : s + 1;
    q = valid_from(a, q + 1, dz);
  }
  cp_async_wait<0>();

  // every (co, ci, tap) of the tile is written, zeros where no chunk added
  float* out = a.out + (long long)split * a.out_size;
  const int tap0 = (dz + 1) * 9;
  auto put = [&](int co, int col, float v) {
    const int ci = cib * CI_TILE + col % CI_TILE;
    if (co < a.cout && ci < a.cin)
      out[((long long)co * a.cin + ci) * 27 + tap0 + col / CI_TILE] = v;
  };
  if constexpr (sizeof(T) == 2) {
    const int wm = warp & 1, wn = warp >> 1;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 9; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put(cob * CO_TILE + wm * 32 + mi * 16 + (lane >> 2) + 8 * (e >> 1),
              wn * 72 + ni * 8 + 2 * (lane & 3) + (e & 1),
              acc[(mi * 9 + ni) * 4 + e]);
  } else {
    const int tm = t >> 4, tn = t & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q2 = 0; q2 < 18; ++q2)
        put(cob * CO_TILE + 4 * tm + i, tn + 16 * q2, acc[i * 18 + q2]);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch_wgrad(const WgArgs& a, int ncob, int split,
                         cudaStream_t s) {
  static bool ready = false;
  auto kernel = conv3d_wgrad_kernel<T>;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<T>::SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((unsigned)(ncob * a.ncib * 3), (unsigned)split);
  kernel<<<grid, kThreads, Geo<T>::SMEM, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dW (cout, cin, 3, 3, 3) float32 from g (n, d, h, w, cout) and the input
// parts (n, d, h, w, c_i), both bfloat16 (bf16 = 1) or float32, with the
// optional prologue (scale, shift, const: (n, cin) float32; pro_slope 1 for
// no activation). The chunks of 16 x 8 (y, x) voxels of each (sample, z)
// slice are split in `split` runs of `per_split`; split > 1 needs the
// float32 workspace `partial` of split * cout * cin * 27 values. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int conv3x3_wgrad(
    const void* g, const void* p0, const void* p1, const void* p2,
    const void* p3, int c0, int c1, int c2, int c3, int nparts,
    const void* pro_scale, const void* pro_shift, const void* pro_const,
    float pro_slope, void* out, void* partial, int n, int d, int h, int w,
    int cout, int split, int per_split, int bf16, void* stream) {
  WgArgs a;
  memset(&a, 0, sizeof(a));
  const void* ps[kMaxParts] = {p0, p1, p2, p3};
  const int cs[kMaxParts] = {c0, c1, c2, c3};
  if (nparts < 1 || nparts > kMaxParts) return (int)cudaErrorInvalidValue;
  const int e = bf16 ? 8 : 4;
  int off = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    const bool used = i < nparts;
    a.part[i] = used ? ps[i] : ps[0];
    a.part_c[i] = used ? cs[i] : 0;
    a.part_off[i] = off;
    a.part_vec[i] = used && cs[i] % e == 0 && off % e == 0 && aligned16(ps[i]);
    if (used) off += cs[i];
  }
  a.nparts = nparts;
  a.g = g;
  a.g_vec = cout % e == 0 && aligned16(g);
  a.pro_scale = static_cast<const float*>(pro_scale);
  a.pro_shift = static_cast<const float*>(pro_shift);
  a.pro_const = static_cast<const float*>(pro_const);
  a.pro_slope = pro_slope;
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.cin = off;
  a.cout = cout;
  a.nyb = (h + PY - 1) / PY;
  a.nxb = (w + PX - 1) / PX;
  a.nchunk = n * d * a.nyb * a.nxb;
  a.per_split = per_split;
  a.ncib = (off + CI_TILE - 1) / CI_TILE;
  a.out_size = (long long)cout * off * 27;
  a.out = static_cast<float*>(split > 1 ? partial : out);
  if (split < 1 || per_split < 1 ||
      (long long)split * per_split < a.nchunk ||
      (split > 1 && partial == nullptr) || (pro_scale && !pro_shift))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.out_size == 0) return (int)cudaSuccess;
  if (a.nchunk == 0)
    return (int)cudaMemsetAsync(out, 0, a.out_size * sizeof(float), s);
  const int ncob = (cout + CO_TILE - 1) / CO_TILE;
  cudaError_t err = bf16 ? launch_wgrad<__nv_bfloat16>(a, ncob, split, s)
                         : launch_wgrad<float>(a, ncob, split, s);
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long blocks = (a.out_size + 255) / 256;
  wgrad_reduce_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                        s>>>(static_cast<const float*>(partial),
                             static_cast<float*>(out), a.out_size, split);
  return (int)cudaGetLastError();
}
