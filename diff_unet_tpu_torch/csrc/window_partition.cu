// Swin window partition (zero padding fused) and its inverse (crop fused)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel benchmarks/pallas_partition_probe.py
// (pallas_partition_t), which reads (1, 7, 49, 49, C) spatial slabs and
// emits the transposed (49, C, 384) window rows of
// diff_unet_tpu/ops/swin.py:window_partition_t, and the XLA relayouts the
// JAX package runs on its Swin path (window_partition_t / window_reverse_t
// with jnp.pad and the crop). The port keeps the (B*nW, N, C) window layout
// with no token padding, so the two kernels are
//
//   partition: out[(b*nW + w)*N + n, :] = x[b, z, y, x, :]  inside the volume
//                                       = 0                 in the pad
//   reverse:   x[b, z, y, x, :] = wt[(b*nW + w)*N + n, :]   inside the volume
//
// with (z, y, x) = (window w of the (gd, gh, gw) grid) * ws + (token n of
// the window), both by index math (no table). The pad is written as zeros
// by the partition and never read by the reverse, so each is the other's
// adjoint: the backward of one launches the other.
//
// What bounds it on an H100: it moves bytes only (each input byte read
// once, each output byte written once), so it is bound by memory bandwidth.
// One block covers a slice of one window's token rows (partition) or of one
// (sample, z) slab of voxels (reverse); each thread copies one 16-byte
// vector of a C-contiguous row where the row width and the base addresses
// allow it, neighbouring threads on neighbouring vectors of a row. The
// window and slab coordinates are decoded once per block from blockIdx.y.
// The copy is bit-exact for every dtype.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geom {
  int b, d, h, w;   // the unpadded volume (partition input, reverse output)
  int gd, gh, gw;   // windows per axis of the padded volume
  int wd, wh, ww;   // window size
};

// grid: x over one window's N * vpr vectors, y = sample * nW + window
template <typename V>
__global__ void partition_kernel(const V* __restrict__ in,
                                 V* __restrict__ out, Geom g, int vpr) {
  const int per_window = g.wd * g.wh * g.ww * vpr;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_window) return;
  const int nw = g.gd * g.gh * g.gw;
  const int row0 = blockIdx.y;                 // sample * nW + window
  const int sample = row0 / nw;
  const int win = row0 - sample * nw;
  const int gx = win % g.gw;
  const int gy = (win / g.gw) % g.gh;
  const int gz = win / (g.gw * g.gh);
  const int tok = i / vpr;
  const int v = i - tok * vpr;
  const int tx = tok % g.ww;
  const int ty = (tok / g.ww) % g.wh;
  const int tz = tok / (g.ww * g.wh);
  const int z = gz * g.wd + tz, y = gy * g.wh + ty, x = gx * g.ww + tx;
  V val{};
  if (z < g.d && y < g.h && x < g.w) {
    const int64_t src = (((int64_t)sample * g.d + z) * g.h + y) * g.w + x;
    val = in[src * vpr + v];
  }
  out[(int64_t)row0 * per_window + i] = val;
}

// grid: x over one (sample, z) slab's h * w * vpr vectors, y = sample * d + z
template <typename V>
__global__ void reverse_kernel(const V* __restrict__ in, V* __restrict__ out,
                               Geom g, int vpr) {
  const int per_slab = g.h * g.w * vpr;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_slab) return;
  const int slab = blockIdx.y;
  const int sample = slab / g.d;
  const int z = slab - sample * g.d;
  const int voxel = i / vpr;
  const int v = i - voxel * vpr;
  const int y = voxel / g.w;
  const int x = voxel - y * g.w;
  const int win = ((z / g.wd) * g.gh + y / g.wh) * g.gw + x / g.ww;
  const int tok = ((z % g.wd) * g.wh + y % g.wh) * g.ww + x % g.ww;
  const int64_t row =
      ((int64_t)sample * g.gd * g.gh * g.gw + win) * (g.wd * g.wh * g.ww) +
      tok;
  out[(int64_t)slab * per_slab + i] = in[row * vpr + v];
}

template <typename V>
cudaError_t launch(bool reverse, const void* in, void* out, const Geom& g,
                   int row_bytes, cudaStream_t stream) {
  const int vpr = row_bytes / (int)sizeof(V);
  if (reverse) {
    const int per_slab = g.h * g.w * vpr;
    dim3 grid((per_slab + kThreads - 1) / kThreads, g.b * g.d);
    reverse_kernel<V><<<grid, kThreads, 0, stream>>>(
        static_cast<const V*>(in), static_cast<V*>(out), g, vpr);
  } else {
    const int per_window = g.wd * g.wh * g.ww * vpr;
    dim3 grid((per_window + kThreads - 1) / kThreads,
              g.b * g.gd * g.gh * g.gw);
    partition_kernel<V><<<grid, kThreads, 0, stream>>>(
        static_cast<const V*>(in), static_cast<V*>(out), g, vpr);
  }
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

// The widest vector (16, 8, 4, 2 or 1 bytes) that divides the row width and
// both base addresses.
cudaError_t dispatch(bool reverse, const void* in, void* out, const Geom& g,
                     int row_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.b == 0 || g.d == 0 || g.h == 0 || g.w == 0 || row_bytes == 0)
    return cudaSuccess;
  auto fits = [&](int a) {
    return row_bytes % a == 0 && aligned(in, a) && aligned(out, a);
  };
  if (fits(16)) return launch<uint4>(reverse, in, out, g, row_bytes, s);
  if (fits(8)) return launch<uint2>(reverse, in, out, g, row_bytes, s);
  if (fits(4)) return launch<uint32_t>(reverse, in, out, g, row_bytes, s);
  if (fits(2)) return launch<uint16_t>(reverse, in, out, g, row_bytes, s);
  return launch<uint8_t>(reverse, in, out, g, row_bytes, s);
}

}  // namespace

// x (b, d, h, w, C) -> windows (b * gd*gh*gw, wd*wh*ww, C); rows are
// row_bytes = C * element size wide. Returns the launch's cudaError_t.
extern "C" int window_partition_forward(const void* in, void* out, int b,
                                        int d, int h, int w, int gd, int gh,
                                        int gw, int wd, int wh, int ww,
                                        int row_bytes, void* stream) {
  const Geom g{b, d, h, w, gd, gh, gw, wd, wh, ww};
  return dispatch(false, in, out, g, row_bytes, stream);
}

// windows (b * gd*gh*gw, wd*wh*ww, C) -> x (b, d, h, w, C), the padded
// volume cropped to (d, h, w).
extern "C" int window_reverse_forward(const void* in, void* out, int b, int d,
                                      int h, int w, int gd, int gh, int gw,
                                      int wd, int wh, int ww, int row_bytes,
                                      void* stream) {
  const Geom g{b, d, h, w, gd, gh, gw, wd, wh, ww};
  return dispatch(true, in, out, g, row_bytes, stream);
}
