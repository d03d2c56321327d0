// Exact 3D Euclidean distance transform (Felzenszwalb & Huttenlocher,
// "Distance Transforms of Sampled Functions", separable parabola method),
// with anisotropic voxel spacing. A host routine, not a GPU kernel.
//
// A copy of diff_unet_tpu/native/edt.cpp's edt3d: the surface distances of
// HD95 and the average surface distances (metrics/metrics.py) run on it.
// It matches scipy.ndimage.distance_transform_edt's semantics: for every
// non-zero voxel, the Euclidean distance to the nearest zero voxel.
//
// "No background anywhere" yields LARGE (~1e10) distances, as the JAX
// package's copy does.
//
// Built by ops/edt.py: g++ -O3 -shared -fPIC -o libdut_edt_<hash>.so edt.cpp
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Large finite sentinel: squared distances in volumes up to ~10^4 voxels
// per axis stay far below it, so envelope intersections remain exact.
constexpr float BIG = 1e20f;

// 1D squared distance transform over sampled parabolas at positions x*s.
// Envelope bookkeeping in double so the ±1e30 sentinels bound any
// intersection magnitude reachable with float inputs.
void dt1d(const float* f, float* d, int n, float s, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -1e30;
  z[1] = +1e30;
  const double s2 = (double)s * s;
  // Parabolas live at positions p*s: f[p] + (x - p*s)^2 intersects
  // f[q] + (x - q*s)^2 at x = (f[q]+s^2 q^2 - f[p] - s^2 p^2) / (2 s (q-p)).
  auto intersect = [&](int q, int p) -> double {
    return (((double)f[q] + s2 * q * q) - ((double)f[p] + s2 * p * p)) /
           (2.0 * (double)s * (q - p));
  };
  for (int q = 1; q < n; ++q) {
    double sq = intersect(q, v[k]);
    while (sq <= z[k]) {
      --k;
      sq = intersect(q, v[k]);
    }
    ++k;
    v[k] = q;
    z[k] = sq;
    z[k + 1] = +1e30;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    const double pos = (double)s * q;
    while (z[k + 1] < pos) ++k;
    const int p = v[k];
    const float dx = s * (q - p);
    d[q] = dx * dx + f[p];
  }
}

}  // namespace

extern "C" {

// mask: nx*ny*nz uint8 (C order, z fastest); out: float32 distances.
void edt3d(const uint8_t* mask, float* out,
           int nx, int ny, int nz,
           float sx, float sy, float sz) {
  const long n = (long)nx * ny * nz;
  for (long i = 0; i < n; ++i) out[i] = mask[i] ? BIG : 0.0f;

  const int nmax = nx > ny ? (nx > nz ? nx : nz) : (ny > nz ? ny : nz);
  std::vector<float> f(nmax), d(nmax);
  std::vector<double> z(nmax + 1);
  std::vector<int> v(nmax);

  // pass along z (contiguous)
  for (int x = 0; x < nx; ++x)
    for (int y = 0; y < ny; ++y) {
      float* row = out + ((long)x * ny + y) * nz;
      std::memcpy(f.data(), row, nz * sizeof(float));
      dt1d(f.data(), row, nz, sz, v.data(), z.data());
    }
  // pass along y
  for (int x = 0; x < nx; ++x)
    for (int zi = 0; zi < nz; ++zi) {
      float* base = out + (long)x * ny * nz + zi;
      for (int y = 0; y < ny; ++y) f[y] = base[(long)y * nz];
      dt1d(f.data(), d.data(), ny, sy, v.data(), z.data());
      for (int y = 0; y < ny; ++y) base[(long)y * nz] = d[y];
    }
  // pass along x
  for (int y = 0; y < ny; ++y)
    for (int zi = 0; zi < nz; ++zi) {
      float* base = out + (long)y * nz + zi;
      for (int x = 0; x < nx; ++x) f[x] = base[(long)x * ny * nz];
      dt1d(f.data(), d.data(), nx, sx, v.data(), z.data());
      for (int x = 0; x < nx; ++x) base[(long)x * ny * nz] = d[x];
    }
  for (long i = 0; i < n; ++i) out[i] = std::sqrt(out[i]);
}

}  // extern "C"
