// Swin cyclic window shift for Hopper (sm_90a) as a table-driven gather.
//
// Replaces the Pallas TPU kernel diff_unet_tpu/ops/pallas_shift.py
// (_shift_pallas, entry shift_windows_t), which applies the spatial roll by
// -ss to window-partitioned tokens as 8 one-hot routing matmuls on the MXU.
// Here the permutation is an int32 table: for every sample,
//
//     out[b, r, :] = in[b, src[r], :]      r = window * N + token
//
// over (B * nW * N, C) token rows. The inverse shift is the same kernel
// with the table built for -ss. The copy moves bytes only, so the result is
// bit-exact for every dtype.
//
// What bounds it on an H100: it is pure data movement (one read and one
// write of the window tensor plus the table, which stays in L2), so it is
// bound by memory bandwidth. Each thread moves one 16-byte vector of a row
// where the row width allows it, neighbouring threads on neighbouring
// vectors of the same row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void shift_gather_kernel(const V* __restrict__ in,
                                    V* __restrict__ out,
                                    const int* __restrict__ src,
                                    int64_t rows_per_sample,
                                    int64_t total_rows, int vec_per_row) {
  const int64_t total = total_rows * vec_per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t row = idx / vec_per_row;
    const int v = (int)(idx - row * vec_per_row);
    const int64_t sample = row / rows_per_sample;
    const int64_t r = row - sample * rows_per_sample;
    const int64_t from = sample * rows_per_sample + src[r];
    out[idx] = in[from * vec_per_row + v];
  }
}

template <typename V>
cudaError_t launch(const void* in, void* out, const int* src,
                   int64_t rows_per_sample, int64_t total_rows, int row_bytes,
                   cudaStream_t stream) {
  const int vec_per_row = row_bytes / (int)sizeof(V);
  const int64_t total = total_rows * vec_per_row;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  shift_gather_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(in), static_cast<V*>(out), src, rows_per_sample,
      total_rows, vec_per_row);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

}  // namespace

// Rows are row_bytes wide; the widest vector (16, 8, 4, 2 or 1 bytes) that
// divides the row width and both base addresses is used. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int shift_windows_forward(const void* in, void* out,
                                     const void* src,
                                     long long rows_per_sample,
                                     long long total_rows, int row_bytes,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(src);
  if (total_rows == 0) return cudaSuccess;
  auto fits = [&](int a) {
    return row_bytes % a == 0 && aligned(in, a) && aligned(out, a);
  };
  if (fits(16))
    return launch<uint4>(in, out, table, rows_per_sample, total_rows,
                         row_bytes, s);
  if (fits(8))
    return launch<uint2>(in, out, table, rows_per_sample, total_rows,
                         row_bytes, s);
  if (fits(4))
    return launch<uint32_t>(in, out, table, rows_per_sample, total_rows,
                            row_bytes, s);
  if (fits(2))
    return launch<uint16_t>(in, out, table, rows_per_sample, total_rows,
                            row_bytes, s);
  return launch<uint8_t>(in, out, table, rows_per_sample, total_rows,
                         row_bytes, s);
}
