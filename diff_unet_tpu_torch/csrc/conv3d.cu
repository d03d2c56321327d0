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
//   out = T(y);  stats[n, 0, co] = sum y;  stats[n, 1, co] = sum y * y
//                                                   (f32 y, over the voxels)
//
// The statistics are reproducible: each output brick (of one sample)
// stores its per-channel partial sums in a slot of its own, and a second
// kernel adds each sample's slots up in slot order. No float atomics, so
// two runs on the same inputs give the same bits.
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
//   two samples, so the statistics take one partial pair per (brick,
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
//   CTA of each tile (an atomic counter) adds them up in split order and
//   runs the epilogue, so the statistics are taken once, from the finished
//   sums.
// - Epilogue from the registers: bias, LeakyReLU, statistics by warp
//   shuffles and a shared-memory reduction, bf16 rounding staged through
//   shared memory for 16-byte coalesced stores.
// At BN 64 (96^3, 48^3) both operands come from shared memory at 4 KB per
// m64n64k16, which is as much as shared memory delivers in the MMA's time:
// that, not HBM, caps those shapes near half the tensor-core peak.
//
// float32 (forward and dgrad) runs the same kernel with 3xTF32 operands
// (Tf32x3Op): each float32 value x is split into big = tf32(x) and small =
// tf32(x - big), both rounded to nearest, ties away (cvt.rna.tf32.f32,
// the low 13 bits cleared), and every product is A_big B_big + A_big
// B_small + A_small B_big, three wgmma.mma_async m64nBNk8 f32.tf32.tf32
// on the tensor cores. Only small * small (under 2^-22 of the product)
// and the rounding of small are lost: about 1e-6 relative, where one TF32
// pass errs by 2^-11. A chunk is 8 channels in the same two 16-byte planes
// a voxel (4 channels each) as bf16's 16, by TMA for parts whose channels
// are multiples of 8 (gathered otherwise); after it arrives the producer
// warps apply the prologue at in-bounds voxels, write big in place and
// small into twin planes 2 * PLANE bytes on (the halo stays 0 in both), so
// a halo stage is 25,600 bytes. The wrapper packs the weights' big and
// small side by side, so a (chunk, dz) weight stage is one bulk copy of
// 2 * 9 * 32 * BN bytes and the small descriptors lie at fixed offsets
// from the big ones: the consumer loop is bf16's, three MMAs a tap, but
// each tap's three make a sum of their own that is added to the brick's
// in float32 once they are done (the tensor cores' adds drop low bits
// toward zero: a longer sum in them drifts from float32's). The doubled
// stages and the second set of sums leave room for one CTA an SM at BN 64
// (three weight stages); the float32 output goes straight from the
// registers.
// What bounds it: three tf32 MMAs of half the bf16 rate for each k8 step,
// from the same shared-memory bytes per MMA as a bf16 k16 step, so 1/6 of
// the bf16 kernel's rate per operation (165 TFLOP/s of float32 work at the
// tensor cores' peak, against 67 for FFMA), and a warpgroup waits for each
// tap's sum (the other one's taps fill the gap, not all of it); the split,
// about 5 instructions a value on the producer warps, once for every halo
// that holds it, is small beside the MMAs of an 8-channel chunk.
//
// int8 (the W8A8 serving path) runs the same kernel, templated on the
// operand type (S8Op against Bf16Op): chunks of 32 int8 channels in the
// same two 16-byte planes a voxel (the 12,800-byte halo tile and the
// (chunk, dz) weight stage keep their bf16 sizes), wgmma.mma_async
// m64nBNk32 s32.s8.s8 into int32 accumulators (for 8-bit types both
// operands K-major in shared memory, as the tile and the pack are), int32
// split partials, and the dequantize epilogue f32(acc) * (sa * sw) + bias
// (or the raw int32 sums). It takes int8 parts (TMA or gathered), or float
// parts that its producer warps quantize on load, as ops/int8.py's
// quantize_act rounds them, after the norm prologue where one is given:
// bf16 parts whose channels are multiples of 32 come by TMA into a staging
// ring of 8-channel quarter chunks, the rest is gathered. It replaces no
// Pallas kernel (the JAX package's ops/int8.py conv_int8 + rescale are
// XLA). What bounds it: with int8 parts the same 54*Cin operations per
// output at twice the bf16 rate, from the same shared-memory bytes per MMA;
// with float parts the producer warps' quantize, which meets each value
// once for every brick halo that holds it (400 halo voxels a 128-voxel
// brick) on 96 threads of the CTA, about 12 instructions a value (23 with
// the prologue).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxParts = 4;

// ------------------------------------------ wgmma path (bf16, s8, 3xTF32)
namespace hw {
// A CTA: two consumer warpgroups, one output z slice of 8 x 8 voxels each,
// and one producer warpgroup; its brick is 2 x 8 x 8 voxels.
constexpr int kConsumers = 256;
constexpr int kCtaThreads = kConsumers + 128;
constexpr int kHaloThreads = 96;         // producer threads on the halo
constexpr int BZ = 2, BY = 8, BX = 8;    // output brick (z, y, x)
constexpr int HZ = BZ + 2, HY = BY + 2, HX = BX + 2;
constexpr int HVOX = HZ * HY * HX;       // halo voxels
constexpr int PLANE = HVOX * 16;         // bytes of one 16-byte-a-voxel plane
constexpr int HALO_BYTES = 2 * PLANE;    // a chunk: 32 bytes of K a voxel
constexpr int kGather = 2;               // gathered voxels in flight
constexpr int HS = 2;                    // halo ring stages
// gathered voxels per producer thread (each fills one plane of its
// voxels), rounded up to whole batches
constexpr int kHaloItems =
    (HVOX + kHaloThreads / 2 * kGather - 1) / (kHaloThreads / 2 * kGather) *
    kGather;
// Where a chunk's halo comes from: gathered by the producer warps; by TMA
// straight into the ring; or (s8 from bf16 parts) by TMA into a staging
// ring of kStSlots quarter chunks (8 bf16 channels, 16 bytes a voxel),
// which the producer warps quantize into the ring's int8 planes.
enum Src { kGathered, kTma, kStaged };
constexpr int kStSlots = 4;
template <class Op, int BN, int SRC>
struct Cfg {
  // two CTAs share an SM at BN 64 (the staged instance too: one CTA an SM
  // with three weight stages and eight staging slots measured slower at
  // every AMOS shape on an H100); 3xTF32's doubled halo and weight stages
  // leave room for one
  static constexpr bool kTwoPerSm = BN == 64 && !Op::kTf32;
  // weight ring stages: where two CTAs share an SM, the staging ring takes
  // the third one's room
  static constexpr int WS = SRC == kStaged && kTwoPerSm ? 2 : 3;
  // a halo stage (3xTF32: the big planes, then the small)
  static constexpr int HALO_STAGE = Op::kParts * HALO_BYTES;
  // the rings, then the epilogue's own buffers (the rings fill for the
  // next brick meanwhile): the staged bf16 output and the statistics'
  // reduction
  static constexpr int ST_BYTES = SRC == kStaged ? kStSlots * PLANE : 0;
  // one (chunk, dz) weight stage
  static constexpr int W_BYTES = Op::kParts * 9 * 32 * BN;
  static constexpr int LDO = BN + 8;                 // staged output row
  static constexpr int OFF_W = HS * HALO_STAGE;
  static constexpr int OFF_ST = OFF_W + WS * W_BYTES;
  static constexpr int OFF_STAGE = OFF_ST + ST_BYTES;
  static constexpr int OFF_RED =
      OFF_STAGE + (Op::kTf32 ? 0 : 64 * BZ * LDO * 2);
  static constexpr int OFF_BAR = OFF_RED + kConsumers / 32 * 2 * BN * 4;
  static constexpr int NBAR =
      3 * HS + 2 * WS + (SRC == kStaged ? 2 * kStSlots : 0);
  static constexpr int SMEM = OFF_BAR + NBAR * 8 + 16;
  static_assert(!kTwoPerSm || 2 * (SMEM + 1024) <= 228 * 1024, "2 CTAs/SM");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};
}  // namespace hw

struct WArgs {
  CUtensorMap map[kMaxParts];   // one 5-D map of each part (TMA)
  const void* part[kMaxParts];
  int part_c[kMaxParts];
  int part_off[kMaxParts];
  int nparts;
  const void* wt;               // (cout_pad / BN, nchunk, 27, 2, BN, 16 B)
  const float* bias;            // (cout) or null
  const float* pro_scale;       // (n, cin) or null: no prologue
  const float* pro_shift;
  const float* pro_const;       // or null
  float pro_slope, act_slope;
  const float* sa;              // s8: () activation scale, or null (raw)
  const float* sw;              // s8: (cout) weight scales
  int out_kind;                 // 0 int32 sums (s8), 1 float32, 2 bf16
  void* out;                    // (n, d, h, w, cout)
  float* stats_part;            // (nbricks, 2, cout) slots, or null
  void* partial;                // split > 1: (tiles, split, 256, BN / 2)
  int* counter;                 // split > 1: (tiles), zeroed
  int n, d, h, w, cin, cout, nchunk, split, per_split, nzb, nyb, nxb;
  int nbricks;                  // n * nzb * nyb * nxb
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(hw::kConsumers) : "memory");
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

// d += A * B for one m64nBNk32 step of int8 operands into int32 sums. For
// 8-bit types wgmma has no transpose: both operands are K-major in shared
// memory, as the halo tile and the weight pack are (a k32 step spans the
// two 16-byte planes, the descriptors' leading-byte offset).
template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A * B for one m64nBNk8 step of tf32 operands (float32 values whose
// low 13 bits are 0) into float32 sums. tf32, like the 8-bit types, has no
// transpose: both operands K-major in shared memory, as the halo tile and
// the pack are (a k8 step spans the two 16-byte planes).
// With `accumulate` 0 the step starts a fresh sum: d = A * B.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da,
                                           uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// The operand types of the wgmma kernel: KC channels a chunk (two planes
// of KC / 2, 16 bytes a voxel each), kParts copies of each operand (3xTF32:
// big and small), the MMA and its accumulator.
struct Bf16Op {
  static constexpr bool kS8 = false;
  static constexpr bool kTf32 = false;
  static constexpr int kParts = 1;
  static constexpr int KC = 16;
  using Acc = float;
  using Acc4 = float4;
  template <int BN>
  __device__ static void mma(float* d, uint64_t da, uint64_t db) {
    wgmma_bf16<BN>(d, da, db);
  }
};
struct S8Op {
  static constexpr bool kS8 = true;
  static constexpr bool kTf32 = false;
  static constexpr int kParts = 1;
  static constexpr int KC = 32;
  using Acc = int;
  using Acc4 = int4;
  template <int BN>
  __device__ static void mma(int* d, uint64_t da, uint64_t db) {
    wgmma_s8<BN>(d, da, db);
  }
};
// 3xTF32: da and db address the big operands; the small halo planes lie
// 2 * PLANE bytes past the big ones and the small weights 9 * 32 * BN
// bytes past theirs (descriptors count 16-byte units). d = the two small
// products, then + the big one, a new sum: the adds truncate at the ulp
// of the sum so far, which the small terms leave small.
struct Tf32x3Op {
  static constexpr bool kS8 = false;
  static constexpr bool kTf32 = true;
  static constexpr int kParts = 2;
  static constexpr int KC = 8;
  using Acc = float;
  using Acc4 = float4;
  template <int BN>
  __device__ static void mma(float* d, uint64_t da, uint64_t db) {
    wgmma_tf32<BN>(d, da + (2 * hw::PLANE >> 4), db, 0);
    wgmma_tf32<BN>(d, da, db + (9 * 32 * BN >> 4), 1);
    wgmma_tf32<BN>(d, da, db, 1);
  }
};

// Index of the barriers in shared memory.
template <int WS>
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
    return base + 8 * (3 * hw::HS + WS + s);
  }
  __device__ uint32_t st_full(int s) const {
    return base + 8 * (3 * hw::HS + 2 * WS + s);
  }
  __device__ uint32_t st_empty(int s) const {
    return base + 8 * (3 * hw::HS + 2 * WS + hw::kStSlots + s);
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

// Whether halo voxel v of brick b lies in the volume.
__device__ __forceinline__ bool halo_inside(const WArgs& a, const Brick& b,
                                            int v, long long* vox) {
  using namespace hw;
  const int hz = v / (HY * HX), r = v - hz * HY * HX, hy = r / HX;
  const int gz = b.z0 - 1 + hz, gy = b.y0 - 1 + hy,
            gx = b.x0 - 1 + r - hy * HX;
  if ((unsigned)gz >= (unsigned)a.d || (unsigned)gy >= (unsigned)a.h ||
      (unsigned)gx >= (unsigned)a.w)
    return false;
  *vox = (((long long)b.n * a.d + gz) * a.h + gy) * a.w + gx;
  return true;
}

// The part that holds concat channel c.
__device__ __forceinline__ int part_of(const WArgs& a, int c) {
  int pi = 0;
#pragma unroll
  for (int i = 1; i < kMaxParts; ++i)
    if (i < a.nparts && c >= a.part_off[i]) pi = i;
  return pi;
}

__device__ __forceinline__ float prologue_f(const WArgs& a, float v, float sc,
                                            float sh, float cs) {
  float u = v * sc + sh;
  u = u >= 0.f ? u : u * a.pro_slope;
  return u + cs;
}

// v rounded to T and back (ATen computes T's arithmetic in float and
// rounds each result to T).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// x[0..3] rounded to T, two at a time (cvt.rn.bf16x2.f32: the scalar
// conversion runs on the slow conversion pipe).
template <typename T>
__device__ __forceinline__ void round4(float* x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[e], x[e + 1]);
      x[e] = __low2float(h);
      x[e + 1] = __high2float(h);
    }
  }
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The activation scale as the quantizer divides by it: s = T(sa) and r =
// RN(1 / s) (bf16 parts, quantize4).
struct QScale {
  float s, r;
};
template <typename T>
__device__ __forceinline__ QScale qscale(float sa) {
  const float s = round_to<T>(sa);
  return QScale{s, __frcp_rn(s)};
}
// A per-(sample, channel) prologue row of four channels: a, b, c.
struct Pro4 {
  float sc[4], sh[4], cs[4];
};
__device__ __forceinline__ Pro4 load_pro4(const WArgs& a, int i, int n) {
  Pro4 p;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool real = e < n;
    p.sc[e] = real ? a.pro_scale[i + e] : 0.f;
    p.sh[e] = real ? a.pro_shift[i + e] : 0.f;
    p.cs[e] = real && a.pro_const ? a.pro_const[i + e] : 0.f;
  }
  return p;
}

// ops/int8.py's quantize_input for four values x of type T, packed as four
// int8 bytes (x[0] lowest). With PRO the prologue T(T(T(x a) + b)
// LeakyReLU) + c), each operation in float and rounded to T, as the tensor
// code rounds it; then clamp(rint(T(x / s)), -127, 127): the float
// quotient rounded once (IEEE division), round half to even. float32 parts
// divide with __fdiv_rn (s > 0). For bf16 parts the quotient is RN(x r) corrected
// once by the exact remainder x - q s (an FMA), 3 instructions instead of
// the division's 10, and still the correctly rounded x / s: x and s have
// 8-bit significands, so an inexact x / s lies at least 2^-9 ulp from any
// midpoint of two floats (its distance is a nonzero integer over
// m_s 2^25, m_s < 2^8), and never on one, while the corrected quotient
// is within about 2^-22 ulp of x / s (r = RN(1 / s) within 2^-24
// relative, the first quotient within 1.5 ulp, the remainder exact), so
// both round alike. (24-bit float32 operands can come within 2^-25 ulp of
// a midpoint: there the correction can round the wrong way.) The first
// quotient is held to +-256 first (beyond, x r may overflow to inf and the
// correction to NaN, and any value there clamps to +-127 all the same).
// The rint is the sum with 1.5 * 2^23 (in [2^23, 2^24) floats are the
// integers, rounded half to even), whose low byte is the int8. The
// intrinsics keep nvcc from contracting a product and a sum into an FMA,
// which would round once where ATen rounds twice.
template <typename T, bool PRO>
__device__ __forceinline__ uint32_t quantize4(float* x, const Pro4& p,
                                              float slope, QScale qs) {
  if constexpr (PRO) {
    float m[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __fmul_rn(x[e], p.sc[e]);
    round4<T>(x);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __fadd_rn(x[e], p.sh[e]);
    round4<T>(x);
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = __fmul_rn(x[e], slope);
    round4<T>(m);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = __fadd_rn(x[e] > 0.f ? x[e] : m[e], p.cs[e]);
    round4<T>(x);
  }
  if constexpr (std::is_same<T, float>::value) {
    // +-0 / s is +-0: zeros (the stems' padding channels) skip the division
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = x[e] == 0.f ? x[e] : __fdiv_rn(x[e], qs.s);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q0 = fminf(fmaxf(__fmul_rn(x[e], qs.r), -256.f), 256.f);
      x[e] = __fmaf_rn(__fmaf_rn(-q0, qs.s, x[e]), qs.r, q0);
    }
    round4<T>(x);
  }
  uint32_t b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    b[e] = __float_as_uint(
        __fadd_rn(fminf(fmaxf(x[e], -127.f), 127.f), 12582912.f));
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// One quarter of an s8 chunk (channels c0 .. c0 + 7), arrived by TMA in
// the staging slot st as 8 bf16 a voxel, quantized into its 8 bytes of
// each voxel's row of the halo ring (dst: the plane, offset to the
// quarter's half of the row): 4 channels of a voxel a thread, their
// prologue row in registers. The halo outside the volume stays 0 (TMA
// fills it with zeros, which the prologue would move), as the JAX package
// pads the quantized input with zeros.
template <bool PRO>
__device__ __forceinline__ void quantize_quarter(const WArgs& a,
                                                 const Brick& b,
                                                 const unsigned char* st,
                                                 unsigned char* dst, int c0,
                                                 QScale qs, int pt) {
  using namespace hw;
  const int g = pt & 1;
  Pro4 p{};
  if constexpr (PRO) p = load_pro4(a, b.n * a.cin + c0 + 4 * g, 4);
#pragma unroll 2
  for (int v = pt >> 1; v < HVOX; v += kHaloThreads / 2) {
    long long vox;
    uint32_t out = 0;
    if (halo_inside(a, b, v, &vox)) {
      const uint2 u = *reinterpret_cast<const uint2*>(st + v * 16 + g * 8);
      float x[4] = {__uint_as_float(u.x << 16),
                    __uint_as_float(u.x & 0xffff0000u),
                    __uint_as_float(u.y << 16),
                    __uint_as_float(u.y & 0xffff0000u)};
      out = quantize4<__nv_bfloat16, PRO>(x, p, a.pro_slope, qs);
    }
    *reinterpret_cast<uint32_t*>(dst + v * 16 + g * 4) = out;
  }
}

// One chunk's bf16 or float32 halo gathered by the producer warps into
// the ring's layout: each thread fills one 16-byte plane row (E = 8 bf16
// or 4 float32 channels) of its voxels. The loads of kGather voxels are
// issued before their stores, so their latencies overlap (more would cost
// registers, and with them the second CTA on the SM). Where the chunk's
// second plane is all padding (Cin <= 2 E j + E: the stems) every thread
// gathers the first plane and the second is zero-filled.
template <typename T>
__device__ __forceinline__ void gather_chunk(const WArgs& a, const Brick& b,
                                             unsigned char* halo, int j,
                                             int pt) {
  using namespace hw;
  constexpr int E = 16 / sizeof(T);
  constexpr int KC = 2 * E;
  const bool one_plane = KC * j + E >= a.cin;
  const int q = one_plane ? 0 : pt & 1;
  const int first = one_plane ? pt : pt >> 1;
  const int step = one_plane ? kHaloThreads : kHaloThreads / 2;
  if (one_plane) {
    for (int v = pt; v < HVOX; v += kHaloThreads)
      *reinterpret_cast<uint4*>(halo + PLANE + v * 16) =
          make_uint4(0, 0, 0, 0);
  }
  for (int k0 = 0; k0 < kHaloItems; k0 += kGather) {
    union {
      uint4 u;
      T e[E];
    } val[kGather];
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int v = first + (k0 + k) * step;
      val[k].u = make_uint4(0, 0, 0, 0);
      long long vox;
      if (v >= HVOX || !halo_inside(a, b, v, &vox)) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = KC * j + E * q + e;
        if (c >= a.cin) break;
        const int pi = part_of(a, c);
        val[k].e[e] = static_cast<const T*>(
            a.part[pi])[vox * a.part_c[pi] + (c - a.part_off[pi])];
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

// x rounded to tf32: to nearest, ties away (cvt.rna.tf32.f32), the low 13
// bits cleared, so that the value does not depend on how the tensor cores
// read them.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// The prologue as the plain version and the conv's backward round it:
// the product and each sum rounded on their own (the intrinsics keep nvcc
// from contracting them into an FMA), so that a LeakyReLU input within
// an ulp of 0 takes the side the backward's recomputation takes.
__device__ __forceinline__ float prologue_rn(float v, float sc, float sh,
                                             float cs, float slope) {
  float u = __fadd_rn(__fmul_rn(v, sc), sh);
  u = u >= 0.f ? u : __fmul_rn(u, slope);
  return __fadd_rn(u, cs);
}

// 3xTF32: plane p (4 float32 channels a voxel) of an arrived chunk split
// in place by the producer thread pt: the prologue at in-bounds voxels
// (padding channels get scale, shift and const 0 and stay 0), then big =
// tf32(u) into the plane and small = tf32(u - big) into its twin 2 * PLANE
// bytes on. Voxels outside the volume get 0 in both (the halo the TMA or
// the gather left 0; the twin plane still holds the last chunk's values).
__device__ __forceinline__ void split_plane(const WArgs& a, const Brick& b,
                                            unsigned char* halo, int j,
                                            int p, int pt) {
  using namespace hw;
  const int c0 = Tf32x3Op::KC * j + 4 * p;
  Pro4 pr{};
  const bool pro = a.pro_scale != nullptr;
  if (pro) pr = load_pro4(a, b.n * a.cin + c0, max(0, min(4, a.cin - c0)));
#pragma unroll 2
  for (int v = pt >> 1; v < HVOX; v += kHaloThreads / 2) {
    long long vox;
    float4* big = reinterpret_cast<float4*>(halo + p * PLANE + v * 16);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (halo_inside(a, b, v, &vox)) {
      const float4 in = *big;
      x[0] = in.x;
      x[1] = in.y;
      x[2] = in.z;
      x[3] = in.w;
      if (pro) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = prologue_rn(x[e], pr.sc[e], pr.sh[e], pr.cs[e],
                             a.pro_slope);
      }
    }
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32_rna(x[e]);
      lo[e] = tf32_rna(x[e] - hi[e]);
    }
    *big = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(halo + (2 + p) * PLANE + v * 16) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// One s8 chunk's halo gathered by the producer warps: 4 channels of a
// voxel a thread (their prologue row in registers, as quantize_quarter
// keeps it), TIn values quantized as quantize_quarter quantizes them (int8
// parts as they are); voxels outside the volume and channels past cin are
// 0. Where the chunk's second plane is all padding (Cin <= 32 j + 16: the
// stems) every thread works on the first and the second is zero-filled; a
// thread whose four channels are all padding writes zeros (the one-channel
// stem: three threads of four).
template <typename TIn, bool PRO>
__device__ __forceinline__ void gather_chunk_s8(const WArgs& a,
                                                const Brick& b,
                                                unsigned char* halo, int j,
                                                QScale qs, int pt) {
  using namespace hw;
  constexpr int KC = S8Op::KC;
  const bool one_plane = KC * j + KC / 2 >= a.cin;
  const int g = pt & 3;
  const int q = one_plane ? 0 : (pt >> 2) & 1;
  const int first = one_plane ? pt >> 2 : pt >> 3;
  const int step = one_plane ? kHaloThreads / 4 : kHaloThreads / 8;
  const int c0 = KC * j + KC / 2 * q + 4 * g;
  if (one_plane) {
    for (int v = pt; v < HVOX; v += kHaloThreads)
      *reinterpret_cast<uint4*>(halo + PLANE + v * 16) =
          make_uint4(0, 0, 0, 0);
  }
  const int nreal = max(0, min(4, a.cin - c0));
  Pro4 p{};
  if constexpr (PRO) p = load_pro4(a, b.n * a.cin + c0, nreal);
#pragma unroll 1
  for (int v = first; v < HVOX; v += step) {
    long long vox;
    uint32_t out = 0;
    if (nreal > 0 && halo_inside(a, b, v, &vox)) {
      TIn x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e, pi = part_of(a, c);
        x[e] = TIn{};
        if (e < nreal)
          x[e] = static_cast<const TIn*>(
              a.part[pi])[vox * a.part_c[pi] + (c - a.part_off[pi])];
      }
      if constexpr (std::is_same<TIn, int8_t>::value) {
        out = __byte_perm(__byte_perm(x[0], x[1], 0x0040),
                          __byte_perm(x[2], x[3], 0x0040), 0x5410);
      } else {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = to_float(x[e]);
        out = quantize4<TIn, PRO>(f, p, a.pro_slope, qs);
        // channels past cin stay 0 (the prologue would move them)
        if (nreal < 4) out &= 0xffffffffu >> (8 * (4 - nreal));
      }
    }
    *reinterpret_cast<uint32_t*>(halo + q * PLANE + v * 16 + 4 * g) = out;
  }
}

// The producer warpgroup. Its last warp streams the weights (lane 0: for
// each chunk of this CTA's split, three (dz) stages of 9 taps) and, from
// bf16 parts into s8, the staging ring (lane 1: each chunk's four quarters,
// as far ahead as the ring has room). The other three warps bring each
// chunk's halo tile (module comment: by TMA, quantized from the staging
// ring, or gathered), apply the bf16 prologue to the arrived tile (3xTF32:
// the prologue and the split) and mark it ready. The streams wait on
// nothing of each other but the ring slots.
template <class Op, int BN, int SRC, typename TIn>
__device__ void produce(const WArgs& a, unsigned char* smem,
                        const Bars<hw::Cfg<Op, BN, SRC>::WS>& bar, int cb,
                        int j0, int j1) {
  using namespace hw;
  using C = Cfg<Op, BN, SRC>;
  constexpr int KC = Op::KC, KP = KC / 2;
  constexpr int WS = C::WS;
  const int pt = threadIdx.x - kConsumers;
  if (SRC == kStaged && pt == kHaloThreads + 1) {
    // quarter u of the walk (brick, chunk, channels 8 (u % 4) ..) into
    // slot u % kStSlots once its last quarter is quantized
    int u = 0;
    for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
      const Brick b = decode_brick(a, brick);
      for (int j = j0; j < j1; ++j) {
        const int pi = part_of(a, KC * j);
        for (int k = 0; k < 4; ++k, ++u) {
          const int su = u % kStSlots;
          mbar_wait(bar.st_empty(su), ((u / kStSlots) & 1) ^ 1);
          mbar_expect_tx(bar.st_full(su), PLANE);
          tma_load_5d(smem_u32(smem + C::OFF_ST + su * PLANE), &a.map[pi],
                      bar.st_full(su), KC * j - a.part_off[pi] + 8 * k,
                      b.x0 - 1, b.y0 - 1, b.z0 - 1, b.n);
        }
      }
    }
    return;
  }
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
                    static_cast<const unsigned char*>(a.wt) +
                        (((long long)cb * a.nchunk + j) * 3 + dz) *
                            C::W_BYTES,
                    C::W_BYTES, bar.w_full(ws));
        }
      }
    }
    return;
  }
  const int p = pt & 1;                 // the plane it fills
  QScale qs{0.f, 0.f};                  // s8 from float parts
  if constexpr (Op::kS8 && !std::is_same<TIn, int8_t>::value)
    qs = qscale<TIn>(*a.sa);
  int hit = 0;
  for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
    const Brick b = decode_brick(a, brick);
    for (int j = j0; j < j1; ++j, ++hit) {
      const int hs = hit % HS;
      const uint32_t hpar = (hit / HS) & 1;
      unsigned char* halo = smem + hs * C::HALO_STAGE;
      if constexpr (SRC == kTma) {
        if (pt == 0) {
          mbar_wait(bar.halo_empty(hs), hpar ^ 1);
          mbar_expect_tx(bar.halo_full(hs), HALO_BYTES);
          const int pi = part_of(a, KC * j);
          const int cl = KC * j - a.part_off[pi];
          for (int q = 0; q < 2; ++q)
            tma_load_5d(smem_u32(halo + q * PLANE), &a.map[pi],
                        bar.halo_full(hs), cl + KP * q, b.x0 - 1, b.y0 - 1,
                        b.z0 - 1, b.n);
        }
        mbar_wait(bar.halo_full(hs), hpar);
      } else if constexpr (SRC == kStaged) {
        mbar_wait(bar.halo_empty(hs), hpar ^ 1);
        for (int k = 0; k < 4; ++k) {
          const int u = 4 * hit + k, su = u % kStSlots;
          mbar_wait(bar.st_full(su), (u / kStSlots) & 1);
          unsigned char* dst = halo + (k >> 1) * PLANE + (k & 1) * 8;
          if (a.pro_scale)
            quantize_quarter<true>(a, b, smem + C::OFF_ST + su * PLANE, dst,
                                   KC * j + 8 * k, qs, pt);
          else
            quantize_quarter<false>(a, b, smem + C::OFF_ST + su * PLANE,
                                    dst, KC * j + 8 * k, qs, pt);
          mbar_arrive(bar.st_empty(su));
        }
      } else {
        mbar_wait(bar.halo_empty(hs), hpar ^ 1);
        if constexpr (Op::kS8) {
          if (a.pro_scale)
            gather_chunk_s8<TIn, true>(a, b, halo, j, qs, pt);
          else
            gather_chunk_s8<TIn, false>(a, b, halo, j, qs, pt);
        } else
          gather_chunk<TIn>(a, b, halo, j, pt);
      }
      if constexpr (Op::kTf32) {
        // other threads gathered the voxels this one rewrites
        if (SRC == kGathered)
          asm volatile("bar.sync 2, %0;" ::"n"(kHaloThreads) : "memory");
        split_plane(a, b, halo, j, p, pt);
      } else if constexpr (!Op::kS8) {
        if (a.pro_scale) {
          // other threads gathered the voxels this one rewrites
          if (SRC == kGathered)
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
            long long vox;
            // the halo outside the volume stays 0
            if (!halo_inside(a, b, v, &vox)) continue;
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
      }
      fence_async_smem();
      mbar_arrive(bar.halo_ready(hs));
    }
  }
}

// The value of output column co from its sum: bf16, acc + bias then the
// LeakyReLU; s8, the dequantize f32(acc) * (sa * sw[co]) + bias[co]
// (ops/int8.py rescale: __int2float_rn, the product sa * sw first,
// __fmul_rn and __fadd_rn, which nvcc may not contract into an FMA).
struct ColumnEpi {
  float scale, bias;
};
template <class Op>
__device__ __forceinline__ ColumnEpi column_epi(const WArgs& a, float sa,
                                                int co) {
  ColumnEpi c{0.f, 0.f};
  if (co < a.cout) {
    if (a.bias) c.bias = a.bias[co];
    if (Op::kS8 && a.sw) c.scale = __fmul_rn(sa, a.sw[co]);
  }
  return c;
}
__device__ __forceinline__ float epi_value(const WArgs& a, float acc,
                                           const ColumnEpi& c) {
  const float v = acc + c.bias;
  return v >= 0.f ? v : v * a.act_slope;
}
__device__ __forceinline__ float epi_value(const WArgs&, int acc,
                                           const ColumnEpi& c) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), c.scale), c.bias);
}

// One CTA walks the bricks blockIdx.x, blockIdx.x + gridDim.x, ... of
// the volume (each 2 x 8 x 8 voxels of one sample) for output channels
// [cb * BN, cb * BN + BN) and channel chunks [j0, j1) of blockIdx.z's
// split; its producers run ahead into the next brick while the consumers
// finish the last one.
template <class Op, int BN, int SRC, typename TIn>
__global__ void __launch_bounds__(hw::kCtaThreads,
                                  hw::Cfg<Op, BN, SRC>::kTwoPerSm ? 2 : 1)
conv3d_wgmma_kernel(const __grid_constant__ WArgs a) {
  using namespace hw;
  using C = Cfg<Op, BN, SRC>;
  using Acc = typename Op::Acc;
  using Acc4 = typename Op::Acc4;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Bars<C::WS> bar{smem_u32(smem + C::OFF_BAR)};
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
    for (int s = 0; s < C::WS; ++s) {
      mbar_init(bar.w_full(s), 1);
      mbar_init(bar.w_empty(s), kConsumers / 32);
    }
    if (SRC == kStaged) {
      for (int s = 0; s < kStSlots; ++s) {
        mbar_init(bar.st_full(s), 1);
        mbar_init(bar.st_empty(s), kHaloThreads);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t >= kConsumers) {
    produce<Op, BN, SRC, TIn>(a, smem, bar, cb, j0, j1);
    return;
  }

  // ---- consumers: warpgroup wg computes output z slice z0 + wg
  const int wg = t >> 7, warp = t >> 5, lane = t & 31;
  const uint32_t halo0 = smem_u32(smem), w0 = smem_u32(smem + C::OFF_W);
  int wit = 0, hit = 0;
  for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
    const Brick b = decode_brick(a, brick);
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // 3xTF32: each tap's three MMAs make a sum of their own, added to acc
    // in float32 (round to nearest) once they are done. The tensor cores
    // align a sum to its largest term and drop the bits below, always
    // toward zero, so a sum kept in them drifts with its MMAs: a stage's
    // 27 (or a brick's) moved y by ~1e-6 of its range, enough to flip a
    // LeakyReLU input within rounding of 0 in the small DiffUNet and move
    // a weight gradient by 1.7e-3 of the model's scale (chip_smoke.py
    // phase 4, H100; tolerance 1e-3). The other warpgroup's taps keep the
    // tensor cores busy while this one waits for its sum (the forward
    // takes ~1.2x).
    float part[Op::kTf32 ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < (Op::kTf32 ? BN / 2 : 1); ++i) part[i] = 0.f;
    int prev_ws = -1, prev_hs = -1;
    for (int j = j0; j < j1; ++j, ++hit) {
      const int hs = hit % HS;
      const uint32_t hpar = (hit / HS) & 1;
      if (SRC == kTma) mbar_wait(bar.halo_full(hs), hpar);
      mbar_wait(bar.halo_ready(hs), hpar);
      const uint32_t hbase = halo0 + hs * C::HALO_STAGE;
      for (int dz = 0; dz < 3; ++dz, ++wit) {
        const int ws = wit % C::WS;
        mbar_wait(bar.w_full(ws), (wit / C::WS) & 1);
        const uint32_t wbase = w0 + ws * C::W_BYTES;
        wgmma_fence();
        // tap's operands: the halo tile at the tap's shift, its weights
        auto desc_a = [&](int tap) {
          return smem_desc(
              hbase + (((wg + dz) * HY + tap / 3) * HX + tap % 3) * 16, PLANE,
              HX * 16);
        };
        auto desc_b = [&](int tap) {
          return smem_desc(wbase + tap * (2 * BN * 16), BN * 16, 128);
        };
        if constexpr (Op::kTf32) {
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            if (tap) wgmma_fence();
            Op::template mma<BN>(part, desc_a(tap), desc_b(tap));
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
              reg_fence(part[i]);
              acc[i] += part[i];
            }
          }
        } else {
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            Op::template mma<BN>(acc, desc_a(tap), desc_b(tap));
          wgmma_commit();
          wgmma_wait<1>();
        }
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
      // partial tiles (f32, or int32 whose sum is exact in any order)
      const long long tile = (long long)cb * a.nbricks + brick;
      Acc* mine = static_cast<Acc*>(a.partial) +
                  ((tile * a.split + split) * kConsumers + t) * (BN / 2);
#pragma unroll
      for (int i = 0; i < BN / 2; i += 4) {
        Acc4 v4;
        v4.x = acc[i];
        v4.y = acc[i + 1];
        v4.z = acc[i + 2];
        v4.w = acc[i + 3];
        *reinterpret_cast<Acc4*>(mine + i) = v4;
      }
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
      // the runs in split order, this CTA's own included, so the sum does
      // not depend on which CTA came last
      const Acc* runs = static_cast<const Acc*>(a.partial) +
                        (tile * a.split * kConsumers + t) * (BN / 2);
      if constexpr (Op::kTf32) {
        // a run's loads all issue before their adds (BN / 8 loads in
        // flight, not one: 3xTF32 splits 8^3 and 4^3 up to 32 ways); the
        // registers of one CTA an SM allow it
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        for (int s = 0; s < a.split; ++s) {
          const Acc* run = runs + (long long)s * kConsumers * (BN / 2);
#pragma unroll
          for (int i = 0; i < BN / 2; i += 4) {
            const Acc4 v = __ldcg(reinterpret_cast<const Acc4*>(run + i));
            acc[i] += v.x;
            acc[i + 1] += v.y;
            acc[i + 2] += v.z;
            acc[i + 3] += v.w;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; i += 4) {
          Acc4 sum;
          sum.x = sum.y = sum.z = sum.w = 0;
          for (int s = 0; s < a.split; ++s) {
            const Acc4 v = __ldcg(reinterpret_cast<const Acc4*>(
                runs + (long long)s * kConsumers * (BN / 2) + i));
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          acc[i] = sum.x;
          acc[i + 1] = sum.y;
          acc[i + 2] = sum.z;
          acc[i + 3] = sum.w;
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
    // the flat output voxel of row0 (row0 + 8 is the next y)
    auto vox0 = [&]() {
      return (((long long)b.n * a.d + zo) * a.h + yo) * a.w + xo;
    };
    __nv_bfloat16* staged =
        reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_STAGE);  // [128][LDO]
    const int row0 = wg * 64 + 16 * w4 + (lane >> 2);
    // bf16 instances always write bf16, 3xTF32 float32: their epilogues
    // have no branch on it
    const int out_kind = Op::kS8 ? a.out_kind : Op::kTf32 ? 1 : 2;
    if (Op::kS8 && out_kind == 0) {
      // the raw int32 sums, straight from the registers
      int* out = static_cast<int*>(a.out) + vox0() * a.cout;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int co = cb * BN + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const bool valid = (i & 2) ? valid1 : valid0;
        if (valid && co < a.cout)
          out[((i & 2) ? (long long)a.w * a.cout : 0) + co] = (int)acc[i];
      }
      continue;
    }
    // the output value (bias, LeakyReLU; s8 the dequantize), the bf16
    // output staged (float32 stored straight from the registers); the
    // statistics of the f32 values summed over the warp's 16 rows of each
    // column by shuffles. The gathered-halo instance reduces each column as
    // it goes (fewer live registers, which it needs for two CTAs an SM
    // without spills); the others keep the partial sums and reduce them
    // together.
    constexpr bool kKeep = SRC != kGathered;
    float* red = reinterpret_cast<float*>(smem + C::OFF_RED);  // [warps][2][BN]
    float sum[kKeep ? BN / 4 : 1], sq[kKeep ? BN / 4 : 1];
    const float sa = Op::kS8 && a.sa ? *a.sa : 0.f;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * jj + 2 * (lane & 3) + q, co = cb * BN + col;
        const ColumnEpi ce = column_epi<Op>(a, sa, co);
        float v0 = epi_value(a, acc[4 * jj + q], ce),
              v1 = epi_value(a, acc[4 * jj + 2 + q], ce);
        if (out_kind == 2) {
          staged[row0 * C::LDO + col] = __float2bfloat16(v0);
          staged[(row0 + 8) * C::LDO + col] = __float2bfloat16(v1);
        } else if (co < a.cout) {
          float* out = static_cast<float*>(a.out) + vox0() * a.cout + co;
          if (valid0) out[0] = v0;
          if (valid1) out[(long long)a.w * a.cout] = v1;
        }
        v0 = valid0 ? v0 : 0.f;
        v1 = valid1 ? v1 : 0.f;
        const int k = kKeep ? 2 * jj + q : 0;
        sum[k] = v0 + v1;
        sq[k] = v0 * v0 + v1 * v1;
        if (!kKeep && a.stats_part) {
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
    if (kKeep && a.stats_part) {
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
    if (a.stats_part && t < BN && cb * BN + t < a.cout) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < kConsumers / 32; ++k) {
        s += red[(2 * k) * BN + t];
        s2 += red[(2 * k + 1) * BN + t];
      }
      const int co = cb * BN + t;
      a.stats_part[(2 * (long long)brick) * a.cout + co] = s;
      a.stats_part[(2 * (long long)brick + 1) * a.cout + co] = s2;
    }
    if (out_kind != 2) continue;
    // 16-byte stores of 8 channels, consecutive threads along a voxel's row
    const bool vec = a.cout % 8 == 0;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
    for (int idx = t; idx < 64 * BZ * (BN / 8); idx += kConsumers) {
      const int r = idx / (BN / 8), cc = (idx % (BN / 8)) * 8;
      const int z = b.z0 + r / 64, y = b.y0 + (r % 64) / 8, x = b.x0 + r % 8;
      const int co = cb * BN + cc;
      if (z >= a.d || y >= a.h || x >= a.w || co >= a.cout) continue;
      __nv_bfloat16* dst =
          out + ((((long long)b.n * a.d + z) * a.h + y) * a.w + x) * a.cout +
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

// stats[n, :, co] from the slots of sample n, summed in slot order: 32
// groups of a block each add every 32nd slot, then one thread adds the
// groups in order. Sample n's slots are its bricks n * per .. n * per +
// per - 1.
constexpr int kReduceGroups = 32;
__global__ void __launch_bounds__(32 * kReduceGroups)
stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ stats,
                    int cout, int per) {
  const int n = blockIdx.y, lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int co = blockIdx.x * 32 + lane;
  const long long lo = (long long)n * per, hi = lo + per - 1;
  float s = 0.f, s2 = 0.f;
  if (co < cout) {
    for (long long i = lo + g; i <= hi; i += kReduceGroups) {
      s += __ldg(part + (2 * i) * cout + co);
      s2 += __ldg(part + (2 * i + 1) * cout + co);
    }
  }
  __shared__ float red[2][kReduceGroups][33];
  red[0][g][lane] = s;
  red[1][g][lane] = s2;
  __syncthreads();
  if (g == 0 && co < cout) {
    for (int k = 1; k < kReduceGroups; ++k) {
      s += red[0][k][lane];
      s2 += red[1][k][lane];
    }
    stats[(2LL * n) * cout + co] = s;
    stats[(2LL * n + 1) * cout + co] = s2;
  }
}

cudaError_t reduce_stats(const WArgs& a, const void* stats, cudaStream_t s) {
  const dim3 grid((unsigned)((a.cout + 31) / 32), (unsigned)a.n);
  stats_reduce_kernel<<<grid, 32 * kReduceGroups, 0, s>>>(
      a.stats_part, static_cast<float*>(const_cast<void*>(stats)), a.cout,
      a.nzb * a.nyb * a.nxb);
  return cudaGetLastError();
}

// Persistent CTAs: as many as fit on the card at once (two per SM at BN
// 64), shared by the (Cout block, split) pairs, each walking its share of
// the bricks. A small grid gets a CTA for each brick instead: its few
// waves would leave SMs idle in the last one.
constexpr int kPersistWaves = 8;
template <class Op, int BN, int SRC, typename TIn>
cudaError_t launch_wgmma(const WArgs& a, int ncb, cudaStream_t s) {
  using C = hw::Cfg<Op, BN, SRC>;
  static int sms = 0;
  auto kernel = conv3d_wgmma_kernel<Op, BN, SRC, TIn>;
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

// The wgmma kernels' common arguments: the parts (tensor maps with a box
// of `box` channels of `type`, elem bytes each, where tma), weights,
// geometry and split. Returns cudaSuccess or cudaErrorInvalidValue.
cudaError_t setup_wgmma(WArgs& a, const void* const* ps, const int* cs,
                        int nparts, int kc, int tma, int elem,
                        CUtensorMapDataType type, int box, const void* wt,
                        const void* bias, void* out, void* stats,
                        void* stats_part, void* partial, void* counter,
                        int n, int d, int h, int w, int cout, int bn,
                        int nchunk, int split, int per_split) {
  memset(&a, 0, sizeof(a));
  if (nparts < 1 || nparts > kMaxParts || (bn != 64 && bn != 128))
    return cudaErrorInvalidValue;
  int off = 0;
  for (int i = 0; i < nparts; ++i) {
    a.part[i] = ps[i];
    a.part_c[i] = cs[i];
    a.part_off[i] = off;
    off += cs[i];
    if (tma && (cs[i] % kc || !aligned16(ps[i])))
      return cudaErrorInvalidValue;
  }
  for (int i = nparts; i < kMaxParts; ++i) a.part_off[i] = off;
  a.nparts = nparts;
  a.wt = wt;
  a.bias = static_cast<const float*>(bias);
  a.pro_slope = a.act_slope = 1.f;
  a.out = out;
  a.stats_part = static_cast<float*>(stats_part);
  a.partial = partial;
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
  if (nchunk * kc < off || split < 1 || per_split < 1 ||
      (long long)split * per_split < nchunk ||
      (split > 1 && (partial == nullptr || counter == nullptr)) ||
      (stats == nullptr) != (stats_part == nullptr))
    return cudaErrorInvalidValue;
  if (tma && (long long)n * d * h * w > 0) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    for (int i = 0; i < nparts; ++i) {
      const cuuint64_t c = (cuuint64_t)cs[i];
      const cuuint64_t dims[5] = {c, (cuuint64_t)w, (cuuint64_t)h,
                                  (cuuint64_t)d, (cuuint64_t)n};
      const cuuint64_t strides[4] = {c * elem, c * elem * w,
                                     c * elem * w * h, c * elem * w * h * d};
      const cuuint32_t boxd[5] = {(cuuint32_t)box, hw::HX, hw::HY, hw::HZ, 1};
      const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
      const CUresult r = encode(
          &a.map[i], type, 5, const_cast<void*>(ps[i]), dims, strides, boxd,
          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

template <class Op, int SRC, typename TIn>
cudaError_t launch_bn(const WArgs& a, int bn, cudaStream_t s) {
  const int ncb = (a.cout + bn - 1) / bn;
  return bn == 64 ? launch_wgmma<Op, 64, SRC, TIn>(a, ncb, s)
                  : launch_wgmma<Op, 128, SRC, TIn>(a, ncb, s);
}

}  // namespace

// bfloat16 (wgmma; f32 0) and float32 (3xTF32 wgmma; f32 1). wt is packed
// as (cout_pad / bn, nchunk, 27, 2, bn, 8) bfloat16 with nchunk = ceil(cin
// / 16), or as (cout_pad / bn, nchunk, 3, 2, 9, 2, bn, 4) float32 with
// nchunk = ceil(cin / 8): the tf32 big and small halves of each (chunk,
// dz) stage side by side; zero padding; bn is 64 or 128; the chunks are
// split in `split` runs of `per_split` (split > 1 needs the partial
// workspace and zeroed counters, sized from the grid). tma 1: every part's
// channels are a multiple of the chunk (16 or 8) and its pointer 16-byte
// aligned, so the halo comes by TMA; 0: the producer warps gather it.
// stats (n, 2, cout) needs stats_part, (bricks, 2, cout) f32 slots.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int conv3x3_wgmma_forward(
    int f32, const void* p0, const void* p1, const void* p2, const void* p3,
    int c0, int c1, int c2, int c3, int nparts, const void* wt,
    const void* bias, const void* pro_scale, const void* pro_shift,
    const void* pro_const, float pro_slope, float act_slope, void* out,
    void* stats, void* stats_part, void* partial, void* counter, int n,
    int d, int h, int w, int cout, int bn, int nchunk, int split,
    int per_split, int tma, void* stream) {
  WArgs a;   // holds four 64-byte-aligned tensor maps
  const void* ps[kMaxParts] = {p0, p1, p2, p3};
  const int cs[kMaxParts] = {c0, c1, c2, c3};
  cudaError_t err =
      f32 ? setup_wgmma(a, ps, cs, nparts, Tf32x3Op::KC, tma, 4,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, wt, bias, out,
                        stats, stats_part, partial, counter, n, d, h, w,
                        cout, bn, nchunk, split, per_split)
          : setup_wgmma(a, ps, cs, nparts, Bf16Op::KC, tma, 2,
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 8, wt, bias, out,
                        stats, stats_part, partial, counter, n, d, h, w,
                        cout, bn, nchunk, split, per_split);
  if (err != cudaSuccess) return (int)err;
  a.pro_scale = static_cast<const float*>(pro_scale);
  a.pro_shift = static_cast<const float*>(pro_shift);
  a.pro_const = static_cast<const float*>(pro_const);
  a.pro_slope = pro_slope;
  a.act_slope = act_slope;
  a.out_kind = f32 ? 1 : 2;
  if ((long long)n * d * h * w == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 3xTF32 keeps a tap's sums beside the brick's: Cout blocks of 64
  const int ncb = (cout + 63) / 64;
  if (f32 && bn != 64) return (int)cudaErrorInvalidValue;
  if (f32)
    err = tma ? launch_wgmma<Tf32x3Op, 64, hw::kTma, float>(a, ncb, s)
              : launch_wgmma<Tf32x3Op, 64, hw::kGathered, float>(a, ncb, s);
  else
    err = tma ? launch_bn<Bf16Op, hw::kTma, __nv_bfloat16>(a, bn, s)
              : launch_bn<Bf16Op, hw::kGathered, __nv_bfloat16>(a, bn, s);
  if (err == cudaSuccess && stats != nullptr) err = reduce_stats(a, stats, s);
  return (int)err;
}

// W8A8 int8 (wgmma s8) on the bf16 kernel's design. in_kind 0: int8 parts;
// 1 bfloat16 and 2 float32 parts, quantized on load with the activation
// scale sa (a device scalar), after the prologue where pro_scale is given
// ((n, cin) rows of a, b and c, rounded to the parts' type, and the slope).
// wt is packed as (cout_pad / bn, nchunk, 27, 2, bn, 16) int8 with nchunk =
// ceil(cin / 32), zero padded. out_kind 0: out is the raw int32 sums (sw,
// bias, stats unused); 1 float32, 2 bfloat16: f32(acc) * (sa * sw[co]) +
// bias[co]. tma 1: every part's channels are a multiple of 32 and its
// pointer 16-byte aligned (int8 or bfloat16 parts), 0: gathered. split,
// partial, counter, stats and stats_part as for bfloat16 (the partials are
// int32). Returns the cudaError_t of the launches (0 on success).
extern "C" int conv3x3_s8_forward(
    const void* p0, const void* p1, const void* p2, const void* p3, int c0,
    int c1, int c2, int c3, int nparts, int in_kind, const void* wt,
    const void* sa, const void* sw, const void* bias, const void* pro_scale,
    const void* pro_shift, const void* pro_const, float pro_slope,
    int out_kind, void* out, void* stats, void* stats_part, void* partial,
    void* counter, int n, int d, int h, int w, int cout, int bn, int nchunk,
    int split, int per_split, int tma, void* stream) {
  WArgs a;
  const void* ps[kMaxParts] = {p0, p1, p2, p3};
  const int cs[kMaxParts] = {c0, c1, c2, c3};
  if (in_kind < 0 || in_kind > 2 || out_kind < 0 || out_kind > 2 ||
      (in_kind == 2 && tma) || (out_kind == 0 && stats != nullptr) ||
      (out_kind != 0 && (sa == nullptr || sw == nullptr)) ||
      (in_kind != 0 && sa == nullptr) ||
      (pro_scale != nullptr && (in_kind == 0 || pro_shift == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = setup_wgmma(
      a, ps, cs, nparts, S8Op::KC, tma, in_kind == 1 ? 2 : 1,
      in_kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      in_kind == 1 ? 8 : 16, wt, bias, out, stats, stats_part, partial,
      counter, n, d, h, w, cout, bn, nchunk, split, per_split);
  if (err != cudaSuccess) return (int)err;
  a.sa = static_cast<const float*>(sa);
  a.sw = static_cast<const float*>(sw);
  a.pro_scale = static_cast<const float*>(pro_scale);
  a.pro_shift = static_cast<const float*>(pro_shift);
  a.pro_const = static_cast<const float*>(pro_const);
  a.pro_slope = pro_slope;
  a.out_kind = out_kind;
  if ((long long)n * d * h * w == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == 0)
    err = tma ? launch_bn<S8Op, hw::kTma, int8_t>(a, bn, s)
              : launch_bn<S8Op, hw::kGathered, int8_t>(a, bn, s);
  else if (in_kind == 1)
    err = tma ? launch_bn<S8Op, hw::kStaged, __nv_bfloat16>(a, bn, s)
              : launch_bn<S8Op, hw::kGathered, __nv_bfloat16>(a, bn, s);
  else
    err = launch_bn<S8Op, hw::kGathered, float>(a, bn, s);
  if (err == cudaSuccess && stats != nullptr) err = reduce_stats(a, stats, s);
  return (int)err;
}
