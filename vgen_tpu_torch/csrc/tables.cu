// The table kernels T1 and T2, with a plain C interface for ctypes
// (vgen_tpu_torch/csrc/build.py builds this file with nvcc for sm_90a, in
// parallel with kernels.cu and p2tr.cu; vgen_tpu_torch/ops/fused.py wraps
// the entry points, vgen_tpu_torch/scan/tables.py build_multiples drives
// them).  Each launcher takes the caller's stream, launches without
// synchronising, and returns cudaGetLastError() (0 on success).
//
// Together with kernel G (p2tr.cu batch_inverse_chain) between them, they
// build R rows of multiples [1..count] P_r of affine base points on the
// card: the scan's i*G table (R = 1, P = G, count = B) and the P2TR
// ladder's window table (R windows, P_r = 2^(bits r) G).  They replace the
// JAX package's device build of the i*G table, which runs in XLA outside
// any Pallas kernel: vgen_tpu/scan/tables.py _ig_builder (log-doubling
// under one lax.scan, curve.jacobian_add_affine, then
// curve.batch_jacobian_to_affine) as ig_table_jax drives it.  The JAX
// package builds its ladder table on the host; here the same kernels build
// both.
//
// Kernel T1, table_grow
//   Computes: log-doubling step s (n = 2^s) of every row: column n + i
//   becomes column i + 2^s P_r (Jacobian plus the host's affine 2^s P_r,
//   table_lanes.cuh jacobian_add_affine_full), for i < min(n, count - n),
//   in place in the Jacobian arrays; the lanes that met the point at
//   infinity are counted into a device integer, which the wrapper reads.
//   Bound: 32-bit integer multiply throughput: one lean mixed add (8M +
//   3S) per column built, R (count - 1) in all over the steps, against
//   96 bytes read and 96 written per column.
//   Design: only the columns a step builds are computed (the JAX build ran
//   every step over all columns, a roll and a select, to keep XLA's
//   compile small: steps x count adds where count are needed).  The
//   doubling (column n - 1 at step s, one lane per row and step) is a
//   branch, not a select.  The first steps, at most one block's columns
//   a row, run in one launch of one block per row with a barrier between
//   steps (it also writes column 0, P_r); every later step is one launch
//   of (tiles of the step's width, R) blocks.  The caller picks the block
//   width (fused.TABLE_GROW_BLOCK, at most kThreads) and so the step
//   ranges.  The arrays are read with plain loads: the one-block steps
//   read what the step before wrote.
//
// Kernel T2, table_affine
//   Computes: (x, y) = (X zi^2, Y zi^3) of every column, zi = 1 / Z from
//   kernel G, written straight into the consumer's layout: (8, count)
//   limb-major tx, ty for the i*G table, or the ladder table (R, count +
//   1, 2, 8) with the d = 0 filler rows zeroed, so no transpose follows.
//   Bound: memory: 96 bytes read (X, Y, zi) and 64 written per column
//   against three multiplies and a squaring.
//   Design: one thread per column over a (tiles of count, R) grid.

#include <cuda_runtime.h>

#include "table_lanes.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    table_grow_kernel(uint32_t* X, uint32_t* Y, uint32_t* Z,
                      const uint32_t* __restrict__ bases, long NT, long count,
                      int steps, int s0, int s1, int* __restrict__ infinities) {
  const long r = blockIdx.y;
  if (s0 == 0) {  // column 0: P_r itself (one block per row)
    if (threadIdx.x == 0) vg::table_first_column(X, Y, Z, bases, NT, count,
                                                 steps, r);
    __syncthreads();
  }
  for (int s = s0; s < s1; s++) {
    const long n = 1L << s;
    const long width = n < count - n ? n : count - n;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < width;
         i += (long)gridDim.x * blockDim.x) {
      if (vg::table_grow_lane(X, Y, Z, bases, NT, count, steps, s, r, i) ==
          vg::kInfinity)
        atomicAdd(infinities, 1);
    }
    // the next step reads the columns this one wrote (one block per row)
    if (s + 1 < s1) __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    table_affine_kernel(const uint32_t* __restrict__ X,
                        const uint32_t* __restrict__ Y,
                        const uint32_t* __restrict__ zi,
                        uint32_t* __restrict__ out_x,
                        uint32_t* __restrict__ out_y, long NT, long count,
                        int ladder) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  vg::table_affine_lane(X, Y, zi, out_x, out_y, NT, count, ladder, blockIdx.y,
                        i);
}

}  // namespace

extern "C" {

// Kernel T1: steps [s0, s1) of the log doubling of R rows of count columns.
// X, Y, Z (8, R count) Jacobian, updated in place (the launch with s0 = 0
// first writes column 0); bases (R, steps, 2, 8); infinities a device int
// the lanes that met infinity add to; block the threads a block, a
// multiple of 32 up to kThreads.  The launch with s0 = 0, and one of
// several steps, runs one block per row (the wrapper takes steps together
// while they are at most one block wide); a single later step runs as many
// blocks as its width needs.
int vgen_table_grow(void* X, void* Y, void* Z, const void* bases,
                    void* infinities, int R, int count, int steps, int s0,
                    int s1, int block, void* stream) {
  if (R < 1 || count < 1 || s0 < 0 || s1 <= s0 || s1 > steps || steps > 31 ||
      block < 32 || block > kThreads || block % 32)
    return (int)cudaErrorInvalidValue;
  const long last = 1L << (s1 - 1);
  const long width = last < count - last ? last : count - last;
  if (s0 > 0 && width < 1) return (int)cudaErrorInvalidValue;
  const unsigned tiles = s0 == 0 || s1 - s0 > 1
                             ? 1u
                             : (unsigned)((width + block - 1) / block);
  table_grow_kernel<<<dim3(tiles, (unsigned)R), block, 0,
                      (cudaStream_t)stream>>>(
      (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z, (const uint32_t*)bases,
      (long)R * count, (long)count, steps, s0, s1, (int*)infinities);
  return (int)cudaGetLastError();
}

// Kernel T2.  X, Y, zi (8, R count) -> ladder == 0: tx = out_x, ty = out_y
// (8, count), R = 1; ladder != 0: out_x (R, count + 1, 2, 8), out_y unused.
int vgen_table_affine(const void* X, const void* Y, const void* zi,
                      void* out_x, void* out_y, int R, int count, int ladder,
                      void* stream) {
  if (R < 1 || count < 1 || (!ladder && R != 1))
    return (int)cudaErrorInvalidValue;
  table_affine_kernel<<<dim3((unsigned)((count + kThreads - 1) / kThreads),
                             (unsigned)R),
                        kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)zi,
      (uint32_t*)out_x, (uint32_t*)out_y, (long)R * count, (long)count,
      ladder);
  return (int)cudaGetLastError();
}

}  // extern "C"
