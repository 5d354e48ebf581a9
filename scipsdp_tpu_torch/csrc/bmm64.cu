// Batched float64 matrix product C[g] = A[g] B[g] of G square n x n
// matrices: the exact products of the refine interior-point tier (X Rp,
// (Rc - X Rp) S^-1, X dS, X S, dX_a dS_a and the Gondzio trial products).
//
// Replaces: scipsdp_tpu/ops/df32.py::dd_bmm (_bmm_kernel) and
// _dd_bmm_lanes (_bmm_lanes_kernel).  The TPU has no float64, so those
// kernels carried every operand as a float32 hi/lo pair and every
// multiply-add as TwoProd + TwoSum, for ~2^-45 relative accuracy.  Hopper
// has native float64 FMA (one rounding of 2^-53 per multiply-add), which
// meets that contract as it is: no double-single arithmetic here.  (Were
// it written in double-single float32, nvcc's default --fmad=true would
// contract TwoProd/TwoSum away, as XLA:CPU does in tests/test_df32.py.)
//
// Contract: A, B, C are (G, n, n) row-major float64, contiguous; C is
// written completely.  The caller upcasts a float32 operand (the f32-valued
// S^-1 of the tier) exactly before the call.
//
// What bounds it on an H100: little.  The solver's shapes are small
// (n = 65, G = 32: 8.8 M multiply-adds; n = 129, G = 8: 17 M; n = 10,
// G = 1472: 1.5 M) against ~34 TFLOP/s of float64 FMA, and the operands
// (G n^2 doubles, 1.1 MB at n = 65) sit in L2.  The time is launch latency
// and how many blocks are in flight to cover float64 FMA and shared-memory
// latency.
//
// Design: two kernels.
//  * n > 16: one thread block per 32 x 32 output tile of one matrix
//    (grid G x tiles^2: 288 blocks at n = 65, G = 32), 256 threads, each
//    owning a 2 x 2 patch of the tile.  The K loop stages 32 x 32 tiles of
//    A and B in shared memory (padded rows, 16.9 KB); out-of-range
//    elements load as 0, so any n is taken.
//  * n <= 16: many whole matrices per block (1,024 outputs a block: ten
//    matrices at n = 10, so 1,472 matrices make 148 blocks), staged in
//    shared memory, one output per thread per pass.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kSmallN = 16;
constexpr int kSmallOutputs = 1024;   // outputs per block in the small kernel
constexpr int kThreads = 256;

__global__ void bmm64_tiled_kernel(const double* __restrict__ A,
                                   const double* __restrict__ B,
                                   double* __restrict__ C, int n) {
  __shared__ double As[kTile][kTile + 1];
  __shared__ double Bs[kTile][kTile + 1];
  const size_t nn = (size_t)n * n;
  const double* Ag = A + (size_t)blockIdx.x * nn;
  const double* Bg = B + (size_t)blockIdx.x * nn;
  double* Cg = C + (size_t)blockIdx.x * nn;
  const int tiles = (n + kTile - 1) / kTile;
  const int row0 = (blockIdx.y / tiles) * kTile;
  const int col0 = (blockIdx.y % tiles) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  double c00 = 0.0, c01 = 0.0, c10 = 0.0, c11 = 0.0;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile;
      const int c = e - r * kTile;
      const int ar = row0 + r, ac = k0 + c;
      const int br = k0 + r, bc = col0 + c;
      As[r][c] = (ar < n && ac < n) ? Ag[(size_t)ar * n + ac] : 0.0;
      Bs[r][c] = (br < n && bc < n) ? Bg[(size_t)br * n + bc] : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const double a0 = As[ty][k], a1 = As[ty + 16][k];
      const double b0 = Bs[k][tx], b1 = Bs[k][tx + 16];
      c00 = fma(a0, b0, c00);
      c01 = fma(a0, b1, c01);
      c10 = fma(a1, b0, c10);
      c11 = fma(a1, b1, c11);
    }
    __syncthreads();
  }

  const int r0 = row0 + ty, r1 = row0 + ty + 16;
  const int q0 = col0 + tx, q1 = col0 + tx + 16;
  if (r0 < n && q0 < n) Cg[(size_t)r0 * n + q0] = c00;
  if (r0 < n && q1 < n) Cg[(size_t)r0 * n + q1] = c01;
  if (r1 < n && q0 < n) Cg[(size_t)r1 * n + q0] = c10;
  if (r1 < n && q1 < n) Cg[(size_t)r1 * n + q1] = c11;
}

__global__ void bmm64_small_kernel(const double* __restrict__ A,
                                   const double* __restrict__ B,
                                   double* __restrict__ C, long long G,
                                   int n, int per_block) {
  extern __shared__ double smem[];
  const int nn = n * n;
  const long long g0 = (long long)blockIdx.x * per_block;
  const int mats = (int)(G - g0 < per_block ? G - g0 : per_block);
  const int count = mats * nn;
  double* As = smem;
  double* Bs = smem + (size_t)per_block * nn;
  const size_t base = (size_t)g0 * nn;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    As[e] = A[base + e];
    Bs[e] = B[base + e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int m = e / nn;
    const int ij = e - m * nn;
    const int i = ij / n;
    const int j = ij - i * n;
    const double* a = As + m * nn + i * n;
    const double* b = Bs + m * nn + j;
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc = fma(a[k], b[k * n], acc);
    C[base + e] = acc;
  }
}

}  // namespace

// C[g] = A[g] B[g] for g < G, n x n float64, launched on ``stream`` on the
// current device; returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int bmm64_f64(const double* A, const double* B, double* C,
                         long long G, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kSmallN) {
    const int nn = n * n;
    const int per_block = nn >= kSmallOutputs ? 1 : kSmallOutputs / nn;
    const long long blocks = (G + per_block - 1) / per_block;
    const size_t smem = 2 * (size_t)per_block * nn * sizeof(double);
    bmm64_small_kernel<<<(unsigned int)blocks, kThreads, smem, s>>>(
        A, B, C, G, n, per_block);
  } else {
    const int tiles = (n + kTile - 1) / kTile;
    const dim3 grid((unsigned int)G, (unsigned int)(tiles * tiles));
    bmm64_tiled_kernel<<<grid, kThreads, 0, s>>>(A, B, C, n);
  }
  return (int)cudaGetLastError();
}
