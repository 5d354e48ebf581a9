// K1 of the fused Newton direction (refine interior-point tier): for one
// bucket of K blocks of size n,
//   P[b, k]   = (Rc[b, k] - XRp[b, k]) Sinv[b, k]            (n x n x n)
//   out[b, j] = sum_{k, a, c} A[k, j, a, c] P[b, k, a, c]     (A* contraction)
// the Schur right-hand side's block part.  The elementwise contraction is
// tr(A_j P) because every A[k, j] is symmetric.
//
// Replaces: scipsdp_tpu/ops/fused.py::rhs_bucket (_rhs_kernel).  That kernel
// carried every float64 value as a float32 hi/lo pair (the TPU has no
// float64) and ran the product and the contraction as masked fori loops over
// the whole batch in VMEM.  Hopper has native float64, on the FMA pipe and
// on the tensor cores alike, which meets its ~2^-45 contract as it is:
// everything here is float64, and the float32 S^-1 is read as float32 and
// widened exactly.
//
// Contract: A (K, mp, n, n), Rc and XRp (B, K, n, n) float64; Sinv (B, K, n,
// n) float32; P (B, K, n, n) float64 scratch; work: rhs_bucket_work_doubles
// float64 of scratch; out (B, mp) float64, written completely.  All
// row-major and contiguous.  No atomic adds of values: every sum runs in
// one fixed order, so results repeat bit for bit.
//
// What bounds it on an H100: bytes.  A is static, shared by every instance
// and dominates them (cls_32, B = 32, K = 1, n = 65, mp = 66: 2.2 of 4.9
// MB; cls_64, B = 8, n = 129, mp = 130: 17.3 of 20.0 MB), so it is read
// once a launch, never once an instance.  The product is 8.8 M
// multiply-adds at cls_32 and the contraction 9.0 M, a fraction of a
// microsecond on the float64 tensor cores.  So the time is launches,
// copies and L2 round trips: taken apart on the card
// (profile_torch_kernels.py dissect bucket), the 15.7 us of a call at
// cls_32 are two empty launches (3.1), the product's copies into shared
// memory (3.5: one element a copy, since an odd n leaves half the rows off
// a 16-byte boundary), the contraction's loads (3.8) and its tile sums
// (0.8); the products and stores are about 1 each.
//
// Design: two launches, in order on the caller's stream.
//  * product, chosen by n: for n <= 144 a block per 16-row panel of one
//    P[b, k] (160 blocks at cls_32): the panel of D = Rc - XRp and the
//    whole S^-1[b, k] staged in shared memory (one cp.async wait), the
//    product on float64 mma.sync (panel_dmma.cuh), also at n <= 16, where
//    a kernel of FMA chains over many whole matrices a block measured
//    1.2-1.4 times slower; for n > 144 the first design's row panels (a
//    thread a column, S^-1 read from L2 a step at a time).
//    Block 0 also zeroes the contraction's arrival counters.
//  * contraction, the product out (B x mp) = P (B x K n^2) A^T (K n^2 x
//    mp) split over K n^2: a block per (slice of one k's n^2 elements, 8
//    columns j, 32 rows b), kCWarps warps of slice_steps(n^2) m16n8k16
//    steps each (2 to 8: 8 steps and 9 slices a tile at cls_32, 8 and 33
//    at cls_64), both fragments loaded straight from L2 (each fragment row is
//    32 contiguous bytes, a whole sector).  Each element of A is read by
//    one block (for B <= 32).  The warps' partials are added in warp
//    order and stored; the last block of a tile to arrive (an atomic
//    count, no atomic on a value) adds the tile's slice partials in slice
//    order and writes out.

#include <cuda_runtime.h>

#include "panel_dmma.cuh"

namespace {

constexpr int kPanel = 16;            // rows of P per row-panel block
constexpr int kPanelThreads = 256;
constexpr int kCWarps = 4;            // warps of a contraction block
// k16 steps a warp: enough that a tile takes about kSlicesPerTile slices,
// within [kMinSteps, kMaxSteps] (slice_steps).  Each slice costs the
// tile's last block one more partial to add, each step a warp one more
// L2 round trip; 8 slices measured 5 % faster than 16 at cls_32 and the
// same at cls_64 and mkp_10 (profile_torch_kernels.py variants bucket)
constexpr int kMinSteps = 2;
constexpr int kMaxSteps = 8;
constexpr int kSlicesPerTile = 8;
constexpr int kTileB = 32;            // rows b of a contraction tile
constexpr int kTileJ = 8;             // columns j of a contraction tile
constexpr int kTile = kTileB * kTileJ;

__host__ __device__ inline int slice_steps(int nn) {
  const int steps = (nn + 16 * kCWarps * kSlicesPerTile - 1) /
                    (16 * kCWarps * kSlicesPerTile);
  return steps < kMinSteps ? kMinSteps : steps > kMaxSteps ? kMaxSteps : steps;
}

__device__ __forceinline__ void zero_counters(int* counters, int count) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < count; i += blockDim.x) counters[i] = 0;
}

// P[bk, r0 + r, :] = (Rc - XRp)[bk, r0 + r, :] Sinv[bk], n <= 144
__global__ void __launch_bounds__(panel::kThreads)
rhs_product_staged(const double* __restrict__ Rc,
                   const double* __restrict__ XRp,
                   const float* __restrict__ Sinv, double* __restrict__ P,
                   int n, int panels, int* counters, int ncounters) {
  using namespace panel;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = up(n, 16), lda = ld_a(n), ldb = ld_b32(n);
  double* Ds = reinterpret_cast<double*>(smem);          // kRows x lda
  float* Ss = reinterpret_cast<float*>(Ds + kRows * lda);  // kp x ldb
  zero_counters(counters, ncounters);
  const int bk = blockIdx.x / panels;
  const int r0 = (blockIdx.x - bk * panels) * kRows;
  const size_t off = (size_t)bk * n * n;
  stage(Ss, ldb, Sinv + off, n, n, kp, up(n, 8));
  cp_async_commit();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRows; r += kWarps) {
    const bool row_ok = r0 + r < n;
    const double* rc = Rc + off + (size_t)(r0 + r) * n;
    const double* xr = XRp + off + (size_t)(r0 + r) * n;
    for (int c = lane; c < kp; c += 32)
      Ds[r * lda + c] = row_ok && c < n ? rc[c] - xr[c] : 0.0;
  }
  cp_async_wait_all();
  __syncthreads();
  double acc[2][4];
  const int nfrag = up(n, 8) / 8;
  panel_product(acc, Ds, lda, Ss, ldb, kp, nfrag);
  const int warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int q = (warp + kWarps * f) * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= n) continue;
      double* p = P + off + (size_t)r * n;
      if (q < n) p[q] = acc[f][2 * h];
      if (q + 1 < n) p[q + 1] = acc[f][2 * h + 1];
    }
  }
}

// P[bk, r0 + r, c] = sum_m (Rc - XRp)[bk, r0 + r, m] Sinv[bk, m, c], any n
__global__ void rhs_product_panels(const double* __restrict__ Rc,
                                   const double* __restrict__ XRp,
                                   const float* __restrict__ Sinv,
                                   double* __restrict__ P, int n, int panels,
                                   int* counters, int ncounters) {
  extern __shared__ double Ds[];   // kPanel x n
  zero_counters(counters, ncounters);
  const int bk = blockIdx.x / panels;
  const int r0 = (blockIdx.x - bk * panels) * kPanel;
  const int rows = n - r0 < kPanel ? n - r0 : kPanel;
  const size_t off = (size_t)bk * n * n;
  for (int e = threadIdx.x; e < kPanel * n; e += blockDim.x) {
    const int r = e / n;
    const size_t g = off + (size_t)(r0 + r) * n + (e - r * n);
    Ds[e] = r < rows ? Rc[g] - XRp[g] : 0.0;
  }
  __syncthreads();
  const float* S = Sinv + off;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    double acc[kPanel];
#pragma unroll
    for (int r = 0; r < kPanel; ++r) acc[r] = 0.0;
    for (int m = 0; m < n; ++m) {
      const double s = (double)S[(size_t)m * n + c];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) acc[r] = fma(Ds[r * n + m], s, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kPanel; ++r)
      if (r < rows) P[off + (size_t)(r0 + r) * n + c] = acc[r];
  }
}

// out[b0 .. b0 + 32, j0 .. j0 + 8] of sum_{k, e} P[b, k, e] A[k, j, e]:
// this block's slice partial into part, the tile's sum by its last block
__global__ void __launch_bounds__(32 * kCWarps)
rhs_contract(const double* __restrict__ A, const double* __restrict__ P,
             double* __restrict__ part, int* __restrict__ counters,
             double* __restrict__ out, int B, int K, int mp, int nn,
             int spk, int steps) {
  __shared__ double red[kCWarps][kTile];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k = blockIdx.x / spk;
  const int e_warp = ((blockIdx.x - k * spk) * kCWarps + warp) * 16 * steps;
  const int j0 = blockIdx.y * kTileJ, b0 = blockIdx.z * kTileB;
  const long long KN = (long long)K * nn;
  const bool j_ok = j0 + g < mp;
  const double* arow = A + ((size_t)k * mp + (j_ok ? j0 + g : 0)) * nn;
  const double* prow[2][2];
  bool p_ok[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + 16 * m + 8 * h + g;
      p_ok[m][h] = b < B;
      prow[m][h] = P + (size_t)(b < B ? b : 0) * KN + (size_t)k * nn;
    }
  const bool two = b0 + 16 < B;
  double acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[m][v] = 0.0;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    if (e_warp + 16 * s >= nn) break;
    double a[2][8], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e_warp + 16 * s + t + 4 * j;
      const bool e_ok = e < nn;
      b[j] = j_ok && e_ok ? __ldg(arow + e) : 0.0;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[m][2 * j + h] = p_ok[m][h] && e_ok && (m == 0 || two)
                                ? __ldg(prow[m][h] + e)
                                : 0.0;
    }
    panel::dmma_k16(acc[0], a[0], b);
    if (two) panel::dmma_k16(acc[1], a[1], b);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[warp][(16 * m + 8 * h + g) * kTileJ + 2 * t + e] =
            acc[m][2 * h + e];
  __syncthreads();
  const int S = gridDim.x;
  const size_t tile = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  double* tile_part = part + tile * S * kTile;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int b = b0 + i / kTileJ, j = j0 + i % kTileJ;
    if (b >= B || j >= mp) continue;
    double v = red[0][i];
#pragma unroll
    for (int w = 1; w < kCWarps; ++w) v += red[w][i];
    if (S == 1)
      out[(size_t)b * mp + j] = v;
    else
      tile_part[(size_t)blockIdx.x * kTile + i] = v;
  }
  if (S == 1) return;
  // the block's partials, ordered by the barrier, are released by one
  // fence before the count; the last block acquires them after it
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counters + tile, 1) == S - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int b = b0 + i / kTileJ, j = j0 + i % kTileJ;
    if (b >= B || j >= mp) continue;
    const double* q = tile_part + i;
    double v = __ldcg(q);
#pragma unroll 8
    for (int s = 1; s < S; ++s) v += __ldcg(q + (size_t)s * kTile);
    out[(size_t)b * mp + j] = v;
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// float64 elements of rhs_bucket_f64's work: the slice partials of every
// contraction tile, then one int counter a tile
extern "C" long long rhs_bucket_work_doubles(int B, int K, int mp, int n) {
  const int slice = 16 * kCWarps * slice_steps(n * n);
  const long long spk = ((long long)n * n + slice - 1) / slice;
  const long long tiles =
      (long long)((mp + kTileJ - 1) / kTileJ) * ((B + kTileB - 1) / kTileB);
  return tiles * K * spk * kTile + (tiles + 1) / 2;
}

// out (B, mp) = A*-contraction of (Rc - XRp) Sinv, with P and work as
// scratch; both kernels launched on ``stream`` on the current device.
// Returns the first CUDA error of the two launches (0 = both launched).
extern "C" int rhs_bucket_f64(const double* A, const double* Rc,
                              const double* XRp, const float* Sinv, double* P,
                              double* work, double* out, int B, int K, int mp,
                              int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nn = n * n;
  const int steps = slice_steps(nn);
  const int spk = (nn + 16 * kCWarps * steps - 1) / (16 * kCWarps * steps);
  const dim3 grid((unsigned int)(K * spk),
                  (unsigned int)((mp + kTileJ - 1) / kTileJ),
                  (unsigned int)((B + kTileB - 1) / kTileB));
  const int tiles = (int)(grid.y * grid.z);
  const long long G = (long long)B * K;
  int* counters = reinterpret_cast<int*>(
      work + (long long)tiles * grid.x * kTile);
  cudaError_t e;
  if (n <= panel::kMaxN) {
    const int panels = (n + panel::kRows - 1) / panel::kRows;
    const size_t smem = (size_t)panel::kRows * panel::ld_a(n) * sizeof(double) +
                        (size_t)panel::up(n, 16) * panel::ld_b32(n) *
                            sizeof(float);
    e = allow_smem((const void*)rhs_product_staged, smem);
    if (e != cudaSuccess) return (int)e;
    rhs_product_staged<<<(unsigned int)(G * panels), panel::kThreads, smem,
                         s>>>(Rc, XRp, Sinv, P, n, panels, counters, tiles);
  } else {
    const int panels = (n + kPanel - 1) / kPanel;
    const size_t smem = (size_t)kPanel * n * sizeof(double);
    e = allow_smem((const void*)rhs_product_panels, smem);
    if (e != cudaSuccess) return (int)e;
    rhs_product_panels<<<(unsigned int)(G * panels), kPanelThreads, smem,
                         s>>>(Rc, XRp, Sinv, P, n, panels, counters, tiles);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rhs_contract<<<grid, 32 * kCWarps, 0, s>>>(A, P, work, counters, out, B, K,
                                             mp, nn, spk, steps);
  return (int)cudaGetLastError();
}
