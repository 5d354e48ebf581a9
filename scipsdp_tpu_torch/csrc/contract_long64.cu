// Float64 contraction over a long axis: out[g, j] = sum_f M[(g,) j, f] v[g, f]
// for the refine interior-point tier: the A* contraction of (Rc - X Rp) S^-1
// (static M = A flattened to (mp, K n^2)), G^T w and G dy (per-instance row
// system), and the second half of the Schur matvec, W u (per-instance
// float32 Wall).
//
// Replaces: scipsdp_tpu/ops/df32.py::dd_contract_long (_long_kernel) and
// dd_contract_long_lanes (_contract_long_lanes_kernel), the TPU's grid and
// lanes layouts of one contraction.  Those carried hi/lo float32 pairs with
// TwoProd and a compensated halving tree for ~2^-45 relative accuracy;
// Hopper's native float64 meets that contract directly.
//
// Contract: M is (J, F) ("static", shared by every g) or (G, J, F), float64
// or float32 (upcast exactly on read); v (G, F) and out (G, J) are float64;
// all row-major and contiguous.
//
// What bounds it on an H100: device-memory bandwidth.  A per-instance M
// (Wall at cls_32, B = 32: 36 MB of float32) is read once; a static M (2.2
// MB at cls_32, 17 MB at cls_64) and v (G x F) are read once each, and out
// (G x J) is small.
//
// Per-instance design: one thread block (4 warps) per output row (g, j).
// The 128 threads stride over f, so every read of M's row and of v[g, :]
// is coalesced; each thread keeps a float64 FMA sum, a shuffle tree
// reduces each warp's 32 sums and thread 0 adds the 4 warps'.
//
// Static design (contract_tile.cuh): the F reduction is split over blocks
// (split-K).  Block (c, y, z) owns F-chunk c, 16 P rows j and 8 Q
// instances; its 8 warps split the (16 P x 8 Q) tile and the chunk's
// 16-column slices, each loading its fragments of M and v straight from
// device memory (a stream of independent loads, no barrier) and
// multiplying them on the float64 tensor cores, and add their sums in a
// fixed order.  With one chunk the block's sum is
// out; otherwise it goes to work[c, g, j] (chunks x G x J doubles,
// allocated by the wrapper), and the launch is cooperative
// (cudaLaunchCooperativeKernel: the plan keeps the grid within the SMs):
// after a grid-wide barrier every thread of the grid adds some outputs'
// partials in chunk order.  No floating-point atomics: two launches agree
// bit for bit.  A launch keeps no state outside its own arguments (the
// barrier is the cooperative launch's own), so launches on several
// streams, or graph replays, may overlap.  ops/df32.py::contract_plan
// picks the chunk, P, the fragments a warp and the groups.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "contract_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 16;       // partials the chunk sum loads at once

template <typename T>
__device__ __forceinline__ double load(const T* p, bool ok) {
  return ok ? (double)__ldg(p) : 0.0;
}

// acc[q] += C's 16 x 8 tile of rows m0 .. m0 + 15 (< mlim) of M (row
// stride F) and fragment q (rows g0 + 8 q .. of v, < glim, row stride
// F) over the 16-column slices s0, s0 + ks, ... of [kb, ke), the
// fragments loaded straight from device memory, a slice at a time: more
// slices' loads in flight a warp cost registers, and so blocks an SM,
// and were slower (profile_torch_kernels.py variants contract).
template <typename TM, int QW>
__device__ __forceinline__ void warp_product(
    double (&acc)[QW][4], const TM* __restrict__ M,
    const double* __restrict__ v, long long F, int mlim, int glim, int m0,
    int g0, int kb, int ke, int s0, int ks) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, t = lane & 3;
  const int nsl = (ke - kb + 15) / 16;
  // the lane's two rows of A and, per fragment, its row of B (the
  // fragment's column r)
  const bool mok[2] = {m0 + r < mlim, m0 + r + 8 < mlim};
  const TM* arow[2] = {M + (size_t)(mok[0] ? m0 + r : 0) * F,
                       M + (size_t)(mok[1] ? m0 + r + 8 : 0) * F};
  bool gok[QW];
  const double* brow[QW];
#pragma unroll
  for (int q = 0; q < QW; ++q) {
    const int g = g0 + 8 * q + r;
    gok[q] = g < glim;
    brow[q] = v + (size_t)(g < glim ? g : 0) * F;
  }
  for (int s = s0; s < nsl; s += ks) {
    double a[8], b[QW][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kb + 16 * s + t + 4 * i;
      const bool ok = k < ke;
      a[2 * i] = load(arow[0] + k, ok && mok[0]);
      a[2 * i + 1] = load(arow[1] + k, ok && mok[1]);
#pragma unroll
      for (int q = 0; q < QW; ++q) b[q][i] = load(brow[q] + k, ok && gok[q]);
    }
#pragma unroll
    for (int q = 0; q < QW; ++q) panel::dmma_k16(acc[q], a, b[q]);
  }
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

template <typename TM>
__global__ void contract_long_instance_kernel(const TM* __restrict__ M,
                                              const double* __restrict__ v,
                                              double* __restrict__ out,
                                              int J, int F) {
  __shared__ double red[kWarps];
  const size_t row = blockIdx.x;   // g * J + j
  const TM* Mr = M + row * F;
  const double* vg = v + (row / J) * F;
  double acc = 0.0;
  for (int f = threadIdx.x; f < F; f += kThreads)
    acc = fma((double)Mr[f], vg[f], acc);
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    out[row] = s;
  }
}

template <typename TM, int QW>
__global__ void __launch_bounds__(ctile::kThreads, 2)
contract_long_static_kernel(const TM* __restrict__ M,
                            const double* __restrict__ v,
                            double* __restrict__ out,
                            double* __restrict__ work, int G, int J, int F,
                            int chunk, int lgP, int lgGroups) {
  __shared__ ctile::Red red;
  const ctile::Map w = ctile::warp_map(lgP, lgGroups);
  const int c = blockIdx.x, nc = gridDim.x;
  const int jb = (blockIdx.y << lgP) * 16;
  const int gb = ((blockIdx.z << lgGroups) * QW) * 8;
  const int j0 = jb + 16 * w.panel, g0 = gb + 8 * QW * w.group;
  const int fb = c * chunk, fe = min(F, fb + chunk);
  const bool live = j0 < J && g0 < G;
  double acc[QW][4] = {};
  if (live)
    warp_product<TM, QW>(acc, M, v, F, J, G, j0, g0, fb, fe, w.split, w.ks);
  // the block's sum: out with one chunk, else its partial
  const size_t n = (size_t)G * J;
  double* dst = nc == 1 ? out : work + (size_t)c * n;
  if (ctile::reduce(acc, w, red) && live) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 2, t = lane & 3;
#pragma unroll
    for (int q = 0; q < QW; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + r + 8 * h, g = g0 + 8 * q + 2 * t + e;
          if (j < J && g < G) dst[(size_t)g * J + j] = acc[q][2 * h + e];
        }
  }
  if (nc == 1) return;
  // every partial is written (the barrier orders the grid's stores before
  // the loads below); the grid's threads add each output's partials in
  // chunk order
  cg::this_grid().sync();
  const size_t threads = (size_t)nc * gridDim.y * gridDim.z * blockDim.x;
  const size_t first =
      ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * nc + c) * blockDim.x +
      threadIdx.x;
  for (size_t i = first; i < n; i += threads) {
    double s = 0.0;
    for (int c0 = 0; c0 < nc; c0 += kBatch) {
      double x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        x[u] = c0 + u < nc ? __ldcg(work + (c0 + u) * n + i) : 0.0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (c0 + u < nc) s += x[u];
    }
    out[i] = s;
  }
}

template <typename TM, int QW>
int launch_tiles(const TM* M, const double* v, double* out, double* work,
                 int G, int J, int F, int chunk, int chunks, int lgP,
                 int lgGroups, cudaStream_t s) {
  const int P = 1 << lgP, Q = QW << lgGroups;
  const int py = ((J + 15) / 16 + P - 1) / P, pz = ((G + 7) / 8 + Q - 1) / Q;
  if (chunk < 1 || chunks < 1 || (long long)chunk * chunks < F)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)chunks, (unsigned int)py, (unsigned int)pz);
  auto kernel = contract_long_static_kernel<TM, QW>;
  if (chunks == 1) {
    kernel<<<grid, ctile::kThreads, 0, s>>>(M, v, out, work, G, J, F, chunk,
                                            lgP, lgGroups);
    return (int)cudaGetLastError();
  }
  // split-K: every block of the grid resident at once for its barrier
  void* params[] = {(void*)&M, (void*)&v,     (void*)&out, (void*)&work,
                    (void*)&G, (void*)&J,     (void*)&F,   (void*)&chunk,
                    (void*)&lgP, (void*)&lgGroups};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, grid, dim3(ctile::kThreads), params, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TM>
int launch_static(const TM* M, const double* v, double* out, double* work,
                  int G, int J, int F, int chunk, int chunks, int P, int QW,
                  int groups, cudaStream_t s) {
  const int lgP = ctile::lg2(P), lgGroups = ctile::lg2(groups);
  if ((1 << lgP) != P || (1 << lgGroups) != groups ||
      lgP + lgGroups > ctile::lg2(ctile::kWarps))
    return (int)cudaErrorInvalidValue;
  switch (QW) {
    case 1:
      return launch_tiles<TM, 1>(M, v, out, work, G, J, F, chunk, chunks,
                                 lgP, lgGroups, s);
    case 2:
      return launch_tiles<TM, 2>(M, v, out, work, G, J, F, chunk, chunks,
                                 lgP, lgGroups, s);
    case 4:
      return launch_tiles<TM, 4>(M, v, out, work, G, J, F, chunk, chunks,
                                 lgP, lgGroups, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TM>
int launch(const TM* M, const double* v, double* out, double* work, int G,
           int J, int F, int per_instance, int chunk, int chunks, int P,
           int QW, int groups, cudaStream_t s) {
  if (per_instance) {
    const unsigned int rows = (unsigned int)((long long)G * J);
    contract_long_instance_kernel<TM><<<rows, kThreads, 0, s>>>(
        M, v, out, J, F);
    return (int)cudaGetLastError();
  }
  return launch_static<TM>(M, v, out, work, G, J, F, chunk, chunks, P, QW,
                           groups, s);
}

}  // namespace

// out (G, J) = contraction of M over F with v (G, F).  ``m_f32`` != 0: M is
// float32; ``per_instance`` != 0: M is (G, J, F), else (J, F).  A static M
// takes ops/df32.py::contract_plan's F ``chunk`` and chunk count
// ``chunks`` (chunk * chunks >= F), ``panels`` P, ``frags`` (fragments a
// warp: 1, 2 or 4) and ``groups`` (P groups a power of two <= 8); with
// chunks > 1, ``work`` holds chunks x G x J doubles and the launch is
// cooperative (its grid resident at once).  The per-instance path ignores
// them.  Launched on ``stream`` on the current device; returns the
// launch's CUDA error (0 = launched).
extern "C" int contract_long64_f64(const void* M, const double* v,
                                   double* out, double* work, int G, int J,
                                   int F, int m_f32, int per_instance,
                                   int chunk, int chunks, int panels,
                                   int frags, int groups, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m_f32)
    return launch((const float*)M, v, out, work, G, J, F, per_instance,
                  chunk, chunks, panels, frags, groups, s);
  return launch((const double*)M, v, out, work, G, J, F, per_instance, chunk,
                chunks, panels, frags, groups, s);
}
