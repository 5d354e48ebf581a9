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
// Hopper's native float64 FMA meets that contract directly.
//
// Contract: M is (J, F) ("static", shared by every g) or (G, J, F), float64
// or float32 (upcast exactly on read); v (G, F) and out (G, J) are float64;
// all row-major and contiguous.
//
// What bounds it on an H100: device-memory bandwidth for a per-instance M
// (Wall at cls_32, B = 32: 36 MB of float32, read once); for a static M the
// v reads (G x F doubles) and the reduction latency, since M itself (2.2 MB
// at cls_32) stays in L2.
//
// Design: one thread block (4 warps) per output row (g, j).  The 128
// threads stride over f, so every read of M's row and of v[g, :] is
// coalesced; each thread keeps a float64 FMA sum, a shuffle tree reduces
// each warp's 32 sums and thread 0 adds the 4 warps'.  A static M is tiled
// over g: one block owns kStaticG instances of its row j, so one read of
// M[j, f] serves all of them (cls_64, B = 8: 260 blocks of 130 strides).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStaticG = 4;

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

template <typename TM>
__global__ void contract_long_static_kernel(const TM* __restrict__ M,
                                            const double* __restrict__ v,
                                            double* __restrict__ out,
                                            int G, int J, int F) {
  __shared__ double red[kStaticG][kWarps];
  const int j = blockIdx.x % J;
  const int g0 = (blockIdx.x / J) * kStaticG;
  const int ng = G - g0 < kStaticG ? G - g0 : kStaticG;
  const TM* Mr = M + (size_t)j * F;
  double acc[kStaticG];
#pragma unroll
  for (int i = 0; i < kStaticG; ++i) acc[i] = 0.0;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    const double m = (double)Mr[f];
#pragma unroll
    for (int i = 0; i < kStaticG; ++i)
      if (i < ng) acc[i] = fma(m, v[(size_t)(g0 + i) * F + f], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kStaticG; ++i) {
    const double s = warp_sum(acc[i]);
    if ((threadIdx.x & 31) == 0) red[i][threadIdx.x >> 5] = s;
  }
  __syncthreads();
  if (threadIdx.x < ng) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
    out[(size_t)(g0 + threadIdx.x) * J + j] = s;
  }
}

template <typename TM>
int launch(const TM* M, const double* v, double* out, int G, int J, int F,
           int per_instance, cudaStream_t s) {
  if (per_instance) {
    const unsigned int rows = (unsigned int)((long long)G * J);
    contract_long_instance_kernel<TM><<<rows, kThreads, 0, s>>>(
        M, v, out, J, F);
  } else {
    const unsigned int blocks =
        (unsigned int)((long long)((G + kStaticG - 1) / kStaticG) * J);
    contract_long_static_kernel<TM><<<blocks, kThreads, 0, s>>>(
        M, v, out, G, J, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (G, J) = contraction of M over F with v (G, F).  ``m_f32`` != 0: M is
// float32; ``per_instance`` != 0: M is (G, J, F), else (J, F).  Launched on
// ``stream`` on the current device; returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int contract_long64_f64(const void* M, const double* v,
                                   double* out, int G, int J, int F,
                                   int m_f32, int per_instance,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m_f32)
    return launch((const float*)M, v, out, G, J, F, per_instance, s);
  return launch((const double*)M, v, out, G, J, F, per_instance, s);
}
