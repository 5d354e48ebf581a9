// Float64 contraction over a short axis: out[g, f] = sum_j M[(g,) j, f] v[g, j]
// for the refine interior-point tier: A(dy) (static M = A flattened to
// (mp, K n^2)) and the first half of the Schur matvec, W^T v (per-instance
// M = the float32 feature matrix Wall, (G, mp, K n^2 + P)).
//
// Replaces: scipsdp_tpu/ops/df32.py::dd_contract_short (_short_kernel) and
// dd_contract_short_lanes (_contract_short_lanes_kernel), the TPU's grid
// and lanes layouts of one contraction.  Those carried hi/lo float32 pairs
// with TwoProd/TwoSum for ~2^-45 relative accuracy; Hopper's native
// float64 FMA meets that contract directly.
//
// Contract: M is (J, F) ("static", shared by every g) or (G, J, F), float64
// or float32 (read as float32 and upcast exactly, so the bandwidth-bound
// matvec over Wall reads half the bytes); v (G, J) and out (G, F) are
// float64; all row-major and contiguous.
//
// What bounds it on an H100: device-memory bandwidth.  Per-instance M is
// read once (Wall at cls_32, B = 32: 32 x 66 x 4290 float32 = 36 MB, ~11 us
// at 3.35 TB/s); 2 FLOP per element of M.
//
// Design: one thread per output (g, f); a warp's 32 threads take 32
// consecutive f, so every read of a row of M is coalesced, and v[g, j] is
// the same address for the whole warp (a broadcast).  The J loop is a
// float64 FMA chain.  A static M is tiled over g: one thread owns kStaticG
// consecutive g of its column f, so one read of M[j, f] serves all of them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStaticG = 4;

template <typename TM>
__global__ void contract_short_instance_kernel(const TM* __restrict__ M,
                                               const double* __restrict__ v,
                                               double* __restrict__ out,
                                               int J, int F) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  const size_t g = blockIdx.y;
  const TM* Mg = M + g * J * F + f;
  const double* vg = v + g * J;
  double acc = 0.0;
  for (int j = 0; j < J; ++j)
    acc = fma((double)Mg[(size_t)j * F], vg[j], acc);
  out[g * F + f] = acc;
}

template <typename TM>
__global__ void contract_short_static_kernel(const TM* __restrict__ M,
                                             const double* __restrict__ v,
                                             double* __restrict__ out,
                                             int G, int J, int F) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  const int g0 = blockIdx.y * kStaticG;
  const int ng = G - g0 < kStaticG ? G - g0 : kStaticG;
  double acc[kStaticG];
#pragma unroll
  for (int i = 0; i < kStaticG; ++i) acc[i] = 0.0;
  for (int j = 0; j < J; ++j) {
    const double m = (double)M[(size_t)j * F + f];
#pragma unroll
    for (int i = 0; i < kStaticG; ++i)
      if (i < ng) acc[i] = fma(m, v[(size_t)(g0 + i) * J + j], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kStaticG; ++i)
    if (i < ng) out[(size_t)(g0 + i) * F + f] = acc[i];
}

template <typename TM>
int launch(const TM* M, const double* v, double* out, int G, int J, int F,
           int per_instance, cudaStream_t s) {
  const unsigned int fb = (unsigned int)((F + kThreads - 1) / kThreads);
  if (per_instance) {
    contract_short_instance_kernel<TM>
        <<<dim3(fb, (unsigned int)G), kThreads, 0, s>>>(M, v, out, J, F);
  } else {
    const unsigned int gb = (unsigned int)((G + kStaticG - 1) / kStaticG);
    contract_short_static_kernel<TM>
        <<<dim3(fb, gb), kThreads, 0, s>>>(M, v, out, G, J, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (G, F) = contraction of M over J with v (G, J).  ``m_f32`` != 0: M is
// float32; ``per_instance`` != 0: M is (G, J, F), else (J, F).  Launched on
// ``stream`` on the current device; returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int contract_short64_f64(const void* M, const double* v,
                                    double* out, int G, int J, int F,
                                    int m_f32, int per_instance,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m_f32)
    return launch((const float*)M, v, out, G, J, F, per_instance, s);
  return launch((const double*)M, v, out, G, J, F, per_instance, s);
}
