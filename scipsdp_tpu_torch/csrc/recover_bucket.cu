// K3 of the fused Newton direction (refine interior-point tier): for one
// bucket of K blocks of size n,
//   dS[b, k] = pad (sum_j A[k, j] dy[b, j] + Rp[b, k])
//   dX[b, k] = pad ((Rc[b, k] - X[b, k] dS[b, k]) Sinv[b, k])
// dX is not symmetrized: the caller applies sym().
//
// Replaces: scipsdp_tpu/ops/fused.py::recover_bucket (_recover_kernel).  That
// kernel carried float64 as float32 hi/lo pairs and ran A(dy) and the two
// chained products as masked fori loops over the batch in VMEM.  Hopper's
// native float64 FMA meets its ~2^-45 contract as it is; the float32 S^-1 is
// read as float32 and upcast in registers.
//
// Contract: A (K, mp, n, n), Rp, Rc, X (B, K, n, n) float64; dy (B, mp)
// float64; Sinv (B, K, n, n) float32; pad bytes (0/1), (K, n, n) shared by
// every b or (B, K, n, n) per instance; dS, dX (B, K, n, n) float64, written
// completely (0 where pad is 0).  All row-major and contiguous.  No
// atomics: every output is summed by one thread in a fixed order.
//
// What bounds it on an H100: at the main path (cls_32, B = 32, K = 1,
// n = 65, mp = 66) A(dy) is 8.9 M multiply-adds and each product 8.8 M;
// the operands sit in L2.  Launch latency and blocks in flight.
//
// Design: two launches of this source, in order on the caller's stream.
//  * dS: one thread per (k, a, c) and group of 4 instances (136 blocks of
//    256 at the main path): the thread walks j, so one read of A[k, j, a,
//    c] (coalesced across the block) serves 4 instances; dy[b, j] is the
//    same address for the whole warp.
//  * dX: one block per 16-row panel of one (b, k) (160 blocks at the main
//    path).  The three n x n float64 tiles of X dS and T S^-1 do not fit
//    one block at n = 129, and need not: the panel of X is staged in
//    shared memory, T = Rc - X dS is formed panel-wide into a second
//    shared buffer (256 n bytes in all, any n up to 900), then T S^-1 is
//    written out.  Each thread owns one column and keeps 16 float64 sums;
//    dS[:, c] and S^-1[:, c] are read once per block, coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kPanel = 16;     // rows of dX per block
constexpr int kGroup = 4;      // instances per dS thread
constexpr int kThreads = 256;

int panel_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < kThreads ? t : kThreads;
}

// dS[b, k, e] = pad ? sum_j A[k, j, e] dy[b, j] + Rp[b, k, e] : 0
__global__ void recover_ds_kernel(const double* __restrict__ A,
                                  const double* __restrict__ dy,
                                  const double* __restrict__ Rp,
                                  const unsigned char* __restrict__ pad,
                                  int pad_per_instance,
                                  double* __restrict__ dS, int B, int K,
                                  int mp, int nn) {
  const long long KE = (long long)K * nn;
  const long long ke = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ke >= KE) return;
  const int b0 = blockIdx.y * kGroup;
  const int ng = B - b0 < kGroup ? B - b0 : kGroup;
  const long long k = ke / nn;
  const double* Ak = A + (size_t)k * mp * nn + (ke - k * nn);
  double acc[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = 0.0;
  for (int j = 0; j < mp; ++j) {
    const double a = Ak[(size_t)j * nn];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i < ng) acc[i] = fma(a, dy[(size_t)(b0 + i) * mp + j], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    if (i >= ng) break;
    const size_t idx = (size_t)(b0 + i) * KE + ke;
    const bool live = pad[pad_per_instance ? idx : (size_t)ke] != 0;
    dS[idx] = live ? acc[i] + Rp[idx] : 0.0;
  }
}

// dX[bk, r0 + r, :] = pad ((Rc - X dS)[bk, r0 + r, :] Sinv[bk])
__global__ void recover_dx_kernel(const double* __restrict__ X,
                                  const double* __restrict__ dS,
                                  const double* __restrict__ Rc,
                                  const float* __restrict__ Sinv,
                                  const unsigned char* __restrict__ pad,
                                  int pad_per_instance,
                                  double* __restrict__ dX, int K, int n,
                                  int panels) {
  extern __shared__ double smem[];
  double* Xs = smem;                 // kPanel x n: the panel of X
  double* Ts = smem + kPanel * n;    // kPanel x n: the panel of Rc - X dS
  const int bk = blockIdx.x / panels;
  const int r0 = (blockIdx.x - bk * panels) * kPanel;
  const int rows = n - r0 < kPanel ? n - r0 : kPanel;
  const size_t nn = (size_t)n * n;
  const size_t off = (size_t)bk * nn;
  const unsigned char* pd = pad + (pad_per_instance ? off
                                                    : (size_t)(bk % K) * nn);
  for (int e = threadIdx.x; e < kPanel * n; e += blockDim.x) {
    const int r = e / n;
    Xs[e] = r < rows ? X[off + (size_t)(r0 + r) * n + (e - r * n)] : 0.0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    double acc[kPanel];
#pragma unroll
    for (int r = 0; r < kPanel; ++r) acc[r] = 0.0;
    for (int m = 0; m < n; ++m) {
      const double d = dS[off + (size_t)m * n + c];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) acc[r] = fma(Xs[r * n + m], d, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kPanel; ++r)
      Ts[r * n + c] =
          r < rows ? Rc[off + (size_t)(r0 + r) * n + c] - acc[r] : 0.0;
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
      for (int r = 0; r < kPanel; ++r) acc[r] = fma(Ts[r * n + m], s, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kPanel; ++r) {
      if (r >= rows) break;
      const size_t i = (size_t)(r0 + r) * n + c;
      dX[off + i] = pd[i] ? acc[r] : 0.0;
    }
  }
}

}  // namespace

// (dS, dX) of one bucket; both kernels launched on ``stream`` on the
// current device.  Returns the first CUDA error of the two launches (0 =
// both launched).
extern "C" int recover_bucket_f64(const double* A, const double* dy,
                                  const double* Rp, const double* Rc,
                                  const double* X, const float* Sinv,
                                  const unsigned char* pad,
                                  int pad_per_instance, double* dS,
                                  double* dX, int B, int K, int mp, int n,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nn = n * n;
  const long long KE = (long long)K * nn;
  const dim3 ds_grid((unsigned int)((KE + kThreads - 1) / kThreads),
                     (unsigned int)((B + kGroup - 1) / kGroup));
  recover_ds_kernel<<<ds_grid, kThreads, 0, s>>>(A, dy, Rp, pad,
                                                 pad_per_instance, dS, B, K,
                                                 mp, nn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int panels = (n + kPanel - 1) / kPanel;
  const size_t smem = 2 * (size_t)kPanel * n * sizeof(double);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(recover_dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  recover_dx_kernel<<<(unsigned int)((long long)B * K * panels),
                      panel_threads(n), smem, s>>>(
      X, dS, Rc, Sinv, pad, pad_per_instance, dX, K, n, panels);
  return (int)cudaGetLastError();
}
