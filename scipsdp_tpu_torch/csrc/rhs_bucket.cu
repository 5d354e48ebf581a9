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
// the whole batch in VMEM.  Hopper has native float64 FMA, which meets its
// ~2^-45 contract as it is: everything here is float64, and the float32
// S^-1 is read as float32 and upcast in registers.
//
// Contract: A (K, mp, n, n), Rc and XRp (B, K, n, n) float64; Sinv (B, K, n,
// n) float32; P (B, K, n, n) float64 scratch; out (B, mp) float64, written
// completely.  All row-major and contiguous.  No atomics: every output is
// summed by one block in a fixed order, so results repeat bit for bit.
//
// What bounds it on an H100: at the main path (cls_32, B = 32, K = 1,
// n = 65, mp = 66) the product is 8.8 M multiply-adds and the contraction
// 9.0 M, against ~34 TFLOP/s of float64 FMA; the operands (1.1 MB each for
// Rc, XRp, P and 2.2 MB for the static A) sit in L2.  The time is launch
// latency and how many blocks are in flight.
//
// Design: two launches of this source, in order on the caller's stream.
//  * product: one block per 16-row panel of one P[b, k] (160 blocks at the
//    main path).  The panel of D = Rc - XRp is staged in shared memory
//    (128 n bytes: any n up to 900); each thread owns one column c and
//    keeps 16 float64 sums, reading S^-1[:, c] once, coalesced across the
//    block.  P goes to the caller's scratch, not through shared memory: at
//    n = 129 the n x n float64 tiles do not fit one block.
//  * contraction: one block per (j, group of 8 instances): 256 threads
//    stride over (k, a, c), so one read of A[k, j, a, c] serves 8
//    instances (A is static and shared by every b); a shuffle tree reduces
//    each warp's sums and the warps' partials are added in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int kPanel = 16;     // rows of P per product block
constexpr int kGroup = 8;      // instances per contraction block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

int panel_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < kThreads ? t : kThreads;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// P[bk, r0 + r, c] = sum_m (Rc - XRp)[bk, r0 + r, m] Sinv[bk, m, c]
__global__ void rhs_product_kernel(const double* __restrict__ Rc,
                                   const double* __restrict__ XRp,
                                   const float* __restrict__ Sinv,
                                   double* __restrict__ P, int n,
                                   int panels) {
  extern __shared__ double Ds[];   // kPanel x n
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

// out[b, j] = sum_{k, e} A[k, j, e] P[b, k, e] for b in one group of kGroup
__global__ void rhs_contract_kernel(const double* __restrict__ A,
                                    const double* __restrict__ P,
                                    double* __restrict__ out, int B, int K,
                                    int mp, int nn) {
  __shared__ double red[kGroup][kWarps];
  const int j = blockIdx.x;
  const int b0 = blockIdx.y * kGroup;
  const int ng = B - b0 < kGroup ? B - b0 : kGroup;
  const long long KE = (long long)K * nn;
  double acc[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = 0.0;
  for (long long ke = threadIdx.x; ke < KE; ke += kThreads) {
    const long long k = ke / nn;
    const double a = A[((size_t)k * mp + j) * nn + (ke - k * nn)];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i < ng) acc[i] = fma(a, P[(size_t)(b0 + i) * KE + ke], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const double s = warp_sum(acc[i]);
    if ((threadIdx.x & 31) == 0) red[i][threadIdx.x >> 5] = s;
  }
  __syncthreads();
  if (threadIdx.x < ng) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
    out[(size_t)(b0 + threadIdx.x) * mp + j] = s;
  }
}

}  // namespace

// out (B, mp) = A*-contraction of (Rc - XRp) Sinv, with P as scratch; both
// kernels launched on ``stream`` on the current device.  Returns the first
// CUDA error of the two launches (0 = both launched).
extern "C" int rhs_bucket_f64(const double* A, const double* Rc,
                              const double* XRp, const float* Sinv, double* P,
                              double* out, int B, int K, int mp, int n,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int panels = (n + kPanel - 1) / kPanel;
  const size_t smem = (size_t)kPanel * n * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rhs_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rhs_product_kernel<<<(unsigned int)((long long)B * K * panels),
                       panel_threads(n), smem, s>>>(Rc, XRp, Sinv, P, n,
                                                    panels);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned int)mp, (unsigned int)((B + kGroup - 1) / kGroup));
  rhs_contract_kernel<<<grid, kThreads, 0, s>>>(A, P, out, B, K, mp, n * n);
  return (int)cudaGetLastError();
}
