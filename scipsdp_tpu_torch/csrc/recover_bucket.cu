// K3 of the fused Newton direction (refine interior-point tier): for one
// bucket of K blocks of size n,
//   dS[b, k] = pad (sum_j A[k, j] dy[b, j] + Rp[b, k])
//   dX[b, k] = pad ((Rc[b, k] - X[b, k] dS[b, k]) Sinv[b, k])
// dX is not symmetrized: the caller applies sym().
//
// Replaces: scipsdp_tpu/ops/fused.py::recover_bucket (_recover_kernel).  That
// kernel carried float64 as float32 hi/lo pairs and ran A(dy) and the two
// chained products as masked fori loops over the batch in VMEM.  Hopper's
// native float64 (FMA pipe and tensor cores) meets its ~2^-45 contract as it
// is; the float32 S^-1 is read as float32 and widened exactly.
//
// Contract: A (K, mp, n, n), Rp, Rc, X (B, K, n, n) float64; dy (B, mp)
// float64; Sinv (B, K, n, n) float32; pad bytes (0/1), (K, n, n) shared by
// every b or (B, K, n, n) per instance; dS, dX (B, K, n, n) float64, written
// completely (0 where pad is 0).  All row-major and contiguous.  No
// atomics: every output is summed in one fixed order.
//
// What bounds it on an H100: bytes.  A is static, shared by every instance
// and dominates them (cls_32, B = 32, K = 1, n = 65, mp = 66: 2.2 of 8.2
// MB; cls_64, B = 8, n = 129, mp = 130: 17.3 of 23.2 MB), so it is read
// once a launch, never once an instance.  A(dy) is 8.9 M multiply-adds at
// cls_32 and each product 8.8 M, a fraction of a microsecond on the
// float64 tensor cores.  So the time is launches, copies and L2 round
// trips: taken apart on the card (profile_torch_kernels.py dissect
// bucket), the 18.3 us of a call at cls_32 are two empty launches (3.3),
// A(dy)'s loads (2.3), the chain's copies of X and dS (3.1) and of S^-1
// (1.4, after X dS) and X dS (1.5); T S^-1 and the stores cost little.
//
// Design: two launches, in order on the caller's stream, since dS must be
// whole before X dS starts and A(dy) is one product over all instances.
//  * A(dy): the product dS (B x K n^2) = dy (B x mp) A (mp x K n^2), a
//    warp per 8 columns e of one k (529 warps at cls_32) and all B rows in
//    passes of 32, m16n8k16 steps over j with both fragments loaded
//    straight from L2 (a fragment row of A is 8 contiguous doubles); each
//    element of A is read by one warp (once, for B <= 32), and Rp and pad
//    are applied as dS is stored.
//  * the chain, chosen by n: for n <= 144 a block per 16-row panel of one
//    (b, k) (160 blocks at cls_32): the panel of X and the whole dS[b, k]
//    staged in shared memory, T = Rc - X dS on float64 mma.sync into the
//    panel's buffer, then S^-1[b, k] staged where dS was and dX = pad
//    (T S^-1) on mma.sync (panel_dmma.cuh): both operands of both products
//    from shared memory.  (S^-1 staged beside dS, its copy in flight
//    during X dS, measured no faster: fewer blocks an SM.)  Also at
//    n <= 16, where a kernel of FMA chains over many whole matrices a
//    block measured 1.4 times slower.  For n > 144 the first design's row
//    panels (a thread a column, dS and S^-1 read from L2 a step at a time).

#include <cuda_runtime.h>

#include "panel_dmma.cuh"

namespace {

constexpr int kPanel = 16;            // rows of dX per row-panel block
constexpr int kPanelThreads = 256;
constexpr int kDsWarps = 4;           // warps of an A(dy) block
constexpr int kPassB = 32;            // rows b of an A(dy) pass

// dS[b, k, e] = pad ? sum_j A[k, j, e] dy[b, j] + Rp[b, k, e] : 0
__global__ void __launch_bounds__(32 * kDsWarps)
recover_ds(const double* __restrict__ A, const double* __restrict__ dy,
           const double* __restrict__ Rp, const unsigned char* __restrict__ pad,
           int pad_per_instance, double* __restrict__ dS, int B, int K,
           int mp, int nn, int frags) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long w = (long long)blockIdx.x * kDsWarps + (threadIdx.x >> 5);
  if (w >= (long long)K * frags) return;
  const int k = (int)(w / frags);
  const int e0 = (int)(w - (long long)k * frags) * 8;
  const bool e_ok = e0 + g < nn;
  const double* acol = A + (size_t)k * mp * nn + (e_ok ? e0 + g : 0);
  for (int b0 = 0; b0 < B; b0 += kPassB) {
    double acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[m][v] = 0.0;
    const double* dyr[2][2];
    bool b_ok[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + 16 * m + 8 * h + g;
        b_ok[m][h] = b < B;
        dyr[m][h] = dy + (size_t)(b < B ? b : 0) * mp;
      }
    const bool two = b0 + 16 < B;
#pragma unroll 2
    for (int j0 = 0; j0 < mp; j0 += 16) {
      double a[2][8], bf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + t + 4 * i;
        const bool j_ok = j < mp;
        bf[i] = e_ok && j_ok ? __ldg(acol + (size_t)j * nn) : 0.0;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[m][2 * i + h] = b_ok[m][h] && j_ok ? __ldg(dyr[m][h] + j) : 0.0;
      }
      panel::dmma_k16(acc[0], a[0], bf);
      if (two) panel::dmma_k16(acc[1], a[1], bf);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!b_ok[m][h]) continue;
        const int b = b0 + 16 * m + 8 * h + g;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = e0 + 2 * t + c;
          if (e >= nn) continue;
          const size_t idx = ((size_t)b * K + k) * nn + e;
          const bool live =
              pad[pad_per_instance ? idx : (size_t)k * nn + e] != 0;
          dS[idx] = live ? acc[m][2 * h + c] + Rp[idx] : 0.0;
        }
      }
  }
}

// dX[bk, r0 + r, :] = pad ((Rc - X dS)[bk, r0 + r, :] Sinv[bk]), n <= 144
__global__ void __launch_bounds__(panel::kThreads)
recover_chain_staged(const double* __restrict__ X,
                     const double* __restrict__ dS,
                     const double* __restrict__ Rc,
                     const float* __restrict__ Sinv,
                     const unsigned char* __restrict__ pad,
                     int pad_per_instance, double* __restrict__ dX, int K,
                     int n, int panels) {
  using namespace panel;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = up(n, 16), lda = ld_a(n);
  double* Ps = reinterpret_cast<double*>(smem);   // kRows x lda: X, then T
  double* Bs = Ps + kRows * lda;                  // kp x ld_b64: dS, S^-1
  const int bk = blockIdx.x / panels;
  const int r0 = (blockIdx.x - bk * panels) * kRows;
  const size_t nn = (size_t)n * n;
  const size_t off = (size_t)bk * nn;
  stage(Ps, lda, X + off + (size_t)r0 * n, n - r0, n, kRows, kp);
  stage(Bs, ld_b64(n), dS + off, n, n, kp, up(n, 8));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int nfrag = up(n, 8) / 8;
  double acc[2][4];
  panel_product(acc, Ps, lda, Bs, ld_b64(n), kp, nfrag);
  __syncthreads();   // every warp is done with X and dS
  float* Ss = reinterpret_cast<float*>(Bs);
  stage(Ss, ld_b32(n), Sinv + off, n, n, kp, up(n, 8));
  cp_async_commit();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  if (warp < nfrag) {   // T = Rc - X dS; 0 beyond n (columns up to kp are)
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int q = (warp + kWarps * f) * 8 + 2 * t;
      if (q >= nfrag * 8) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        const bool row_ok = r0 + r < n;
        const double* rc = Rc + off + (size_t)(r0 + r) * n;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          Ps[r * lda + q + c] =
              row_ok && q + c < n ? rc[q + c] - acc[f][2 * h + c] : 0.0;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  panel_product(acc, Ps, lda, Ss, ld_b32(n), kp, nfrag);
  const unsigned char* pd =
      pad + (pad_per_instance ? off : (size_t)(bk % K) * nn);
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int q = (warp + kWarps * f) * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= n || warp >= nfrag) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t i = (size_t)r * n + q + c;
        if (q + c < n) dX[off + i] = pd[i] ? acc[f][2 * h + c] : 0.0;
      }
    }
  }
}

// dX[bk, r0 + r, :] = pad ((Rc - X dS)[bk, r0 + r, :] Sinv[bk]), any n
__global__ void recover_chain_panels(const double* __restrict__ X,
                                     const double* __restrict__ dS,
                                     const double* __restrict__ Rc,
                                     const float* __restrict__ Sinv,
                                     const unsigned char* __restrict__ pad,
                                     int pad_per_instance,
                                     double* __restrict__ dX, int K, int n,
                                     int panels) {
  extern __shared__ double panel_smem[];
  double* Xs = panel_smem;               // kPanel x n: the panel of X
  double* Ts = panel_smem + kPanel * n;  // kPanel x n: the panel of Rc - X dS
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

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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
  const int frags = (nn + 7) / 8;
  const long long warps = (long long)K * frags;
  recover_ds<<<(unsigned int)((warps + kDsWarps - 1) / kDsWarps),
               32 * kDsWarps, 0, s>>>(A, dy, Rp, pad, pad_per_instance, dS,
                                      B, K, mp, nn, frags);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long G = (long long)B * K;
  if (n <= panel::kMaxN) {
    const int panels = (n + panel::kRows - 1) / panel::kRows;
    const size_t smem = ((size_t)panel::kRows * panel::ld_a(n) +
                         (size_t)panel::up(n, 16) * panel::ld_b64(n)) *
                        sizeof(double);
    e = allow_smem((const void*)recover_chain_staged, smem);
    if (e != cudaSuccess) return (int)e;
    recover_chain_staged<<<(unsigned int)(G * panels), panel::kThreads, smem,
                           s>>>(X, dS, Rc, Sinv, pad, pad_per_instance, dX, K,
                                n, panels);
  } else {
    const int panels = (n + kPanel - 1) / kPanel;
    const size_t smem = 2 * (size_t)kPanel * n * sizeof(double);
    e = allow_smem((const void*)recover_chain_panels, smem);
    if (e != cudaSuccess) return (int)e;
    recover_chain_panels<<<(unsigned int)(G * panels), kPanelThreads, smem,
                           s>>>(X, dS, Rc, Sinv, pad, pad_per_instance, dX,
                                K, n, panels);
  }
  return (int)cudaGetLastError();
}
