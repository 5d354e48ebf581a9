// Batched lower Cholesky of N independent float32 n x n matrices, for the
// interior-point solver's PSD probes.
//
// Replaces: scipsdp_tpu/ops/pallas_kernels.py::cholesky_lanes
// (_chol_lanes_kernel), the TPU kernel that laid the batch on the 128-lane
// axis and ran one right-looking column loop for 128 matrices at once.
//
// Contract (the same as the TPU kernel's):
//   * in/out are (N, n, n) row-major float32, N = product of leading dims;
//   * out holds the lower factor L with exact zeros above the diagonal;
//   * a matrix that is not positive definite yields NaN in ITS OWN output
//     only: a pivot <= 0, subnormal (read as zero, as the TPU and XLA's
//     CPU flush it) or NaN is set to NaN, and products with it carry the
//     NaN through that matrix's trailing part.  The solver tests
//     isnan(L).any() per matrix and discards the factor.  A +inf pivot
//     gives +inf on the diagonal and zeros below it (sqrt, then divide);
//   * only the lower triangle of the input is read (potrf semantics);
//   * every sum is taken in a fixed order: two launches give the same bits.
//
// Arithmetic: right-looking, column by column, each column scaled by the
// reciprocal square root of its pivot, every update one fmaf in column
// order:
//   r = rsqrt(a_kk) (the hardware's, relative error < 2^-22.9),
//   d = a_kk r (+inf for a_kk = +inf),
//   l_ik = a_ik * r,  a_ij = fmaf(-l_ik, l_jk, a_ij)  for k < j <= i.
// The blocking below changes when each step runs, not what it computes.
//
// What bounds it on an H100: the column loop's dependences and barriers.
// The work is tiny next to the card's float32 rate (n = 65: ~92 kFLOP a
// matrix) and the bytes are n(n+1)/2 floats in and n^2 out, so the time
// is the dependent steps of one matrix and how many matrices are in
// flight.  An unblocked loop needs two block barriers a column (130 at
// n = 65).
//
// Design: blocked right-looking, panels of nb = kNB = 16 columns (the
// panel count from the caller, ops/kernels.py::tri_blocks, whose nb is
// this kNB), one block a matrix, the matrix in shared memory at a padded
// stride (tri::smem_ld), padded to whole panels with an identity tail.
// Each panel is
//   (a) the nb x nb diagonal block factored in registers by a group of nb
//       lanes of warp 0 (a lane a row, the columns exchanged by shuffles);
//   (b) the rows below solved against it, a thread a row (chains of
//       nb^2/2), written back and, transposed, into a panel buffer P;
//   (c) the trailing lower triangle updated, A22 -= L21 L21^T, 4 x 4 tiles
//       a thread with two float4 reads of P per 16 FMAs, by all warps but
//       warp 0, which meanwhile updates the next diagonal block and
//       factors it: the next panel's (a), looking ahead;
// with one block barrier after (b) and one after (c): 2 n/nb a matrix.
// n <= nb takes one group of nb lanes a matrix, several matrices a block
// and no barrier.  Where the matrix does not fit in shared memory (n > ~230)
// it stays in the output buffer in device memory (the L2 holds it) and only
// the panel is staged: each trailing element is read and written once a
// panel, not once a column.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "tri_factor.cuh"

namespace {

constexpr int kNB = 16;              // panel width: a half warp
constexpr int kThreads = 256;        // a block of the general kernel
constexpr int kSmallThreads = 128;   // ... for a padded size up to kSmallNp
constexpr int kSmallNp = 80;
constexpr int kGlobalThreads = 512;  // ... with the matrix in device memory
constexpr int kTinyThreads = 256;    // n <= kNB: groups of kNB lanes
constexpr unsigned kFull = 0xffffffffu;

// The hardware's reciprocal square root: one instruction, where the IEEE
// routines branch for special inputs, and a branch in the unrolled column
// loop of factor_block splits it into pieces the compiler cannot
// interleave (a column then costs its shuffles' issue plus its latency).
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Cholesky of one kNB x kNB block held by a group of kNB lanes, lane r
// holding row r in a[] (entries above the diagonal are ignored).  On return a[q] = L[r][q] (0 above the diagonal) and rinv =
// 1 / L[r][r].  All 32 lanes of the warp must call it.  Every lane keeps
// the whole diagonal (dg), updated with the same fmaf as its owner's, so
// the next pivot needs no shuffle of its own: a column's dependent steps
// are one shuffle, one fmaf, the reciprocal square root and two
// multiplies, with no branch.
__device__ __forceinline__ void factor_block(float (&a)[kNB], int r,
                                             float& rinv) {
  float dg[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t) dg[t] = __shfl_sync(kFull, a[t], t, kNB);
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    const float c = dg[q];
    const float ri = c >= FLT_MIN ? rsqrt_approx(c) : tri::qnan();
    const float d = c < INFINITY ? c * ri : c;
    if (r == q) rinv = ri;
    const float l = r == q ? d : (r > q ? a[q] * ri : 0.f);
    a[q] = l;
#pragma unroll
    for (int t = q + 1; t < kNB; ++t) {
      const float lt = __shfl_sync(kFull, l, t, kNB);
      if (r >= t) a[t] = fmaf(-l, lt, a[t]);
      dg[t] = fmaf(-lt, lt, dg[t]);
    }
  }
}

// n <= kNB: group g of kNB lanes factors matrix g whole, identity-padded.
__global__ void __launch_bounds__(kTinyThreads)
    cholesky_tiny_kernel(const float* __restrict__ in, float* __restrict__ out,
                         long long nmat, int n) {
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kNB;
  const int r = threadIdx.x % kNB;
  const bool live = g < nmat;     // dead groups compute too: whole shuffles
  const float* A = in + (size_t)(live ? g : 0) * n * n;
  float a[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t)
    a[t] = (r < n && t <= r) ? A[r * n + t] : (t == r ? 1.f : 0.f);
  float rinv;
  factor_block(a, r, rinv);
  if (!live || r >= n) return;
  float* O = out + (size_t)g * n * n;
#pragma unroll
  for (int t = 0; t < kNB; ++t)
    if (t < n) O[r * n + t] = a[t];
}

// Shared floats of the general kernel: the matrix (np rows of ld, unless
// it stays in device memory), the panel buffer P (kNB rows of np), and the
// factored diagonal block (kNB rows of kNB + 1) and its reciprocals.
size_t smem_floats(int np, int ld, bool in_smem) {
  return (in_smem ? (size_t)np * ld : 0) + (size_t)kNB * np + kNB * (kNB + 2);
}

// Warp 0 (all 32 lanes; a group of kNB lanes a copy): the diagonal block
// at rows and columns k1 .. k1 + kNB of W, updated with the panel's columns
// in P (k0's update, the same fmaf order as the tiles; none for the first
// block), factored, written to S / Srinv and back into W.
__device__ __forceinline__ void diagonal_block(float* W, int ldw, int nv,
                                               const float* P, int np, int k1,
                                               bool update, float* S,
                                               float* Srinv) {
  const int r = threadIdx.x % kNB;
  float a[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t) {
    const int i = k1 + r, j = k1 + t;
    a[t] = t > r ? 0.f
                 : (i < nv && j < nv) ? W[(size_t)i * ldw + j]
                                      : (i == j ? 1.f : 0.f);
  }
  if (update) {
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      const float pr = P[k * np + k1 + r];
#pragma unroll
      for (int t = 0; t < kNB; ++t)
        if (t <= r) a[t] = fmaf(-pr, P[k * np + k1 + t], a[t]);
    }
  }
  float rinv;
  factor_block(a, r, rinv);
  if (threadIdx.x < kNB) {
#pragma unroll
    for (int t = 0; t < kNB; ++t) S[r * (kNB + 1) + t] = a[t];
    Srinv[r] = rinv;
    if (k1 + r < nv) {
#pragma unroll
      for (int t = 0; t < kNB; ++t)
        if (t <= r) W[(size_t)(k1 + r) * ldw + k1 + t] = a[t];
    }
  }
}

__global__ void __launch_bounds__(kGlobalThreads)
    cholesky_lanes_kernel(const float* __restrict__ in, float* out, int n,
                          int np, int ld, int in_smem) {
  extern __shared__ __align__(16) float smem[];
  const float* A = in + (size_t)blockIdx.x * n * n;
  float* O = out + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  // the working matrix: shared memory padded to np with an identity tail,
  // or the output itself (row stride n; rows and columns past n read as
  // the identity and are never written)
  float* W = in_smem ? smem : O;
  const int ldw = in_smem ? ld : n;
  const int nv = in_smem ? np : n;
  float* P = smem + (in_smem ? (size_t)np * ld : 0);   // P[k][r], k < kNB
  float* S = P + (size_t)kNB * np;        // the panel's diagonal block L_pp
  float* Srinv = S + kNB * (kNB + 1);
  auto get = [&](int r, int c) -> float {
    return (r < nv && c < nv) ? W[(size_t)r * ldw + c] : (r == c ? 1.f : 0.f);
  };

  // the lower triangle of A into W
  for (int r = warp; r < np; r += nt / 32) {
    for (int c = lane; c <= r; c += 32) {
      if (r < n && c < n) {
        if (in_smem) cp_async4(W + (size_t)r * ld + c, A + (size_t)r * n + c);
        else O[(size_t)r * n + c] = A[(size_t)r * n + c];
      } else if (in_smem) {
        W[(size_t)r * ld + c] = r == c ? 1.f : 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) diagonal_block(W, ldw, nv, P, np, 0, false, S, Srinv);
  __syncthreads();

  for (int k0 = 0; k0 < np; k0 += kNB) {
    const int k1 = k0 + kNB;
    // (b) rows below: l_q = (a_q - sum_{t<q} l_t L[q][t]) / L[q][q]
    for (int i = k1 + tid; i < np; i += nt) {
      float l[kNB];
      if (in_smem) {
#pragma unroll
        for (int t4 = 0; t4 < kNB; t4 += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              W + (size_t)i * ld + k0 + t4);
          l[t4] = v.x; l[t4 + 1] = v.y; l[t4 + 2] = v.z; l[t4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kNB; ++t) l[t] = get(i, k0 + t);
      }
#pragma unroll
      for (int q = 0; q < kNB; ++q) {
        float s = l[q];
#pragma unroll
        for (int t = 0; t < q; ++t) s = fmaf(-l[t], S[q * (kNB + 1) + t], s);
        l[q] = s * Srinv[q];
        P[q * np + i] = l[q];
      }
      if (i < nv) {
#pragma unroll
        for (int t = 0; t < kNB; ++t) W[(size_t)i * ldw + k0 + t] = l[t];
      }
    }
    __syncthreads();
    // (c) the trailing lower triangle: warp 0 updates and factors the next
    // diagonal block (the next panel's (a), looking ahead), the other
    // warps update the rest in 4 x 4 tiles
    const int T = (np - k1) / 4;
    const int ntiles = T * (T + 1) / 2;
    constexpr int kDiagTiles = (kNB / 4) * (kNB / 4 + 1) / 2;
    if (warp == 0 && k1 < np)
      diagonal_block(W, ldw, nv, P, np, k1, true, S, Srinv);
    for (int t = kDiagTiles + tid - 32; warp > 0 && t < ntiles; t += nt - 32) {
      int tr = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (tr * (tr + 1) / 2 > t) --tr;
      while ((tr + 1) * (tr + 2) / 2 <= t) ++tr;
      const int tc = t - tr * (tr + 1) / 2;
      const int r0 = k1 + 4 * tr, c0 = k1 + 4 * tc;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (in_smem) {
          const float4 v = *reinterpret_cast<const float4*>(
              W + (size_t)(r0 + u) * ld + c0);
          acc[u][0] = v.x; acc[u][1] = v.y; acc[u][2] = v.z; acc[u][3] = v.w;
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = get(r0 + u, c0 + v);
        }
      }
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        const float4 pr = *reinterpret_cast<const float4*>(P + k * np + r0);
        const float4 pc = *reinterpret_cast<const float4*>(P + k * np + c0);
        const float lr[4] = {pr.x, pr.y, pr.z, pr.w};
        const float lc[4] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[u][v] = fmaf(-lr[u], lc[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (in_smem) {
          *reinterpret_cast<float4*>(W + (size_t)(r0 + u) * ld + c0) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        } else if (r0 + u < n) {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (c0 + v < n) O[(size_t)(r0 + u) * n + c0 + v] = acc[u][v];
        }
      }
    }
    __syncthreads();
  }

  // the n x n output: L, exact zeros above the diagonal
  for (int i = warp; i < n; i += nt / 32) {
    for (int j = lane; j < n; j += 32) {
      if (in_smem) O[(size_t)i * n + j] = j <= i ? W[(size_t)i * ld + j] : 0.f;
      else if (j > i) O[(size_t)i * n + j] = 0.f;
    }
  }
}

}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device, in ``npan`` panels of kNB columns, the last one non-empty;
// returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for a split it does not take.
extern "C" int cholesky_lanes_f32(const float* in, float* out, long long nmat,
                                  int n, int npan, void* stream) {
  if (npan < 1 || (long long)(npan - 1) * kNB >= n ||
      (long long)npan * kNB < n || nmat >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (npan == 1) {   // n <= kNB
    const long long blocks = (nmat * kNB + kTinyThreads - 1) / kTinyThreads;
    cholesky_tiny_kernel<<<(unsigned int)blocks, kTinyThreads, 0, st>>>(
        in, out, nmat, n);
    return (int)cudaGetLastError();
  }
  int max_smem = 0;
  cudaError_t err = tri::smem_limit(&max_smem);
  if (err != cudaSuccess) return (int)err;
  const int np = npan * kNB;
  const int ld = tri::smem_ld(np);
  const int threads = np <= kSmallNp ? kSmallThreads : kThreads;
  const bool in_smem =
      smem_floats(np, ld, true) * sizeof(float) <= (size_t)max_smem;
  const int nthreads = in_smem ? threads : kGlobalThreads;
  const size_t smem = smem_floats(np, ld, in_smem) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = tri::smem_opt_in(cholesky_lanes_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_lanes_kernel<<<(unsigned int)nmat, nthreads, smem, st>>>(
      in, out, n, np, ld, (int)in_smem);
  return (int)cudaGetLastError();
}
