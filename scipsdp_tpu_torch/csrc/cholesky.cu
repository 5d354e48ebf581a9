// Batched lower Cholesky of N independent float32 n x n matrices, for the
// interior-point solver's factor-quality sites (the X/S factors and the
// Schur complement of the float32 tiers with use_pallas).
//
// Replaces: scipsdp_tpu/ops/pallas_kernels.py::cholesky (_chol_kernel),
// the TPU kernel that factored one identity-padded 128 x 128 tile per grid
// step, left-looking, with one-hot matvecs for its row and column reads.
//
// Contract (the same as the TPU kernel's, and eigen.cholesky's pattern):
//   * in/out are (N, n, n) row-major float32, N = product of leading dims;
//   * only the lower triangle of the input is read;
//   * out holds the lower factor L with exact zeros above the diagonal;
//   * a matrix that is not positive definite (a pivot that is not > 0, or
//     NaN) comes back NaN on and below its whole diagonal, and no other
//     matrix of the stack is touched (the X and S halves share one launch;
//     the solver tells them apart by NaN);
//   * every sum is taken in a fixed order: two launches give the same bits.
//
// Arithmetic: the factor-quality rounding of the TPU kernel, right-looking
// column by column:
//   d = sqrtf(a_kk) (IEEE), l_ik = a_ik / d (IEEE division),
//   a_ij = fmaf(-l_ik, l_jk, a_ij)  for k < j <= i,
// each element's updates in column order.  The blocking below changes when
// each step runs, not what it computes.
//
// What bounds it on an H100: the column loop's dependences and barriers.
// The work is tiny next to the card's float32 rate (n = 65: ~92 kFLOP a
// matrix) and the bytes are n(n+1)/2 floats in and n^2 out, so the time
// is the dependent steps of one matrix and how many matrices are in
// flight.  An unblocked loop needs two block barriers a column (130 at
// n = 65).
//
// Design: cholesky_lanes.cu's blocked right-looking panels (its code is
// not shared: the probe kernel keeps its reciprocal-square-root arithmetic
// and its bits) of nb = kNB = 16 columns (the panel count from the
// caller, ops/kernels.py::tri_blocks, whose nb is this kNB), one block a
// matrix (kThreads threads), the matrix in shared memory
// at a padded stride (tri::smem_ld), padded to whole panels with an
// identity tail.  Each panel is
//   (a) the nb x nb diagonal block factored in registers by a group of nb
//       lanes of warp 0 (a lane a row, the columns exchanged by shuffles;
//       every lane keeps the diagonal, so every lane sees every pivot);
//   (b) the rows below solved against it, a thread a row (a chain of
//       nb^2/2 fmaf and nb divisions), written back and, transposed, into
//       a panel buffer P;
//   (c) the trailing lower triangle updated, A22 -= L21 L21^T, 4 x 4 tiles
//       a thread with two float4 reads of P per 16 FMAs, by all warps but
//       warp 0, which meanwhile updates the next diagonal block and
//       factors it: the next panel's (a), looking ahead;
// with one block barrier after (b) and one after (c): 2 n/nb a matrix (12
// at n = 65).  Warp 0 records a failed pivot in a shared flag, read once
// when the output is written.  The square roots and divisions of (a) and
// (b) are sqrt_rn and div_rn: the IEEE results (the contract's rounding)
// with no branch to split their unrolled chains.  A positive definite
// matrix with an operand out of their range (a magnitude below 2^-62 or
// above 2^62) raises a second flag and is factored again at the end from
// A, unblocked, with sqrtf and / (tri::factor_lower, left-looking).
// n <= nb takes one group of nb lanes a matrix, several matrices a block
// and no barrier (an operand out of range: the group's block factored
// again with sqrtf and /).  Where the matrix does
// not fit in shared memory (n > ~224) it stays in the output buffer in
// device memory (the L2 holds it) and only the panel is staged: each
// trailing element is read and written once a panel, not once a column.

#include <cuda_runtime.h>
#include <math.h>

#include "tri_factor.cuh"

namespace {

constexpr int kNB = 16;              // panel width: a half warp
constexpr int kThreads = 512;        // a block of the general kernel
constexpr int kTinyThreads = 256;    // n <= kNB: groups of kNB lanes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The operands for which sqrt_rn and div_rn are exact: 2^-62 <= |x| <=
// 2^62 (so no square root, reciprocal or quotient of two of them leaves
// the normal range).  NaN and inf are not.
__device__ __forceinline__ bool in_range(float x) {
  const float ax = fabsf(x);
  return ax >= 0x1p-62f && ax <= 0x1p62f;
}

// sqrtf(c) and a / d, rounded to nearest as the IEEE routines round, for
// operands in range (c > 0, d > 0), without their slow-path branch (which
// splits an unrolled loop into pieces the compiler cannot interleave): an
// approximation from the hardware's reciprocal (square root), one Newton
// step to within an ulp, then the nearest of it and its two neighbours by
// exact float64 comparisons with the midpoints between them (the squares
// and products of these 26- and 24-bit values are exact in float64, and no
// midpoint is ever the exact result).
__device__ __forceinline__ float sqrt_rn(float c) {
  const float y = rsqrt_approx(c);
  float g = c * y;
  g = fmaf(fmaf(-g, g, c), 0.5f * y, g);
  const float dn = __int_as_float(__float_as_int(g) - 1);
  const float up = __int_as_float(__float_as_int(g) + 1);
  const double gd = g, cd = c;
  const double mdn = 0.5 * (gd + (double)dn), mup = 0.5 * (gd + (double)up);
  return cd < mdn * mdn ? dn : (cd > mup * mup ? up : g);
}

__device__ __forceinline__ float div_rn(float a, float d) {
  const float y = rcp_approx(d);
  float q = a * y;
  q = fabsf(fmaf(fmaf(-q, d, a), y, q));
  const float dn = __int_as_float(__float_as_int(q) - 1);
  const float up = __int_as_float(__float_as_int(q) + 1);
  const double qd = q, ad = fabsf(a), dd = d;
  const double mdn = 0.5 * (qd + (double)dn), mup = 0.5 * (qd + (double)up);
  const float r = ad < mdn * dd ? dn : (ad > mup * dd ? up : q);
  return a == 0.f ? a : copysignf(r, a);
}

// Cholesky of one kNB x kNB block held by a group of kNB lanes, lane r
// holding row r in a[] (entries above the diagonal are ignored).  On
// return a[q] = L[r][q] (0 above the diagonal), and ok is false if a pivot
// was not > 0 (the same in every lane of the group).  All 32 lanes of the
// warp must call it.  Every lane keeps the whole diagonal (dg), updated
// with the same fmaf as its owner's, so each pivot is known to all lanes
// without a shuffle of its own.  With ``ieee`` false the square roots and
// quotients are sqrt_rn and div_rn, and the return value says whether all
// of this lane's operands were in their range (else the caller factors the
// block again with ``ieee``: sqrtf and /, the same bits where both apply;
// then it returns true).
__device__ __forceinline__ bool factor_block(float (&a)[kNB], int r,
                                             bool& ok, bool ieee) {
  float dg[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t) dg[t] = __shfl_sync(kFull, a[t], t, kNB);
  bool exact = true;   // stays true with ieee
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    const float c = dg[q];
    ok = ok && c > 0.f;
    float d, quo;
    if (ieee) {
      d = sqrtf(c);
      quo = a[q] / d;
    } else {
      exact = exact && in_range(c) &&
              (r <= q || a[q] == 0.f || in_range(a[q]));
      d = sqrt_rn(c);
      quo = div_rn(a[q], d);
    }
    const float l = r == q ? d : (r > q ? quo : 0.f);
    a[q] = l;
#pragma unroll
    for (int t = q + 1; t < kNB; ++t) {
      const float lt = __shfl_sync(kFull, l, t, kNB);
      if (r >= t) a[t] = fmaf(-l, lt, a[t]);
      dg[t] = fmaf(-lt, lt, dg[t]);
    }
  }
  return exact;
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
  bool ok = true;
#pragma unroll
  for (int ieee = 0; ieee < 2; ++ieee) {   // sqrt_rn / div_rn, else IEEE
#pragma unroll
    for (int t = 0; t < kNB; ++t)
      a[t] = (r < n && t <= r) ? A[r * n + t] : (t == r ? 1.f : 0.f);
    ok = true;
    if (__all_sync(kFull, factor_block(a, r, ok, ieee))) break;
  }
  if (!live || r >= n) return;
  float* O = out + (size_t)g * n * n;
#pragma unroll
  for (int t = 0; t < kNB; ++t)
    if (t < n) O[r * n + t] = t > r ? 0.f : (ok ? a[t] : tri::qnan());
}

// Shared floats of the general kernel: the matrix (np rows of ld, unless
// it stays in device memory), the panel buffer P (kNB rows of np), the
// factored diagonal block (kNB rows of kNB + 1) and two flags (a failed
// pivot; an operand out of sqrt_rn's and div_rn's range).
size_t smem_floats(int np, int ld, bool in_smem) {
  return (in_smem ? (size_t)np * ld : 0) + (size_t)kNB * np +
         kNB * (kNB + 1) + 2;
}

// Warp 0 (all 32 lanes; a group of kNB lanes a copy): the diagonal block
// at rows and columns k1 .. k1 + kNB of W, updated with the panel's columns
// in P (k0's update, the same fmaf order as the tiles; none for the first
// block), factored, written to S and back into W; a pivot that is not > 0
// sets flags[0], an operand out of sqrt_rn's and div_rn's range flags[1].
__device__ __forceinline__ void diagonal_block(float* W, int ldw, int nv,
                                               const float* P, int np, int k1,
                                               bool update, float* S,
                                               int* flags) {
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
  bool ok = true;
  const bool exact = __all_sync(kFull, factor_block(a, r, ok, false));
  if (threadIdx.x < kNB) {
#pragma unroll
    for (int t = 0; t < kNB; ++t) S[r * (kNB + 1) + t] = a[t];
    if (k1 + r < nv) {
#pragma unroll
      for (int t = 0; t < kNB; ++t)
        if (t <= r) W[(size_t)(k1 + r) * ldw + k1 + t] = a[t];
    }
    if (r == 0 && !ok) flags[0] = 1;
    if (r == 0 && !exact) flags[1] = 1;
  }
}

// Row i, columns k0 .. k0 + kNB of the working matrix W (row stride ldw;
// rows and columns from nv on read as the identity; float4 reads where W
// is the padded matrix in shared memory)
__device__ __forceinline__ void load_row(float (&l)[kNB], const float* W,
                                         int ldw, int nv, bool in_smem, int i,
                                         int k0) {
  if (in_smem) {
#pragma unroll
    for (int t4 = 0; t4 < kNB; t4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(
          W + (size_t)i * ldw + k0 + t4);
      l[t4] = v.x; l[t4 + 1] = v.y; l[t4 + 2] = v.z; l[t4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kNB; ++t) {
      const int c = k0 + t;
      l[t] = (i < nv && c < nv) ? W[(size_t)i * ldw + c]
                                : (i == c ? 1.f : 0.f);
    }
  }
}

// The general kernel's body, with the matrix in shared memory (in_smem, a
// constant in each of the two kernels below) or in device memory
__device__ __forceinline__ void cholesky_body(const float* __restrict__ in,
                                              float* out, int n, int np,
                                              int ld, bool in_smem) {
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
  int* flags = reinterpret_cast<int*>(S + kNB * (kNB + 1));
  auto get = [&](int r, int c) -> float {
    return (r < nv && c < nv) ? W[(size_t)r * ldw + c] : (r == c ? 1.f : 0.f);
  };

  // the lower triangle of A into W
  if (tid < 2) flags[tid] = 0;
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
  if (warp == 0) diagonal_block(W, ldw, nv, P, np, 0, false, S, flags);
  __syncthreads();

  for (int k0 = 0; k0 < np; k0 += kNB) {
    const int k1 = k0 + kNB;
    // (b) rows below: l_q = (a_q - sum_{t<q} l_t L[q][t]) / L[q][q], with
    // div_rn (an operand out of its range sets flags[1])
    for (int i = k1 + tid; i < np; i += nt) {
      float l[kNB];
      load_row(l, W, ldw, nv, in_smem, i, k0);
      bool exact = true;
#pragma unroll
      for (int q = 0; q < kNB; ++q) {
        float s = l[q];
#pragma unroll
        for (int t = 0; t < q; ++t) s = fmaf(-l[t], S[q * (kNB + 1) + t], s);
        const float d = S[q * (kNB + 1) + q];
        exact = exact && in_range(d) && (s == 0.f || in_range(s));
        l[q] = div_rn(s, d);
      }
      if (!exact) flags[1] = 1;
#pragma unroll
      for (int q = 0; q < kNB; ++q) P[q * np + i] = l[q];
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
      diagonal_block(W, ldw, nv, P, np, k1, true, S, flags);
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

  // a positive definite matrix with an operand out of sqrt_rn's and
  // div_rn's range (one beyond 2^62 or below 2^-62) is factored again from
  // A with sqrtf and /, unblocked (tri::factor_lower: left-looking, the
  // parent design's order)
  bool ok = flags[0] == 0;
  if (ok && flags[1]) {
    __syncthreads();
    tri::stage_lower(A, W, n, ldw);
    __syncthreads();
    ok = tri::factor_lower(W, n, ldw, P);
  }
  // the n x n output: L (NaN on and below the diagonal of a matrix that
  // is not positive definite), exact zeros above the diagonal
  for (int i = warp; i < n; i += nt / 32) {
    for (int j = lane; j < n; j += 32) {
      if (j > i) O[(size_t)i * n + j] = 0.f;
      else if (!ok) O[(size_t)i * n + j] = tri::qnan();
      else if (in_smem) O[(size_t)i * n + j] = W[(size_t)i * ld + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    cholesky_kernel(const float* __restrict__ in, float* out, int n, int np,
                    int ld) {
  cholesky_body(in, out, n, np, ld, true);
}

__global__ void __launch_bounds__(kThreads)
    cholesky_global_kernel(const float* __restrict__ in, float* out, int n,
                           int np) {
  cholesky_body(in, out, n, np, n, false);
}


}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device, in ``npan`` panels of kNB columns, the last one non-empty;
// returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for a split it does not take.
extern "C" int cholesky_f32(const float* in, float* out, long long nmat,
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
  const bool in_smem =
      smem_floats(np, ld, true) * sizeof(float) <= (size_t)max_smem;
  const size_t smem = smem_floats(np, ld, in_smem) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (in_smem) {
    err = tri::smem_opt_in(cholesky_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    cholesky_kernel<<<(unsigned int)nmat, kThreads, smem, st>>>(in, out, n,
                                                                 np, ld);
  } else {
    err = tri::smem_opt_in(cholesky_global_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    cholesky_global_kernel<<<(unsigned int)nmat, kThreads, smem, st>>>(
        in, out, n, np);
  }
  return (int)cudaGetLastError();
}
