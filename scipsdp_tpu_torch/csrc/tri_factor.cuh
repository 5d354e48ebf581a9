// Device code shared by cholesky.cu, tril_inverse.cu and
// chol_inverse_lanes.cu: the left-looking Cholesky factorization and the
// forward-substitution inverse of ONE float32 matrix, each run by all the
// threads of one block.  Every sum is taken in a fixed order (no atomics),
// so two launches give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tri {

// Threads that share one row's dot product in the factorization: each
// takes every kLanes-th term, then a fixed xor-shuffle tree adds the four
// partial sums.
constexpr int kLanes = 4;

// Row stride of a matrix staged in shared memory: a multiple of 32 plus 4.
// In the factorization the 8 rows x 4 lanes of a warp then read 32
// distinct banks; in the inverse, thread j reads X[k][j] at k = j + s, a
// stride of ld + 1 (odd) across the warp: distinct banks again.
__host__ __device__ inline int smem_ld(int n) { return ((n + 31) / 32) * 32 + 4; }

__device__ inline float qnan() { return __int_as_float(0x7fffffff); }

// Left-looking Cholesky of the n x n matrix ``a`` (row stride ld), in
// place: on entry its lower triangle holds A, on exit L (the part above
// the diagonal is neither read nor written).  Column j is
//   c[r] = A[r][j] - sum_{k<j} L[r][k] L[j][k],  r >= j,
// then L[j][j] = sqrt(c[j]) and L[r][j] = c[r] / L[j][j].  ``col`` is
// shared scratch of n floats.  A pivot that is not positive (or NaN) makes
// its column NaN, and the NaN runs on through the later columns; the
// return value, the same in every thread, is false for such a matrix.
// blockDim.x must be a multiple of 32.  Ends with a block barrier.
__device__ inline bool factor_lower(float* a, int n, int ld, float* col) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int g = tid % kLanes;
  const int grp = tid / kLanes;
  const int ngrp = nt / kLanes;
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    const float* lj = a + (size_t)j * ld;
    // every thread runs the same number of passes, so the whole warp
    // takes part in each shuffle
    for (int r0 = j; r0 < n; r0 += ngrp) {
      const int r = r0 + grp;
      float s = 0.f;
      if (r < n) {
        const float* lr = a + (size_t)r * ld;
        for (int k = g; k < j; k += kLanes) s = fmaf(lr[k], lj[k], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (r < n && g == 0) col[r] = a[(size_t)r * ld + j] - s;
    }
    __syncthreads();
    const float c = col[j];
    ok = ok && c > 0.f;
    const float d = c > 0.f ? sqrtf(c) : qnan();
    for (int r = j + tid; r < n; r += nt)
      a[(size_t)r * ld + j] = (r == j) ? d : col[r] / d;
    __syncthreads();
  }
  return ok;
}

// X = L^-1 for the lower-triangular n x n matrix L (row stride ldl; only
// its lower triangle is read) into X (row stride ldx), zeros above the
// diagonal.  Thread j solves L x = e_j for its columns j, rows in order:
//   X[i][j] = (delta_ij - sum_{j<=k<i} L[i][k] X[k][j]) / L[i][i].
// A thread reads only its own columns of X, so no barrier is needed; the
// caller synchronizes before X is read by other threads.  A NaN in L
// reaches that matrix's X only.
__device__ inline void invert_lower(const float* L, int ldl, float* X,
                                    int ldx, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    for (int i = 0; i < j; ++i) X[(size_t)i * ldx + j] = 0.f;
    for (int i = j; i < n; ++i) {
      const float* li = L + (size_t)i * ldl;
      float s = (i == j) ? 1.f : 0.f;
      for (int k = j; k < i; ++k) s = fmaf(-li[k], X[(size_t)k * ldx + j], s);
      X[(size_t)i * ldx + j] = s / li[i];
    }
  }
}

// Copy the lower triangle of the n x n row-major matrix ``src`` into
// ``dst`` (row stride ld).
__device__ inline void stage_lower(const float* __restrict__ src, float* dst,
                                   int n, int ld) {
  const size_t nn = (size_t)n * n;
  for (size_t t = threadIdx.x; t < nn; t += blockDim.x) {
    const int i = (int)(t / n);
    const int j = (int)(t - (size_t)i * n);
    if (j <= i) dst[(size_t)i * ld + j] = src[t];
  }
}

// Write the n x n row-major output: the lower triangle of ``src`` (row
// stride ld; NaN instead where ``ok`` is false) and exact zeros above the
// diagonal.  ``src`` may be ``dst`` itself (ld = n): each element is read
// and written by one thread.
__device__ inline void write_lower(const float* src, int ld, float* dst,
                                   int n, bool ok) {
  const size_t nn = (size_t)n * n;
  for (size_t t = threadIdx.x; t < nn; t += blockDim.x) {
    const int i = (int)(t / n);
    const int j = (int)(t - (size_t)i * n);
    dst[t] = j <= i ? (ok ? src[(size_t)i * ld + j] : qnan()) : 0.f;
  }
}

// Dynamic shared memory a block may use on the current device, and the
// opt-in above the 48 KB default for ``kernel`` when ``bytes`` needs it.
inline cudaError_t smem_limit(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(max_smem,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <typename Kernel>
inline cudaError_t smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tri
