// Device code shared by the float32 triangular kernels (cholesky_lanes.cu,
// cholesky.cu, tril_inverse.cu, chol_inverse_lanes.cu): the padded row
// stride, the shared-memory opt-in, and the left-looking Cholesky
// factorization of ONE float32 matrix run by all the threads of one block
// (cholesky.cu's fall-back).  Every sum is taken in a fixed order (no
// atomics), so two launches give the same bits.

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
// distinct banks, and so do 8 threads' float4 reads of 8 rows.
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
