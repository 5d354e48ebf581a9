// Fused A -> L^-1 (A = L L^T) of N independent float32 n x n matrices:
// the Cholesky factorization followed by the triangular inverse in one
// launch, only the inverse written.
//
// Replaces: scipsdp_tpu/ops/pallas_kernels.py::chol_inverse_lanes
// (_cholinv_lanes_kernel), the TPU kernel that laid 128 matrices on the
// lane axis and ran the forward substitution interleaved with the
// elimination.  The JAX package has no solver caller for it (its tests and
// a profiling script use it); the port keeps the function and its
// contract.
//
// Contract:
//   * in/out are (N, n, n) row-major float32, N = product of leading dims,
//     any leading batch shape (no lanes layout, no padding);
//   * only the lower triangle of A is read;
//   * out is L^-1, exact zeros above the diagonal;
//   * a matrix that is not positive definite comes back NaN on and below
//     its diagonal, and no other matrix is touched.
//
// What bounds it on an H100: the two sequential chains of cholesky.cu and
// tril_inverse.cu, one after the other, per matrix; bytes and operations
// are small (n^3/2 FLOP and 2 n^2 floats a matrix).
//
// Design: one thread block per matrix; tri::factor_lower then
// tri::invert_lower (tri_factor.cuh) on L and X both in shared memory
// where they fit (n <= ~160), else on a device-memory workspace for L that
// the wrapper allocates and on the output buffer for X.

#include <cuda_runtime.h>

#include "tri_factor.cuh"

namespace {

__global__ void chol_inverse_kernel(const float* __restrict__ in, float* out,
                                    float* work, int n, int ld,
                                    int in_smem) {
  extern __shared__ float smem[];
  const size_t nn = (size_t)n * n;
  const float* A = in + (size_t)blockIdx.x * nn;
  float* O = out + (size_t)blockIdx.x * nn;
  float* col = smem;                                   // n floats
  const int lda = in_smem ? ld : n;
  float* a = in_smem ? smem + n : work + (size_t)blockIdx.x * nn;
  float* x = in_smem ? a + (size_t)n * ld : O;
  tri::stage_lower(A, a, n, lda);
  __syncthreads();
  const bool ok = tri::factor_lower(a, n, lda, col);
  tri::invert_lower(a, lda, x, lda, n);
  __syncthreads();
  tri::write_lower(x, lda, O, n, ok);
}

}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device; ``work`` holds nmat n x n floats (used only where L and X do not
// fit in shared memory).  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int chol_inverse_lanes_f32(const float* in, float* out,
                                      float* work, long long nmat, int n,
                                      void* stream) {
  int max_smem = 0;
  cudaError_t err = tri::smem_limit(&max_smem);
  if (err != cudaSuccess) return (int)err;
  const int ld = tri::smem_ld(n);
  const size_t full = (2 * (size_t)n * ld + n) * sizeof(float);
  const int in_smem = full <= (size_t)max_smem;
  const size_t smem = in_smem ? full : (size_t)n * sizeof(float);
  err = tri::smem_opt_in(chol_inverse_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int lanes = ((tri::kLanes * n + 31) / 32) * 32;
  const int threads = lanes < 256 ? lanes : 256;
  chol_inverse_kernel<<<(unsigned int)nmat, threads, smem,
                        (cudaStream_t)stream>>>(in, out, work, n, ld,
                                                in_smem);
  return (int)cudaGetLastError();
}
