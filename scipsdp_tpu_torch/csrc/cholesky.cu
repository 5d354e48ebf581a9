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
//   * a matrix that is not positive definite comes back NaN on and below
//     its diagonal, and no other matrix of the stack is touched (the X and
//     S halves share one launch; the solver tells them apart by NaN).
//
// What bounds it on an H100: neither bytes nor operations (n = 65: 92 kFLOP
// and 34 KB a matrix).  Column j depends on every column before it, so the
// time is n sequential steps of two block barriers each, and with one
// block per matrix only as many SMs work as there are matrices (64 for the
// X/S stack and 32 for the Schur factors at cls_32 B=32).
//
// Design: one thread block per matrix, the matrix in shared memory (row
// stride tri::smem_ld(n); (130, 130) takes 85 KB, hence the dynamic
// shared-memory opt-in).  Left-looking like _chol_kernel: four lanes share
// each row's dot product, so 64 rows of a column are summed at once.  Where
// the matrix exceeds a block's shared memory (n > ~224) the same loop runs
// on the output buffer in device memory.  The factorization itself is
// tri::factor_lower (tri_factor.cuh), shared with chol_inverse_lanes.cu.

#include <cuda_runtime.h>

#include "tri_factor.cuh"

namespace {

__global__ void cholesky_kernel(const float* __restrict__ in, float* out,
                                int n, int ld, int in_smem) {
  extern __shared__ float smem[];
  const size_t nn = (size_t)n * n;
  const float* A = in + (size_t)blockIdx.x * nn;
  float* O = out + (size_t)blockIdx.x * nn;
  float* col = smem;                        // n floats
  float* a = in_smem ? smem + n : O;        // working matrix, stride ld
  tri::stage_lower(A, a, n, ld);
  __syncthreads();
  const bool ok = tri::factor_lower(a, n, ld, col);
  tri::write_lower(a, ld, O, n, ok);
}

}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int cholesky_f32(const float* in, float* out, long long nmat,
                            int n, void* stream) {
  int max_smem = 0;
  cudaError_t err = tri::smem_limit(&max_smem);
  if (err != cudaSuccess) return (int)err;
  const int ld = tri::smem_ld(n);
  const size_t full = ((size_t)n * ld + n) * sizeof(float);
  const int in_smem = full <= (size_t)max_smem;
  const size_t smem = in_smem ? full : (size_t)n * sizeof(float);
  err = tri::smem_opt_in(cholesky_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int lanes = ((tri::kLanes * n + 31) / 32) * 32;
  const int threads = lanes < 256 ? lanes : 256;
  cholesky_kernel<<<(unsigned int)nmat, threads, smem,
                    (cudaStream_t)stream>>>(in, out, n, in_smem ? ld : n,
                                            in_smem);
  return (int)cudaGetLastError();
}
