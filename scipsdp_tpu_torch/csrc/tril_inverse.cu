// Batched inverse X = L^-1 of N independent float32 n x n lower-triangular
// matrices: the triangular inverses of the float32 tiers' X/S factors and
// Schur factors with use_pallas (the direction solves and the step rules
// then become batched matmuls).
//
// Replaces: scipsdp_tpu/ops/pallas_kernels.py::tril_inverse
// (_trinv_kernel), the TPU kernel that ran forward substitution one row of
// X per step on an identity-padded 128 x 128 tile.
//
// Contract:
//   * in/out are (N, n, n) row-major float32, N = product of leading dims;
//   * only the lower triangle of L is read;
//   * out is exactly lower triangular: zeros above the diagonal;
//   * a NaN anywhere in L spreads through that matrix's X and never
//     beyond it.
//
// What bounds it on an H100: the dependence of row i of X on rows j..i-1:
// column 0 alone is n^2/2 dependent multiply-adds (8,450 at n = 130).  The
// operations (n^3/6 a matrix) and bytes (2 n^2 floats) are small.  The time
// is that chain's latency, once per matrix, with one block per matrix.
//
// Design: one thread block per matrix with L and X both in shared memory
// where they fit (2 n ld floats: 171 KB at n = 130, above the 48 KB
// default, hence the opt-in); a thread per column of X walks the rows in
// order.  A thread reads only its own column of X, so the substitution
// needs no barrier; L[i][k] across a warp is consecutive, X[k][j] strided
// by ld + 1 (odd), so neither read conflicts on a bank.  Where the two
// exceed a block's shared memory (n > ~160), L is read from and X written
// to device memory directly.  The substitution is tri::invert_lower
// (tri_factor.cuh), shared with chol_inverse_lanes.cu.

#include <cuda_runtime.h>

#include "tri_factor.cuh"

namespace {

__global__ void tril_inverse_kernel(const float* __restrict__ in, float* out,
                                    int n, int ld, int in_smem) {
  extern __shared__ float smem[];
  const size_t nn = (size_t)n * n;
  const float* L = in + (size_t)blockIdx.x * nn;
  float* O = out + (size_t)blockIdx.x * nn;
  if (!in_smem) {
    tri::invert_lower(L, n, O, n, n);
    return;
  }
  float* Ls = smem;
  float* Xs = smem + (size_t)n * ld;
  tri::stage_lower(L, Ls, n, ld);
  __syncthreads();
  tri::invert_lower(Ls, ld, Xs, ld, n);
  __syncthreads();
  tri::write_lower(Xs, ld, O, n, true);
}

}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tril_inverse_f32(const float* in, float* out, long long nmat,
                                int n, void* stream) {
  int max_smem = 0;
  cudaError_t err = tri::smem_limit(&max_smem);
  if (err != cudaSuccess) return (int)err;
  const int ld = tri::smem_ld(n);
  const size_t full = 2 * (size_t)n * ld * sizeof(float);
  const int in_smem = full <= (size_t)max_smem;
  const size_t smem = in_smem ? full : 0;
  err = tri::smem_opt_in(tril_inverse_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = ((n + 31) / 32) * 32;
  const int threads = cols < 1024 ? cols : 1024;
  tril_inverse_kernel<<<(unsigned int)nmat, threads, smem,
                        (cudaStream_t)stream>>>(in, out, n, ld, in_smem);
  return (int)cudaGetLastError();
}
