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
//     only: a pivot <= 0 (or NaN) becomes NaN, and x / NaN and x - NaN
//     carry it through that matrix's trailing part.  The solver tests
//     isnan(L).any() per matrix and discards the factor.
//   * only the lower triangle of the input is read (potrf semantics).
//
// What bounds it on an H100: the column loop is sequential with two block
// barriers per column, and the matrix must sit in shared memory (227 KB a
// block at most) to keep the O(n^3/3) trailing updates off device memory.
// The work is tiny next to the card's float32 rate (n = 65: ~92 kFLOP a
// matrix), so the time is barrier latency and the number of matrices in
// flight, not arithmetic or bandwidth.
//
// Design: one thread block per matrix, so hundreds to thousands of
// independent matrices fill the 132 SMs without any lane padding or
// identity-padded batch tails.  The matrix is staged in dynamic shared
// memory (n = 129: 66.6 KB, above the 48 KB default, hence the
// cudaFuncSetAttribute opt-in).  The scaled column k is copied into a
// contiguous shared vector so the rank-1 update reads it without bank
// conflicts whatever n is; each warp owns rows, its lanes walk the columns
// of a row (consecutive addresses).  Where n*n floats exceed the card's
// shared memory per block (n > ~238) the same loop runs on the output
// buffer in device memory, so every n the solver can produce is taken.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void cholesky_lanes_kernel(const float* __restrict__ in,
                                      float* __restrict__ out, int n,
                                      int in_smem) {
  extern __shared__ float smem[];
  const size_t nn = (size_t)n * n;
  const float* A = in + (size_t)blockIdx.x * nn;
  float* O = out + (size_t)blockIdx.x * nn;
  float* col = smem;                      // n floats: scaled column k
  float* a = in_smem ? smem + n : O;      // working matrix, row-major
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  for (size_t t = tid; t < nn; t += nt) a[t] = A[t];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // every thread reads the pivot; nobody writes it in this phase
    const float akk = a[(size_t)k * n + k];
    const float d = akk > 0.f ? sqrtf(akk) : __int_as_float(0x7fffffff);
    for (int i = k + tid; i < n; i += nt)
      col[i] = (i == k) ? d : a[(size_t)i * n + k] / d;
    __syncthreads();
    // column k of L goes back into the work matrix (never read again as
    // input), and the trailing lower triangle takes the rank-1 update
    for (int i = k + tid; i < n; i += nt) a[(size_t)i * n + k] = col[i];
    for (int i = k + 1 + warp; i < n; i += nwarps) {
      const float lik = col[i];
      float* row = a + (size_t)i * n;
      for (int j = k + 1 + lane; j <= i; j += 32) row[j] -= lik * col[j];
    }
    __syncthreads();
  }

  for (size_t t = tid; t < nn; t += nt) {
    const int i = (int)(t / n);
    const int j = (int)(t - (size_t)i * n);
    O[t] = (j <= i) ? a[t] : 0.f;
  }
}

}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int cholesky_lanes_f32(const float* in, float* out, long long nmat,
                                  int n, void* stream) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t full = ((size_t)n * n + n) * sizeof(float);
  const int in_smem = full <= (size_t)max_smem;
  const size_t smem = in_smem ? full : (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cholesky_lanes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = n <= 64 ? ((n + 31) / 32) * 32 : 256;
  cholesky_lanes_kernel<<<(unsigned int)nmat, threads, smem,
                          (cudaStream_t)stream>>>(in, out, n, in_smem);
  return (int)cudaGetLastError();
}
