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
//     beyond it;
//   * every sum is taken in a fixed order (no atomics): two launches give
//     the same bits.
//
// What bounds it on an H100: the dependence of row i of X on rows j..i-1.
// Substitution one row at a time is a chain of n^2/2 dependent
// multiply-adds for column 0 (2,080 at n = 65); the operations (n^3/6 a
// matrix) and bytes (n(n+1)/2 floats in, n^2 out) are small.  So the time
// is the length of the dependent chain and the number of blocks in flight.
//
// Design (LAPACK's blocked trtri order, by block columns): X's block
// columns of width nb = kNB = 16 are independent (L X = I column by
// column), so the grid has one block per (matrix, block column j), the
// number of block columns from the caller (ops/kernels.py::tri_blocks,
// whose nb is this kNB).  In the block for block column j (rows from
// c0 = j nb on):
//   1. stage, with cp.async, the diagonal blocks L_ii (i >= j) and the
//      strips L[i-block rows][c0 .. i0) (transposed, so four rows of a
//      column are one float4), one copy group a strip, so that row block
//      i waits for its own strip only; where all strips do not fit in
//      shared memory (n > ~200) two strip slots take turns, the next strip
//      in flight while the current one is used;
//   2. every diagonal block is inverted at once, one group of nb lanes a
//      block, a lane a column, the column in registers: chains of nb^2/2;
//   3. row block by row block, X_ij = -L_ii^-1 (sum_{k<i} L_ik X_kj),
//      X_jj = L_jj^-1: each thread sums a register tile of nb/4 rows of
//      one column over k (independent FMAs from shared memory), then the
//      product with L_ii^-1 takes the tile's other rows from the lanes of
//      its own warp by shuffles, so a row block needs one block barrier.
// The dependent depth falls from n^2/2 to nb (the diagonal inverses) plus
// one short sum a row block.  X's block column stays in shared memory and
// is written to device memory as each row block is done; the rows above
// the block column are written as zeros.

#include <cuda_runtime.h>

#include "tri_factor.cuh"

namespace {

constexpr int kNB = 16;              // block column width: a half warp
constexpr int kThreads = 128;        // a block, at least the kNB/8 step warps
constexpr int kBlockThreads = kThreads > kNB * 4 ? kThreads : kNB * 4;
constexpr unsigned kFull = 0xffffffffu;

// row strides in shared memory: diagonal inverses and strips (a multiple
// of 4 floats, for float4 reads), and X's block column
constexpr int LDS = kNB + 4;
constexpr int LDX = kNB + 2;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most ``pending`` of this thread's committed copy groups
// are still in flight (more than 7 waits as for 7).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Shared floats of the block for block column 0 (the largest): nblk
// diagonal inverses, X's block column, and every strip (fit) or two slots.
size_t smem_floats(int nblk, bool fit) {
  const size_t m = nblk;
  const size_t strips = fit ? LDS * kNB * (m - 1) * m / 2 : 2 * LDS * kNB * (m - 1);
  return m * kNB * LDS + m * kNB * LDX + strips;
}

__global__ void __launch_bounds__(kBlockThreads)
    tril_inverse_kernel(const float* __restrict__ in, float* __restrict__ out,
                        int n, int nblk, int fit) {
  constexpr int TR = kNB / 4;   // rows of a thread's tile in a row block
  constexpr int SW = kNB / 8;   // warps that compute a row block (8 columns each)
  extern __shared__ __align__(16) float smem[];
  const int jb = (int)(blockIdx.x % (unsigned)nblk);
  const size_t mat = blockIdx.x / (unsigned)nblk;
  const float* L = in + mat * n * n;
  float* O = out + mat * n * n;
  const int c0 = jb * kNB;
  const int w = min(kNB, n - c0);      // live columns of this block column
  const int m = nblk - jb;            // row blocks from jb on
  const int tid = threadIdx.x, nt = blockDim.x;
  float* Dinv = smem;                            // m blocks of kNB x LDS
  float* X = Dinv + (size_t)m * kNB * LDS;        // m kNB rows of LDX
  float* strips = X + (size_t)m * kNB * LDX;
  // strip s (row block jb + s, s >= 1): Lt[k][p] = L[i0 + p][c0 + k],
  // k < s kNB, rows past n zero
  auto strip = [&](int s) -> float* {
    return fit ? strips + (size_t)LDS * kNB * (s - 1) * s / 2
               : strips + (size_t)(s & 1) * LDS * kNB * (m - 1);
  };
  // a thread copies (k, p) = (e / kNB, e % kNB): 16 rows a warp, their
  // shared writes contiguous and the division a shift
  auto load_strip = [&](int s) {
    float* dst = strip(s);
    const int width = s * kNB;
    const float* src = L + (size_t)(c0 + s * kNB) * n + c0;
    for (int e = tid; e < width * kNB; e += nt) {
      const int k = e / kNB, p = e % kNB;
      if (c0 + s * kNB + p < n) cp_async4(dst + k * LDS + p, src + (size_t)p * n + k);
      else dst[k * LDS + p] = 0.f;
    }
  };

  // 1. the diagonal blocks (lower part; identity past n) and the strips
  for (int e = tid; e < m * kNB * kNB; e += nt) {
    const int s = e / (kNB * kNB), p = (e / kNB) % kNB, q = e % kNB;
    const int row = c0 + s * kNB + p, col = c0 + s * kNB + q;
    float* d = Dinv + (size_t)s * kNB * LDS + p * LDS + q;
    if (row < n && q <= p) cp_async4(d, L + (size_t)row * n + col);
    else *d = (row >= n && p == q) ? 1.f : 0.f;
  }
  cp_async_commit();
  // one copy group a strip: step s waits for strip s only
  const int issued = fit ? m - 1 : min(m - 1, 1);
  for (int s = 1; s <= issued; ++s) {
    load_strip(s);
    cp_async_commit();
  }
  // the rows above the block column are zero
  for (int e = tid; e < c0 * kNB; e += nt) {
    const int r = e / kNB, c = e % kNB;
    if (c < w) O[(size_t)r * n + c0 + c] = 0.f;
  }
  cp_async_wait(issued);   // the diagonal blocks
  __syncthreads();

  // 2. invert every diagonal block: lane c of a group of kNB solves
  // L_ii x = e_c in registers, x_r = (delta_rc - sum_{k<r} L[r][k] x_k) /
  // L[r][r] (times the reciprocal); written back transposed,
  // Dinv_i[l][r] = (L_ii^-1)[r][l]
  {
    const int groups = nt / kNB, g = tid / kNB, c = tid % kNB;
    for (int round = 0; round * groups < m; ++round) {
      // a group past the last block (s >= m) reads and writes nothing, but
      // takes part in every __syncwarp of its warp
      const int s = round * groups + g;
      float* D = Dinv + (size_t)s * kNB * LDS;
      float x[kNB];
      if (s < m) {
        // the reciprocals first: their IEEE routine branches, and the
        // substitution after them stays one block the compiler interleaves
        float rd[kNB];
#pragma unroll
        for (int r = 0; r < kNB; ++r) rd[r] = __frcp_rn(D[r * LDS + r]);
#pragma unroll
        for (int r = 0; r < kNB; ++r) {
          const float* Dr = D + r * LDS;
          float acc = (r == c) ? 1.f : 0.f;
#pragma unroll
          for (int k = 0; k < r; ++k) acc = fmaf(-Dr[k], x[k], acc);
          x[r] = r >= c ? acc * rd[r] : 0.f;
        }
      }
      __syncwarp();
      if (s < m) {
#pragma unroll
        for (int r = 0; r < kNB; ++r) D[c * LDS + r] = x[r];
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. the row blocks in order; warp wi < SW computes columns 8 wi ..
  // 8 wi + 7, lane (rg, cc) rows rg TR .. rg TR + TR - 1 of column 8 wi + cc
  const int wi = tid / 32, lane = tid % 32, rg = lane / 8, cc = lane % 8;
  const int c = wi * 8 + cc;
  for (int s = 0; s < m; ++s) {
    if (s > 0) {
      cp_async_wait(fit ? m - 1 - s : 0);   // strip s has landed
      __syncthreads();       // for every thread, and X's earlier rows too
      if (!fit && s + 1 < m) {
        load_strip(s + 1);
        cp_async_commit();
      }
    }
    if (wi >= SW) continue;
    const float* Di = Dinv + (size_t)s * kNB * LDS;
    float res[TR];
    if (s == 0) {
#pragma unroll
      for (int t = 0; t < TR; ++t) res[t] = Di[c * LDS + rg * TR + t];
    } else {
      const float* Lt = strip(s);
      float R[TR];
#pragma unroll
      for (int t = 0; t < TR; ++t) R[t] = 0.f;
      const int width = s * kNB;
#pragma unroll 4
      for (int k = 0; k < width; ++k) {
        const float xv = X[k * LDX + c];
#pragma unroll
        for (int t4 = 0; t4 < TR; t4 += 4) {
          const float4 l4 =
              *reinterpret_cast<const float4*>(Lt + k * LDS + rg * TR + t4);
          R[t4] = fmaf(l4.x, xv, R[t4]);
          R[t4 + 1] = fmaf(l4.y, xv, R[t4 + 1]);
          R[t4 + 2] = fmaf(l4.z, xv, R[t4 + 2]);
          R[t4 + 3] = fmaf(l4.w, xv, R[t4 + 3]);
        }
      }
      float acc[TR];
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[t] = 0.f;
#pragma unroll
      for (int l = 0; l < kNB; ++l) {
        const float v = __shfl_sync(kFull, R[l % TR], (l / TR) * 8 + cc);
#pragma unroll
        for (int t4 = 0; t4 < TR; t4 += 4) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(Di + l * LDS + rg * TR + t4);
          acc[t4] = fmaf(d4.x, v, acc[t4]);
          acc[t4 + 1] = fmaf(d4.y, v, acc[t4 + 1]);
          acc[t4 + 2] = fmaf(d4.z, v, acc[t4 + 2]);
          acc[t4 + 3] = fmaf(d4.w, v, acc[t4 + 3]);
        }
      }
#pragma unroll
      for (int t = 0; t < TR; ++t) res[t] = -acc[t];
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int k = s * kNB + rg * TR + t;
      X[k * LDX + c] = res[t];
      if (c < w && c0 + k < n) O[(size_t)(c0 + k) * n + c0 + c] = res[t];
    }
  }
}

}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device, in ``nblk`` block columns of kNB columns, the last one
// non-empty; returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for a split it does not take.
extern "C" int tril_inverse_f32(const float* in, float* out, long long nmat,
                                int n, int nblk, void* stream) {
  if (nblk < 1 || (long long)(nblk - 1) * kNB >= n ||
      (long long)nblk * kNB < n || nmat * nblk >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int max_smem = 0;
  cudaError_t err = tri::smem_limit(&max_smem);
  if (err != cudaSuccess) return (int)err;
  const bool fit = smem_floats(nblk, true) * sizeof(float) <= (size_t)max_smem;
  const size_t smem = smem_floats(nblk, fit) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = tri::smem_opt_in(tril_inverse_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tril_inverse_kernel<<<(unsigned int)(nmat * nblk), kBlockThreads, smem,
                        (cudaStream_t)stream>>>(in, out, n, nblk, (int)fit);
  return (int)cudaGetLastError();
}
