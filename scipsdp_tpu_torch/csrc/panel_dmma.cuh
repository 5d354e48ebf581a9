// Shared device code of the fused direction's bucket kernels
// (rhs_bucket.cu, recover_bucket.cu): float64 tensor-core products of one
// 16-row panel of an n x n matrix by a whole n x n matrix, both staged in
// shared memory, for n <= kMaxN.
//
// The fragment layout and the padded rows are bmm64.cu's: with g = lane / 4
// and t = lane % 4 a lane holds, of a 16 x 8 x 16 product, a[2 j + h] =
// A[g + 8 h][t + 4 j], b[j] = B[t + 4 j][g] and c[2 h + e] = C[g + 8 h][2 t
// + e].  A panel row is ld_a(n) doubles (4 mod 16), a row of the right
// operand ld_b64(n) doubles (4 or 12 mod 16) or ld_b32(n) floats (8 or 24
// mod 32), so that every fragment load touches each bank once.  K is
// padded with zeros to a multiple of 16 (kp = up(n, 16)) and the columns
// to a multiple of 8: every step is one m16n8k16 product, summed into one
// accumulator in k order, so that two launches agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace panel {

constexpr int kWarps = 9;              // a warp owns column fragments w, w + 9
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;              // rows of a panel
constexpr int kMaxN = 144;             // two column fragments a warp

__host__ __device__ constexpr int up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int ld_a(int n) { return up(n, 16) + 4; }
__host__ __device__ constexpr int ld_b64(int n) { return up(n, 8) + 4; }
__host__ __device__ constexpr int ld_b32(int n) {
  return up(n, 8) % 16 == 8 ? up(n, 8) : up(n, 8) + 8;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? BYTES : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void dmma_k16(double (&c)[4], const double (&a)[8],
                                         const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Copy rows x n of a row-major matrix (row stride n) into shared memory
// rows of ``ld`` elements, with zeros in columns [n, cols_pad) and in the
// whole of rows [rows, rows_pad): warp w copies rows w, w + warps, ..., a
// lane the columns lane, lane + 32, ... of each, one element a copy (the
// zeros are stored, not copied).  (16 bytes a copy, each row placed where
// its global alignment puts it, cost more in bank conflicts than it saved:
// odd n leaves half the rows off a 16-byte boundary.)  Not committed.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int rows,
                                      int n, int rows_pad, int cols_pad) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows_pad; r += warps) {
    T* d = dst + r * ld;
    if (r < rows) {
      const T* s = src + (size_t)r * n;
      for (int c = lane; c < n; c += 32)
        cp_async<(int)sizeof(T)>(d + c, s + c, true);
      for (int c = n + lane; c < cols_pad; c += 32) d[c] = T(0);
    } else {
      for (int c = lane; c < cols_pad; c += 32) d[c] = T(0);
    }
  }
}

// acc[f] = the panel As (kRows x kp, row stride lda) times column fragment
// warp + kWarps f of Bs (kp x 8 nfrag, row stride ldb), f = 0, 1; a
// fragment at or beyond nfrag is left at 0.
template <typename TB>
__device__ __forceinline__ void panel_product(double (&acc)[2][4],
                                              const double* As, int lda,
                                              const TB* Bs, int ldb, int kp,
                                              int nfrag) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[f][v] = 0.0;
  if (warp >= nfrag) return;
  const double* ap = As + g * lda + t;
  const TB* bp = Bs + t * ldb + warp * 8 + g;
  const bool two = warp + kWarps < nfrag;
#pragma unroll 3
  for (int k0 = 0; k0 < kp; k0 += 16) {
    double a[8], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[2 * j] = ap[k0 + 4 * j];
      a[2 * j + 1] = ap[8 * lda + k0 + 4 * j];
      b[j] = (double)bp[(k0 + 4 * j) * ldb];
    }
    dmma_k16(acc[0], a, b);
    if (two) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = (double)bp[(k0 + 4 * j) * ldb + 8 * kWarps];
      dmma_k16(acc[1], a, b);
    }
  }
}

}  // namespace panel
