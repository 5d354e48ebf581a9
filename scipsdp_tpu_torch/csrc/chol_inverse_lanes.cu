// Fused A -> L^-1 (A = L L^T) of N independent float32 n x n matrices:
// the Cholesky factorization and the triangular inverse in one launch,
// only the inverse written.
//
// Replaces: scipsdp_tpu/ops/pallas_kernels.py::chol_inverse_lanes
// (_cholinv_lanes_kernel), the TPU kernel that laid 128 matrices on the
// lane axis and ran the forward substitution on an identity block
// interleaved with the right-looking elimination: at step k, d = sqrt(a_kk),
// c = a_:k / d, A22 -= c r^T, row k of X scaled by 1/d, the rows below
// minus c x_k.  The JAX package has no solver caller for it (its tests and
// a profiling script use it); the port keeps the function and its
// contract.
//
// Contract:
//   * in/out are (N, n, n) row-major float32, N = product of leading dims,
//     any leading batch shape (no lanes layout, no padding);
//   * only the lower triangle of A is read;
//   * out is L^-1, exact zeros above the diagonal;
//   * a matrix that is not positive definite (a pivot that is not a
//     positive normal float: <= 0, subnormal, +inf or NaN) comes back NaN
//     on and below its diagonal, and no other matrix is touched;
//   * every sum is taken in a fixed order (no atomics): two launches give
//     the same bits.
//
// Arithmetic: the TPU kernel's algorithm in panels.  A pivot c gives
// rs = 1/sqrt(c) from the hardware's reciprocal square root and one Newton
// step (branch-free, within an ulp), and L's diagonal itself is never
// formed: l_iq = (a_iq - sum_{t<q} l_it l_qt) * rs_q, and X's rows are
// solved against the diagonal block by x_q = (x_q - sum_{t<q} l_qt x_t) *
// rs_q, each sum one fmaf a term in column order.  The rank-nb updates of
// the trailing part and of X's rows below take each panel's sum from zero
// (fmaf in column order) and subtract it once: an element is rounded at
// its own scale once a panel, not once a column, which keeps the pivots'
// error (and so the inverse's diagonal, 1/sqrt of a pivot) 2-5x below a
// column-by-column update's on an ill-conditioned stack.
//
// What bounds it on an H100: the dependent steps of one matrix.  The work
// is tiny next to the card's float32 rate (n = 65: ~180 kFLOP a matrix)
// and the bytes are n(n+1)/2 floats in and n^2 out (bound ~0.5 us at the
// cls_32 X/S stack, 64 x 65^2, under the ~2 us an empty launch takes), so
// the time is the chain of the factorization and the substitution, the block
// barriers between their steps, and how many matrices are in flight.  The
// parent design ran the two unblocked one after the other: two barriers a
// column for the left-looking factor and then a thread a column of X, a
// chain of ~n^2/2 dependent FMAs for column 0.
//
// Design: blocked right-looking panels of nb = kNB = 16 columns (the panel
// count from the caller, ops/kernels.py::tri_blocks, whose nb is this kNB)
// with X carried along, one block a matrix (kThreads threads), padded to
// whole panels with an identity tail.  A and X share ONE buffer: before
// panel k0 .. k1 = k0 + nb, the columns < k0 of its lower triangle hold X
// (final in the rows < k0) and the columns >= k0 the trailing part of A;
// X's columns >= k0 are still the identity and are not stored.  Each panel:
//   (a) the nb x nb diagonal block factored in registers by a group of nb
//       lanes of warp 0 (a lane a row, the columns exchanged by shuffles),
//       into a small buffer S (L11 with rs on its diagonal);
//   (b) the rows below solved against it, L21 = A21 L11^-T, a thread a row,
//       into a panel buffer P (transposed, for float4 reads);
//   (d1) at the same time X's panel rows, X_p <- L11^-1 X_p, a thread a
//       column (chains of nb), over the columns < k1, written in place of
//       A11 (the columns from k0 on start as the identity);
//   (c) the trailing lower triangle updated, A22 -= L21 L21^T, and
//   (d2) X's rows below, X_below -= L21 X_p over the columns < k1 (those
//       from k0 on start from zero), both in 4 x 4 tiles a thread with two
//       float4 reads per 16 FMAs, by all warps but warp 0; the next
//       diagonal block's tiles are warp 1's first, and a named barrier
//       hands them to warp 0, which factors that block (the next panel's
//       (a)) while the other tiles are updated: looking ahead;
// with one block barrier after (b)+(d1) and one after (c)+(d2): 2 n/nb a
// matrix (10 at n = 65, against 130 for the parent's factor alone), L never
// leaves the block, and every thread works in every phase.  Warp 0 records
// a failed pivot in a shared flag, read once when the output is written.
// The look-ahead factor (16 dependent columns of a reciprocal square root
// and shuffles) is the longest chain of a panel (profile_torch_kernels.py
// dissect cholinv); warp 0 once also updated the block itself (272 shared
// loads a lane), and the kernel took 0.028 ms at the cls_32 X/S stack
// where it now takes 0.021 (NVIDIA H100 80GB HBM3 at 700 W; 0.049 for
// cholesky.cu then tril_inverse.cu, 0.082 for the parent design).
// n <= nb takes one group of nb lanes a matrix, several matrices a block
// and no block barrier.  The shared buffer is np rows of tri::smem_ld(np)
// floats (np = 16 * panels): it fits up to n = 224 (219 KB at np = 224);
// above that the matrix stays in the output buffer in device memory (the
// L2 holds it) and only the panel, X's panel rows and the diagonal block
// are staged, with no workspace.
// A thread-block cluster of two blocks a matrix (one owning A and running
// (a), (b), (c), the other owning X and running (d1), (d2), L11 and L21
// written into its shared memory, a cluster barrier for each block
// barrier; profile_torch_kernels.py variants cholinv builds it from this
// source) was 13-27 % slower at the float32 tiers' shapes: its barriers
// cost more than the tiles it splits.  Hence the optional second copies of
// S and P (S2, P2) below.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "tri_factor.cuh"

namespace {

constexpr int kNB = 16;              // panel width: a half warp
constexpr int kThreads = 512;        // a block of the general kernel
constexpr int kTinyThreads = 256;    // n <= kNB: groups of kNB lanes
constexpr int LDS = kNB + 4;         // row stride of S (float4 reads)
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

// 1 / sqrt(c) for a positive normal float c, within an ulp: the hardware's
// approximation (relative error < 2^-22.9) and one Newton step; NaN for
// any other c.  No branch: an IEEE routine's slow-path branch would split
// the unrolled column loop of factor_block.
__device__ __forceinline__ float pivot_rsqrt(float c) {
  float y = rsqrt_approx(c);
  const float e = fmaf(-(c * y), y, 1.f);
  y = fmaf(0.5f * y, e, y);
  return (c >= FLT_MIN && c <= FLT_MAX) ? y : tri::qnan();
}

// Cholesky of one kNB x kNB block held by a group of kNB lanes, lane r
// holding row r in a[] (entries above the diagonal are ignored).  On return
// a[q] = L[r][q] below the diagonal, a[r] = 1 / L[r][r], 0 above; ok is
// false if a pivot was not a positive normal float (the same in every lane
// of the group).  All 32 lanes of the warp must call it.  Every lane keeps
// the whole diagonal (dg), updated with the same fmaf as its owner's, so
// each pivot is known to all lanes without a shuffle of its own.
__device__ __forceinline__ void factor_block(float (&a)[kNB], int r,
                                             bool& ok) {
  float dg[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t) dg[t] = __shfl_sync(kFull, a[t], t, kNB);
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    const float c = dg[q];
    ok = ok && c >= FLT_MIN && c <= FLT_MAX;
    const float rs = pivot_rsqrt(c);
    const float l = r > q ? a[q] * rs : 0.f;
    a[q] = r == q ? rs : l;
#pragma unroll
    for (int t = q + 1; t < kNB; ++t) {
      const float lt = __shfl_sync(kFull, l, t, kNB);
      if (r >= t) a[t] = fmaf(-l, lt, a[t]);
      dg[t] = fmaf(-lt, lt, dg[t]);
    }
  }
}

// n <= kNB: group g of kNB lanes takes matrix g whole, identity-padded:
// the factor in registers, then L11 through shared memory to the lanes,
// lane c solving column c of X.
__global__ void __launch_bounds__(kTinyThreads)
    chol_inverse_tiny_kernel(const float* __restrict__ in,
                             float* __restrict__ out, long long nmat, int n) {
  __shared__ __align__(16) float Sg[kTinyThreads / kNB][kNB * LDS];
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kNB;
  const int r = threadIdx.x % kNB;
  float* S = Sg[threadIdx.x / kNB];
  const bool live = g < nmat;     // dead groups compute too: whole shuffles
  const float* A = in + (size_t)(live ? g : 0) * n * n;
  float a[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t)
    a[t] = (r < n && t <= r) ? A[r * n + t] : (t == r ? 1.f : 0.f);
  bool ok = true;
  factor_block(a, r, ok);
#pragma unroll
  for (int t = 0; t < kNB; ++t) S[r * LDS + t] = a[t];
  __syncwarp();
  float x[kNB];
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    float s = q == r ? 1.f : 0.f;
#pragma unroll
    for (int t = 0; t < q; ++t) s = fmaf(-S[q * LDS + t], x[t], s);
    x[q] = s * S[q * LDS + q];
  }
  if (!live || r >= n) return;
  float* O = out + (size_t)g * n * n;
#pragma unroll
  for (int q = 0; q < kNB; ++q)
    if (q < n) O[q * n + r] = r > q ? 0.f : (ok ? x[q] : tri::qnan());
}

// Shared floats of the general kernel: the buffer (np rows of ld; where it
// stays in device memory, X's panel rows Xp instead, kNB rows of np), the
// panel buffer P (kNB rows of np), the factored diagonal block S (kNB rows
// of LDS) and the failed-pivot flag.
size_t smem_floats(int np, int ld, bool in_smem) {
  return (in_smem ? (size_t)np * ld : (size_t)kNB * np) + (size_t)kNB * np +
         kNB * LDS + 1;
}

// The working buffer: np x np, stored rows and columns < nv at row stride
// ld (nv = np in shared memory; in device memory nv = n, the rows and
// columns past n read as the identity and are never written).
struct Buf {
  float* w;
  int ld, nv;
  bool smem;
  __device__ __forceinline__ float get(int r, int c) const {
    return (r < nv && c < nv) ? w[(size_t)r * ld + c] : (r == c ? 1.f : 0.f);
  }
  __device__ __forceinline__ void put(int r, int c, float v) const {
    if (r < nv && c < nv) w[(size_t)r * ld + c] = v;
  }
  // four consecutive columns c0 .. c0 + 3 of row r (c0 a multiple of 4)
  __device__ __forceinline__ float4 get4(int r, int c0) const {
    if (smem) return *reinterpret_cast<const float4*>(w + (size_t)r * ld + c0);
    return make_float4(get(r, c0), get(r, c0 + 1), get(r, c0 + 2),
                       get(r, c0 + 3));
  }
  __device__ __forceinline__ void put4(int r, int c0, float4 v) const {
    if (smem) {
      *reinterpret_cast<float4*>(w + (size_t)r * ld + c0) = v;
    } else {
      put(r, c0, v.x); put(r, c0 + 1, v.y);
      put(r, c0 + 2, v.z); put(r, c0 + 3, v.w);
    }
  }
};

// Named barrier 1 of warps 0 and 1: warp 1 arrives once it has written
// the next diagonal block's tiles, warp 0 waits for them.
__device__ __forceinline__ void diagonal_tiles_arrive() {
  __syncwarp();
  asm volatile("bar.arrive 1, 64;\n" ::: "memory");
}

__device__ __forceinline__ void diagonal_tiles_wait() {
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

// (a), by warp 0 (all 32 lanes; a group of kNB lanes a copy): the diagonal
// block at rows and columns k1 .. k1 + kNB of the buffer (updated by the
// tiles), factored into S (and S2, where given); a failed pivot sets
// *flag.
__device__ __forceinline__ void diagonal_block(const Buf& W, int k1,
                                               float* S, float* S2,
                                               int* flag) {
  const int r = threadIdx.x % kNB;
  float a[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t) a[t] = t > r ? 0.f : W.get(k1 + r, k1 + t);
  bool ok = true;
  factor_block(a, r, ok);
  if (threadIdx.x < kNB) {
#pragma unroll
    for (int t = 0; t < kNB; ++t) S[r * LDS + t] = a[t];
    if (S2 != nullptr) {
#pragma unroll
      for (int t = 0; t < kNB; ++t) S2[r * LDS + t] = a[t];
    }
    if (r == 0 && !ok) *flag = 1;
  }
}

// (b) row i of L21: l_q = (a_iq - sum_{t<q} l_t L11[q][t]) * rs_q, into
// P[q][i] (and P2, where given)
__device__ __forceinline__ void row_solve(const Buf& W, const float* S,
                                          float* P, float* P2, int np,
                                          int k0, int i) {
  float l[kNB];
#pragma unroll
  for (int t4 = 0; t4 < kNB; t4 += 4) {
    const float4 v = W.get4(i, k0 + t4);
    l[t4] = v.x; l[t4 + 1] = v.y; l[t4 + 2] = v.z; l[t4 + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    float s = l[q];
#pragma unroll
    for (int t4 = 0; t4 < q; t4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(S + q * LDS + t4);
      const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t4 + u < q) s = fmaf(-l[t4 + u], sv[u], s);
    }
    l[q] = s * S[q * LDS + q];
    P[q * np + i] = l[q];
    if (P2 != nullptr) P2[q * np + i] = l[q];
  }
}

// (d1) column c < k1 of X's panel rows k0 .. k1: x_q = (x_q - sum_{t<q}
// L11[q][t] x_t) * rs_q, from X (c < k0) or the identity (c >= k0), written
// back whole (exact zeros above the diagonal), and into Xp[q][c] where the
// buffer is in device memory
__device__ __forceinline__ void col_solve(const Buf& W, const float* S,
                                          float* Xp, int np, int k0, int c) {
  float x[kNB];
#pragma unroll
  for (int q = 0; q < kNB; ++q)
    x[q] = c < k0 ? W.get(k0 + q, c) : (c - k0 == q ? 1.f : 0.f);
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    float s = x[q];
#pragma unroll
    for (int t4 = 0; t4 < q; t4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(S + q * LDS + t4);
      const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t4 + u < q) s = fmaf(-sv[u], x[t4 + u], s);
    }
    x[q] = s * S[q * LDS + q];
  }
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    W.put(k0 + q, c, x[q]);
    if (!W.smem) Xp[q * np + c] = x[q];
  }
}

// The 4 x 4 tile of sums over the panel's kNB columns of P's entries r0 ..
// r0 + 3 times right(k), four consecutive entries of row k of the right
// factor (P's columns for (c), X's panel rows for (d2)): from zero, fmaf in
// k order.
template <typename Right>
__device__ __forceinline__ void tile_sum(float (&acc)[4][4], const float* P,
                                         int np, int r0, Right right) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    const float4 pr = *reinterpret_cast<const float4*>(P + k * np + r0);
    const float4 pc = right(k);
    const float lr[4] = {pr.x, pr.y, pr.z, pr.w};
    const float lc[4] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(lr[u], lc[v], acc[u][v]);
  }
}

// The tile at (r0, c0) of the buffer (``stored``) or of zeros, minus acc,
// back into the buffer.
__device__ __forceinline__ void subtract_tile(const Buf& W, int r0, int c0,
                                              const float (&acc)[4][4],
                                              bool stored) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 b = stored ? W.get4(r0 + u, c0) : make_float4(0, 0, 0, 0);
    W.put4(r0 + u, c0, make_float4(b.x - acc[u][0], b.y - acc[u][1],
                                   b.z - acc[u][2], b.w - acc[u][3]));
  }
}

// Tiles of (c) and (d2) of the panel k0 .. k1 for T = (np - k1) / 4 tile
// rows: the trailing lower triangle's T (T + 1) / 2 tiles in row order (the
// next diagonal block's (kNB / 4) (kNB / 4 + 1) / 2 first), then X's
// T x k1 / 4.

// (c) trailing tile number t: tile row tr, tile column tc <= tr
__device__ __forceinline__ void a_tile(const Buf& W, const float* P, int np,
                                       int k1, int t) {
  int tr = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (tr * (tr + 1) / 2 > t) --tr;
  while ((tr + 1) * (tr + 2) / 2 <= t) ++tr;
  const int tc = t - tr * (tr + 1) / 2;
  const int r0 = k1 + 4 * tr, c0 = k1 + 4 * tc;
  float acc[4][4];
  tile_sum(acc, P, np, r0, [&](int k) {
    return *reinterpret_cast<const float4*>(P + k * np + c0);
  });
  subtract_tile(W, r0, c0, acc, true);
}

// (d2) X tile number t: rows k1 + 4 (t / (k1/4)) .., columns 4 (t % (k1/4))
// .., X's panel rows read from the buffer in shared memory, else from Xp
__device__ __forceinline__ void x_tile(const Buf& W, const float* P,
                                       const float* Xp, int np, int k0,
                                       int k1, int t) {
  const int ct = k1 / 4;
  const int tr = t / ct, tc = t - tr * ct;
  const int r0 = k1 + 4 * tr, c0 = 4 * tc;
  float acc[4][4];
  tile_sum(acc, P, np, r0, [&](int k) {
    return W.smem ? W.get4(k0 + k, c0)
                  : *reinterpret_cast<const float4*>(Xp + k * np + c0);
  });
  subtract_tile(W, r0, c0, acc, c0 < k0);
}

// The lower triangle of A into the buffer (4-byte copies: rows of odd n
// are not 16-byte aligned), the identity tail in shared memory; the copies
// into shared memory are still in flight on return (cp_async_wait_all).
__device__ __forceinline__ void stage(const float* __restrict__ A, float* O,
                                      const Buf& W, int n, int np) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < np; r += blockDim.x / 32) {
    for (int c = lane; c <= r; c += 32) {
      if (r < n && c < n) {
        if (W.smem) cp_async4(W.w + (size_t)r * W.ld + c, A + (size_t)r * n + c);
        else O[(size_t)r * n + c] = A[(size_t)r * n + c];
      } else if (W.smem) {
        W.w[(size_t)r * W.ld + c] = r == c ? 1.f : 0.f;
      }
    }
  }
}

// The n x n output: X (NaN on and below the diagonal of a matrix that is
// not positive definite), exact zeros above the diagonal.
__device__ __forceinline__ void write_out(float* O, const Buf& W, int n,
                                          bool ok) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += blockDim.x / 32) {
    for (int j = lane; j < n; j += 32) {
      if (j > i) O[(size_t)i * n + j] = 0.f;
      else if (!ok) O[(size_t)i * n + j] = tri::qnan();
      else if (W.smem) O[(size_t)i * n + j] = W.w[(size_t)i * W.ld + j];
    }
  }
}

// The general kernel's body, with the buffer in shared memory (in_smem, a
// constant in each of the two kernels below) or in device memory
__device__ __forceinline__ void chol_inverse_body(const float* __restrict__ in,
                                                  float* out, int n, int np,
                                                  int ld, bool in_smem) {
  extern __shared__ __align__(16) float smem[];
  const float* A = in + (size_t)blockIdx.x * n * n;
  float* O = out + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32;
  const Buf W{in_smem ? smem : O, in_smem ? ld : n, in_smem ? np : n,
              in_smem};
  float* Xp = smem;                          // device memory: X_p[q][c]
  float* P = smem + (in_smem ? (size_t)np * ld : (size_t)kNB * np);
  float* S = P + (size_t)kNB * np;           // L11, rs on its diagonal
  int* flag = reinterpret_cast<int*>(S + kNB * LDS);

  if (tid == 0) *flag = 0;   // warp 0's own: no barrier before its use
  // the first diagonal block straight from A while the copies land
  stage(A, O, W, n, np);
  if (warp == 0)
    diagonal_block(Buf{const_cast<float*>(A), n, n, false}, 0, S, nullptr,
                   flag);
  cp_async_wait_all();
  __syncthreads();

  for (int k0 = 0; k0 < np; k0 += kNB) {
    const int k1 = k0 + kNB;
    // (b) the rows below, then (d1) X's panel rows, a thread each
    const int nrows = np - k1;
    for (int t = tid; t < np; t += nt) {
      if (t < nrows) row_solve(W, S, P, nullptr, np, k0, k1 + t);
      else col_solve(W, S, Xp, np, k0, t - nrows);
    }
    __syncthreads();
    // (c) and (d2) by warps 1.., the next diagonal block's tiles first (by
    // warp 1), warp 0 then factoring that block: looking ahead
    const int T = nrows / 4;
    const int na = T * (T + 1) / 2, ntiles = na + T * (k1 / 4);
    if (warp == 0) {
      if (k1 < np) {
        diagonal_tiles_wait();
        diagonal_block(W, k1, S, nullptr, flag);
      }
    } else {
      auto tile = [&](int t) {
        if (t < na) a_tile(W, P, np, k1, t);
        else if (t < ntiles) x_tile(W, P, Xp, np, k0, k1, t - na);
      };
      tile(tid - 32);   // warp 1: the diagonal block's tiles among them
      if (warp == 1 && k1 < np) diagonal_tiles_arrive();
      for (int t = tid - 32 + nt - 32; t < ntiles; t += nt - 32) tile(t);
    }
    __syncthreads();
  }
  write_out(O, W, n, *flag == 0);
}

__global__ void __launch_bounds__(kThreads, 1)
    chol_inverse_kernel(const float* __restrict__ in, float* out, int n,
                        int np, int ld) {
  chol_inverse_body(in, out, n, np, ld, true);
}

__global__ void __launch_bounds__(kThreads, 1)
    chol_inverse_global_kernel(const float* __restrict__ in, float* out,
                               int n, int np) {
  chol_inverse_body(in, out, n, np, n, false);
}

}  // namespace

// Launch on ``stream`` for ``nmat`` matrices of size n on the current
// device, in ``npan`` panels of kNB columns, the last one non-empty;
// returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for a split it does not take.
extern "C" int chol_inverse_lanes_f32(const float* in, float* out,
                                      long long nmat, int n, int npan,
                                      void* stream) {
  if (npan < 1 || (long long)(npan - 1) * kNB >= n ||
      (long long)npan * kNB < n || nmat >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (npan == 1) {   // n <= kNB
    const long long blocks = (nmat * kNB + kTinyThreads - 1) / kTinyThreads;
    chol_inverse_tiny_kernel<<<(unsigned int)blocks, kTinyThreads, 0, st>>>(
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
    err = tri::smem_opt_in(chol_inverse_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    chol_inverse_kernel<<<(unsigned int)nmat, kThreads, smem, st>>>(
        in, out, n, np, ld);
  } else {
    err = tri::smem_opt_in(chol_inverse_global_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    chol_inverse_global_kernel<<<(unsigned int)nmat, kThreads, smem, st>>>(
        in, out, n, np);
  }
  return (int)cudaGetLastError();
}
