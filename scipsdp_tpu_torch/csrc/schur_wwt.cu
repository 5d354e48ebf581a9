// Batched Gram product M[b] = W[b] W[b]^T in float32: the Schur complement
// of the float32 tiers with use_pallas, W = Wall (B, mp, F), the W features
// of every block and the LP rows stacked on one feature axis.
//
// Replaces: scipsdp_tpu/ops/pallas_kernels.py::schur_wwt (_gram_kernel),
// the TPU kernel that padded mp to the 128 MXU tile and F to 512-chunks and
// accumulated each output tile over an F grid axis, at
// Precision.HIGHEST (float32).
//
// Contract: W is (B, mp, F) row-major float32, contiguous; M is (B, mp, mp)
// float32, symmetric, written completely.  Products and sums in float32
// FMA (no TF32: it keeps ~10 bits and misses the 1e-5 bar of the JAX
// package's test), each sum in a fixed order: two launches agree bit for
// bit.
//
// What bounds it on an H100: at cls_32 B=32 (mp = 66, F = 4,290) the 36 MB
// read of W (11 us at 3.35 TB/s) just above the 0.6 GFLOP of the lower
// triangle (9 us at 67 TFLOP/s of float32 FMA); at cls_64 B=8 (mp = 130,
// F = 16,770) the 2.3 GFLOP (34 us) above its 70 MB (21 us).  Both need many
// blocks in flight, and the output is small against F: cls_64 has only
// 8 x 15 lower 32 x 32 tiles for 132 SMs.
//
// Design: two kernels in one launch call.
//  * gram_tiles: one block of 64 threads per (lower 32 x 32 output tile,
//    batch element, F-chunk).  F is split into chunks (a multiple of 32
//    long, chosen by the wrapper from the shapes alone: about 1,024 blocks,
//    at least 256 columns each) so that even cls_64 fills the card.  The
//    F loop stages 32-column slabs of the two row panels in shared memory
//    with 4-byte cp.async, double-buffered and transposed on the way
//    (k-major, rows padded to 33: conflict-free stores and loads); each
//    thread accumulates a 4 x 4 patch in registers.  The upper tiles are
//    never computed.  With one chunk it writes M and its mirror directly;
//    otherwise its partial tile goes to a float32 workspace (nchunks, B,
//    mp, mp) the wrapper allocates.
//  * gram_sum: the partial tiles added in chunk order, each sum written to
//    M[b][i][j] and M[b][j][i].
// TMA, wgmma and 3xTF32 splits are for a later redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;          // output tile edge
constexpr int kK = 32;          // F columns per stage
constexpr int kPad = kT + 1;    // padded row length of a staged slab
constexpr int kThreads = 64;    // 8 x 8 threads, a 4 x 4 patch each

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 4 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
gram_tiles(const float* __restrict__ W, float* __restrict__ dst, int B,
           int mp, long long F, int chunk_len, int direct) {
  __shared__ float s[2][2][kK][kPad];   // [stage][row panel i/j][k][row]
  // lower tile t -> (ti, tj), ti >= tj, t = ti (ti + 1) / 2 + tj
  const int t = blockIdx.x;
  int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const float* Wb = W + (size_t)b * mp * F;
  const long long f0 = (long long)c * chunk_len;
  const long long f1 = f0 + chunk_len < F ? f0 + chunk_len : F;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int nsteps = (int)((f1 - f0 + kK - 1) / kK);

  auto load_slab = [&](int step, int stage) {
    const long long fs = f0 + (long long)step * kK;
    for (int e = tid; e < 2 * kT * kK; e += kThreads) {
      const int op = e / (kT * kK);
      const int r = (e / kK) % kT;
      const int k = e % kK;
      const int row = (op ? tj : ti) * kT + r;
      const long long f = fs + k;
      const bool ok = row < mp && f < f1;
      cp_async4(&s[stage][op][k][r], ok ? Wb + (size_t)row * F + f : Wb, ok);
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (nsteps > 0) load_slab(0, 0);
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) {
      load_slab(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = step & 1;
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = s[st][0][k][ty + 8 * q];
        v[q] = s[st][1][k][tx + 8 * q];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t mm = (size_t)mp * mp;
  float* out = dst + ((size_t)c * B + b) * mm;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ti * kT + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = tj * kT + tx + 8 * j;
      if (r < mp && q < mp && q <= r) {
        out[(size_t)r * mp + q] = acc[i][j];
        if (direct) out[(size_t)q * mp + r] = acc[i][j];
      }
    }
  }
}

__global__ void gram_sum(const float* __restrict__ work, float* __restrict__ M,
                         int B, int mp, int nchunks) {
  const size_t mm = (size_t)mp * mp;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)B * mm) return;
  const size_t b = e / mm;
  const int i = (int)((e - b * mm) / mp);
  const int j = (int)(e - b * mm - (size_t)i * mp);
  if (j > i) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += work[((size_t)c * B + b) * mm + e - b * mm];
  M[b * mm + (size_t)i * mp + j] = s;
  M[b * mm + (size_t)j * mp + i] = s;
}

}  // namespace

// M[b] = W[b] W[b]^T for b < B, W (B, mp, F) float32, F split into
// ``nchunks`` chunks of ``chunk_len`` columns (the last one shorter; every
// chunk non-empty).  ``work`` holds nchunks * B * mp * mp floats when
// nchunks > 1 (unused otherwise).  Launched on ``stream`` on the current
// device; returns cudaGetLastError() after the launches (0 = launched).
extern "C" int schur_wwt_f32(const float* W, float* M, float* work, int B,
                             int mp, long long F, int nchunks, int chunk_len,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (mp + kT - 1) / kT;
  const dim3 grid((unsigned int)(tiles * (tiles + 1) / 2),
                  (unsigned int)nchunks, (unsigned int)B);
  const int direct = nchunks == 1;
  gram_tiles<<<grid, kThreads, 0, s>>>(W, direct ? M : work, B, mp, F,
                                       chunk_len, direct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const size_t total = (size_t)B * mp * mp;
  gram_sum<<<(unsigned int)((total + 255) / 256), 256, 0, s>>>(work, M, B,
                                                               mp, nchunks);
  return (int)cudaGetLastError();
}
