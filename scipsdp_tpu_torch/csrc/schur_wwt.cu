// Batched Gram product M[b] = W[b] W[b]^T in float32: the Schur complement
// of the float32 tiers with use_pallas, W = Wall (B, mp, F), the W features
// of every block and the LP rows stacked on one feature axis.
//
// Replaces: scipsdp_tpu/ops/pallas_kernels.py::schur_wwt (_gram_kernel),
// the TPU kernel that padded mp to the 128 MXU tile and F to 512-chunks and
// accumulated each output tile over an F grid axis, at
// Precision.HIGHEST (float32).
//
// Contract: W is (B, mp, F) row-major float32, contiguous, any F; M is
// (B, mp, mp) float32, symmetric, written completely, to float32 accuracy
// (1e-5 of the largest entry is the bar of the JAX package's test; plain
// TF32 keeps ~10 bits and misses it).  Every sum in a fixed order: two
// launches agree bit for bit.
//
// What bounds it on an H100: at cls_32 B=32 (mp = 66, F = 4,290) the 36 MB
// read of W (11 us at 3.35 TB/s) above the three TF32 products per
// multiply-add of the lower triangle (1.8 GFLOP: 4 us at 495 TFLOP/s); at
// cls_64 B=8 (mp = 130, F = 16,770) its 70 MB (21 us) above 6.9 GFLOP
// (14 us).  So W should leave device memory once, in wide copies, with
// many bytes in flight, and the output is small against F: the F axis has
// to be split across blocks to fill 132 SMs.  Taken apart on the card
// (parts of the kernel cut out in turn, cls_32): of 59 us the products
// take about 28 (mma.sync starts one TF32 m16n8k8 per ~4 cycles a SM,
// well under the data sheet's rate), the copies ~10 that the pipeline does
// not hide, the splits and shared loads ~13; and the kernel lives on
// resident warps: a variant at 109 registers a thread ran 1.6x slower.
//
// Design: two kernels in one launch call.
//  * gram_mma: the TF32 tensor cores through
//    mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with a 3xTF32
//    split.  "row.col" takes A as M x K and B as N x K, both with k
//    contiguous: both operands are rows of W as they lie, so 32-column
//    slabs are copied straight into shared memory (no transposition) by
//    the widest cp.async the row stride allows, picked at launch from F:
//    16 bytes when F % 4 == 0, 8 when F is even (the solver's 4,290 and
//    16,770), else 4.  Shared rows are padded to 36 floats, so a
//    fragment's loads (g = lane / 4 picks the row, t = lane % 4 the
//    column) touch every bank once.  Each loaded value x is split in
//    registers, hi = tf32(x), lo = tf32(x - hi), and lo hi, hi lo, hi hi
//    are accumulated in float32 (lo lo, ~2^-22 of the product, is
//    dropped): float32 accuracy at a third of the TF32 rate.  The tensor
//    core's own float32 adds truncate, and over a chain of 3 F / 8
//    products that bias reaches 1.6e-5 of the diagonal at F = 16,770
//    (measured); so a chain ends with its slab (12 products) and the slab
//    sums are added by rounded float32 adds outside the tensor core.
//    Rows are cut into panels of 80.  One block owns (a pair of panels
//    I >= J, a batch element, an F-chunk) and stages the panels' rows of
//    each slab once, in a 3-stage ring: for mp <= 80 (cls_32, mkp_10) that
//    is all of W's rows, so every element leaves L2 once; cls_64 (130) has
//    three pairs.  A warp owns a 16-row fragment row and up to four 8-wide
//    fragment columns (one split A fragment feeds four products);
//    fragments wholly above the diagonal or beyond mp are skipped, so
//    mp = 66 computes 80 x 72, and a diagonal pair needs 9 warps (the
//    launch of a single panel has no more), any other pair 15; 62
//    registers a thread keep three 9-warp blocks on a SM.  With one
//    chunk a block writes M and its mirror directly; otherwise its partial
//    sums go to a float32 workspace (nchunks, B, mp, mp) the wrapper
//    allocates.
//  * gram_sum: the partial sums added in chunk order, each written to
//    M[b][i][j] and M[b][j][i].

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPanel = 80;              // rows of a panel
constexpr int kRowFrags = kPanel / 16;  // 16-row fragment rows of a panel
constexpr int kColFrags = kPanel / 8;   // 8-wide fragment columns
constexpr int kWarpCols = 4;            // fragment columns per warp
constexpr int kColGroups = (kColFrags + kWarpCols - 1) / kWarpCols;
constexpr int kWarpsPair = kRowFrags * kColGroups;   // 15
constexpr int kK = 32;                  // F columns per stage
constexpr int kLd = kK + 4;             // 36 = 4 (mod 32)
constexpr int kStages = 3;
constexpr int kPanelFloats = kPanel * kLd;

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? BYTES : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo + O(2^-22 x), both representable in TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c (16 x 8) += a (16 x 8, rows x k) b^T (b: 8 x 8, columns x k)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// fragment-column groups of fragment row i that a diagonal pair needs:
// group q starts at column 8 kWarpCols q, the row ends at 16 i + 15
__host__ __device__ constexpr int diag_groups(int i) {
  const int need = (2 * i + 1) / kWarpCols + 1;
  return need < kColGroups ? need : kColGroups;
}

constexpr int diag_warps() {
  int warps = 0;
  for (int i = 0; i < kRowFrags; ++i) warps += diag_groups(i);
  return warps;
}
constexpr int kWarpsDiag = diag_warps();   // 9: 1 + 1 + 2 + 2 + 3

// E: floats per copy
template <int E>
__global__ void __launch_bounds__(32 * kWarpsPair)
gram_mma(const float* __restrict__ W, float* __restrict__ dst, int B, int mp,
         long long F, int chunk_len, int direct) {
  extern __shared__ __align__(16) float smem[];   // [stage][panel][row][kLd]
  // pair p -> (I, J), I >= J, p = I (I + 1) / 2 + J
  const int p = blockIdx.x;
  int I = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (I * (I + 1) / 2 > p) --I;
  while ((I + 1) * (I + 2) / 2 <= p) ++I;
  const int J = p - I * (I + 1) / 2;
  const bool diag = I == J;
  const int npanels = gridDim.x == 1 ? 1 : 2;   // panels a stage has room for
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const float* Wb = W + (size_t)b * mp * F;
  const long long f0 = (long long)c * chunk_len;
  const long long f1 = f0 + chunk_len < F ? f0 + chunk_len : F;
  const int nslabs = (int)((f1 - f0 + kK - 1) / kK);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int rows_i = mp - I * kPanel < kPanel ? mp - I * kPanel : kPanel;
  const int rows_j = mp - J * kPanel < kPanel ? mp - J * kPanel : kPanel;

  // this warp's unit: fragment row i, fragment columns 4 q .. 4 q + 3
  int i = 0, q = warp;
  if (diag) {
    for (; i < kRowFrags && q >= diag_groups(i); ++i) q -= diag_groups(i);
  } else {
    i = warp / kColGroups;
    q = warp % kColGroups;
  }
  unsigned live = 0;                    // bit jj: fragment column 4 q + jj
  if (i < kRowFrags && 16 * i < rows_i) {
#pragma unroll
    for (int jj = 0; jj < kWarpCols; ++jj) {
      const int j = kWarpCols * q + jj;
      if (j < kColFrags && 8 * j < rows_j && (!diag || 8 * j <= 16 * i + 15))
        live |= 1u << jj;
    }
  }

  // each thread's share of a slab, fixed for the whole run: E floats at
  // one column position of every row_step-th staged row
  constexpr int kRowCopies = kK / E;
  const int kc = (tid % kRowCopies) * E;
  const int r0 = tid / kRowCopies;
  const int row_step = blockDim.x / kRowCopies;
  const int staged = (diag ? 1 : 2) * kPanel;

  auto load_slab = [&](int slab, int stage) {
    const long long f = f0 + (long long)slab * kK + kc;
    float* base = smem + (size_t)stage * npanels * kPanelFloats + kc;
    for (int r = r0; r < staged; r += row_step) {
      const int row = r < kPanel ? I * kPanel + r : J * kPanel + r - kPanel;
      const bool ok = row < mp && f < f1;
      cp_async<4 * E>(base + r * kLd, ok ? Wb + (size_t)row * F + f : Wb, ok);
    }
  };

  // the tensor core's float32 adds truncate, a bias that grows with the
  // length of the chain: a slab's 12 products are summed in ``part`` and
  // each slab sum is added to ``acc`` by a rounded float32 add
  float acc[kWarpCols][4], part[kWarpCols][4];
#pragma unroll
  for (int jj = 0; jj < kWarpCols; ++jj)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[jj][v] = part[jj][v] = 0.f;

  // every thread commits one group per slab slot, loaded or not, so that
  // wait_group counts the same on every thread
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslabs) load_slab(s, s);
    cp_async_commit();
  }
  for (int slab = 0; slab < nslabs; ++slab) {
    cp_async_wait<kStages - 2>();       // this slab has landed
    __syncthreads();                    // ... for all; the last one is read
    const int next = slab + kStages - 1;
    if (next < nslabs) load_slab(next, next % kStages);
    cp_async_commit();
    if (!live) continue;
    const float* Pa = smem + (size_t)(slab % kStages) * npanels * kPanelFloats;
    const float* Pb = diag ? Pa : Pa + kPanelFloats;
    const long long left = f1 - (f0 + (long long)slab * kK);
    const int steps = left >= kK ? kK / 8 : (int)((left + 7) / 8);
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      if (ks < steps) {
        const float* a = Pa + (16 * i + g) * kLd + ks * 8 + t;
        uint32_t ahi[4], alo[4];
        split_tf32(a[0], ahi[0], alo[0]);
        split_tf32(a[8 * kLd], ahi[1], alo[1]);
        split_tf32(a[4], ahi[2], alo[2]);
        split_tf32(a[8 * kLd + 4], ahi[3], alo[3]);
#pragma unroll
        for (int jj = 0; jj < kWarpCols; ++jj) {
          if (live >> jj & 1) {
            const float* v =
                Pb + (8 * (kWarpCols * q + jj) + g) * kLd + ks * 8 + t;
            uint32_t bhi[2], blo[2];
            split_tf32(v[0], bhi[0], blo[0]);
            split_tf32(v[4], bhi[1], blo[1]);
            mma_tf32(part[jj], alo, bhi);
            mma_tf32(part[jj], ahi, blo);
            mma_tf32(part[jj], ahi, bhi);
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kWarpCols; ++jj)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[jj][v] += part[jj][v];
        part[jj][v] = 0.f;
      }
  }
  cp_async_wait<0>();

  if (!live) return;
  const size_t mm = (size_t)mp * mp;
  float* out = dst + ((size_t)c * B + b) * mm;
#pragma unroll
  for (int jj = 0; jj < kWarpCols; ++jj) {
    if (!(live >> jj & 1)) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = I * kPanel + 16 * i + g + (v & 2 ? 8 : 0);
      const int col = J * kPanel + 8 * (kWarpCols * q + jj) + 2 * t + (v & 1);
      if (r < mp && col < mp && col <= r) {
        out[(size_t)r * mp + col] = acc[jj][v];
        if (direct) out[(size_t)col * mp + r] = acc[jj][v];
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

template <int E>
cudaError_t launch_mma(const float* W, float* dst, int B, int mp, long long F,
                       int nchunks, int chunk_len, int direct,
                       cudaStream_t s) {
  const int panels = (mp + kPanel - 1) / kPanel;
  const int pairs = panels * (panels + 1) / 2;
  const int warps = pairs == 1 ? kWarpsDiag : kWarpsPair;
  const size_t smem = (size_t)kStages * (pairs == 1 ? 1 : 2) * kPanelFloats *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_mma<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned int)pairs, (unsigned int)nchunks, (unsigned int)B);
  gram_mma<E><<<grid, 32 * warps, smem, s>>>(W, dst, B, mp, F, chunk_len,
                                             direct);
  return cudaGetLastError();
}

}  // namespace

// M[b] = W[b] W[b]^T for b < B, W (B, mp, F) float32, F split into
// ``nchunks`` chunks of ``chunk_len`` columns (a multiple of 32; the last
// chunk shorter; every chunk non-empty).  ``work`` holds nchunks * B * mp *
// mp floats when nchunks > 1 (unused otherwise).  Launched on ``stream`` on
// the current device; returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int schur_wwt_f32(const float* W, float* M, float* work, int B,
                             int mp, long long F, int nchunks, int chunk_len,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk_len % kK != 0) return (int)cudaErrorInvalidValue;
  const int direct = nchunks == 1;
  float* dst = direct ? M : work;
  cudaError_t err;
  if (F % 4 == 0 && (uintptr_t)W % 16 == 0)
    err = launch_mma<4>(W, dst, B, mp, F, nchunks, chunk_len, direct, s);
  else if (F % 2 == 0 && (uintptr_t)W % 8 == 0)
    err = launch_mma<2>(W, dst, B, mp, F, nchunks, chunk_len, direct, s);
  else
    err = launch_mma<1>(W, dst, B, mp, F, nchunks, chunk_len, direct, s);
  if (err != cudaSuccess || direct) return (int)err;
  const size_t total = (size_t)B * mp * mp;
  gram_sum<<<(unsigned int)((total + 255) / 256), 256, 0, s>>>(work, M, B,
                                                               mp, nchunks);
  return (int)cudaGetLastError();
}
