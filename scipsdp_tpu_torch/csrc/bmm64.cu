// Batched float64 matrix product C[g] = A[g] B[g] of G square n x n
// matrices: the exact products of the refine interior-point tier (X Rp,
// (Rc - X Rp) S^-1, X dS, X S, dX_a dS_a and the Gondzio trial products).
//
// Replaces: scipsdp_tpu/ops/df32.py::dd_bmm (_bmm_kernel) and
// _dd_bmm_lanes (_bmm_lanes_kernel).  The TPU has no float64, so those
// kernels carried every operand as a float32 hi/lo pair and every
// multiply-add as TwoProd + TwoSum, for ~2^-45 relative accuracy.  Hopper
// has native float64 (one rounding of 2^-53 per multiply-add, on the FMA
// pipe and on the tensor cores alike), which meets that contract as it is:
// no double-single arithmetic here.
//
// Contract: A and C are (G, n, n) row-major float64, contiguous; B is
// (G, n, n) row-major, float64 or (b_is_f32) float32: the tier's
// float32-valued S^-1 is read as float32 (half the bytes, no upcast pass
// before the launch) and widened exactly on its way into the product.  C
// is written completely.  Every sum runs over k in one fixed order in one
// accumulator: two launches agree bit for bit.
//
// What bounds it on an H100: latency, not a rate.  The solver's shapes are
// small (n = 65, G = 32: 8.8 M multiply-adds, 0.26 us at the 67 TFLOP/s of
// the float64 tensor cores; n = 129, G = 8: 17 M) and the operands (G n^2
// doubles, 1.1 MB at n = 65: 1 us at 3.35 TB/s) sit in L2.  Taken apart on
// the card (profile_torch_kernels.py dissect: the kernel beside copies of
// itself with one part cut out), the 5.4 us of a call at n = 65 are an
// empty launch (2.1), the copies into shared memory (1.8: 8-byte cp.async,
// the widest an odd n allows; 2.8 of 7.2 at n = 129), the products (0.5)
// and the stores (0.3).  Earlier designs showed what else costs: every
// further cp.async wait with its barrier, and a copy loop that derives its
// indices per element (more than the products).  So: one wide slab, one
// wait, no index arithmetic in the copy loop.
//
// Design: two kernels, chosen by n in the entry point.
//  * n > 16, bmm64_mma_kernel: the float64 tensor cores through
//    mma.sync.aligned.m16n8k16.row.col.f64 (and m16n8k4 on the ragged end
//    of K; the 8 x 8 x 4 shape measured no faster per product than an FMA
//    loop).  One block owns a tile of 16 or 32 rows by 72 columns of one
//    matrix: 9 warps, warp w owning the 8 columns 8w.. and one or two
//    16 x 8 accumulator fragments under each other (one B fragment feeds
//    both).  The entry point takes 16-row tiles while their blocks are
//    all resident at once (n = 65, G = 32: 160 blocks; n = 129, G = 8:
//    144), else 32-row tiles.  Edges pad to the fragment (16 rows, 8
//    columns, 4 in k), not to the tile: out-of-range elements are
//    zero-filled in shared memory, stores are masked, a fragment row or a
//    warp wholly beyond n only copies.  K comes in slabs of 144, so n <=
//    144 is one slab: every copy in flight at once, one wait, one barrier.
//    Rows of an odd n are only 8-byte aligned, so the copy width is picked
//    at launch: 16 bytes (two doubles, or 8 bytes for two floats) when n
//    is even and the bases are aligned, else one element a copy.  Each
//    thread copies fixed positions of every slab (a pointer add and a
//    bound check a copy).  Shared rows are padded (A: 148 doubles; B: 76
//    doubles or 72 floats) so that the fragment loads, g-major for A and
//    t-major for B, touch every bank once.  A longer K takes the slabs in
//    turn (copy, wait, multiply): no ring, since one block's slab nearly
//    fills the SM's shared memory and the products outlast the copies.
//  * n <= 16, bmm64_small_kernel: many whole matrices per block (1,024
//    outputs a block: ten matrices at n = 10, so 1,472 matrices make 148
//    blocks), staged in shared memory, one float64 FMA chain per output.
//    The tensor-core tile, padded to 16, measured 1.4-2.5 times slower
//    there (one block per matrix, 4.1 times the work).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSmallN = 16;
constexpr int kSmallOutputs = 1024;   // outputs per block in the small kernel
constexpr int kSmallThreads = 256;

constexpr int kWarps = 9;             // one 8-column fragment column each
constexpr int kBN = 8 * kWarps;       // block tile: 72 columns
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 144;              // k per slab: nine 16 x 8 x 16 steps
constexpr int kLdA = kBK + 4;         // 4 (mod 16): g-major loads
constexpr int kARows = kThreads / (kBK / 2);   // rows of A a pass covers
constexpr int kFineWaves = 2;         // 16-row tiles up to this many a SM
template <typename TB> struct LdB;    // t-major loads: 12 (mod 16) doubles,
template <> struct LdB<double> { static constexpr int v = kBN + 4; };
template <> struct LdB<float> { static constexpr int v = kBN; };  // 8 (mod 32)
static_assert(kBK % 16 == 0, "a slab is whole 16 x 8 x 16 products deep");
static_assert(kThreads % (kBK / 2) == 0 && kThreads % kBN == 0 &&
              kThreads % (kBN / 2) == 0 && kBK % (kThreads / (kBN / 2)) == 0,
              "the copies must divide evenly among the threads");

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? BYTES : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// With g = lane / 4 and t = lane % 4 a lane holds, of a 16 x 8 x 16
// product, a[2 j + h] = A[g + 8 h][t + 4 j], b[j] = B[t + 4 j][g] and
// c[2 h + e] = C[g + 8 h][2 t + e]; the 16 x 8 x 4 product takes j = 0.
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

__device__ __forceinline__ void dmma_k4(double (&c)[4], double a0, double a1,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// FR: 16-row fragments per warp (the tile has 16 FR rows); E: elements per
// copy (2 only for an even n on aligned bases).  Dynamic shared memory: the
// tile's rows of A, then the slab's rows of B.
template <typename TB, int FR, int E>
__global__ void __launch_bounds__(kThreads)
bmm64_mma_kernel(const double* __restrict__ A, const TB* __restrict__ B,
                 double* __restrict__ C, int n, int col_panels) {
  constexpr int kBM = 16 * FR;
  constexpr int kLdB = LdB<TB>::v;
  extern __shared__ __align__(16) unsigned char smem[];
  double* As = reinterpret_cast<double*>(smem);
  TB* Bs = reinterpret_cast<TB*>(As + kBM * kLdA);
  const size_t nn = (size_t)n * n;
  const double* Ag = A + (size_t)blockIdx.x * nn;
  const TB* Bg = B + (size_t)blockIdx.x * nn;
  double* Cg = C + (size_t)blockIdx.x * nn;
  const int row0 = ((int)blockIdx.y / col_panels) * kBM;
  const int col0 = ((int)blockIdx.y % col_panels) * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int nslabs = (n + kBK - 1) / kBK;
  const int ksteps = (n + 3) / 4;       // k = 4 steps in all; k beyond 4
  const bool live = col0 + warp * 8 < n;   // ksteps is never read

  // each thread's share of a slab, fixed for the whole run so that a copy
  // costs a pointer add and a bound check: two neighbouring doubles in one
  // column position of every kARows-th row of A, and E elements in one
  // column position of every kBRows-th row of B
  constexpr int kBCols = kBN / E;           // copies per row of B
  constexpr int kBRows = kThreads / kBCols; // rows of B a pass covers
  const int ar = tid / (kBK / 2), ac = (tid % (kBK / 2)) * 2;
  const double* a_src = Ag + (size_t)(row0 + ar) * n + ac;
  double* a_dst = As + ar * kLdA + ac;
  const int br = tid / kBCols, bc = (tid % kBCols) * E;
  const bool b_ok = col0 + bc < n;
  const TB* b_src = Bg + (size_t)br * n + col0 + bc;
  TB* b_dst = Bs + br * kLdB + bc;

  auto load_slab = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kBM; r += kARows) {
      if (ar + r < kBM && k0 + ac < 4 * ksteps) {
        const bool row_ok = row0 + ar + r < n;
        if (E == 2) {
          const bool ok = row_ok && k0 + ac < n;
          cp_async<16>(a_dst + r * kLdA, ok ? a_src + (size_t)r * n + k0 : Ag,
                       ok);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bool ok = row_ok && k0 + ac + j < n;
            cp_async<8>(a_dst + r * kLdA + j,
                        ok ? a_src + (size_t)r * n + k0 + j : Ag, ok);
          }
        }
      }
    }
#pragma unroll 4
    for (int r = 0; r < kBK; r += kBRows) {
      if (k0 + br + r >= 4 * ksteps) break;
      const bool ok = b_ok && k0 + br + r < n;
      cp_async<(int)sizeof(TB) * E>(
          b_dst + r * kLdB, ok ? b_src + (size_t)(k0 + r) * n : Bg, ok);
    }
  };

  double acc[FR][4];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.0;

  const double* Ast = As + g * kLdA + t;
  const TB* Bst = Bs + t * kLdB + warp * 8 + g;
  for (int slab = 0; slab < nslabs; ++slab) {
    if (slab) __syncthreads();          // the last slab has been read
    load_slab(slab * kBK);
    cp_async_wait_all();
    __syncthreads();
    if (!live) continue;
#pragma unroll 3
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const int steps = ksteps - slab * (kBK / 4) - 4 * kc;   // of k = 4
      if (steps >= 4) {                 // one k = 16 product
        double b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = (double)Bst[(16 * kc + 4 * j) * kLdB];
#pragma unroll
        for (int i = 0; i < FR; ++i) {
          if (row0 + 16 * i < n) {
            double a[8];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              a[2 * j] = Ast[16 * i * kLdA + 16 * kc + 4 * j];
              a[2 * j + 1] = Ast[(16 * i + 8) * kLdA + 16 * kc + 4 * j];
            }
            dmma_k16(acc[i], a, b);
          }
        }
      } else {                          // the ragged end of K: k = 4 products
        for (int ks = 0; ks < steps; ++ks) {
          const double b = (double)Bst[(16 * kc + 4 * ks) * kLdB];
#pragma unroll
          for (int i = 0; i < FR; ++i)
            if (row0 + 16 * i < n)
              dmma_k4(acc[i], Ast[16 * i * kLdA + 16 * kc + 4 * ks],
                      Ast[(16 * i + 8) * kLdA + 16 * kc + 4 * ks], b);
        }
        break;
      }
    }
  }

  if (!live) return;
  const int q = col0 + warp * 8 + 2 * t;
#pragma unroll
  for (int i = 0; i < FR; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * i + 8 * h + g;
      if (r < n && q < n) Cg[(size_t)r * n + q] = acc[i][2 * h];
      if (r < n && q + 1 < n) Cg[(size_t)r * n + q + 1] = acc[i][2 * h + 1];
    }
  }
}

template <typename TB>
__global__ void bmm64_small_kernel(const double* __restrict__ A,
                                   const TB* __restrict__ B,
                                   double* __restrict__ C, long long G,
                                   int n, int per_block) {
  extern __shared__ double small_smem[];
  const int nn = n * n;
  const long long g0 = (long long)blockIdx.x * per_block;
  const int mats = (int)(G - g0 < per_block ? G - g0 : per_block);
  const int count = mats * nn;
  double* As = small_smem;
  double* Bs = small_smem + (size_t)per_block * nn;
  const size_t base = (size_t)g0 * nn;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    As[e] = A[base + e];
    Bs[e] = (double)B[base + e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int m = e / nn;
    const int ij = e - m * nn;
    const int i = ij / n;
    const int j = ij - i * n;
    const double* a = As + m * nn + i * n;
    const double* b = Bs + m * nn + j;
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc = fma(a[k], b[k * n], acc);
    C[base + e] = acc;
  }
}

// shared memory of a block: 16 FR rows of A, the slab's rows of B
template <typename TB, int FR>
size_t tile_smem(int n) {
  const int brows = n < kBK ? (n + 3) / 4 * 4 : kBK;
  return (size_t)16 * FR * kLdA * sizeof(double) +
         (size_t)brows * LdB<TB>::v * sizeof(TB);
}

template <typename TB, int FR>
cudaError_t launch_mma(const double* A, const TB* B, double* C, long long G,
                       int n, cudaStream_t s) {
  const int row_panels = (n + 16 * FR - 1) / (16 * FR);
  const int col_panels = (n + kBN - 1) / kBN;
  if ((long long)row_panels * col_panels > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned int)G, (unsigned int)(row_panels * col_panels));
  const size_t smem = tile_smem<TB, FR>(n);
  const bool wide = n % 2 == 0 && (uintptr_t)A % 16 == 0 &&
                    (uintptr_t)B % (2 * sizeof(TB)) == 0;
  auto kernel = wide ? bmm64_mma_kernel<TB, FR, 2> : bmm64_mma_kernel<TB, FR, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, s>>>(A, B, C, n, col_panels);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch(const double* A, const TB* B, double* C, long long G,
                   int n, cudaStream_t s) {
  if (n <= kSmallN) {
    const int nn = n * n;
    const int per_block = nn >= kSmallOutputs ? 1 : kSmallOutputs / nn;
    const long long blocks = (G + per_block - 1) / per_block;
    const size_t smem = 2 * (size_t)per_block * nn * sizeof(double);
    bmm64_small_kernel<TB><<<(unsigned int)blocks, kSmallThreads, smem, s>>>(
        A, B, C, G, n, per_block);
    return cudaGetLastError();
  }
  // 16-row tiles while all their blocks are resident at once (at most
  // kFineWaves a SM, and as many as their shared memory allows)
  int dev = 0, sms = 0, smem_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
  if (e != cudaSuccess) return e;
  const long long fine_blocks =
      G * ((n + 15) / 16) * ((n + kBN - 1) / kBN);
  const long long fit = smem_sm / (long long)(tile_smem<TB, 1>(n) + 1024);
  const long long resident = sms * (fit < kFineWaves ? fit : kFineWaves);
  if (fine_blocks <= resident) return launch_mma<TB, 1>(A, B, C, G, n, s);
  return launch_mma<TB, 2>(A, B, C, G, n, s);
}

}  // namespace

// C[g] = A[g] B[g] for g < G, n x n, A and C float64, B float64 or (with
// b_is_f32) float32; launched on ``stream`` on the current device; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bmm64_f64(const double* A, const void* B, double* C,
                         long long G, int n, int b_is_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b_is_f32) return (int)launch(A, (const float*)B, C, G, n, s);
  return (int)launch(A, (const double*)B, C, G, n, s);
}
