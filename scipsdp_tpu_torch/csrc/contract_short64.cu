// Float64 contraction over a short axis: out[g, f] = sum_j M[(g,) j, f] v[g, j]
// for the refine interior-point tier: A(dy) (static M = A flattened to
// (mp, K n^2)) and the first half of the Schur matvec, W^T v (per-instance
// M = the float32 feature matrix Wall, (G, mp, K n^2 + P)).
//
// Replaces: scipsdp_tpu/ops/df32.py::dd_contract_short (_short_kernel) and
// dd_contract_short_lanes (_contract_short_lanes_kernel), the TPU's grid
// and lanes layouts of one contraction.  Those carried hi/lo float32 pairs
// with TwoProd/TwoSum for ~2^-45 relative accuracy; Hopper's native
// float64 meets that contract directly.
//
// Contract: M is (J, F) ("static", shared by every g) or (G, J, F), float64
// or float32 (read as float32 and upcast exactly, so the bandwidth-bound
// matvec over Wall reads half the bytes); v (G, J) and out (G, F) are
// float64; all row-major and contiguous.
//
// What bounds it on an H100: device-memory bandwidth.  Per-instance M is
// read once (Wall at cls_32, B = 32: 32 x 66 x 4290 float32 = 36 MB, ~11 us
// at 3.35 TB/s); 2 FLOP per element of M.  A static M (2.2 MB at cls_32,
// 17 MB at cls_64) is read once and out (G x F) written once.
//
// Per-instance design: one thread per output (g, f); a warp's 32 threads
// take 32 consecutive f, so every read of a row of M is coalesced, and
// v[g, j] is the same address for the whole warp (a broadcast).  The J
// loop is a float64 FMA chain.
//
// Static design (contract_tile.cuh): out^T = M^T v^T on the float64 tensor
// cores.  A block owns 16 P columns f and 8 Q instances (up to 256 of
// them, so M is read from device memory once a launch at the refine
// tier's widths); its 8 warps split the (16 P x 8 Q) tile and the j
// slices, load M's fragments straight from device memory, several
// slices' at once, multiply them with v's, and add their sums in a fixed
// order.  v's fragments come from a copy of its (8 Q x J) row tile in
// shared memory (kStage: made by cp.async, kPiece rows of j at a time,
// while the first fragments of M are loaded) or, for wider block rows,
// straight from device memory, where the cache keeps the small v.
// ops/df32.py::contract_plan picks P, the fragments a warp, the groups
// and the mode, and mirrors layout().

#include <cuda_runtime.h>

#include "contract_tile.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TM>
__global__ void contract_short_instance_kernel(const TM* __restrict__ M,
                                               const double* __restrict__ v,
                                               double* __restrict__ out,
                                               int J, int F) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  const size_t g = blockIdx.y;
  const TM* Mg = M + g * J * F + f;
  const double* vg = v + g * J;
  double acc = 0.0;
  for (int j = 0; j < J; ++j)
    acc = fma((double)Mg[(size_t)j * F], vg[j], acc);
  out[g * F + f] = acc;
}

constexpr int kPiece = 144;   // rows of j of v staged at once (9 slices)
constexpr int kInFlight = 32; // doubles a lane holds for M's fragments and
                              // v's (two blocks an SM: <= 128 registers)

// Shared memory of a static launch: the rows of j a piece and v's row tile
// (a row of rows + 4 doubles, each fragment load free of bank conflicts),
// and reduce()'s buffer over the same bytes.
struct Layout {
  int rows, ldb, bytes;
};

__host__ __device__ inline Layout layout(int J, int Q) {
  const int padded = (J + 15) / 16 * 16;
  const int rows = padded < 16 ? 16 : padded < kPiece ? padded : kPiece;
  const int staged = 8 * Q * (rows + 4) * 8;
  const int red = (int)sizeof(ctile::Red);
  return {rows, rows + 4, staged > red ? staged : red};
}

template <typename T>
__device__ __forceinline__ double load(const T* p, bool ok) {
  return ok ? (double)__ldg(p) : 0.0;
}

// acc[q] += M^T's 16 x 16 slices (rows f0 .. f0 + 15 < F, M's row stride
// F) times fragment q of v, bat(q, row, k) = v[g0 + 8 q + row][j0 + k],
// over the slices split, split + ks, ... < nsl of the rows j0 .. of j (<
// J); a warp that is not live loads and adds nothing.  M's fragments come
// straight from device memory, several slices' at once (fewer the more
// fragments of v a warp holds: kInFlight doubles a lane with them) before
// they are multiplied; v's are read as they are multiplied (loading them
// with M's cost registers and time: profile_torch_kernels.py variants
// contract).  wait(), which every thread of the block calls once, makes a
// staged piece of v visible: the first slices' loads are in flight while
// it is copied.
template <typename TM, int QW, typename B, typename Wait>
__device__ __forceinline__ void product(double (&acc)[QW][4], const TM* M,
                                        int F, int J, int f0, int j0,
                                        int nsl, int split, int ks,
                                        bool live, B bat, Wait wait) {
  constexpr int U = (kInFlight - 8 * QW) / 8 > 1 ? (kInFlight - 8 * QW) / 8
                                                 : 1;   // slices at once
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, t = lane & 3;
  const bool fok[2] = {live && f0 + r < F, live && f0 + r + 8 < F};
  const TM* col[2] = {M + (fok[0] ? f0 + r : 0),
                      M + (fok[1] ? f0 + r + 8 : 0)};
  double a[U][8];
  auto fetch = [&](int s) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * (s + u * ks) + t + 4 * i;
        const bool ok = s + u * ks < nsl && j0 + k < J;
        const size_t at = (size_t)(j0 + k) * F;
        a[u][2 * i] = load(col[0] + at, ok && fok[0]);
        a[u][2 * i + 1] = load(col[1] + at, ok && fok[1]);
      }
  };
  auto multiply = [&](int s) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u * ks >= nsl) break;
      const int k0 = 16 * (s + u * ks) + t;
#pragma unroll
      for (int q = 0; q < QW; ++q) {
        double b[4] = {bat(q, r, k0), bat(q, r, k0 + 4), bat(q, r, k0 + 8),
                       bat(q, r, k0 + 12)};
        panel::dmma_k16(acc[q], a[u], b);
      }
    }
  };
  fetch(split);
  wait();
  if (!live) return;
  multiply(split);
  for (int s = split + U * ks; s < nsl; s += U * ks) {
    fetch(s);
    multiply(s);
  }
}

template <typename TM, int QW, bool kStage>
__global__ void __launch_bounds__(ctile::kThreads, 2)
contract_short_static_kernel(const TM* __restrict__ M,
                             const double* __restrict__ v,
                             double* __restrict__ out, int G, int J, int F,
                             int lgP, int lgGroups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = QW << lgGroups;
  const ctile::Map w = ctile::warp_map(lgP, lgGroups);
  const int fb = (blockIdx.x << lgP) * 16, gb = blockIdx.y * 8 * Q;
  const int f0 = fb + 16 * w.panel, g0 = gb + 8 * QW * w.group;
  const bool live = f0 < F && g0 < G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double acc[QW][4] = {};
  if constexpr (kStage) {
    const Layout L = layout(J, Q);
    double* Bs = reinterpret_cast<double*>(smem);
    const double* Bw = Bs + 8 * QW * w.group * L.ldb;
    for (int j0 = 0; j0 < J; j0 += L.rows) {
      if (j0 > 0) __syncthreads();   // every warp is done with the last piece
      // v's piece, a warp a row, one cp.async an element, zeros outside v
      for (int g = warp; g < 8 * Q; g += ctile::kWarps)
        for (int k = lane; k < L.rows; k += 32) {
          const bool ok = gb + g < G && j0 + k < J;
          panel::cp_async<8>(Bs + g * L.ldb + k,
                             ok ? v + (size_t)(gb + g) * J + j0 + k : v, ok);
        }
      panel::cp_async_commit();
      product<TM, QW>(
          acc, M, F, J, f0, j0, (min(L.rows, J - j0) + 15) / 16, w.split,
          w.ks, live,
          [&](int q, int row, int k) { return Bw[(8 * q + row) * L.ldb + k]; },
          [] {
            panel::cp_async_wait_all();
            __syncthreads();
          });
    }
  } else {
    // v's fragments straight from device memory (cached), all of j at once
    product<TM, QW>(
        acc, M, F, J, f0, 0, (J + 15) / 16, w.split, w.ks, live,
        [&](int q, int row, int k) {
          const int g = g0 + 8 * q + row;
          return load(v + (size_t)(g < G ? g : 0) * J + k, g < G && k < J);
        },
        [] {});
  }
  if (!ctile::reduce(acc, w, *reinterpret_cast<ctile::Red*>(smem)) || !live)
    return;
  const int r = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < QW; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = f0 + r + 8 * h, g = g0 + 8 * q + 2 * t + e;
        if (f < F && g < G) out[(size_t)g * F + f] = acc[q][2 * h + e];
      }
}

template <typename TM, int QW, bool kStage>
int launch_tiles(const TM* M, const double* v, double* out, int G, int J,
                 int F, int lgP, int lgGroups, cudaStream_t s) {
  const int P = 1 << lgP, Q = QW << lgGroups;
  const int smem = kStage ? layout(J, Q).bytes : (int)sizeof(ctile::Red);
  auto kernel = contract_short_static_kernel<TM, QW, kStage>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned int)(((F + 15) / 16 + P - 1) / P),
                  (unsigned int)(((G + 7) / 8 + Q - 1) / Q));
  kernel<<<grid, ctile::kThreads, smem, s>>>(M, v, out, G, J, F, lgP,
                                             lgGroups);
  return (int)cudaGetLastError();
}

template <typename TM, bool kStage>
int launch_static(const TM* M, const double* v, double* out, int G, int J,
                  int F, int P, int QW, int groups, cudaStream_t s) {
  const int lgP = ctile::lg2(P), lgGroups = ctile::lg2(groups);
  if ((1 << lgP) != P || (1 << lgGroups) != groups ||
      lgP + lgGroups > ctile::lg2(ctile::kWarps))
    return (int)cudaErrorInvalidValue;
  switch (QW) {
    case 1:
      return launch_tiles<TM, 1, kStage>(M, v, out, G, J, F, lgP, lgGroups,
                                         s);
    case 2:
      return launch_tiles<TM, 2, kStage>(M, v, out, G, J, F, lgP, lgGroups,
                                         s);
    case 4:
      return launch_tiles<TM, 4, kStage>(M, v, out, G, J, F, lgP, lgGroups,
                                         s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TM>
int launch(const TM* M, const double* v, double* out, int G, int J, int F,
           int per_instance, int P, int QW, int groups, int stage,
           cudaStream_t s) {
  if (per_instance) {
    const unsigned int fb = (unsigned int)((F + kThreads - 1) / kThreads);
    contract_short_instance_kernel<TM>
        <<<dim3(fb, (unsigned int)G), kThreads, 0, s>>>(M, v, out, J, F);
    return (int)cudaGetLastError();
  }
  if (stage)
    return launch_static<TM, true>(M, v, out, G, J, F, P, QW, groups, s);
  return launch_static<TM, false>(M, v, out, G, J, F, P, QW, groups, s);
}

}  // namespace

// out (G, F) = contraction of M over J with v (G, J).  ``m_f32`` != 0: M is
// float32; ``per_instance`` != 0: M is (G, J, F), else (J, F).  A static M
// takes ops/df32.py::contract_plan's ``panels`` P, ``frags`` (fragments a
// warp: 1, 2 or 4), ``groups`` (P groups a power of two <= 8) and
// ``stage`` (!= 0: v staged in shared memory; 0: read as fragments); the
// per-instance path ignores them.  Launched on ``stream`` on the current device; returns the
// launch's CUDA error (0 = launched).
extern "C" int contract_short64_f64(const void* M, const double* v,
                                    double* out, int G, int J, int F,
                                    int m_f32, int per_instance, int panels,
                                    int frags, int groups, int stage,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m_f32)
    return launch((const float*)M, v, out, G, J, F, per_instance, panels,
                  frags, groups, stage, s);
  return launch((const double*)M, v, out, G, J, F, per_instance, panels,
                frags, groups, stage, s);
}
