// K2 of the fused Newton direction (refine interior-point tier): the Schur
// solve (W W^T + diag + reg) dy = rhs on the live rows (live = !fix) to
// float64 accuracy, in one launch:
//   rhsf = live rhs;  dy = precond(rhsf)
//   nrefine times:  vf = live dy
//                   dy += precond(rhsf - live (W (W^T vf) + diag vf + reg vf))
//   dy = live dy
// with precond(r) = dsc f64(f32(Minv f32(dsc r))): the float32 inverse of the
// Jacobi-equilibrated float32 Schur matrix, and W the float32 features.
//
// Replaces: scipsdp_tpu/ops/fused.py::schur_solve_fused (_schur_kernel).
// That kernel carried the float64 values as float32 hi/lo pairs with TwoProd
// and compensated halving trees (the TPU has no float64) and ran the whole
// batch in one VMEM-resident grid cell.  Hopper's native float64 FMA meets
// its contract as it is; W and Minv are read as float32 and upcast in
// registers.
//
// Contract: W (B, mp, F) and Minv (B, mp, mp) float32; rhs, dsc, diag, reg
// (B, mp) float64; fix (B, mp) bytes (0/1); dy (B, mp) float64, written
// completely.  All row-major and contiguous.  No atomics: every output is
// summed by one thread, warp or block in a fixed order, so results repeat
// bit for bit.
//
// What bounds it on an H100: W (36 MB of float32 at cls_32, B = 32; 70 MB
// at cls_64, B = 8) has to be read at least once, but at these sizes each
// block's chain of dependent steps takes longer: a pass is a product, a
// second product, a cluster barrier and the preconditioner, each on the
// result of the one before, and every float32 of W is widened to float64
// for both products.  Instances never exchange data, so no grid-wide
// barrier is needed.
//
// Design: one thread-block cluster per instance b (grid (C, B), cluster
// (C, 1, 1), launched with cudaLaunchKernelEx).  F is cut into C slices of
// ``slice`` columns (a multiple of 4; the last one may be shorter or
// empty), one a block; ops/fused.py::schur_plan picks C, the slice and the
// chunk from (B, mp, F), the shared-memory limit and the clusters the card
// holds at once.  A block stages its slice W[b][:, slice] in shared memory
// with cp.async (16-, 8- or 4-byte copies as F's alignment allows): where
// the slice fits (``chunk`` = ``slice``; cls_32: 6 blocks of 189 KB) it is
// read from device memory once and kept for every pass, Minv[b] beside it;
// where it does not (cls_64: 8.7 MB an instance) it is streamed in chunks
// of ``chunk`` columns through two buffers, the next chunk (or the next
// pass's first) in flight while one is used, so each pass reads W once.
// A pass is
//   wt_c = W_c^T vf        a thread a pair of columns (float2) and a group
//                          of rows, the groups' sums added in order
//   u_s += W_c wt_c        a warp a row, a lane a pair of columns, a fixed
//                          shuffle tree, the chunks added in order
//   cluster barrier;  u = sum of the C blocks' u_s in rank order, read
//   through distributed shared memory;
//   v32 = f32(dsc (rhsf - live (u + diag vf + reg vf)));
//   dy += dsc f32(Minv v32), a warp a row
// where every block computes all of u, v32 and dy, in the same order and
// so to the same bits: one cluster barrier a pass (u_s alternates between
// two buffers, so a pass never overwrites what another block may still
// read), nrefine + 1 in all (none for nrefine = 0), no device-memory
// scratch.  A cluster that cannot be resident
// (cudaOccupancyMaxActiveClusters = 0) is returned as an error, never
// launched smaller.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsAtOnce = 2;   // rows a warp sums together in W_c wt_c
constexpr int kMaxCluster = 16;

struct Args {
  const float* __restrict__ W;
  const double* __restrict__ rhs;
  const float* __restrict__ Minv;
  const double* __restrict__ dsc;
  const double* __restrict__ diag;
  const double* __restrict__ reg;
  const unsigned char* __restrict__ fix;
  double* __restrict__ dy;
  int B, mp, F, nrefine, slice, chunk;
};

// Dynamic shared memory, in this order: the W buffer(s) (mp rows of chunk
// floats; two when streaming), Minv (mp x mp floats, padded to a multiple
// of 4) where the slice is kept, rhs, dsc, diag, reg, vf, u_s twice and dy
// (mp doubles each), wt (max(chunk, 2 kThreads) doubles: a chunk's sums, or
// the partial sums of its row groups), v32 (mp floats), fix (mp bytes,
// padded to a multiple of 4).  ops/fused.py::schur_smem computes the same
// sum.
__host__ __device__ inline size_t minv_floats(int mp, bool resident) {
  return resident ? ((size_t)mp * mp + 3) / 4 * 4 : 0;
}

size_t smem_bytes(int mp, int chunk, bool resident) {
  return ((size_t)(resident ? 1 : 2) * mp * chunk + minv_floats(mp, resident))
             * sizeof(float) +
         ((size_t)8 * mp + max(chunk, 2 * kThreads)) * sizeof(double) +
         (size_t)mp * sizeof(float) + ((size_t)mp + 3) / 4 * 4;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes));
}

// Copy columns [0, cw) of the mp rows at ``src`` (row stride F) into
// ``buf`` (row stride ``ld``), kBytes a copy, a warp a row; commits one
// cp.async group.
template <int kBytes>
__device__ __forceinline__ void copy_rows(const float* src, int F, float* buf,
                                          int ld, int cw, int mp) {
  constexpr int kVec = kBytes / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < mp; i += kWarps) {
    const float* s = src + (size_t)i * F;
    float* d = buf + (size_t)i * ld;
    for (int c = lane * kVec; c < cw; c += 32 * kVec)
      cp_async<kBytes>(d + c, s + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The widest copy that every row start of W allows (``src`` and F are
// checked; slices and chunks start at multiples of 4 columns).
__device__ __forceinline__ void copy_chunk(const float* src, int F, float* buf,
                                           int ld, int cw, int mp) {
  const size_t at = (size_t)src;
  if (F % 4 == 0 && at % 16 == 0) copy_rows<16>(src, F, buf, ld, cw, mp);
  else if (F % 2 == 0 && at % 8 == 0) copy_rows<8>(src, F, buf, ld, cw, mp);
  else copy_rows<4>(src, F, buf, ld, cw, mp);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dy[i] (= or +=) dsc f64(f32(Minv v32)) and vf[i] = live dy[i] for every
// row i, a warp a row, two rows at a time (Minv in shared or device memory)
__device__ __forceinline__ void precond(int mp, const float* __restrict__ Mb,
                                        const double* dscb, const float* v32,
                                        const unsigned char* fix, double* dy,
                                        double* vf, bool add) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = warp; i0 < mp; i0 += 2 * kWarps) {
    const int i1 = i0 + kWarps;
    const float* M0 = Mb + (size_t)i0 * mp;
    const float* M1 = Mb + (size_t)min(i1, mp - 1) * mp;
    double acc0 = 0.0, acc1 = 0.0;
    for (int j = lane; j < mp; j += 32) {
      const double v = (double)v32[j];
      acc0 = fma((double)M0[j], v, acc0);
      acc1 = fma((double)M1[j], v, acc1);
    }
    acc0 = warp_sum(acc0);
    acc1 = warp_sum(acc1);
    if (lane == 0) {
      const double u0 = dscb[i0] * (double)(float)acc0;
      dy[i0] = add ? dy[i0] + u0 : u0;
      vf[i0] = fix[i0] ? 0.0 : dy[i0];
      if (i1 < mp) {
        const double u1 = dscb[i1] * (double)(float)acc1;
        dy[i1] = add ? dy[i1] + u1 : u1;
        vf[i1] = fix[i1] ? 0.0 : dy[i1];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    schur_solve_fused_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int mp = a.mp, F = a.F, chunk = a.chunk;
  const bool resident = chunk >= a.slice;

  float* wbuf = reinterpret_cast<float*>(smem);
  float* sM = wbuf + (size_t)(resident ? 1 : 2) * mp * chunk;
  double* rhs = reinterpret_cast<double*>(sM + minv_floats(mp, resident));
  double* dsc = rhs + mp;
  double* diag = dsc + mp;
  double* reg = diag + mp;
  double* vf = reg + mp;      // live dy
  double* us = vf + mp;       // this block's share of u = W wt, by pass parity
  double* dy = us + 2 * mp;   // the whole dy, the same bits in every block
  double* wt = dy + mp;
  float* v32 = reinterpret_cast<float*>(wt + max(chunk, 2 * kThreads));
  unsigned char* fix = reinterpret_cast<unsigned char*>(v32 + mp);

  const size_t bm = (size_t)b * mp;
  const float* Mg = a.Minv + bm * mp;
  // this block's columns [f0, f0 + w) of W[b], in nch chunks
  const int f0 = rank * a.slice;
  const int w = max(0, min(a.slice, F - f0));
  const int nch = (w + chunk - 1) / chunk;
  const float* Wb = a.W + bm * F + f0;

  // Minv, where it is staged, then the first chunk, in flight during the
  // first preconditioning; the instance's vectors into shared memory
  if (resident) copy_chunk(Mg, mp, sM, mp, mp, mp);
  const float* Mb = resident ? sM : Mg;
  const int steps = a.nrefine * nch;   // chunks read over all passes
  if (steps > 0) copy_chunk(Wb, F, wbuf, chunk, min(chunk, w), mp);
  for (int j = tid; j < mp; j += kThreads) {
    rhs[j] = a.rhs[bm + j];
    dsc[j] = a.dsc[bm + j];
    diag[j] = a.diag[bm + j];
    reg[j] = a.reg[bm + j];
    fix[j] = a.fix[bm + j];
    v32[j] = (float)(dsc[j] * (fix[j] ? 0.0 : rhs[j]));
  }
  if (steps > 0) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else cp_async_wait_all();
  __syncthreads();
  precond(mp, Mb, dsc, v32, fix, dy, vf, false);

  for (int pass = 0; pass < a.nrefine; ++pass) {
    double* usp = us + (pass % 2) * mp;
    if (nch == 0)   // a block with no columns adds nothing
      for (int j = tid; j < mp; j += kThreads) usp[j] = 0.0;
    for (int k = 0; k < nch; ++k) {
      const int step = pass * nch + k;
      const int c0 = k * chunk;
      const int cw = min(chunk, w - c0);
      const float* Wc = wbuf;
      if (!resident) {
        Wc = wbuf + (size_t)(step % 2) * mp * chunk;
        cp_async_wait_all();
        __syncthreads();
        if (step + 1 < steps) {   // the next chunk, or the next pass's first
          const int c1 = ((step + 1) % nch) * chunk;
          copy_chunk(Wb + c1, F, wbuf + (size_t)((step + 1) % 2) * mp * chunk,
                     chunk, min(chunk, w - c1), mp);
        }
      } else {
        if (step == 0) cp_async_wait_all();
        __syncthreads();
      }
      // wt_c = W_c^T vf, a thread a pair of columns (a float2 of each row;
      // rows are 8-byte aligned, chunks even) and a row group: groups =
      // kThreads / pairs of them, at most 16, each summing rows g, g +
      // groups, ... in order, then added in group order
      const int cp = (cw + 1) / 2;
      const int groups = cp > 0 ? max(1, min(16, kThreads / cp)) : 1;
      for (int t = tid; t < groups * cp; t += kThreads) {
        const int q = t % cp, g = t / cp;
        const float* Wq = Wc + 2 * q;
        double s0 = 0.0, s1 = 0.0;
        for (int i = g; i < mp; i += groups) {
          const float2 w2 =
              *reinterpret_cast<const float2*>(Wq + (size_t)i * chunk);
          s0 = fma((double)w2.x, vf[i], s0);
          s1 = fma((double)w2.y, vf[i], s1);
        }
        *reinterpret_cast<double2*>(wt + (size_t)g * 2 * cp + 2 * q) =
            make_double2(s0, s1);
      }
      __syncthreads();
      if (groups > 1) {
        for (int c = tid; c < 2 * cp; c += kThreads) {
          double x = wt[c];
          for (int g = 1; g < groups; ++g) x += wt[(size_t)g * 2 * cp + c];
          wt[c] = x;
        }
        __syncthreads();
      }
      // u_s += W_c wt_c, a warp a row, kRowsAtOnce rows at a time, a lane a
      // pair of columns at a time (the pair past an odd cw counts once)
      for (int i0 = warp; i0 < mp; i0 += kRowsAtOnce * kWarps) {
        double acc[kRowsAtOnce];
        const float* Wr[kRowsAtOnce];
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) {
          acc[u] = 0.0;
          Wr[u] = Wc + (size_t)min(i0 + u * kWarps, mp - 1) * chunk;
        }
        for (int c = 2 * lane; c < cw; c += 64) {
          const double2 x = *reinterpret_cast<const double2*>(wt + c);
          const bool two = c + 1 < cw;
#pragma unroll
          for (int u = 0; u < kRowsAtOnce; ++u) {
            const float2 w2 = *reinterpret_cast<const float2*>(Wr[u] + c);
            acc[u] = fma((double)w2.x, x.x, acc[u]);
            acc[u] = two ? fma((double)w2.y, x.y, acc[u]) : acc[u];
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) acc[u] = warp_sum(acc[u]);
        if (lane == 0) {   // the chunks in order, the first on 0
#pragma unroll
          for (int u = 0; u < kRowsAtOnce; ++u) {
            const int i = i0 + u * kWarps;
            if (i < mp) usp[i] = (k == 0 ? 0.0 : usp[i]) + acc[u];
          }
        }
      }
      if (!resident) __syncthreads();   // the buffer is refilled next
    }
    // every block's u_s of this pass is complete; the one of the pass
    // before, in the other buffer, is no longer read by anyone
    cluster.sync();
    // u in rank order; v32 = f32(dsc (rhsf - live (u + diag vf + reg vf)))
    for (int j = tid; j < mp; j += kThreads) {
      double u = *cluster.map_shared_rank(usp + j, 0);
      for (int q = 1; q < C; ++q) u += *cluster.map_shared_rank(usp + j, q);
      double r = 0.0;
      if (!fix[j]) r = rhs[j] - (u + diag[j] * vf[j] + reg[j] * vf[j]);
      v32[j] = (float)(dsc[j] * r);
    }
    __syncthreads();
    precond(mp, Mb, dsc, v32, fix, dy, vf, true);
  }
  // no block reads another's shared memory past the last barrier
  if (a.nrefine > 0) cluster.sync();
  else __syncthreads();
  // every block holds the same dy; each writes its share of the rows
  const int rows = (mp + C - 1) / C;
  const int r1 = min(mp, (rank + 1) * rows);
  for (int i = rank * rows + tid; i < r1; i += kThreads)
    a.dy[bm + i] = fix[i] ? 0.0 : dy[i];
}

// The launch of a plan: checks it, sets the kernel's attributes and fills
// ``cfg`` (its attribute in ``attr``); returns the CUDA error
// (cudaErrorInvalidValue for a plan the kernel does not take).
cudaError_t configure(int B, int mp, int F, int nrefine, int C, int slice,
                      int chunk, void* stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (B < 1 || B > 65535 || mp < 1 || F < 0 || nrefine < 0 || C < 1 ||
      C > kMaxCluster || slice < 4 || slice % 4 || chunk < 4 || chunk % 4 ||
      chunk > slice || (long long)C * slice < F)
    return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(mp, chunk, chunk >= slice);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(schur_solve_fused_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(schur_solve_fused_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)C, (unsigned)B);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The clusters of a plan that the current device holds at once (the
// occupancy query), in *clusters; returns the CUDA error of the query.
extern "C" int schur_solve_fused_clusters(int mp, int F, int C, int slice,
                                          int chunk, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      configure(1, mp, F, 0, C, slice, chunk, nullptr, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                             schur_solve_fused_kernel, &cfg);
}

// dy (B, mp) of the fused Schur solve on ``stream`` on the current device:
// a cluster of ``C`` blocks per instance, F in slices of ``slice`` columns,
// staged ``chunk`` columns at a time (``chunk`` >= ``slice``: the slice
// stays in shared memory for every pass).  Returns the CUDA error of the
// set-up, the occupancy query or the launch (0 = launched):
// cudaErrorInvalidValue for a plan it does not take, and
// cudaErrorLaunchOutOfResources where no cluster can be resident.
extern "C" int schur_solve_fused_f64(const float* W, const double* rhs,
                                     const float* Minv, const double* dsc,
                                     const double* diag, const double* reg,
                                     const unsigned char* fix, double* dy,
                                     int B, int mp, int F, int nrefine, int C,
                                     int slice, int chunk, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(B, mp, F, nrefine, C, slice, chunk, stream, &cfg,
                            &attr);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, schur_solve_fused_kernel,
                                     &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  Args a{W, rhs, Minv, dsc, diag, reg, fix, dy, B, mp, F, nrefine, slice,
         chunk};
  e = cudaLaunchKernelEx(&cfg, schur_solve_fused_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
