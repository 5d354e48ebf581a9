// K2 of the fused Newton direction (refine interior-point tier): the Schur
// solve (W W^T + diag + reg) dy = rhs on the live rows (live = !fix) to
// float64 accuracy, as one cooperative launch:
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
// (B, mp) float64; fix (B, mp) bytes (0/1); wt (B, F) float64 and v32 (B, mp)
// float32 scratch; dy (B, mp) float64, written completely.  All row-major
// and contiguous.  No atomics: every output is summed by one thread, warp or
// block in a fixed order, so results repeat bit for bit.
//
// What bounds it on an H100: device-memory and L2 bandwidth.  Each pass
// reads W twice (W^T vf, then W wt): 36 MB of float32 at cls_32, B = 32
// (8.7 MB per instance at cls_64), so 3 passes move ~216 MB, ~65 us at the
// 3.35 TB/s peak; W wt re-reads wt (B F float64) once per row from L2.
// The passes depend on each other, so the phases are separated by grid-wide
// barriers, not launches.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) whose grid is
// the occupancy query's resident blocks per SM times the SM count, cut to
// the largest phase's work; phases are grid-stride loops separated by
// cooperative_groups::this_grid().sync():
//   v32 = f32(dsc rhsf)                 one thread per (b, i)
//   dy = dsc f32(Minv v32)              one warp per row (b, i)
//   per pass:
//     wt = W^T vf                       one thread per (b, f), coalesced in f
//     v32 = f32(dsc (rhsf - live u))    one block per row, u = W wt + ...
//     dy += dsc f32(Minv v32)           one warp per row
// The rows of W are F long (4,290 at cls_32, 16,770 at cls_64) and there
// are only B mp of them (1,040 at cls_64 B = 8): a warp per row left most
// of the grid idle in W wt, so a whole block reads each row and adds its
// warps' sums in warp order.  At MkP's short rows (F = 101) that idles
// most of each block instead; variants that chose per F (a warp for short
// rows, or 1-8 warps per row) cost registers or a stack frame and were
// slower at every shape on an H100.
// A zero from the occupancy query is returned as an error, never launched
// with a smaller grid.  Values written inside the kernel (dy, wt, v32) are
// read through plain, coherent loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* __restrict__ W;
  const double* __restrict__ rhs;
  const float* __restrict__ Minv;
  const double* __restrict__ dsc;
  const double* __restrict__ diag;
  const double* __restrict__ reg;
  const unsigned char* __restrict__ fix;
  double* wt;     // written and read inside the kernel
  float* v32;
  double* dy;
  int B, mp, F, nrefine;
};

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// dy (= or +=) dsc f64(f32(Minv v32)), one warp per row; ``last`` applies
// the final live mask
__device__ void precond(const Args& a, bool add, bool last, long long gwarp,
                        long long nwarps, int lane) {
  const long long rows = (long long)a.B * a.mp;
  for (long long row = gwarp; row < rows; row += nwarps) {
    const float* Mr = a.Minv + (size_t)row * a.mp;
    const float* v = a.v32 + (size_t)(row / a.mp) * a.mp;
    double acc = 0.0;
    for (int j = lane; j < a.mp; j += 32)
      acc = fma((double)Mr[j], (double)v[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const double u = a.dsc[row] * (double)(float)acc;
      double d = add ? a.dy[row] + u : u;
      if (last && a.fix[row]) d = 0.0;
      a.dy[row] = d;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
schur_solve_fused_kernel(Args a) {
  __shared__ double red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const long long gsize = (long long)gridDim.x * blockDim.x;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gwarp = gtid >> 5;
  const long long nwarps = gsize >> 5;
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)a.B * a.mp;
  const long long cols = (long long)a.B * a.F;

  for (long long i = gtid; i < rows; i += gsize)
    a.v32[i] = (float)(a.dsc[i] * (a.fix[i] ? 0.0 : a.rhs[i]));
  grid.sync();
  precond(a, false, a.nrefine == 0, gwarp, nwarps, lane);

  for (int pass = 0; pass < a.nrefine; ++pass) {
    grid.sync();
    // wt[b, f] = sum_i W[b, i, f] vf[b, i]
    for (long long idx = gtid; idx < cols; idx += gsize) {
      const long long b = idx / a.F;
      const float* Wc = a.W + (size_t)b * a.mp * a.F + (idx - b * a.F);
      const double* d = a.dy + (size_t)b * a.mp;
      const unsigned char* fx = a.fix + (size_t)b * a.mp;
      double acc = 0.0;
      for (int i = 0; i < a.mp; ++i)
        acc = fma((double)Wc[(size_t)i * a.F], fx[i] ? 0.0 : d[i], acc);
      a.wt[idx] = acc;
    }
    grid.sync();
    // v32 = f32(dsc (rhsf - live (W wt + diag vf + reg vf))), one block
    // per row
    for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
      const float* Wr = a.W + (size_t)row * a.F;
      const double* w = a.wt + (size_t)(row / a.mp) * a.F;
      double acc = 0.0;
      for (int f = threadIdx.x; f < a.F; f += kThreads)
        acc = fma((double)Wr[f], w[f], acc);
      acc = warp_sum(acc);
      if (lane == 0) red[threadIdx.x >> 5] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        double s = 0.0;
        for (int k = 0; k < kWarps; ++k) s += red[k];
        double r = 0.0;
        if (!a.fix[row]) {
          const double vf = a.dy[row];
          r = a.rhs[row] - (s + a.diag[row] * vf + a.reg[row] * vf);
        }
        a.v32[row] = (float)(a.dsc[row] * r);
      }
      __syncthreads();
    }
    grid.sync();
    precond(a, true, pass == a.nrefine - 1, gwarp, nwarps, lane);
  }
}

}  // namespace

// dy (B, mp) of the fused Schur solve, one cooperative launch on ``stream``
// on the current device.  Returns the CUDA error of the occupancy query or
// the launch (0 = launched); a query that leaves no resident block is
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int schur_solve_fused_f64(const float* W, const double* rhs,
                                     const float* Minv, const double* dsc,
                                     const double* diag, const double* reg,
                                     const unsigned char* fix, double* wt,
                                     float* v32, double* dy, int B, int mp,
                                     int F, int nrefine, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, schur_solve_fused_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1 || sms < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // no more blocks than the largest phase has work for: B F threads, or a
  // block per row
  const long long rows = (long long)B * mp;
  const long long cols = (long long)B * F;
  long long blocks = (cols + kThreads - 1) / kThreads;
  if (blocks < rows) blocks = rows;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  Args a{W, rhs, Minv, dsc, diag, reg, fix, wt, v32, dy,
         B, mp, F, nrefine};
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)schur_solve_fused_kernel,
                                  dim3((unsigned int)blocks), dim3(kThreads),
                                  params, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
