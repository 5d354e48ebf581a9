// Shared device code of the static paths of contract_short64.cu and
// contract_long64.cu: how a block's warps split its tile, and how they add
// their sums in a fixed order.
//
// Both contractions are, for one block, C[m][g] = sum_k A[m][k] B[g][k]:
// m runs over M's kept axis (f in the short contraction, j in the long
// one), g over instances, k over the contracted axis (j, f), cut into
// slices of 16.  The block's tile is P 16-row panels of m by Q = QW *
// groups 8-instance fragments.  Its kWarps warps split it: warp w owns
// panel p, fragment group qg (fragments qg QW .. qg QW + QW - 1) and the
// k-slices split, split + ks, ... of the block's range, where w = (p
// groups + qg) ks + split and ks = kWarps / (P groups).  The ks warps of
// a (panel, group) add their sums in split order (reduce), so every value
// is summed in one fixed order and two launches agree bit for bit.
//
// With r = lane / 4 and t = lane % 4 a lane holds c[2 h + e] = C[16 p + r
// + 8 h][8 q + 2 t + e] (bmm64.cu's fragment layout, panel_dmma.cuh): the
// float64 tensor cores (mma.sync m16n8k16) add one slice a step.

#pragma once

#include <cuda_runtime.h>

#include "panel_dmma.cuh"

namespace ctile {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxFrags = 4;   // QW: fragments a warp (1, 2 or 4)

__host__ __device__ constexpr int lg2(int x) {
  return x <= 1 ? 0 : 1 + lg2(x / 2);
}

// A warp's place in the block's tile (see above).
struct Map {
  int panel, group, split, ks;
};

__device__ __forceinline__ Map warp_map(int lgP, int lgGroups) {
  const int lgKs = lg2(kWarps) - lgP - lgGroups;
  const int w = threadIdx.x >> 5;
  return {w >> (lgGroups + lgKs), (w >> lgKs) & ((1 << lgGroups) - 1),
          w & ((1 << lgKs) - 1), 1 << lgKs};
}

// Shared memory of reduce(): every warp's values, lane-major.
struct Red {
  double v[kWarps][4 * kMaxFrags][32];
};

// Adds the ks warps' acc of each (panel, group) in split order into the
// split-0 warp's acc and returns true in that warp.  Starts with a
// barrier, so red may alias memory the block has finished reading.
template <int QW>
__device__ __forceinline__ bool reduce(double (&acc)[QW][4], const Map& w,
                                       Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (w.ks > 1) {
#pragma unroll
    for (int q = 0; q < QW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) red.v[warp][4 * q + e][lane] = acc[q][e];
  }
  __syncthreads();
  if (w.split != 0) return false;
  for (int sp = 1; sp < w.ks; ++sp)
#pragma unroll
    for (int q = 0; q < QW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[q][e] += red.v[warp + sp][4 * q + e][lane];
  return true;
}

}  // namespace ctile
