#!/usr/bin/env python3
"""Check and tune the redesigned kernels of the PyTorch/CUDA port on one
CUDA card: the tensor-core kernels ``bmm64`` (float64 DMMA) and
``schur_wwt`` (3xTF32), the blocked triangular kernels ``cholesky_lanes``
and ``tril_inverse``, the panel-blocked factor-quality ``cholesky``, the
fused Schur solve ``schur_solve_fused`` (a cluster an instance) and the
fused direction's staged float64 tensor-core ``rhs_bucket`` and
``recover_bucket``, the fused ``A -> L^-1`` ``chol_inverse_lanes``, and
the static paths of the float64 contractions ``contract_short64`` and
``contract_long64``.

    python3 profile_torch_kernels.py check [GROUP]     # build, ptxas, errors
    python3 profile_torch_kernels.py variants [GROUP]  # time design variants
    python3 profile_torch_kernels.py dissect [GROUP]   # parts cut out
    python3 profile_torch_kernels.py phases [GROUP]    # kernel phases
    python3 profile_torch_kernels.py reference         # Schur plans, chaos
    python3 profile_torch_kernels.py phases cholinv [PARENT_CSRC]
    python3 profile_torch_kernels.py dissect cholinv [PARENT_CSRC]
    python3 profile_torch_kernels.py phases contract [PARENT_CSRC]

GROUP takes one group of kernels: ``mma`` the tensor-core kernels, ``tri``
the two blocked triangular ones, ``chol`` the factor-quality Cholesky,
``schur`` the fused Schur solve, ``bucket`` rhs_bucket and recover_bucket,
``cholinv`` chol_inverse_lanes, ``contract`` the two contractions
(default all; ``phases`` without a group runs chip_smoke.py's df32 and
float32 kernel phases).  PARENT_CSRC, the
``scipsdp_tpu_torch/csrc`` directory of another checkout (an unpacked
``git archive`` of the parent commit under ``build/``), adds that
checkout's ``chol_inverse_lanes.cu``, built against its own headers and
called with its own entry point, to ``phases cholinv`` (timed in turns
with the committed kernel) and to ``dissect cholinv`` (cut up).
``check`` builds the sources, prints the compiler's report, and holds
each kernel against its plain version (and float64 numpy) on a few shapes
around the fragment and block edges (the triangular kernels through
``chip_smoke.pallas_check``, and the Cholesky's pivot edges through
``chip_smoke.pivot_edges``): the short first run after a kernel change.
``variants`` times the committed kernels beside variants made by
substituting constants in a copy of the source under ``build/variants/``
(tile rows, slab depth and the small-matrix threshold of ``bmm64``; the
pipeline depth and warp tile of ``schur_wwt``; the block width nb = 32 and
the threads per block of the triangular kernels) and beside other settings
of ``schur_wwt``'s F split, each against the library call, in turns,
replayed from CUDA graphs (``chip_smoke.graph_times``).
``dissect`` stands in for a kernel profiler where none is at hand: it
times each kernel beside copies with one part taken out (the copies into
shared memory, the products, the triangular kernels' diagonal-block step,
the stores, all but the launch), so the differences say what each part
costs.
For ``chol`` and ``schur`` the same three modes hold the factor-quality
Cholesky (``check``: around the panel and shared-memory edges, NaN on
and below the diagonal of a matrix that is not positive definite) and
the Schur solve (``check``: every chip_smoke.FUSED_SHAPES case at
nrefine 0, 1 and 3, and a W that starts off 16-byte alignment;
``variants``: other cluster sizes and chunks through the same entry
point, and copies with other constants; ``dissect``: the parent
commit's cooperative kernel or the cluster kernel, whichever the
checkout holds, with a part cut out).  For ``bucket``: ``check`` holds
both kernels to their plain versions and numpy at chip_smoke.FUSED_BARS,
two launches bit for bit, at every chip_smoke.FUSED_SHAPES case and
chip_smoke.BUCKET_EDGES; ``variants`` times copies with other contraction
slices and warps a block (BUCKET_VARIANTS); ``dissect`` cuts up the
parent commit's row-panel kernels or the staged ones, whichever the
checkout holds (BUCKET_CUTS: each launch, the copies, each product, the
contraction's loads and tile sums, the stores).
For ``cholinv``: ``check`` holds the kernel to its plain version and
numpy (chip_smoke.pallas_check) at TRI_CHECK_N and around its
shared-memory limit (CHOLINV_CHECK_N), for 1 and 5 matrices and on two
ill-conditioned stacks, beside the cholesky -> tril_inverse kernel pair's
error; ``phases cholinv`` times it, the parent's kernel, the kernel pair
and the library pair (cholesky_ex -> solve_triangular) at CHOLINV_TIMED;
``variants`` a cluster of two blocks a matrix (CHOLINV_CLUSTER), other
block sizes and nb = 32; ``dissect`` cuts out the X update, the factor, the copies and the
stores (CHOLINV_CUTS; the parent's factor or inverse with PARENT_CSRC).
For ``contract``: ``check`` holds both kernels to their plain versions
(chip_smoke.df32_check) at every df32-phase case, at chip_smoke.py's
static tile edges (contract_edge_phase) and on two streams and from two
graphs at once (contract_streams_check); ``variants`` times the static
cases under other launch plans of ops/df32.py (panels, fragments a warp,
groups, chunks) and copies of the short source with other loads in
flight, beside the float64 einsum; ``dissect`` cuts out the loads,
the short kernel's copies of v, the products, the stores or partials,
the long one's grid barrier and chunk sum (CONTRACT_CUTS, in the source with
contract_tile.cuh inlined); ``phases contract`` times every df32-phase
contraction case (contract_times), with PARENT_CSRC that checkout's two
sources in the same graphs, parent, change, change, parent, and the
static cases also with the L2 cold.
``phases`` runs ``chip_smoke.py``'s build and its ``df32_phase`` and
``pallas_kernel_phase`` (every shape those time, a few minutes); ``phases
tri``, ``phases chol``, ``phases schur`` and ``phases bucket`` only the
build and the group's kernels, plain versions and library calls (for
``bucket``: bounds) at the main-path shapes, in graphs.  ``reference`` runs chip_smoke.py's small
CPU-reference instance through the fused refine route under each cluster
plan of the Schur solve (iterations against the CPU solve's; every
call's deviation from the plain version).
Copied into a checkout of another commit and run there, it times that
commit's kernels by the same means, for a comparison within one call on
one card.  Every line printed is one JSON object; the first names the
card and its power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops import df32, fused, kernels

VARIANT_DIR = _build.BUILD_ROOT.parent / "variants"
BMM_SHAPES = [("cls_32 X Rp", 32, 65), ("cls_64", 8, 129), ("mkp_10", 1472, 10)]
GRAM_SHAPES = [("cls_32", 32, 66, 4290), ("cls_64", 8, 130, 16770),
               ("mkp_10", 32, 46, 101)]
# the triangular kernels' timed shapes: (kernel, label, leading shape, n);
# the X/S stacks and Schur factors of the float32 tiers and the stacked
# probe ladders of chip_smoke.py (TRI_SHAPES, CHOL_SHAPES), and n = 300
TRI_TIMED = [("tril_inverse", "cls_32 X/S", (32, 2), 65),
             ("tril_inverse", "cls_32 Schur", (32,), 66),
             ("tril_inverse", "cls_64 X/S", (8, 2), 129),
             ("tril_inverse", "cls_64 Schur", (8,), 130),
             ("tril_inverse", "mkp_10 X/S", (32, 2), 10),
             ("tril_inverse", "n=300", (4,), 300),
             ("cholesky_lanes", "cls_32 probes", (32, 10), 65),
             ("cholesky_lanes", "cls_64 probes", (8, 10), 129),
             ("cholesky_lanes", "cls_32 B=128 probes", (384,), 65),
             ("cholesky_lanes", "mkp_10 probes", (14720,), 10),
             ("cholesky_lanes", "n=300", (4,), 300)]
# n (for 1 and 5 matrices each) at which check() holds them, around the
# block widths 16 and 32, the shared-memory limits and n = 300
TRI_CHECK_N = (5, 9, 10, 16, 17, 31, 32, 33, 48, 65, 66, 129, 130, 200, 238,
               300)
# the factor-quality Cholesky's timed shapes (chip_smoke.TRI_SHAPES' main
# path: the float32 tiers' X/S stacks and Schur factors) and n = 300, and
# its checked n (TRI_CHECK_N, and both sides of its 128-thread and
# shared-memory limits, n = 80 and 224)
CHOL_TIMED = [("cholesky", "cls_32 X/S", (32, 2), 65),
              ("cholesky", "cls_32 Schur", (32,), 66),
              ("cholesky", "cls_64 X/S", (8, 2), 129),
              ("cholesky", "cls_64 Schur", (8,), 130),
              ("cholesky", "mkp_10 X/S", (32, 2), 10),
              ("cholesky", "mkp_10 Schur", (32,), 46),
              ("cholesky", "n=300", (4,), 300)]
CHOL_CHECK_N = tuple(sorted(TRI_CHECK_N + (80, 81, 224, 225)))
# the fused A -> L^-1's timed shapes: the float32 tiers' X/S stacks and
# Schur factors at cls_32 B=32 and cls_64 B=8, mkp_10's X/S stack and n =
# 300 (device memory); checked n: TRI_CHECK_N and both sides of its
# shared-memory limit (np = 224)
CHOLINV_TIMED = [("chol_inverse_lanes", "cls_32 X/S", (32, 2), 65),
                 ("chol_inverse_lanes", "cls_32 Schur", (32,), 66),
                 ("chol_inverse_lanes", "cls_64 X/S", (8, 2), 129),
                 ("chol_inverse_lanes", "cls_64 Schur", (8,), 130),
                 ("chol_inverse_lanes", "mkp_10 X/S", (32, 2), 10),
                 ("chol_inverse_lanes", "n=300", (4,), 300)]
CHOLINV_CHECK_N = tuple(sorted(TRI_CHECK_N + tuple(range(160, 167)) +
                               (224, 225)))
# the Schur solve's timed cases: labels of chip_smoke.FUSED_SHAPES
SCHUR_TIMED = ("cls_32 B=32", "cls_64 B=8", "mkp_10 B=32", "F=420", "F=700")


def compiled(name: str, tag: str, src: str, csrc=_build.CSRC) -> ctypes.CDLL:
    """``src``, a changed copy of ``<csrc>/<name>.cu``, built against the
    headers in ``csrc`` into ``build/variants/`` and loaded."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    cu = VARIANT_DIR / f"{name}_{tag}.cu"
    so = VARIANT_DIR / f"lib{name}_{tag}.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(csrc), "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def variant(name: str, tag: str, subs: dict) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with each ``constexpr int <key> = ...;`` set to
    ``subs[key]``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for key, value in subs.items():
        src, hits = re.subn(rf"(constexpr int {key} = )[^;]+;",
                            rf"\g<1>{value};", src)
        if hits != 1:
            raise KeyError(f"{name}.cu: constant {key} found {hits} times")
    return compiled(name, tag, src)


def cut(name: str, tag: str, *edits: tuple, csrc=_build.CSRC) -> ctypes.CDLL:
    """``<csrc>/<name>.cu`` with each (text, replacement[, count]) applied
    to the ``count`` (default 1) places the text stands: a kernel with one
    part taken out, to time what is left.  Its results are wrong by design;
    only its time is read."""
    src = (csrc / f"{name}.cu").read_text()
    for text, replacement, *count in edits:
        if src.count(text) != (count[0] if count else 1):
            raise KeyError(f"{name}.cu: {text!r} found {src.count(text)} "
                           "times")
        src = src.replace(text, replacement)
    return compiled(name, tag, src, csrc)


# the cuts of dissect(): (text in the source, what takes its place)
BMM_CUTS = {
    "return": ("double* __restrict__ C, int n, int col_panels) {\n",
               "double* __restrict__ C, int n, int col_panels) {\n"
               "  if (n > 0) return;\n"),
    "copies": ("  auto load_slab = [&](int k0) {\n",
               "  auto load_slab = [&](int k0) {\n    if (n > 0) return;\n"),
    "products": ("          dmma_k16(acc[i], a, b);\n",
                 "          acc[i][0] += a[0] + b[0];\n"),
    "stores": ("  if (!live) return;\n  const int q",
               "  if (!live || acc[0][0] != 1.2345) return;\n  const int q"),
}
GRAM_MMAS = ("            mma_tf32(part[jj], alo, bhi);\n"
             "            mma_tf32(part[jj], ahi, blo);\n"
             "            mma_tf32(part[jj], ahi, bhi);\n")
GRAM_CUTS = {
    "return": ("long long F, int chunk_len, int direct) {\n",
               "long long F, int chunk_len, int direct) {\n"
               "  if (mp > 0) return;\n"),
    "copies": ("  auto load_slab = [&](int slab, int stage) {\n",
               "  auto load_slab = [&](int slab, int stage) {\n"
               "    if (mp > 0) return;\n"),
    "two of three products": (
        GRAM_MMAS, "            mma_tf32(part[jj], ahi, bhi);\n"),
}


TRINV_CUTS = {
    "return": ("int n, int nblk, int fit) {\n",
               "int n, int nblk, int fit) {\n  if (n > 0) return;\n"),
    "copies": ("    if (row < n && q <= p) cp_async4(d, L",
               "    if (n < 0 && q <= p) cp_async4(d, L"),
    "strips": ("  for (int s = 1; s <= issued; ++s) {\n    load_strip(s);",
               "  for (int s = 1; s <= issued; ++s) {\n    if (n < 0) load_strip(s);"),
    "diagonal inverses": ("    for (int round = 0; round * groups < m; ++round) {",
                          "    for (int round = 0; round * groups < m && n < 0;"
                          " ++round) {"),
    "products": ("      for (int k = 0; k < width; ++k) {",
                 "      for (int k = 0; k < width && n < 0; ++k) {"),
    "stores": ("      if (c < w && c0 + k < n) O[",
               "      if (c < w && c0 + k < n && res[0] == 1.2345f) O["),
}
CHOL_CUTS = {
    "return": ("int np, int ld, int in_smem) {\n",
               "int np, int ld, int in_smem) {\n  if (n > 0) return;\n"),
    "copies": ("        if (in_smem) cp_async4(W",
               "        if (in_smem && n < 0) cp_async4(W"),
    "diagonal factor": ("  factor_block(a, r, rinv);\n  if (threadIdx.x < kNB) {",
                        "  if (k1 < 0) factor_block(a, r, rinv);\n"
                        "  if (threadIdx.x < kNB) {"),
    "row solves": ("    for (int i = k1 + tid; i < np; i += nt) {",
                   "    for (int i = k1 + tid; i < np && n < 0; i += nt) {"),
    "trailing products": ("      for (int k = 0; k < kNB; ++k) {\n        const float4 pr",
                          "      for (int k = 0; k < kNB && n < 0; ++k) {\n"
                          "        const float4 pr"),
    "stores": ("      if (in_smem) O[(size_t)i * n + j]",
               "      if (in_smem && n < 0) O[(size_t)i * n + j]"),
}
# Parts of the fused A -> L^-1 cut out (for "factor": the row solves, the
# trailing tiles and the look-ahead diagonal factors; the X part keeps the
# first panel's L11), and of the parent commit's kernel (PARENT_CUTS: its
# unblocked left-looking factor, then its inverse a thread a column)
CHOLINV_CUTS = {
    "return": ("  extern __shared__ __align__(16) float smem[];\n"
               "  const float* A = in + (size_t)blockIdx.x * n * n;\n",
               "  extern __shared__ __align__(16) float smem[];\n"
               "  if (n > 0) return;\n"
               "  const float* A = in + (size_t)blockIdx.x * n * n;\n"),
    "copies": ("        if (W.smem) cp_async4(W.w + (size_t)r * W.ld + c, "
               "A + (size_t)r * n + c);",
               "        if (W.smem) W.w[(size_t)r * W.ld + c] = r == c ? n : 0.f;"),
    "X update": (("      else col_solve(W, S, Xp, np, k0, t - nrows);",
                  "      else if (n < 0) col_solve(W, S, Xp, np, k0, t - nrows);"),
                 ("ntiles = na + T * (k1 / 4);",
                  "ntiles = na + (n < 0 ? T * (k1 / 4) : 0);")),
    "factor": (("      if (t < nrows) row_solve(W, S, P, nullptr, np, k0, k1 + t);",
                "      if (t < nrows) {\n"
                "        if (n < 0) row_solve(W, S, P, nullptr, np, k0, k1 + t);\n"
                "      }"),
               ("        diagonal_block(W, k1, S, nullptr, flag);",
                "        if (n < 0) diagonal_block(W, k1, S, nullptr, flag);"),
               ("        if (t < na) a_tile(W, P, np, k1, t);",
                "        if (t < na) {\n"
                "          if (n < 0) a_tile(W, P, np, k1, t);\n"
                "        }")),
    "look-ahead factor": ("        diagonal_block(W, k1, S, nullptr, flag);",
                          "        if (n < 0) diagonal_block(W, k1, S, nullptr, flag);"),
    "stores": ("      else if (W.smem) O[(size_t)i * n + j]",
               "      else if (W.smem && n < 0) O[(size_t)i * n + j]"),
}
PARENT_CUTS = {
    "return": ("                                    int in_smem) {\n",
               "                                    int in_smem) {\n"
               "  if (n > 0) return;\n"),
    "factor": ("  const bool ok = tri::factor_lower(a, n, lda, col);",
               "  const bool ok = true;"),
    "inverse": ("  tri::invert_lower(a, lda, x, lda, n);", ""),
}
# Parts of the factor-quality Cholesky cut out.  Every copy, the whole one
# too, loses its fall-back to the unblocked IEEE factorization
# (CHOL2_ONCE): a cut that leaves the data out of the fast operations'
# range must not send its matrices down that path, and on the inputs of
# the timed shapes no copy with the fall-back takes it.
CHOL2_ONCE = (("  if (ok && flags[1]) {", "  if (ok && flags[1] && n < 0) {"),)
CHOL2_CUTS = {
    "return": ("                    int ld) {\n",
               "                    int ld) {\n  if (n > 0) return;\n"),
    "copies": ("        if (in_smem) cp_async4(W + (size_t)r * ld + c, "
               "A + (size_t)r * n + c);",
               "        if (in_smem) W[(size_t)r * ld + c] = r == c ? n : 0.f;"),
    "diagonal factor": (
        "  const bool exact = __all_sync(kFull, factor_block(a, r, ok, false));",
        "  const bool exact = true;\n"
        "  if (k1 < 0) factor_block(a, r, ok, false);"),
    "exact ops of the diagonal factor": (
        "      d = sqrt_rn(c);\n      quo = div_rn(a[q], d);",
        "      d = c * rsqrt_approx(c);\n      quo = a[q] * rcp_approx(d);"),
    "row solves": ("    for (int i = k1 + tid; i < np; i += nt) {",
                   "    for (int i = k1 + tid; i < np && n < 0; i += nt) {"),
    "row divisions": ("        l[q] = div_rn(s, d);",
                      "        l[q] = s * rcp_approx(d);"),
    "trailing products": ("      for (int k = 0; k < kNB; ++k) {\n"
                          "        const float4 pr",
                          "      for (int k = 0; k < kNB && n < 0; ++k) {\n"
                          "        const float4 pr"),
    "stores": ("      else if (in_smem) O[(size_t)i * n + j]",
               "      else if (in_smem && n < 0) O[(size_t)i * n + j]"),
}
# Parts of the Schur solve cut out, for the kernel the checkout holds: the
# parent commit's cooperative launch (grid-wide barriers, W^T vf a thread
# a column, W wt a block a row re-reading wt) or the cluster kernel
SCHUR_RETURN = ("schur_solve_fused_kernel(Args a) {\n",
                "schur_solve_fused_kernel(Args a) {\n  if (a.B > 0) return;\n")
SCHUR_EXCHANGE = (
    ("      double u = *cluster.map_shared_rank(usp + j, 0);\n"
     "      for (int q = 1; q < C; ++q) u += *cluster.map_shared_rank(usp + j, q);",
     "      double u = usp[j];\n      for (int q = 1; q < C; ++q) u += usp[j];"),)
SCHUR_COMPUTE = (
    ("      for (int t = tid; t < groups * cp; t += kThreads) {",
     "      for (int t = tid; t < groups * cp && cp < 0; t += kThreads) {"),
    ("      for (int i0 = warp; i0 < mp; i0 += kRowsAtOnce * kWarps) {",
     "      for (int i0 = warp; i0 < mp && mp < 0; "
     "i0 += kRowsAtOnce * kWarps) {"),
    ("  for (int i0 = warp; i0 < mp; i0 += 2 * kWarps) {",
     "  for (int i0 = warp; i0 < mp && mp < 0; i0 += 2 * kWarps) {"))
SCHUR_CUTS = {
    "cooperative": {
        "return": (SCHUR_RETURN,),
        "grid syncs": (
            ("namespace {\n\nconstexpr int kThreads = 256;",
             "namespace {\n\nstruct NoSync {\n  __device__ void sync() const {}"
             "\n};\nconstexpr int kThreads = 256;"),
            ("  cg::grid_group grid = cg::this_grid();\n", "  NoSync grid;\n")),
        "W^T vf": (("    for (long long idx = gtid; idx < cols; idx += gsize) {",
                    "    for (long long idx = gtid; idx < cols && cols < 0; "
                    "idx += gsize) {"),),
        "W wt": (("    for (long long row = blockIdx.x; row < rows; "
                  "row += gridDim.x) {",
                  "    for (long long row = blockIdx.x; row < rows && rows < 0;"
                  " row += gridDim.x) {"),),
        "wt re-reads": (("        acc = fma((double)Wr[f], w[f], acc);",
                         "        acc = fma((double)Wr[f], (double)f, acc);"),),
        "preconditioner": (
            ("  for (long long row = gwarp; row < rows; row += nwarps) {",
             "  for (long long row = gwarp; row < rows && rows < 0; "
             "row += nwarps) {"),),
    },
    "cluster": {
        "return": (SCHUR_RETURN,),
        "staging": (("      cp_async<kBytes>(d + c, s + c);",
                     "      if (mp < 0) cp_async<kBytes>(d + c, s + c);"),),
        "W^T vf": SCHUR_COMPUTE[:1],
        "W wt": SCHUR_COMPUTE[1:2],
        "preconditioner": SCHUR_COMPUTE[2:],
        "cluster exchange": SCHUR_EXCHANGE,
        "cluster barriers and exchange": SCHUR_EXCHANGE + (
            ("    cluster.sync();\n    // u in", "    __syncthreads();\n    // u in"),
            ("  if (a.nrefine > 0) cluster.sync();",
             "  if (a.nrefine > 0) __syncthreads();")),
        "products, exchange and preconditioner (staging alone)":
            SCHUR_COMPUTE + SCHUR_EXCHANGE,
    },
}


def bmm_variant(lib: ctypes.CDLL):
    fn = lib.bmm64_f64
    fn.argtypes = list(df32._ARGTYPES["bmm64"])
    fn.restype = ctypes.c_int

    def call(A, B):
        out = torch.empty_like(A)
        n = A.shape[-1]
        err = fn(A.data_ptr(), B.data_ptr(), out.data_ptr(),
                 A.numel() // (n * n), n, int(B.dtype == torch.float32),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bmm64 variant: CUDA error {err}")
        return out
    return call


def gram_variant(lib: ctypes.CDLL):
    fn = lib.schur_wwt_f32
    fn.argtypes = list(kernels._ARGTYPES["schur_wwt"])
    fn.restype = ctypes.c_int

    def call(W):
        B, mp, F = W.shape
        out = torch.empty((B, mp, mp), dtype=W.dtype, device=W.device)
        nchunks, chunk_len = kernels.gram_chunks(B, mp, F)
        work = torch.empty((nchunks, B, mp, mp), dtype=W.dtype,
                           device=W.device) if nchunks > 1 else out
        err = fn(W.data_ptr(), out.data_ptr(), work.data_ptr(), B, mp, F,
                 nchunks, chunk_len, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"schur_wwt variant: CUDA error {err}")
        return out
    return call


def tri_variant(lib: ctypes.CDLL, name: str, nb: int):
    """The C entry ``<name>_f32`` of a built copy of a triangular kernel
    whose block width (``kNB``) is ``nb``, called with the block count that
    ``kernels.tri_blocks`` gives for that width."""
    fn = getattr(lib, f"{name}_f32")
    fn.argtypes = list(kernels._ARGTYPES[name])
    fn.restype = ctypes.c_int

    def call(A):
        out = torch.empty_like(A)
        n = A.shape[-1]
        err = fn(A.data_ptr(), out.data_ptr(), A.numel() // (n * n), n,
                 max(1, -(-n // nb)), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} variant: CUDA error {err}")
        return out
    return call


def tri_case(name: str, lead: tuple, n: int, rng, scale: float = 0):
    """(args, float64 reference) of a triangular kernel: a positive definite
    stack (chip_smoke.spd_stack) for the Cholesky kernels and the fused
    inverse, its factor rounded to float32 for ``tril_inverse``."""
    N = int(np.prod(lead))
    # without a scale, the call an earlier commit's chip_smoke.py takes
    A64 = cs.spd_stack(rng, N, n, scale) if scale else cs.spd_stack(rng, N, n)
    if name in ("cholesky_lanes", "cholesky"):
        A32 = A64.astype(np.float32)
        ref = np.linalg.cholesky(A32.astype(np.float64))
    elif name == "chol_inverse_lanes":
        A32 = A64.astype(np.float32)
        ref = np.linalg.inv(np.linalg.cholesky(A32.astype(np.float64)))
    else:
        A32 = np.linalg.cholesky(A64).astype(np.float32)
        ref = np.linalg.inv(A32.astype(np.float64))
    A = torch.as_tensor(A32.reshape(lead + (n, n)), device="cuda")
    return (A,), ref.reshape(lead + (n, n))


def library_call(name: str, n: int, device):
    """The one PyTorch call computing a triangular kernel's function (for
    the fused inverse, the two: chip_smoke.library_pair)."""
    if name in ("cholesky_lanes", "cholesky"):
        return torch.linalg.cholesky_ex
    if name == "chol_inverse_lanes":
        return cs.library_pair
    eye = torch.eye(n, dtype=torch.float32, device=device)
    return lambda L: torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                                   upper=False)


def ptxas_report(*names: str) -> None:
    """Build the named sources and log each one's compiler report."""
    _build.build(*names)
    for name in names:
        report = (_build.library_path(name).parent / "build.log").read_text()
        cs.log("ptxas", kernel=name, report=[
            ln for ln in report.splitlines() if "registers" in ln
            or "Compiling" in ln or "spill" in ln or "error" in ln][:40])


# A kernel built with csrc/cholesky.cu that holds its sqrt_rn and div_rn
# to sqrtf and / bit for bit: the square root of every float in
# [2^-62, 2^62), and as many quotients of pseudo-random operands in that
# range (dividends of either sign, one in 1,024 a signed zero)
OPS_CHECK = r"""
#include "cholesky.cu"

namespace {
__device__ __forceinline__ unsigned mix(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return (unsigned)(x ^ (x >> 31));
}

__global__ void ops_check_kernel(unsigned long long n,
                                 unsigned long long* bad) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long k = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x; k < n; k += stride) {
    const float c = __uint_as_float((65u << 23) + (unsigned)k);
    if (__float_as_uint(sqrt_rn(c)) != __float_as_uint(sqrtf(c)))
      atomicAdd(bad, 1ull);
    const unsigned h = mix(k), g = mix(k ^ (0xA5A5A5A5ull << 32));
    const float d = __uint_as_float(((65u + h % 124u) << 23) | (g & 0x7fffffu));
    const unsigned ha = mix(k + 0x1234567ull), ga = mix(~k);
    float a = __uint_as_float(((65u + ha % 124u) << 23) | (ga & 0x7fffffu) |
                              (ha & 0x80000000u));
    if ((k & 1023) == 0) a = (k & 2048) ? -0.f : 0.f;
    if (__float_as_uint(div_rn(a, d)) != __float_as_uint(a / d))
      atomicAdd(bad + 1, 1ull);
  }
}
}  // namespace

extern "C" int cholesky_ops_check(unsigned long long n,
                                  unsigned long long* bad) {
  ops_check_kernel<<<132 * 16, 256>>>(n, bad);
  return (int)cudaGetLastError();
}
"""


# chol_inverse_lanes' variant with a thread-block cluster of two blocks a
# matrix, built from csrc/chol_inverse_lanes.cu (its device functions; S2
# and P2 are their second copies): rank 0 owns A and runs (a), (b), (c),
# rank 1 owns X and runs (d1), (d2), a cluster barrier for each block
# barrier; matrices whose buffer does not fit in shared memory take the
# committed entry, here renamed
CHOLINV_CLUSTER = r"""
#include <cooperative_groups.h>

#define chol_inverse_lanes_f32 chol_inverse_lanes_single_f32
#include "chol_inverse_lanes.cu"
#undef chol_inverse_lanes_f32

namespace {
namespace cg = cooperative_groups;

// The blocks of rank 0 (A: (a), (b), (c)) and rank 1 (X: (d1), (d2)) of
// a cluster take matrix blockIdx.x / 2, the buffer in shared memory in
// each; rank 0 writes S, P and the flag into rank 1's shared memory as
// well as its own.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    chol_inverse_cluster_kernel(const float* __restrict__ in, float* out,
                                int n, int np, int ld) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const bool owns_a = cluster.block_rank() == 0;
  const size_t mat = blockIdx.x / 2;
  const float* A = in + mat * n * n;
  float* O = out + mat * n * n;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32;
  const Buf W{smem, ld, np, true};
  float* P = smem + (size_t)np * ld;
  float* S = P + (size_t)kNB * np;
  int* flag = reinterpret_cast<int*>(S + kNB * LDS);
  float* P2 = owns_a ? cluster.map_shared_rank(P, 1) : nullptr;
  float* S2 = owns_a ? cluster.map_shared_rank(S, 1) : nullptr;
  int* flag2 = owns_a ? cluster.map_shared_rank(flag, 1) : flag;

  if (tid == 0) *flag = 0;
  cluster.sync();
  if (owns_a) stage(A, O, W, n, np);
  if (owns_a && warp == 0)
    diagonal_block(Buf{const_cast<float*>(A), n, n, false}, 0, S, S2, flag2);
  cp_async_wait_all();
  cluster.sync();
  for (int k0 = 0; k0 < np; k0 += kNB) {
    const int k1 = k0 + kNB;
    const int nrows = np - k1;
    if (owns_a) {
      for (int t = tid; t < nrows; t += nt)
        row_solve(W, S, P, P2, np, k0, k1 + t);
    } else {
      for (int c = tid; c < k1; c += nt) col_solve(W, S, nullptr, np, k0, c);
    }
    cluster.sync();
    const int T = nrows / 4;
    const int na = T * (T + 1) / 2;
    if (owns_a && warp == 0) {
      if (k1 < np) {
        diagonal_tiles_wait();
        diagonal_block(W, k1, S, S2, flag2);
      }
    } else if (owns_a) {
      if (tid - 32 < na) a_tile(W, P, np, k1, tid - 32);
      if (warp == 1 && k1 < np) diagonal_tiles_arrive();
      for (int t = tid - 32 + nt - 32; t < na; t += nt - 32)
        a_tile(W, P, np, k1, t);
    } else {
      for (int t = tid; t < T * (k1 / 4); t += nt)
        x_tile(W, P, nullptr, np, k0, k1, t);
    }
    cluster.sync();
  }
  if (!owns_a) write_out(O, W, n, *flag == 0);
}
}  // namespace

extern "C" int chol_inverse_lanes_f32(const float* in, float* out,
                                      long long nmat, int n, int npan,
                                      void* stream) {
  int max_smem = 0;
  cudaError_t err = tri::smem_limit(&max_smem);
  if (err != cudaSuccess) return (int)err;
  const int np = npan * kNB;
  const int ld = tri::smem_ld(np);
  const size_t smem = smem_floats(np, ld, true) * sizeof(float);
  if (npan < 2 || (long long)(npan - 1) * kNB >= n || np < n ||
      nmat >= (1LL << 30) || smem > (size_t)max_smem)
    return chol_inverse_lanes_single_f32(in, out, nmat, n, npan, stream);
  err = tri::smem_opt_in(chol_inverse_cluster_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  chol_inverse_cluster_kernel<<<(unsigned int)(2 * nmat), kThreads, smem,
                                (cudaStream_t)stream>>>(in, out, n, np, ld);
  return (int)cudaGetLastError();
}
"""


def chol_ops_check(device) -> None:
    """cholesky.cu's branch-free sqrt_rn and div_rn against sqrtf and /,
    bit for bit, over OPS_CHECK's 124 * 2^23 cases of each."""
    lib = compiled("cholesky", "ops_check", OPS_CHECK)
    fn = lib.cholesky_ops_check
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    n = 124 << 23
    err = fn(n, bad.data_ptr())
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"cholesky_ops_check: CUDA error {err}")
    wrong = bad.tolist()
    cs.log("check", kernel="cholesky", exact_ops_cases=n,
           sqrt_rn_differs=wrong[0], div_rn_differs=wrong[1])
    if any(wrong):
        raise AssertionError(f"sqrt_rn / div_rn differ from IEEE: {wrong}")


def tri_check(device, names=("cholesky_lanes", "tril_inverse")) -> None:
    """The blocked triangular kernels against their plain versions and
    float64 numpy (chip_smoke.pallas_check: bar, zeros above the diagonal,
    NaN pattern, bits on two launches) at 1 and 5 matrices of each checked
    n and on two ill-conditioned stacks."""
    ptxas_report(*names)
    rng = np.random.default_rng(5)
    for name in names:
        worst, pair = {}, {}
        ns = {"cholesky": CHOL_CHECK_N,
              "chol_inverse_lanes": CHOLINV_CHECK_N}.get(name, TRI_CHECK_N)
        cases = [(N, n, 0) for n in ns for N in (1, 5)]
        for N, n, scale in cases + [(4, 65, 4), (4, 129, 4)]:
            args, ref = tri_case(name, (N,), n, rng, scale)
            label = f"check ({N}, {n}) s={scale}"
            _, err, err_ref = cs.pallas_check(name, label, args, ref, N // 2)
            key = f"{N}x{n}" + (" ill" if scale else "")
            worst[key] = err_ref / float(np.abs(ref).max())
            if name == "chol_inverse_lanes" and scale:
                pair[key] = {"abs_err": err_ref, "kernel_pair_abs_err": (
                    cs.pair_entry(f"{label} ill-conditioned", args, ref,
                                  err_ref)["kernel_pair_err_vs_numpy"])}
        cs.log("check", kernel=name, nan_own_matrix_only=True,
               repeat_bit_for_bit=True, rel_err_vs_numpy=worst,
               **({"vs_kernel_pair": pair} if pair else {}))
    if "cholesky_lanes" in names:
        for n in (10, 65, 300):
            cs.log("check", kernel="cholesky_lanes", n=n,
                   pivot_edges=cs.pivot_edges(device, n))


def tri_times(device, timed=TRI_TIMED) -> None:
    """Each triangular kernel, its plain version and its library call at
    ``timed``, device ms from CUDA graphs (only the wrappers, so that the
    same lines run in a checkout of an earlier commit)."""
    rng = np.random.default_rng(6)
    for name, label, lead, n in timed:
        args, _ = tri_case(name, lead, n, rng)
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        ms = cs.graph_times([wrapper, plain, library_call(name, n, device)],
                            args)
        cs.log("tri_times", kernel=name, shape=label, lead=list(lead), n=n,
               ms=ms[0], plain_ms=ms[1], library_ms=ms[2])


def tri_variants(device, timed=TRI_TIMED) -> None:
    rng = np.random.default_rng(7)
    settings = {   # a substituted constant (key=value) a copy
        "chol_inverse_lanes": ["kThreads=256", "kThreads=1024", "kNB=32"],
        "tril_inverse": ["kThreads=64", "kThreads=256", "kNB=32"],
        "cholesky_lanes": ["kThreads=128", "kThreads=512", "kSmallThreads=64",
                           "kSmallThreads=256", "kNB=32"],
        "cholesky": ["kThreads=256", "kThreads=1024"]}
    settings = {k: v for k, v in settings.items()
                if k in {x[0] for x in timed}}
    calls = {}
    for name, subs in settings.items():
        calls[name] = {}
        for sub in subs:
            key, value = sub.split("=")
            lib = variant(name, key + value, {key: int(value)})
            nb = int(value) if key == "kNB" else kernels._TRI_NB
            calls[name][sub] = tri_variant(lib, name, nb)
        if name == "chol_inverse_lanes":
            calls[name]["cluster of 2"] = tri_variant(
                compiled(name, "cluster", CHOLINV_CLUSTER), name,
                kernels._TRI_NB)
    for name, label, lead, n in timed:
        args, ref = tri_case(name, lead, n, rng)
        fns = {"committed": getattr(kernels, name), **calls[name]}
        for k, f in fns.items():
            got = f(*args).double().cpu().numpy().reshape(ref.shape)
            rel = float(np.abs(got - ref).max() / np.abs(ref).max())
            if not rel <= 1e-4:
                raise AssertionError(f"{name} {k} {label}: {rel}")
        fns["library"] = library_call(name, n, device)
        cs.log("variants", kernel=name, shape=label, lead=list(lead), n=n,
               ms=dict(zip(fns, cs.graph_times(list(fns.values()), args))))


def tri_dissect(device, groups=(("tril_inverse", TRINV_CUTS, TRI_TIMED),
                                 ("cholesky_lanes", CHOL_CUTS, TRI_TIMED))):
    """The triangular kernels beside copies with parts cut out
    (TRINV_CUTS, CHOL_CUTS, CHOL2_CUTS), in turns, at the first four
    main-path shapes of each (and n = 300 for the factor-quality
    Cholesky)."""
    rng = np.random.default_rng(8)
    for name, cuts, timed in groups:
        base = CHOL2_ONCE if name == "cholesky" else ()
        libs = {"whole": cut(name, "whole", *base),
                "empty launch": cut(name, "ret", *base, cuts["return"])}
        for part, edit in cuts.items():
            if part != "return":
                libs[f"no {part}"] = cut(name, part.replace(" ", "_"), *base,
                                         edit)
        shapes = [x for x in timed if x[0] == name]
        shapes = shapes[:4] + [x for x in shapes[4:] if x[3] == 300
                               and name == "cholesky"]
        for _, label, lead, n in shapes:
            args, _ = tri_case(name, lead, n, rng)
            fns = [*(tri_variant(v, name, kernels._TRI_NB)
                     for v in libs.values()), library_call(name, n, device)]
            cs.log("dissect", kernel=name, shape=label, lead=list(lead), n=n,
                   ms=dict(zip([*libs, "library"], cs.graph_times(fns, args))))


def parent_cholinv(lib: ctypes.CDLL):
    """The C entry of another checkout's ``chol_inverse_lanes.cu`` built
    by ``compiled``/``cut`` (the parent design: a device-memory workspace
    of A's size, allocated at each call as its wrapper did, and no panel
    count)."""
    fn = lib.chol_inverse_lanes_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(A):
        out, work = torch.empty_like(A), torch.empty_like(A)
        n = A.shape[-1]
        err = fn(A.data_ptr(), out.data_ptr(), work.data_ptr(),
                 A.numel() // (n * n), n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent chol_inverse_lanes: CUDA error {err}")
        return out
    return call


def parent_source(parent) -> ctypes.CDLL:
    """``<parent>/chol_inverse_lanes.cu`` built as it stands."""
    return cut("chol_inverse_lanes", "parent", csrc=parent)


def cholinv_times(device, parent=None) -> None:
    """chol_inverse_lanes, the parent's kernel (with ``parent``), the
    cholesky -> tril_inverse kernel pair and the library pair at
    CHOLINV_TIMED, device ms from CUDA graphs replayed in turns; each held
    to numpy at the kernel's bar first."""
    rng = np.random.default_rng(9)
    fns = {"committed": kernels.chol_inverse_lanes}
    if parent is not None:
        fns = {"parent": parent_cholinv(parent_source(parent)), **fns}
    fns.update(kernel_pair=cs.kernel_pair, library_pair=cs.library_pair)
    for name, label, lead, n in CHOLINV_TIMED:
        args, ref = tri_case(name, lead, n, rng)
        errs = {}
        for k, f in fns.items():
            got = f(*args).double().cpu().numpy().reshape(ref.shape)
            np.testing.assert_allclose(got, ref, rtol=3e-3, atol=3e-3,
                                       err_msg=f"{k} {label}")
            errs[k] = float(np.abs(got - ref).max())
        ms = dict(zip(fns, cs.graph_times(list(fns.values()), args)))
        cs.log("cholinv_times", shape=label, lead=list(lead), n=n, ms=ms,
               max_abs_err_vs_numpy=errs,
               **cs.kernel_bound(name, args, fns["committed"](*args)))


def cholinv_dissect(device, parent=None) -> None:
    """chol_inverse_lanes beside copies with parts cut out (CHOLINV_CUTS)
    and, with ``parent``, the parent's kernel beside its cuts
    (PARENT_CUTS), in turns, at CHOLINV_TIMED."""
    rng = np.random.default_rng(10)
    name = "chol_inverse_lanes"
    calls = {"whole": tri_variant(cut(name, "whole"), name, kernels._TRI_NB)}
    for part, edit in CHOLINV_CUTS.items():
        edits = edit if isinstance(edit[0], tuple) else (edit,)
        lib = cut(name, part.replace(" ", "_"), *edits)
        calls["empty launch" if part == "return" else f"no {part}"] = (
            tri_variant(lib, name, kernels._TRI_NB))
    if parent is not None:
        calls["parent"] = parent_cholinv(parent_source(parent))
        for part, edit in PARENT_CUTS.items():
            lib = cut(name, f"parent_{part}", edit, csrc=parent)
            calls["parent empty launch" if part == "return"
                  else f"parent no {part}"] = parent_cholinv(lib)
    for _, label, lead, n in CHOLINV_TIMED:
        args, _ = tri_case(name, lead, n, rng)
        cs.log("dissect", kernel=name, shape=label, lead=list(lead), n=n,
               ms=dict(zip(calls, cs.graph_times(list(calls.values()),
                                                 args))))


def schur_caller(lib: ctypes.CDLL, plan=None):
    """The C entry of a built copy of ``schur_solve_fused.cu`` as a
    function of the wrapper's arguments: the parent commit's cooperative
    entry (scratch wt and v32, no plan), or the cluster entry with ``plan``
    (C, slice, chunk; the wrapper's unless given)."""
    fn = lib.schur_solve_fused_f64
    fn.argtypes = list(fused._ARGTYPES["schur_solve_fused"])
    fn.restype = ctypes.c_int
    cooperative = len(fn.argtypes) == 15

    def call(W, rhs, Minv, dsc, diag, reg, fix, nrefine):
        B, mp, F = W.shape
        dy = torch.empty((B, mp), dtype=torch.float64, device=W.device)
        ptrs = [W, rhs, Minv, dsc, diag, reg, fix]
        if cooperative:
            ptrs += [torch.empty((B, F), dtype=torch.float64, device=W.device),
                     torch.empty((B, mp), dtype=torch.float32, device=W.device)]
            extra = ()
        else:
            extra = plan or fused._device_plan(W.device.index, B, mp, F)
        err = fn(*(x.data_ptr() for x in ptrs + [dy]), B, mp, F, nrefine,
                 *extra, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"schur_solve_fused copy: CUDA error {err}")
        return dy
    return call


def schur_cases(device, labels=None) -> dict:
    """label -> the Schur solve's arguments at chip_smoke.FUSED_SHAPES (all
    of them, or those labelled)."""
    return {label: per_kernel["schur_solve_fused"][0]
            for label, per_kernel in cs.fused_cases(device)
            if labels is None or label in labels}


def schur_check(device) -> None:
    """The Schur solve against its plain version at every FUSED_SHAPES case
    and at nrefine 0, 1 and 3: at nrefine 3 within chip_smoke's bar
    (1e-10 max|plain|); at 0 and 1 within 1e-6 max|plain| (the plain
    version takes its preconditioner product in float32 arithmetic, the
    kernel in float64 rounded to float32: the two part by a float32 ulp
    until the refinement passes remove it); two launches bit for bit;
    fixed rows exactly 0.  Also with W starting 4 bytes off a 16-byte
    boundary (the kernel's 4-byte copies)."""
    ptxas_report("schur_solve_fused")
    cases = schur_cases(device)
    args = cases["cls_32 B=32"]
    W = args[0]
    off = torch.empty(W.numel() + 1, dtype=W.dtype, device=W.device)
    off[1:] = W.flatten()
    cases["cls_32 B=32, W off 16-byte alignment"] = (
        off[1:].view(W.shape),) + tuple(args[1:])
    for label, args in cases.items():
        W, fix = args[0], args[6]
        for nrefine in (0, 1, 3):
            a = args[:7] + (nrefine,)
            got = fused.schur_solve_fused(*a)
            again = fused.schur_solve_fused(*a)
            want = fused.schur_solve_fused_plain(*a)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            rel = float((got - want).abs().max()) / scale
            bar = 1e-10 if nrefine == cs.NREFINE else 1e-6
            same = bool((got == again).all())
            zero = bool((got[fix] == 0).all())
            cs.log("check", kernel="schur_solve_fused", shape=label,
                   B=W.shape[0], mp=W.shape[1], F=W.shape[2],
                   nrefine=nrefine,
                   plan=fused._device_plan(W.device.index, *W.shape),
                   rel_err_vs_plain=rel, bar=bar, repeat_same=same,
                   fixed_rows_zero=zero)
            if not (rel <= bar and same and zero):
                raise AssertionError(f"schur_solve_fused {label} nrefine "
                                     f"{nrefine}: {rel} {same} {zero}")


def schur_times(device) -> None:
    """The Schur solve and its plain version at SCHUR_TIMED, device ms from
    CUDA graphs (only the wrappers, so that the same lines run in a
    checkout of an earlier commit)."""
    for label, args in schur_cases(device, SCHUR_TIMED).items():
        ms = cs.graph_times([fused.schur_solve_fused,
                             fused.schur_solve_fused_plain], args)
        cs.log("schur_times", kernel="schur_solve_fused", shape=label,
               shape_bmf=list(args[0].shape), ms=ms[0], plain_ms=ms[1])


def schur_variants(device) -> None:
    """The committed plan beside other cluster sizes and chunks (the same
    library, other arguments) and copies with other constants, in turns,
    each held to the plain version."""
    libs = {"threads=512": variant("schur_solve_fused", "t512",
                                   {"kThreads": 512}),
            "rows_at_once=1": variant("schur_solve_fused", "r1",
                                      {"kRowsAtOnce": 1}),
            "rows_at_once=4": variant("schur_solve_fused", "r4",
                                      {"kRowsAtOnce": 4})}
    base = _build.load("schur_solve_fused")
    for label, args in schur_cases(device, SCHUR_TIMED).items():
        B, mp, F = args[0].shape
        C, slice_, chunk = fused._device_plan(device.index or 0, B, mp, F)
        plans = {}
        for c in (1, 2, 3, 4, 6, 8, 12, 16):
            plan = fused.schur_split(mp, F, c)
            if c != C and plan is not None:
                plans[f"C={c}" + (" streamed" if plan[2] < plan[1]
                                  else "")] = plan
            if plan is not None and plan[2] < plan[1] and c in (8, 16):
                half = plan[:2] + (max(4, plan[2] // 2 - plan[2] // 2 % 4),)
                plans[f"C={c} half chunks"] = half
        held = {}
        for k, p in {"committed": (C, slice_, chunk), **plans}.items():
            n = ctypes.c_int(0)
            err = base.schur_solve_fused_clusters(mp, F, *p, ctypes.byref(n))
            held[k] = n.value if err == 0 else f"CUDA error {err}"
        cs.log("clusters", kernel="schur_solve_fused", shape=label,
               plans={"committed": (C, slice_, chunk), **plans},
               clusters_at_once=held)
        fns = {"committed": fused.schur_solve_fused,
               **{k: schur_caller(base, p) for k, p in plans.items()},
               **{k: schur_caller(v) for k, v in libs.items()},
               "plain": fused.schur_solve_fused_plain}
        want = fused.schur_solve_fused_plain(*args)
        for k, f in list(fns.items()):
            try:
                got = f(*args)
            except RuntimeError as err:   # a copy the plan does not fit
                cs.log("variants", kernel="schur_solve_fused", shape=label,
                       variant=k, refused=str(err))
                del fns[k]
                continue
            rel = float((got - want).abs().max() / want.abs().max())
            if not rel <= 1e-10:
                raise AssertionError(f"schur_solve_fused {k} {label}: {rel}")
        cs.log("variants", kernel="schur_solve_fused", shape=label,
               plan=(C, slice_, chunk), ms=dict(zip(
                   fns, cs.graph_times(list(fns.values()), args))))


def schur_dissect(device) -> None:
    """The Schur solve the checkout holds beside copies with parts cut out
    (SCHUR_CUTS: the parent commit's cooperative kernel or the cluster
    kernel), in turns, at SCHUR_TIMED's first three cases."""
    src = (_build.CSRC / "schur_solve_fused.cu").read_text()
    kind = next(k for k, cuts in SCHUR_CUTS.items() if all(
        src.count(text) == 1 for edits in cuts.values() for text, _ in edits))
    libs = {"whole": cut("schur_solve_fused", "whole")}
    for part, edits in SCHUR_CUTS[kind].items():
        key = "empty launch" if part == "return" else f"no {part}"
        libs[key] = cut("schur_solve_fused", re.sub(r"\W+", "_", part),
                        *edits)
    for label, args in schur_cases(device, SCHUR_TIMED[:3]).items():
        fns = [schur_caller(v) for v in libs.values()]
        cs.log("dissect", kernel="schur_solve_fused", design=kind,
               shape=label, ms=dict(zip(libs, cs.graph_times(fns, args))))


def schur_reference(device) -> None:
    """chip_smoke.py's small CPU-reference instance (cpu_reference) through
    the fused refine route on the card, under the wrapper's plan and then
    under each cluster size 1-9 of ``fused.schur_split`` (the wrapper's
    plan only in a checkout without it): iterations and statuses beside
    the CPU solve's, and the worst per-instance deviation from the plain
    version over the solve's Schur solves."""
    import dataclasses
    from scipsdp_tpu_torch.models.families import cardinality_least_squares
    from scipsdp_tpu_torch.models.problem import densify
    from scipsdp_tpu_torch.ops.ipm import build_ipm_data, ipm_solve
    from scipsdp_tpu_torch.utils.config import Settings, resolve_backend_autos

    s = dataclasses.replace(resolve_backend_autos(Settings(), device).ipm,
                            max_iters=100, phase32="refine",
                            fused_direction="on", step_rule="probe",
                            use_lanes_chol=True)
    prob = cardinality_least_squares(8, 16, 3, seed=1)
    dense = densify(prob)
    lb, ub = cs.node_boxes(prob, 8, 8, np.random.default_rng(1))
    req = cs.request(prob, lb, ub, "direct")
    cpu = ipm_solve(build_ipm_data(dense, "cpu"), *req, settings=s)
    data = build_ipm_data(dense, device)
    wrapper = fused.schur_solve_fused
    worst, shapes = [], []

    def held_to_plain(*args):
        got = wrapper(*args)
        want = fused.schur_solve_fused_plain(*args)
        rel = (got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1e-300)
        worst.append(float(torch.nan_to_num(rel, nan=0.0).max()))
        shapes.append(tuple(args[0].shape))
        return got

    def solve(plan):
        worst.clear()
        out = ipm_solve(data, *req, settings=s)
        cs.log("reference", kernel="schur_solve_fused", plan=plan,
               shape=shapes[0], iters=out.iters, cpu_iters=cpu.iters,
               same_status=bool((out.status.cpu() == cpu.status).all()),
               worst_rel_vs_plain=max(worst))

    held_to_plain.launches = 0
    fused.schur_solve_fused = held_to_plain
    keep = getattr(fused, "_device_plan", None)
    try:
        solve("wrapper's")
        if hasattr(fused, "schur_split"):
            B, mp, F = shapes[0]
            for c in range(1, 10):
                plan = fused.schur_split(mp, F, c)
                fused._device_plan = lambda *a, _p=plan: _p
                solve(plan)
    finally:
        fused.schur_solve_fused = wrapper
        if keep is not None:
            fused._device_plan = keep


def via(lib: ctypes.CDLL, wrapper):
    """``wrapper`` (one of ops/fused.py's) launching the entry point of
    ``lib``, a built copy of its source, instead of the package's own
    library: the checkout's wrapper fits its source's C signature."""
    def entry(name, fn_name, argtypes):
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    work = getattr(lib, "rhs_bucket_work_doubles", None)
    if work is not None:    # rhs_bucket's scratch, as the copy counts it
        work.argtypes = [ctypes.c_int] * 4
        work.restype = ctypes.c_longlong

    def call(*args):
        keep = _build._entry, getattr(fused, "_rhs_work", None)
        _build._entry = entry
        if work is not None:
            fused._rhs_work = lambda *shape: int(work(*shape))
        try:
            return wrapper(*args)
        finally:
            _build._entry = keep[0]
            if keep[1] is not None:
                fused._rhs_work = keep[1]
    return call


# the bucket kernels' timed cases: labels of chip_smoke.FUSED_SHAPES
BUCKET_TIMED = ("cls_32 B=32", "cls_64 B=8", "mkp_10 B=32")
BUCKET = ("rhs_bucket", "recover_bucket")


def _stop(text: str) -> tuple:
    """An edit that makes the kernel whose signature ends in ``text``
    return at once."""
    return (text, text + "  if (blockDim.x > 0) return;\n")


# the staged kernels' cuts: each product kernel returns once it has zeroed
# the contraction's arrival counters; a panel product replaced by a value
ZERO_AND_STOP = ("  zero_counters(counters, ncounters);\n",
                 "  zero_counters(counters, ncounters);\n"
                 "  if (blockDim.x > 0) return;\n", 2)
FAKE_PRODUCT = ("acc[0][0] = acc[0][1] = acc[0][2] = acc[0][3] = acc[1][0] = "
                "acc[1][1] = acc[1][2] = acc[1][3] = (double)threadIdx.x;")
# Parts of rhs_bucket and recover_bucket cut out, for the design the
# checkout holds: the parent commit's row-panel kernels (a thread a
# column, operands read from L2 a step at a time) or the staged kernels
BUCKET_CUTS = {
    "row-panel": {
        "rhs_bucket": {
            "return": (_stop("int panels) {\n"), _stop("int mp, int nn) {\n")),
            "product launch": (_stop("int panels) {\n"),),
            "contraction launch": (_stop("int mp, int nn) {\n"),),
            "staging": (("Rc[g] - XRp[g] : 0.0;", "(double)g : 0.0;"),),
            "product": (("    for (int m = 0; m < n; ++m) {\n"
                         "      const double s = (double)S[",
                         "    for (int m = 0; m < n && n < 0; ++m) {\n"
                         "      const double s = (double)S["),),
            "P stores": (("      if (r < rows) P[",
                          "      if (r < rows && acc[r] == 1.2345) P["),),
            "contraction": (("for (long long ke = threadIdx.x; ke < KE;",
                             "for (long long ke = threadIdx.x; ke < KE && "
                             "KE < 0;"),),
        },
        "recover_bucket": {
            "return": (_stop("int mp, int nn) {\n"), _stop("int panels) {\n")),
            "A(dy) launch": (_stop("int mp, int nn) {\n"),),
            "chain launch": (_stop("int panels) {\n"),),
            "A(dy)": (("  for (int j = 0; j < mp; ++j) {",
                       "  for (int j = 0; j < mp && mp < 0; ++j) {"),),
            "X staging": (("Xs[e] = r < rows ? X[off + (size_t)(r0 + r) * n "
                           "+ (e - r * n)] : 0.0;", "Xs[e] = (double)e;"),),
            "X dS": (("    for (int m = 0; m < n; ++m) {\n"
                      "      const double d = dS[",
                      "    for (int m = 0; m < n && n < 0; ++m) {\n"
                      "      const double d = dS["),),
            "T S^-1": (("    for (int m = 0; m < n; ++m) {\n"
                        "      const double s = (double)S[",
                        "    for (int m = 0; m < n && n < 0; ++m) {\n"
                        "      const double s = (double)S["),),
            "dX stores": (("      dX[off + i] = pd[i] ? acc[r] : 0.0;",
                           "      if (acc[r] == 1.2345) dX[off + i] = "
                           "pd[i] ? acc[r] : 0.0;"),),
        },
    },
    "staged": {
        "rhs_bucket": {
            "return": (ZERO_AND_STOP, _stop("int spk, int steps) {\n")),
            "product launch": (ZERO_AND_STOP,),
            "contraction launch": (_stop("int spk, int steps) {\n"),),
            "staging": (
                ("  stage(Ss, ldb, Sinv + off, n, n, kp, up(n, 8));\n", ""),
                ("rc[c] - xr[c]", "(double)c")),
            "product": (
                ("  panel_product(acc, Ds, lda, Ss, ldb, kp, nfrag);",
                 FAKE_PRODUCT),),
            "P stores": (
                ("      if (r >= n) continue;\n      double* p",
                 "      if (r >= n || acc[f][2 * h] != 1.2345) continue;\n"
                 "      double* p"),),
            "contraction loads": (
                ("b[j] = j_ok && e_ok ? __ldg(arow + e) : 0.0;",
                 "b[j] = (double)e;"),
                ("? __ldg(prow[m][h] + e)", "? (double)(e + h)")),
            "tile sums": (("  if (!last) return;",
                           "  if (!last || S > 0) return;"),),
        },
        "recover_bucket": {
            "return": (_stop("int mp, int nn, int frags) {\n"),
                       _stop("                     int n, int panels) {\n")),
            "A(dy) launch": (_stop("int mp, int nn, int frags) {\n"),),
            "chain launch": (
                _stop("                     int n, int panels) {\n"),),
            "A(dy) loads": (
                ("bf[i] = e_ok && j_ok ? __ldg(acol + (size_t)j * nn) : 0.0;",
                 "bf[i] = (double)j;"),
                ("? __ldg(dyr[m][h] + j) : 0.0;", "? (double)(j + h) : 0.0;")),
            "X, dS staging": (
                ("  stage(Ps, lda, X + off + (size_t)r0 * n, n - r0, n, kRows, "
                 "kp);\n", ""),
                ("  stage(Bs, ld_b64(n), dS + off, n, n, kp, up(n, 8));\n",
                 "")),
            "X dS": (
                ("  panel_product(acc, Ps, lda, Bs, ld_b64(n), kp, nfrag);",
                 FAKE_PRODUCT),),
            "S^-1 staging": (
                ("  stage(Ss, ld_b32(n), Sinv + off, n, n, kp, up(n, 8));\n",
                 ""),),
            "T S^-1": (
                ("  panel_product(acc, Ps, lda, Ss, ld_b32(n), kp, nfrag);",
                 FAKE_PRODUCT),),
            "dX stores": (
                ("        if (q + c < n) dX[off + i]",
                 "        if (q + c < n && acc[f][2 * h + c] == 1.2345) "
                 "dX[off + i]"),),
        },
    },
}


def bucket_cases(device, labels=None) -> dict:
    """label -> {kernel: (args, numpy references)} of rhs_bucket and
    recover_bucket at chip_smoke.FUSED_SHAPES (all, or those labelled)
    and, for ``check``, chip_smoke.BUCKET_EDGES."""
    cases = {label: {k: per_kernel[k] for k in BUCKET}
             for label, per_kernel in cs.fused_cases(device)
             if labels is None or label in labels}
    if labels is None and hasattr(cs, "bucket_edge_cases"):
        cases.update(cs.bucket_edge_cases(device))
    return cases


def bucket_check(device) -> None:
    """rhs_bucket and recover_bucket against their plain versions and
    float64 numpy (chip_smoke.fused_check: FUSED_BARS, two launches bit
    for bit) at every FUSED_SHAPES case and chip_smoke.BUCKET_EDGES."""
    ptxas_report(*BUCKET)
    for label, per_kernel in bucket_cases(device).items():
        for name, (args, refs) in per_kernel.items():
            err, err_ref = cs.fused_check(name, label, args, refs)
            cs.log("check", kernel=name, shape=label,
                   blocks=list(args[-1].shape) if name == "recover_bucket"
                   else list(args[1].shape), max_abs_err=err,
                   max_abs_err_vs_numpy=err_ref, repeat_same=True)


def bucket_times(device) -> None:
    """Each bucket kernel, its plain version and its bound at
    BUCKET_TIMED, device ms from CUDA graphs (only the wrappers, so that
    the same lines run in a checkout of an earlier commit)."""
    for label, per_kernel in bucket_cases(device, BUCKET_TIMED).items():
        for name, (args, _) in per_kernel.items():
            wrapper = getattr(fused, name)
            ms = cs.graph_times([wrapper, getattr(fused, f"{name}_plain")],
                                args)
            bound = cs.kernel_bound(name, args, wrapper(*args))
            cs.log("bucket_times", kernel=name, shape=label, ms=ms[0],
                   plain_ms=ms[1], **bound,
                   share_of_bound=bound["bound_ms"] / ms[0])


BUCKET_VARIANTS = {   # a substituted constant (key=value) a copy
    "rhs_bucket": ["kSlicesPerTile=16", "kMinSteps=4", "kCWarps=8"],
    "recover_bucket": ["kDsWarps=2", "kDsWarps=8"],
}


def bucket_variants(device) -> None:
    """The committed bucket kernels beside copies with other constants
    (BUCKET_VARIANTS: the contraction's slices, the warps a block), each
    held to the plain version, timed in turns
    with the plain version at BUCKET_TIMED and at n = 16, 17, 32 and 33."""
    extra = [(f"n={n}", 32, 1, n, 46, "none") for n in (16, 17, 32, 33)]
    cases = {**bucket_cases(device, BUCKET_TIMED),
             **cs.bucket_edge_cases(device, extra)}
    for name, subs in BUCKET_VARIANTS.items():
        wrapper = getattr(fused, name)
        fns = {"committed": wrapper}
        for sub in subs:
            key, value = sub.split("=")
            fns[sub] = via(variant(name, key + value, {key: int(value)}),
                           wrapper)
        fns["plain"] = getattr(fused, f"{name}_plain")
        for label, per_kernel in cases.items():
            args = per_kernel[name][0]
            want = fns["plain"](*args)
            want = want if isinstance(want, tuple) else (want,)
            for k, f in fns.items():
                got = f(*args)
                got = got if isinstance(got, tuple) else (got,)
                for g, w in zip(got, want):
                    rel = float((g - w).abs().max() / w.abs().max())
                    if not rel <= 1e-11:
                        raise AssertionError(f"{name} {k} {label}: {rel}")
            cs.log("variants", kernel=name, shape=label, ms=dict(zip(
                fns, cs.graph_times(list(fns.values()), args))))


def bucket_dissect(device) -> None:
    """Each bucket kernel the checkout holds beside copies with parts cut
    out (BUCKET_CUTS), in turns, at BUCKET_TIMED; also the kernel with
    both launches made empty."""
    for name in BUCKET:
        src = (_build.CSRC / f"{name}.cu").read_text()
        kind = next(k for k, cuts in BUCKET_CUTS.items() if all(
            src.count(text) == (count[0] if count else 1)
            for edits in cuts[name].values()
            for text, _, *count in edits))
        libs = {"whole": cut(name, "whole")}
        for part, edits in BUCKET_CUTS[kind][name].items():
            key = "empty launches" if part == "return" else f"no {part}"
            libs[key] = cut(name, re.sub(r"\W+", "_", part), *edits)
        wrapper = getattr(fused, name)
        for label, per_kernel in bucket_cases(device, BUCKET_TIMED).items():
            args = per_kernel[name][0]
            fns = [via(v, wrapper) for v in libs.values()]
            fns.append(getattr(fused, f"{name}_plain"))
            cs.log("dissect", kernel=name, design=kind, shape=label,
                   ms=dict(zip([*libs, "plain"], cs.graph_times(fns, args))))


# the static contractions' timed cases: labels of chip_smoke.DF32_SHAPES
CONTRACT = ("contract_short64", "contract_long64")
CONTRACT_STATIC = {"contract_short64": "A(dy)", "contract_long64": "A*(Psi)"}
FLUSH_BYTES = 64 << 20     # written before each cold call (L2: 50 MB)
CONTRACT_IN_FLIGHT = (24, 40)   # the short kernel's kInFlight in copies
# the cuts of contract_dissect(): (text, replacement) in the source with
# contract_tile.cuh inlined
CONTRACT_CUTS = {
    "contract_short64": {
        "return": _stop("int F,\n                             int lgP, int lgGroups) {\n"),
        "loads": ("  return ok ? (double)__ldg(p) : 0.0;",
                  "  return ok ? (double)(size_t)p : 0.0;"),
        "v copies": ("        panel::cp_async<8>(Bs",
                     "        if (J < 0) panel::cp_async<8>(Bs"),
        "products": ("        panel::dmma_k16(acc[q], a[u], b);",
                     "        for (int z = 0; z < 4; ++z) acc[q][z] += a[u][z] + b[z];"),
        "stores": ("if (f < F && g < G) out[", "if (f < 0 && g < G) out["),
    },
    "contract_long64": {
        "return": _stop("int chunk, int lgP, int lgGroups) {\n"),
        "loads": ("  return ok ? (double)__ldg(p) : 0.0;",
                  "  return ok ? (double)(size_t)p : 0.0;"),
        "products": (
            "    for (int q = 0; q < QW; ++q) panel::dmma_k16(acc[q], a, b[q]);",
            "    for (int q = 0; q < QW; ++q)\n"
            "      for (int z = 0; z < 8; ++z) acc[q][z & 3] += a[z] + b[q][z & 3];"),
        "partials": ("if (j < J && g < G) dst[", "if (j < 0 && g < G) dst["),
        "grid barrier": ("  cg::this_grid().sync();\n", ""),
        "chunk sum": ("  for (size_t i = first; i < n; i += threads) {",
                      "  for (size_t i = first; i < 0; i += threads) {"),
    },
}


def contract_cases(device, static=None) -> list:
    """(kernel, label, args) of the two contractions among
    chip_smoke.df32_cases (``static``: only those with a static M, or only
    those without)."""
    return [(name, label, args) for name, label, args in cs.df32_cases(device)
            if name in CONTRACT and "test_df32" not in label
            and (static is None or (args[0].dim() == 2) == static)]


def with_plan(wrapper, plan):
    """``wrapper`` launched on ``plan`` (an ops/df32.py ContractPlan)
    instead of df32.contract_plan's."""
    def call(M, v):
        keep = df32.contract_plan
        df32.contract_plan = lambda *a, **k: plan
        try:
            return wrapper(M, v)
        finally:
            df32.contract_plan = keep
    return call


def parent_contract(lib: ctypes.CDLL, name: str):
    """The C entry of another checkout's contraction source built by
    ``cut`` (the parent design: no plan, no partials) as a wrapper."""
    fn = getattr(lib, f"{name}_f64")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(M, v):
        G, (J, F) = v.shape[0], M.shape[-2:]
        out = torch.empty((G, F) if name == "contract_short64" else (G, J),
                          dtype=torch.float64, device=v.device)
        err = fn(M.data_ptr(), v.data_ptr(), out.data_ptr(), G, J, F,
                 int(M.dtype == torch.float32), int(M.dim() == 3),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent {name}: CUDA error {err}")
        return out
    return call


def cold_times(fns, args, flush: torch.Tensor) -> list:
    """Device ms of one call of each of ``fns`` with the L2 cache cold:
    before each call ``flush`` (64 MB) is written and the stream held by
    a spin, so that the call is queued before its start event is reached
    (median of chip_smoke.REPS calls each, in turns)."""
    for f in fns:
        f(*args)
    times = tuple([] for _ in fns)
    for _ in range(cs.REPS):
        for f, acc in zip(fns, times):
            flush.fill_(1.0)
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f(*args)
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end))
    return [float(np.median(t)) for t in times]


def contract_check(device) -> None:
    """Both contractions' compiler reports, then every df32-phase
    contraction case and the static paths' tile edges against the plain
    versions (chip_smoke.df32_check: DF32_TOL, two launches bit for bit),
    and the static paths on two streams and from two graphs at once
    (chip_smoke.contract_streams_check)."""
    ptxas_report(*CONTRACT)
    cs.contract_edge_phase(device)
    cs.contract_streams_check(device)
    for name, label, args in contract_cases(device):
        _, err, rel = cs.df32_check(name, label, args)
        cs.log("check", kernel=name, shape=label, max_abs_err=err,
               max_rel_err=rel, repeat_same=True)


def contract_variants(device) -> None:
    """Each static case under the committed plan beside other plans (the
    panels a block, the fragments a warp and the groups; also the long
    one's chunk counts) and copies of the short one's source with other
    loads in flight a lane (CONTRACT_IN_FLIGHT), each
    held to the plain version, in turns with the float64 einsum."""
    copies = {}
    for name, label, args in contract_cases(device, static=True):
        G, (J, F) = args[1].shape[0], args[0].shape
        kind = "short" if name == "contract_short64" else "long"
        wrapper = getattr(df32, name)
        base = df32.contract_plan(kind, G, J, F)
        gf = -(-G // 8)
        plans = {"committed": base}
        for frags in (1, 2, 4):
            for groups in (1, 2, 4, 8):
                if frags * groups > df32._pow2(gf):
                    continue
                for P in (1, 2, 4, 8):
                    if P * groups > 8:
                        continue
                    key = f"P={P} QW={frags} groups={groups}"
                    if kind == "short":
                        for stage in (0, 1):
                            plans[f"{key} stage={stage}"] = df32.plan_of(
                                kind, G, J, F, P, frags, groups, stage=stage)
                        continue
                    for nc in sorted({base.chunks // 2, base.chunks,
                                      2 * base.chunks}):
                        if nc >= 1 and P <= 4:
                            plans[f"{key} chunks={nc}"] = df32.plan_of(
                                kind, G, J, F, P, frags, groups, nc)
        want = cs.PLAIN[name](*args)
        fns = {key: with_plan(wrapper, plan) for key, plan in plans.items()}
        for n in CONTRACT_IN_FLIGHT if kind == "short" else ():
            if (name, n) not in copies:
                copies[name, n] = variant(name, f"f{n}", {"kInFlight": n})
            fns[f"kInFlight={n}"] = via(copies[name, n], wrapper)
        for key, fn in fns.items():
            rel = float((fn(*args) - want).abs().max() / want.abs().max())
            if not rel <= cs.DF32_TOL:
                raise AssertionError(f"{name} {key} {label}: {rel}")
        fns["einsum64"] = cs.einsum64(name, args)
        ms = dict(zip(fns, cs.graph_times(list(fns.values()), args)))
        cs.log("variants", kernel=name, shape=label,
               plan=base._asdict(), ms=ms,
               **cs.kernel_bound(name, args, want))


def contract_dissect(device) -> None:
    """Each static kernel beside copies with parts cut out (CONTRACT_CUTS,
    in the source with contract_tile.cuh inlined), in turns, at the static
    cases."""
    header = (_build.CSRC / "contract_tile.cuh").read_text()
    for name in CONTRACT:
        src = (_build.CSRC / f"{name}.cu").read_text().replace(
            '#include "contract_tile.cuh"\n', header.replace(
                "#pragma once\n", ""))
        libs = {"whole": compiled(name, "whole", src)}
        for part, (text, replacement) in CONTRACT_CUTS[name].items():
            key = "empty launch" if part == "return" else f"no {part}"
            if src.count(text) != 1:
                raise KeyError(f"{name}: {text!r} found {src.count(text)} "
                               "times")
            libs[key] = compiled(name, re.sub(r"\W+", "_", part),
                                 src.replace(text, replacement))
        wrapper = getattr(df32, name)
        for kname, label, args in contract_cases(device, static=True):
            if kname != name:
                continue
            fns = [via(v, wrapper) for v in libs.values()]
            fns.append(cs.einsum64(name, args))
            cs.log("dissect", kernel=name, shape=label, ms=dict(zip(
                [*libs, "einsum64"], cs.graph_times(fns, args))))


def contract_times(device, parent=None) -> None:
    """Every df32-phase contraction case: the committed kernel and, with
    ``parent``, the parent checkout's kernel, parent, change, change,
    parent in turns, beside the float64 einsum and the plain version, as
    device ms from CUDA graphs (warm: M stays in L2 across the replays);
    the static cases also cold (cold_times)."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    for name, label, args in contract_cases(device):
        fns = {"change": getattr(df32, name)}
        if parent is not None:
            old = parent_contract(cut(name, "parent", csrc=parent), name)
            fns = {"parent": old, "change": fns["change"],
                   "change again": fns["change"], "parent again": old}
        fns.update(einsum64=cs.einsum64(name, args), plain=cs.PLAIN[name])
        want = cs.PLAIN[name](*args)
        for key in ("parent", "change"):
            if key in fns:
                rel = float((fns[key](*args) - want).abs().max()
                            / want.abs().max())
                if not rel <= cs.DF32_TOL:
                    raise AssertionError(f"{name} {key} {label}: {rel}")
        ms = dict(zip(fns, cs.graph_times(list(fns.values()), args)))
        cold = None
        if args[0].dim() == 2:
            keys = [k for k in fns if k != "plain"]
            cold = dict(zip(keys, cold_times([fns[k] for k in keys], args,
                                             flush)))
        cs.log("contract_times", kernel=name, shape=label,
               static=args[0].dim() == 2, ms=ms, cold_ms=cold,
               **cs.kernel_bound(name, args, want))


def check(device) -> None:
    _build.build("bmm64", "schur_wwt")
    for name in ("bmm64", "schur_wwt"):
        report = (_build.library_path(name).parent / "build.log").read_text()
        cs.log("ptxas", kernel=name, report=[
            ln for ln in report.splitlines() if "registers" in ln
            or "Compiling" in ln or "spill" in ln or "error" in ln][:40])
    rng = np.random.default_rng(0)
    for G, n in [(1, 8), (1, 4), (2, 7), (33, 9), (3, 17), (2, 24), (32, 65),
                 (1, 72), (2, 73), (8, 129), (3, 130), (1472, 10), (2, 200)]:
        A = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
        B = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
        for Bx in (B, B.float()):
            got, want = df32.bmm64(A, Bx), df32.bmm64_plain(A, Bx)
            again = df32.bmm64(A, Bx)
            torch.cuda.synchronize()
            rel = float((got - want).abs().max() / want.abs().max())
            cs.log("check", kernel="bmm64", G=G, n=n, b=str(Bx.dtype)[6:],
                   max_rel_err=rel, repeat_same=bool((got == again).all()))
            if not rel <= cs.DF32_TOL or not bool((got == again).all()):
                raise AssertionError(f"bmm64 ({G}, {n}) {Bx.dtype}: {rel}")
    for B, mp, F in [(1, 8, 64), (2, 16, 40), (2, 17, 101), (2, 35, 577),
                     (1, 80, 256), (2, 81, 258), (32, 66, 4290),
                     (3, 130, 1024), (2, 161, 515), (8, 130, 16770)]:
        W = rng.standard_normal((B, mp, F)).astype(np.float32)
        W *= np.exp(rng.uniform(-2, 2, (B, mp, 1))).astype(np.float32)
        W64 = W.astype(np.float64)
        ref = np.einsum("xif,xjf->xij", W64, W64)
        Wt = torch.as_tensor(W, device=device)
        got, want = kernels.schur_wwt(Wt), kernels.schur_wwt_plain(Wt)
        again = kernels.schur_wwt(Wt)
        torch.cuda.synchronize()
        scale = float(np.abs(ref).max())
        e_np = float(np.abs(got.double().cpu().numpy() - ref).max()) / scale
        e_pl = float((got - want).abs().max()) / scale
        p_np = float(np.abs(want.double().cpu().numpy() - ref).max()) / scale
        same = bool((got == again).all()) and bool((got == got.mT).all())
        cs.log("check", kernel="schur_wwt", B=B, mp=mp, F=F,
               chunks=kernels.gram_chunks(B, mp, F), rel_err_vs_numpy=e_np,
               rel_err_vs_plain=e_pl, plain_rel_err_vs_numpy=p_np,
               repeat_same_and_symmetric=same)
        if not (e_np <= 1e-5 and e_pl <= 1e-5 and same):
            raise AssertionError(f"schur_wwt ({B}, {mp}, {F}): {e_np} {e_pl}")


def variants(device) -> None:
    rng = np.random.default_rng(1)
    libs = {"rows=32": variant("bmm64", "r32", {"kFineWaves": 0}),
            "rows=16": variant("bmm64", "r16", {"kFineWaves": 99}),
            "bk=96": variant("bmm64", "bk96", {"kBK": 96}),
            "small_n=0": variant("bmm64", "sn0", {"kSmallN": 0})}
    for label, G, n in BMM_SHAPES:
        A = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
        B = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
        names = ["committed", *libs, "torch.matmul"]
        fns = [df32.bmm64, *(bmm_variant(v) for v in libs.values()),
               torch.matmul]
        want = df32.bmm64_plain(A, B)
        for k, f in zip(names, fns):
            rel = float((f(A, B) - want).abs().max() / want.abs().max())
            if not rel <= cs.DF32_TOL:
                raise AssertionError(f"bmm64 {k} {label}: {rel}")
        cs.log("variants", kernel="bmm64", shape=label, G=G, n=n,
               ms=dict(zip(names, cs.graph_times(fns, (A, B)))),
               f32_b_ms=cs.graph_times([df32.bmm64], (A, B.float()))[0])
    glibs = {"stages=4": variant("schur_wwt", "s4", {"kStages": 4}),
             "stages=2": variant("schur_wwt", "s2", {"kStages": 2}),
             "warp_cols=2": variant("schur_wwt", "wc2", {"kWarpCols": 2})}
    for label, B, mp, F in GRAM_SHAPES:
        W = torch.as_tensor(rng.standard_normal((B, mp, F)).astype(np.float32),
                            device=device)
        want = kernels.schur_wwt_plain(W)
        names = ["committed", *glibs, "torch.bmm"]
        fns = [kernels.schur_wwt, *(gram_variant(v) for v in glibs.values()),
               lambda W: torch.bmm(W, W.mT)]
        for k, f in zip(names, fns):
            rel = float((f(W) - want).abs().max() / want.abs().max())
            if not rel <= 1e-5:
                raise AssertionError(f"schur_wwt {k} {label}: {rel}")
        cs.log("variants", kernel="schur_wwt", shape=label,
               chunks=kernels.gram_chunks(B, mp, F),
               ms=dict(zip(names, cs.graph_times(fns, (W,)))))
        keep = kernels._GRAM_BLOCKS, kernels._GRAM_MIN_CHUNK
        split = {}
        for blocks in (132, 264, 528, 1056):
            for min_chunk in (128, 256, 512):
                kernels._GRAM_BLOCKS, kernels._GRAM_MIN_CHUNK = blocks, min_chunk
                chunks = kernels.gram_chunks(B, mp, F)
                if str(chunks) not in split:
                    split[str(chunks)] = cs.graph_times([kernels.schur_wwt],
                                                        (W,))[0]
        kernels._GRAM_BLOCKS, kernels._GRAM_MIN_CHUNK = keep
        cs.log("variants", kernel="schur_wwt", shape=label,
               ms_by_chunks=split)


def dissect(device) -> None:
    """Where the time goes, without a profiler: each kernel beside copies
    of itself with parts cut out (BMM_CUTS, GRAM_CUTS), in turns."""
    rng = np.random.default_rng(2)
    b = BMM_CUTS
    libs = {"whole": cut("bmm64", "whole"),
            "empty launch": cut("bmm64", "ret", b["return"]),
            "no copies": cut("bmm64", "nc", b["copies"]),
            "no products": cut("bmm64", "np", b["products"]),
            "no stores": cut("bmm64", "ns", b["stores"]),
            "no copies, no products": cut("bmm64", "ncp", b["copies"],
                                          b["products"]),
            "no copies, products, stores": cut(
                "bmm64", "ncps", b["copies"], b["products"], b["stores"])}
    for label, G, n in BMM_SHAPES[:2]:
        A = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
        B = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
        fns = [*(bmm_variant(v) for v in libs.values()), torch.matmul]
        cs.log("dissect", kernel="bmm64", shape=label, G=G, n=n, ms=dict(zip(
            [*libs, "torch.matmul"], cs.graph_times(fns, (A, B)))))
    g = GRAM_CUTS
    libs = {"whole": cut("schur_wwt", "whole"),
            "empty launch": cut("schur_wwt", "ret", g["return"]),
            "no copies": cut("schur_wwt", "nc", g["copies"]),
            "one product of three": cut("schur_wwt", "p1",
                                        g["two of three products"]),
            "no copies, one product": cut("schur_wwt", "ncp1", g["copies"],
                                          g["two of three products"])}
    for label, B, mp, F in GRAM_SHAPES:
        W = torch.as_tensor(rng.standard_normal((B, mp, F)).astype(np.float32),
                            device=device)
        fns = [*(gram_variant(v) for v in libs.values()),
               lambda W: torch.bmm(W, W.mT)]
        cs.log("dissect", kernel="schur_wwt", shape=label,
               chunks=kernels.gram_chunks(B, mp, F), ms=dict(zip(
                   [*libs, "torch.bmm"], cs.graph_times(fns, (W,)))))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.log("env", card=cs.card_line(), torch=torch.__version__)
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    parent = Path(sys.argv[3]).resolve() if len(sys.argv) > 3 else None
    if mode == "reference":   # the fused route on the CPU-reference case
        schur_reference(device)
        return 0
    if mode == "phases":
        cs.build_phase()
        if which == "tri":
            tri_times(device)
        elif which == "chol":
            tri_times(device, CHOL_TIMED)
        elif which == "schur":
            schur_times(device)
        elif which == "bucket":
            bucket_times(device)
        elif which == "cholinv":
            cholinv_times(device, parent)
        elif which == "contract":
            contract_times(device, parent)
        else:
            cs.df32_phase(device)
            cs.pallas_kernel_phase(device)
        return 0
    if which in ("all", "mma"):
        check(device)
        if mode == "variants":
            variants(device)
        if mode == "dissect":
            dissect(device)
    if which in ("all", "tri"):
        tri_check(device)
        if mode == "variants":
            tri_variants(device)
        if mode == "dissect":
            tri_dissect(device)
    if which in ("all", "chol"):
        chol_ops_check(device)
        tri_check(device, ("cholesky",))
        if mode == "variants":
            tri_variants(device, CHOL_TIMED)
        if mode == "dissect":
            tri_dissect(device, (("cholesky", CHOL2_CUTS, CHOL_TIMED),))
    if which in ("all", "schur"):
        if mode != "dissect":   # dissect also runs the parent's kernel
            schur_check(device)
        if mode == "variants":
            schur_variants(device)
        if mode == "dissect":
            schur_dissect(device)
    if which in ("all", "bucket"):
        if mode != "dissect":   # dissect also runs the parent's kernels
            bucket_check(device)
        if mode == "variants":
            bucket_variants(device)
        if mode == "dissect":
            bucket_dissect(device)
    if which in ("all", "contract"):
        if mode != "dissect":
            contract_check(device)
        if mode == "variants":
            contract_variants(device)
        if mode == "dissect":
            contract_dissect(device)
    if which in ("all", "cholinv"):
        tri_check(device, ("chol_inverse_lanes",))
        if mode == "variants":
            tri_variants(device, CHOLINV_TIMED)
        if mode == "dissect":
            cholinv_dissect(device, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
