#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scipsdp_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which raises (and so exits non-zero) when it fails:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; no CUDA device means exit 2 before any work.
2. build: the eleven kernels of ``scipsdp_tpu_torch/csrc`` with nvcc, one
   process per source, all started together.
3. kernel checks, each kernel against its plain PyTorch version on the
   same inputs, timed with CUDA events in turns after warm-up (median of
   REPS samples of LAUNCHES back-to-back calls: "eager" times, which
   include the host's launch cost; and as device time, the LAUNCHES calls
   replayed from one CUDA graph), beside the one PyTorch library call
   that computes the same function where there is one (``library_ms``;
   the port never calls it; for the df32 contractions the float64
   ``torch.einsum`` on operands made float64 outside the timing) and the
   least
   time the card could take for the work (``bound_ms``: bytes over 3.35
   TB/s or FLOPs over 67 TFLOP/s, whichever is larger; ``schur_wwt``'s
   three TF32 products per multiply-add over 495 TFLOP/s):
   ``cholesky_lanes`` at the probe shapes and an ill-conditioned cls_64
   stack (against its plain version and float64 numpy at rtol and atol
   2e-4, the bar of the JAX package's lanes-Cholesky test; exact zeros
   above the diagonal; a non-PD matrix NaNs its own factor only; two
   launches bit for bit) and at its pivot edges (a subnormal pivot NaNs
   its factor, a +inf one gives +inf and zeros below it); ``bmm64``, ``contract_short64`` and
   ``contract_long64`` at the refine tier's shapes for cls_32 B=32 (the
   main path), cls_64 B=8 and mkp_10 B=32, and on tests/test_df32.py's inputs (relative error at
   most 1e-11: max |kernel - plain| / max |plain|), ``bmm64`` also around
   its fragment edges (n = 7 ... 129, 1 and 33 matrices, float64 and
   float32 right operands; two launches bit for bit; the float32 operand
   must reach the kernel without an upcast op), the contractions' static
   paths (A(dy), A*(Psi)) also at cls_32 B=128 and at their tile edges
   (every (G, J, F) of CONTRACT_EDGE_*, float64 and float32 M, two
   launches bit for bit) and on two streams, and from two CUDA graphs,
   at once (CONTRACT_STREAM_CASES, bit for bit the launch alone), each
   static case's time against the float64 einsum in one line;
   ``rhs_bucket``,
   ``schur_solve_fused`` and ``recover_bucket`` at the same three shapes,
   tests/test_fused.py's and an odd F with one instance's rows all fixed,
   against their plain versions and against
   float64 numpy references (the exact solve of the live subsystem for
   the Schur solve) at tests/test_fused.py's bars (FUSED_BARS), two
   launches bit for bit; ``rhs_bucket`` and ``recover_bucket`` also at
   BUCKET_EDGES (n = 16 ... 145 around their kernels' shape choices, 33
   instances, a per-instance pad), checked only;
   ``cholesky``, ``tril_inverse``, ``schur_wwt`` and ``chol_inverse_lanes``
   at the float32 tiers' shapes for cls_32 B=32, cls_64 B=8 and mkp_10
   B=32, at tests/test_pallas.py's and tests/test_lanes_chol.py's shapes,
   at n = 300 (the device-memory path), ``tril_inverse`` and
   ``chol_inverse_lanes`` also on an ill-conditioned cls_64 stack (rows
   and columns scaled by e^U(-4, 4), as the IPM's factors are near the
   optimum; ``chol_inverse_lanes`` there no further from numpy than the
   ``cholesky`` -> ``tril_inverse`` kernel pair, whose times and the
   library pair's ``cholesky_ex`` -> ``solve_triangular`` are logged
   beside it at every shape), and ``schur_wwt`` around its panel
   and copy-width edges (mp = 16, 17, 80, 81; odd F, F % 4 == 0; the
   result symmetric), against their plain versions
   and float64 numpy references at those tests' bars (PALLAS_BARS), NaN
   per matrix (``cholesky``, ``chol_inverse_lanes``: on and below the
   whole diagonal, zeros above), two launches bit for bit.
4. float64 path: batched interior-point relaxation solves through
   ``ipm_solve`` with the device's resolved settings (phase32="off", probe
   step rule with the probe kernel): three requests of 32
   branch-and-bound node boxes on cls_32 (direct, Gamma=1 feasibility
   probe, Gamma=1e3 penalty solve) and one of 8 boxes on cls_64.  Each
   output is checked (every slot OPTIMAL, children bound no lower than the
   root, the root's dual point feasible by an independent numpy check)
   and held against the same solve through the plain probe.
   Then the recovery ladder (``core/sdpi.py``) at the default CUDA
   settings: cls_32/direct's 32 boxes through
   ``SDPInterface(dense, device="cuda").solve_batch(lb, ub,
   rounding_seed=0)`` (every slot OPTIMAL, objvals within 2 * gaptol of
   the float64 path's, the rounded points' flags as an independent numpy
   check says) and a rungs request whose last nine boxes the direct rung
   cannot decide (SDPI_SLOTS: infeasible, at and just below the
   feasibility edge, unbounded; two with every z fixed): each slot ends
   as its kind allows, and the rung that decided it (direct, probe,
   penalty, bound, box, verify) is logged.  Then, in turns
   (SDPI_ROUNDS), the ladder against direct ``ipm_solve``, cold against
   warm-started children (from the root's y and X: the same statuses,
   objvals within 2 * gaptol) and the rungs request; one profiled
   solve_batch of each but the rungs request (device busy, launches,
   host syncs); and a small
   CLS instance with the same kinds of boxes through the ladder on the
   card and on the CPU (equal statuses, objvals within 2 * gaptol).
   Then the host branch-and-bound loop (``core/branchbound.py::
   solve_misdp`` with ``bb.turbo="off"``, the bb path): a small CLS (10
   features) solved on the card and on the CPU
   (the same status, objectives within 1e-4 relative; both node counts
   logged), then ``bench_families.py``'s cls_32 at B=32, otherwise default
   settings and its node cap of 4000 on the card: OPTIMAL, the objective within
   1e-4 relative of the optimum BENCH_FAM_CLS32.json records for the JAX
   package (BB_OPTIMUM), the incumbent feasible by an independent numpy
   check (each block's smallest eigenvalue, the LP rows, the bounds and
   integrality within the settings' feastol), the probe kernel launched;
   nodes, batches, IPM iterations, wall, the time inside ``solve_batch``,
   nodes/s, the node store (native or Python heap) are logged, and one
   profiled run of the same solve gives device busy time and host syncs
   per batch.
   Then the device-resident tree (``core/turbo.py``, the turbo path):
   the small CLS with ``bb.turbo="on"`` on the card and on the CPU (the
   same status and optimum within 1e-4 relative), then cls_32 at B=32 at
   default settings ("auto" engages turbo at once on the card): a spy
   shows that ``solve_turbo`` ran and did not bail; OPTIMAL at the same
   optimum, the incumbent feasible, #1 launched in the IPM and in
   ``psd_feasible``; nodes, rounds, the widths of the batch ramp, IPM
   iterations, solver calls, heuristic incumbents, wall and nodes/s
   beside the host loop's tree; a profiled run for device busy time and
   the host syncs by kind (at most 3 of ``core/turbo.py``'s own a round
   and one a chunk, and no per-round read at any other of its lines);
   ``min_k_partition(12, 3, 0.6, seed=1)`` at B=8 through
   ``solve_turbo`` (no bail, optimum 30.0 within 1e-4 relative; rung
   solves logged); and #1 against its plain version on every candidate
   point ``psd_feasible`` saw in the cls_32 tree (the same NaN flag per
   matrix; a mismatch is logged with its lambda_min and fails).
5. refine path: the same four requests with phase32="refine" (the
   non-fused direction, probe rule, probe kernel): every request must
   launch the probe kernel and the three df32 kernels.  A direct request
   must match the float64 tier's statuses and bounds (2 * gaptol), pass
   the same checks, and agree with the same request through the plain
   df32 versions (use_df32="off").  The probe and penalty requests may
   leave slots FAILED, as the JAX package's refine tier does; those are
   counted, and their OPTIMAL slots must hold to both references' bounds.
6. fused path: the same four requests with the fused direction
   (fused_direction="on"): every request must launch the three fused
   kernels, the probe kernel and ``bmm64``; the other kernels it launches
   are logged.  A direct request must be all OPTIMAL, pass the same
   checks, and match the non-fused refine path's statuses and both it and
   the float64 tier in bounds (2 * gaptol); the probe and penalty requests
   count their FAILED slots.
7. pallas paths: the same four requests through the float32 tier
   (phase32="on") and the fused refine tier, both with use_pallas=True:
   every request must launch ``cholesky``, ``tril_inverse`` and
   ``schur_wwt`` and the probe kernel, the refine route also ``bmm64`` and
   the three fused kernels.  A direct request must be all OPTIMAL, pass
   the checks, match the same route with use_pallas=False in statuses
   (iterations within 2) and both it and the float64 tier in bounds
   (2 * gaptol); the probe and penalty requests count their FAILED slots.
   phase32="lite" runs once, on cls_32/direct, and may FAIL slots.
8. TF32 check: cls_32/direct through both pallas routes with the caller's
   ``allow_tf32`` on must equal the solve with it off (statuses,
   iterations, dobj) and leave the flag on.
9. timing: per request the four routes — refine with the fused direction,
   refine with the df32 kernels, refine with their plain versions, the
   float64 tier — in turns (ROUTE_ROUNDS rounds); on the direct requests
   the pallas routes, the float32 tier on library factors, the fused
   refine tier and the float64 tier in turns (PALLAS_ROUNDS); then the
   float64 path's probe kernel against the plain probe.
10. card against CPU: a small CLS instance, float64 tier, refine tier
   (non-fused and fused) and the on_pallas route.
11. profile: per request and route one torch.profiler pass (device busy
   time, kernel launches in all and per iteration, the ops with the most
   device time) and the host syncs of one solve by source line (CUDA sync
   debug mode); the fused refine route on every request, the others on
   the direct requests only (the profiles take a third of the run).
12. probing path (``core/probing.py``) on cls_32: each function on the
   card with its wall, batched solves, #1 launches and host syncs (one
   call, in CUDA sync debug mode), held to the same call on the CPU with
   the card's IPM settings on the same inputs: ``slater_check`` and
   ``analytic_center`` on the root box and PROBE_BOXES request boxes
   (flags equal; every center feasible by ``check_points``),
   ``obbt_root`` over the binaries and, with the optimum as a cutoff row,
   over the continuous variables (the same count of tightenings, bounds
   within 1e-6), ``fracdive`` on boxes that leave DIVE_FREE binaries free
   (flags equal, at least one point found, each feasible), the inner-LP
   heuristic as the root calls it and from the root's k largest z (ok
   flags equal, a feasible point within 1e-3 of the CPU's) and the
   rounding problems from the root's X and y (the same action).  Then
   two trees through ``solve_misdp``: the root options (inner-LP
   heuristic, OBBT, analytic-center warm starts) at "auto": turbo
   engages without a bail, OPTIMAL at BB_OPTIMUM within 1e-4 relative,
   the incumbent feasible and inside the OBBT bounds, the probing's
   share of the wall; and the in-tree options (Slater
   statistics, diving, OBBT, rounding-problem warm starts) in the host
   loop under PROBE_TREE_CAP nodes: the bound at most the optimum, any
   incumbent feasible, the Slater, rounding and heuristic counters.
13. LP path (``solve_sdps=0``): ``separate_eigenvector_cuts`` at cls_32's
   root LP point on the card against the CPU (valid flags equal,
   eigenvalues within 1e-9 (1 + |lam|), each valid cut within 1e-7
   relative, a repeated eigenvalue's cuts as their eigenspace sum),
   both timed, and batched float64 ``eigh`` at n = 65 for 1 and 32
   matrices; then cls_32 at B=32 (node cap 4000, LP_TIME_LIMIT) to
   OPTIMAL at BB_OPTIMUM (or a bound at most the optimum and a feasible
   incumbent) and mkp_12 at B=8 to 30.0: nodes, LP rounds, separation
   rounds, cuts, exact enforcement solves and their #1 launches, and the
   walls of HiGHS, the separation and the rest.
14. cli path (the file entry points): cls_32 and cls_64 written by the
   port's writers as .dat-s, .dat-s.gz, .cbf and .cip and read back
   with ``read_problem`` (bytes and read ms of each file; the plain
   .dat-s through the native tokenizer only, its problem equal to the
   Python parser's, which is timed beside it); ``python -m
   scipsdp_tpu_torch`` in process on the cls_32 .dat-s, .cbf and .cip
   files at B=32 (OPTIMAL at BB_OPTIMUM within 1e-4 relative, the
   incumbent feasible; wall, nodes, rounds, #1 launches, the .dat-s
   run's host syncs, beside the turbo phase's tree), ``--settings``
   (every loaded field as the .set file says, the optimum), ``--slater
   --write-transformed`` on the card and on the CPU (the same lines and
   file; the file reads back with the generated rows), mkp_12
   ``--lp-approx`` to 30.0, cls_64's root; two subprocesses: cls_32 to
   its optimum, and with ``--mesh`` (one card: no mesh) to the same.
15. mesh path (``parallel/mesh.py``) on virtual meshes of 2 and 4 cuda:0
   entries (so it measures the lockstep's cost, not multi-card scaling):
   cls_32/direct (B=32) through ``sharded_solver`` against the unsharded
   ``ipm_solve`` of the same call, float64 (equal statuses, iterations
   and float64 iterations, dobj within 1e-9 relative) and the fused
   refine route (equal statuses, iterations within 3, dobj within 5e-6);
   each solve's flag reads counted in CUDA sync debug mode (one a
   iteration, plus the last), its walls, #1 launches and host syncs
   logged.  Then cls_32 at B=32 through ``solve_misdp(use_mesh=True,
   mesh_devices=n)`` with the solver's mesh made a virtual one: the host
   loop (``SDPInterface(mesh=...)``'s ladder) and turbo
   (``solve_turbo(mesh=...)``, width B), OPTIMAL at BB_OPTIMUM, feasible
   incumbents; nodes, rounds, wall, #1 beside the unsharded trees.  Then
   the blocks axis over distinct devices: truss_topology(128, 4, seed=1)
   (one bucket of four 65 x 65 blocks, split 2 + 2) at B=8 through
   ``sharded_solver`` on the mixed row ["cuda:0", "cpu"] beside the same
   split on ["cuda:0", "cuda:0"], float64 (equal statuses and
   iterations, dobj within 1e-9) and fused refine (equal statuses,
   iterations within 3, dobj within 5e-6): one flag read an iteration,
   the bytes moved between the devices an iteration and the host syncs
   logged, the card's kernels launched for the card's half only (the CPU
   half on their plain versions); a host-loop and a turbo tree on the
   truss with the solver's mesh made the mixed row, under a node cap,
   with the unsharded trees' incumbent objective, nodes and dual bound;
   on two or more cards the row ["cuda:0", "cuda:1"] at B=32 (else a line
   says it did not run).  Then the card as it is: ``use_mesh=True`` on
   one card builds no mesh, and ``mesh_devices=2`` raises ValueError
   before any launch.
16. multihost path (``parallel/multihost.py``): two processes on the card
   join a gloo group and solve with ``solve_misdp_distributed`` under a
   deadline: tests/test_multihost.py's steal instance to -2.3 in both
   (nodes stolen and donated), cls_32 at B=32 to BB_OPTIMUM in both;
   each process's wall, nodes, collectives and #1 beside the
   single-process host loop's tree.

The kernel launch counters are set to 0 just before each path (float64,
sdpi, bb, turbo, refine, fused, on_pallas, refine_pallas, lite_pallas,
probing, lpmode, cli, mesh) and read just after (the mesh path counts its
sharded runs only; the multihost path sums the two processes' counters,
each from 0).  The line before the
last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  Float32 matmuls run in full float32
(TF32 off for matmul and cuDNN) except inside the TF32 check.  The whole
run takes about 11 minutes on an H100, the build included.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gzip
import io
import json
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from scipsdp_tpu_torch import _build, native
from scipsdp_tpu_torch.__main__ import main as cli_main
from scipsdp_tpu_torch.core import branchbound as bb_module
from scipsdp_tpu_torch.core import probing
from scipsdp_tpu_torch.core import sdpi as sdpi_module
from scipsdp_tpu_torch.core import turbo
from scipsdp_tpu_torch.core.branchbound import solve_misdp
from scipsdp_tpu_torch.core.feascheck import check_points
from scipsdp_tpu_torch.core.presolve_sdp import presolve_problem
from scipsdp_tpu_torch.core.sdpi import SDPInterface
from scipsdp_tpu_torch.models import reader_sdpa
from scipsdp_tpu_torch.models.families import (cardinality_least_squares,
                                               min_k_partition,
                                               truss_topology)
from scipsdp_tpu_torch.models.io import read_problem
from scipsdp_tpu_torch.models.problem import MISDP, densify
from scipsdp_tpu_torch.models.writers import (transformed_for_write,
                                              write_cbf, write_cip,
                                              write_sdpa)
from scipsdp_tpu_torch.native.frontier import FrontierStore
from scipsdp_tpu_torch.ops import df32, fused, kernels
from scipsdp_tpu_torch.ops.cuts import separate_eigenvector_cuts
from scipsdp_tpu_torch.ops import ipm as ipm_module
from scipsdp_tpu_torch.ops.ipm import build_ipm_data, ipm_solve
from scipsdp_tpu_torch.parallel import mesh as mesh_module
from scipsdp_tpu_torch.parallel.mesh import make_mesh, sharded_solver
from scipsdp_tpu_torch.utils.config import (BBSettings, IPMSettings,
                                            Settings, resolve_backend_autos)
from scipsdp_tpu_torch.utils.status import SolverResultStatus

KERNELS = {   # name -> (wrapper, TPU kernel it replaces)
    "cholesky_lanes": (kernels.cholesky_lanes,
                       "scipsdp_tpu/ops/pallas_kernels.py:337"),
    "bmm64": (df32.bmm64, "scipsdp_tpu/ops/df32.py:151"),
    "contract_short64": (df32.contract_short64,
                         "scipsdp_tpu/ops/df32.py:275"),
    "contract_long64": (df32.contract_long64, "scipsdp_tpu/ops/df32.py:345"),
    "rhs_bucket": (fused.rhs_bucket, "scipsdp_tpu/ops/fused.py:228"),
    "schur_solve_fused": (fused.schur_solve_fused,
                          "scipsdp_tpu/ops/fused.py:304"),
    "recover_bucket": (fused.recover_bucket, "scipsdp_tpu/ops/fused.py:381"),
    "cholesky": (kernels.cholesky, "scipsdp_tpu/ops/pallas_kernels.py:142"),
    "tril_inverse": (kernels.tril_inverse,
                     "scipsdp_tpu/ops/pallas_kernels.py:154"),
    "schur_wwt": (kernels.schur_wwt, "scipsdp_tpu/ops/pallas_kernels.py:168"),
    "chol_inverse_lanes": (kernels.chol_inverse_lanes,
                           "scipsdp_tpu/ops/pallas_kernels.py:353"),
}
PLAIN = {"cholesky_lanes": kernels.cholesky_lanes_plain,
         "bmm64": df32.bmm64_plain,
         "contract_short64": df32.contract_short64_plain,
         "contract_long64": df32.contract_long64_plain,
         "rhs_bucket": fused.rhs_bucket_plain,
         "schur_solve_fused": fused.schur_solve_fused_plain,
         "recover_bucket": fused.recover_bucket_plain,
         "cholesky": kernels.cholesky_plain,
         "tril_inverse": kernels.tril_inverse_plain,
         "schur_wwt": kernels.schur_wwt_plain,
         "chol_inverse_lanes": kernels.chol_inverse_lanes_plain}
DF32 = ("bmm64", "contract_short64", "contract_long64")
FUSED = ("rhs_bucket", "schur_solve_fused", "recover_bucket")
PALLAS = ("cholesky", "tril_inverse", "schur_wwt")     # the solver's three
# the per-matrix float32 kernels' cases: (label, leading shape, n, s); the
# X/S stack (B slots x 2 blocks) and the Schur factor (B, mp, mp) of the
# float32 tiers at cls_32 B=32 (the main path), cls_64 B=8 and mkp_10 B=32,
# then tests/test_pallas.py's and tests/test_lanes_chol.py's shapes, then n =
# 300 (device memory); s > 0 scales the rows and columns of the positive
# definite matrix (so the rows of its factor) by e^U(-s, s), an IPM-like
# ill-conditioned factor
TRI_SHAPES = [("cls_32 B=32 X/S", (32, 2), 65, 0),
              ("cls_32 B=32 Schur", (32,), 66, 0),
              ("cls_64 B=8 X/S", (8, 2), 129, 0), ("cls_64 B=8 Schur", (8,), 130, 0),
              ("cls_64 B=8 X/S ill-conditioned", (8, 2), 129, 4),
              ("mkp_10 B=32 X/S", (32, 2), 10, 0),
              ("mkp_10 B=32 Schur", (32,), 46, 0),
              ("test_pallas", (4,), 20, 0), ("test_pallas", (2,), 48, 0),
              ("test_pallas", (1,), 96, 0), ("test_pallas", (1,), 128, 0),
              ("test_lanes_chol", (20,), 43, 0), ("test_lanes_chol", (3, 4), 9, 0),
              ("device memory", (4,), 300, 0)]
# the Schur Gram's cases: (label, B, mp, F = K n^2 + LP rows)
GRAM_SHAPES = [("cls_32 B=32", 32, 66, 4290), ("cls_64 B=8", 8, 130, 16770),
               ("mkp_10 B=32", 32, 46, 101), ("test_pallas", 2, 35, 577),
               ("test_pallas", 1, 8, 64), ("test_pallas", 3, 130, 1024),
               ("test_pallas F-chunk", 1, 16, 1024),
               # one and two row panels, 4-, 8- and 16-byte copies
               ("edge mp=16 odd F", 2, 16, 101), ("edge mp=17 F%4=0", 2, 17, 256),
               ("edge mp=80 odd F", 1, 80, 515), ("edge mp=81 F%4=0", 2, 81, 1028)]
# bmm64 around the 16 x 8 x 16 fragment and the 72-column tile: n, for 1
# and 33 matrices each, float64 and float32 right operands
BMM_EDGE_N = (7, 8, 9, 17, 64, 65, 72, 73, 129)
BMM_EDGE_G = (1, 33)
PALLAS_MAIN = {"cholesky": "cls_32 B=32 X/S", "tril_inverse": "cls_32 B=32 X/S",
               "chol_inverse_lanes": "cls_32 B=32 X/S",
               "schur_wwt": "cls_32 B=32"}
# tests/test_pallas.py's and tests/test_lanes_chol.py's bars: relative to
# max |reference| (cholesky, tril_inverse, schur_wwt), or (rtol, atol)
PALLAS_BARS = {"cholesky": 1e-4, "tril_inverse": 1e-4, "schur_wwt": 1e-5,
               "chol_inverse_lanes": (3e-3, 3e-3),
               "cholesky_lanes": (2e-4, 2e-4)}
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, FLOP/s of
# float32 outside the tensor cores and of float64 on them (both 67 T), and
# of TF32 on the tensor cores; the bound of a call is the larger of its
# bytes and its FLOPs over these.  schur_wwt computes each multiply-add of
# the lower triangle as three TF32 products (a hi/lo split), so its FLOPs
# count three times, over the TF32 peak
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# (leading shape, n, s) of the matrix stacks cholesky_lanes is checked and
# timed at (s as in TRI_SHAPES); (32, 10) and (8, 10) are the stacked probe
# ladders of the main path (B slots x 2*5 trials) at cls_32 B=32 and cls_64
# B=8, (14720,) x 10 mkp_10's at B=1472; (1, 10) x 1 the B = 1 solves of a
# block-free LP (the inner-LP and rounding LPs: one 1 x 1 dummy bucket),
# (1, 10) x 65 cls_32's B = 1 solves (primal Slater, LP mode's exact
# enforcement); (16, 10) and (8, 10) x 65 the ladders of one shard of
# cls_32 B=32 over a mesh of 2 and of 4, (32, 1) x 65 turbo's psd_feasible
# at the mesh's fixed width 32, (2, 10) x 1 the ladders of the
# multi-process steal instance (B = 2, one 1 x 1 block); (8, 20) x 65 the
# ladder of one half of the truss_128 bucket at B = 8 (2 blocks x 10
# trials), (32, 20) the same at B = 32 on two cards, (8, 40) the unsplit
# bucket's in the truss trees, (8, 4) turbo's psd_feasible there
CHOL_SHAPES = [((3,), 5, 0), ((16,), 43, 0), ((130,), 17, 0), ((1,), 64, 0),
               ((384,), 65, 0), ((32, 10), 65, 0), ((320,), 97, 0),
               ((320,), 129, 0), ((8, 10), 129, 0), ((8, 2), 129, 4),
               ((14720,), 10, 0), ((4,), 300, 0), ((1, 10), 1, 0),
               ((1, 10), 65, 0), ((16, 10), 65, 0), ((8, 10), 65, 0),
               ((32, 1), 65, 0), ((2, 10), 1, 0), ((8, 20), 65, 0),
               ((32, 20), 65, 0), ((8, 40), 65, 0), ((8, 4), 65, 0)]
CHOL_MAIN = ((32, 10), 65, 0)
DF32_TOL = 1e-11
# the refine tier's shapes per instance: (label, mp, K n^2, LP rows P, B,
# K, n); cls_32 B=32 is the main path, B=16 and B=8 one shard of it over
# a mesh of 2 and of 4; truss_128 B=8 half one half of its bucket split
# over a mesh row (the per-bucket products), truss_128 B=8 the whole
# bucket (the W features gathered at home: F = 4 n^2 + 1); cls_32 B=128,
# the width of the planned benchmark, only for the static contractions
# A(dy) and A*(Psi) (DF32_STATIC_ONLY)
DF32_SHAPES = [("cls_32 B=32", 66, 4225, 65, 32, 1, 65),
               ("cls_32 B=16", 66, 4225, 65, 16, 1, 65),
               ("cls_32 B=8", 66, 4225, 65, 8, 1, 65),
               ("truss_128 B=8 half", 129, 8450, 1, 8, 2, 65),
               ("truss_128 B=8", 129, 16900, 1, 8, 4, 65),
               ("cls_64 B=8", 130, 16641, 129, 8, 1, 129),
               ("mkp_10 B=32", 46, 100, 1, 32, 1, 10),
               ("cls_32 B=128", 66, 4225, 65, 128, 1, 65)]
DF32_STATIC_ONLY = ("cls_32 B=128",)
# the static contractions' tile edges (ops/df32.py::contract_plan:
# 8-instance fragments, 16-row panels and slices, the short kernel's
# staged pieces of 144 rows of j, the long one's F chunks), every (G, J,
# F) of them, float64 and float32 M, checked and not timed
CONTRACT_EDGE_G = (1, 3, 17, 33, 128)
CONTRACT_EDGE_J = (1, 16, 17, 46, 130, 145)
CONTRACT_EDGE_F = (1, 100, 4225, 16641)
# the static contractions launched on two streams at once (and replayed
# from two CUDA graphs at once): DF32_SHAPES labels, launches a stream
CONTRACT_STREAM_CASES = ("cls_32 B=32", "cls_64 B=8")
CONTRACT_STREAM_LAUNCHES = 20
DF32_MAIN = {"bmm64": "cls_32 B=32 X Rp",
             "contract_short64": "cls_32 B=32 W^T v",
             "contract_long64": "cls_32 B=32 W u"}
# the fused kernels' shapes: (label, B, K, n, mp, F = K n^2 + LP rows,
# padded, fixed0); the first six are DF32_SHAPES' (truss_128 B=8 half:
# the half bucket's K = 2, the Schur solve's F of the whole), then
# tests/test_fused.py's inputs, then two short-F cases, then an odd F
# (no cluster size cuts it into whole slices; 4-byte copies); a padded
# case zeroes the last 3 rows and columns of its last block, a fixed0 case
# fixes every row of instance 0 (the Schur solve returns 0 there)
FUSED_SHAPES = [("cls_32 B=32", 32, 1, 65, 66, 4290, False, False),
                ("cls_32 B=16", 16, 1, 65, 66, 4290, False, False),
                ("cls_32 B=8", 8, 1, 65, 66, 4290, False, False),
                ("truss_128 B=8 half", 8, 2, 65, 129, 16901, False, False),
                ("cls_64 B=8", 8, 1, 129, 130, 16770, False, False),
                ("mkp_10 B=32", 32, 1, 10, 46, 101, True, False),
                ("test_fused", 4, 2, 13, 9, 37, True, False),
                ("F=420", 8, 1, 20, 30, 420, True, False),
                ("F=700", 8, 1, 26, 40, 700, False, False),
                ("F=4097 instance 0 fixed", 4, 1, 20, 66, 4097, False, True)]
FUSED_MAIN = "cls_32 B=32"
# rhs_bucket's and recover_bucket's edge cases, checked and not timed:
# (label, B, K, n, mp, pad) around their kernels' shape choices (the
# staged tensor-core panels up to n = 144 in 16-row panels of 8-column
# fragments, k padded to 16; the row panels above), the contraction's
# 32-row passes (B = 33) and a per-instance (B, K, n, n) pad
# ("instance": each instance zeroes its own trailing rows and columns of
# its last block; "shared": one (1, K, n, n) pad, the last block 3 smaller)
BUCKET_EDGES = [("edge n=16", 3, 2, 16, 9, "shared"),
                ("edge n=17", 3, 2, 17, 11, "none"),
                ("edge n=64", 2, 2, 64, 20, "shared"),
                ("edge n=65 per-instance pad", 3, 2, 65, 66, "instance"),
                ("edge n=72", 2, 2, 72, 17, "none"),
                ("edge n=73", 2, 2, 73, 25, "instance"),
                ("edge n=129", 2, 2, 129, 30, "shared"),
                ("edge n=143", 2, 2, 143, 9, "none"),
                ("edge n=145", 2, 2, 145, 9, "instance"),
                ("edge B=33 n=13", 33, 2, 13, 40, "instance"),
                ("edge B=33 n=33", 33, 2, 33, 19, "shared")]
NREFINE = 3          # the settings' schur_refine
# tests/test_fused.py's bars, each times max(floor, max |reference|), for
# the kernel against its plain version and against the numpy reference
FUSED_BARS = {"rhs_bucket": [(1e-12, 0.0)],
              "schur_solve_fused": [(1e-10, 0.0)],
              "recover_bucket": [(1e-12, 1.0), (1e-11, 1.0)]}
GAMMA = 1e3
REPS = 25
LAUNCHES = 10
PROBE_PAIRS = 3      # float64 path: probe kernel vs plain probe
ROUTE_ROUNDS = 5     # the refine routes and float64, in turns
PALLAS_ROUNDS = 5    # the pallas routes, their twins and float64


T0 = time.perf_counter()


def log(tag: str, **kw) -> None:
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": tag, "t": round(time.perf_counter() - T0, 1),
                      **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def counts() -> dict:
    return {k: w.launches for k, (w, _) in KERNELS.items()}


def reset_counts() -> None:
    for w, _ in KERNELS.values():
        w.launches = 0
        if hasattr(w, "static_launches"):
            w.static_launches = 0


def static_counts() -> dict:
    """The two contractions' launches with a static M (A(dy), A*(Psi)),
    counted where they launch, beside ``counts()``, which takes in their
    per-instance launches too (W^T v; W u, G dy, G^T w)."""
    return {k: w.static_launches for k, (w, _) in KERNELS.items()
            if hasattr(w, "static_launches")}


def spd_stack(rng, N: int, n: int, s: float = 0) -> np.ndarray:
    """tests/test_lanes_chol.py's positive definite stack a a^T + n I; with
    s > 0 its rows and columns scaled by e^U(-s, s)."""
    a = rng.standard_normal((N, n, n))
    A = np.einsum("bij,bkj->bik", a, a) + n * np.eye(n)
    if s:
        d = np.exp(rng.uniform(-s, s, (N, n)))
        A = d[:, :, None] * A * d[:, None, :]
    return A


def work_flops(name: str, args) -> float:
    """FLOPs of one call of kernel ``name`` on ``args`` (2 per
    multiply-add; the triangular factorizations and inverses n^3/3 each)."""
    if name in ("cholesky_lanes", "cholesky", "tril_inverse",
                "chol_inverse_lanes"):
        n = args[0].shape[-1]
        per = 2 if name == "chol_inverse_lanes" else 1
        return per * args[0].numel() * n / 3
    if name == "schur_wwt":
        mp, F = args[0].shape[-2:]
        return args[0].numel() // (mp * F) * mp * (mp + 1) * F
    if name == "bmm64":
        return 2 * args[0].numel() * args[0].shape[-1]
    if name in ("contract_short64", "contract_long64"):
        J, F = args[0].shape[-2:]
        return 2 * args[1].shape[0] * J * F
    if name == "rhs_bucket":
        A, Rc = args[0], args[1]
        B, K, n = Rc.shape[0], A.shape[0], A.shape[-1]
        return 2 * B * K * n**3 + 2 * B * A.shape[1] * K * n * n
    if name == "schur_solve_fused":
        B, mp, F = args[0].shape
        nrefine = args[7]
        return (nrefine + 1) * 2 * B * mp * mp + nrefine * 4 * B * mp * F
    if name == "recover_bucket":
        A, dy = args[0], args[1]
        B, K, n = dy.shape[0], A.shape[0], A.shape[-1]
        return 2 * B * A.shape[1] * K * n * n + 4 * B * K * n**3
    raise KeyError(name)


# the kernels that read only the lower triangle of their (..., n, n) input
LOWER_READERS = ("cholesky_lanes", "cholesky", "tril_inverse",
                 "chol_inverse_lanes")


def kernel_bound(name: str, args, out) -> dict:
    """The least time the card could take for one call of kernel ``name``
    on ``args`` giving ``out``: its bytes (each input tensor read once, of
    a LOWER_READERS input n(n+1)/2 floats a matrix; each output written
    once) over the memory rate, or its FLOPs over the peak rate of their
    type, whichever is larger."""
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if isinstance(t, torch.Tensor))
    if name in LOWER_READERS:
        n = args[0].shape[-1]
        nbytes -= args[0].numel() // n * (n - 1) // 2 * args[0].element_size()
    tb, tf = nbytes / PEAK_BYTES, work_flops(name, args) / PEAK_FLOPS
    if name == "schur_wwt":
        tf = 3 * work_flops(name, args) / PEAK_TF32_FLOPS
    return {"bound_ms": 1e3 * max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations"}


def event_ms(fn, args) -> float:
    """Device time per call over LAUNCHES back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def graph_times(fns, args) -> list:
    """Device ms per call of each of ``fns``: LAUNCHES calls of each
    captured in one CUDA graph, the graphs replayed in turns (median of
    REPS replays), so no host launch cost enters."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up before capture
        for _ in range(2):
            for f in fns:
                f(*args)
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for f in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(LAUNCHES):
                f(*args)
        graphs.append(g)
    times = tuple([] for _ in fns)
    for _ in range(REPS):
        for g, acc in zip(graphs, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end) / LAUNCHES)
    return [float(np.median(t)) for t in times]


def eager_times(fns, args) -> list:
    """Median ms of each of ``fns`` on ``args``, measured in turns."""
    for _ in range(3):
        for f in fns:
            f(*args)
    times = tuple([] for _ in fns)
    for _ in range(REPS):
        for f, acc in zip(fns, times):
            acc.append(event_ms(f, args))
    return [float(np.median(t)) for t in times]


def build_phase() -> float:
    t0 = time.perf_counter()
    _build.build(*KERNELS)
    seconds = time.perf_counter() - t0
    log("build", seconds=seconds, kernels=list(KERNELS),
        logs={k: (_build.library_path(k).parent / "build.log")
              .read_text()[-1500:] for k in KERNELS})
    return seconds


def cholesky_phase(device) -> dict:
    """Check cholesky_lanes against its plain version and float64 numpy
    (``pallas_check``: bars, zeros above the diagonal, NaN per matrix, two
    launches bit for bit) and time it beside them and
    ``torch.linalg.cholesky_ex``, as device time (CUDA graphs) and eager."""
    rng = np.random.default_rng(0)
    worst, main = 0.0, None
    for lead, n, scale in CHOL_SHAPES:
        N = int(np.prod(lead))
        A32 = spd_stack(rng, N, n, scale).astype(np.float32)
        A = torch.as_tensor(A32.reshape(lead + (n, n)), device=device)
        ref = np.linalg.cholesky(A32.astype(np.float64)).reshape(A.shape)
        label = f"{list(lead)} x {n}" + (" ill-conditioned" if scale else "")
        L, err, err_ref = pallas_check("cholesky_lanes", label, (A,), ref,
                                       N // 2)
        fns = [kernels.cholesky_lanes, kernels.cholesky_lanes_plain,
               torch.linalg.cholesky_ex]
        t, tp, tl = graph_times(fns, (A,))
        te, tpe, tle = eager_times(fns, (A,))
        entry = {"max_abs_err": err, "max_abs_err_vs_numpy": err_ref,
                 "ms": t, "plain_ms": tp, "library_ms": tl, "eager_ms": te,
                 "plain_eager_ms": tpe, "library_eager_ms": tle,
                 **kernel_bound("cholesky_lanes", (A,), L)}
        log("kernel", name="cholesky_lanes", shape=list(lead) + [n, n],
            scale=scale, nan_own_matrix_only=True, repeat_bit_for_bit=True,
            **entry)
        worst = max(worst, err)
        if (lead, n, scale) == CHOL_MAIN:
            main = entry
    for n in (10, 65, 300):
        log("kernel", name="cholesky_lanes", n=n,
            pivot_edges=pivot_edges(device, n))
    return {**main, "max_abs_err": worst}


def pivot_edges(device, n: int) -> dict:
    """cholesky_lanes on pivots that are no positive normal float, beside
    a clean matrix S (spd_stack): S with its first pivot subnormal (read as
    zero, as the JAX kernel does where subnormals flush: NaN in that factor
    only) and with it +inf (+inf on the diagonal, zeros below it, the rest
    the factor of S[1:, 1:]: sqrt, then divide).  Raises on a mismatch;
    returns the errors from the plain version."""
    S = torch.as_tensor(spd_stack(np.random.default_rng(3), 1, n)[0],
                        dtype=torch.float32, device=device)
    A = S.repeat(3, 1, 1)
    A[0, 0, 0] = 1e-40
    A[1, 0, 0] = float("inf")
    L = kernels.cholesky_lanes(A)
    torch.cuda.synchronize()
    nan = torch.isnan(L).flatten(1).any(1).tolist()
    if nan != [True, False, False]:
        raise AssertionError(f"cholesky_lanes pivot edges n={n}: NaN {nan}")
    if not (L[1, 0, 0] == float("inf") and bool((L[1, 1:, 0] == 0).all())):
        raise AssertionError(f"cholesky_lanes +inf pivot n={n}: column 0 "
                             f"{L[1, :4, 0].tolist()}")
    rest = kernels.cholesky_lanes_plain(S[1:, 1:])
    clean = kernels.cholesky_lanes_plain(S)
    torch.testing.assert_close(L[1, 1:, 1:], rest, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(L[2], clean, rtol=2e-4, atol=2e-4)
    return {"inf_pivot_err": float((L[1, 1:, 1:] - rest).abs().max()),
            "clean_err": float((L[2] - clean).abs().max()),
            "nan_per_matrix": nan}


def df32_cases(device):
    """(kernel, label, args) at the refine tier's shapes, and
    tests/test_df32.py's inputs (badly scaled products, the X S
    near-central-path cancellation)."""
    rng = np.random.default_rng(1)

    def t(x, dt=torch.float64):
        return torch.as_tensor(x, dtype=dt, device=device)

    def normal(*shape):
        return rng.standard_normal(shape)

    cases = []
    for label, mp, F, P, B, K, n in DF32_SHAPES:
        blk = (B, K, n, n)
        if label in DF32_STATIC_ONLY:
            A_flat, dy = t(normal(mp, F)), t(normal(B, mp))
            cases += [
                ("contract_short64", f"{label} A(dy)", (A_flat, dy)),
                ("contract_long64", f"{label} A*(Psi)",
                 (A_flat, t(normal(B, F))))]
            continue
        X = t(normal(*blk))
        cases.append(("bmm64", f"{label} X Rp", (X, t(normal(*blk)))))
        # (Rc - X Rp) S^-1 with the float32-valued S^-1
        cases.append(("bmm64", f"{label} Psi S^-1",
                      (X, t(normal(*blk), torch.float32))))
        A_flat = t(normal(mp, F))
        Wall = t(normal(B, mp, F + P), torch.float32)
        Gall = t(normal(B, P, mp))
        dy = t(normal(B, mp))
        cases += [
            ("contract_short64", f"{label} A(dy)", (A_flat, dy)),
            ("contract_short64", f"{label} W^T v", (Wall, dy)),
            ("contract_long64", f"{label} A*(Psi)", (A_flat, t(normal(B, F)))),
            ("contract_long64", f"{label} W u", (Wall, t(normal(B, F + P)))),
            ("contract_long64", f"{label} G dy", (Gall, dy)),
            ("contract_long64", f"{label} G^T w",
             (Gall.transpose(1, 2).contiguous(), t(normal(B, P)))),
        ]
    cases.append(("bmm64", "1472 x n=10", (t(normal(1472, 10, 10)),
                                           t(normal(1472, 10, 10)))))
    # tests/test_df32.py inputs
    r0 = np.random.default_rng(0)
    n = 24
    A = r0.standard_normal((n, n)) * np.exp(r0.uniform(-6, 6, (n, n)))
    Bm = r0.standard_normal((n, n))
    Q, _ = np.linalg.qr(r0.standard_normal((n, n)))
    lam = np.exp(r0.uniform(-3, 3, n))
    X = (Q * lam) @ Q.T
    S = (Q * (1e-7 / lam)) @ Q.T
    cases.append(("bmm64", "test_df32 scaled A B", (t(A[None]), t(Bm[None]))))
    cases.append(("bmm64", "test_df32 X S cancellation",
                  (t(X[None]), t(S[None]))))
    r2 = np.random.default_rng(2)
    M = r2.standard_normal((34, 200)) * 1e3
    cases.append(("contract_short64", "test_df32 short",
                  (t(M), t(r2.standard_normal((1, 34))))))
    r3 = np.random.default_rng(3)
    M = r3.standard_normal((34, 777)) * np.exp(r3.uniform(-4, 4, (34, 777)))
    cases.append(("contract_long64", "test_df32 long",
                  (t(M), t(r3.standard_normal((1, 777))))))
    r9 = np.random.RandomState(9)
    M = r9.randn(200, 65, 300)
    cases.append(("contract_short64", "test_df32 lanes (200, 65, 300)",
                  (t(M), t(r9.randn(200, 65)))))
    cases.append(("contract_long64", "test_df32 lanes (200, 65, 300)",
                  (t(M), t(r9.randn(200, 300)))))
    return cases


def df32_check(name, label, args) -> tuple:
    """One df32 kernel against its plain version at DF32_TOL: one launch
    counted, a float64 result of the plain version's shape, two launches
    bit for bit.  Returns (kernel output, max abs error, relative error)."""
    wrapper = KERNELS[name][0]
    before = wrapper.launches
    got = wrapper(*args)
    want = PLAIN[name](*args)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{name}: no launch counted at {label}")
    if got.dtype != torch.float64 or got.shape != want.shape:
        raise AssertionError(f"{name} {label}: {got.dtype} "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}")
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-300)
    if not rel <= DF32_TOL:
        raise AssertionError(f"{name} {label}: relative error {rel}")
    if not bool((got == wrapper(*args)).all()):
        raise AssertionError(f"{name} {label}: two launches differ")
    return got, err, rel


def ops_of(fn, args) -> list:
    """Names of the ATen ops one call of ``fn`` dispatches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.key.startswith("aten::")})


def bmm64_edge_phase(device) -> None:
    """``bmm64`` around its fragment and tile edges, float64 and float32
    right operands, held to its plain version (no timing)."""
    rng = np.random.default_rng(4)
    worst = 0.0
    for n in BMM_EDGE_N:
        for G in BMM_EDGE_G:
            A = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
            B = torch.as_tensor(rng.standard_normal((G, n, n)), device=device)
            for Bx in (B, B.float()):
                _, _, rel = df32_check(
                    "bmm64", f"edge ({G}, {n}) {str(Bx.dtype)[6:]} B", (A, Bx))
                worst = max(worst, rel)
    log("kernel_edges", name="bmm64", n=BMM_EDGE_N, G=BMM_EDGE_G,
        right_operands=["float64", "float32"], max_rel_err=worst,
        repeat_bit_for_bit=True)


def contract_edge_phase(device) -> None:
    """The static contractions at every (G, J, F) of CONTRACT_EDGE_G,
    CONTRACT_EDGE_J and CONTRACT_EDGE_F, a float64 and a float32 M, held
    to their plain versions (DF32_TOL, two launches bit for bit; no
    timing)."""
    rng = np.random.default_rng(5)
    worst = {"contract_short64": 0.0, "contract_long64": 0.0}
    for G in CONTRACT_EDGE_G:
        for J in CONTRACT_EDGE_J:
            for F in CONTRACT_EDGE_F:
                M = torch.as_tensor(rng.standard_normal((J, F)), device=device)
                vs = {"contract_short64": rng.standard_normal((G, J)),
                      "contract_long64": rng.standard_normal((G, F))}
                for name, v in vs.items():
                    v = torch.as_tensor(v, device=device)
                    for Mx in (M, M.float()):
                        _, _, rel = df32_check(
                            name, f"edge ({G}, {J}, {F}) "
                            f"{str(Mx.dtype)[6:]} M", (Mx, v))
                        worst[name] = max(worst[name], rel)
    for name, rel in worst.items():
        log("kernel_edges", name=name, path="static", G=CONTRACT_EDGE_G,
            J=CONTRACT_EDGE_J, F=CONTRACT_EDGE_F, M=["float64", "float32"],
            max_rel_err=rel, repeat_bit_for_bit=True)


def contract_streams_check(device) -> None:
    """The static contractions at CONTRACT_STREAM_CASES, each on two
    streams at once with other inputs (CONTRACT_STREAM_LAUNCHES launches
    a stream, in turns), then from two CUDA graphs of those launches
    replayed on the two streams at once: every result bit for bit the
    launch alone.  A launch keeps no state outside its arguments (the
    long one's split-K sum waits on its cooperative launch's own
    barrier), so launches that overlap cannot mix."""
    rng = np.random.default_rng(6)
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for label, mp, knn, _, B, _, _ in DF32_SHAPES:
        if label not in CONTRACT_STREAM_CASES:
            continue
        M = torch.as_tensor(rng.standard_normal((mp, knn)), device=device)
        for name in ("contract_short64", "contract_long64"):
            wrapper = KERNELS[name][0]
            D = mp if name == "contract_short64" else knn
            vs = [torch.as_tensor(rng.standard_normal((B, D)), device=device)
                  for _ in streams]
            want = [wrapper(M, v) for v in vs]
            outs = ([], [])
            for s in streams:
                s.wait_stream(main)
            for _ in range(CONTRACT_STREAM_LAUNCHES):
                for s, v, out in zip(streams, vs, outs):
                    with torch.cuda.stream(s):
                        out.append(wrapper(M, v))
            torch.cuda.synchronize()
            graphs, gouts = [], ([], [])
            for v, out in zip(vs, gouts):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    for _ in range(CONTRACT_STREAM_LAUNCHES):
                        out.append(wrapper(M, v))
                graphs.append(g)
            for s in streams:
                s.wait_stream(main)
            for s, g in zip(streams, graphs):
                with torch.cuda.stream(s):
                    g.replay()
            torch.cuda.synchronize()
            for mode, got in (("streams", outs), ("graphs", gouts)):
                for w, out in zip(want, got):
                    if not all(bool((o == w).all()) for o in out):
                        raise AssertionError(f"{name} {label}: launches on "
                                             f"two {mode} at once differ "
                                             "from the launch alone")
            log("contract_streams", name=name, shape=label,
                plan=df32.contract_plan(
                    "short" if name == "contract_short64" else "long", B, mp,
                    knn)._asdict(),
                launches_a_stream=CONTRACT_STREAM_LAUNCHES,
                modes=["streams", "graphs"], bit_for_bit=True)


def einsum64(name, args):
    """The one PyTorch call that computes a df32 contraction: a float64
    ``torch.einsum`` (the plain version's product) on the operands made
    float64 beforehand, outside the timing.  The call ignores its
    arguments, so the timers can pass the kernel's."""
    M, v = (a.to(torch.float64) for a in args)
    out = "gf" if name == "contract_short64" else "gj"
    inner = "gj" if name == "contract_short64" else "gf"
    spec = f"{'jf' if M.dim() == 2 else 'gjf'},{inner}->{out}"
    return lambda *_: torch.einsum(spec, M, v)


def df32_phase(device) -> dict:
    """Check and time the three df32 kernels against their plain
    versions, ``bmm64`` against ``torch.matmul`` and the contractions
    against their float64 ``torch.einsum`` (einsum64); returns the
    main-path entry of each."""
    out, static = {}, {}
    bmm64_edge_phase(device)
    contract_edge_phase(device)
    contract_streams_check(device)
    for name, label, args in df32_cases(device):
        wrapper = KERNELS[name][0]
        got, err, rel = df32_check(name, label, args)
        if name == "bmm64" and args[1].dtype == torch.float32:
            # the float32 right operand reaches the kernel as it is
            ops = ops_of(wrapper, args)
            log("kernel_ops", name=name, shape=label, aten_ops=ops)
            if "aten::_to_copy" in ops or "aten::copy_" in ops:
                raise AssertionError(f"{name} {label}: upcast before the "
                                     f"launch: {ops}")
        fns = [wrapper, PLAIN[name]]
        lib = name != "bmm64" or args[1].dtype == torch.float64
        if lib:
            fns.append(torch.matmul if name == "bmm64"
                       else einsum64(name, args))
        t, tp, *tl = graph_times(fns, args)
        te, tpe, *tle = eager_times(fns, args)
        log("kernel", name=name, shape=label,
            args=[list(a.shape) + [str(a.dtype)[6:]] for a in args],
            max_abs_err=err, max_rel_err=rel, ms=t, plain_ms=tp,
            eager_ms=te, plain_eager_ms=tpe, library_ms=tl[0] if lib else None,
            library_eager_ms=tle[0] if lib else None)
        if name != "bmm64" and args[0].dim() == 2 and "test_df32" not in label:
            static[label] = {"ms": t, "library_ms": tl[0],
                             "of_library": t / tl[0],
                             **kernel_bound(name, args, got)}
        if label == DF32_MAIN[name]:
            out[name] = {"max_abs_err": err, "max_rel_err": rel, "ms": t,
                         "plain_ms": tp, "eager_ms": te,
                         "plain_eager_ms": tpe,
                         "library_ms": tl[0] if lib else None,
                         **kernel_bound(name, args, got)}
    log("static_contractions", card=card_line(), cases=static,
        at_or_below_library=all(c["ms"] <= c["library_ms"]
                                for c in static.values()))
    return out


def _sym(a):
    return 0.5 * (a + np.swapaxes(a, -1, -2))


def rhs_reference(A, Rc, XRp, Sinv):
    """float64 numpy reference of rhs_bucket."""
    P = np.einsum("zkac,zkcd->zkad", Rc - XRp, Sinv.astype(np.float64))
    return np.einsum("kjpq,zkqp->zj", A, P)


def recover_reference(A, dy, Rp, Rc, X, Sinv, pad):
    """float64 numpy references (dS, dX) of recover_bucket."""
    dS = np.where(pad, np.einsum("kjpq,zj->zkpq", A, dy) + Rp, 0.0)
    dX = np.where(pad, np.einsum(
        "zkac,zkcd->zkad", Rc - np.einsum("zkac,zkcd->zkad", X, dS),
        Sinv.astype(np.float64)), 0.0)
    return dS, dX


def bucket_edge_cases(device, edges=BUCKET_EDGES) -> dict:
    """label -> {kernel: (args, numpy references)} of rhs_bucket and
    recover_bucket at ``edges`` (BUCKET_EDGES' form), with fused_cases'
    input scales."""
    rng = np.random.default_rng(3)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    cases = {}
    for label, B, K, n, mp, kind in edges:
        A = _sym(rng.standard_normal((K, mp, n, n)))
        Rc = rng.standard_normal((B, K, n, n)) * 1e-6
        XRp = rng.standard_normal((B, K, n, n)) * 1e-6
        Sinv = _sym(rng.standard_normal((B, K, n, n))).astype(np.float32)
        dy = rng.standard_normal((B, mp)) * 1e-3
        Rp = rng.standard_normal((B, K, n, n)) * 1e-7
        X = _sym(rng.standard_normal((B, K, n, n)))
        pad = np.ones((1, K, n, n), bool)
        if kind == "shared":
            act = np.arange(n) < n - 3
            pad[0, -1] = act[:, None] & act[None, :]
        elif kind == "instance":
            pad = np.ones((B, K, n, n), bool)
            for b in range(B):
                act = np.arange(n) < n - 1 - b % 4
                pad[b, -1] = act[:, None] & act[None, :]
        cases[label] = {
            "rhs_bucket": ((t(A), t(Rc), t(XRp), t(Sinv)),
                           (rhs_reference(A, Rc, XRp, Sinv),)),
            "recover_bucket": ((t(A), t(dy), t(Rp), t(Rc), t(X), t(Sinv),
                                t(pad)),
                               recover_reference(A, dy, Rp, Rc, X, Sinv,
                                                 pad))}
    return cases


def fused_cases(device):
    """(label, {kernel: (args, numpy reference)}) at FUSED_SHAPES, with
    tests/test_fused.py's input scales: corrector-scale Rc and X Rp,
    symmetric A, X and float32 S^-1; the Schur system with two fixed rows
    (every row of instance 0 where FUSED_SHAPES says so),
    its preconditioner built as the refine tier builds it, and the exact
    float64 solve of each live subsystem."""
    rng = np.random.default_rng(2)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    cases = []
    for label, B, K, n, mp, F, padded, fixed0 in FUSED_SHAPES:
        A = _sym(rng.standard_normal((K, mp, n, n)))
        Rc = rng.standard_normal((B, K, n, n)) * 1e-6
        XRp = rng.standard_normal((B, K, n, n)) * 1e-6
        Sinv = _sym(rng.standard_normal((B, K, n, n))).astype(np.float32)
        rhs_ref = rhs_reference(A, Rc, XRp, Sinv)

        W = rng.standard_normal((B, mp, F)).astype(np.float32)
        diag = np.abs(rng.standard_normal((B, mp))) * 1e3
        reg = np.full((B, mp), 1e-7)
        fix = np.zeros((B, mp), bool)
        fix[:, -2:] = True
        fix[0] |= fixed0
        rhs = rng.standard_normal((B, mp))
        W64 = W.astype(np.float64)
        M = np.einsum("bif,bjf->bij", W64, W64) + np.eye(mp) * (
            diag + reg)[:, :, None]
        sol = np.zeros((B, mp))
        for b in range(B):
            live = ~fix[b]
            sol[b, live] = np.linalg.solve(M[b][np.ix_(live, live)],
                                           rhs[b, live])
        M = np.where(fix[:, :, None] | fix[:, None, :], 0.0, M)
        M += np.eye(mp) * fix[:, :, None]
        dsc = 1.0 / np.sqrt(np.einsum("bii->bi", M))
        Minv = np.linalg.inv((M * dsc[:, :, None] * dsc[:, None, :])
                             .astype(np.float32)).astype(np.float32)

        dy = rng.standard_normal((B, mp)) * 1e-3
        Rp = rng.standard_normal((B, K, n, n)) * 1e-7
        X = _sym(rng.standard_normal((B, K, n, n)))
        pad = np.ones((1, K, n, n), bool)
        if padded:      # a smaller last block in the bucket
            act = np.arange(n) < n - 3
            pad[0, -1] = act[:, None] & act[None, :]
        dS, dX = recover_reference(A, dy, Rp, Rc, X, Sinv, pad)
        cases.append((label, {
            "rhs_bucket": ((t(A), t(Rc), t(XRp), t(Sinv)), (rhs_ref,)),
            "schur_solve_fused": ((t(W), t(rhs), t(Minv), t(dsc), t(diag),
                                   t(reg), t(fix), NREFINE), (sol,)),
            "recover_bucket": ((t(A), t(dy), t(Rp), t(Rc), t(X), t(Sinv),
                                t(pad)), (dS, dX)),
        }))
    return cases


def fused_check(name, label, args, refs) -> tuple:
    """Fused kernel ``name`` on ``args`` against its plain version and the
    numpy references ``refs`` at FUSED_BARS, float64 of the plain
    version's shape, two launches bit for bit, one launch counted a call;
    returns the largest errors from the plain version and from numpy."""
    wrapper = KERNELS[name][0]
    before = wrapper.launches
    got = wrapper(*args)
    want = PLAIN[name](*args)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{name}: no launch counted at {label}")
    if name != "recover_bucket":
        got, want = (got,), (want,)
    again = wrapper(*args)
    again = again if name == "recover_bucket" else (again,)
    err = err_ref = 0.0
    for g, w, g2, ref, (bar, floor) in zip(got, want, again, refs,
                                           FUSED_BARS[name]):
        if g.dtype != torch.float64 or g.shape != w.shape:
            raise AssertionError(f"{name} {label}: {g.dtype} "
                                 f"{tuple(g.shape)} vs {tuple(w.shape)}")
        if not bool((g == g2).all()):
            raise AssertionError(f"{name} {label}: two launches differ")
        gn = g.cpu().numpy()
        e = float((g - w).abs().max())
        er = float(np.abs(gn - ref).max())
        for what, x, scale in (
                ("plain version", e, float(w.abs().max())),
                ("numpy reference", er, float(np.abs(ref).max()))):
            if not x <= bar * max(floor, scale):
                raise AssertionError(
                    f"{name} {label}: {x} from the {what}, bar "
                    f"{bar} * max({floor}, {scale})")
        err, err_ref = max(err, e), max(err_ref, er)
    return err, err_ref


def fused_kernel_phase(device) -> dict:
    """Check and time the three fused kernels against their plain versions
    and the numpy references (each chains several products over mixed
    float32 and float64 operands: no one library call computes it), and
    check rhs_bucket and recover_bucket at BUCKET_EDGES; returns the
    main-path entry of each."""
    out = {}
    for label, per_kernel in bucket_edge_cases(device).items():
        for name, (args, refs) in per_kernel.items():
            err, err_ref = fused_check(name, label, args, refs)
            log("kernel_edge", name=name, shape=label,
                args=[list(a.shape) for a in args], max_abs_err=err,
                max_abs_err_vs_numpy=err_ref, repeat_same=True)
    for label, per_kernel in fused_cases(device):
        for name in FUSED:
            args, refs = per_kernel[name]
            wrapper = KERNELS[name][0]
            err, err_ref = fused_check(name, label, args, refs)
            t, tp = graph_times([wrapper, PLAIN[name]], args)
            te, tpe = eager_times([wrapper, PLAIN[name]], args)
            log("kernel", name=name, shape=label,
                args=[list(a.shape) + [str(a.dtype)[6:]] for a in args
                      if isinstance(a, torch.Tensor)],
                max_abs_err=err, max_abs_err_vs_numpy=err_ref,
                bars=FUSED_BARS[name], ms=t, plain_ms=tp, eager_ms=te,
                plain_eager_ms=tpe)
            if label == FUSED_MAIN:
                out[name] = {"max_abs_err": err,
                             "max_abs_err_vs_numpy": err_ref, "ms": t,
                             "plain_ms": tp, "eager_ms": te,
                             "plain_eager_ms": tpe, "library_ms": None,
                             **kernel_bound(name, args, wrapper(*args))}
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def pallas_cases(device):
    """(label, {kernel: (args, float64 numpy reference, library call or
    None, the matrix made indefinite or None)}) at TRI_SHAPES and
    GRAM_SHAPES.  Positive definite inputs are tests/test_lanes_chol.py's
    (a a^T + n I, symmetric, as the plain Cholesky symmetrizes); the
    triangular inverse takes their float64 factors rounded to float32."""
    rng = np.random.default_rng(3)
    cases = []
    for label, lead, n, scale in TRI_SHAPES:
        N = int(np.prod(lead))
        A64 = spd_stack(rng, N, n, scale)
        L64 = np.linalg.cholesky(A64)
        A = torch.as_tensor(A64.reshape(lead + (n, n)), dtype=torch.float32,
                            device=device)
        Lt = torch.as_tensor(L64.reshape(lead + (n, n)), dtype=torch.float32,
                             device=device)
        Linv64 = np.linalg.inv(L64.astype(np.float32).astype(np.float64))
        eye = torch.eye(n, dtype=torch.float32, device=device).expand(Lt.shape)
        per_kernel = {
            "cholesky": ((A,), L64, torch.linalg.cholesky_ex, N // 2),
            "tril_inverse": ((Lt,), Linv64, lambda L, eye=eye: (
                torch.linalg.solve_triangular(L, eye, upper=False)), N // 2),
            "chol_inverse_lanes": ((A,), np.linalg.inv(L64), None, N // 2),
        }
        if scale:   # the ill-conditioned stack: the two inverses' case
            del per_kernel["cholesky"]
        cases.append((label, per_kernel))
    for label, B, mp, F in GRAM_SHAPES:
        W = rng.standard_normal((B, mp, F)).astype(np.float32)
        W64 = W.astype(np.float64)
        Wt = torch.as_tensor(W, device=device)
        cases.append((label, {"schur_wwt": (
            (Wt,), np.einsum("xif,xjf->xij", W64, W64),
            lambda W: torch.bmm(W, W.mT), None)}))
    return cases


def pallas_check(name, label, args, ref, bad) -> tuple:
    """One float32 kernel against its plain version and the numpy
    reference at its bar; exact zeros above the diagonal; two launches
    bit for bit; with ``bad``, NaN in that matrix of the stack only.
    Returns (kernel output, max |kernel - plain|, max |kernel - numpy|)."""
    wrapper = KERNELS[name][0]
    before = wrapper.launches
    got = wrapper(*args)
    want = PLAIN[name](*args)
    again = wrapper(*args)
    torch.cuda.synchronize()
    if wrapper.launches != before + 2:
        raise AssertionError(f"{name}: no launch counted at {label}")
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"{name} {label}: {got.dtype} "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}")
    if not same_bits(got, again):
        raise AssertionError(f"{name} {label}: two launches differ")
    gn = got.double().cpu().numpy().reshape(ref.shape)
    err = float((got - want).abs().max())
    err_ref = float(np.abs(gn - ref).max())
    bar = PALLAS_BARS[name]
    if isinstance(bar, tuple):
        np.testing.assert_allclose(gn, ref, rtol=bar[0], atol=bar[1],
                                   err_msg=f"{name} {label} vs numpy")
        torch.testing.assert_close(got, want, rtol=bar[0], atol=bar[1])
    else:
        scale = max(1.0, float(np.abs(ref).max())) if name == "schur_wwt" \
            else float(np.abs(ref).max())
        for what, x in (("plain version", err), ("numpy reference", err_ref)):
            if not x <= bar * scale:
                raise AssertionError(f"{name} {label}: {x} from the {what}, "
                                     f"bar {bar} * {scale}")
    if name == "schur_wwt":
        if not bool((got == got.mT).all()):
            raise AssertionError(f"{name} {label}: not symmetric")
    else:
        if not bool((torch.triu(got, diagonal=1) == 0).all()):
            raise AssertionError(f"{name} {label}: nonzero above the diagonal")
        n = got.shape[-1]
        flat = args[0].reshape(-1, n, n)
        broken = flat.clone()
        if name == "tril_inverse":
            broken[bad, n - 1, 0] = float("nan")
        else:
            broken[bad] -= 4.0 * n * torch.eye(n, device=flat.device)
        out = wrapper(broken).reshape(flat.shape)
        nan_mat = torch.isnan(out).reshape(flat.shape[0], -1).any(1)
        torch.cuda.synchronize()
        expect = torch.zeros_like(nan_mat)
        expect[bad] = True
        if not bool((nan_mat == expect).all()):
            raise AssertionError(f"{name} {label}: NaN pattern wrong: "
                                 f"{nan_mat.nonzero().flatten().tolist()}")
        low = torch.ones(n, n, dtype=torch.bool, device=out.device).tril()
        if name in ("cholesky", "chol_inverse_lanes") and not (
                bool(torch.isnan(out[bad][low]).all())
                and bool((out[bad][~low] == 0).all())):
            raise AssertionError(f"{name} {label}: the matrix that is not "
                                 "positive definite is not NaN on and below "
                                 "its diagonal with zeros above")
    return got, err, err_ref


def kernel_pair(A: torch.Tensor) -> torch.Tensor:
    """chol_inverse_lanes' two-call yardstick in the port: the cholesky
    kernel, then the tril_inverse kernel."""
    return kernels.tril_inverse(kernels.cholesky(A))


def library_pair(A: torch.Tensor) -> torch.Tensor:
    """chol_inverse_lanes' two-call yardstick in the library:
    cholesky_ex, then solve_triangular on the identity."""
    L = torch.linalg.cholesky_ex(A)[0]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def pair_entry(label, args, ref, err_ref) -> dict:
    """chol_inverse_lanes beside its two-call yardsticks (kernel_pair,
    library_pair): their device and eager ms and the kernel pair's error
    from numpy; on the ill-conditioned stack the fused kernel must be no
    further from numpy than the pair."""
    pair_err = float(np.abs(kernel_pair(*args).double().cpu().numpy()
                            .reshape(ref.shape) - ref).max())
    if "ill-conditioned" in label and not err_ref <= pair_err:
        raise AssertionError(f"chol_inverse_lanes {label}: {err_ref} from "
                             f"numpy, the cholesky -> tril_inverse pair "
                             f"{pair_err}")
    tk, tl = graph_times([kernel_pair, library_pair], args)
    tke, tle = eager_times([kernel_pair, library_pair], args)
    return {"kernel_pair_ms": tk, "library_pair_ms": tl,
            "kernel_pair_eager_ms": tke, "library_pair_eager_ms": tle,
            "kernel_pair_err_vs_numpy": pair_err}


def pallas_kernel_phase(device) -> dict:
    """Check and time the four float32 kernels against their plain
    versions, the numpy references and (#2-#4) the library call that
    computes the same function (#5: the two-call yardsticks, pair_entry);
    returns the main-path entry of each."""
    out = {}
    for label, per_kernel in pallas_cases(device):
        for name, (args, ref, library, bad) in per_kernel.items():
            got, err, err_ref = pallas_check(name, label, args, ref, bad)
            fns = [KERNELS[name][0], PLAIN[name]] + (
                [library] if library else [])
            t, tp, *tl = graph_times(fns, args)
            te, tpe, *tle = eager_times(fns, args)
            entry = {"max_abs_err": err, "max_abs_err_vs_numpy": err_ref,
                     "ms": t, "plain_ms": tp, "eager_ms": te,
                     "plain_eager_ms": tpe,
                     "library_ms": tl[0] if library else None,
                     "library_eager_ms": tle[0] if library else None,
                     **kernel_bound(name, args, got)}
            if name == "chol_inverse_lanes":
                entry.update(pair_entry(label, args, ref, err_ref))
            log("kernel", name=name, shape=label,
                args=[list(a.shape) for a in args], bar=PALLAS_BARS[name],
                **entry)
            if label == PALLAS_MAIN[name]:
                out[name] = entry
    return out


def node_boxes(prob, B: int, nfeat: int, rng):
    """Slot 0 is the root box; slots 1.. fix 1-3 binary z variables."""
    lb = np.tile(prob.lb, (B, 1))
    ub = np.tile(prob.ub, (B, 1))
    for s in range(1, B):
        k = int(rng.integers(1, 4))
        zs = nfeat + rng.choice(nfeat, size=k, replace=False)
        vals = rng.integers(0, 2, size=k).astype(float)
        lb[s, zs] = vals
        ub[s, zs] = vals
    return lb, ub


def request(prob, lb, ub, mode: str):
    """(b, lb, ub) with the penalty column for one solve mode."""
    B = lb.shape[0]
    b = np.concatenate([np.tile(prob.obj, (B, 1)), np.zeros((B, 1))], 1)
    lbp = np.concatenate([lb, np.zeros((B, 1))], 1)
    ubp = np.concatenate([ub, np.zeros((B, 1))], 1)
    if mode != "direct":
        ubp[:, -1] = 1e20
    if mode == "probe":
        b[:, :-1] = 0.0
        b[:, -1] = 1.0
    elif mode == "penalty":
        b[:, -1] = GAMMA
    return b, lbp, ubp


def make_cases(device):
    cases = []
    rng = np.random.default_rng(0)
    for label, args, B, modes in (
            ("cls_32", (32, 64, 8), 32, ("direct", "probe", "penalty")),
            ("cls_64", (64, 128, 12), 8, ("direct",))):
        prob = cardinality_least_squares(*args, seed=5)
        dense = densify(prob)
        data = build_ipm_data(dense, device)
        lb, ub = node_boxes(prob, B, args[0], rng)
        for mode in modes:
            cases.append((f"{label}/{mode}", dense, data,
                          request(prob, lb, ub, mode), mode == "direct"))
    return cases


def timed(data, req, settings):
    """Wall time of one solve, between two device synchronizations, and
    its output."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ipm_solve(data, *req, settings=settings)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def dual_violation(dense, y: np.ndarray, lb, ub) -> float:
    """Independent numpy check of a dual point (without the penalty
    variable): worst violation of Z(y) >= 0, G y >= h and the bounds,
    relative to the data scale."""
    scale = 1.0 + max(np.abs(dense.C).max(), np.abs(dense.h).max(initial=0))
    worst = 0.0
    for k in range(dense.nblocks):
        Z = np.einsum("jab,j->ab", dense.A[k], y) - dense.C[k]
        worst = max(worst, -np.linalg.eigvalsh(Z)[0])
    if dense.G.shape[0]:
        worst = max(worst, float(np.max(dense.h - dense.G @ y)))
    worst = max(worst, float(np.max(lb - y)), float(np.max(y - ub)))
    return worst / scale


def check_solve(label, dense, out, req, gaptol, feastol, direct):
    """Every slot OPTIMAL with finite y; for a direct solve, children bound
    no lower than the root and the root's dual point is feasible."""
    st = out.status.cpu().numpy()
    if not (st == int(SolverResultStatus.OPTIMAL)).all():
        raise AssertionError(f"{label}: statuses {collections.Counter(st)}")
    if not np.isfinite(out.y.cpu().numpy()).all():
        raise AssertionError(f"{label}: non-finite y")
    if not direct:
        return None
    dobj = out.dobj.cpu().numpy()
    root = dobj[0]
    floor = root - 2 * gaptol * (1 + abs(root))
    if not (dobj >= floor).all():
        raise AssertionError(f"{label}: child bound below root {root}")
    y = out.y[0, :dense.nvars].cpu().numpy()
    viol = dual_violation(dense, y, req[1][0, :-1], req[2][0, :-1])
    if viol > 10 * feastol:
        raise AssertionError(f"{label}: root dual point infeasible by {viol}")
    return viol


def agree(label, out, ref, gaptol, what, iters_tol=3, bar=None):
    """Same statuses, dobj within ``bar`` (2 * gaptol unless given) *
    (1 + |dobj|), iterations within ``iters_tol``."""
    st, st_ref = out.status.cpu().numpy(), ref.status.cpu().numpy()
    if not (st == st_ref).all():
        raise AssertionError(f"{label}: statuses differ from {what}")
    d, d_ref = out.dobj.cpu().numpy(), ref.dobj.cpu().numpy()
    dev = np.abs(d - d_ref) / (1 + np.abs(d_ref))
    if not (dev <= (2 * gaptol if bar is None else bar)).all():
        raise AssertionError(f"{label}: dobj differs from {what} by "
                             f"{dev.max()}")
    if abs(out.iters - ref.iters) > iters_tol:
        raise AssertionError(f"{label}: {out.iters} vs {ref.iters} iters "
                             f"({what})")
    return float(dev.max())


def drive(cases, settings, need) -> tuple:
    """One solve per request (the first of each, so it includes warm-up)
    with every launch counter set to 0 just before and read just after;
    each request must launch every kernel in ``need``."""
    reset_counts()
    outs, per_request = [], []
    for label, _, data, req, _ in cases:
        before = counts()
        outs.append(ipm_solve(data, *req, settings=settings))
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()}
        missing = [k for k in need if delta[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        per_request.append(delta)
    return counts(), per_request, outs


def f64_phase(cases, settings):
    """The float64 tier (phase32="off") with the probe kernel."""
    launches, per_request, outs = drive(cases, settings, ["cholesky_lanes"])
    plain = dataclasses.replace(settings, use_lanes_chol=False)
    for (label, dense, data, req, direct), out, n in zip(cases, outs,
                                                         per_request):
        viol = check_solve(label, dense, out, req, settings.gaptol,
                           settings.feastol, direct)
        ref = ipm_solve(data, *req, settings=plain)
        dev = agree(label, out, ref, settings.gaptol, "the plain probe")
        log("f64_solve", request=label, B=int(out.status.shape[0]),
            iters=out.iters, plain_probe_iters=ref.iters, launches=n,
            max_rel_dobj_vs_plain_probe=dev, root_dobj=float(out.dobj[0]),
            root_dual_violation=viol)
    log("f64_path", launches=launches)
    return launches, outs


# the sdpi phase: the rungs request's slots after the main request's, by
# kind: (label, count); "t-" fixes the epigraph variable t below the root's
# optimum t* by the given share of it, "z fixed" fixes every binary z (k of
# them to 1), "unbounded" minimises -t
SDPI_SLOTS = [("infeasible: k+1 z at 1", 1), ("t- 1e-3", 1), ("t- 1e-6", 1),
              ("t- 1e-5", 1), ("t- 3e-5", 1), ("unbounded", 1),
              ("t at t*", 1), ("z fixed", 2)]
SDPI_ROUNDS = 5      # ladder against direct ipm_solve, warm against cold
UNSOLVED = [int(SolverResultStatus.FAILED), int(SolverResultStatus.ITERLIMIT),
            int(SolverResultStatus.TIMELIMIT)]


def rung_boxes(prob, lb, ub, tstar, nfeat, k, rng):
    """The rungs request: ``lb``/``ub`` with their last slots replaced by
    SDPI_SLOTS' boxes.  Returns (lb, ub, obj, kinds), kinds per slot
    ("child" for the boxes kept)."""
    B = lb.shape[0]
    lb, ub = lb.copy(), ub.copy()
    obj = np.tile(prob.obj, (B, 1))
    kinds = ["root"] + ["child"] * (B - 1)
    tidx, zs = 2 * nfeat, np.arange(nfeat, 2 * nfeat)
    s = B - sum(c for _, c in SDPI_SLOTS)
    for kind, count in SDPI_SLOTS:
        for _ in range(count):
            lb[s], ub[s], kinds[s] = prob.lb, prob.ub, kind
            if kind.startswith("infeasible"):
                lb[s, zs[:k + 1]] = 1.0
            elif kind.startswith("t- "):
                lb[s, tidx] = ub[s, tidx] = tstar * (1 - float(kind[3:]))
            elif kind == "t at t*":
                lb[s, tidx] = ub[s, tidx] = tstar
            elif kind == "unbounded":
                obj[s, tidx] = -1.0
            elif kind == "z fixed":
                on = np.isin(zs, rng.choice(zs, size=k, replace=False))
                lb[s, zs] = ub[s, zs] = on.astype(float)
            s += 1
    return lb, ub, obj, kinds


def expected_ok(kind: str, status: int) -> bool:
    """The statuses a slot of this kind may end with: a feasible box
    OPTIMAL, an infeasible one INFEASIBLE, the unbounded one UNBOUNDED; the
    boxes at the feasibility edge (t at or just below t*) any decided
    status."""
    S = SolverResultStatus
    if kind in ("root", "child", "z fixed"):
        return status == int(S.OPTIMAL)
    if kind.startswith("infeasible") or kind == "t- 1e-3":
        return status == int(S.INFEASIBLE)
    if kind == "unbounded":
        return status == int(S.UNBOUNDED)
    return status not in UNSOLVED


class RungLog:
    """Wraps SDPInterface._run and records each ladder solve's kind (probe,
    penalty, box, verify), the slots it solved (not given a conflict box)
    and its wall, the device synchronized after it; and the wall of the
    direct rung with rounding (``solve_and_round``, not through _run).
    ``restore()`` unwraps both."""

    def __init__(self, iface):
        self.iface, self.run, self.calls = iface, iface._run, []
        self.walls, self.direct_s = [], 0.0
        self.round = sdpi_module.solve_and_round
        iface._run = self

        def timed_round(*args, **kw):
            t0 = time.perf_counter()
            out = self.round(*args, **kw)
            torch.cuda.synchronize()
            self.direct_s += time.perf_counter() - t0
            return out

        sdpi_module.solve_and_round = timed_round

    def restore(self):
        self.iface._run = self.run
        sdpi_module.solve_and_round = self.round

    def __call__(self, b, lb, ub, cuts=None, warm_y=None, warm_mask=None,
                 gaptol=None, warm_X=None, feastol_vec=None):
        m = self.iface.m
        act = ~(lb > ub).any(axis=1)
        if feastol_vec is not None:
            kind = "verify"
        elif (b[:, m] == 1).all() and not b[:, :m].any():
            kind = "probe"
        elif (ub[act, m] > 0).any():
            kind = "penalty"
        elif (np.abs(ub[act, :m]) == 1e7).any() or (
                np.abs(lb[act, :m]) == 1e7).any():
            kind = "box"
        else:
            kind = "direct"
        self.calls.append((kind, act))
        t0 = time.perf_counter()
        out = self.run(b, lb, ub, cuts, warm_y, warm_mask, gaptol=gaptol,
                       warm_X=warm_X, feastol_vec=feastol_vec)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        return out

    def rungs(self, res) -> list:
        """Per slot the rung that decided it: presolve, direct, probe
        (INFEASIBLE), penalty (OPTIMAL at a recorded tier), bound (a
        penalty or Farkas bound), box, verify; "unsolved" if none did."""
        S = SolverResultStatus
        out = []
        for s, st in enumerate(res.status.tolist()):
            solved = [k for k, act in self.calls if act[s]]
            if st in (int(S.PRESOLVED_OPTIMAL), int(S.PRESOLVED_INFEASIBLE)):
                r = "presolve"
            elif "probe" not in solved:
                r = "direct"
            elif "verify" in solved:
                r = "verify"
            elif st == int(S.INFEASIBLE):
                r = "probe"
            elif "box" in solved and st in (int(S.UNBOUNDED), int(S.OPTIMAL)):
                r = "box"
            elif st == int(S.OPTIMAL) and np.isfinite(res.tier[s]).all():
                r = "penalty"
            elif st == int(S.BOUND_ONLY):
                r = "bound"
            else:
                r = "unsolved"
            out.append(r)
        return out


def rounding_agrees(dense, res, lb, ub, feastol) -> dict:
    """round_feas against an independent float64 numpy check of each
    rounded point (box, integrality, LP rows, lambda_min(Z) >= -feastol),
    on the points whose lambda_min is not within 1e-6 of the -feastol
    edge (a float32 Cholesky cannot decide there); raises on a
    disagreement."""
    feas, clear = [], []
    for y, lo, hi in zip(res.round_y, lb, ub):
        lam = min(np.linalg.eigvalsh(np.einsum("jab,j->ab", dense.A[k], y)
                                     - dense.C[k])[0]
                  for k in range(dense.nblocks))
        feas.append(bool(lam >= -feastol and (y >= lo).all()
                         and (y <= hi).all()
                         and (dense.G @ y >= dense.h - feastol).all()
                         and (np.abs(y - np.round(y))[dense.integral]
                              <= feastol).all()))
        clear.append(abs(lam + feastol) > 1e-6)
    feas, clear = np.array(feas), np.array(clear)
    if not (res.round_feas[clear] == feas[clear]).all():
        raise AssertionError(f"round_feas {res.round_feas.tolist()} against "
                             f"numpy {feas.tolist()}")
    return {"round_feasible": int(res.round_feas.sum()),
            "numpy_feasible": int(feas.sum()), "edge_points": int((~clear).sum())}


def ladder_request(label, iface, lb, ub, kinds, **kw):
    """One solve_batch with the rungs logged; every slot must end as
    expected_ok says.  Returns (result, per-slot rungs, launches)."""
    log_ = RungLog(iface)
    before, nveri = counts(), iface.stat_nveri_resolve
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = iface.solve_batch(lb, ub, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log_.restore()
    delta = {k: v - before[k] for k, v in counts().items()}
    rungs = log_.rungs(res)
    bad = [(s, kinds[s], int(st)) for s, st in enumerate(res.status)
           if not expected_ok(kinds[s], int(st))]
    if bad:
        raise AssertionError(f"{label}: slots (slot, kind, status) {bad}")
    log("sdpi_request", request=label, B=len(kinds), nsolves=res.nsolves,
        npenalty=res.npenalty, ndirect=res.ndirect, iters=res.iters,
        verification_resolves=iface.stat_nveri_resolve - nveri,
        calls=[k for k, _ in log_.calls], wall_s=wall,
        direct_rung_s=log_.direct_s, later_rungs_s=log_.walls,
        outside_solves_s=wall - log_.direct_s - sum(log_.walls),
        statuses=collections.Counter(res.status.tolist()),
        rung_by_kind=collections.Counter(
            f"{k}: {r}" for k, r in zip(kinds, rungs)), launches=delta)
    return res, rungs, delta


def sdpi_phase(case, settings, f64_out, device):
    """The recovery ladder (core/sdpi.py) at the default CUDA settings.
    The main request (cls_32 B=32 root and child boxes) through
    SDPInterface.solve_batch with rounding_seed=0: every slot OPTIMAL,
    objvals within 2 * gaptol of the float64 path's, round_feas as a numpy
    check says; the rungs request (SDPI_SLOTS' boxes in its last slots):
    each slot as expected_ok says, with the rung that decided it logged;
    both launch the probe kernel.  Then the main request against direct
    ipm_solve and warm-started children against cold ones (warm from the
    root's y and X: statuses equal, objvals within 2 * gaptol), in turns,
    and one profiled call of each but the rungs request (its 124,728
    launches took ~90 s of the script under the profiler; its wall is in
    sdpi_timing).  Returns the launches of the two requests' first
    solves."""
    label, dense, _, req, _ = case
    nfeat, k = 32, 8
    prob = cardinality_least_squares(nfeat, 2 * nfeat, k, seed=5)
    lb, ub = req[1][:, :-1], req[2][:, :-1]
    B = lb.shape[0]
    iface = SDPInterface(dense, device=device)
    if (iface.settings.ipm.step_rule, iface.settings.ipm.use_lanes_chol,
            iface.settings.ipm.phase32) != ("probe", True, "off"):
        raise AssertionError(f"SDPInterface settings {iface.settings.ipm}")
    gaptol, feastol = settings.gaptol, iface.settings.bb.feastol
    reset_counts()
    main, _, n_main = ladder_request(f"{label} ladder", iface, lb, ub,
                                     ["root"] + ["child"] * (B - 1),
                                     rounding_seed=0)
    tstar = float(main.y[0, 2 * nfeat])
    lbr, ubr, objr, kinds = rung_boxes(prob, lb, ub, tstar, nfeat, k,
                                       np.random.default_rng(7))
    rungs, slot_rungs, n_rungs = ladder_request(
        f"{label} rungs", iface, lbr, ubr, kinds, obj=objr, rounding_seed=0)
    launches = counts()
    for what, n in (("main", n_main), ("rungs", n_rungs)):
        if n["cholesky_lanes"] == 0:
            raise AssertionError(f"sdpi {what}: cholesky_lanes not launched")
    d_ref = f64_out.dobj.cpu().numpy()
    dev = np.abs(main.objval - d_ref) / (1 + np.abs(d_ref))
    if not (dev <= 2 * gaptol).all():
        raise AssertionError(f"sdpi: objval differs from ipm_solve by "
                             f"{dev.max()}")
    agree_main = rounding_agrees(dense, main, lb, ub, feastol)
    agree_rungs = rounding_agrees(dense, rungs, lbr, ubr, feastol)

    # the main request: ladder against direct ipm_solve; warm against cold
    warm = (np.tile(main.y[0], (B, 1)), np.ones(B, bool),
            [np.tile(x[:1], (B, 1, 1, 1)) for x in main.X])
    runs = {
        "ladder": lambda: iface.solve_batch(lb, ub, rounding_seed=0),
        "ipm_solve": lambda: ipm_solve(iface.data, *req,
                                       settings=iface.settings.ipm),
        "cold": lambda: iface.solve_batch(lb, ub),
        "warm": lambda: iface.solve_batch(lb, ub, warm=warm),
        "rungs": lambda: iface.solve_batch(lbr, ubr, obj=objr,
                                           rounding_seed=0)}
    walls = {k: [] for k in runs}
    outs = {}
    for r in range(SDPI_ROUNDS):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for key in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[key] = runs[key]()
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
    cold, warm_res = outs["cold"], outs["warm"]
    if not (warm_res.status == cold.status).all():
        raise AssertionError("sdpi: warm-started statuses differ from cold")
    wdev = np.abs(warm_res.objval - cold.objval) / (1 + np.abs(cold.objval))
    if not (wdev <= 2 * gaptol).all():
        raise AssertionError(f"sdpi: warm objvals differ by {wdev.max()}")
    log("sdpi_timing", request=label, rounds=SDPI_ROUNDS,
        wall_s_median={k: float(np.median(v)) for k, v in walls.items()},
        wall_s=walls, nsolves={k: getattr(o, "nsolves", 1)
                               for k, o in outs.items()},
        iters={k: int(o.iters) for k, o in outs.items()},
        ladder_statuses=collections.Counter(outs["ladder"].status.tolist()),
        ipm_solve_statuses=collections.Counter(
            outs["ipm_solve"].status.tolist()),
        max_rel_objval_vs_f64_path=float(dev.max()),
        max_rel_objval_warm_vs_cold=float(wdev.max()),
        rounding_main=agree_main, rounding_rungs=agree_rungs,
        rung_per_slot=dict(zip(range(B), zip(kinds, slot_rungs))))
    for key in ("ipm_solve", "ladder", "cold", "warm"):
        log("sdpi_profile", request=label, run=key,
            **device_profile(runs[key])[1])
    return launches


def sdpi_cpu_reference(device, settings) -> None:
    """A small CLS instance through the ladder on the card and on the CPU,
    with the card's settings: SDPI_SLOTS' boxes after a root and a child;
    statuses equal, objvals within 2 * gaptol (infinities equal)."""
    nfeat, k = 8, 3
    prob = cardinality_least_squares(nfeat, 2 * nfeat, k, seed=1)
    dense = densify(prob)
    B = 2 + sum(c for _, c in SDPI_SLOTS)
    lb, ub = node_boxes(prob, B, nfeat, np.random.default_rng(2))
    s = Settings(ipm=settings)
    ifaces = {d: SDPInterface(dense, s, device=d) for d in ("cpu", device)}
    tstar = float(ifaces["cpu"].solve_batch(prob.lb[None],
                                            prob.ub[None]).y[0, 2 * nfeat])
    lb, ub, obj, kinds = rung_boxes(prob, lb, ub, tstar, nfeat, k,
                                    np.random.default_rng(3))
    res = {d: i.solve_batch(lb, ub, obj=obj, rounding_seed=0)
           for d, i in ifaces.items()}
    ref, out = res["cpu"], res[device]
    if not (out.status == ref.status).all():
        raise AssertionError(f"sdpi small CLS: statuses {out.status} on the "
                             f"card, {ref.status} on the CPU")
    # the slots whose objval is a bound: equal infinities, finite ones
    # within 2 * gaptol
    S = SolverResultStatus
    held = np.isin(ref.status, [int(S.OPTIMAL), int(S.PRESOLVED_OPTIMAL),
                                int(S.BOUND_ONLY), int(S.UNBOUNDED)])
    fin = held & np.isfinite(ref.objval)
    dev = np.abs(out.objval[fin] - ref.objval[fin]) / (1 + np.abs(
        ref.objval[fin]))
    if not ((dev <= 2 * settings.gaptol).all() and np.array_equal(
            out.objval[held & ~fin], ref.objval[held & ~fin])):
        raise AssertionError(f"sdpi small CLS: objvals {out.objval} on the "
                             f"card, {ref.objval} on the CPU")
    log("sdpi_cpu_reference", instance="cls_8x16", B=B,
        statuses=out.status.tolist(), kinds=kinds, nsolves=out.nsolves,
        cpu_nsolves=ref.nsolves, max_rel_objval=float(dev.max()))


# the bb path: bench_families.py's production-size cls_32 at its batch of
# 32 and node cap (NODE_CAPS), held to the optimum BENCH_FAM_CLS32.json
# records for the JAX package; a small CLS on the card against the CPU
BB_INSTANCE = (32, 64, 8, 5)       # nfeatures, nsamples, k, seed
BB_BATCH = 32
BB_NODE_CAP = 4000
BB_OPTIMUM = 0.8340659474849534
BB_SMALL = (10, 20, 3, 1)
BB_REL = 1e-4


def incumbent_violation(prob, y: np.ndarray) -> dict:
    """Independent numpy check of a solution of ``prob`` (the problem as
    given, before presolve): -lambda_min of each block's Z(y) built from
    its sparse triples, and the worst violation of the LP rows, of the
    bounds and of integrality."""
    eig = -np.inf
    for blk in prob.blocks:
        Z = np.zeros((blk.size, blk.size))
        np.add.at(Z, (blk.row, blk.col), blk.val * y[blk.var])
        np.add.at(Z, (blk.const_row, blk.const_col), -blk.const_val)
        Z = Z + np.tril(Z, -1).T          # the triples hold the lower part
        eig = max(eig, -float(np.linalg.eigvalsh(Z)[0]))
    act = prob.lp.dense(prob.nvars) @ y
    lhs, rhs = prob.lp.lhs, prob.lp.rhs
    rows = np.concatenate([np.where(lhs > -1e19, lhs - act, 0.0),
                           np.where(rhs < 1e19, act - rhs, 0.0), [0.0]])
    ints = y[prob.integral]
    return {"psd": eig, "lp_rows": float(rows.max()),
            "bounds": float(max(np.max(prob.lb - y), np.max(y - prob.ub))),
            "integrality": float(np.max(np.abs(ints - np.round(ints)),
                                        initial=0.0))}


def bb_summary(res, wall) -> dict:
    st = res.stats
    return {"status": res.status.name, "objval": res.objval,
            "dual_bound": res.dual_bound, "nodes": st.nodes,
            "relax_solves": st.relax_solves,
            "ipm_iterations": st.ipm_iterations,
            "solver_calls": st.solver_calls, "npenalty": st.npenalty,
            "nunsolved": st.nunsolved, "heur_found": st.heur_found,
            "nnogoods": st.nnogoods, "wall_s": wall,
            "solve_time_s": st.solve_time,
            "host_share_of_wall": 1.0 - st.solve_time / wall,
            "nodes_per_s": st.nodes / wall}


def bb_settings(**bb) -> Settings:
    return Settings(bb=dataclasses.replace(Settings().bb, **bb))


def bb_phase(card: str) -> tuple:
    """The host B&B loop (``core/branchbound.py::solve_misdp`` with
    ``bb.turbo="off"``) on the card.  A small CLS solved on the card and
    on the CPU: the same status and optimum within BB_REL.  Then cls_32 at
    B=32, otherwise default settings and the node cap, with every launch
    counter set to 0 just before and read just after: OPTIMAL, the
    objective within BB_REL of BB_OPTIMUM, the incumbent feasible by
    incumbent_violation at the settings' feastol, the probe kernel
    launched.  Then tree_profile of the same solve (device busy, launches,
    host syncs per batch).  Returns the counts and the tree's summary."""
    small = cardinality_least_squares(*BB_SMALL[:3], seed=BB_SMALL[3])
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = solve_misdp(small, bb_settings(turbo="off"), device=dev)
        res[dev] = bb_summary(res[dev], time.perf_counter() - t0)
    ref, out = res["cpu"], res["cuda"]
    if out["status"] != ref["status"] or abs(
            out["objval"] - ref["objval"]) > BB_REL * abs(ref["objval"]):
        raise AssertionError(f"bb small CLS: {out} on the card, {ref} on "
                             f"the CPU")
    log("bb_cpu_reference", instance="cls_10x20", card=out, cpu=ref)

    prob = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    settings = bb_settings(batch_size=BB_BATCH, node_limit=BB_NODE_CAP,
                           turbo="off")

    def run():
        return solve_misdp(prob, settings)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    summary = bb_summary(out, wall)
    if out.status.name != "OPTIMAL" or abs(
            out.objval - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
        raise AssertionError(f"bb cls_32: {summary}, want OPTIMAL at "
                             f"{BB_OPTIMUM}")
    viol = incumbent_violation(prob, out.best_y)
    feastol = settings.bb.feastol
    if not all(v <= feastol for v in viol.values()):
        raise AssertionError(f"bb cls_32: incumbent infeasible: {viol}")
    if launches["cholesky_lanes"] == 0:
        raise AssertionError("bb cls_32: cholesky_lanes not launched")
    prof = tree_profile(run)
    log("bb_solve", instance="cls_32", batch=BB_BATCH, node_cap=BB_NODE_CAP,
        card=card, node_store=("native" if FrontierStore(1).native
                               else "python"),
        **summary, rel_err_vs_jax_optimum=abs(out.objval - BB_OPTIMUM)
        / BB_OPTIMUM, incumbent_violation=viol, launches=launches,
        cholesky_lanes_per_batch=launches["cholesky_lanes"]
        / out.stats.relax_solves,
        host_syncs_per_batch=prof["host_syncs"] / out.stats.relax_solves,
        device_idle_share=1.0 - 1e-6 * prof["device_busy_us"] / wall,
        **prof)
    return launches, {**summary, "device_idle_share": 1.0 - 1e-6
                      * prof["device_busy_us"] / wall,
                      "host_syncs_per_batch": prof["host_syncs"]
                      / out.stats.relax_solves}


# the turbo path: the device-resident tree (core/turbo.py), which "auto"
# engages at once on the card; mkp_12 at B = 8 through solve_turbo, held
# to its known optimum (tests/test_families.py, bench.py:73's rule)
TURBO_MKP = (12, 3, 0.6, 1)        # nvertices, k, density, seed
TURBO_MKP_BATCH = 8
TURBO_MKP_OPTIMUM = 30.0


class CallSpy:
    """Calls, results, #1 launches and wall of each call of the named
    functions of ``module`` while a ``with`` block runs.  A ``timed`` spy
    ends each call in torch.cuda.synchronize, so its wall holds the
    call's device work."""

    def __init__(self, module, names, timed=True):
        self.module, self.names, self.timed = module, names, timed
        self.wall = dict.fromkeys(names, 0.0)
        self.calls = dict.fromkeys(names, 0)
        self.launches = dict.fromkeys(names, 0)
        self.results = {k: [] for k in names}
        self.args = {k: [] for k in names}

    def wrap(self, name, orig):
        def call(*a, **kw):
            self.args[name].append((a, kw))
            l0 = kernels.cholesky_lanes.launches
            t0 = time.perf_counter()
            try:
                out = orig(*a, **kw)
            finally:
                if self.timed:
                    torch.cuda.synchronize()
                self.wall[name] += time.perf_counter() - t0
                self.calls[name] += 1
                self.launches[name] += kernels.cholesky_lanes.launches - l0
            self.results[name].append(out)
            return out
        return call

    def __enter__(self):
        self.saved = {k: getattr(self.module, k) for k in self.names}
        for name, orig in self.saved.items():
            setattr(self.module, name, self.wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


class TurboSpy(CallSpy):
    """What the turbo path did inside a ``with`` block: ``solve_turbo``'s
    results, the widths ``make_round`` built and the chunks they ran,
    ``psd_feasible``'s calls, the #1 launches inside them and their
    inputs (data, candidate points, check tolerance).  Untimed: it adds
    no host sync to the tree."""

    def __init__(self):
        super().__init__(turbo, ("solve_turbo", "make_round",
                                 "psd_feasible"), timed=False)
        self.widths, self.points = [], []
        self.chunks = 0

    def wrap(self, name, orig):
        call = super().wrap(name, orig)
        if name == "make_round":
            def make_round(settings, integral, B, *a, **kw):
                self.widths.append(B)
                chunk = call(settings, integral, B, *a, **kw)

                def counted(*ca):
                    self.chunks += 1
                    return chunk(*ca)
                return counted
            return make_round
        if name == "psd_feasible":
            def psd_feasible(data, yc, chktol, *a):
                self.points.append((data, yc, chktol))
                return call(data, yc, chktol, *a)
            return psd_feasible
        return call


def turbo_read_lines() -> dict:
    """core/turbo.py's host reads, tagged in the source: line -> "chunk"
    (the summary) or "round" (whether a round runs, each rung's test)."""
    lines = pathlib.Path(turbo.__file__).read_text().splitlines()
    return {i + 1: ("chunk" if "host read: the chunk" in line else "round")
            for i, line in enumerate(lines) if "# host read:" in line}


def turbo_syncs(sites: list, rounds: int, chunks: int, widths: int) -> dict:
    """Host syncs of one turbo tree by kind from tree_profile's
    ``sync_sites`` ((site, count) pairs); raises if core/turbo.py read
    more than 3 times a round plus once a chunk, or read at an untagged
    line more often than once a width plus once (the set-up copies and
    the incumbent): a frontier tensor read inside the loop would."""
    tags = turbo_read_lines()
    out = {"round": 0, "chunk": 0, "turbo_setup": 0, "ipm_and_rest": 0}
    for site, n in sites:
        name, line = site.rsplit(":", 1)
        if name != "turbo.py":
            out["ipm_and_rest"] += n
        elif int(line) in tags:
            out[tags[int(line)]] += n
        else:
            if n > widths + 1:
                raise AssertionError(f"turbo: {n} host syncs at {site}, "
                                     f"an untagged line, in {rounds} rounds")
            out["turbo_setup"] += n
    if out["round"] > 3 * rounds or out["chunk"] != chunks:
        raise AssertionError(f"turbo: host reads {out} in {rounds} rounds "
                             f"and {chunks} chunks")
    return {**out, "turbo_reads_per_round": out["round"] / rounds,
            "ipm_syncs_per_round": out["ipm_and_rest"] / rounds}


def psd_probe_check(points) -> dict:
    """#1 against its plain version on psd_feasible's real inputs: every
    candidate point's shifted float32 stacks (turbo.probe_stacks) through
    kernels.cholesky_lanes and kernels.cholesky_lanes_plain; the NaN flag
    of each matrix must be equal.  A point where they differ fails the
    phase, logged with its lambda_min (float64).  Returns the counts and
    the point nearest the edge."""
    nmat = npts = 0
    nearest = np.inf
    bad = []
    for data, yc, chktol in points:
        for t, Zs in enumerate(turbo.probe_stacks(data, yc, chktol)):
            flat = Zs.reshape(-1, *Zs.shape[-2:]).contiguous()
            fk = torch.isnan(kernels.cholesky_lanes(flat)).flatten(1).any(1)
            fp = torch.isnan(kernels.cholesky_lanes_plain(flat)).flatten(
                1).any(1)
            lam = torch.linalg.eigvalsh(flat.double())[:, 0]
            nearest = min(nearest, float(lam.abs().min()))
            for i in torch.nonzero(fk != fp).flatten().tolist():
                bad.append({"bucket": t, "matrix": i,
                            "kernel_psd": not bool(fk[i]),
                            "plain_psd": not bool(fp[i]),
                            "lambda_min": float(lam[i])})
            nmat += flat.shape[0]
        npts += yc.shape[0]
    if bad:
        log("turbo_probe_mismatch", mismatches=bad[:20], count=len(bad))
        raise AssertionError(f"turbo: cholesky_lanes and its plain version "
                             f"disagree on {len(bad)} of {nmat} candidate "
                             f"matrices")
    return {"points": npts, "matrices": nmat,
            "nearest_lambda_min_to_edge": nearest}


def turbo_phase(card: str, host_tree: dict) -> dict:
    """The device-resident tree (``core/turbo.py``).  A small CLS with
    ``bb.turbo="on"`` on the card and on the CPU: the same status and
    optimum within BB_REL.  Then cls_32 at B=32, default settings ("auto"
    engages turbo at once on the card) and the node cap, every launch
    counter set to 0 just before and read just after: ``solve_turbo`` ran
    and did not bail, OPTIMAL within BB_REL of BB_OPTIMUM, the incumbent
    feasible, #1 launched in the IPM and in ``psd_feasible``; the tree
    beside the host loop's (``host_tree``); tree_profile of the same
    solve, its host syncs by kind (turbo_syncs).  Then mkp_12 at B=8
    through ``solve_turbo`` (no bail, the optimum 30.0), and #1 against
    its plain version on every candidate point of the cls_32 tree
    (psd_probe_check).  Returns the counts of the cls_32 run and its
    summary."""
    small = cardinality_least_squares(*BB_SMALL[:3], seed=BB_SMALL[3])
    res = {}
    for dev in ("cuda", "cpu"):
        with TurboSpy() as spy:
            t0 = time.perf_counter()
            out = solve_misdp(small, bb_settings(turbo="on"), device=dev)
            res[dev] = bb_summary(out, time.perf_counter() - t0)
        tres = spy.results["solve_turbo"]
        if len(tres) != 1 or tres[0] is None:
            raise AssertionError(f"turbo small CLS on {dev}: solve_turbo "
                                 f"results {tres}")
    ref, out = res["cpu"], res["cuda"]
    if out["status"] != ref["status"] or abs(
            out["objval"] - ref["objval"]) > BB_REL * abs(ref["objval"]):
        raise AssertionError(f"turbo small CLS: {out} on the card, {ref} "
                             f"on the CPU")
    log("turbo_cpu_reference", instance="cls_10x20", card=out, cpu=ref)

    prob = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    settings = bb_settings(batch_size=BB_BATCH, node_limit=BB_NODE_CAP)
    spies = []

    def run():
        with TurboSpy() as spy:
            spies.append(spy)
            return solve_misdp(prob, settings)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    spy = spies[0]
    summary = bb_summary(out, wall)
    if len(spy.results["solve_turbo"]) != 1 or \
            spy.results["solve_turbo"][0] is None:
        raise AssertionError(f"turbo cls_32: solve_turbo results "
                             f"{spy.results['solve_turbo']}, want one that "
                             f"did not bail")
    if out.status.name != "OPTIMAL" or abs(
            out.objval - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
        raise AssertionError(f"turbo cls_32: {summary}, want OPTIMAL at "
                             f"{BB_OPTIMUM}")
    viol = incumbent_violation(prob, out.best_y)
    if not all(v <= settings.bb.feastol for v in viol.values()):
        raise AssertionError(f"turbo cls_32: incumbent infeasible: {viol}")
    psd_launches = spy.launches["psd_feasible"]
    ipm_launches = launches["cholesky_lanes"] - psd_launches
    if psd_launches == 0 or ipm_launches <= 0:
        raise AssertionError(f"turbo cls_32: cholesky_lanes launched "
                             f"{psd_launches} times in psd_feasible, "
                             f"{ipm_launches} in the IPM")
    tres = spy.results["solve_turbo"][0]
    prof = tree_profile(run)
    sync_spy = spies[-1]
    syncs = turbo_syncs(prof["sync_sites"],
                        sync_spy.results["solve_turbo"][0].rounds,
                        sync_spy.chunks, len(sync_spy.widths))
    idle = 1.0 - 1e-6 * prof["device_busy_us"] / wall
    log("turbo_solve", instance="cls_32", batch=BB_BATCH,
        node_cap=BB_NODE_CAP, card=card, **summary,
        rounds=tres.rounds, chunks=spy.chunks, widths=spy.widths,
        nsolves=tres.nsolves, nheur=tres.nheur,
        rel_err_vs_jax_optimum=abs(out.objval - BB_OPTIMUM) / BB_OPTIMUM,
        incumbent_violation=viol, launches=launches,
        cholesky_lanes_ipm=ipm_launches,
        cholesky_lanes_psd_feasible=psd_launches,
        psd_feasible_calls=spy.calls["psd_feasible"],
        cholesky_lanes_per_round=launches["cholesky_lanes"] / tres.rounds,
        host_syncs_per_round=prof["host_syncs"] / tres.rounds,
        syncs_by_kind=syncs, device_idle_share=idle, **prof,
        host_loop=host_tree, wall_host_over_turbo=host_tree["wall_s"] / wall)

    mkp = min_k_partition(*TURBO_MKP[:3], seed=TURBO_MKP[3])
    dense = densify(mkp)
    m = dense.nvars
    ms = bb_settings(batch_size=TURBO_MKP_BATCH)
    t0 = time.perf_counter()
    mres = turbo.solve_turbo(dense, mkp, ms, mkp.lb[:m], mkp.ub[:m], np.inf,
                             None, rounds_per_dispatch=ms.bb.turbo_rounds)
    mwall = time.perf_counter() - t0
    if mres is None or abs(mres.inc_val - TURBO_MKP_OPTIMUM) > 1e-4 * max(
            1.0, TURBO_MKP_OPTIMUM):
        raise AssertionError(f"turbo mkp_12: {mres}, want "
                             f"{TURBO_MKP_OPTIMUM} without a bail")
    log("turbo_mkp", instance="mkp_12", batch=TURBO_MKP_BATCH, wall_s=mwall,
        inc_val=mres.inc_val, dual_bound=mres.dual_bound, nodes=mres.nodes,
        rounds=mres.rounds, nsolves=mres.nsolves,
        rung_solves=mres.nsolves - mres.rounds, iters=mres.iters,
        nheur=mres.nheur, nunsolved=mres.nunsolved,
        nodes_per_s=mres.nodes / mwall)

    log("turbo_probe_check", instance="cls_32", card=card,
        psd_feasible_calls=len(spy.points), **psd_probe_check(spy.points))
    return launches, {**summary, "rounds": tres.rounds}


# the probing path (core/probing.py) and the LP path (solve_sdps=0, with
# ops/cuts.py) on cls_32; the LP path also on mkp_12 to its optimum
PROBE_BOXES = 32                   # the request boxes of the functions
DIVE_FREE = 6                      # binaries left free in a dive box
PROBE_OBJ_TOL = 1e-4               # card against CPU, relative (the tests')
PROBE_TREE_CAP = 8                 # node cap of the in-tree probing tree
LP_NODE_CAP = 4000
LP_TIME_LIMIT = 300.0              # seconds; PERF.md says where it stops
EIGH_BATCHES = (1, 32)             # batched float64 eigh at n = 65


def counted_call(label, fn, card) -> tuple:
    """(output, record) of one call of ``fn`` on the card in CUDA sync
    debug mode: its wall (the debug mode's warnings cost microseconds a
    sync), the batched IPM solves and #1 launches inside it and its host
    syncs (sync_sites)."""
    with CallSpy(sdpi_module, ("ipm_solve",), timed=False) as spy:
        l0 = kernels.cholesky_lanes.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_sites() as syncs:
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.cholesky_lanes.launches - l0
    rec = {"function": label, "wall_s": wall,
           "solves": spy.calls["ipm_solve"], "cholesky_lanes": launches,
           "host_syncs": len(syncs), "card": card}
    return out, rec


def dive_boxes(prob, B: int, nfeat: int, free: int, rng):
    """B boxes that fix all but ``free`` of the binary z variables to 0
    (a random set each), so a dive of at most 8 fixings ends integral."""
    lb, ub = np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1))
    for s in range(B):
        fixed = nfeat + rng.permutation(nfeat)[free:]
        lb[s, fixed] = ub[s, fixed] = 0.0
    return lb, ub


def probing_functions(card, prob, dense, ipm) -> dict:
    """Each function of core/probing.py on cls_32 on the card, held to the
    same call on the CPU with the card's IPM settings on the same inputs:
    ``slater_check`` and ``analytic_center`` on the root box and the
    request boxes (flags equal; every center feasible by
    ``check_points``), ``obbt_root`` over the binaries and, with the
    optimum as a cutoff row, over the continuous variables (tightenings
    equal, bounds within 1e-6), ``fracdive`` on the dive boxes from the
    card's relaxation points (flags equal, at least one point found, each
    passing incumbent_violation in its box, objectives within
    PROBE_OBJ_TOL), ``inner_lp_point`` as the root heuristic calls it and
    from the root relaxation's k largest z (ok flags equal; a feasible
    point within 1e-3 of the CPU's and passing incumbent_violation), and
    ``rounding_problem`` from the card's root X and y (the same action; a
    warm point's objective within PROBE_OBJ_TOL).  Returns the OBBT
    bounds."""
    m = prob.nvars
    nfeat, _, k = BB_INSTANCE[:3]
    lb, ub = node_boxes(prob, PROBE_BOXES, nfeat, np.random.default_rng(4))
    s = Settings(ipm=ipm)
    ifaces = {"cuda": SDPInterface(dense, s),
              "cpu": SDPInterface(dense, s, device="cpu")}
    card_iface = ifaces["cuda"]
    recs = []

    def both(label, make):
        out, rec = counted_call(label, lambda: make(card_iface), card)
        recs.append(rec)
        return out, make(ifaces["cpu"])

    def same_obj(label, y, y_cpu):
        a, b = prob.obj @ y, prob.obj @ y_cpu
        if abs(a - b) > PROBE_OBJ_TOL * (1 + abs(b)):
            raise AssertionError(f"probing {label}: objective {a} on the "
                                 f"card, {b} on the CPU")

    sl, sl_cpu = both("slater_check",
                      lambda i: probing.slater_check(i, lb, ub))
    if not np.array_equal(sl, sl_cpu):
        raise AssertionError(f"probing slater_check: {sl} on the card, "
                             f"{sl_cpu} on the CPU")
    (ac_y, ac_ok), (_, ac_ok_cpu) = both(
        "analytic_center", lambda i: probing.analytic_center(i, lb, ub))
    feas = check_points(card_iface.data, ac_y, lb, ub,
                        feastol=ipm.feastol)[0].cpu().numpy()
    if not np.array_equal(ac_ok, ac_ok_cpu) or not feas[ac_ok].all():
        raise AssertionError(f"probing analytic_center: ok {ac_ok} on the "
                             f"card, {ac_ok_cpu} on the CPU; feasible "
                             f"{feas}")
    feastol = Settings().bb.feastol
    obbt = {}
    for label, targets, cutoff in (
            ("obbt_root int", np.flatnonzero(prob.integral), None),
            ("obbt_root cont cutoff",
             np.flatnonzero(~prob.integral), BB_OPTIMUM * (1 + BB_REL))):
        (lo, hi, nt), (lo_c, hi_c, nt_c) = both(
            label, lambda i: probing.obbt_root(i, prob.lb, prob.ub, targets,
                                               cutoff, BB_BATCH, feastol))
        fin = (np.abs(lo_c) < 1e19) & (np.abs(hi_c) < 1e19)
        dev = float(max(np.abs(lo - lo_c)[np.abs(lo_c) < 1e19].max(),
                        np.abs(hi - hi_c)[np.abs(hi_c) < 1e19].max()))
        if nt != nt_c or dev > 1e-6:
            raise AssertionError(f"probing {label}: {nt} tightenings on the "
                                 f"card, {nt_c} on the CPU, bounds apart "
                                 f"by {dev}")
        recs[-1].update(tightenings=nt, max_bound_dev=dev,
                        finite_bounds=int(fin.sum()))
        obbt[label] = (lo, hi)

    dlb, dub = dive_boxes(prob, PROBE_BOXES, nfeat, DIVE_FREE,
                          np.random.default_rng(5))
    res = card_iface.solve_batch(dlb, dub)
    ok = np.isin(res.status, (int(SolverResultStatus.OPTIMAL),
                              int(SolverResultStatus.PRESOLVED_OPTIMAL)))
    (yd, fd), (yd_cpu, fd_cpu) = both(
        "fracdive", lambda i: probing.fracdive(
            i, dlb, dub, res.y, prob.integral, feastol, start_ok=ok))
    if not np.array_equal(fd, fd_cpu) or not fd.any():
        raise AssertionError(f"probing fracdive: feasible {fd} on the card, "
                             f"{fd_cpu} on the CPU; want equal, one or more")
    for i in np.flatnonzero(fd):
        viol = incumbent_violation(prob, yd[i])
        if max(viol.values()) > feastol or np.any(yd[i] < dlb[i] - feastol) \
                or np.any(yd[i] > dub[i] + feastol):
            raise AssertionError(f"probing fracdive: point {i} reported "
                                 f"feasible, violation {viol}")
        same_obj(f"fracdive point {i}", yd[i], yd_cpu[i])
    recs[-1].update(feasible=int(fd.sum()), started=int(ok.sum()),
                    free_binaries=DIVE_FREE)

    root = card_iface.solve_batch(prob.lb[None], prob.ub[None])
    z = np.flatnonzero(prob.integral)
    y_top = np.zeros(m)
    y_top[z[np.argsort(-root.y[0][z])[:k]]] = 1.0
    for label, y_ref in (("inner_lp_point", None),
                         ("inner_lp_point top-k z", y_top)):
        (y_in, ok_in), (y_in_cpu, ok_in_cpu) = both(
            label, lambda i: probing.inner_lp_point(prob, s, y_ref=y_ref,
                                                    device=i.device))
        if ok_in != ok_in_cpu:
            raise AssertionError(f"probing {label}: feasible {ok_in} on the "
                                 f"card, {ok_in_cpu} on the CPU")
        dev = None
        if ok_in:
            viol = incumbent_violation(prob, y_in)
            dev = float(np.abs(y_in - y_in_cpu).max())
            if max(viol.values()) > feastol or dev > 1e-3:
                raise AssertionError(f"probing {label}: violation {viol}, "
                                     f"{dev} from the CPU's point")
        recs[-1].update(feasible=bool(ok_in), max_dev_vs_cpu=dev,
                        lp_variables=m + sum(b.size * (b.size - 1) // 2
                                             for b in prob.blocks))

    X = bb_module._Solver.buckets_to_blocks(
        card_iface.data, [np.asarray(x[0]) for x in root.X])
    (act, wy), (act_cpu, wy_cpu) = both(
        "rounding_problem", lambda i: probing.rounding_problem(
            prob, dense, s, X, root.y[0], prob.lb, prob.ub,
            feastol=feastol, device=i.device))
    if act != act_cpu:
        raise AssertionError(f"probing rounding_problem: {act} on the card, "
                             f"{act_cpu} on the CPU")
    if act == "ok":
        same_obj("rounding_problem", wy, wy_cpu)
    recs[-1].update(action=act, warm_objective=(
        None if wy is None else float(prob.obj @ wy)))
    for rec in recs:
        log("probing_function", instance="cls_32", boxes=PROBE_BOXES,
            slater=sl.tolist() if rec["function"] == "slater_check"
            else None, **rec)
    return obbt


def probing_phase(card: str) -> dict:
    """The probing path.  Each function of ``core/probing.py`` on cls_32's
    root box and request boxes (probing_functions).  Then, every launch
    counter set to 0 just before and read just after, two trees through
    ``solve_misdp`` on the card: the root options (inner-LP heuristic,
    OBBT, analytic-center warm starts) at "auto": turbo engages, OPTIMAL
    within BB_REL of BB_OPTIMUM, the incumbent feasible and inside the
    OBBT bounds; and the in-tree options (Slater statistics, diving, OBBT,
    rounding-problem warm starts) in the host loop under PROBE_TREE_CAP:
    every bound at most the optimum, any incumbent feasible.  Returns the
    counts."""
    prob = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    dense = densify(prob)
    ipm = resolve_backend_autos(Settings(), torch.device("cuda")).ipm
    obbt = probing_functions(card, prob, dense, ipm)
    names = ("inner_lp_point", "analytic_center", "obbt_root", "slater_check",
             "slater_check_primal", "fracdive", "rounding_problem")
    feastol = Settings().bb.feastol

    reset_counts()
    root = bb_settings(batch_size=BB_BATCH, node_limit=BB_NODE_CAP,
                       heuristic_innerlp=True, obbt_at_root=True,
                       warmstart=True, warmstartiptype=2)
    with TurboSpy() as tspy, CallSpy(probing, names) as pspy:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve_misdp(prob, root)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    root_launches = counts()
    summary = bb_summary(out, wall)
    tres = tspy.results["solve_turbo"]
    if len(tres) != 1 or tres[0] is None:
        raise AssertionError(f"probing root options: solve_turbo results "
                             f"{tres}, want one that did not bail")
    if out.status.name != "OPTIMAL" or abs(
            out.objval - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
        raise AssertionError(f"probing root options: {summary}")
    viol = incumbent_violation(prob, out.best_y)
    if max(viol.values()) > feastol:
        raise AssertionError(f"probing root options: incumbent infeasible: "
                             f"{viol}")
    for label, (lo, hi) in obbt.items():
        if np.any(out.best_y < lo - feastol) or np.any(
                out.best_y > hi + feastol):
            raise AssertionError(f"probing {label}: the bounds cut off the "
                                 f"optimum")
    probing_wall = sum(pspy.wall.values())
    log("probing_root_tree", instance="cls_32", batch=BB_BATCH, card=card,
        **summary, incumbent_violation=viol, turbo_rounds=tres[0].rounds,
        probing_calls=pspy.calls, probing_wall_s=pspy.wall,
        probing_share_of_wall=probing_wall / wall, launches=root_launches)

    intree = bb_settings(batch_size=BB_BATCH, node_limit=PROBE_TREE_CAP,
                         turbo="off", slatercheck=1, diving_freq=2,
                         obbt_freq=2, warmstart=True, warmstartproject=4)
    with CallSpy(probing, names) as pspy:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve_misdp(prob, intree)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    st = out.stats
    summary = bb_summary(out, wall)
    if out.dual_bound > BB_OPTIMUM * (1 + BB_REL):
        raise AssertionError(f"probing in-tree options: bound "
                             f"{out.dual_bound} above the optimum")
    viol = None
    if out.best_y is not None:
        viol = incumbent_violation(prob, out.best_y)
        if max(viol.values()) > feastol or out.objval < BB_OPTIMUM * (
                1 - BB_REL):
            raise AssertionError(f"probing in-tree options: incumbent "
                                 f"{out.objval} infeasible: {viol}")
    if launches["cholesky_lanes"] == 0:
        raise AssertionError("probing: cholesky_lanes not launched")
    log("probing_intree_tree", instance="cls_32", batch=BB_BATCH,
        node_cap=PROBE_TREE_CAP, card=card, **summary,
        incumbent_violation=viol,
        slater=[st.slater_holds, st.slater_fails, st.slater_undecided],
        slater_primal=[st.slater_primal_holds, st.slater_primal_fails,
                       st.slater_primal_undecided],
        roundingprobinf=st.roundingprobinf,
        redcost_tightenings=st.redcost_tightenings,
        probing_calls=pspy.calls, probing_wall_s=pspy.wall,
        probing_share_of_wall=sum(pspy.wall.values()) / wall,
        launches={k: v - root_launches[k] for k, v in launches.items()})
    return launches


def cut_check(card, prob) -> None:
    """``separate_eigenvector_cuts`` at cls_32's root LP point on the card
    against the CPU: the same ``valid`` flags, eigenvalues within
    1e-9 (1 + |lam|), each valid cut within 1e-7 relative (a repeated
    eigenvalue's cuts as their sum over the eigenspace, which is the same
    whichever way it is split); both timed, and float64 ``eigh`` at n = 65
    for EIGH_BATCHES matrices."""
    lp = MISDP(nvars=prob.nvars, obj=prob.obj, lb=prob.lb, ub=prob.ub,
                 integral=prob.integral, blocks=[], lp=prob.lp,
                 name=prob.name + "_lp")
    lp_iface = SDPInterface(densify(lp), device="cpu", lp_host=True)
    y = lp_iface.solve_batch(prob.lb[None], prob.ub[None]).y
    dense = densify(prob)
    out = {}
    for dev in ("cuda", "cpu"):
        data = build_ipm_data(dense, dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sep = sdpi_module.to_host(separate_eigenvector_cuts(data, y))[0]
            times.append(time.perf_counter() - t0)
        out[dev] = (sep, float(np.median(times)))
    (sep, ms), (ref, ms_cpu) = out["cuda"], out["cpu"]
    nvalid = 0
    for t in range(len(ref.lam)):
        lam = ref.lam[t]
        if not np.array_equal(sep.valid[t], ref.valid[t]) or np.any(
                np.abs(sep.lam[t] - lam) > 1e-9 * (1 + np.abs(lam))):
            raise AssertionError("lpmode cuts: flags or eigenvalues differ "
                                 "between the card and the CPU")
        for i, k in np.ndindex(*lam.shape[:2]):
            lk = lam[i, k]
            groups = np.split(np.arange(lk.size), np.flatnonzero(
                np.diff(lk) > 1e-8 * (1 + np.abs(lk[1:]))) + 1)
            for g in groups:
                if not ref.valid[t][i, k, g].any():
                    continue
                nvalid += len(g)
                for a, b in ((sep.coefs[t], ref.coefs[t]),
                             (sep.rhs[t], ref.rhs[t])):
                    ga, gb = a[i, k, g].sum(axis=0), b[i, k, g].sum(axis=0)
                    if np.abs(ga - gb).max() > 1e-7 * (1 + np.abs(gb).max()):
                        raise AssertionError("lpmode cuts: coefficients "
                                             "differ between the card and "
                                             "the CPU")
    eigh_ms = eigh_times(dense.blocksize)
    log("lpmode_cuts", instance="cls_32", card=card, valid_cuts=nvalid,
        separate_ms_card=1e3 * ms, separate_ms_cpu=1e3 * ms_cpu,
        eigh_float64_ms=eigh_ms, n=dense.blocksize,
        eigh_ms_per_matrix={nb: v / nb for nb, v in eigh_ms.items()})


def eigh_times(n: int) -> dict:
    """Device ms of one batched float64 ``torch.linalg.eigh`` of
    EIGH_BATCHES symmetric n x n matrices, after a warm-up call: a time
    that grows with the batch as B single calls do shows a loop of
    per-matrix solver calls."""
    out = {}
    for nb in EIGH_BATCHES:
        M = torch.randn(nb, n, n, dtype=torch.float64, device="cuda")
        M = M + M.transpose(1, 2)
        torch.linalg.eigh(M)
        out[nb] = event_ms(torch.linalg.eigh, (M,))
    return out


def lpmode_phase(card: str) -> dict:
    """The LP path (``solve_sdps=0``).  cut_check, then, every launch
    counter set to 0 just before and read just after, cls_32 at B=32 and
    LP_NODE_CAP through ``solve_misdp`` on the card: OPTIMAL within BB_REL
    of BB_OPTIMUM, or (at the node cap or LP_TIME_LIMIT) a bound at most
    the optimum and any incumbent feasible; the walls of HiGHS, the cut
    separation (einsum, ``eigh``, one transfer) and the rest; #1 from the
    exact enforcement solves.  Then mkp_12 at B=8 to its optimum 30.0.
    Returns the counts."""
    prob = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    cut_check(card, prob)
    feastol = Settings().bb.feastol
    lp_settings = dataclasses.replace(
        bb_settings(batch_size=BB_BATCH, node_limit=LP_NODE_CAP,
                    time_limit=LP_TIME_LIMIT), solve_sdps=0)

    def run(p, s):
        with CallSpy(sdpi_module.SDPInterface, ("_solve_batch_lp_host",)) \
                as hspy, CallSpy(bb_module,
                                 ("separate_eigenvector_cuts",)) as cspy:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve_misdp(p, s)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = out.stats
        highs = hspy.wall["_solve_batch_lp_host"]
        sep = cspy.wall["separate_eigenvector_cuts"]
        return out, {**bb_summary(out, wall), "sep_rounds": st.sep_rounds,
                     "ncuts": st.ncuts, "ncuts_dropped": st.ncuts_dropped,
                     "nenforce_sdp": st.nenforce_sdp,
                     "ndropped_nodes": st.ndropped_nodes,
                     "highs_wall_s": highs, "separation_wall_s": sep,
                     "separations": cspy.calls["separate_eigenvector_cuts"],
                     "rest_wall_s": wall - highs - sep}

    reset_counts()
    out, summary = run(prob, lp_settings)
    launches = counts()
    if out.status.name == "OPTIMAL":
        if abs(out.objval - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
            raise AssertionError(f"lpmode cls_32: {summary}")
    elif out.dual_bound > BB_OPTIMUM * (1 + BB_REL):
        raise AssertionError(f"lpmode cls_32: bound {out.dual_bound} above "
                             f"the optimum")
    viol = None
    if out.best_y is not None:
        viol = incumbent_violation(prob, out.best_y)
        if max(viol.values()) > feastol:
            raise AssertionError(f"lpmode cls_32: incumbent infeasible: "
                                 f"{viol}")
    if out.stats.nenforce_sdp and launches["cholesky_lanes"] == 0:
        raise AssertionError("lpmode cls_32: enforcement solves launched no "
                             "cholesky_lanes")
    log("lpmode_tree", instance="cls_32", batch=BB_BATCH,
        node_cap=LP_NODE_CAP, time_limit_s=LP_TIME_LIMIT, card=card,
        **summary, incumbent_violation=viol,
        rel_err_vs_jax_optimum=(None if out.objval is None else
                                abs(out.objval - BB_OPTIMUM) / BB_OPTIMUM),
        cholesky_lanes_enforcement=launches["cholesky_lanes"],
        launches=launches)

    mkp = min_k_partition(*TURBO_MKP[:3], seed=TURBO_MKP[3])
    ms = dataclasses.replace(bb_settings(batch_size=TURBO_MKP_BATCH,
                                         node_limit=LP_NODE_CAP),
                             solve_sdps=0)
    mout, msummary = run(mkp, ms)
    if mout.status.name != "OPTIMAL" or abs(
            mout.objval - TURBO_MKP_OPTIMUM) > 1e-4 * TURBO_MKP_OPTIMUM:
        raise AssertionError(f"lpmode mkp_12: {msummary}, want OPTIMAL at "
                             f"{TURBO_MKP_OPTIMUM}")
    all_launches = counts()
    mlaunch = all_launches["cholesky_lanes"] - launches["cholesky_lanes"]
    if mout.stats.nenforce_sdp and mlaunch == 0:
        raise AssertionError("lpmode mkp_12: enforcement solves launched no "
                             "cholesky_lanes")
    log("lpmode_mkp", instance="mkp_12", batch=TURBO_MKP_BATCH, card=card,
        **msummary, incumbent_violation=incumbent_violation(mkp, mout.best_y),
        cholesky_lanes_enforcement=mlaunch)
    return all_launches


# the file entry points (the cli path): the port's writers and readers on
# cls_32 and cls_64, and ``python -m scipsdp_tpu_torch`` on the card, in
# process and as a subprocess
CLI_CLS64 = (64, 128, 12, 5)       # nfeatures, nsamples, k, seed
CLI_SET = ("branching/sdpmostfrac/priority = 3000000\n"
           "relaxing/SDP/warmstart = TRUE\n"
           f"limits/nodes = {BB_NODE_CAP}\n")
# the presolve's generated row classes (tests/test_write_transformed.py's)
CLI_GEN_SET = "".join(f"constraints/SDP/{k} = TRUE\n" for k in (
    "diaggezerocuts", "twominorlinconss", "diagzeroimplcuts",
    "twominorvarbounds"))


def same_problem(a, b, path="problem") -> None:
    """Raises unless two problems hold the same values: dataclasses field
    by field, arrays exactly (dtype too), containers item by item."""
    if dataclasses.is_dataclass(a):
        if type(a).__name__ != type(b).__name__:
            raise AssertionError(f"{path}: {type(a)} against {type(b)}")
        for f in dataclasses.fields(a):
            same_problem(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{path}: arrays differ")
    elif isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            raise AssertionError(f"{path}: {len(a)} against {len(b)} items")
        for i, (x, y) in enumerate(zip(a, b)):
            same_problem(x, y, f"{path}[{i}]")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} against {b!r}")


def flat_fields(settings) -> dict:
    """Every field of a settings tree, as "section.field" -> value."""
    out = {}
    for k, v in dataclasses.asdict(settings).items():
        if isinstance(v, dict):
            out.update({f"{k}.{f}": x for f, x in v.items()})
        else:
            out[k] = v
    return out


def write_formats(prob, stem: pathlib.Path) -> dict:
    """``prob`` written by the port's writers as .dat-s, .cbf and .cip,
    and the .dat-s file compressed as .dat-s.gz: format -> path."""
    paths = {}
    for fmt, write in ((".dat-s", write_sdpa), (".cbf", write_cbf),
                       (".cip", write_cip)):
        paths[fmt] = str(stem) + fmt
        write(prob, paths[fmt])
    paths[".dat-s.gz"] = paths[".dat-s"] + ".gz"
    with open(paths[".dat-s"], "rb") as src, \
            gzip.open(paths[".dat-s.gz"], "wb") as dst:
        shutil.copyfileobj(src, dst)
    return paths


def read_formats(label, paths: dict) -> dict:
    """Each file read back through ``read_problem``, timed, with spies on
    the native tokenizer and the Python SDPA parser: the plain .dat-s
    file must go through the tokenizer only, the .gz one through the
    Python parser; the tokenizer's problem must equal the Python
    parser's (itself timed on the plain file).  Returns format -> the
    problem read."""
    probs, rec = {}, {}
    for fmt, path in paths.items():
        with CallSpy(native, ("parse_sdpa_native",), timed=False) as nspy, \
                CallSpy(reader_sdpa, ("_read_sdpa_python",),
                        timed=False) as pspy:
            t0 = time.perf_counter()
            probs[fmt] = read_problem(path)
            ms = 1e3 * (time.perf_counter() - t0)
        tokens = [r is not None for r in nspy.results["parse_sdpa_native"]]
        python = pspy.calls["_read_sdpa_python"]
        want = {".dat-s": ([True], 0), ".dat-s.gz": ([False], 1)}.get(
            fmt, ([], 0))
        if (tokens, python) != want:
            raise AssertionError(f"cli {label}{fmt}: native tokens {tokens}, "
                                 f"Python parses {python}, want {want}")
        rec[fmt] = {"bytes": pathlib.Path(path).stat().st_size,
                    "read_ms": ms, "parser": ("native" if tokens == [True]
                                              else "python")}
    t0 = time.perf_counter()
    slow = reader_sdpa._read_sdpa_python(paths[".dat-s"],
                                         probs[".dat-s"].name)
    rec[".dat-s"]["python_read_ms"] = 1e3 * (time.perf_counter() - t0)
    same_problem(probs[".dat-s"], slow)
    same_problem(probs[".dat-s"], probs[".dat-s.gz"])
    log("cli_read", instance=label, nvars=probs[".dat-s"].nvars,
        lp_rows={f: p.lp.nrows for f, p in probs.items()}, files=rec)
    return probs


def cli_result(text: str) -> dict:
    """The status, objective, bound and gap lines the CLI printed."""
    keys = {"SCIP-SDP-TPU status": "status", "objective value": "objval",
            "dual bound": "dual_bound", "gap": "gap"}
    out = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        if key.strip() in keys:
            value = value.strip()
            out[keys[key.strip()]] = (value if key.startswith("SCIP")
                                      else float(value))
    return out


def cli_solve(argv, syncs=False) -> dict:
    """``__main__.main(argv)`` in this process, its stdout captured, with
    spies on ``solve_misdp`` (its result, settings and #1 launches) and
    on turbo; in CUDA sync debug mode when ``syncs``.  Raises unless it
    returns 0."""
    buf = io.StringIO()
    with CallSpy(bb_module, ("solve_misdp",), timed=False) as spy, \
            TurboSpy() as tspy, contextlib.redirect_stdout(buf):
        with (sync_sites() if syncs else contextlib.nullcontext([])) as \
                sites:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}\n{buf.getvalue()}")
    res = spy.results["solve_misdp"][0]
    (_, settings), _ = spy.args["solve_misdp"][0]
    turbo_res = tspy.results["solve_turbo"]
    return {"argv": argv, "wall_s": wall, "text": buf.getvalue(),
            "printed": cli_result(buf.getvalue()), "result": res,
            "settings": settings,
            "nodes": res.stats.nodes, "relax_solves": res.stats.relax_solves,
            "turbo_rounds": (turbo_res[0].rounds if turbo_res
                             and turbo_res[0] is not None else None),
            "cholesky_lanes": spy.launches["solve_misdp"],
            "host_syncs": len(sites) if syncs else None}


def check_optimum(label, run, prob, optimum, feastol) -> dict:
    """The printed status OPTIMAL and objective within BB_REL of
    ``optimum``; the incumbent feasible in ``prob`` by
    incumbent_violation.  Returns the run's summary for the log."""
    got = run["printed"]
    if got.get("status") != "OPTIMAL" or abs(
            got["objval"] - optimum) > BB_REL * abs(optimum):
        raise AssertionError(f"cli {label}: printed {got}, want OPTIMAL at "
                             f"{optimum}")
    viol = incumbent_violation(prob, run["result"].best_y)
    if max(viol.values()) > feastol:
        raise AssertionError(f"cli {label}: incumbent infeasible: {viol}")
    return {k: run[k] for k in ("wall_s", "nodes", "relax_solves",
                                "turbo_rounds", "cholesky_lanes",
                                "host_syncs")} | {
        "printed": got, "incumbent_violation": viol,
        "rel_err_vs_jax_optimum": abs(got["objval"] - optimum) / optimum}


def cli_subprocess(argv) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "scipsdp_tpu_torch", *argv],
                          capture_output=True, text=True, timeout=300,
                          cwd=pathlib.Path(__file__).resolve().parent)


def cli_phase(card: str, turbo_tree: dict) -> dict:
    """The file entry points (the cli path), every launch counter set to
    0 just before and read just after.  cls_32 and cls_64 written by the
    port's writers as .dat-s, .dat-s.gz, .cbf and .cip and read back
    (read_formats).  Then ``python -m scipsdp_tpu_torch`` in process:
    the cls_32 .dat-s, .cbf and .cip files at ``--batch-size 32`` to
    OPTIMAL at BB_OPTIMUM with a feasible incumbent, beside the turbo
    phase's in-memory tree (``turbo_tree``; the writers re-encode bounds
    as LP rows, so the trees may differ: optima are compared, not node
    counts), the .dat-s run again in CUDA sync debug mode for its host
    syncs; ``--settings`` with a .set file this phase writes (the loaded
    settings field by field, the tree's optimum); ``--slater --node-limit
    1 --write-transformed`` with the presolve's generated row classes
    set on (CLI_GEN_SET) on the card and with ``--cpu`` (the same two
    Slater lines, the same file, which reads back with the presolved
    problem's variables and its generated rows); mkp_12 ``--lp-approx``
    to 30.0; cls_64 ``--node-limit 1`` (the root bound).  Last, two
    subprocesses: the cls_32 .dat-s file (exit 0, the objective printed)
    and ``--mesh`` (one card: no mesh, the same optimum).  Returns the
    counts."""
    feastol = Settings().bb.feastol
    cls32 = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    cls64 = cardinality_least_squares(*CLI_CLS64[:3], seed=CLI_CLS64[3])
    mkp = min_k_partition(*TURBO_MKP[:3], seed=TURBO_MKP[3])
    t0 = time.perf_counter()
    if native.get_sdpa_lib() is None:
        raise AssertionError("cli: the SDPA tokenizer did not build (g++)")
    log("cli_build", tokenizer_build_s=time.perf_counter() - t0,
        library=str(native.library_path(native._SRC_PATH,
                                        "libsdpaparse.so")))
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        files = {"cls_32": write_formats(cls32, tmp / "cls_32"),
                 "cls_64": write_formats(cls64, tmp / "cls_64")}
        probs = {k: read_formats(k, v) for k, v in files.items()}
        if probs["cls_32"][".cip"].lp.nrows != cls32.lp.nrows:
            raise AssertionError("cli cls_32.cip: LP rows changed")

        trees = {}
        for fmt in (".dat-s", ".cbf", ".cip"):
            run = cli_solve([files["cls_32"][fmt], "--batch-size",
                             str(BB_BATCH), "-q"])
            trees[fmt] = check_optimum(f"cls_32{fmt}", run,
                                       probs["cls_32"][fmt], BB_OPTIMUM,
                                       feastol)
        run = cli_solve([files["cls_32"][".dat-s"], "--batch-size",
                         str(BB_BATCH), "-q"], syncs=True)
        trees[".dat-s"]["host_syncs"] = run["host_syncs"]
        log("cli_trees", instance="cls_32", batch=BB_BATCH, card=card,
            trees=trees, turbo_phase_tree=turbo_tree)

        setfile = tmp / "tree.set"
        setfile.write_text(CLI_SET)
        run = cli_solve([files["cls_32"][".dat-s"], "--batch-size",
                         str(BB_BATCH), "-q", "--settings", str(setfile)])
        want = Settings(
            ipm=IPMSettings(gaptol=1e-5, feastol=1e-5),
            bb=BBSettings(feastol=1e-5, node_limit=BB_NODE_CAP,
                          time_limit=1e20, batch_size=BB_BATCH,
                          branching_rule="mostfrac", warmstart=True))
        got = flat_fields(run["settings"])
        wrong = {k: (v, got[k]) for k, v in flat_fields(want).items()
                 if got[k] != v}
        if wrong:
            raise AssertionError(f"cli --settings: fields {wrong}")
        log("cli_settings", instance="cls_32", card=card, set_file=CLI_SET,
            **check_optimum("cls_32 --settings", run, probs["cls_32"][
                ".dat-s"], BB_OPTIMUM, feastol))

        slater = {}
        genfile = tmp / "gen.set"
        genfile.write_text(CLI_GEN_SET)
        for dev, extra in (("cuda", []), ("cpu", ["--cpu"])):
            out = str(tmp / f"transformed_{dev}.cbf")
            run = cli_solve([files["cls_32"][".dat-s"], "--batch-size",
                             str(BB_BATCH), "-q", "--slater",
                             "--node-limit", "1", "--settings", str(genfile),
                             "--write-transformed", out, *extra])
            slater[dev] = ([ln for ln in run["text"].splitlines()
                            if "Slater condition" in ln],
                           pathlib.Path(out).read_bytes(), run["wall_s"])
        if slater["cuda"][:2] != slater["cpu"][:2] or \
                len(slater["cuda"][0]) != 2:
            raise AssertionError(f"cli --slater: {slater['cuda'][0]} on the "
                                 f"card, {slater['cpu'][0]} on the CPU "
                                 f"(transformed files equal: "
                                 f"{slater['cuda'][1] == slater['cpu'][1]})")
        presolved = presolve_problem(probs["cls_32"][".dat-s"],
                                     run["settings"])
        back = read_problem(str(tmp / "transformed_cuda.cbf"))
        rows = transformed_for_write(presolved).lp.nrows
        if back.nvars != presolved.nvars or back.lp.nrows != rows or \
                rows <= probs["cls_32"][".dat-s"].lp.nrows:
            raise AssertionError(f"cli --write-transformed: {back.nvars} "
                                 f"variables, {back.lp.nrows} rows; want "
                                 f"{presolved.nvars}, {rows}")
        log("cli_slater", instance="cls_32", card=card,
            lines=slater["cuda"][0], wall_s={k: v[2] for k, v in
                                             slater.items()},
            transformed={"nvars": back.nvars, "lp_rows": back.lp.nrows,
                         "read_lp_rows": probs["cls_32"][".dat-s"].lp.nrows,
                         "propagation_rows": (
                             0 if presolved.proprows is None
                             else presolved.proprows.nrows)})

        mkp_path = str(tmp / "mkp_12.dat-s")
        write_sdpa(mkp, mkp_path)
        run = cli_solve([mkp_path, "--lp-approx", "--batch-size",
                         str(TURBO_MKP_BATCH), "-q"])
        log("cli_lp_approx", instance="mkp_12", batch=TURBO_MKP_BATCH,
            card=card, **check_optimum("mkp_12 --lp-approx", run,
                                       read_problem(mkp_path),
                                       TURBO_MKP_OPTIMUM, feastol),
            nenforce_sdp=run["result"].stats.nenforce_sdp)

        run = cli_solve([files["cls_64"][".dat-s"], "--batch-size",
                         str(BB_BATCH), "-q", "--node-limit", "1"])
        if run["nodes"] < 1 or not np.isfinite(run["printed"]["dual_bound"]):
            raise AssertionError(f"cli cls_64 root: {run['printed']}")
        log("cli_root", instance="cls_64", card=card,
            **{k: run[k] for k in ("printed", "wall_s", "nodes",
                                   "cholesky_lanes")})
        launches = counts()
        if launches["cholesky_lanes"] == 0:
            raise AssertionError("cli: cholesky_lanes not launched")

        t0 = time.perf_counter()
        proc = cli_subprocess([files["cls_32"][".dat-s"], "-q",
                               "--batch-size", str(BB_BATCH)])
        wall = time.perf_counter() - t0
        printed = cli_result(proc.stdout)
        if proc.returncode != 0 or abs(printed.get("objval", np.inf)
                                       - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
            raise AssertionError(f"cli subprocess: exit {proc.returncode}, "
                                 f"{printed}\n{proc.stderr[-2000:]}")
        mesh = cli_subprocess([files["cls_32"][".dat-s"], "-q",
                               "--batch-size", str(BB_BATCH), "--mesh"])
        mesh_printed = cli_result(mesh.stdout)
        if mesh.returncode != 0 or abs(mesh_printed.get(
                "objval", np.inf) - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
            raise AssertionError(f"cli --mesh: exit {mesh.returncode}, "
                                 f"{mesh_printed}\n{mesh.stderr[-2000:]}")
        log("cli_subprocess", card=card, wall_s=wall, printed=printed,
            mesh_exit=mesh.returncode, mesh_printed=mesh_printed)
    return launches


# the mesh path (parallel/mesh.py): virtual meshes of MESH_SHARDS cuda:0
# entries (one card: the lockstep's cost, not multi-card scaling)
MESH_SHARDS = (2, 4)
MESH_F64_BAR = 1e-9                # dobj, relative to 1 + |dobj|
MESH_REFINE_BAR = 5e-6             # PERF.md §2's float32 bars
MESH_REFINE_ITERS = 3


def virtual_mesh(n: int, axes=("nodes",)):
    """A mesh of n entries of cuda:0."""
    return make_mesh(n, axes, devices=[torch.device("cuda", 0)] * n)


def ipm_read_line() -> int:
    """ops/ipm.py's line of the lockstep's flag read (tagged there)."""
    lines = pathlib.Path(ipm_module.__file__).read_text().splitlines()
    return next(i + 1 for i, line in enumerate(lines)
                if "# host read: the flags" in line)


class Launches:
    """#1 and every other kernel's launches of the calls made through
    ``run``, accumulated; calls made otherwise are not counted."""

    def __init__(self):
        self.total = dict.fromkeys(KERNELS, 0)

    def run(self, fn):
        before = counts()
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            for k, v in counts().items():
                self.total[k] += v - before[k]


def sharded_solves(case, routes, spent: Launches) -> dict:
    """cls_32/direct through ``sharded_solver`` on MESH_SHARDS virtual
    meshes against the unsharded ``ipm_solve`` of the same call, per
    route: float64 with equal statuses and iterations and dobj within
    MESH_F64_BAR, the fused refine route with equal statuses, iterations
    within MESH_REFINE_ITERS and dobj within MESH_REFINE_BAR.  Each
    sharded solve reads its flags once per iteration (the lockstep's one
    host sync): its sync sites hold the tagged read iters + 1 times.
    Returns the walls."""
    label, dense, data, req, _ = case
    read = f"ipm.py:{ipm_read_line()}"
    out = {}
    for route, s in routes.items():
        timed(data, req, s)                      # warm-up
        ref_wall, ref = timed(data, req, s)
        for n in MESH_SHARDS:
            solve = sharded_solver(data, s, virtual_mesh(n))
            spent.run(lambda: solve(*req))       # warm-up
            l0 = kernels.cholesky_lanes.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = spent.run(lambda: solve(*req))
            wall = time.perf_counter() - t0
            l1 = kernels.cholesky_lanes.launches - l0
            with sync_sites() as sites:
                spent.run(lambda: solve(*req))
            reads = sites.count(read)
            if reads != res.iters + 1:
                raise AssertionError(f"mesh {route} x{n}: {reads} flag reads "
                                     f"in {res.iters} iterations")
            if route == "f64":
                dev = agree(f"mesh {route} x{n}", res, ref, s.gaptol,
                            "ipm_solve", iters_tol=0, bar=MESH_F64_BAR)
            else:
                dev = agree(f"mesh {route} x{n}", res, ref, s.gaptol,
                            "ipm_solve", iters_tol=MESH_REFINE_ITERS,
                            bar=MESH_REFINE_BAR)
            if route == "f64" and res.f64_iters != ref.f64_iters:
                raise AssertionError(f"mesh f64 x{n}: f64 iterations "
                                     f"{res.f64_iters} vs {ref.f64_iters}")
            out[f"{route} x{n}"] = wall
            log("mesh_solve", request=label, route=route, shards=n,
                B=int(res.status.shape[0]), iters=res.iters,
                unsharded_iters=ref.iters, f64_iters=res.f64_iters,
                max_rel_dobj_vs_unsharded=dev, wall_s=wall,
                unsharded_wall_s=ref_wall, cholesky_lanes=l1,
                flag_reads_per_iteration=reads / (res.iters + 1),
                host_syncs=len(sites),
                host_syncs_per_iteration=len(sites) / res.iters,
                sync_sites=sorted(collections.Counter(sites).items()))
    return out


def mesh_trees(card, spent: Launches, host_tree, turbo_tree) -> dict:
    """cls_32 at B=32 through ``solve_misdp(use_mesh=True,
    mesh_devices=n)`` with the solver's mesh made a virtual one: the host
    loop (turbo="off": every batch through ``SDPInterface(mesh=...)``'s
    ladder) and turbo ("auto": ``solve_turbo(mesh=...)``, width fixed at
    B), each OPTIMAL at BB_OPTIMUM within BB_REL with a feasible
    incumbent; nodes, rounds, wall and #1 beside the unsharded trees of
    bb_phase and turbo_phase."""
    prob = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    trees = {}
    real = bb_module.make_mesh
    bb_module.make_mesh = lambda n, axes, device=None: virtual_mesh(n, axes)
    try:
        for engine in ("off", "auto"):
            for n in MESH_SHARDS:
                s = dataclasses.replace(
                    bb_settings(batch_size=BB_BATCH, node_limit=BB_NODE_CAP,
                                turbo=engine), use_mesh=True, mesh_devices=n)
                with TurboSpy() as spy:
                    l0 = kernels.cholesky_lanes.launches
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = spent.run(lambda: solve_misdp(prob, s))
                    wall = time.perf_counter() - t0
                tres = spy.results["solve_turbo"]
                label = f"{'turbo' if engine == 'auto' else 'host'} x{n}"
                if engine == "auto" and (len(tres) != 1 or tres[0] is None):
                    raise AssertionError(f"mesh {label}: solve_turbo {tres}")
                if res.status.name != "OPTIMAL" or abs(
                        res.objval - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
                    raise AssertionError(f"mesh {label}: {res}, want OPTIMAL "
                                         f"at {BB_OPTIMUM}")
                viol = incumbent_violation(prob, res.best_y)
                if max(viol.values()) > s.bb.feastol:
                    raise AssertionError(f"mesh {label}: incumbent "
                                         f"infeasible: {viol}")
                trees[label] = {**bb_summary(res, wall),
                                "rounds": tres[0].rounds if tres else None,
                                "widths": spy.widths,
                                "cholesky_lanes": kernels.cholesky_lanes
                                .launches - l0, "incumbent_violation": viol}
    finally:
        bb_module.make_mesh = real
    log("mesh_trees", instance="cls_32", batch=BB_BATCH, card=card,
        trees=trees, unsharded_host_tree=host_tree,
        unsharded_turbo_tree=turbo_tree)
    return trees


# the blocks axis over distinct devices (parallel/mesh.py): a split
# bucket's halves on a mesh row of the card and the CPU.  torch raises on
# any op that mixes a CUDA tensor with a CPU tensor of more than 0
# dimensions, so a move the solve misses fails; the same split on a row of
# two cuda:0 entries is the reference
BLOCKS_TRUSS = (128, 4, 1)         # truss_topology(nbars, nloads, seed)
BLOCKS_BATCH = 8
BLOCKS_NODE_CAP = 2
BLOCKS_TWO_CARD_BATCH = 32
MIXED_ROW = ("cuda:0", "cpu")
CARD_ROW = ("cuda:0", "cuda:0")
BLOCKS_AXES = ("nodes", "blocks")
# the kernels each route runs per bucket: launched for the card's half,
# their plain versions for the CPU's (the rest run at home, on the card)
BLOCKS_PER_BUCKET = {"f64": ("cholesky_lanes",),
                     "refine_fused": ("cholesky_lanes", "bmm64",
                                      "rhs_bucket", "recover_bucket")}


def truss_boxes(prob, B: int, rng):
    """Slot 0 is the root box; slots 1.. bound 1-3 bar areas by an
    integer inside their box (a branching-down or -up child)."""
    lb = np.tile(prob.lb, (B, 1))
    ub = np.tile(prob.ub, (B, 1))
    for s in range(1, B):
        for j in rng.choice(prob.nvars, size=int(rng.integers(1, 4)),
                            replace=False):
            v = float(rng.integers(0, 3))
            if rng.random() < 0.5:
                ub[s, j] = v
            else:
                lb[s, j] = v
    return lb, ub


class MoveSpy:
    """The moves between devices of a sharded solve inside a ``with``
    block: each call of ``to_device`` (ops/ipm.py's inside the solve,
    parallel/mesh.py's around it) whose tensor changes device, as (from,
    to, bytes), and the number of moves made before each flag read."""

    def __init__(self):
        self.moves, self.reads = [], []

    def __enter__(self):
        self.saved = (ipm_module.to_device, mesh_module.to_device,
                      mesh_module.lockstep)
        move, lockstep = self.saved[0], self.saved[2]

        def spy(x, d):
            if isinstance(x, torch.Tensor) and x.device != torch.device(d):
                self.moves.append((x.device.type, torch.device(d).type,
                                   x.numel() * x.element_size()))
            return move(x, d)

        def counted(steppers, combine):
            def read(flags):
                self.reads.append(len(self.moves))
                return combine(flags)
            return lockstep(steppers, read)

        ipm_module.to_device = mesh_module.to_device = spy
        mesh_module.lockstep = counted
        return self

    def __exit__(self, *exc):
        (ipm_module.to_device, mesh_module.to_device,
         mesh_module.lockstep) = self.saved

    def per_iteration(self) -> dict:
        """Moves and bytes between the first flag read and the last, a
        loop iteration, by direction."""
        inside = self.moves[self.reads[0]:self.reads[-1]]
        iters = max(len(self.reads) - 1, 1)
        out = {}
        for src, dst, nbytes in inside:
            key = f"{src}_to_{dst}"
            n, b = out.get(key, (0, 0))
            out[key] = (n + 1, b + nbytes)
        return {k: {"moves": n / iters, "bytes": b / iters}
                for k, (n, b) in out.items()}


class PlainSpy:
    """Each kernel's plain version run by its wrapper on CPU tensors
    inside a ``with`` block, counted (the solver also calls some plain
    versions itself, as library routes: not counted)."""

    def __init__(self):
        self.calls = dict.fromkeys(KERNELS, 0)

    def __enter__(self):
        self.saved = {}
        for name, (wrapper, _) in KERNELS.items():
            module = sys.modules[wrapper.__module__]
            orig = getattr(module, f"{name}_plain")
            self.saved[name] = (module, orig)

            def call(*a, name=name, orig=orig, **kw):
                if sys._getframe(1).f_code.co_name == name:
                    self.calls[name] += 1
                return orig(*a, **kw)
            setattr(module, f"{name}_plain", call)
        return self

    def __exit__(self, *exc):
        for name, (module, orig) in self.saved.items():
            setattr(module, f"{name}_plain", orig)


def row_solve(data, req, settings, row, spent: Launches) -> tuple:
    """One solve of ``req`` through ``sharded_solver`` on the mesh row
    ``row`` (nodes 1, blocks 2) with MoveSpy, PlainSpy, the host syncs and
    the launches: (output, wall, record)."""
    solve = sharded_solver(data, settings, make_mesh(
        2, BLOCKS_AXES, devices=list(row)))
    before = counts()
    with MoveSpy() as moves, PlainSpy() as plain, sync_sites() as sites:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = spent.run(lambda: solve(*req))
        wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in counts().items() if v > before[k]}
    read = f"ipm.py:{ipm_read_line()}"
    return res, wall, {
        "row": list(row), "iters": res.iters, "wall_s": wall,
        "flag_reads": sites.count(read), "host_syncs": len(sites),
        "host_syncs_per_iteration": len(sites) / max(res.iters, 1),
        "sync_sites": sorted(collections.Counter(sites).items()),
        "moved_per_iteration": moves.per_iteration(),
        "moved_bytes_total": sum(m[2] for m in moves.moves),
        "launches": launched,
        "plain_calls_on_cpu": {k: v for k, v in plain.calls.items() if v}}


def mixed_row_solves(card, routes, spent: Launches) -> dict:
    """The truss at BLOCKS_BATCH through sharded_solver on MIXED_ROW and
    on CARD_ROW, per route: float64 with equal statuses and iterations
    and dobj within MESH_F64_BAR, the fused refine route with equal
    statuses, iterations within MESH_REFINE_ITERS and dobj within
    MESH_REFINE_BAR; on the mixed row one flag read an iteration (plus
    the last), the route's per-bucket kernels launched for the card's half
    and their plain versions run for the CPU's (no plain version on the
    CPU of a kernel the card did not run), #1 at half the card row's
    launches in float64.  Returns the walls."""
    prob = truss_topology(*BLOCKS_TRUSS[:2], seed=BLOCKS_TRUSS[2])
    data = build_ipm_data(densify(prob), torch.device("cuda", 0))
    lb, ub = truss_boxes(prob, BLOCKS_BATCH, np.random.default_rng(3))
    req = request(prob, lb, ub, "direct")
    walls = {}
    for route, s in routes.items():
        ref, ref_wall, ref_rec = row_solve(data, req, s, CARD_ROW, spent)
        out, wall, rec = row_solve(data, req, s, MIXED_ROW, spent)
        label = f"blocks mixed {route}"
        if route == "f64":
            dev = agree(label, out, ref, s.gaptol, "the cuda:0 row",
                        iters_tol=0, bar=MESH_F64_BAR)
        else:
            dev = agree(label, out, ref, s.gaptol, "the cuda:0 row",
                        iters_tol=MESH_REFINE_ITERS, bar=MESH_REFINE_BAR)
        if rec["flag_reads"] != out.iters + 1:
            raise AssertionError(f"{label}: {rec['flag_reads']} flag reads "
                                 f"in {out.iters} iterations")
        halves = [k for k in BLOCKS_PER_BUCKET[route]
                  if not (rec["launches"].get(k)
                          and rec["plain_calls_on_cpu"].get(k))]
        if halves or set(rec["plain_calls_on_cpu"]) - set(rec["launches"]):
            raise AssertionError(f"{label}: kernels launched "
                                 f"{rec['launches']}, plain versions on the "
                                 f"CPU {rec['plain_calls_on_cpu']}")
        if route == "f64" and 2 * rec["launches"]["cholesky_lanes"] != \
                ref_rec["launches"]["cholesky_lanes"]:
            raise AssertionError(f"{label}: #1 launched {rec['launches']} "
                                 f"vs the cuda:0 row's "
                                 f"{ref_rec['launches']}")
        walls[f"mixed {route}"] = wall
        walls[f"cuda:0 row {route}"] = ref_wall
        log("blocks_solve", card=card, instance="truss_128", route=route,
            B=BLOCKS_BATCH, statuses=collections.Counter(
                out.status.tolist()), max_rel_dobj_vs_card_row=dev,
            card_row_iters=ref.iters, mixed=rec, card_row=ref_rec)
    if torch.cuda.device_count() >= 2:
        lb, ub = truss_boxes(prob, BLOCKS_TWO_CARD_BATCH,
                             np.random.default_rng(4))
        req = request(prob, lb, ub, "direct")
        s = routes["f64"]
        ref, ref_wall, ref_rec = row_solve(data, req, s, CARD_ROW, spent)
        out, wall, rec = row_solve(data, req, s, ("cuda:0", "cuda:1"), spent)
        dev = agree("blocks two cards", out, ref, s.gaptol,
                    "the cuda:0 row", iters_tol=0, bar=MESH_F64_BAR)
        walls["two cards f64"] = wall
        log("blocks_two_cards", card=card, B=BLOCKS_TWO_CARD_BATCH,
            max_rel_dobj_vs_card_row=dev, two_cards=rec, card_row=ref_rec)
    else:
        log("blocks_two_cards", card=card, ran=False,
            reason=f"{torch.cuda.device_count()} CUDA device: the row "
                   f"['cuda:0', 'cuda:1'] did not run")
    return walls


def mixed_row_trees(card, spent: Launches) -> dict:
    """The truss at BLOCKS_BATCH under BLOCKS_NODE_CAP through
    ``solve_misdp(use_mesh=True, mesh_devices=2)`` with the solver's mesh
    made MIXED_ROW, the host loop (turbo="off") and turbo ("on"), beside
    the same settings without a mesh: the same status, incumbent
    objective and nodes, dual bound within MESH_F64_BAR."""
    prob = truss_topology(*BLOCKS_TRUSS[:2], seed=BLOCKS_TRUSS[2])
    trees = {}
    real = bb_module.make_mesh
    bb_module.make_mesh = lambda n, axes, device=None: make_mesh(
        2, axes, devices=list(MIXED_ROW))
    try:
        for engine in ("off", "on"):
            s = bb_settings(batch_size=BLOCKS_BATCH,
                            node_limit=BLOCKS_NODE_CAP, turbo=engine)
            runs = {}
            for label, um in (("mixed", True), ("unsharded", False)):
                with MoveSpy() as moves:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = spent.run(lambda: solve_misdp(
                        prob, dataclasses.replace(s, use_mesh=um,
                                                  mesh_devices=2)))
                    wall = time.perf_counter() - t0
                runs[label] = {**bb_summary(res, wall),
                               "moved_bytes": sum(m[2] for m in moves.moves)}
            got, want = runs["mixed"], runs["unsharded"]
            name = "host" if engine == "off" else "turbo"
            db = abs(got["dual_bound"] - want["dual_bound"]) / (
                1 + abs(want["dual_bound"]))
            if (got["status"], got["objval"], got["nodes"]) != (
                    want["status"], want["objval"], want["nodes"]) or \
                    not db <= MESH_F64_BAR or not got["moved_bytes"]:
                raise AssertionError(f"blocks tree {name}: {got} vs {want}")
            trees[name] = runs
    finally:
        bb_module.make_mesh = real
    log("blocks_trees", card=card, instance="truss_128", batch=BLOCKS_BATCH,
        node_cap=BLOCKS_NODE_CAP, trees=trees)
    return trees


def mesh_phase(card, case, routes, host_tree, turbo_tree) -> dict:
    """The mesh path: sharded_solves, mesh_trees, mixed_row_solves,
    mixed_row_trees, then the card as it is:
    ``solve_misdp(use_mesh=True)`` on one card builds no mesh (the tree
    at the optimum), and ``mesh_devices=2`` raises ValueError before any
    kernel launch.  Every launch counter set to 0 just before and the
    sharded runs' launches returned."""
    reset_counts()
    spent = Launches()
    walls = sharded_solves(case, routes, spent)
    mesh_trees(card, spent, host_tree, turbo_tree)
    walls.update(mixed_row_solves(card, routes, spent))
    mixed_row_trees(card, spent)
    prob = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    with CallSpy(bb_module, ("make_mesh",), timed=False) as spy:
        t0 = time.perf_counter()
        res = solve_misdp(prob, dataclasses.replace(
            bb_settings(batch_size=BB_BATCH, node_limit=BB_NODE_CAP),
            use_mesh=True))
        wall = time.perf_counter() - t0
    if spy.calls["make_mesh"] or abs(res.objval - BB_OPTIMUM) > \
            BB_REL * BB_OPTIMUM:
        raise AssertionError(f"mesh one card: make_mesh called "
                             f"{spy.calls['make_mesh']} times, {res}")
    before = counts()
    try:
        solve_misdp(prob, dataclasses.replace(Settings(), use_mesh=True,
                                              mesh_devices=2))
    except ValueError as err:
        error = str(err)
    else:
        raise AssertionError("mesh_devices=2 on one card did not raise")
    if counts() != before:
        raise AssertionError("mesh_devices=2: kernels launched before the "
                             "ValueError")
    log("mesh_one_card", card=card, tree=bb_summary(res, wall),
        mesh_devices_2_error=error, walls=walls)
    if spent.total["cholesky_lanes"] == 0:
        raise AssertionError("mesh: cholesky_lanes not launched")
    return spent.total


# multi-process branch-and-bound (parallel/multihost.py): two processes on
# the card over gloo, each with a deadline
MULTIHOST_DEADLINE_S = 300
MULTIHOST_WORKER = r"""
import importlib, json, sys, time
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
# the host side's tensors are tiny: one thread each, or the processes'
# idle OpenMP workers spin against each other's host work
torch.set_num_threads(1)
import torch.distributed as dist
from scipsdp_tpu_torch.models.families import cardinality_least_squares
from scipsdp_tpu_torch.models.problem import (INF, LinearConstraints, MISDP,
                                              SDPBlock)
from scipsdp_tpu_torch.parallel import multihost
from scipsdp_tpu_torch.utils.config import BBSettings, Settings

gathers = [0]
allgather = multihost.allgather


def counted(vec):
    gathers[0] += 1
    return allgather(vec)


multihost.allgather = counted
t0 = time.perf_counter()
assert multihost.initialize(f"127.0.0.1:{port}", nproc, pid) == (pid, nproc)
joined = time.perf_counter() - t0


probe = importlib.import_module("scipsdp_tpu_torch.ops.kernels")


def run(label, prob, settings):
    gathers[0] = 0
    l0 = probe.cholesky_lanes.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = multihost.solve_misdp_distributed(prob, settings, sync_every=1)
    torch.cuda.synchronize()
    return {"label": label, "status": res.status.name, "objval": res.objval,
            "dual_bound": res.dual_bound, "nodes": res.stats.nodes,
            "relax_solves": res.stats.relax_solves,
            "ipm_iterations": res.stats.ipm_iterations,
            "nstolen": res.stats.nstolen, "ndonated": res.stats.ndonated,
            "syncs": gathers[0], "wall_s": time.perf_counter() - t0,
            "cholesky_lanes": probe.cholesky_lanes.launches - l0,
            "best_y": None if res.best_y is None else res.best_y.tolist()}


m = 6
blk = SDPBlock(size=1, var=[0], row=[0], col=[0], val=[1.0],
               const_row=[0], const_col=[0], const_val=[1.0])
steal = MISDP(nvars=m, obj=-np.array([1.0, 1.1, 1.2, 1.3, 0.9, 0.8]),
              lb=np.zeros(m), ub=np.ones(m), integral=np.ones(m, bool),
              blocks=[blk], name="steal",
              lp=LinearConstraints.from_rows(
                  [(list(range(m)), [1.0] * m, -INF, 2.0)]))
cls = cardinality_least_squares(%d, %d, %d, seed=%d)
out = {"pid": pid, "join_s": joined, "device": torch.cuda.get_device_name(0),
       "runs": [run("steal", steal, Settings(bb=BBSettings(batch_size=2))),
                run("cls_32", cls, Settings(bb=BBSettings(
                    batch_size=%d, node_limit=%d)))],
       "launches": {k: getattr(importlib.import_module(mod), k).launches
                    for k, mod in %r.items()}}
dist.destroy_process_group()
print(json.dumps(out))
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_phase(card, host_tree) -> dict:
    """Two processes on the card, joined in a gloo group
    (``parallel/multihost.py``), each solving with
    ``solve_misdp_distributed`` under a deadline: JAX's steal instance
    (tests/test_multihost.py) to -2.3 in both, with nodes stolen and
    donated, then cls_32 at B=32 to BB_OPTIMUM within BB_REL in both (a
    feasible incumbent where one is held); each process's wall, nodes,
    collectives and #1 launches beside the single-process host loop's
    tree (bb_phase: a sync hook keeps turbo off).  Returns the launches
    of both processes (each counts from 0)."""
    script = MULTIHOST_WORKER % (*BB_INSTANCE, BB_BATCH, BB_NODE_CAP,
                                 {k: w.__module__ for k, (w, _) in
                                  KERNELS.items()})
    port = free_port()
    root = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i), "2",
                               str(port)], cwd=root, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTIHOST_DEADLINE_S))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"multihost: the processes did not finish in "
                             f"{MULTIHOST_DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    res = []
    for p, (stdout, stderr) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"multihost: exit {p.returncode}\n"
                                 f"{stderr[-3000:]}")
        res.append(json.loads(stdout.strip().splitlines()[-1]))
    prob = cardinality_least_squares(*BB_INSTANCE[:3], seed=BB_INSTANCE[3])
    for r in res:
        steal, cls = r["runs"]
        if steal["status"] != "OPTIMAL" or abs(steal["objval"] + 2.3) > 1e-4:
            raise AssertionError(f"multihost steal, process {r['pid']}: "
                                 f"{steal}")
        if cls["status"] != "OPTIMAL" or abs(
                cls["objval"] - BB_OPTIMUM) > BB_REL * BB_OPTIMUM:
            raise AssertionError(f"multihost cls_32, process {r['pid']}: "
                                 f"{cls}, want OPTIMAL at {BB_OPTIMUM}")
        if cls["best_y"] is not None:
            viol = incumbent_violation(prob, np.asarray(cls["best_y"]))
            if max(viol.values()) > Settings().bb.feastol:
                raise AssertionError(f"multihost cls_32, process "
                                     f"{r['pid']}: incumbent infeasible "
                                     f"{viol}")
            cls["incumbent_violation"] = viol
        cls.pop("best_y")
        steal.pop("best_y")
    steals = [r["runs"][0] for r in res]
    if not sum(r["nstolen"] for r in steals) or \
            not sum(r["ndonated"] for r in steals):
        raise AssertionError(f"multihost steal: nothing stolen or donated: "
                             f"{steals}")
    launches = {k: sum(r["launches"][k] for r in res) for k in KERNELS}
    if launches["cholesky_lanes"] == 0:
        raise AssertionError("multihost: cholesky_lanes not launched")
    log("multihost", card=card, processes=2, wall_s=wall,
        per_process=[{k: r[k] for k in ("pid", "device", "join_s", "runs")}
                     for r in res],
        single_process_host_tree=host_tree, launches=launches)
    return launches


def tree_profile(fn) -> dict:
    """Device busy time and host syncs of one B&B solve: one call under
    torch.profiler with CUDA activity only (the tree launches ~150,000
    kernels; CPU op events as well took minutes to aggregate) and one in
    CUDA sync debug mode (host syncs by the Python line that synced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in kern)
    aggregate = time.perf_counter() - t0 - wall
    with sync_sites() as syncs:
        fn()
    return {"profiled_wall_s": wall, "profile_aggregate_s": aggregate,
            "device_busy_us": busy,
            "kernel_launches": sum(e.count for e in kern),
            "host_syncs": len(syncs),
            "sync_sites": sorted(collections.Counter(syncs).items())}


def bounds_agree(label, out, ref, gaptol, what) -> tuple:
    """Slots OPTIMAL in both solves bound within 2 * gaptol * (1 + |dobj|);
    every slot of ``out`` is OPTIMAL or FAILED (no bound: the JAX package
    hands such a slot to its recovery ladder).  Returns the number of
    slots whose status differs and the largest relative deviation."""
    st, st_ref = out.status.cpu().numpy(), ref.status.cpu().numpy()
    opt = int(SolverResultStatus.OPTIMAL)
    if not np.isin(st, [opt, int(SolverResultStatus.FAILED)]).all():
        raise AssertionError(f"{label}: statuses {collections.Counter(st)}")
    both = (st == opt) & (st_ref == opt)
    d, d_ref = out.dobj.cpu().numpy()[both], ref.dobj.cpu().numpy()[both]
    dev = np.abs(d - d_ref) / (1 + np.abs(d_ref))
    if not (dev <= 2 * gaptol).all():
        raise AssertionError(f"{label}: dobj differs from {what} by "
                             f"{dev.max()}")
    return int((st != st_ref).sum()), float(dev.max(initial=0.0))


def refine_phase(cases, rset, f64_outs):
    """The refine tier, non-fused direction: every request launches the
    probe kernel and the three df32 kernels.  A direct
    request must converge every slot, as the float64 tier does, with the
    same bounds, the same checks, and the same statuses and iterations
    (within 3) through the plain df32 route.  The Gamma=1 probe and the
    Gamma=1e3 penalty request may leave slots FAILED (the JAX package's
    refine tier, on the CPU, fails 18 of the penalty request's 32 slots):
    their FAILED slots are counted, their OPTIMAL slots hold to the float64
    tier's and the plain route's bounds."""
    launches, per_request, outs = drive(cases, rset,
                                        ["cholesky_lanes", *DF32])
    static = static_counts()
    plain = dataclasses.replace(rset, use_df32="off")
    for (label, dense, data, req, direct), out, f64, n in zip(
            cases, outs, f64_outs, per_request):
        ref = ipm_solve(data, *req, settings=plain)
        viol = None
        if direct:
            viol = check_solve(label, dense, out, req, rset.gaptol,
                               rset.feastol, direct)
            agree(label, out, ref, rset.gaptol, "the plain df32 route")
        diff64, dev64 = bounds_agree(label, out, f64, rset.gaptol,
                                     "the float64 tier")
        diffp, devp = bounds_agree(label, out, ref, rset.gaptol,
                                   "the plain df32 route")
        failed = int(SolverResultStatus.FAILED)
        log("refine_solve", request=label, B=int(out.status.shape[0]),
            iters=out.iters, f64_iters=out.f64_iters,
            failed=int((out.status == failed).sum()),
            plain_route_iters=ref.iters, plain_route_f64_iters=ref.f64_iters,
            plain_route_failed=int((ref.status == failed).sum()),
            f64_tier_iters=f64.iters, launches=n,
            status_diff_vs_f64_tier=diff64, status_diff_vs_plain_route=diffp,
            max_rel_dobj_vs_f64_tier=dev64, max_rel_dobj_vs_plain_route=devp,
            root_dobj=float(out.dobj[0]), root_dual_violation=viol)
    log("refine_path", launches=launches, static_launches=static)
    return launches, outs


def fused_phase(cases, fset, f64_outs, refine_outs):
    """The refine tier with the fused direction: every request launches the
    three fused kernels, the probe kernel and bmm64 (X Rp, hoisted out of
    the direction); the other kernels each request still launches are
    logged.  A direct request must converge every slot with the same
    checks, the non-fused refine path's statuses, and both that path's and
    the float64 tier's bounds (2 * gaptol).  The probe and penalty requests
    count their FAILED slots; their OPTIMAL slots hold to both bounds."""
    launches, per_request, outs = drive(
        cases, fset, [*FUSED, "cholesky_lanes", "bmm64"])
    static = static_counts()
    failed = int(SolverResultStatus.FAILED)
    for (label, dense, data, req, direct), out, f64, nonfused, n in zip(
            cases, outs, f64_outs, refine_outs, per_request):
        viol = None
        if direct:
            viol = check_solve(label, dense, out, req, fset.gaptol,
                               fset.feastol, direct)
        diff64, dev64 = bounds_agree(label, out, f64, fset.gaptol,
                                     "the float64 tier")
        diffr, devr = bounds_agree(label, out, nonfused, fset.gaptol,
                                   "the non-fused refine path")
        if direct and diffr:
            raise AssertionError(f"{label}: {diffr} statuses differ from "
                                 "the non-fused refine path")
        log("fused_solve", request=label, B=int(out.status.shape[0]),
            iters=out.iters, f64_iters=out.f64_iters,
            failed=int((out.status == failed).sum()),
            nonfused_iters=nonfused.iters,
            nonfused_f64_iters=nonfused.f64_iters,
            nonfused_failed=int((nonfused.status == failed).sum()),
            f64_tier_iters=f64.iters, launches=n,
            other_kernels_launched=[k for k in KERNELS if n[k] and k not in
                                    (*FUSED, "cholesky_lanes", "bmm64")],
            status_diff_vs_f64_tier=diff64, status_diff_vs_nonfused=diffr,
            max_rel_dobj_vs_f64_tier=dev64, max_rel_dobj_vs_nonfused=devr,
            root_dobj=float(out.dobj[0]), root_dual_violation=viol)
    log("fused_path", launches=launches, static_launches=static)
    return launches


def pallas_phase(cases, routes, f64_outs) -> dict:
    """The two routes with use_pallas=True: "on_pallas" (phase32="on") and
    "refine_pallas" (the fused refine tier).  Every request must launch the
    solver's three float32 kernels and the probe kernel, the refine route
    also bmm64 and the three fused kernels.  A direct request whose twin
    (the same route with use_pallas=False: library factors) converges
    every slot must be all OPTIMAL, pass check_solve, and match the twin:
    equal statuses, iterations within 2, and bounds within 2 * gaptol of
    it and of the float64 tier.  Where the twin itself FAILs slots (the
    float32 "on" tier at cls_64, n = 129: JAX's own tier FAILs 1 of its 8
    slots on the CPU), and on the probe and penalty requests, the FAILED
    slots are counted and the OPTIMAL ones hold to both bounds.  Returns
    the launches per route."""
    launches = {}
    failed = int(SolverResultStatus.FAILED)
    for route in ("on_pallas", "refine_pallas"):
        s = routes[route]
        need = [*PALLAS, "cholesky_lanes"] + (
            ["bmm64", *FUSED] if s.phase32 == "refine" else [])
        launches[route], per_request, outs = drive(cases, s, need)
        twin = dataclasses.replace(s, use_pallas=False)
        for (label, dense, data, req, direct), out, f64, n in zip(
                cases, outs, f64_outs, per_request):
            ref = ipm_solve(data, *req, settings=twin)
            held = direct and bool((ref.status == int(
                SolverResultStatus.OPTIMAL)).all())
            viol = None
            if held:
                viol = check_solve(label, dense, out, req, s.gaptol,
                                   s.feastol, direct)
                agree(label, out, ref, s.gaptol, "use_pallas=False",
                      iters_tol=2)
            diff64, dev64 = bounds_agree(label, out, f64, s.gaptol,
                                         "the float64 tier")
            difft, devt = bounds_agree(label, out, ref, s.gaptol,
                                       "use_pallas=False")
            log("pallas_solve", route=route, request=label,
                held_to_twin=held, B=int(out.status.shape[0]),
                iters=out.iters,
                f64_iters=out.f64_iters,
                failed=int((out.status == failed).sum()),
                twin_iters=ref.iters, twin_f64_iters=ref.f64_iters,
                twin_failed=int((ref.status == failed).sum()),
                f64_tier_iters=f64.iters, launches=n,
                status_diff_vs_f64_tier=diff64, status_diff_vs_twin=difft,
                max_rel_dobj_vs_f64_tier=dev64, max_rel_dobj_vs_twin=devt,
                root_dobj=float(out.dobj[0]), root_dual_violation=viol)
        log("pallas_path", route=route, launches=launches[route])
    # "lite" once: logged and counted; it may FAIL slots, as in JAX
    lite = dataclasses.replace(routes["on_pallas"], phase32="lite")
    launches["lite_pallas"], per_request, outs = drive(cases[:1], lite, PALLAS)
    diff64, dev64 = bounds_agree(cases[0][0], outs[0], f64_outs[0],
                                 lite.gaptol, "the float64 tier")
    log("lite_solve", request=cases[0][0], iters=outs[0].iters,
        f64_iters=outs[0].f64_iters,
        failed=int((outs[0].status == failed).sum()),
        statuses=collections.Counter(outs[0].status.tolist()),
        launches=per_request[0], status_diff_vs_f64_tier=diff64,
        max_rel_dobj_vs_f64_tier=dev64)
    return launches


def tf32_phase(case, routes) -> None:
    """The caller allows TF32: cls_32/direct through both pallas routes
    must equal the same solve with TF32 off (statuses, iterations, dobj
    bit for bit: every float32 iteration runs at full precision), and the
    caller's flag must come back as it was set."""
    label, _, data, req, _ = case
    for route in ("refine_pallas", "on_pallas"):
        s = routes[route]
        off = ipm_solve(data, *req, settings=s)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            on = ipm_solve(data, *req, settings=s)
            kept = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        same = (on.iters == off.iters
                and bool((on.status == off.status).all())
                and bool((on.dobj == off.dobj).all()))
        log("tf32_check", route=route, request=label, flag_kept=kept,
            iters=on.iters, same_as_tf32_off=same)
        if not (kept and same):
            raise AssertionError(f"{route} {label}: TF32 on changed the "
                                 f"solve ({same}) or the flag ({kept})")


def timing_phase(cases, routes, rounds) -> None:
    """Wall per request for each route, the routes in turns (the order
    rotates every round)."""
    names = list(routes)
    for label, _, data, req, _ in cases:
        walls = {k: [] for k in names}
        outs = {}
        for r in range(rounds):
            order = names[r % len(names):] + names[:r % len(names)]
            if r % 2:
                order = order[::-1]
            for k in order:
                wall, outs[k] = timed(data, req, routes[k])
                walls[k].append(wall)
        log("timing", request=label, rounds=rounds,
            wall_s_median={k: float(np.median(v)) for k, v in walls.items()},
            iters={k: o.iters for k, o in outs.items()},
            f64_iters={k: o.f64_iters for k, o in outs.items()},
            first_faster_rounds={f"{a}<{b}": sum(
                x < y for x, y in zip(walls[a], walls[b]))
                for a, b in zip(names, names[1:] + names[:1])},
            wall_s=walls)


def probe_timing_phase(cases, settings) -> None:
    """The float64 path: probe kernel against the plain probe, in turns."""
    plain = dataclasses.replace(settings, use_lanes_chol=False)
    for label, _, data, req, _ in cases:
        walls = {"kernel": [], "plain": []}
        for r in range(PROBE_PAIRS):
            order = ("kernel", "plain") if r % 2 == 0 else ("plain", "kernel")
            for route in order:
                walls[route].append(timed(
                    data, req, settings if route == "kernel" else plain)[0])
        log("f64_probe_timing", request=label,
            kernel_wall_s_median=float(np.median(walls["kernel"])),
            plain_probe_wall_s_median=float(np.median(walls["plain"])),
            wall_s=walls)


def cpu_reference(device, routes, bars) -> None:
    """A small instance on the card against the same solve on the CPU
    (the path the tests hold against JAX), one per route: equal statuses,
    iterations within 3, dobj within ``bars[route]`` (2 * gaptol unless
    named) * (1 + |dobj|)."""
    prob = cardinality_least_squares(8, 16, 3, seed=1)
    dense = densify(prob)
    lb, ub = node_boxes(prob, 8, 8, np.random.default_rng(1))
    req = request(prob, lb, ub, "direct")
    cpu_data, dev_data = build_ipm_data(dense, "cpu"), build_ipm_data(dense,
                                                                      device)
    for route, s in routes.items():
        ref = ipm_solve(cpu_data, *req, settings=s)
        out = ipm_solve(dev_data, *req, settings=s)
        dev = agree(f"small CLS {route}", out, ref, s.gaptol,
                    "the CPU solve", bar=bars.get(route))
        log("cpu_reference", instance="cls_8x16", B=8, route=route,
            iters=out.iters, cpu_iters=ref.iters, max_rel_dobj=dev)


@contextlib.contextmanager
def sync_sites():
    """The Python line of each host sync inside the ``with`` block (CUDA
    sync debug mode), in the list it yields, filled when the block ends;
    syncs made by this script's own lines (a spy's timing) are left
    out."""
    sites = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")
    own = pathlib.Path(__file__).name
    sites += [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
              if "synchronizing CUDA operation" in str(w.message)
              and pathlib.Path(w.filename).name != own]


def device_profile(fn) -> tuple:
    """(output, profile) of ``fn``: one call under torch.profiler (its
    wall, device busy time, kernel launches, the ops and kernels with the
    most device time) and one in CUDA sync debug mode (host syncs by the
    Python line that synced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    evts = sorted(prof.key_averages(), key=dev_us, reverse=True)
    kern = [e for e in evts if e.device_type == DeviceType.CUDA]
    ops = [e for e in evts if e.device_type != DeviceType.CUDA]
    with sync_sites() as syncs:
        fn()
    return out, {
        "profiled_wall_s": wall, "device_busy_us": sum(map(dev_us, kern)),
        "kernel_launches": sum(e.count for e in kern),
        "host_syncs": len(syncs),
        "sync_sites": sorted(collections.Counter(syncs).items()),
        "top_ops": [{"op": e.key, "self_device_us": dev_us(e),
                     "calls": e.count} for e in ops[:10]],
        "top_kernels": [{"kernel": e.key[:90], "device_us": dev_us(e),
                         "calls": e.count} for e in kern[:8]]}


def profile_one(label, data, req, settings, route) -> None:
    """device_profile of one solve (the loop reads the done mask once per
    iteration: one host sync each)."""
    out, prof = device_profile(lambda: ipm_solve(data, *req,
                                                 settings=settings))
    log("profile", request=label, route=route, iters=out.iters,
        f64_iters=out.f64_iters,
        launches_per_iter=prof["kernel_launches"] / out.iters, **prof)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=card)
    settings = resolve_backend_autos(Settings(), device).ipm
    settings = dataclasses.replace(settings, max_iters=100)
    rset = dataclasses.replace(settings, phase32="refine",
                               fused_direction="off", step_rule="probe",
                               use_lanes_chol=True)
    fset = dataclasses.replace(rset, fused_direction="on")
    pallas = {"on_pallas": dataclasses.replace(rset, phase32="on",
                                               use_pallas=True),
              "refine_pallas": dataclasses.replace(fset, use_pallas=True)}
    log("settings", step_rule=settings.step_rule,
        use_lanes_chol=settings.use_lanes_chol, phase32=settings.phase32,
        use_pallas=settings.use_pallas, refine=dataclasses.asdict(rset),
        pallas={k: dataclasses.asdict(v) for k, v in pallas.items()})

    build_phase()
    kern = {"cholesky_lanes": cholesky_phase(device), **df32_phase(device),
            **fused_kernel_phase(device), **pallas_kernel_phase(device)}
    cases = make_cases(device)
    routes = {"refine_fused": fset, "refine_kernels": rset,
              "refine_plain": dataclasses.replace(rset, use_df32="off"),
              "f64": settings}
    paths = {}
    paths["f64"], f64_outs = f64_phase(cases, settings)
    paths["sdpi"] = sdpi_phase(cases[0], settings, f64_outs[0], device)
    sdpi_cpu_reference(device, settings)
    paths["bb"], host_tree = bb_phase(card)
    paths["turbo"], turbo_tree = turbo_phase(card, host_tree)
    paths["refine"], refine_outs = refine_phase(cases, rset, f64_outs)
    paths["fused"] = fused_phase(cases, fset, f64_outs, refine_outs)
    paths.update(pallas_phase(cases, pallas, f64_outs))
    tf32_phase(cases[0], pallas)
    timing_phase(cases, routes, ROUTE_ROUNDS)
    # the float32 routes, and the "on" tier on library factors beside them
    f32_routes = {"on_pallas": pallas["on_pallas"],
                  "on": dataclasses.replace(pallas["on_pallas"],
                                            use_pallas=False),
                  "refine_pallas": pallas["refine_pallas"]}
    direct = [c for c in cases if c[4]]
    timing_phase(direct, {**f32_routes, "refine_fused": fset,
                          "f64": settings}, PALLAS_ROUNDS)
    probe_timing_phase(cases, settings)
    cpu_reference(device, {"f64": settings, "refine_kernels": rset,
                           "refine_fused": fset,
                           "on_pallas": pallas["on_pallas"]},
                  {"on_pallas": 5e-6})
    for label, _, data, req, is_direct in cases:
        for route, s in routes.items():
            if is_direct or route == "refine_fused":
                profile_one(label, data, req, s, route)
    for label, _, data, req, _ in direct:
        for route, s in f32_routes.items():
            profile_one(label, data, req, s, route)
    paths["probing"] = probing_phase(card)
    paths["lpmode"] = lpmode_phase(card)
    paths["cli"] = cli_phase(card, turbo_tree)
    paths["mesh"] = mesh_phase(card, cases[0], {"f64": settings,
                                                "refine_fused": fset},
                               host_tree, turbo_tree)
    paths["multihost"] = multihost_phase(card, host_tree)

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"scipsdp_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": sum(p[name] for p in paths.values()),
        "launches_by_path": {k: p[name] for k, p in paths.items()},
        **kern[name]} for name, (_, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
