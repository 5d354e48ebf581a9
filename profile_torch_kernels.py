#!/usr/bin/env python3
"""Check and tune the redesigned kernels of the PyTorch/CUDA port on one
CUDA card: the tensor-core kernels ``bmm64`` (float64 DMMA) and
``schur_wwt`` (3xTF32), and the blocked triangular kernels
``cholesky_lanes`` and ``tril_inverse``.

    python3 profile_torch_kernels.py check [mma|tri]     # build, ptxas, errors
    python3 profile_torch_kernels.py variants [mma|tri]  # time design variants
    python3 profile_torch_kernels.py dissect [mma|tri]   # parts cut out
    python3 profile_torch_kernels.py phases [tri]        # kernel phases

The optional second word takes one pair of kernels: ``mma`` the
tensor-core kernels, ``tri`` the triangular ones (default both).
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
``phases`` runs ``chip_smoke.py``'s build and its ``df32_phase`` and
``pallas_kernel_phase`` (every shape those time, a few minutes); ``phases
tri`` only the build and ``tri_times`` (the two triangular kernels, their
plain versions and library calls at the main-path shapes, in graphs).
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

import numpy as np
import torch

import chip_smoke as cs
from scipsdp_tpu_torch import _build
from scipsdp_tpu_torch.ops import df32, kernels

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


def compiled(name: str, tag: str, src: str) -> ctypes.CDLL:
    """``src``, a changed copy of ``csrc/<name>.cu``, built into
    ``build/variants/`` and loaded."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    cu = VARIANT_DIR / f"{name}_{tag}.cu"
    so = VARIANT_DIR / f"lib{name}_{tag}.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
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


def cut(name: str, tag: str, *edits: tuple) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with each (text, replacement) applied: a kernel
    with one part taken out, to time what is left.  Its results are wrong
    by design; only its time is read."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for text, replacement in edits:
        if src.count(text) != 1:
            raise KeyError(f"{name}.cu: {text!r} found {src.count(text)} "
                           "times")
        src = src.replace(text, replacement)
    return compiled(name, tag, src)


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
    stack (chip_smoke.spd_stack) for ``cholesky_lanes``, its factor rounded
    to float32 for ``tril_inverse``."""
    N = int(np.prod(lead))
    # without a scale, the call an earlier commit's chip_smoke.py takes
    A64 = cs.spd_stack(rng, N, n, scale) if scale else cs.spd_stack(rng, N, n)
    if name == "cholesky_lanes":
        A32 = A64.astype(np.float32)
        ref = np.linalg.cholesky(A32.astype(np.float64))
    else:
        A32 = np.linalg.cholesky(A64).astype(np.float32)
        ref = np.linalg.inv(A32.astype(np.float64))
    A = torch.as_tensor(A32.reshape(lead + (n, n)), device="cuda")
    return (A,), ref.reshape(lead + (n, n))


def library_call(name: str, n: int, device):
    """The one PyTorch call computing a triangular kernel's function."""
    if name == "cholesky_lanes":
        return torch.linalg.cholesky_ex
    eye = torch.eye(n, dtype=torch.float32, device=device)
    return lambda L: torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                                   upper=False)


def tri_check(device) -> None:
    names = ("cholesky_lanes", "tril_inverse")
    _build.build(*names)
    for name in names:
        report = (_build.library_path(name).parent / "build.log").read_text()
        cs.log("ptxas", kernel=name, report=[
            ln for ln in report.splitlines() if "registers" in ln
            or "Compiling" in ln or "spill" in ln or "error" in ln][:40])
    rng = np.random.default_rng(5)
    for name in names:
        worst = {}
        cases = [(N, n, 0) for n in TRI_CHECK_N for N in (1, 5)]
        for N, n, scale in cases + [(4, 65, 4), (4, 129, 4)]:
            args, ref = tri_case(name, (N,), n, rng, scale)
            _, err, err_ref = cs.pallas_check(
                name, f"check ({N}, {n}) s={scale}", args, ref, N // 2)
            rel = err_ref / float(np.abs(ref).max())
            worst[f"{N}x{n}" + (" ill" if scale else "")] = rel
        cs.log("check", kernel=name, nan_own_matrix_only=True,
               repeat_bit_for_bit=True, rel_err_vs_numpy=worst)
    for n in (10, 65, 300):
        cs.log("check", kernel="cholesky_lanes", n=n,
               pivot_edges=cs.pivot_edges(device, n))


def tri_times(device) -> None:
    """Each triangular kernel, its plain version and its library call at
    TRI_TIMED, device ms from CUDA graphs (only the wrappers, so that the
    same lines run in a checkout of an earlier commit)."""
    rng = np.random.default_rng(6)
    for name, label, lead, n in TRI_TIMED:
        args, _ = tri_case(name, lead, n, rng)
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        ms = cs.graph_times([wrapper, plain, library_call(name, n, device)],
                            args)
        cs.log("tri_times", kernel=name, shape=label, lead=list(lead), n=n,
               ms=ms[0], plain_ms=ms[1], library_ms=ms[2])


def tri_variants(device) -> None:
    rng = np.random.default_rng(7)
    settings = {   # a substituted constant (key=value) a copy
        "tril_inverse": ["kThreads=64", "kThreads=256", "kNB=32"],
        "cholesky_lanes": ["kThreads=128", "kThreads=512", "kSmallThreads=64",
                           "kSmallThreads=256", "kNB=32"]}
    calls = {}
    for name, subs in settings.items():
        calls[name] = {}
        for sub in subs:
            key, value = sub.split("=")
            lib = variant(name, key + value, {key: int(value)})
            nb = int(value) if key == "kNB" else kernels._TRI_NB
            calls[name][sub] = tri_variant(lib, name, nb)
    for name, label, lead, n in TRI_TIMED:
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


def tri_dissect(device) -> None:
    """The triangular kernels beside copies with parts cut out
    (TRINV_CUTS, CHOL_CUTS), in turns, at the main-path shapes."""
    rng = np.random.default_rng(8)
    for name, cuts in (("tril_inverse", TRINV_CUTS),
                       ("cholesky_lanes", CHOL_CUTS)):
        libs = {"whole": cut(name, "whole"),
                "empty launch": cut(name, "ret", cuts["return"])}
        for part, edit in cuts.items():
            if part != "return":
                libs[f"no {part}"] = cut(name, part.replace(" ", "_"), edit)
        shapes = [x for x in TRI_TIMED if x[0] == name][:4]
        for _, label, lead, n in shapes:
            args, _ = tri_case(name, lead, n, rng)
            fns = [*(tri_variant(v, name, kernels._TRI_NB)
                     for v in libs.values()), library_call(name, n, device)]
            cs.log("dissect", kernel=name, shape=label, lead=list(lead), n=n,
                   ms=dict(zip([*libs, "library"], cs.graph_times(fns, args))))


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
    if mode == "phases":
        cs.build_phase()
        if which == "tri":
            tri_times(device)
            return 0
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
