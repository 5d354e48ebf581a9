#!/usr/bin/env python3
"""Check and tune the two tensor-core kernels of the PyTorch/CUDA port,
``bmm64`` (float64 DMMA) and ``schur_wwt`` (3xTF32), on one CUDA card.

    python3 profile_torch_kernels.py check      # build, ptxas report, errors
    python3 profile_torch_kernels.py variants   # time design variants
    python3 profile_torch_kernels.py dissect    # time them with parts cut out
    python3 profile_torch_kernels.py phases     # chip_smoke's kernel phases

``check`` builds the two sources, prints the compiler's report, and holds
each kernel against its plain version (and float64 numpy) on a few shapes
around the fragment edges: the short first run after a kernel change.
``variants`` times the committed kernels beside variants made by
substituting constants in a copy of the source under ``build/variants/``
(tile rows, slab depth and the small-matrix threshold of ``bmm64``; the
pipeline depth and warp tile of ``schur_wwt``) and
beside other settings of ``schur_wwt``'s F split, each against the library
call, in turns, replayed from CUDA graphs (``chip_smoke.graph_times``).
``dissect`` stands in for a kernel profiler where none is at hand: it
times each kernel beside copies with one part taken out (the
copies into shared memory, the tensor-core products, the stores, all but
the launch), so the differences say what each part costs.
``phases`` runs only ``chip_smoke.py``'s build and its ``df32_phase`` and
``pallas_kernel_phase`` (every shape those time, a few minutes): copied
into a checkout of another commit and run there, it times that commit's
kernels by the same means, for a comparison within one call on one card.
Every line printed is one JSON object; the first names the card and its
power limit.
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
    if mode == "phases":
        cs.build_phase()
        cs.df32_phase(device)
        cs.pallas_kernel_phase(device)
        return 0
    check(device)
    if mode == "variants":
        variants(device)
    if mode == "dissect":
        dissect(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
