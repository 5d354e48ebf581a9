"""Reader for the Conic Benchmark Format (CBF) with SCIP-SDP extensions.

Implements the subset of CBF (version <= 3) handled by the reference
``src/scipsdp/reader_cbf.c``:

* sections VER, OBJSENSE, VAR, INT, CON, PSDVAR, PSDCON, PSDVARRANK1,
  PSDCONRANK1, OBJFCOORD, OBJACOORD, OBJBCOORD, FCOORD, ACOORD, BCOORD,
  HCOORD, DCOORD (dispatch: reader_cbf.c:2342-2420);
* scalar variable cones F / L+ / L- (reader_cbf.c:473-481), constraint
  cones L+ / L- / L= (reader_cbf.c:799-807);
* a PSD *variable* of size n is modeled as n(n+1)/2 scalar variables for
  its lower triangle plus an SDP constraint assembling the matrix
  (reader_cbf.c:606-676); coefficients on off-diagonal entries count twice
  (symmetric inner product, reader_cbf.c:1199-1212);
* rank-1 flags via PSDVARRANK1 / PSDCONRANK1 (reader_cbf.c:41-56).

Conventions: a scalar constraint i is "sum_j <F_ij, X_j> + sum_j a_ij x_j
+ b_i in cone"; a PSD constraint c is "sum_j H_cj x_j + D_c >= 0 (PSD)".

numpy only: a copy of the JAX package's ``models/reader_cbf.py``,
kept beside it rather than imported so this package never imports JAX.
"""

from __future__ import annotations

import gzip
import re
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from scipsdp_tpu_torch.models.problem import (
    INF,
    LinearConstraints,
    MISDP,
    SDPBlock,
)
from scipsdp_tpu_torch.models.reader_sdpa import ReadError


def _open(path: str) -> TextIO:
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


_SECTIONS = {
    "VER", "OBJSENSE", "VAR", "INT", "CON", "PSDVAR", "PSDCON",
    "PSDVARRANK1", "PSDCONRANK1", "OBJFCOORD", "OBJACOORD", "OBJBCOORD",
    "FCOORD", "ACOORD", "BCOORD", "HCOORD", "DCOORD",
}


def read_cbf(path: str, name: Optional[str] = None) -> MISDP:
    with _open(path) as f:
        raw = f.readlines()
    if name is None:
        name = re.sub(r"\.cbf(\.gz)?$", "", path.split("/")[-1])

    # tokenize into sections
    lines: List[Tuple[int, str]] = []
    for lineno, line in enumerate(raw, 1):
        pos = line.find("#")
        if pos >= 0:
            line = line[:pos]
        s = line.strip()
        if s:
            lines.append((lineno, s))

    sections: Dict[str, List[Tuple[int, str]]] = {}
    order: List[str] = []
    current: Optional[str] = None
    for lineno, s in lines:
        if s.split()[0] in _SECTIONS and len(s.split()) == 1:
            current = s.split()[0]
            if current in sections:
                raise ReadError(f"line {lineno}: duplicate section {current}")
            sections[current] = []
            order.append(current)
        else:
            if current is None:
                raise ReadError(f"line {lineno}: content before first section")
            sections[current].append((lineno, s))

    if "VER" not in sections or not sections["VER"]:
        raise ReadError("missing VER section")
    try:
        ver = int(sections["VER"][0][1].split()[0])
    except ValueError:
        raise ReadError("could not parse CBF version") from None
    if ver < 1 or ver > 3:
        raise ReadError(f"unsupported CBF version {ver}")

    objsense = 1.0
    if "OBJSENSE" in sections:
        tok = sections["OBJSENSE"][0][1].split()[0].upper()
        if tok == "MIN":
            objsense = 1.0
        elif tok == "MAX":
            objsense = -1.0
        else:
            raise ReadError(f"invalid OBJSENSE '{tok}'")

    def ints(tokens: List[str], lineno: int, n: int) -> List[int]:
        if len(tokens) < n:
            raise ReadError(f"line {lineno}: expected {n} integers")
        try:
            return [int(t) for t in tokens[:n]]
        except ValueError:
            raise ReadError(f"line {lineno}: could not parse integers") from None

    # ---- scalar variables -------------------------------------------------
    nscalarvars = 0
    var_lb: List[float] = []
    var_ub: List[float] = []
    if "VAR" in sections:
        body = sections["VAR"]
        if not body:
            raise ReadError("empty VAR section")
        lineno, header = body[0]
        nscalarvars, ncones = ints(header.split(), lineno, 2)
        if nscalarvars < 0 or ncones < 0:
            raise ReadError(f"line {lineno}: negative VAR counts")
        total = 0
        for lineno, s in body[1:1 + ncones]:
            toks = s.split()
            if len(toks) < 2:
                raise ReadError(f"line {lineno}: invalid VAR cone line")
            cone, cnt = toks[0], int(toks[1])
            if cone == "F":
                lo, hi = -INF, INF
            elif cone == "L+":
                lo, hi = 0.0, INF
            elif cone == "L-":
                lo, hi = -INF, 0.0
            else:
                raise ReadError(
                    f"line {lineno}: unsupported variable cone '{cone}' "
                    "(only F, L+, L- are supported)")
            var_lb.extend([lo] * cnt)
            var_ub.extend([hi] * cnt)
            total += cnt
        if len(body) < 1 + ncones:
            raise ReadError("VAR section: missing cone lines")
        if total != nscalarvars:
            raise ReadError(
                f"VAR section: cone sizes sum to {total}, expected {nscalarvars}")

    # ---- PSD variables ----------------------------------------------------
    npsdvars = 0
    psdvar_sizes: List[int] = []
    if "PSDVAR" in sections:
        body = sections["PSDVAR"]
        if not body:
            raise ReadError("empty PSDVAR section")
        lineno, header = body[0]
        (npsdvars,) = ints(header.split(), lineno, 1)
        if npsdvars < 0:
            raise ReadError(f"line {lineno}: negative PSDVAR count")
        sizes: List[int] = []
        for lineno, s in body[1:]:
            for tok in s.split():
                sizes.append(int(tok))
        if len(sizes) < npsdvars:
            raise ReadError("PSDVAR section: too few sizes")
        psdvar_sizes = sizes[:npsdvars]
        for sz in psdvar_sizes:
            if sz <= 0:
                raise ReadError(f"PSDVAR size {sz} invalid")

    # scalar variable index of PSD var v entry (r, c), r >= c (lower tri)
    psdvar_offset: List[int] = []
    off = nscalarvars
    for sz in psdvar_sizes:
        psdvar_offset.append(off)
        off += sz * (sz + 1) // 2
    nvars = off

    def tri_index(v: int, r: int, c: int) -> int:
        if r < c:
            r, c = c, r
        # lower-triangle row-major: entry (r, c) has index r(r+1)/2 + c
        return psdvar_offset[v] + r * (r + 1) // 2 + c

    lb = np.full(nvars, -INF)
    ub = np.full(nvars, INF)
    lb[:nscalarvars] = var_lb
    ub[:nscalarvars] = var_ub
    integral = np.zeros(nvars, dtype=bool)

    if "INT" in sections:
        body = sections["INT"]
        if not body:
            raise ReadError("empty INT section")
        lineno, header = body[0]
        (nint,) = ints(header.split(), lineno, 1)
        idxs: List[int] = []
        for lineno, s in body[1:]:
            for tok in s.split():
                idxs.append(int(tok))
        if len(idxs) < nint:
            raise ReadError("INT section: too few indices")
        for idx in idxs[:nint]:
            if idx < 0 or idx >= nscalarvars:
                raise ReadError(f"INT index {idx} out of range")
            integral[idx] = True

    # ---- scalar constraints ----------------------------------------------
    nconss = 0
    con_lhs: List[float] = []
    con_rhs: List[float] = []
    if "CON" in sections:
        body = sections["CON"]
        if not body:
            raise ReadError("empty CON section")
        lineno, header = body[0]
        nconss, ncones = ints(header.split(), lineno, 2)
        total = 0
        for lineno, s in body[1:1 + ncones]:
            toks = s.split()
            if len(toks) < 2:
                raise ReadError(f"line {lineno}: invalid CON cone line")
            cone, cnt = toks[0], int(toks[1])
            # cone constrains  expr + b  (lhs/rhs filled in after BCOORD)
            if cone == "L+":
                pat = (0.0, INF)
            elif cone == "L-":
                pat = (-INF, 0.0)
            elif cone == "L=":
                pat = (0.0, 0.0)
            else:
                raise ReadError(
                    f"line {lineno}: unsupported constraint cone '{cone}'")
            con_lhs.extend([pat[0]] * cnt)
            con_rhs.extend([pat[1]] * cnt)
            total += cnt
        if total != nconss:
            raise ReadError(
                f"CON section: cone sizes sum to {total}, expected {nconss}")

    # ---- PSD constraints --------------------------------------------------
    npsdcons = 0
    psdcon_sizes: List[int] = []
    if "PSDCON" in sections:
        body = sections["PSDCON"]
        if not body:
            raise ReadError("empty PSDCON section")
        lineno, header = body[0]
        (npsdcons,) = ints(header.split(), lineno, 1)
        sizes = []
        for lineno, s in body[1:]:
            for tok in s.split():
                sizes.append(int(tok))
        if len(sizes) < npsdcons:
            raise ReadError("PSDCON section: too few sizes")
        psdcon_sizes = sizes[:npsdcons]
        for sz in psdcon_sizes:
            if sz <= 0:
                raise ReadError(f"PSDCON size {sz} invalid")

    # rank-1 flags
    psdvar_rank1 = [False] * npsdvars
    psdcon_rank1 = [False] * npsdcons
    for sec, flags, count in (
        ("PSDVARRANK1", psdvar_rank1, npsdvars),
        ("PSDCONRANK1", psdcon_rank1, npsdcons),
    ):
        if sec in sections:
            body = sections[sec]
            if not body:
                raise ReadError(f"empty {sec} section")
            lineno, header = body[0]
            (nr1,) = ints(header.split(), lineno, 1)
            idxs = []
            for lineno, s in body[1:]:
                for tok in s.split():
                    idxs.append(int(tok))
            if len(idxs) < nr1:
                raise ReadError(f"{sec} section: too few indices")
            for idx in idxs[:nr1]:
                if idx < 0 or idx >= count:
                    raise ReadError(f"{sec} index {idx} out of range")
                flags[idx] = True

    # ---- coefficient sections --------------------------------------------
    obj = np.zeros(nvars)
    objoffset = 0.0

    def entries(sec: str, nfields: int):
        body = sections[sec]
        if not body:
            raise ReadError(f"empty {sec} section")
        lineno, header = body[0]
        (cnt,) = ints(header.split(), lineno, 1)
        out = []
        for lineno, s in body[1:]:
            toks = s.split()
            if len(toks) < nfields:
                raise ReadError(f"line {lineno}: {sec} entry needs {nfields} fields")
            try:
                nums = [int(t) for t in toks[: nfields - 1]]
                nums.append(float(toks[nfields - 1]))
            except ValueError:
                raise ReadError(f"line {lineno}: could not parse {sec} entry") from None
            out.append((lineno, nums))
        if len(out) < cnt:
            raise ReadError(f"{sec} section: expected {cnt} entries, got {len(out)}")
        return out[:cnt]

    if "OBJFCOORD" in sections:
        for lineno, (v, r, c, val) in entries("OBJFCOORD", 4):
            if v < 0 or v >= npsdvars:
                raise ReadError(f"line {lineno}: OBJFCOORD psdvar {v} invalid")
            if not (0 <= r < psdvar_sizes[v] and 0 <= c < psdvar_sizes[v]):
                raise ReadError(f"line {lineno}: OBJFCOORD entry out of range")
            obj[tri_index(v, r, c)] += val if r == c else 2 * val

    if "OBJACOORD" in sections:
        for lineno, (j, val) in entries("OBJACOORD", 2):
            if j < 0 or j >= nscalarvars:
                raise ReadError(f"line {lineno}: OBJACOORD var {j} invalid")
            obj[j] += val

    if "OBJBCOORD" in sections:
        body = sections["OBJBCOORD"]
        if not body:
            raise ReadError("empty OBJBCOORD section")
        objoffset = float(body[0][1].split()[0])

    # scalar constraint coefficient lists
    con_coefs: List[List[Tuple[int, float]]] = [[] for _ in range(nconss)]
    con_b = np.zeros(nconss)

    if "FCOORD" in sections:
        for lineno, (i, v, r, c, val) in entries("FCOORD", 5):
            if not (0 <= i < nconss):
                raise ReadError(f"line {lineno}: FCOORD constraint {i} invalid")
            if not (0 <= v < npsdvars):
                raise ReadError(f"line {lineno}: FCOORD psdvar {v} invalid")
            if not (0 <= r < psdvar_sizes[v] and 0 <= c < psdvar_sizes[v]):
                raise ReadError(f"line {lineno}: FCOORD entry out of range")
            con_coefs[i].append((tri_index(v, r, c), val if r == c else 2 * val))

    if "ACOORD" in sections:
        for lineno, (i, j, val) in entries("ACOORD", 3):
            if not (0 <= i < nconss):
                raise ReadError(f"line {lineno}: ACOORD constraint {i} invalid")
            if not (0 <= j < nscalarvars):
                raise ReadError(f"line {lineno}: ACOORD var {j} invalid")
            con_coefs[i].append((j, val))

    if "BCOORD" in sections:
        for lineno, (i, val) in entries("BCOORD", 2):
            if not (0 <= i < nconss):
                raise ReadError(f"line {lineno}: BCOORD constraint {i} invalid")
            con_b[i] += val

    # PSD constraint blocks: sum H_j x_j + D >= 0  ->  A_j = H_j, A_0 = -D
    hvar: List[List[int]] = [[] for _ in range(npsdcons)]
    hrow: List[List[int]] = [[] for _ in range(npsdcons)]
    hcol: List[List[int]] = [[] for _ in range(npsdcons)]
    hval: List[List[float]] = [[] for _ in range(npsdcons)]
    drow: List[List[int]] = [[] for _ in range(npsdcons)]
    dcol: List[List[int]] = [[] for _ in range(npsdcons)]
    dval: List[List[float]] = [[] for _ in range(npsdcons)]

    if "HCOORD" in sections:
        for lineno, (c_, j, r, cc, val) in entries("HCOORD", 5):
            if not (0 <= c_ < npsdcons):
                raise ReadError(f"line {lineno}: HCOORD psdcon {c_} invalid")
            if not (0 <= j < nscalarvars):
                raise ReadError(f"line {lineno}: HCOORD var {j} invalid")
            if not (0 <= r < psdcon_sizes[c_] and 0 <= cc < psdcon_sizes[c_]):
                raise ReadError(f"line {lineno}: HCOORD entry out of range")
            hvar[c_].append(j)
            hrow[c_].append(r)
            hcol[c_].append(cc)
            hval[c_].append(val)

    if "DCOORD" in sections:
        for lineno, (c_, r, cc, val) in entries("DCOORD", 4):
            if not (0 <= c_ < npsdcons):
                raise ReadError(f"line {lineno}: DCOORD psdcon {c_} invalid")
            if not (0 <= r < psdcon_sizes[c_] and 0 <= cc < psdcon_sizes[c_]):
                raise ReadError(f"line {lineno}: DCOORD entry out of range")
            drow[c_].append(r)
            dcol[c_].append(cc)
            dval[c_].append(-val)   # A_0 = -D

    # ---- assemble ---------------------------------------------------------
    blocks: List[SDPBlock] = []
    # PSD variables: assemble X_v = sum_(r>=c) x_{v,rc} E_rc  >= 0
    for v, sz in enumerate(psdvar_sizes):
        vv, rr, cc, vals = [], [], [], []
        for r in range(sz):
            for c in range(r + 1):
                vv.append(tri_index(v, r, c))
                rr.append(r)
                cc.append(c)
                vals.append(1.0)
        blocks.append(
            SDPBlock(
                size=sz,
                var=np.array(vv, np.int32),
                row=np.array(rr, np.int32),
                col=np.array(cc, np.int32),
                val=np.array(vals),
                const_row=np.zeros(0, np.int32),
                const_col=np.zeros(0, np.int32),
                const_val=np.zeros(0),
                rank1=psdvar_rank1[v],
            )
        )
    for c_ in range(npsdcons):
        if not hval[c_] and not dval[c_]:
            raise ReadError(f"PSD constraint {c_} has no entries")
        blocks.append(
            SDPBlock(
                size=psdcon_sizes[c_],
                var=np.array(hvar[c_], np.int32),
                row=np.array(hrow[c_], np.int32),
                col=np.array(hcol[c_], np.int32),
                val=np.array(hval[c_]),
                const_row=np.array(drow[c_], np.int32),
                const_col=np.array(dcol[c_], np.int32),
                const_val=np.array(dval[c_]),
                rank1=psdcon_rank1[c_],
            )
        )

    rows = []
    for i in range(nconss):
        inds = [j for j, _ in con_coefs[i]]
        vals = [v for _, v in con_coefs[i]]
        # expr + b in cone  ->  lhs - b <= expr <= rhs - b
        lo = con_lhs[i] - con_b[i] if con_lhs[i] > -INF else -INF
        hi = con_rhs[i] - con_b[i] if con_rhs[i] < INF else INF
        rows.append((inds, vals, lo, hi))
    lp = LinearConstraints.from_rows(rows) if rows else LinearConstraints.empty()

    # internal minimization form
    internal_obj = obj * objsense

    prob = MISDP(
        nvars=nvars,
        obj=internal_obj,
        lb=lb,
        ub=ub,
        integral=integral,
        blocks=blocks,
        lp=lp,
        name=name,
        objsense=objsense,
        objoffset=objoffset,
    )
    prob.validate()
    return prob
