"""Reader for SCIP's native CIP format (the subset SCIP-SDP emits).

The reference reads ``.cip`` through SCIP's core reader plus the constraint
handlers' parse callbacks; the SDP constraint syntax is cons_sdp.c's
print/parse format (consPrintSdp:8714 / consParseSdp:8855):

    [SDP] <name>: <blocksize>
        rank-1? 0|1
        A_0: (i,j):v, ...
        <var>: (i,j):v, ...;

plus SCIP linear constraints  ``[linear] <name>: terms {<=,>=,==} rhs;``
(terms like ``+2.5<X_1>[C]``), quadratic constraints
``[quadratic] <name>: +2<x>[C]^2 +<x>[C]<y>[C] -3<z>[C] <= 5;``
(squares ``<x>^2``, bilinear products ``<x><y>``, linear terms — SCIP's
cons_quadratic print format; upgraded to a rank-1 SDP by presolve,
consQuadConsUpgdSdp role) and indicator constraints
``[indicator] <name>: <binvar> = 1 -> <slackvar> = 0;``.

Sections: STATISTICS, OBJECTIVE (Sense), VARIABLES, (FIXED,) CONSTRAINTS,
END.

numpy only: a copy of the JAX package's ``models/reader_cip.py``,
kept beside it rather than imported so this package never imports JAX.
"""

from __future__ import annotations

import gzip
import re
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from scipsdp_tpu_torch.models.problem import (
    INF,
    IndicatorLink,
    LinearConstraints,
    MISDP,
    QuadConstraint,
    SDPBlock,
)
from scipsdp_tpu_torch.models.reader_sdpa import ReadError


def _open(path: str) -> TextIO:
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


_VAR_RE = re.compile(
    r"\[(binary|integer|implicit integer|continuous)\]\s*<([^>]+)>\s*:"
    r"\s*obj=([^,]+),\s*(?:original|global|local)\s+bounds=\[([^,]+),([^\]]+)\]"
)
_TERM_RE = re.compile(r"([+-]?\s*\d*\.?\d*(?:[eE][+-]?\d+)?)\s*<([^>]+)>\[[BICM]?\]")
# quadratic terms: coef <x>[C]^2 | coef <x>[C]<y>[C] | coef <x>[C]
_QTERM_RE = re.compile(
    r"([+-]?\s*\d*\.?\d*(?:[eE][+-]?\d+)?)\s*"
    r"<([^>]+)>(?:\[[BICM]?\])?"
    r"(?:\s*(\^2)|\s*\*?\s*<([^>]+)>(?:\[[BICM]?\])?)?")
_ENTRY_RE = re.compile(r"\((\d+),(\d+)\):([+-]?\d*\.?\d+(?:[eE][+-]?\d+)?)")
_IND_RE = re.compile(r"<([^>]+)>\s*=\s*1\s*->\s*<([^>]+)>\s*=\s*0")


def _parse_bound(tok: str) -> float:
    tok = tok.strip()
    if tok in ("+inf", "inf", "+infinity", "infinity"):
        return INF
    if tok in ("-inf", "-infinity"):
        return -INF
    return float(tok)


def _parse_coef(tok: str) -> float:
    tok = tok.replace(" ", "")
    if tok in ("", "+"):
        return 1.0
    if tok == "-":
        return -1.0
    return float(tok)


def read_cip(path: str, name: Optional[str] = None) -> MISDP:
    with _open(path) as f:
        lines = f.read().splitlines()
    if name is None:
        name = re.sub(r"\.cip(\.gz)?$", "", path.split("/")[-1])

    sense = 1.0
    varnames: List[str] = []
    varindex: Dict[str, int] = {}
    obj: List[float] = []
    lb: List[float] = []
    ub: List[float] = []
    integral: List[bool] = []

    section = None
    i = 0
    cons_lines: List[str] = []
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line in ("STATISTICS", "OBJECTIVE", "VARIABLES", "FIXED",
                    "CONSTRAINTS", "END"):
            section = line
            continue
        if not line:
            continue
        if section == "OBJECTIVE":
            m = re.match(r"Sense\s*:\s*(\w+)", line)
            if m:
                sense = -1.0 if m.group(1).lower().startswith("max") else 1.0
        elif section == "VARIABLES":
            m = _VAR_RE.search(line)
            if not m:
                raise ReadError(f"cannot parse variable line: {line}")
            vtype, vname, vobj, lo, hi = m.groups()
            varindex[vname] = len(varnames)
            varnames.append(vname)
            obj.append(float(vobj))
            lb.append(_parse_bound(lo))
            ub.append(_parse_bound(hi))
            integral.append(vtype in ("binary", "integer"))
        elif section == "CONSTRAINTS":
            cons_lines.append(line)

    nvars = len(varnames)

    # join multi-line constraints (terminated by ';')
    joined: List[str] = []
    buf = ""
    for line in cons_lines:
        buf = (buf + " " + line).strip()
        if buf.endswith(";"):
            joined.append(buf[:-1])
            buf = ""
    if buf:
        joined.append(buf)

    rows: List[Tuple[List[int], List[float], float, float]] = []
    rowname: Dict[str, int] = {}
    blocks: List[SDPBlock] = []
    indicators: List[IndicatorLink] = []
    quadcons: List[QuadConstraint] = []

    for cons in joined:
        m = re.match(r"\[(\w+)\]\s*<([^>]+)>\s*:\s*(.*)", cons, re.S)
        if not m:
            raise ReadError(f"cannot parse constraint: {cons[:80]}")
        ctype, cname, body = m.groups()
        if ctype == "linear":
            # forms: terms <= rhs | terms >= rhs | terms == rhs |
            #        lhs <= terms <= rhs
            mm = re.match(r"(.*?)(<=|>=|==)(.*)", body, re.S)
            if not mm:
                raise ReadError(f"cannot parse linear constraint: {body[:80]}")
            left, op, right = mm.groups()
            mm2 = re.match(r"(.*?)(<=|>=)(.*)", right, re.S)
            if mm2 and "<" in right and mm2.group(2) in ("<=", ">="):
                # ranged: lhs <= terms <= rhs
                lo = float(left)
                terms = mm2.group(1)
                hi = float(mm2.group(3))
            else:
                terms = left
                val = float(right)
                if op == "<=":
                    lo, hi = -INF, val
                elif op == ">=":
                    lo, hi = val, INF
                else:
                    lo = hi = val
            inds, vals = [], []
            for coef, vname in _TERM_RE.findall(terms):
                if vname not in varindex:
                    raise ReadError(f"unknown variable <{vname}>")
                inds.append(varindex[vname])
                vals.append(_parse_coef(coef))
            rowname[cname] = len(rows)
            rows.append((inds, vals, lo, hi))
        elif ctype == "SDP" or ctype == "SDPrank1":
            mm = re.match(r"(\d+)\s*(.*)", body, re.S)
            if not mm:
                raise ReadError(f"cannot parse SDP constraint: {body[:80]}")
            size = int(mm.group(1))
            rest = mm.group(2)
            rank1 = ctype == "SDPrank1"
            mr = re.search(r"rank-1\?\s*(\d)", rest)
            if mr:
                rank1 = rank1 or mr.group(1) == "1"
            var_l, row_l, col_l, val_l = [], [], [], []
            crow, ccol, cval = [], [], []
            # split into "<token>: entries" chunks: A_0 or variable names
            for chunk in re.finditer(
                    r"(A_0|<[^>]+>)\s*:\s*((?:\([^)]*\)[^,<A]*,?\s*)*)", rest):
                tag, entries = chunk.groups()
                for r, c, v in _ENTRY_RE.findall(entries):
                    r, c, v = int(r), int(c), float(v)
                    if r >= size or c >= size:
                        raise ReadError(
                            f"SDP entry ({r},{c}) outside block of size {size}")
                    if tag == "A_0":
                        crow.append(r)
                        ccol.append(c)
                        cval.append(v)
                    else:
                        vname = tag[1:-1]
                        if vname not in varindex:
                            raise ReadError(f"unknown variable <{vname}>")
                        var_l.append(varindex[vname])
                        row_l.append(r)
                        col_l.append(c)
                        val_l.append(v)
            blocks.append(
                SDPBlock(
                    size=size,
                    var=np.array(var_l, np.int32),
                    row=np.array(row_l, np.int32),
                    col=np.array(col_l, np.int32),
                    val=np.array(val_l),
                    const_row=np.array(crow, np.int32),
                    const_col=np.array(ccol, np.int32),
                    const_val=np.array(cval),
                    rank1=rank1,
                )
            )
        elif ctype == "quadratic":
            mm = re.match(r"(.*?)(<=|>=|==)\s*([+-]?\d*\.?\d+(?:[eE][+-]?\d+)?)\s*$",
                          body, re.S)
            if not mm:
                raise ReadError(
                    f"cannot parse quadratic constraint: {body[:80]}")
            terms, op, rhs_tok = mm.groups()
            val = float(rhs_tok)
            if op == "<=":
                lo, hi = -INF, val
            elif op == ">=":
                lo, hi = val, INF
            else:
                lo = hi = val
            lin_i, lin_v, qr, qc_, qv = [], [], [], [], []
            for coef, v1, sq, v2 in _QTERM_RE.findall(terms):
                if not v1:
                    continue
                if v1 not in varindex:
                    raise ReadError(f"unknown variable <{v1}>")
                c = _parse_coef(coef)
                if sq:
                    qr.append(varindex[v1])
                    qc_.append(varindex[v1])
                    qv.append(c)
                elif v2:
                    if v2 not in varindex:
                        raise ReadError(f"unknown variable <{v2}>")
                    qr.append(varindex[v1])
                    qc_.append(varindex[v2])
                    qv.append(c)
                else:
                    lin_i.append(varindex[v1])
                    lin_v.append(c)
            quadcons.append(QuadConstraint(
                lin_ind=lin_i, lin_val=lin_v, qrow=qr, qcol=qc_, qval=qv,
                lhs=lo, rhs=hi, name=cname))
        elif ctype == "indicator":
            mm = _IND_RE.search(body)
            if not mm:
                raise ReadError(f"cannot parse indicator constraint: {body[:80]}")
            bvar, svar = mm.groups()
            if bvar not in varindex or svar not in varindex:
                raise ReadError(f"unknown indicator variables {bvar}/{svar}")
            indicators.append(
                IndicatorLink(binvar=varindex[bvar],
                              slackvar=varindex[svar], row=-1))
        else:
            raise ReadError(f"unsupported CIP constraint type [{ctype}]")

    lp = LinearConstraints.from_rows(rows) if rows else LinearConstraints.empty()
    # attach row index to indicator links where the slack variable appears
    for link in indicators:
        for ri, (inds, vals, lo, hi) in enumerate(rows):
            if link.slackvar in inds:
                link.row = ri
                break

    prob = MISDP(
        nvars=nvars,
        obj=np.asarray(obj) * sense,
        lb=np.asarray(lb),
        ub=np.asarray(ub),
        integral=np.asarray(integral, dtype=bool),
        blocks=blocks,
        lp=lp,
        indicators=indicators,
        quadcons=quadcons,
        name=name,
        varnames=varnames,
        objsense=sense,
    )
    prob.validate()
    return prob
