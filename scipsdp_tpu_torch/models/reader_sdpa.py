"""Reader for the (extended) sparse SDPA format ``.dat-s``.

Implements the format described in the reference's ``sdpa_format.txt`` with
the SCIP-SDP extensions, matching the validation behavior of
``src/scipsdp/reader_sdpa.c`` (every corrupt input in
``unittests/instances/*.dat-s`` must raise :class:`ReadError`):

* header: #vars, #blocks, blocksizes (negative size = the single LP block),
  objective coefficients;
* entries ``n b i j v`` with n = 0 for the constant matrix A_0;
* LP block entries must be diagonal (reader_sdpa.c:1158-1165); LP rows are
  ``>=`` rows whose constant part is given with n = 0;
* ``*INTEGER`` section: one ``*<idx>`` line per integer variable (1-based);
* ``*RANK1`` section (after ``*INTEGER`` if present): ``*<idx>`` per rank-1
  SDP block;
* indicator extension: a *negative* variable index n <= -2 on an LP-block
  diagonal entry declares variable (-n - 1) (1-based) the binary indicator
  of that LP row; a fresh slack variable s >= 0 is added to the row and
  "binvar = 1 ==> s = 0" is recorded (reader_sdpa.c:1147-1252).

Variables read from SDPA files are unbounded continuous (or integer)
variables; bounds only arise through LP rows, except indicator variables
which become binary (reader_sdpa.c:1239-1243).

numpy only: a copy of the JAX package's ``models/reader_sdpa.py``,
kept beside it rather than imported so this package never imports JAX.
"""

from __future__ import annotations

import gzip
import math
import re
from typing import List, Optional, TextIO, Tuple

import numpy as np

from scipsdp_tpu_torch.models.problem import (
    INF,
    IndicatorLink,
    LinearConstraints,
    MISDP,
    SDPBlock,
)


class ReadError(Exception):
    """Raised on malformed input (analog of SCIP_READERROR)."""


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?")
_INT_RE = re.compile(r"^[+-]?\d+")


def _open(path: str) -> TextIO:
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _strip_comment(line: str) -> str:
    for ch in ('"', "*"):
        pos = line.find(ch)
        if pos >= 0:
            line = line[:pos]
    return line


def _parse_int(tok: str, what: str, lineno: int) -> int:
    m = _INT_RE.match(tok)
    if not m:
        raise ReadError(f"line {lineno}: could not parse integer {what} from '{tok}'")
    return int(m.group(0))


def _parse_float(tok: str, what: str, lineno: int) -> float:
    m = _NUM_RE.match(tok)
    if not m:
        raise ReadError(f"line {lineno}: could not parse value {what} from '{tok}'")
    return float(m.group(0).replace("d", "e").replace("D", "e"))


def read_sdpa(path: str, name: Optional[str] = None) -> MISDP:
    """Parse an extended SDPA ``.dat-s`` (optionally ``.gz``) file.

    Plain files go through the native C++ tokenizer
    (native/sdpa_parse.cpp) with vectorized validation; gz files and
    anything the native path rejects fall back to the pure-Python parser
    (identical validation semantics either way).
    """
    if name is None:
        name = re.sub(r"\.(dat-s|dat)(\.gz)?$", "", path.split("/")[-1])

    from scipsdp_tpu_torch.native import parse_sdpa_native

    tokens = parse_sdpa_native(path)
    if tokens is not None:
        try:
            return _assemble_from_tokens(tokens, name)
        except ReadError:
            raise
    return _read_sdpa_python(path, name)


def _assemble_from_tokens(tokens, name: str) -> MISDP:
    """Vectorized assembly + validation of natively tokenized SDPA data."""
    bs, obj, var, blk, row, col, val, ii, rr = tokens
    nvars = len(obj)
    nblocks = len(bs)
    if np.any(bs == 0):
        raise ReadError("block of size 0")
    lp_blocks = np.where(bs < 0)[0]
    if len(lp_blocks) > 1:
        raise ReadError("more than one LP block")
    lp_block = int(lp_blocks[0]) if len(lp_blocks) else -1
    nlprows = int(-bs[lp_block]) if lp_block >= 0 else 0
    if np.any(np.abs(obj) >= INF):
        raise ReadError("infinite objective coefficient")
    if np.any(~np.isfinite(val)) or np.any(np.abs(val) >= INF):
        raise ReadError("infinite/NaN entry value")
    if np.any((blk < 1) | (blk > nblocks)):
        raise ReadError("block index out of range")
    if np.any(var > nvars):
        raise ReadError("variable index exceeds nvars")

    is_lp = (blk - 1) == lp_block
    # LP block entries must be diagonal and in row range
    if np.any(is_lp & (row != col)):
        raise ReadError("LP-block entry not on the diagonal")
    if np.any(is_lp & ((row < 1) | (row > nlprows))):
        raise ReadError("LP row out of range")
    sdp_mask = ~is_lp
    if np.any(sdp_mask & (var < 0)):
        raise ReadError("negative variable index in SDP block")
    sizes_of = bs[blk - 1]
    if np.any(sdp_mask & ((row < 1) | (col < 1) | (row > sizes_of)
                          | (col > sizes_of))):
        raise ReadError("entry outside block")

    sdp_blocks = [b for b in range(nblocks) if b != lp_block]
    blocks = []
    for b in sdp_blocks:
        mask = (blk - 1) == b
        if not mask.any():
            raise ReadError(f"SDP block {b + 1} has no nonzero entries")
        mc = mask & (var == 0)
        mv = mask & (var >= 1)
        blocks.append(SDPBlock(
            size=int(bs[b]),
            var=(var[mv] - 1).astype(np.int32),
            row=(row[mv] - 1).astype(np.int32),
            col=(col[mv] - 1).astype(np.int32),
            val=val[mv],
            const_row=(row[mc] - 1).astype(np.int32),
            const_col=(col[mc] - 1).astype(np.int32),
            const_val=val[mc],
        ))

    lp_coef: List[List[Tuple[int, float]]] = [[] for _ in range(nlprows)]
    lp_lhs = np.zeros(nlprows)
    indicator_of_row: List[Optional[int]] = [None] * nlprows
    idx = np.where(is_lp)[0]
    for t in idx:
        r = int(row[t]) - 1
        v = int(var[t])
        if v >= 1:
            lp_coef[r].append((v - 1, float(val[t])))
        elif v == 0:
            lp_lhs[r] = float(val[t])
        else:
            indvar = -v - 1
            if indvar >= nvars:
                raise ReadError(f"indicator variable {-v} does not exist")
            indicator_of_row[r] = indvar
    for r in range(nlprows):
        if not lp_coef[r]:
            raise ReadError(f"LP row {r + 1} has no variable coefficients")

    integral = np.zeros(nvars, dtype=bool)
    for iv in ii:
        if iv < 1 or iv > nvars:
            raise ReadError(f"integer variable index {iv} invalid")
        integral[iv - 1] = True
    sdp_index = {b: k for k, b in enumerate(sdp_blocks)}
    rank1flags = [False] * len(sdp_blocks)
    for rv in rr:
        if rv < 1 or rv > nblocks:
            raise ReadError(f"rank-1 block index {rv} invalid")
        if rv - 1 == lp_block:
            raise ReadError("LP block cannot be rank 1")
        rank1flags[sdp_index[rv - 1]] = True
    for k, f in enumerate(rank1flags):
        blocks[k].rank1 = f

    return _finalize_sdpa(name, nvars, obj, integral, blocks, lp_coef,
                          lp_lhs, indicator_of_row)


def _read_sdpa_python(path: str, name: str) -> MISDP:
    with _open(path) as f:
        raw_lines = f.readlines()

    # split off the comment-section extensions (*INTEGER / *RANK1)
    int_section: List[Tuple[int, str]] = []
    rank1_section: List[Tuple[int, str]] = []
    data_lines: List[Tuple[int, str]] = []
    mode = "data"
    for lineno, line in enumerate(raw_lines, 1):
        stripped = line.strip()
        upper = stripped.upper()
        if upper.startswith("*INTEGER"):
            if mode == "rank1":
                raise ReadError(f"line {lineno}: *INTEGER section after *RANK1 section")
            mode = "integer"
            continue
        if upper.startswith("*RANK1"):
            mode = "rank1"
            continue
        if mode == "integer":
            if stripped.startswith("*"):
                int_section.append((lineno, stripped[1:].strip()))
                continue
            elif stripped:
                raise ReadError(
                    f"line {lineno}: lines in *INTEGER section must start with '*'")
        elif mode == "rank1":
            if stripped.startswith("*"):
                rank1_section.append((lineno, stripped[1:].strip()))
                continue
            elif stripped:
                raise ReadError(
                    f"line {lineno}: lines in *RANK1 section must start with '*'")
        cleaned = _strip_comment(line).strip()
        if cleaned:
            data_lines.append((lineno, cleaned))

    it = iter(data_lines)

    def next_line(what: str) -> Tuple[int, str]:
        try:
            return next(it)
        except StopIteration:
            raise ReadError(f"unexpected end of file while reading {what}") from None

    # ---- header -----------------------------------------------------------
    lineno, line = next_line("number of variables")
    nvars = _parse_int(line.split()[0], "number of variables", lineno)
    if nvars < 0:
        raise ReadError(f"line {lineno}: negative number of variables {nvars}")

    lineno, line = next_line("number of blocks")
    nblocks = _parse_int(line.split()[0], "number of blocks", lineno)
    if nblocks < 0:
        raise ReadError(f"line {lineno}: negative number of blocks {nblocks}")

    lineno, line = next_line("block sizes")
    toks = line.split()
    if len(toks) < nblocks:
        raise ReadError(f"line {lineno}: expected {nblocks} block sizes, got {len(toks)}")
    blocksizes: List[int] = []
    lp_block: Optional[int] = None
    nlprows = 0
    for bi in range(nblocks):
        sz = _parse_int(toks[bi], f"size of block {bi + 1}", lineno)
        if sz == 0:
            raise ReadError(f"line {lineno}: block {bi + 1} has size 0")
        if sz < 0:
            if lp_block is not None:
                raise ReadError(f"line {lineno}: more than one LP block")
            lp_block = bi
            nlprows = -sz
        blocksizes.append(sz)

    lineno, line = next_line("objective coefficients")
    toks = line.split()
    if len(toks) < nvars:
        raise ReadError(
            f"line {lineno}: expected {nvars} objective coefficients, got {len(toks)}")
    obj = np.array(
        [_parse_float(toks[j], f"objective of variable {j + 1}", lineno)
         for j in range(nvars)]
    )
    if np.any(np.abs(obj) >= INF):
        raise ReadError(f"line {lineno}: infinite objective coefficient")

    # ---- matrix entries ---------------------------------------------------
    sdp_blocks = [bi for bi in range(nblocks) if bi != lp_block]
    sdp_index = {bi: k for k, bi in enumerate(sdp_blocks)}
    bvar: List[List[int]] = [[] for _ in sdp_blocks]
    brow: List[List[int]] = [[] for _ in sdp_blocks]
    bcol: List[List[int]] = [[] for _ in sdp_blocks]
    bval: List[List[float]] = [[] for _ in sdp_blocks]
    crow: List[List[int]] = [[] for _ in sdp_blocks]
    ccol: List[List[int]] = [[] for _ in sdp_blocks]
    cval: List[List[float]] = [[] for _ in sdp_blocks]

    lp_coef: List[List[Tuple[int, float]]] = [[] for _ in range(nlprows)]
    lp_lhs = np.zeros(nlprows)
    indicator_of_row: List[Optional[int]] = [None] * nlprows  # 0-based binvar

    for lineno, line in it:
        toks = line.split()
        if len(toks) < 5:
            raise ReadError(f"line {lineno}: invalid entry line '{line}'")
        v = _parse_int(toks[0], "variable index", lineno)
        b = _parse_int(toks[1], "block index", lineno)
        i = _parse_int(toks[2], "row index", lineno)
        j = _parse_int(toks[3], "column index", lineno)
        val = _parse_float(toks[4], "entry value", lineno)

        if b < 1 or b > nblocks:
            raise ReadError(f"line {lineno}: block index {b} out of range 1..{nblocks}")
        b -= 1
        if v > nvars:
            raise ReadError(f"line {lineno}: variable index {v} exceeds nvars {nvars}")
        if abs(val) >= INF or math.isnan(val):
            raise ReadError(f"line {lineno}: infinite/NaN value")

        if b == lp_block:
            if i != j:
                raise ReadError(
                    f"line {lineno}: LP-block entry ({i},{j}) not on the diagonal")
            if i < 1 or i > nlprows:
                raise ReadError(
                    f"line {lineno}: LP row {i} out of range 1..{nlprows}")
            r = i - 1
            if v >= 1:
                lp_coef[r].append((v - 1, val))
            elif v == 0:
                lp_lhs[r] = val
            else:
                # indicator extension: negative variable index
                indvar = -v - 1  # file index -n -> variable (-n - 1) 1-based -> 0-based
                if indvar >= nvars:
                    raise ReadError(
                        f"line {lineno}: indicator variable {-v} does not exist")
                indicator_of_row[r] = indvar
        else:
            if v < 0:
                raise ReadError(
                    f"line {lineno}: negative variable index in SDP block {b + 1}")
            sz = blocksizes[b]
            if i < 1 or i > sz or j < 1 or j > sz:
                raise ReadError(
                    f"line {lineno}: entry ({i},{j}) outside block {b + 1} of size {sz}")
            k = sdp_index[b]
            if v == 0:
                crow[k].append(i - 1)
                ccol[k].append(j - 1)
                cval[k].append(val)
            else:
                bvar[k].append(v - 1)
                brow[k].append(i - 1)
                bcol[k].append(j - 1)
                bval[k].append(val)

    # each SDP block must contain at least one nonzero (reader_sdpa.c checks
    # exercised by blocks_SDPnononz / blocks_LPnononz)
    for k, bi in enumerate(sdp_blocks):
        if not bval[k] and not cval[k]:
            raise ReadError(f"SDP block {bi + 1} has no nonzero entries")
    for r in range(nlprows):
        if not lp_coef[r]:
            raise ReadError(f"LP row {r + 1} has no variable coefficients")

    # ---- extension sections ----------------------------------------------
    integral = np.zeros(nvars, dtype=bool)
    for lineno, tok in int_section:
        if not tok:
            raise ReadError(f"line {lineno}: empty *INTEGER entry")
        idx = _parse_int(tok, "integer variable index", lineno)
        if idx < 1 or idx > nvars:
            raise ReadError(f"line {lineno}: integer variable index {idx} invalid")
        integral[idx - 1] = True

    rank1 = [False] * len(sdp_blocks)
    for lineno, tok in rank1_section:
        if not tok:
            raise ReadError(f"line {lineno}: empty *RANK1 entry")
        idx = _parse_int(tok, "rank-1 block index", lineno)
        if idx < 1 or idx > nblocks:
            raise ReadError(f"line {lineno}: rank-1 block index {idx} invalid")
        if idx - 1 == lp_block:
            raise ReadError(f"line {lineno}: LP block cannot be rank 1")
        rank1[sdp_index[idx - 1]] = True

    blocks = []
    for k, bi in enumerate(sdp_blocks):
        blocks.append(
            SDPBlock(
                size=blocksizes[bi],
                var=np.array(bvar[k], dtype=np.int32),
                row=np.array(brow[k], dtype=np.int32),
                col=np.array(bcol[k], dtype=np.int32),
                val=np.array(bval[k]),
                const_row=np.array(crow[k], dtype=np.int32),
                const_col=np.array(ccol[k], dtype=np.int32),
                const_val=np.array(cval[k]),
                rank1=rank1[k],
            )
        )

    return _finalize_sdpa(name, nvars, obj, integral, blocks, lp_coef,
                          lp_lhs, indicator_of_row)


def _finalize_sdpa(name, nvars, obj, integral, blocks, lp_coef, lp_lhs,
                   indicator_of_row) -> MISDP:
    """Shared tail of both parse paths: indicator slack variables, bounds,
    LP row assembly, MISDP construction."""
    nlprows = len(lp_coef)
    lb = np.full(nvars, -INF)
    ub = np.full(nvars, INF)

    # indicator rows get a slack variable (obj 0, s >= 0) with coefficient 1
    indicators: List[IndicatorLink] = []
    extra_vars = 0
    obj_list = list(obj)
    for r in range(nlprows):
        iv = indicator_of_row[r]
        if iv is not None:
            sidx = nvars + extra_vars
            extra_vars += 1
            lp_coef[r].append((sidx, 1.0))
            indicators.append(IndicatorLink(binvar=iv, slackvar=sidx, row=r))
            obj_list.append(0.0)
    if extra_vars:
        obj = np.array(obj_list)
        lb = np.concatenate([lb, np.zeros(extra_vars)])
        ub = np.concatenate([ub, np.full(extra_vars, INF)])
        integral = np.concatenate([integral, np.zeros(extra_vars, dtype=bool)])
        for link in indicators:
            # indicator variables become binary (reader_sdpa.c:1239-1243)
            lb[link.binvar] = 0.0
            ub[link.binvar] = 1.0
            integral[link.binvar] = True
    ntot = nvars + extra_vars

    rows = []
    for r in range(nlprows):
        inds = [ij for ij, _ in lp_coef[r]]
        vals = [v for _, v in lp_coef[r]]
        rows.append((inds, vals, lp_lhs[r], INF))
    lp = LinearConstraints.from_rows(rows) if rows else LinearConstraints.empty()

    prob = MISDP(
        nvars=ntot,
        obj=np.asarray(obj, dtype=np.float64),
        lb=lb,
        ub=ub,
        integral=integral,
        blocks=blocks,
        lp=lp,
        indicators=indicators,
        name=name,
    )
    prob.validate()
    return prob
