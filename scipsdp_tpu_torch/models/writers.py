"""Problem writers: extended SDPA ``.dat-s`` and CBF.

Analog of the reference's writer halves (reader_sdpa.c SCIP_DECL_READERWRITE,
reader_cbf.c CBFwrite): emit a MISDP in either format such that reading it
back yields an equivalent problem (the round-trip property tested by
unittests/src/readwrite.c).

Limitations mirroring the data model: variable bounds are emitted as LP
rows in SDPA form (the format has no bound section); indicator constraints
are emitted with the negative-variable-index extension in SDPA form and are
not representable in CBF (error, like the reference's CBF writer for
unsupported constructs).

numpy only: a copy of the JAX package's ``models/writers.py``,
kept beside it rather than imported so this package never imports JAX.
"""

from __future__ import annotations

from typing import List

import numpy as np

from scipsdp_tpu_torch.models.problem import INF, MISDP


def transformed_for_write(prob: MISDP) -> MISDP:
    """Fold propagation-only generated rows (diagzeroimpl / 2-minor /
    varbound classes, core/presolve_sdp.py) into the LP section so the
    TRANSFORMED problem can be written.

    Reference parity: SCIP-SDP's CBF writer learned to emit the transformed
    problem's knapsack/logicor/setppc/varbound constraint classes as linear
    constraints (changelog.txt:6-11) — our presolve represents all of those
    as generated LinearConstraints rows, merged here."""
    import dataclasses

    if prob.proprows is None or prob.proprows.nrows == 0:
        return prob
    pr = prob.proprows
    rows = []
    for i in range(pr.nrows):
        s, e = pr.beg[i], pr.beg[i + 1]
        rows.append((pr.ind[s:e].tolist(), pr.val[s:e].tolist(),
                     float(pr.lhs[i]), float(pr.rhs[i])))
    from scipsdp_tpu_torch.core.presolve_sdp import _append_rows
    return dataclasses.replace(prob, lp=_append_rows(prob.lp, rows),
                               proprows=None)


def write_problem(prob: MISDP, path: str, transformed: bool = False) -> None:
    """Write in the format implied by the extension (.dat-s / .cbf / .cip);
    transformed=True folds generated propagation rows in first."""
    if transformed:
        prob = transformed_for_write(prob)
    if path.endswith(".cbf"):
        write_cbf(prob, path)
    elif path.endswith(".cip"):
        write_cip(prob, path)
    else:
        write_sdpa(prob, path)


def write_sdpa(prob: MISDP, path: str) -> None:
    """Write the extended sparse SDPA format (sdpa_format.txt)."""
    # assemble LP rows in >=-form: original rows (lhs then rhs sides would
    # change row count; SDPA rows are single-sided >=) plus finite bounds
    rows: List[tuple] = []   # (coefs dict var->val, rhs, indvar or None)
    D = prob.lp.dense(prob.nvars)
    for i in range(prob.lp.nrows):
        ind = None
        for link in prob.indicators:
            if link.row == i:
                ind = link.binvar
        coefs = {j: D[i, j] for j in np.nonzero(D[i])[0]}
        if ind is not None:
            # drop the slack variable column (implied by the extension)
            slack = [l.slackvar for l in prob.indicators if l.row == i]
            for s in slack:
                coefs.pop(s, None)
        if prob.lp.lhs[i] > -INF:
            rows.append((coefs, prob.lp.lhs[i], ind))
        if prob.lp.rhs[i] < INF:
            rows.append(({j: -v for j, v in coefs.items()},
                         -prob.lp.rhs[i], ind))
    slackvars = {l.slackvar for l in prob.indicators}
    for j in range(prob.nvars):
        if j in slackvars:
            continue
        binvars = {l.binvar for l in prob.indicators}
        if prob.lb[j] > -INF and not (j in binvars and prob.lb[j] == 0.0):
            rows.append(({j: 1.0}, prob.lb[j], None))
        if prob.ub[j] < INF and not (j in binvars and prob.ub[j] == 1.0):
            rows.append(({j: -1.0}, -prob.ub[j], None))

    nblocks = prob.nblocks + (1 if rows else 0)
    lp_index = prob.nblocks + 1  # 1-based

    lines = []
    lines.append(f"{prob.nvars}")
    lines.append(f"{nblocks}")
    sizes = [str(b.size) for b in prob.blocks]
    if rows:
        sizes.append(str(-len(rows)))
    lines.append(" ".join(sizes))
    lines.append(" ".join(repr(float(v)) for v in prob.obj))

    for bi, blk in enumerate(prob.blocks, 1):
        for v, r, c, val in zip(blk.var, blk.row, blk.col, blk.val):
            lines.append(f"{v + 1} {bi} {r + 1} {c + 1} {float(val)!r}")
        for r, c, val in zip(blk.const_row, blk.const_col, blk.const_val):
            lines.append(f"0 {bi} {r + 1} {c + 1} {float(val)!r}")
    for ri, (coefs, rhs, ind) in enumerate(rows, 1):
        for j, val in sorted(coefs.items()):
            if val != 0.0:
                lines.append(f"{j + 1} {lp_index} {ri} {ri} {float(val)!r}")
        if rhs != 0.0 or not coefs:
            lines.append(f"0 {lp_index} {ri} {ri} {float(rhs)!r}")
        if ind is not None:
            lines.append(f"{-(ind + 1)} {lp_index} {ri} {ri} 1")

    ints = [j for j in range(prob.nvars) if prob.integral[j]]
    if ints:
        lines.append("*INTEGER")
        lines.extend(f"*{j + 1}" for j in ints)
    r1 = [bi for bi, blk in enumerate(prob.blocks, 1) if blk.rank1]
    if r1:
        lines.append("*RANK1")
        lines.extend(f"*{bi}" for bi in r1)

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_cip(prob: MISDP, path: str) -> None:
    """Write SCIP's CIP format (the subset read by reader_cip.py —
    cons_sdp.c's consPrintSdp:8714 syntax for SDP blocks, SCIP linear /
    quadratic / indicator constraint print formats)."""
    def vname(j):
        return (prob.varnames[j] if prob.varnames is not None
                else f"x{j}")

    def btok(x):
        if x >= INF:
            return "+inf"
        if x <= -INF:
            return "-inf"
        return repr(float(x))

    lines = ["STATISTICS", f"  Problem name: {prob.name}",
             "OBJECTIVE", "  Sense: minimize", "VARIABLES"]
    for j in range(prob.nvars):
        vtype = "integer" if prob.integral[j] else "continuous"
        if prob.integral[j] and prob.lb[j] == 0.0 and prob.ub[j] == 1.0:
            vtype = "binary"
        lines.append(
            f"  [{vtype}] <{vname(j)}>: obj={float(prob.obj[j])!r}, "
            f"original bounds=[{btok(prob.lb[j])},{btok(prob.ub[j])}]")
    lines.append("CONSTRAINTS")
    tag = {True: "I", False: "C"}

    D = prob.lp.dense(prob.nvars)
    ind_rows = {l.row for l in prob.indicators}
    for i in range(prob.lp.nrows):
        if i in ind_rows:
            continue   # emitted through the [indicator] constraint below
        terms = "".join(
            f" {'+' if D[i, j] >= 0 else '-'}{abs(float(D[i, j]))!r}"
            f"<{vname(j)}>[{tag[bool(prob.integral[j])]}]"
            for j in np.nonzero(D[i])[0])
        lo, hi = prob.lp.lhs[i], prob.lp.rhs[i]
        if lo > -INF and hi < INF and lo == hi:
            lines.append(f"  [linear] <lin{i}>:{terms} == {float(lo)!r};")
        elif lo > -INF and hi < INF:
            lines.append(f"  [linear] <lin{i}>: {float(lo)!r} <={terms} "
                         f"<= {float(hi)!r};")
        elif lo > -INF:
            lines.append(f"  [linear] <lin{i}>:{terms} >= {float(lo)!r};")
        else:
            lines.append(f"  [linear] <lin{i}>:{terms} <= {float(hi)!r};")

    for k, blk in enumerate(prob.blocks):
        ctype = "SDPrank1" if blk.rank1 else "SDP"
        parts = [f"  [{ctype}] <sdp{k}>: {blk.size}"]
        parts.append(f"    rank-1? {1 if blk.rank1 else 0}")
        centries = ", ".join(
            f"({r},{c}):{float(v)!r}" for r, c, v in
            zip(blk.const_row, blk.const_col, blk.const_val))
        parts.append(f"    A_0: {centries}")
        per_var = {}
        for v, r, c, val in zip(blk.var, blk.row, blk.col, blk.val):
            per_var.setdefault(int(v), []).append((int(r), int(c),
                                                   float(val)))
        for v, ents in sorted(per_var.items()):
            es = ", ".join(f"({r},{c}):{val!r}" for r, c, val in ents)
            parts.append(f"    <{vname(v)}>: {es}")
        lines.append("\n".join(parts) + ";")

    for qi, qc in enumerate(prob.quadcons):
        terms = []
        for r, c, v in zip(qc.qrow, qc.qcol, qc.qval):
            s = "+" if v >= 0 else "-"
            if r == c:
                terms.append(f"{s}{abs(float(v))!r}"
                             f"<{vname(int(r))}>[{tag[bool(prob.integral[r])]}]^2")
            else:
                terms.append(
                    f"{s}{abs(float(v))!r}"
                    f"<{vname(int(r))}>[{tag[bool(prob.integral[r])]}]"
                    f"<{vname(int(c))}>[{tag[bool(prob.integral[c])]}]")
        for j, v in zip(qc.lin_ind, qc.lin_val):
            s = "+" if v >= 0 else "-"
            terms.append(f"{s}{abs(float(v))!r}"
                         f"<{vname(int(j))}>[{tag[bool(prob.integral[j])]}]")
        body = " ".join(terms)
        if qc.lhs > -INF and qc.rhs < INF and qc.lhs == qc.rhs:
            lines.append(f"  [quadratic] <q{qi}>: {body} == {float(qc.lhs)!r};")
        elif qc.lhs > -INF:
            lines.append(f"  [quadratic] <q{qi}>: {body} >= {float(qc.lhs)!r};")
        else:
            lines.append(f"  [quadratic] <q{qi}>: {body} <= {float(qc.rhs)!r};")

    for li, link in enumerate(prob.indicators):
        lines.append(f"  [indicator] <ind{li}>: <{vname(link.binvar)}> = 1 "
                     f"-> <{vname(link.slackvar)}> = 0;")
        if link.row >= 0:
            i = link.row
            terms = "".join(
                f" {'+' if D[i, j] >= 0 else '-'}{abs(float(D[i, j]))!r}"
                f"<{vname(j)}>[{tag[bool(prob.integral[j])]}]"
                for j in np.nonzero(D[i])[0])
            lo, hi = prob.lp.lhs[i], prob.lp.rhs[i]
            if lo > -INF:
                lines.append(f"  [linear] <indlin{li}>:{terms} "
                             f">= {float(lo)!r};")
            else:
                lines.append(f"  [linear] <indlin{li}>:{terms} "
                             f"<= {float(hi)!r};")

    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_cbf(prob: MISDP, path: str) -> None:
    """Write CBF version 1 (reader_cbf.c CBFwrite analog).

    Scalar variables are emitted as free with bounds as L+/L- rows; SDP
    blocks become PSDCON constraints.  Indicator constraints are not
    representable in CBF.
    """
    if prob.indicators:
        raise ValueError("indicator constraints cannot be written to CBF")

    # user-facing objective: user = objsense * internal + objoffset; emit
    # the user's sense so write->read round-trips the original problem
    maximize = getattr(prob, "objsense", 1.0) < 0
    lines = ["VER", "1", "", "OBJSENSE", "MAX" if maximize else "MIN", ""]
    lines += ["VAR", f"{prob.nvars} 1", f"F {prob.nvars}", ""]

    ints = [j for j in range(prob.nvars) if prob.integral[j]]
    if ints:
        lines += ["INT", str(len(ints))] + [str(j) for j in ints] + [""]

    # scalar constraints: original rows (per finite side) + finite bounds
    con_rows: List[tuple] = []   # (coefs, b_const, cone)
    D = prob.lp.dense(prob.nvars)
    for i in range(prob.lp.nrows):
        coefs = {j: D[i, j] for j in np.nonzero(D[i])[0]}
        lo, hi = prob.lp.lhs[i], prob.lp.rhs[i]
        if lo > -INF and hi < INF and lo == hi:
            con_rows.append((coefs, -lo, "L="))
            continue
        if lo > -INF:
            con_rows.append((coefs, -lo, "L+"))
        if hi < INF:
            con_rows.append((coefs, -hi, "L-"))
    for j in range(prob.nvars):
        if prob.lb[j] > -INF:
            con_rows.append(({j: 1.0}, -prob.lb[j], "L+"))
        if prob.ub[j] < INF:
            con_rows.append(({j: 1.0}, -prob.ub[j], "L-"))

    # group by cone for the CON section (order: L=, L+, L-)
    order = {"L=": 0, "L+": 1, "L-": 2}
    con_rows.sort(key=lambda t: order[t[2]])
    counts = {c: sum(1 for r in con_rows if r[2] == c) for c in order}
    lines += ["CON", f"{len(con_rows)} {sum(1 for c in order if counts[c])}"]
    for c in ("L=", "L+", "L-"):
        if counts[c]:
            lines.append(f"{c} {counts[c]}")
    lines.append("")

    if prob.nblocks:
        lines += ["PSDCON", str(prob.nblocks)]
        lines += [str(b.size) for b in prob.blocks]
        lines.append("")
        r1 = [k for k, b in enumerate(prob.blocks) if b.rank1]
        if r1:
            lines += ["PSDCONRANK1", str(len(r1))] + [str(k) for k in r1]
            lines.append("")

    sense = -1.0 if maximize else 1.0
    objc = [(j, sense * v) for j, v in enumerate(prob.obj) if v != 0.0]
    lines += ["OBJACOORD", str(len(objc))]
    lines += [f"{j} {float(v)!r}" for j, v in objc]
    lines.append("")
    objoffset = float(getattr(prob, "objoffset", 0.0))
    if objoffset != 0.0:
        lines += ["OBJBCOORD", repr(objoffset), ""]

    acoord = []
    bcoord = []
    for i, (coefs, bconst, _) in enumerate(con_rows):
        for j, v in sorted(coefs.items()):
            if v != 0.0:
                acoord.append(f"{i} {j} {float(v)!r}")
        if bconst != 0.0:
            bcoord.append(f"{i} {float(bconst)!r}")
    lines += ["ACOORD", str(len(acoord))] + acoord + [""]
    lines += ["BCOORD", str(len(bcoord))] + bcoord + [""]

    hcoord = []
    dcoord = []
    for k, blk in enumerate(prob.blocks):
        for v, r, c, val in zip(blk.var, blk.row, blk.col, blk.val):
            hcoord.append(f"{k} {v} {r} {c} {float(val)!r}")
        # A_0 stored as subtracted constant: D = -A_0
        for r, c, val in zip(blk.const_row, blk.const_col, blk.const_val):
            dcoord.append(f"{k} {r} {c} {float(-val)!r}")
    lines += ["HCOORD", str(len(hcoord))] + hcoord + [""]
    lines += ["DCOORD", str(len(dcoord))] + dcoord + [""]

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
