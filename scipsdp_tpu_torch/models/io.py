"""Problem I/O dispatch (extension-based, with .gz support).

Analog of SCIP's reader registry: SCIP-SDP registers two readers
(reader_sdpa.c, reader_cbf.c; scipsdpdefplugins.c:208-269).

numpy only: a copy of the JAX package's ``models/io.py``,
kept beside it rather than imported so this package never imports JAX.
"""

from __future__ import annotations

from scipsdp_tpu_torch.models.problem import MISDP
from scipsdp_tpu_torch.models.reader_cbf import read_cbf
from scipsdp_tpu_torch.models.reader_cip import read_cip
from scipsdp_tpu_torch.models.reader_sdpa import ReadError, read_sdpa

__all__ = ["read_problem", "ReadError"]


def _remove_small_values(prob: MISDP, eps: float) -> MISDP:
    """Drop |coefficient| < eps from SDP blocks and LP rows on read
    (``reading/removesmallval``, scipsdpdefplugins.c:199-201): tiny stray
    coefficients destabilize the IPM's scaling without carrying
    information at the 1e-5 solver tolerances."""
    import dataclasses

    import numpy as np

    changed = False
    blocks = []
    for blk in prob.blocks:
        val = np.asarray(blk.val, dtype=np.float64)
        keep = np.abs(val) >= eps
        cval = np.asarray(blk.const_val, dtype=np.float64)
        ckeep = np.abs(cval) >= eps
        if keep.all() and ckeep.all():
            blocks.append(blk)
            continue
        changed = True
        blocks.append(dataclasses.replace(
            blk,
            var=np.asarray(blk.var)[keep], row=np.asarray(blk.row)[keep],
            col=np.asarray(blk.col)[keep], val=val[keep],
            const_row=np.asarray(blk.const_row)[ckeep],
            const_col=np.asarray(blk.const_col)[ckeep],
            const_val=cval[ckeep]))
    lp = prob.lp
    small = np.abs(lp.val) < eps if lp.nrows else None
    if small is not None and small.any():
        changed = True
        rows = []
        for i in range(lp.nrows):
            s, e = lp.beg[i], lp.beg[i + 1]
            keep = ~small[s:e]
            rows.append((lp.ind[s:e][keep].tolist(),
                         lp.val[s:e][keep].tolist(),
                         float(lp.lhs[i]), float(lp.rhs[i])))
        from scipsdp_tpu_torch.models.problem import LinearConstraints
        lp = LinearConstraints.from_rows(rows)
    if not changed:
        return prob
    return dataclasses.replace(prob, blocks=blocks, lp=lp)


def read_problem(path: str, remove_small_val: bool = True,
                 small_val_eps: float = 1e-9) -> MISDP:
    base = path[:-3] if path.endswith(".gz") else path
    if base.endswith(".dat-s") or base.endswith(".dat"):
        prob = read_sdpa(path)
    elif base.endswith(".cbf"):
        prob = read_cbf(path)
    elif base.endswith(".cip"):
        prob = read_cip(path)
    else:
        raise ReadError(f"unknown problem file extension: {path}")
    if remove_small_val:
        prob = _remove_small_values(prob, small_val_eps)
    return prob
