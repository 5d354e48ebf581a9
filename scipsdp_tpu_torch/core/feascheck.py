"""Batched feasibility check of candidate points.

Counterpart of ``scipsdp_tpu/core/feascheck.py``: the SDP constraint
handler's check (smallest eigenvalue of Z(y) >= -feastol per block,
cons_sdp.c:672-729) plus LP rows and bounds, as in the independent
solution checker (sdpsolchecker.c:58).  One batched ``eigvalsh`` per size
bucket decides feasibility for a whole batch of points on ``data``'s
device.
"""

from __future__ import annotations

import torch

from scipsdp_tpu_torch.ops.eigen import min_eigenvalue
from scipsdp_tpu_torch.ops.ipm import IPMData


def check_points(data: IPMData, y, lb, ub, feastol: float = 1e-5):
    """y: (B, m) candidate points (no penalty variable), lb/ub: (B, m);
    tensors or numpy arrays.  Returns (feasible (B,) bool, viol (B,)):
    ``viol`` is the largest constraint violation (0 if feasible)."""

    def tens(x):
        return torch.as_tensor(x, dtype=torch.float64, device=data.device)

    y, lb, ub = tens(y), tens(lb), tens(ub)
    B = y.shape[0]
    yx = torch.cat([y, y.new_zeros((B, 1))], dim=1)
    viol = y.new_zeros((B,))
    for t in range(data.nbuckets):
        Z = torch.einsum("kjab,xj->xkab", data.A[t], yx) - data.C[t][None]
        lam = min_eigenvalue(Z, data.dimmask[t][None].expand(Z.shape[:-1]))
        viol = torch.maximum(viol, torch.clamp_min(-lam, 0.0).amax(dim=1))
    Gy = torch.einsum("pm,xm->xp", data.G, yx)
    lp_viol = torch.clamp_min(data.h[None] - Gy, 0.0).amax(dim=1)
    lb_viol = torch.clamp_min(torch.where(lb > -1e19, lb - y, 0.0),
                              0.0).amax(dim=1)
    ub_viol = torch.clamp_min(torch.where(ub < 1e19, y - ub, 0.0),
                              0.0).amax(dim=1)
    viol = torch.maximum(viol, torch.maximum(lp_viol,
                                             torch.maximum(lb_viol, ub_viol)))
    return viol <= feastol, viol
