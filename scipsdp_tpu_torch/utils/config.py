"""Typed configuration tree.

The same fields and defaults as the JAX package's ``utils/config.py``: the
reference's parameter registry (SCIP params plus the ``relaxing/SDP/*``
params of relax_sdp.c:5374-5560, the SDPI params of src/sdpi/sdpi.c:197-203
and type_sdpi.h:47-66, and SCIP-SDP's re-defaulted SCIP params,
scipsdpdefplugins.c:127-204) as plain frozen dataclasses.  Only
:func:`resolve_backend_autos` differs: it resolves the "auto" knobs from a
``torch.device`` instead of the active JAX backend.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IPMSettings:
    """Interior-point solver parameters (replaces DSDP/SDPA/MOSEK knobs).

    Tolerance semantics follow the reference: ``gaptol`` is the relative
    duality-gap stopping criterion (relaxing/SDP/sdpsolvergaptol, default
    1e-5, relax_sdp.c:70-71), ``feastol`` the feasibility tolerance of the
    returned solution (relaxing/SDP/sdpsolverfeastol, 1e-5).
    """

    gaptol: float = 1e-5
    feastol: float = 1e-5
    epsilon: float = 1e-9          # equality test (sdpi.c DEFAULT_EPSILON)
    max_iters: int = 100           # IPM iteration cap per solve attempt
    # penalty formulation ladder (sdpi.c:197-203, sdpisolver.h:237-245):
    # a gentle starting Gamma, escalated toward maxpenaltyparam
    penaltyparam: float = 1e3      # starting Gamma
    maxpenaltyparam: float = 1e10  # maximal Gamma
    npenaltyincr: int = 8          # number of Gamma increases
    peninfeasadjust: float = 1.1   # infeasibility margin (relax_sdp.c:96)
    min_gaptol: float = 1e-10      # MIN_GAPTOL floor when the ladder
                                   # tightens gaptol (sdpi.c:56,3507)
    penaltyboundtol: float = 1e-3  # Tr(X) ~ Gamma relative tolerance
                                   # (PENALTYBOUNDTOL, sdpisolver_dsdp.c:61)
    # numerics
    dtype: str = "float64"         # "float64" | "float32"
    mixed_precision: str = "off"   # "on": fast f32 solve first, failures
                                   # escalated to f64 (the reference's
                                   # fast->stable settings tiers)
    phase32: str = "auto"          # mixed precision INSIDE one solve:
                                   # "on" (f32 directions while every
                                   # active relative gap is above
                                   # phase32_switch), "lite", "refine"
                                   # (f32 factors, f64 assembly and refined
                                   # Schur solves) or "off" (all f64)
    phase32_switch: float = 1e-3   # relative-gap handoff point
    refine_switch: float = 0.0     # relative-gap f64 handoff for "refine"
    schur_refine: int = 3          # f64 refinement passes on the Schur
                                   # solve in "refine"/"lite" mode
    gondzio: int = 0               # extra Gondzio centrality correctors
                                   # per iteration (0 = plain Mehrotra)
    # stall detection: declare FAILED after ``stall_window`` iterations
    # without a ``stall_factor`` merit (relgap+pinf+dinf) improvement
    stall_factor: float = 0.8
    stall_window: int = 15
    # what to do when an f32/refine direction NaNs: "repair" = one f64
    # iteration, then back to the f32 tier; "fail" = mark the instance
    # FAILED and leave it to the recovery ladder
    nan32_policy: str = "repair"
    tau: float = 0.95              # fraction-to-boundary step factor
    sigma_min: float = 1e-8        # minimum centering parameter
    chol_reg: float = 1e-12        # Schur diagonal regularization (relative)
    init_point_scale: float = 1.0  # lambda*-style initial point scaling
                                   # (SDPA lambdastar, relax_sdp.c:74),
                                   # multiplied by per-instance data norms
    presolve_rounds: int = 3       # vectorized prepareLPData passes
                                   # (sdpi.c:1131 loop)
    warmstartipfactor: float = 0.5  # identity share in warmstart convex
                                    # combination (DEFAULT_WARMSTARTIPFACTOR)
    preopt_gap: float = 0.0        # > 0: snapshot the first iterate whose
                                   # relative gap drops below this value
                                   # (sdpisolver_sdpa.cpp:1612-1618); 0 = off
    onevar: bool = True            # one-active-variable fast path
                                   # (SCIPsolveOneVarSDP, sdpi.c:3301-3381)
    use_pallas: bool = False       # hand-written kernels for the Schur
                                   # product and the factor-quality
                                   # Cholesky / triangular inverse
    use_lanes_chol: str = "auto"   # hand-written batched Cholesky for the
                                   # PSD PROBE sites only (the caller just
                                   # tests NaN); factor-quality sites stay
                                   # on the library factorization.
                                   # "auto" = on for an accelerator
    use_df32: str = "auto"         # compensated kernels for the refine
                                   # tier's exact contractions
    fused_direction: str = "auto"  # fused direction kernels (rhs assembly,
                                   # Schur solve + refinement, recovery)
                                   # in the refine tier with use_df32 not
                                   # "off": "auto" and "on" fuse, "off"
                                   # runs the separate contractions; inert
                                   # outside the refine tier
    step_rule: str = "auto"        # PSD max-step: "probe" (Gershgorin base
                                   # + ONE stacked f32 Cholesky over a
                                   # geometric candidate ladder, certified
                                   # via PSD-segment convexity, within 2x
                                   # of the exact step), "eigh" (exact),
                                   # "power" (iteration + probe repair) or
                                   # "gershgorin" (conservative);
                                   # "auto" = "probe" on an accelerator,
                                   # "eigh" on CPU


@dataclasses.dataclass(frozen=True)
class BBSettings:
    """Branch-and-bound orchestration parameters."""

    # SCIP-SDP re-defaults (scipsdpdefplugins.c:127-204)
    feastol: float = 1e-5          # numerics/feastol
    dualfeastol: float = 1e-5      # numerics/dualfeastol
    gaplimit: float = 0.0          # relative B&B gap limit
    node_limit: int = 1_000_000
    time_limit: float = 1e20
    lp_host_simplex: bool = True   # LP-mode node relaxations via a host
                                   # dual simplex instead of the batched IPM
    # best-first node selection is the reference default because SDP
    # warmstarts are weak (scipsdpdefplugins.c:152-158)
    node_selection: str = "bestbound"
    branching_rule: str = "infobjective"
    batch_size: int = 16           # open nodes solved per device step
    heuristic_fracround: bool = True  # heur_sdpfracround.c analog
    heuristic_rand: bool = True    # heur_sdprand.c analog
    heuristic_innerlp: bool = False   # heur_sdpinnerlp.c analog
    diving_freq: int = 0           # heur_sdpfracdiving every N batches
    obbt_at_root: bool = False     # prop_sdpobbt root tightening
    prop_freq: int = 1             # SDP-structural propagation cadence
                                   # (cons_sdp.c:7046); 0 = off
    obbt_freq: int = -1            # in-tree OBBT every k-th depth
                                   # (prop_sdpobbt.c; -1 = off)
    enableproptiming: bool = False  # per-routine propagation timing
                                    # (cons_sdp.c:265-292)
    conflict_nogoods: bool = True  # binary no-goods from propagation
                                   # conflicts (cons_sdp.c:4793,5138)
    warmstart: bool = False        # relaxing/SDP/warmstart (DEFAULT FALSE)
    # warmstart recipe knobs (relax_sdp.c:77-86 defaults)
    warmstartproject: int = 2      # DEFAULT_WARMSTARTPROJECT
    warmstartiptype: int = 1       # DEFAULT_WARMSTARTIPTYPE: 1 scaled
                                   # identity, 2 root analytic centers
    warmstartprimal: bool = True   # parent X as the IPM primal start
                                   # (fillStartX, relax_sdp.c:2959-3049)
    warmstartroundonlyinf: bool = False  # DEFAULT_WARMSTARTROUNDONLYINF
    warmstartpreoptsol: bool = False  # warmstart from a PRE-optimal iterate
                                      # (sdpisolver_sdpa.cpp:1612-1618)
    warmstartpreoptgap: float = 1e-2  # relative gap of that iterate
    objlimit_pruning: bool = True
    # conflict constraints from relaxation certificates (relax_sdp.c:100-105)
    conflictconss: bool = True     # DEFAULT_CONFLICTCONSS
    conflictfeas: bool = True      # DEFAULT_CONFLICTFEAS (feasible nodes)
    conflictinfeas: bool = True    # DEFAULT_CONFLICTINFEAS (Farkas rows)
    conflictcmir: bool = False     # DEFAULT_CONFLICTCMIR
    max_conflict_rows: int = 256   # rolling cap on stored conflict rows
    # device-resident B&B: "auto" | "on" | "off"
    turbo: str = "auto"
    turbo_capacity: int = 2048     # frontier slab slots
    turbo_rounds: int = 32         # B&B rounds fused per device dispatch
    turbo_adaptive_batch: bool = True  # ramp the batch width with the
                                       # live frontier
    # LP-mode exact enforcement (constraints/SDP/enforcesdp,
    # cons_sdp.c:8276-8423)
    enforcesdp: bool = True
    enforce_after: int = 4         # separation requeues before the exact
                                   # SDP probing solve
    usedimacsfeastol: bool = False  # DIMACS-scaled eigenvalue tolerance
                                    # (cons_sdp.c:703-710,7716-7727)
    slatercheck: int = 0           # per-node dual Slater accounting
                                   # (sdpi.c:197: 0 off, 1 stats, 2 print)


@dataclasses.dataclass(frozen=True)
class PresolveSettings:
    """Problem-level presolve switches (constraints/SDP/* params,
    cons_sdp.c:123-127 — defaults mirror the reference)."""

    diaggezerocuts: bool = False   # DEFAULT_DIAGGEZEROCUTS
    twominorlinconss: bool = False  # DEFAULT_TWOMINORLINCONSS
    move_1x1_blocks: bool = True    # move_1x1_blocks_to_lp
    diagzeroimplcuts: bool = True   # DEFAULT_DIAGZEROIMPLCUTS
    twominorprodconss: bool = False  # DEFAULT_TWOMINORPRODCONSS
    twominorsocconss: bool = False   # DEFAULT_TWOMINORSOCCONSS
                                     # (cons_sdp.c:2786-2807)
    twominorvarbounds: bool = True  # DEFAULT_TWOMINORVARBOUNDS
    tightenmatrices: bool = False   # DEFAULT_TIGHTENMATRICES
    fixvars: bool = True            # eliminate fixed variables
    aggregate: bool = True          # doubleton-equality aggregation
    # 0: generated linear rows only propagate (LP mode also separates);
    # 1: rows join the relaxation (DEFAULT_PRESOLLINCONSSPARAM = 0)
    presollinconssparam: int = 0


@dataclasses.dataclass(frozen=True)
class CutSettings:
    """Eigenvector-cut separation switches (constraints/SDP/* params,
    cons_sdp.c:133-145 — defaults mirror the reference)."""

    generatecmir: bool = True        # DEFAULT_GENERATECMIR
    separateonecut: bool = False     # DEFAULT_SEPARATEONECUT
    multiplesparsecuts: bool = False  # DEFAULT_MULTIPLESPARSECUTS
    maxnsparsecuts: int = 0          # DEFAULT_MAXNSPARSECUTS (-1: no limit)
    sparsifyfactor: float = 0.1      # DEFAULT_SPARSIFYFACTOR
    sparsifytargetsize: int = -1     # DEFAULT_SPARSIFYTARGETSIZE


@dataclasses.dataclass(frozen=True)
class Settings:
    ipm: IPMSettings = dataclasses.field(default_factory=IPMSettings)
    bb: BBSettings = dataclasses.field(default_factory=BBSettings)
    presolve: PresolveSettings = dataclasses.field(
        default_factory=PresolveSettings)
    cuts: CutSettings = dataclasses.field(default_factory=CutSettings)
    # misc/solvesdps: 1 = nonlinear B&B with SDP relaxations (default),
    # 0 = LP outer approximation with eigenvector cuts (relax_sdp.c:5428)
    solve_sdps: int = 1
    use_symmetry: bool = False
    symmetry_mode: str = "lexrows"   # "lexrows" | "orbital"
    use_mesh: bool = False
    mesh_devices: int = 0            # 0 = all local devices
    verbosity: int = 0
    seed: int = 0

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


def default_settings(**kw) -> Settings:
    return Settings(**kw)


def resolve_backend_autos(settings: Settings, device) -> Settings:
    """Resolve the device-dependent "auto" IPM knobs for ``device`` (a
    ``torch.device`` or anything it accepts); idempotent.

    CUDA: ``step_rule="probe"`` with the hand-written probe Cholesky
    (``use_lanes_chol=True``) and ``phase32="off"``.  phase32 is "off" on
    the H100 because the card has native FP64; whether the f32 refine tier
    pays there anyway is an open measurement.  CPU: ``"eigh"``, ``False``
    and ``"off"``, as the JAX package resolves them on its CPU backend.
    """
    import torch

    ipm = settings.ipm
    cpu = torch.device(device).type == "cpu"
    repl = {}
    if ipm.step_rule == "auto":
        repl["step_rule"] = "eigh" if cpu else "probe"
    if ipm.use_lanes_chol == "auto":
        repl["use_lanes_chol"] = not cpu
    if ipm.phase32 == "auto":
        repl["phase32"] = "off"
    if not repl:
        return settings
    return dataclasses.replace(
        settings, ipm=dataclasses.replace(ipm, **repl))
