"""Multi-process branch-and-bound (``scipsdp_tpu_torch/parallel/
multihost.py``) against the JAX package's ``parallel/multihost.py``.

The root partition and the lockstep sync's decisions are held to JAX's on
the same inputs (the sync driven by a scripted all-gather and process
index in both packages).  The real thing runs as in
``tests/test_multihost.py``: two OS processes join a ``torch.distributed``
gloo group, each solving on the CPU; the problem makes one process's root
partition infeasible, so it must steal nodes from the other, and both must
agree on the optimum.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models.problem import LinearConstraints, MISDP
from scipsdp_tpu.parallel import multihost as jmh
from scipsdp_tpu.utils.config import BBSettings, Settings
from scipsdp_tpu_torch.core import branchbound as tbb
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.parallel import multihost as tmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120

WORKER = r"""
import json, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out = sys.argv[4]
use_mesh = sys.argv[5] == "mesh"
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from scipsdp_tpu_torch.models.problem import (
    INF, LinearConstraints, MISDP, SDPBlock)
from scipsdp_tpu_torch.parallel.multihost import (
    initialize, solve_misdp_distributed)
from scipsdp_tpu_torch.utils.config import BBSettings, Settings

assert initialize(f"127.0.0.1:{port}", nproc, pid) == (pid, nproc)
# y0 is forced to 1 by the SDP block (Z = y0 - 1 >= 0); the root is
# partitioned on y0, so one process starts infeasible and must steal.
m = 6
obj = -np.array([1.0, 1.1, 1.2, 1.3, 0.9, 0.8])
blk = SDPBlock(size=1, var=[0], row=[0], col=[0], val=[1.0],
               const_row=[0], const_col=[0], const_val=[1.0])
lp = LinearConstraints.from_rows(
    [(list(range(m)), [1.0] * m, -INF, 2.0)])
prob = MISDP(nvars=m, obj=obj, lb=np.zeros(m), ub=np.ones(m),
             integral=np.ones(m, bool), blocks=[blk], lp=lp,
             name="steal")
res = solve_misdp_distributed(
    prob, Settings(bb=BBSettings(batch_size=2), use_mesh=use_mesh,
                   mesh_devices=2 if use_mesh else 0),
    sync_every=1, device="cpu")
json.dump({"pid": pid, "status": res.status.name, "objval": res.objval,
           "nstolen": res.stats.nstolen, "ndonated": res.stats.ndonated,
           "nodes": res.stats.nodes},
          open(out, "w"))
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _binary(n, name):
    return MISDP(nvars=n, obj=np.zeros(n), lb=np.zeros(n), ub=np.ones(n),
                 integral=np.ones(n, bool), blocks=[],
                 lp=LinearConstraints.empty(), name=name)


@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 8])
def test_partition_root_equals_jax(nparts):
    """The same boxes as JAX's on binaries (padding with empty boxes past
    the last one), on CLS (continuous variables first) and on a general
    integer box."""
    wide = _binary(2, "wide")
    wide.ub[:] = 5.0
    for jp in (_binary(2, "b2"), _binary(3, "b3"), wide,
               jfam.cardinality_least_squares(4, 8, 2, seed=1)):
        want = jmh.partition_root(jp, nparts)
        got = tmh.partition_root(problem_from_jax(jp), nparts)
        assert len(got) == len(want) == nparts
        for (tl, tu), (jl, ju) in zip(got, want):
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(tu, ju)


class Ctx:
    """A sync context that records what the hook asks of it."""

    def __init__(self, inc, bound, nopen, stopping=False, boxes=()):
        self.incumbent_val, self.best_open_bound = inc, bound
        self.nopen, self.stopping, self.nvars = nopen, stopping, 2
        self.boxes = list(boxes)
        self.log = []

    def adopt_incumbent(self, val):
        self.log.append(("adopt", val))
        self.incumbent_val = val

    def pop_for_donation(self, k):
        self.log.append(("pop", k))
        return self.boxes[:k]

    def push_nodes(self, nodes):
        self.log.append(("push", [(list(lb), list(ub), bound, depth)
                                  for lb, ub, bound, depth in nodes]))


BOXES = [(np.array([0.0, 1.0]), np.array([1.0, 1.0]), -3.0 - i, 2 + i)
         for i in range(4)]


def _donated(rows, k):
    """The donor's (k, 2m + 2) buffer holding ``rows`` of BOXES."""
    buf = np.full((k, 6), np.nan)
    for i, (lb, ub, bound, depth) in enumerate(rows):
        buf[i] = np.concatenate([lb, ub, [bound, float(depth)]])
    return buf


# each script: (rank, sync_every, max_steal, [local rows of the other
# processes' all-gathers], ctx) -- the other rows of the scalar gather,
# then the donor's buffer of the box gather when there is one
SCRIPTS = {
    "idle_takes": (0, 1, 8, [
        [None, [5.0, -1.0, 6.0, 0.0]],
        [None, _donated(BOXES[:3], 8)]],
        lambda: Ctx(np.inf, np.inf, 0)),
    "donor_pops": (1, 1, 8, [
        [[np.inf, np.inf, 0.0, 0.0], None],
        [np.full((8, 6), np.nan), None]],
        lambda: Ctx(5.0, -1.0, 6, boxes=BOXES)),
    "round_robin": (2, 1, 4, [
        [[4.0, -2.0, 7.0, 0.0], [np.inf, np.inf, 0.0, 0.0], None],
        [_donated(BOXES[:3], 4), np.full((4, 6), np.nan), None]],
        lambda: Ctx(np.inf, np.inf, 0)),
    "all_done": (0, 1, 8, [[None, [2.0, 2.0, 0.0, 0.0]]],
                 lambda: Ctx(3.0, np.inf, 0)),
    "stopped_host": (1, 1, 8, [[[3.0, 1.0, 5.0, 1.0], None]],
                     lambda: Ctx(np.inf, np.inf, 0)),
    "off_turn": (0, 2, 8, [[None, [5.0, -1.0, 6.0, 0.0]]],
                 lambda: Ctx(np.inf, np.inf, 0)),
}


def _run(package, monkeypatch, script):
    rank, every, steal, rounds, make_ctx = script
    queue = list(rounds)

    def scripted(vec):
        rows = queue.pop(0)
        return np.stack([np.asarray(vec if r is None else r, float)
                         for r in rows])

    if package is jmh:
        monkeypatch.setattr(jmh.jax, "process_index", lambda: rank)
    else:
        monkeypatch.setattr(tmh, "process_index", lambda: rank)
    sync = package.DistributedSync(2, sync_every=every, max_steal=steal)
    sync._allgather = scripted
    ctx = make_ctx()
    done = sync(ctx)
    assert not queue
    return done, ctx.log, sync.global_incumbent, sync.global_bound


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_sync_decisions_equal_jax(case, monkeypatch):
    """One call of DistributedSync in both packages with the same gathered
    rows and rank: the same done flag, incumbent adoption, donation and
    round-robin take, and the same global incumbent and bound."""
    want = _run(jmh, monkeypatch, SCRIPTS[case])
    monkeypatch.undo()
    got = _run(tmh, monkeypatch, SCRIPTS[case])
    assert repr(got) == repr(want)


def test_sync_bounds_and_distributed_on_one_process():
    """Without a process group: sync_bounds is the identity and
    solve_misdp_distributed is solve_misdp."""
    assert tmh.initialize() == (0, 1)
    inc, bound, loads = tmh.sync_bounds(-5.0, -7.0, 3)
    assert inc == -5.0 and bound == -7.0 and loads.tolist() == [3]
    tp = problem_from_jax(jfam.cardinality_least_squares(4, 8, 2, seed=1))
    s = settings_from_jax(Settings(bb=BBSettings(batch_size=4,
                                                 turbo="off")))
    a = tmh.solve_misdp_distributed(tp, s, device="cpu")
    b = tbb.solve_misdp(tp, s, device="cpu")
    assert (a.status, a.objval, a.stats.nodes) == \
        (b.status, b.objval, b.stats.nodes)


@pytest.mark.parametrize("mesh_mode", ["nomesh", "mesh"])
def test_two_process_steal_and_agree(tmp_path, mesh_mode):
    """Two processes over gloo, each solving on the CPU ("mesh": on a
    local two-entry CPU mesh): both reach the optimum -2.3 (y0 = 1 forced,
    then the best coefficient 1.3), the process whose partition was
    infeasible stole nodes and the other donated them."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", str(port), str(outs[i]),
         mesh_mode], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)]
    try:
        for p in procs:
            p.wait(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"distributed workers did not finish in {WAIT_S} s "
                    f"(deadlock?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        assert p.returncode == 0, p.stderr.read().decode()[-2000:]
    res = [json.load(open(o)) for o in outs]
    for r in res:
        assert r["status"] == "OPTIMAL"
        assert abs(r["objval"] - (-2.3)) < 1e-4, r
    assert sum(r["nstolen"] for r in res) > 0, res
    assert sum(r["ndonated"] for r in res) > 0, res
