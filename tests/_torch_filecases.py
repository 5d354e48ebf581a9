"""Shared problems of the file parity tests (``test_torch_readers.py``,
``test_torch_writers.py``, ``test_torch_cli.py``).

Every problem is generated: the family instances from seeds, the small
hand-built ones of the JAX package's reader and writer tests, and
``_torch_bbcases``' indicator and rank-1 problems.  The JAX package's
writers put each on disk; none reads a reference file.
"""

import gzip
import shutil

import numpy as np

from _torch_bbcases import indicator_prob, rank1_prob
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models import writers as jw
from scipsdp_tpu.models.problem import (INF, IndicatorLink,
                                        LinearConstraints, MISDP,
                                        QuadConstraint)
from scipsdp_tpu.models.reader_cip import read_cip as jread_cip

# tests/test_readers.py::test_cip_quadratic_parse_and_upgrade's text
QUAD_CIP = """STATISTICS
  Problem name: quadtest
OBJECTIVE
  Sense: minimize
VARIABLES
  [continuous] <x>: obj=1, original bounds=[0,4]
  [continuous] <y>: obj=1, original bounds=[0,4]
  [integer] <z>: obj=0, original bounds=[0,3]
CONSTRAINTS
  [quadratic] <q1>: +<x>[C]<y>[C] -0.5<z>[I] >= 1;
  [quadratic] <q2>: +2<x>[C]^2 +<y>[C] <= 36;
END
"""


def quad_indicator_prob():
    """tests/test_writers.py::test_cip_roundtrip_quadratic_indicator's
    problem: a quadratic row and an indicator link, no SDP block."""
    lp = LinearConstraints.from_rows([([0, 2], [1.0, 1.0], 2.0, INF)])
    return MISDP(
        nvars=3, obj=np.array([1.0, 0.0, 0.0]),
        lb=np.zeros(3), ub=np.array([4.0, 1.0, INF]),
        integral=np.array([False, True, False]), blocks=[],
        lp=lp,
        indicators=[IndicatorLink(binvar=1, slackvar=2, row=0)],
        quadcons=[QuadConstraint(lin_ind=[1], lin_val=[-0.5], qrow=[0, 0],
                                 qcol=[0, 1], qval=[2.0, 1.0],
                                 lhs=-INF, rhs=3.0)],
        name="qi")


def sense_prob():
    """tests/test_write_transformed.py::test_roundtrip_objsense_offset's
    problem: maximize (y0 + 2 y1) + 5 s.t. y0 + y1 <= 1 -> 7."""
    return MISDP(
        nvars=2, obj=np.array([-1.0, -2.0]),
        lb=np.zeros(2), ub=np.ones(2), integral=np.ones(2, bool),
        blocks=[], lp=LinearConstraints.from_rows(
            [([0, 1], [1.0, 1.0], -INF, 1.0)]),
        name="sense", objsense=-1.0, objoffset=5.0)


def quad_prob(tmp_path):
    """QUAD_CIP as the JAX reader reads it."""
    path = tmp_path / "quadtest.cip"
    path.write_text(QUAD_CIP)
    return jread_cip(str(path))


# name -> builder of a JAX package MISDP (``quad`` takes a directory)
PROBLEMS = {
    "cls": lambda: jfam.cardinality_least_squares(5, 8, 2, seed=3),
    "tt": lambda: jfam.truss_topology(4, 1, seed=3),
    "mkp": lambda: jfam.min_k_partition(6, 3, 0.6, seed=12),
    "ind": indicator_prob,
    "rank1": rank1_prob,
    "sense": sense_prob,
    "qi": quad_indicator_prob,
    "quad": quad_prob,
}

WRITERS = {".dat-s": "write_sdpa", ".cbf": "write_cbf", ".cip": "write_cip"}
FORMATS = (".dat-s", ".dat-s.gz", ".cbf", ".cip")
# the CBF writer refuses indicator constraints (ValueError) in both
NO_CBF = ("ind", "qi")


def problem(name, tmp_path):
    build = PROBLEMS[name]
    return build(tmp_path) if name == "quad" else build()


def gzip_copy(path):
    """``path`` compressed beside it as ``path + ".gz"``."""
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return path + ".gz"


def jax_file(jprob, tmp_path, fmt, stem=None):
    """``jprob`` written by the JAX package's writer of ``fmt`` (a
    ``.dat-s.gz`` file is the ``.dat-s`` one compressed)."""
    base = fmt[:-3] if fmt.endswith(".gz") else fmt
    path = str(tmp_path / ((stem or jprob.name) + base))
    getattr(jw, WRITERS[base])(jprob, path)
    return gzip_copy(path) if fmt.endswith(".gz") else path
