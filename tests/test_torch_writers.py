"""The port's writers (``models/writers.py``) against the JAX package's: the
same problem written by both is the same file, byte for byte, in every
format and for the transformed (presolved) problem; and the round trips
of the JAX package's CIP and CBF writer tests through the port alone.
"""

import numpy as np
import pytest

from _torch_bbcases import torch_one_thread  # noqa: F401 (fixture)
from _torch_filecases import (NO_CBF, PROBLEMS, WRITERS, problem,
                              quad_indicator_prob, sense_prob)
from scipsdp_tpu.core.presolve_sdp import presolve_problem as jpresolve
from scipsdp_tpu.models import writers as jw
from scipsdp_tpu.utils.config import PresolveSettings, Settings
from scipsdp_tpu_torch.core.branchbound import solve_misdp
from scipsdp_tpu_torch.core.presolve_sdp import presolve_problem as tpresolve
from scipsdp_tpu_torch.interop import problem_from_jax, settings_from_jax
from scipsdp_tpu_torch.models import writers as tw
from scipsdp_tpu_torch.models.io import read_problem
from scipsdp_tpu_torch.models.reader_cip import read_cip


def _write_both(write, jprob, tprob, tmp_path, ext, **kw):
    """The bytes each package's ``write`` gives, or the error it raised."""
    out = []
    for pkg, prob in (("jax", jprob), ("port", tprob)):
        path = tmp_path / f"{pkg}{ext}"
        try:
            getattr(jw if pkg == "jax" else tw, write)(prob, str(path), **kw)
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
        else:
            out.append(path.read_bytes())
    return out


@pytest.mark.parametrize("ext", sorted(WRITERS))
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_same_file(tmp_path, name, ext):
    jprob = problem(name, tmp_path)
    want, got = _write_both(WRITERS[ext], jprob, problem_from_jax(jprob),
                            tmp_path, ext)
    assert got == want
    assert isinstance(want, tuple) == (ext == ".cbf" and name in NO_CBF)


def _gen_settings():
    """test_write_transformed.py's presolve settings: every generated
    row class on."""
    return Settings(presolve=PresolveSettings(
        diaggezerocuts=True, twominorlinconss=True,
        diagzeroimplcuts=True, twominorvarbounds=True))


@pytest.mark.parametrize("ext", [".cbf", ".dat-s"])
@pytest.mark.parametrize("name", ["cls", "tt", "mkp", "rank1"])
def test_same_transformed_file(tmp_path, name, ext):
    """write_problem(presolve_problem(...), transformed=True): the
    generated rows folded into the LP section, the same bytes."""
    jprob = problem(name, tmp_path)
    js = _gen_settings()
    jt = jpresolve(jprob, js)
    tt = tpresolve(problem_from_jax(jprob), settings_from_jax(js))
    want, got = _write_both("write_problem", jt, tt, tmp_path, ext,
                            transformed=True)
    assert got == want
    assert jt.proprows.nrows > 0


def test_cip_roundtrip_quadratic_indicator(tmp_path):
    """test_writers.py's round trip through the port's writer and
    reader."""
    prob = problem_from_jax(quad_indicator_prob())
    p = str(tmp_path / "qi.cip")
    tw.write_cip(prob, p)
    back = read_cip(p)
    assert len(back.quadcons) == 1
    qc = back.quadcons[0]
    np.testing.assert_allclose(sorted(qc.qval), [1.0, 2.0])
    assert qc.rhs == 3.0 and list(qc.lin_val) == [-0.5]
    assert len(back.indicators) == 1
    assert back.indicators[0].binvar == 1
    assert back.lp.nrows == 1


def test_roundtrip_objsense_offset(tmp_path, torch_one_thread):  # noqa: F811
    """test_write_transformed.py's: MAX sense and an objective offset
    survive the port's CBF write and read, and the port solves the re-read
    problem on the CPU to 7."""
    out = str(tmp_path / "sense.cbf")
    tw.write_problem(problem_from_jax(sense_prob()), out)
    back = read_problem(out)
    assert back.objsense == -1.0
    assert abs(back.objoffset - 5.0) < 1e-12
    r = solve_misdp(back, device="cpu")
    assert abs(r.objval - 7.0) < 1e-4
