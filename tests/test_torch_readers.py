"""The port's readers (``models/io.py::read_problem`` over
``reader_sdpa.py`` with the native tokenizer, ``reader_cbf.py`` and
``reader_cip.py``) against the JAX package's, on files the JAX writers
produce from generated problems (``_torch_filecases``): every ``MISDP``
field equal, exactly.  Then the port's native and Python SDPA parses
against each other, and both packages on mutated (corrupt) files: the port
raises where JAX raises, with the same message, and reads the same
problem where JAX reads one.
"""

import pytest

from _torch_bbcases import assert_same
from _torch_filecases import (FORMATS, NO_CBF, PROBLEMS, QUAD_CIP, jax_file,
                              problem)
from scipsdp_tpu.models import families as jfam
from scipsdp_tpu.models import io as jio
from scipsdp_tpu.models import reader_sdpa as jrs
from scipsdp_tpu_torch import native as tnative
from scipsdp_tpu_torch.models import io as tio
from scipsdp_tpu_torch.models import reader_sdpa as trs

CASES = [(name, fmt) for name in PROBLEMS for fmt in FORMATS
         if not (fmt == ".cbf" and name in NO_CBF)]


@pytest.mark.parametrize("name,fmt", CASES)
def test_read_same_problem(tmp_path, name, fmt):
    path = jax_file(problem(name, tmp_path), tmp_path, fmt)
    assert_same(jio.read_problem(path), tio.read_problem(path))


def test_read_cip_text(tmp_path):
    """The CIP text of the JAX package's quadratic reader test, as given."""
    path = tmp_path / "quadtest.cip"
    path.write_text(QUAD_CIP)
    jp, tp = jio.read_problem(str(path)), tio.read_problem(str(path))
    assert len(tp.quadcons) == 2
    assert_same(jp, tp)


@pytest.mark.parametrize("name", ["cls", "tt", "mkp", "ind", "rank1"])
def test_native_parser_matches_python(tmp_path, name):
    """The twin of test_readers.py's: the native tokenizer reads the plain
    file (it returns tokens) and gives the problem the Python parser
    gives."""
    path = jax_file(problem(name, tmp_path), tmp_path, ".dat-s")
    assert tnative.parse_sdpa_native(path) is not None, "g++ build failed"
    native = trs.read_sdpa(path)
    assert_same(native, trs._read_sdpa_python(path, native.name))


def test_native_library_beside_the_package(tmp_path):
    """The tokenizer is built under build/, never beside its source, and
    a gz file goes to the Python parser."""
    path = jax_file(problem("cls", tmp_path), tmp_path, ".dat-s.gz")
    assert tnative.parse_sdpa_native(path) is None
    lib = tnative.library_path(tnative._SRC_PATH, "libsdpaparse.so")
    assert tnative.get_sdpa_lib() is not None
    assert lib.is_file() and "build" in lib.parts
    assert not (tnative._SRC_PATH.parent / "libsdpaparse.so").exists()


def _cut(lines):
    """The file cut in the middle of a line past its middle."""
    k = len(lines) * 3 // 5
    return lines[:k] + [lines[k][:len(lines[k]) // 2]]


def _sdpa_entry(lines, block):
    """Index of the first entry line of ``block`` (1-based)."""
    return next(i for i, ln in enumerate(lines[4:], 4)
                if ln.split()[1] == str(block))


def _set_field(lines, i, k, value):
    toks = lines[i].split()
    toks[k] = value
    return lines[:i] + [" ".join(toks)] + lines[i + 1:]


def _cbf_line(lines, section, offset):
    return lines.index(section) + offset


# mutation -> (on the .dat-s lines, on the .cbf lines) of cls_5 as the JAX
# writers write it: an SDP block of size 9 and an LP block of 32 rows
MUTATIONS = {
    "truncated": (_cut, _cut),
    "non_numeric_token": (
        lambda ls: _set_field(ls, _sdpa_entry(ls, 1), 4, "abc"),
        lambda ls: _set_field(ls, _cbf_line(ls, "ACOORD", 2), 2, "abc")),
    "block_index_out_of_range": (
        lambda ls: _set_field(ls, _sdpa_entry(ls, 1), 1, "3"),
        lambda ls: _set_field(ls, _cbf_line(ls, "HCOORD", 2), 0, "1")),
    "negative_block_size": (
        lambda ls: _set_field(ls, 2, 0, "-9"),
        lambda ls: _set_field(ls, _cbf_line(ls, "PSDCON", 2), 0, "-9")),
    "missing_objective": (
        lambda ls: ls[:3] + ls[4:],
        lambda ls: [ln for i, ln in enumerate(ls) if not
                    _cbf_line(ls, "OBJACOORD", 0) <= i
                    <= _cbf_line(ls, "OBJACOORD", 2)]),
    # the LP block's entries must be diagonal; CBF's PSD entries name the
    # lower triangle, so its mirror is an entry above the diagonal
    "entry_below_diagonal": (
        lambda ls: _set_field(ls, _sdpa_entry(ls, 2), 2,
                              str(int(ls[_sdpa_entry(ls, 2)].split()[3])
                                  + 1)),
        lambda ls: _set_field(_set_field(ls, _cbf_line(ls, "HCOORD", 2), 2,
                                         "0"),
                              _cbf_line(ls, "HCOORD", 2), 3, "8")),
}


def _mutated(tmp_path, fmt, mutation):
    """Path of cls_5 written by the JAX writer of ``fmt`` and mutated."""
    good = jax_file(jfam.cardinality_least_squares(5, 8, 2, seed=3),
                    tmp_path, fmt, stem="good")
    with open(good) as f:
        lines = f.read().splitlines()
    path = str(tmp_path / (mutation + fmt))
    with open(path, "w") as f:
        f.write("\n".join(MUTATIONS[mutation][fmt == ".cbf"](lines)) + "\n")
    return path


def _outcome(read, path):
    """("ok", problem) or ("raise", exception type name, message)."""
    try:
        return ("ok", read(path))
    except Exception as exc:   # compared below, whatever it is
        return ("raise", type(exc).__name__, str(exc))


def _same_outcome(a, b):
    assert a[0] == b[0], (a[1:] if a[0] == "raise" else b[1:])
    if a[0] == "ok":
        assert_same(a[1], b[1])
    else:
        assert a[1:] == b[1:]


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
@pytest.mark.parametrize("fmt", [".dat-s", ".cbf"])
def test_corrupt_input(tmp_path, fmt, mutation):
    """Each mutation of a valid file: the port raises or accepts as JAX
    does (the .dat-s ones through both packages' native path and both
    Python parsers)."""
    path = _mutated(tmp_path, fmt, mutation)
    want = _outcome(jio.read_problem, path)
    _same_outcome(want, _outcome(tio.read_problem, path))
    if want[0] == "raise" and want[1] != "ReadError":
        pytest.fail(f"JAX raised {want[1]} on {mutation}, not ReadError")
    if fmt == ".dat-s":
        _same_outcome(_outcome(lambda p: jrs._read_sdpa_python(p, "bad"),
                               path),
                      _outcome(lambda p: trs._read_sdpa_python(p, "bad"),
                               path))


def test_mutations_reach_the_checks(tmp_path):
    """The list holds both outcomes: every mutation raises ReadError in
    the port but two CBF ones, which read (an objective-free problem; an
    entry in the upper triangle)."""
    read = {(m, fmt): _outcome(tio.read_problem,
                               _mutated(tmp_path, fmt, m))[:2]
            for m in MUTATIONS for fmt in (".dat-s", ".cbf")}
    assert read.pop(("missing_objective", ".cbf"))[0] == "ok"
    assert read.pop(("entry_below_diagonal", ".cbf"))[0] == "ok"
    assert set(read.values()) == {("raise", "ReadError")}, read
