"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled into
``build/scipsdp_tpu_torch/<hash>/lib<name>.so`` beside the package (the
hash covers the source and the flags, so an edited source rebuilds), then
loaded with ``ctypes``; :func:`launch` calls one of its entry points
(``<name>_f64`` or ``<name>_f32``, as the caller names it) on the current
CUDA stream.  The hash also covers the shared device code in
``csrc/*.cuh``.  :func:`build` compiles several sources at once, one nvcc
process each.  Sources come only from this package; nothing is
fetched.  A failed build raises with nvcc's output.  The compiler's report
(``-Xptxas -v``: registers, shared memory, spills) is kept in ``build.log``
beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "scipsdp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    location, or the first ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built (keyed by source, headers and
    flags)."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / key.hexdigest()[:16] / f"lib{name}.so"


def build(*names: str) -> None:
    """Build every named ``csrc/<name>.cu`` whose library is missing: one
    nvcc process per source, all started together, each waited for; raises
    with the output of every build that failed."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless its library exists, then load it."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def _entry(name: str, entry: str, argtypes: tuple):
    fn = getattr(load(name), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, dev: torch.device, *args,
           entry: str | None = None) -> None:
    """Call ``entry(*args, stream)`` of ``csrc/<name>.cu`` (``<name>_f64``
    unless named; declared with ``argtypes``, the stream last, returning a
    CUDA error code) on the current stream of CUDA device ``dev``, which is
    made the current device for the call; raise on a non-zero error."""
    entry = entry or f"{name}_f64"
    with torch.cuda.device(dev):
        err = _entry(name, entry, argtypes)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{err}")
