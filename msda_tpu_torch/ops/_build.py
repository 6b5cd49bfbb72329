"""Build and load the port's CUDA kernels.

Each kernel source under ``msda_tpu_torch/csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface, which the kernel's wrapper
loads with ``ctypes``.  The build happens at first CUDA use (or ahead of it,
for several kernels at once, with :func:`build`), from the repository's
sources only, into ``build/kernels/`` beside the package (a directory that
``.gitignore`` lists).  A library is rebuilt when its source or a shared
header (``csrc/*.cuh``) is newer than it.  Importing this module needs
neither ``nvcc`` nor a GPU.

``defines`` builds a variant: the sources' compile-time launch constants
(``#ifndef`` guards in ``csrc/``) set by ``-D`` flags, into
``lib<name>-<tag>.so``, where the tag lists them (``variant``).  The
default build has no ``-D`` flag.  ``python -m msda_tpu_torch.autotune``
sweeps them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Mapping

__all__ = [
    "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build",
    "load_library", "build_log", "variant",
]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.RLock()
_LOADED: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _sources(name: str) -> list[Path]:
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise RuntimeError(f"kernel source {source} is missing")
    return [source, *sorted(CSRC_DIR.glob("*.cuh"))]


def _stale(lib: Path, sources: list[Path]) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources)


def variant(name: str, defines: Mapping[str, int] | None = None) -> str:
    """The library stem of ``name`` built with ``defines``: ``name`` itself
    without any, else ``name-K1=V1-K2=V2`` in the order of the keys."""
    if not defines:
        return name
    return "-".join([name, *(f"{k}={v}" for k, v in sorted(defines.items()))])


def _compile(jobs: list[tuple[str, Mapping[str, int] | None]]) -> None:
    """Compile each ``(name, defines)``: ``csrc/<name>.cu`` into
    ``lib<variant>.so`` atomically, one ``nvcc`` per library, all started
    together; keep each log beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    try:
        for name, defines in jobs:
            stem = variant(name, defines)
            fd, tmp = tempfile.mkstemp(prefix=f".{stem}.", suffix=".so",
                                       dir=BUILD_DIR)
            os.close(fd)
            flags = [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", tmp,
                   str(CSRC_DIR / f"{name}.cu")]
            procs.append((stem, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for stem, tmp, cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {stem} (exit "
                              f"{proc.returncode}):\n$ {' '.join(cmd)}\n"
                              f"{err}{out}")
                continue
            os.replace(tmp, BUILD_DIR / f"lib{stem}.so")
            (BUILD_DIR / f"{stem}.log").write_text(err + out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def build(names, defines=None) -> None:
    """Build the libraries of ``names`` that are missing or older than their
    sources, concurrently.  ``defines``: one mapping of constants for every
    name, or a sequence of them, one a name (variants of one source side by
    side).  Raises ``RuntimeError`` with nvcc's output when a build
    fails."""
    names = list(names)
    if defines is None or isinstance(defines, Mapping):
        defines = [defines] * len(names)
    with _LOCK:
        stale = [(n, d) for n, d in zip(names, defines, strict=True)
                 if _stale(BUILD_DIR / f"lib{variant(n, d)}.so",
                           _sources(n))]
        if stale:
            _compile(stale)


def load_library(name: str, defines: Mapping[str, int] | None = None
                 ) -> ctypes.CDLL:
    """Load ``lib<name>.so`` (with ``defines``: the variant's library),
    building it from ``csrc/<name>.cu`` first when it is missing or older
    than its sources.  Raises ``RuntimeError`` with nvcc's output when the
    build fails."""
    stem = variant(name, defines)
    with _LOCK:
        if stem not in _LOADED:
            build([name], defines)
            _LOADED[stem] = ctypes.CDLL(str(BUILD_DIR / f"lib{stem}.so"))
        return _LOADED[stem]


def build_log(name: str, defines: Mapping[str, int] | None = None) -> str:
    """nvcc's output (``-Xptxas -v`` register and spill report) from the
    last build of ``name`` (with ``defines``), or "" when the library was
    built elsewhere."""
    path = BUILD_DIR / f"{variant(name, defines)}.log"
    return path.read_text() if path.exists() else ""
