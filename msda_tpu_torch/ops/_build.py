"""Build and load the port's CUDA kernels.

Each kernel source under ``msda_tpu_torch/csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface, which the kernel's wrapper
loads with ``ctypes``.  The build happens at first CUDA use (or ahead of it,
for several kernels at once, with :func:`build`), from the repository's
sources only, into ``build/kernels/`` beside the package (a directory that
``.gitignore`` lists).  A library is rebuilt when its source or a shared
header (``csrc/*.cuh``) is newer than it.  Importing this module needs
neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = [
    "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build",
    "load_library", "build_log",
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


def _compile(names: list[str]) -> None:
    """Compile each ``csrc/<name>.cu`` into ``lib<name>.so`` atomically, one
    ``nvcc`` per source, all started together; keep each log beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    jobs = []
    try:
        for name in names:
            fd, tmp = tempfile.mkstemp(prefix=f".{name}.", suffix=".so",
                                       dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
            jobs.append((name, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, tmp, cmd, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu (exit "
                              f"{proc.returncode}):\n$ {' '.join(cmd)}\n"
                              f"{err}{out}")
                continue
            os.replace(tmp, BUILD_DIR / f"lib{name}.so")
            (BUILD_DIR / f"{name}.log").write_text(err + out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def build(names) -> None:
    """Build the libraries of ``names`` that are missing or older than their
    sources, concurrently.  Raises ``RuntimeError`` with nvcc's output when
    a build fails."""
    with _LOCK:
        stale = [n for n in names
                 if _stale(BUILD_DIR / f"lib{n}.so", _sources(n))]
        if stale:
            _compile(stale)


def load_library(name: str) -> ctypes.CDLL:
    """Load ``lib<name>.so``, building it from ``csrc/<name>.cu`` first when
    it is missing or older than its sources.  Raises ``RuntimeError`` with
    nvcc's output when the build fails."""
    with _LOCK:
        if name not in _LOADED:
            build([name])
            _LOADED[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        return _LOADED[name]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and spill report) from the
    last build of ``name``, or "" when the library was built elsewhere."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
