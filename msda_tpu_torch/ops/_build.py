"""Build and load the port's CUDA kernels.

Each kernel source under ``msda_tpu_torch/csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface, which the kernel's wrapper
loads with ``ctypes``.  The build happens at first CUDA use, from the
repository's sources only, into ``build/kernels/`` beside the package (a
directory that ``.gitignore`` lists).  A library is rebuilt when its source
is newer than it.  Importing this module needs neither ``nvcc`` nor a GPU.
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
    "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "load_library",
    "build_log",
]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
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


def _stale(lib: Path, sources: list[Path]) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources)


def _compile(name: str, source: Path, lib: Path) -> str:
    """Compile ``source`` into ``lib`` atomically; return nvcc's log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source.name} (exit {proc.returncode}):"
                f"\n$ {' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    log = proc.stderr + proc.stdout
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def load_library(name: str) -> ctypes.CDLL:
    """Load ``lib<name>.so``, building it from ``csrc/<name>.cu`` first when
    it is missing or older than its sources.  Raises ``RuntimeError`` with
    nvcc's output when the build fails."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        source = CSRC_DIR / f"{name}.cu"
        if not source.is_file():
            raise RuntimeError(f"kernel source {source} is missing")
        sources = [source, *sorted(CSRC_DIR.glob("*.cuh"))]
        lib = BUILD_DIR / f"lib{name}.so"
        if _stale(lib, sources):
            _compile(name, source, lib)
        _LOADED[name] = ctypes.CDLL(str(lib))
        return _LOADED[name]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and spill report) from the
    last build of ``name``, or "" when the library was built elsewhere."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
