"""Build a CUDA source of the port into a shared library and load it.

``nvcc`` compiles each ``csrc/*.cu`` file by hand into ``build/`` at the
root of the checkout, as a library with a plain C interface that
:mod:`ctypes` loads (no PyTorch headers, so a build takes seconds).  The
library's name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Builds run on first use,
never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from repro_torch.kernels import KernelError

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

#: ``-fmad=false`` keeps every multiply and add separately rounded, as the
#: plain PyTorch version rounds them; no ``--use_fast_math``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library exists; -> the library path.
    The compiler's output (``-Xptxas -v``: registers, spills) is kept
    beside it as ``.log``."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelError(f"nvcc failed on {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a stub
    return out


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
