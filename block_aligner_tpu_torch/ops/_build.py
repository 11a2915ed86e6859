"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load it with ``ctypes``.

Each library is compiled from the sources in this checkout into the
repository's ``build/`` directory, under a name keyed on a hash of every
file in ``csrc/`` and of the compiler flags, so an edited source never loads
a stale build.  The result has a plain C interface: no PyTorch headers, so
a build takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, report: bool = False):
    """Compile ``csrc/<name>.cu`` unless this exact source is built already.
    With ``report`` it returns ``(path, log)``, the log ptxas's registers,
    stack and spills of every kernel (``-Xptxas -v``, which changes no
    code; empty if the library was built already)."""
    out = library_path(name)
    if out.exists():
        return (out, "") if report else out
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, *(("-Xptxas", "-v") if report else ()), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return (out, proc.stderr) if report else out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
