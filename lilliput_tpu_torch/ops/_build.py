"""Build the port's native libraries at first use.

Both libraries have a plain C interface and are loaded with ctypes:

* the host entropy library (``binding.py``): g++ over the JAX package's
  ``jpeg_huff.cpp`` and the port's ``csrc/host/jpeg_enc.cpp``;
* the CUDA kernels (``decode_kernels.py``): nvcc over ``csrc/*.cu`` for
  ``sm_90a``.

Outputs go to ``lilliput_tpu_torch/_build/`` (git-ignored), named by a hash
of the command and the sources, so an edited source rebuilds and a stale
library is never loaded. Nothing is built when a module is imported. A failed
build raises with the compiler's stderr; there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, List, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

_lock = threading.Lock()


class BuildError(RuntimeError):
    """A native library of the port failed to build."""


def build_shared(name: str, sources: Sequence[str],
                 command: Callable[[str], List[str]]) -> str:
    """Build `sources` into BUILD_DIR/<name>-<hash>.so unless that file
    exists; returns its path. `command(out_path)` gives the compiler argv.
    The compiler's stderr (e.g. ``-Xptxas -v`` register counts) is kept
    beside the library as ``.log``."""
    h = hashlib.sha256()
    h.update("\0".join(command("OUT")).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"{name} build failed (exit {proc.returncode}):\n"
                             f"{proc.stderr}{proc.stdout}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stderr + proc.stdout)
        os.replace(tmp, out)  # atomic: no reader sees a partial file
    return out


def build_log(lib_path: str) -> str:
    """Compiler output saved by build_shared for `lib_path`."""
    with open(lib_path[:-3] + ".log") as f:
        return f.read()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_cuda(name: str, sources: Sequence[str]) -> str:
    """Route (b) of the port's kernel build: nvcc into a shared library with
    a plain C interface. Exact arithmetic: no --use_fast_math."""
    nvcc = find_nvcc()
    return build_shared(name, sources, lambda out: [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", out, *sources])
