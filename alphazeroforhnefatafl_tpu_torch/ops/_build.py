"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, on first use, and loaded with ``ctypes``.
The library lands in ``_kernels/`` beside ``csrc/`` (listed in
``.gitignore``), under a name keyed by a hash of the sources and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtafl_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the sources if their library is not built yet.

    Returns (library path, build seconds, nvcc's stderr); seconds is 0 and
    the log empty when the library was already there.
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [str(Path(work) / f"{src.stem}.o") for src in cu]
        compiles = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                        for src, obj in zip(cu, objects))
        ]
        log = ""
        failed = None
        for cmd, proc in compiles:  # wait for every compile, then report the first failure
            _, err = proc.communicate()
            log += err
            if proc.returncode != 0 and failed is None:
                failed = (proc.returncode, cmd, err)
        if failed is None:
            tmp = str(Path(work) / "lib.so")
            cmd = [nvcc, "-shared", "-o", tmp, *objects]
            link = subprocess.run(cmd, capture_output=True, text=True)
            log += link.stderr
            if link.returncode != 0:
                failed = (link.returncode, cmd, link.stderr)
        if failed is not None:
            code, cmd, err = failed
            raise KernelBuildError(f"nvcc failed ({code}): {' '.join(cmd)}\n{err}")
        # Atomic: a concurrent loader never sees half a file, and ranks that
        # build at once only waste an nvcc run.
        os.replace(tmp, out)
    return out, time.perf_counter() - t0, log


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.tafl_legal_mask.argtypes = [p, p, p, p, i, p, p]
    lib.tafl_legal_mask.restype = i
    lib.tafl_step.argtypes = [p, p, p, p, p, p, p, p, p, p, i, p, p, p, p, p]
    lib.tafl_step.restype = i
    lib.tafl_group_norm_act.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p, p]
    lib.tafl_group_norm_act.restype = i
    f = ctypes.c_float
    lib.tafl_se_block.argtypes = [p, p, p, p, p, p, f, p, p, p, p, i, i, i, i, p, p]
    lib.tafl_se_block.restype = i
    lib.tafl_bn_relu.argtypes = [p, p, p, p, p, f, i, i, i, p, p]
    lib.tafl_bn_relu.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    path, _, _ = build()
    return _declare(ctypes.CDLL(str(path)))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
