"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` holds ``extern "C"`` launchers with plain pointers, sizes
and a ``cudaStream_t``; no source includes PyTorch's headers, so each file
compiles in seconds.  One ``nvcc`` per source is started at once, each
writing its own shared library for ``sm_90a`` into
``build/torch_kernels/<hash of the sources and flags>/`` at the repository
root (git-ignored).  A library whose hash directory already holds it is not
rebuilt.  The build runs at the first launch of any kernel, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, else from ``PATH``, else the toolkit's
    default ``/usr/local/cuda/bin``; raises if absent."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").is_file():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    """``build/torch_kernels/<hash>``: the hash covers every source and
    header in ``csrc/`` and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(src: Path) -> Path:
    return build_dir() / f"libsmart_tts_{src.stem}.so"


def build_all() -> dict[str, dict]:
    """Compile every source missing from the build directory, all nvcc
    processes at once.  Returns, for each source built, its seconds and the
    ptxas lines on registers, shared memory and spills of its kernels."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if not _lib_path(s).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        # write under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, errors = {}, []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        report[src.stem] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [line.split("info    : ")[-1].strip()
                      for line in log.splitlines()
                      if "registers" in line or "spill" in line]}
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {src.name}:\n{log}")
        else:
            os.replace(tmp, _lib_path(src))
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load(stem: str, signatures: dict[str, tuple[list, object]]
         ) -> ctypes.CDLL:
    """The shared library built from ``csrc/<stem>.cu``, building first if
    needed.  ``signatures`` maps each exported function to its (argtypes,
    restype), set once when the library is first loaded."""
    with _lock:
        if stem not in _libs:
            src = CSRC_DIR / f"{stem}.cu"
            if not src.is_file():
                raise FileNotFoundError(src)
            if not _lib_path(src).is_file():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(src)))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[stem] = lib
        return _libs[stem]
