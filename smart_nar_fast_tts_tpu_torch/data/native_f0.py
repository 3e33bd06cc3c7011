"""ctypes binding of the repository's native F0 trackers (``native/f0/``), as
``smart_nar_fast_tts_tpu/data/native_f0.py``.

One shared library, ``libsmartf0.so``, holds two algorithms:

- ``world`` (default): DIO + StoneMask (``world_f0.cc``), the algorithm
  family PyWORLD runs in the reference (``preprocessor/preprocessor.py:
  181-186``); its plain version is ``data/world_f0.py``;
- ``nccf``: the normalized-autocorrelation tracker (``f0.cc``); its plain
  version is ``data/pitch.py``.

``SMART_TTS_F0=nccf`` selects the second, ``SMART_TTS_NATIVE_F0=off`` the
numpy versions, as in the JAX package.

The library is built with g++ and the JAX package's flags from the
repository's sources, which are read and never written, at its first use
(never at import), into ``build/native_f0/<hash>/libsmartf0.so`` at the
repository root (git-ignored).  The hash covers the sources, the flags and
the target that ``-march=native`` selects on this host, so a build tree
copied to another machine is not loaded there.

Unlike the JAX module, nothing falls back to numpy: a failed build raises
with g++'s output, and a failed call raises.  Only ``SMART_TTS_NATIVE_F0=off``
runs the numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .pitch import estimate_f0 as estimate_f0_nccf_numpy
from .world_f0 import estimate_f0_world as estimate_f0_world_numpy

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCES = (REPO_ROOT / "native" / "f0" / "f0.cc",
           REPO_ROOT / "native" / "f0" / "world_f0.cc")
BUILD_ROOT = REPO_ROOT / "build" / "native_f0"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "smart_f0_estimate": [_DOUBLE_P, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_double, ctypes.c_double,
                          ctypes.c_double, _DOUBLE_P, ctypes.c_int64],
    "smart_world_f0": [_DOUBLE_P, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_double, ctypes.c_double,
                       ctypes.c_double, ctypes.c_double, _DOUBLE_P,
                       ctypes.c_int64],
    "smart_stonemask": [_DOUBLE_P, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_int, ctypes.c_double, ctypes.c_double,
                        _DOUBLE_P, ctypes.c_int64],
}

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


def lib_path() -> Path:
    """``BUILD_ROOT/<hash>/libsmartf0.so``: the hash covers the flags, g++'s
    resolved target options for ``-march=native`` and each of SOURCES.
    Raises ``FileNotFoundError`` for a missing source."""
    target = subprocess.run(
        [CXX, "-march=native", "-Q", "--help=target"], capture_output=True,
        text=True, check=True, timeout=120).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(target.encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsmartf0.so"


def build(out: Path) -> None:
    """Compile SOURCES into ``out``: written under a temporary name, then
    renamed, so a concurrent process never loads a half-written library.
    Raises with g++'s output when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, *(str(s) for s in SOURCES), "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not build the native F0 library:\n"
                           f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The library built from SOURCES, building it first if its hash
    directory does not hold it yet; loaded once per SOURCES and
    BUILD_ROOT."""
    key = (SOURCES, BUILD_ROOT)
    with _lock:
        if key not in _libs:
            path = lib_path()
            if not path.is_file():
                build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[key] = lib
        return _libs[key]


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def native_off() -> bool:
    return os.environ.get("SMART_TTS_NATIVE_F0") == "off"


def _check(rc: int, name: str, n: int, hop: int) -> None:
    if rc != 0:
        raise ValueError(f"{name} returned {rc} on {n} samples at hop {hop}")


def estimate_f0_nccf_native(wav: np.ndarray, sampling_rate: int,
                            hop_length: int, f0_floor: float = 71.0,
                            f0_ceil: float = 800.0,
                            nccf_threshold: float = 0.30) -> np.ndarray:
    """The NCCF tracker: ``len(wav)//hop + 1`` F0 values in Hz, 0 where
    unvoiced."""
    if native_off():
        return estimate_f0_nccf_numpy(wav, sampling_rate, hop_length,
                                      f0_floor, f0_ceil, nccf_threshold)
    lib = load()
    wav64 = np.ascontiguousarray(wav, np.float64)
    n_frames = len(wav64) // hop_length + 1
    out = np.empty(n_frames, np.float64)
    rc = lib.smart_f0_estimate(
        wav64.ctypes.data_as(_DOUBLE_P), len(wav64), sampling_rate,
        hop_length, f0_floor, f0_ceil, nccf_threshold,
        out.ctypes.data_as(_DOUBLE_P), n_frames)
    _check(rc, "smart_f0_estimate", len(wav64), hop_length)
    return out


def estimate_f0_world_native(wav: np.ndarray, sampling_rate: int,
                             hop_length: int, f0_floor: float = 71.0,
                             f0_ceil: float = 800.0,
                             channels_in_octave: float = 2.0,
                             allowed_range: float = 0.1) -> np.ndarray:
    """DIO, then StoneMask's refinement of its contour: ``len(wav)//hop +
    1`` F0 values in Hz, 0 where unvoiced."""
    if native_off():
        return estimate_f0_world_numpy(wav, sampling_rate, hop_length,
                                       f0_floor, f0_ceil)
    lib = load()
    wav64 = np.ascontiguousarray(wav, np.float64)
    n_frames = len(wav64) // hop_length + 1
    out = np.empty(n_frames, np.float64)
    wp = wav64.ctypes.data_as(_DOUBLE_P)
    op = out.ctypes.data_as(_DOUBLE_P)
    rc = lib.smart_world_f0(wp, len(wav64), sampling_rate, hop_length,
                            f0_floor, f0_ceil, channels_in_octave,
                            allowed_range, op, n_frames)
    _check(rc, "smart_world_f0", len(wav64), hop_length)
    rc = lib.smart_stonemask(wp, len(wav64), sampling_rate, hop_length,
                             f0_floor, f0_ceil, op, n_frames)
    _check(rc, "smart_stonemask", len(wav64), hop_length)
    return out


def estimate_f0_native(wav: np.ndarray, sampling_rate: int, hop_length: int,
                       f0_floor: float = 71.0, f0_ceil: float = 800.0,
                       nccf_threshold: float = 0.30) -> np.ndarray:
    """The preprocessor's F0: DIO + StoneMask, or the NCCF tracker under
    ``SMART_TTS_F0=nccf``."""
    if os.environ.get("SMART_TTS_F0", "world") == "nccf":
        return estimate_f0_nccf_native(wav, sampling_rate, hop_length,
                                       f0_floor, f0_ceil, nccf_threshold)
    return estimate_f0_world_native(wav, sampling_rate, hop_length,
                                    f0_floor, f0_ceil)
