"""Build of the port's host (C++) libraries, one helper for all of them:
the neighbour sampler (``csrc/sampler.cpp``, ``data/native_sampler.py``)
and the accuracy scorer (``csrc/metrics.cpp``, ``utils/metrics.py``).

Each source is compiled with ``g++ -O3 -march=native -std=c++17 -fPIC
-shared`` into ``_build/`` beside the package at first use, as
``<source stem>-<hash>.so``, the hash over the source, the flags and the
host CPU's features (a ``-march=native`` build runs only on a CPU like the
one it was built on); its module loads it with ``ctypes``.  ``CXX`` names
the compiler and ``BUILD_DIR`` the output directory; both are read at build
time.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")


def _host_cpu() -> bytes:
    """The host CPU's feature flags (``-march=native`` compiles for them),
    or its machine name where ``/proc/cpuinfo`` is not readable."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def library_path(source: str) -> str:
    """``BUILD_DIR/<source stem>-<hash>.so``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(source: str, what: str, force: bool = False) -> str:
    """Compile ``source`` unless its library exists (or ``force``); return
    the library's path.  Raises ``RuntimeError`` naming ``what`` with the
    compiler's output when the compiler is missing or fails."""
    path = library_path(source)
    if os.path.exists(path) and not force:
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as ex:
        raise RuntimeError(f"cannot build {what}: {' '.join(cmd)} did not "
                           f"start ({ex})") from ex
    if proc.returncode != 0 or not os.path.exists(tmp):
        raise RuntimeError(f"cannot build {what}: {' '.join(cmd)} exited "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)            # atomic against a concurrent build
    return path
