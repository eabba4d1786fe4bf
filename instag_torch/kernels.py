"""Build and load the port's CUDA kernels (sources in ``instag_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``instag_torch/build/lib<name>-<hash>.so`` at first use
(the hash is of the source and of every header in ``csrc/``, so an edited
source or header is rebuilt), then loaded with ``ctypes``. Each source
exports ``<name>_launch``, which returns a ``cudaError_t``, and
``<name>_error_string``. Nothing here runs at import time: the CPU tests
import every module, and a host without a card need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: list[str]) -> dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Returns each build's wall seconds; raises with
    the compiler's output if any fails."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        with open(path + ".log", "w") as f:
            f.write(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib


def launch(name: str, argtypes: list, *args) -> None:
    """Call ``<name>_launch`` of ``csrc/<name>.cu`` with ``args`` (ctypes
    ``argtypes``: ``c_void_p`` for pointers and streams, ``c_int`` for
    ints); raise with CUDA's message if it returns an error."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        msg = getattr(lib, f"{name}_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: " + getattr(
            lib, f"{name}_error_string")(err).decode())
