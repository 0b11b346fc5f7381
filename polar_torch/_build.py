"""Build and load the port's native kernels.

Each kernel is a plain C-ABI shared library loaded with ``ctypes``:

* ``cuda``: ``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` (Hopper);
* ``host``: ``g++`` compiles ``csrc/<name>_host.cpp``, the same
  per-codeword routine for the CPU, used only by the tests.

Libraries are built at first use into ``build/polar_torch/`` beside the
package, named by a hash of their sources and flags, so a changed source
rebuilds and an unchanged one loads at once. A build writes a temporary
file and renames it, so concurrent processes never load half a library.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "polar_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_loaded = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _command(name: str, route: str, out: str):
    if route == "cuda":
        return [_nvcc(), *NVCC_FLAGS, "-o", out,
                os.path.join(CSRC, f"{name}.cu")]
    if route == "host":
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host build needs it")
        return [gxx, *GXX_FLAGS, "-o", out,
                os.path.join(CSRC, f"{name}_host.cpp")]
    raise ValueError(f"unknown route {route!r}")


def _library_path(name: str, route: str) -> str:
    h = hashlib.sha256(route.encode())
    flags = NVCC_FLAGS if route == "cuda" else GXX_FLAGS
    h.update(" ".join(flags).encode())
    # the kernel's own sources and every header (shared ones included)
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith(".cuh") or (fn.startswith(name + ".")
                                   or fn.startswith(name + "_host.")):
            with open(os.path.join(CSRC, fn), "rb") as fh:
                h.update(fn.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{route}_{h.hexdigest()[:16]}.so")


def build(names_routes):
    """Compile every ``(name, route)`` not built yet, all compilers started
    together. Returns the library paths in the given order."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = [], []
    for name, route in names_routes:
        path = _library_path(name, route)
        paths.append(path)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = _command(name, route, tmp)
        procs.append((path, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for path, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                               f"{out.decode(errors='replace')}")
        os.replace(tmp, path)
    return paths


def load(name: str, route: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of kernel ``name`` built by ``route``, built
    first if needed."""
    key = (name, route)
    if key not in _loaded:
        (path,) = build([key])
        _loaded[key] = ctypes.CDLL(path)
    return _loaded[key]
