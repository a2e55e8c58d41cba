"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library that ``ctypes``
loads; nothing includes PyTorch's headers, so a build takes seconds.
Libraries go to ``imaginaire_tpu_torch/build/`` (listed in .gitignore),
named by a digest of the source and the flags, so an edited source is
never served by a stale library. A build happens at first use, from the
sources in the checkout; importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded = {}  # name -> ctypes.CDLL, one load per process


def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built on first use and "
                       "need the CUDA toolkit")


def source_path(name):
    path = CSRC_DIR / f"{name}.cu"
    if not path.is_file():
        raise FileNotFoundError(f"no kernel source {path}")
    return path


def library_path(name):
    digest = hashlib.sha256(source_path(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(nvcc, source, output):
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build_all(names):
    """Compile every named kernel that has no library yet, one ``nvcc``
    per source, all started together. Returns {name: library path}; the
    compiler's output (registers, spills) is kept beside each library
    as ``<library>.log``. Raises if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.is_file()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, source_path(name), tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        Path(f"{path}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a reader never sees a partial library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name):
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build_all([name])[name]))
    return lib
