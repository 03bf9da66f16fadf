"""Build the package's CUDA sources into shared libraries and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the repository
root (listed in ``.gitignore``). A library is keyed by a hash of its source,
of every header under ``csrc/`` that it includes (``#include "..."``, followed
recursively) and of the flags, so an edited source or header rebuilds and an
unchanged one is reused.
Builds start at first use, never at import; several sources build in
parallel, one ``nvcc`` each. A failed build raises with nvcc's messages.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_DIR, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Every kernel source of the package, by name (``csrc/<name>.cu``).
KERNELS = ("flash_fwd", "flash_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: name → {"seconds": build wall time, "log": nvcc/ptxas output} for the
#: libraries this process compiled (reused libraries have no entry).
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA toolkit is "
        "needed to build the kernels in %s" % CSRC_DIR)


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes with
    quotes, directly or through another header, in first-seen order."""
    todo, seen = [os.path.join(CSRC_DIR, name + ".cu")], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path), inc.decode()))
    return seen


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def build(names: Sequence[str]) -> None:
    """Compile every source in ``names`` whose library is missing, all
    ``nvcc`` processes started together; raises if any fails."""
    todo = [(n, library_path(n)) for n in names
            if not os.path.exists(library_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.time()
    for name, out in todo:
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append("nvcc failed for %s (rc=%d):\n%s"
                          % (name, proc.returncode, log[-6000:]))
            continue
        os.replace(tmp, out)
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        BUILD_LOG[name] = {"seconds": time.time() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
