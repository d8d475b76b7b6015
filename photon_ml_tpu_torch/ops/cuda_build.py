"""Build and load the port's CUDA kernels.

Each kernel is a shared library with a plain C entry point, built from
translation units under ``photon_ml_tpu_torch/csrc/``. At first use
``nvcc`` compiles every unit for ``sm_90a`` at once, one process each,
then links them into ``csrc/_build/`` (listed in .gitignore) under a
name keyed by a hash of the sources, headers and flags; the library is
loaded with ``ctypes``. A source change therefore rebuilds; an unchanged
one loads the cached library. ``build_all`` starts every unit of every
kernel together, so a fresh checkout's build takes as long as the
slowest unit plus the links.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no multiply-add contraction, so a kernel rounds each
# product as its plain PyTorch version does. A bounded entity at its
# optimum ends on a line search whose Armijo test sits at that rounding:
# with contraction the entity solver and its plain version stopped 2 of
# 4,995 such entities for different reasons on the H100.
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                        "-fPIC", "-Xptxas", "-v"]


class KernelSources(NamedTuple):
    units: Tuple[str, ...]  # compiled separately, in parallel
    headers: Tuple[str, ...]  # included by the units


KERNEL_SOURCES: Dict[str, KernelSources] = {
    "entity_lbfgs": KernelSources(
        units=("entity_lbfgs.cu", "entity_lbfgs_lbfgs_f64.cu",
               "entity_lbfgs_lbfgs_f32.cu", "entity_lbfgs_owlqn_f64.cu",
               "entity_lbfgs_owlqn_f32.cu", "entity_lbfgs_tron_f64.cu",
               "entity_lbfgs_tron_f32.cu"),
        headers=("entity_lbfgs.cuh",)),
    "gather": KernelSources(
        units=("gather_onehot.cu", "gather_residue.cu"), headers=()),
    "csr_spmv": KernelSources(units=("csr_spmv.cu",),
                              headers=("csr_order.cuh",)),
    "csr_spmm": KernelSources(units=("csr_spmm.cu", "csr_spmm_f64.cu"),
                              headers=("csr_order.cuh", "csr_spmm.cuh")),
    "device_loop": KernelSources(units=("device_loop.cu",), headers=()),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> Path:
    src = KERNEL_SOURCES[name]
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in src.units + src.headers:
        digest.update(f.encode())
        digest.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands at once; their combined outputs, in order. Raises
    with the output of the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return logs


def build_all(names: List[str] = None) -> Dict[str, dict]:
    """Build every named kernel (all by default) that has no cached
    library: every unit compiled at once, then one link per kernel.
    Returns per kernel ``{"path", "seconds", "log"}``; ``log`` holds
    nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) for
    fresh builds."""
    names = list(KERNEL_SOURCES) if names is None else names
    t0 = time.perf_counter()
    report = {}
    pending = []
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"path": str(out), "seconds": 0.0, "log": ""}
        else:
            pending.append(name)
    if not pending:
        return report
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objects = {name: [BUILD_DIR / f"{Path(u).stem}.{tag}.o"
                      for u in KERNEL_SOURCES[name].units]
               for name in pending}
    compile_cmds, owners = [], []
    for name in pending:
        for unit, obj in zip(KERNEL_SOURCES[name].units, objects[name]):
            compile_cmds.append([_nvcc(), *COMPILE_FLAGS, "-c", "-o",
                                 str(obj), str(CSRC / unit)])
            owners.append(name)
    try:
        logs = _run_all(compile_cmds)
        tmps = {name: library_path(name).with_suffix(f".{tag}.tmp")
                for name in pending}
        _run_all([[_nvcc(), *ARCH, "-shared", "-o", str(tmps[name]),
                   *map(str, objects[name])] for name in pending])
        for name in pending:
            os.replace(tmps[name], library_path(name))
            report[name] = {
                "path": str(library_path(name)),
                "seconds": time.perf_counter() - t0,
                "log": "".join(log for log, owner in zip(logs, owners)
                               if owner == name)}
    finally:
        for objs in objects.values():
            for obj in objs:
                obj.unlink(missing_ok=True)
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
