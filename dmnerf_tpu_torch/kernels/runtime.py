"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with nvcc for ``sm_90a`` into a shared library
with a plain C interface and loaded with ctypes. The sources of a kernel pair share
their code through the headers ``csrc/*.cuh``. The build happens at first use, into
``build/kernels/`` at the root of the checkout, under a file name keyed by a hash of
the source, the headers and the flags, so an edited source or header is rebuilt and
an unchanged one is not. Nothing is built or loaded when a module is imported. A build
holds a file lock in ``build/kernels/``, so the ranks of a process group on one host
build each source once and load what the first one built.

``LAUNCHES`` counts, per kernel entry point (``COUNTED``), the launches its wrapper made
(``count_launch``; a launch recorded into a CUDA graph is not one); a run resets it with
``reset_launches()`` and reads it afterwards to show which kernels ran.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the sources: K1, K2 (pe_mode 'kernel_t'), K3, K4 (pe_mode 'kernel'), K5, K6, K7 (pe_mode
# 'outside': the forward and backward over precomputed embeddings, and the embedding),
# the fused render passes K8c, K8f (two entry points of one source), the head probes
# K9, K10, the instance loss's assignment K11 and a training bundle's instance channels
# K12 (a forward and a backward entry point)
KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "fused_mlp_fwd_kpe", "fused_mlp_bwd_kpe",
           "fused_mlp_fwd_pe", "fused_mlp_bwd_pe", "fused_pe", "fused_render", "head512",
           "heads_fused", "assignment", "instance_terms")
ENTRIES = {"fused_render": ("fused_render_weights", "fused_render_maps"),
           "instance_terms": ("instance_terms_fwd", "instance_terms_bwd")}
COUNTED = tuple(e for k in KERNELS for e in ENTRIES.get(k, (k,)))
LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTED}
_LOADED: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel, made by its wrapper on the current stream. While
    that stream is being captured into a CUDA graph nothing runs, so nothing is counted;
    a graph's launches show in torch.profiler's device activity instead."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, $PATH)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process per
    source, all started together, under the build directory's lock. Returns each
    source's compiler report (register and shared-memory use from ``-Xptxas -v``);
    raises on the first failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes or we exit
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, str]:
    procs: List = []
    reports: Dict[str, str] = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            reports[name] = (so.with_suffix(".log").read_text()
                             if so.with_suffix(".log").exists() else "")
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
        reports[name] = out
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
