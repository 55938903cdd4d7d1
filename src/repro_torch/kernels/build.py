"""Builds the hand-written CUDA kernels and binds them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at
the repository root, at its first use; the hash is of the source and
of the shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt
and a stale library is never loaded.  Nothing is built or imported
when this module is imported: the CPU tests import every module on a
host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
KERNELS = ("vote_aggregate", "tree_hist", "flash_attention",
           "flash_attention_bwd", "rglru_scan", "rglru_scan_bwd", "wkv6",
           "wkv6_bwd")

# sources nvcc compiles with split compilation, over every core of the
# host: the attention backward's ~40 template instances (bf16 wgmma and
# float32 split-TF32, each head dim and soft-cap) took 137 s in one
# nvcc alone on an 8-core H100 host, 48 s split; the other sources take
# 4-17 s each
SPLIT_COMPILE = ("flash_attention_bwd",)

_LIBS: Dict[str, ctypes.CDLL] = {}
# several host threads launch kernels in one process (the thread and
# socket transports run a party a thread): one lock makes the first
# load (and build) of a library happen once, another makes each
# wrapper's ``launches += 1`` lose no increment
_LOAD_LOCK = threading.Lock()
COUNT_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda; "
                           "the CUDA kernels are built on the GPU host")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def command(src: Path, out: Path):
    """The nvcc command that builds the kernel source ``src`` into the
    shared library ``out``."""
    split = ["--split-compile=0"] if src.stem in SPLIT_COMPILE else []
    return [nvcc(), ARCH, "-std=c++17", "-O3", *split, "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(src)]


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compiles every named kernel that is not built yet, one ``nvcc``
    per source, all started together.  Returns {name: ptxas report}
    (registers, shared memory and spills per kernel; empty for a
    library that was already built).  Raises if any build fails."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        final = lib_path(name)
        if final.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        procs[name] = (tmp, final, subprocess.Popen(
            command(CSRC / f"{name}.cu", Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {name: "" for name in names}, []
    for name, (tmp, final, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            os.unlink(tmp)
        else:
            # atomic publish: a concurrent build never loads a torn file
            os.replace(tmp, final)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed; safe to call
    from several threads at once."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = lib_path(name)
                if not path.exists():
                    build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(err: int, name: str) -> None:
    """Raises on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
