"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``kernels/<name>/csrc/*.cu`` file in the package has a plain C
interface (no PyTorch headers), so each compiles with ``nvcc`` in seconds.
All of them are compiled in parallel, one ``nvcc`` per source, and linked
into one shared library under ``build/repro_torch/<hash>/`` at the root of
the checkout (listed in ``.gitignore``); the hash keys on the sources and
the flags, so an edited kernel rebuilds and an unchanged one loads from
disk. If ``nvcc`` fails, the error carries its stderr.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; `launch` raises when that is not 0 and
only then counts the launch in `CUDA_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_DIR.parent.parent
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"      # where the CUDA toolkit puts it

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

#: kernel name -> hand-kernel launches issued (bumped only after a launch
#: that returned cudaSuccess; plain-version calls never count)
CUDA_LAUNCHES: Dict[str, int] = {
    "spike_matmul_mapped": 0,
    "lif_epilogue_scan": 0,
    "dense_conv_lif": 0,
}

_LIB: Optional[ctypes.CDLL] = None
_FUNCS: Dict[str, Callable[..., int]] = {}   # entry points with argtypes set


def reset_cuda_launches() -> None:
    for name in CUDA_LAUNCHES:
        CUDA_LAUNCHES[name] = 0


def sources() -> List[Path]:
    return sorted(PACKAGE_DIR.glob("kernels/*/csrc/*.cu"))


def _digest(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in srcs:
        h.update(str(src.relative_to(PACKAGE_DIR)).encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (on PATH or at {NVCC_FALLBACK}): "
                           "the CUDA kernels cannot be built")
    return nvcc


def build(*, force: bool = False, ptxas_verbose: bool = False) -> dict:
    """Compile every kernel source into the shared library.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's stderr
    (the ``-Xptxas -v`` register/spill report when asked for). Without
    ``force`` an existing library for the same sources is reused.
    """
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists() and not force:
        return {"path": lib_path, "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, err = proc.communicate()
            log.append(f"== {src.relative_to(PACKAGE_DIR)}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)      # atomic: concurrent builders agree
    return {"path": lib_path, "seconds": time.perf_counter() - t0,
            "log": "\n".join(log)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()["path"]))
    return _LIB


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def launch(name: str, argtypes: Sequence, *args) -> None:
    """Call the C entry point ``name`` and count the launch.

    Raises when the entry point reports a CUDA error: a refused launch
    never runs, and nothing else would report it.
    """
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    CUDA_LAUNCHES[name] += 1


def check_cuda_operands(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous, 16-byte aligned float32
    CUDA tensor on one device (what the kernels' vector loads assume)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def is_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain path), False for CUDA (hand kernel);
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")
