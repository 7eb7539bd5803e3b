"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``kernels/<name>/csrc/*.cu`` file in the package has a plain C
interface (no PyTorch headers), so each compiles with ``nvcc`` in seconds.
All of them are compiled in parallel, one ``nvcc`` per source, and linked
into one shared library under ``build/repro_torch/<hash>/`` at the root of
the checkout (listed in ``.gitignore``); the hash keys on every file under
``csrc/`` (headers too) and the flags, so an edited kernel rebuilds and an
unchanged one loads from disk. If ``nvcc`` fails, the error carries its stderr.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; `launch` raises when that is not 0 and
only then counts the launch in `CUDA_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_DIR.parent.parent
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"      # where the CUDA toolkit puts it

#: streaming multiprocessors of an H100 SXM: the block count the launch
#: pickers aim for when they are not given the card's own (`sm_count`)
H100_SMS = 132

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]
# No -lcuda: the one libcuda call (cuTensorMapEncodeTiled, for the flash
# kernel's TMA maps) is looked up with dlsym at run time; dlopen is libc's.
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

#: kernel name -> hand-kernel launches issued (bumped only after a launch
#: that returned cudaSuccess; plain-version calls never count)
CUDA_LAUNCHES: Dict[str, int] = {
    "spike_matmul_mapped": 0,
    "lif_epilogue_scan": 0,
    "dense_conv_lif": 0,
    "spike_matmul": 0,
    "lif_step": 0,
    "int4_matmul": 0,
    "flash_attention": 0,
}

_LIB: Optional[ctypes.CDLL] = None
_FUNCS: Dict[str, Callable[..., int]] = {}   # entry points with argtypes set


def reset_cuda_launches() -> None:
    for name in CUDA_LAUNCHES:
        CUDA_LAUNCHES[name] = 0


def sources() -> List[Path]:
    return sorted(PACKAGE_DIR.glob("kernels/*/csrc/*.cu"))


def csrc_files() -> List[Path]:
    """Every file under ``kernels/*/csrc/``: the sources and what they may
    include."""
    return sorted(p for p in PACKAGE_DIR.glob("kernels/*/csrc/**/*") if p.is_file())


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in csrc_files():
        h.update(str(path.relative_to(PACKAGE_DIR)).encode())
        h.update(path.read_bytes())
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
    out_dir = BUILD_ROOT / _digest()
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
            [nvcc, *LINK_FLAGS, "-o", str(tmp_lib), *map(str, objs)],
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


def ptr(t: torch.Tensor) -> int:
    """A tensor's device address, for a ``ctypes.c_void_p`` argument (ctypes
    converts the int; no pointer object is built per launch)."""
    return t.data_ptr()


def stream() -> int:
    """The current device's current stream as a raw handle: the query
    PyTorch's own generated kernels make, with no `torch.cuda.Stream`
    object built per launch."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


@functools.lru_cache(maxsize=None)
def sm_count(device_index) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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


_FLOAT32 = (torch.float32,)


def check_cuda_operands(name: str, dtypes: Optional[Dict[str, Tuple[torch.dtype, ...]]] = None,
                        **tensors: torch.Tensor) -> None:
    """Raise unless every operand has a dtype its kernel takes and is a
    contiguous, 16-byte aligned CUDA tensor, all on one device (what the
    kernels' vector loads assume).

    ``dtypes`` maps an operand's name to the dtypes allowed for it; an
    operand it does not name must be float32. The dtype is checked first,
    so a wrong dtype raises on any device, before anything is launched.
    """
    dtypes = dtypes or {}
    for arg, t in tensors.items():
        allowed = dtypes.get(arg, _FLOAT32)
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {arg} must be one of {allowed}, got {t.dtype}")
    # cheap tensor queries; a `torch.device` is built only for a message
    index = next(iter(tensors.values())).get_device()
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, not a CUDA device")
        if t.get_device() != index:
            devices = {u.device for u in tensors.values()}
            raise ValueError(f"{name}: operands on several devices {devices}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def is_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain path), False for CUDA (hand kernel);
    raises for any other device."""
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"{name}: no kernel for device {t.device}")
