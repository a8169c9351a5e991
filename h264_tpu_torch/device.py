"""Device policy and the build of the package's CUDA kernels.

Every entry point of the package takes a ``device`` argument.  ``None``
means the CUDA card: the package is written for it, and without one it
raises instead of continuing quietly on the host.  ``"cpu"`` runs every
kernel's plain PyTorch version (the tests do this).

The CUDA kernels (``csrc/*.cu``) are built at first use with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, loaded with
``ctypes``; the host C runtime (``native/*.c``) is built the same way with
``gcc``.  Both land in ``build/h264_tpu_torch/`` beside the package.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "h264_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_cuda_libs: dict = {}
build_log: dict = {}  # stem -> nvcc's stderr (ptxas register/smem report)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "h264_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _stale(so: pathlib.Path, srcs) -> bool:
    return not so.exists() or any(
        so.stat().st_mtime < pathlib.Path(s).stat().st_mtime for s in srcs)


def _cuda_so(stem: str) -> pathlib.Path:
    # "_sm90a" keeps kernel libraries apart from the host C ones
    # (csrc/deblock.cu and native/deblock.c share a stem)
    return BUILD_DIR / f"lib{stem}_sm90a.so"


def build_cuda(stems) -> None:
    """Compile every stale ``csrc/<stem>.cu`` into
    ``build/h264_tpu_torch/lib<stem>_sm90a.so``: one nvcc per source, all
    started together.  Raises with nvcc's output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for stem in stems:
        src = CSRC / f"{stem}.cu"
        so = _cuda_so(stem)
        if not _stale(so, [src, *CSRC.glob("*.cuh")]):
            continue
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((stem, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for stem, so, tmp, p in procs:
        out, err = p.communicate()
        build_log[stem] = out + err
        if p.returncode != 0:
            failed.append(f"{stem}: nvcc exit {p.returncode}\n{out}{err}")
        else:
            os.replace(tmp, so)  # atomic: no process loads a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load_cuda(stem: str) -> ctypes.CDLL:
    """The loaded kernel library of ``csrc/<stem>.cu``, built if stale."""
    with _lock:
        lib = _cuda_libs.get(stem)
        if lib is None:
            build_cuda([stem])
            lib = ctypes.CDLL(str(_cuda_so(stem)))
            _cuda_libs[stem] = lib
        return lib


def build_host_c(stem: str, src_dir: pathlib.Path,
                 extra=()) -> pathlib.Path:
    """Compile ``<src_dir>/<stem>.c`` (and the `extra` sources of that
    directory, linked as separate translation units) with gcc into
    ``build/h264_tpu_torch/lib<stem>.so`` if stale; returns its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = [src_dir / f"{stem}.c", *(src_dir / x for x in extra)]
    so = BUILD_DIR / f"lib{stem}.so"
    if _stale(so, srcs):
        tmp = BUILD_DIR / f"lib{stem}.so.tmp{os.getpid()}"
        base = ["gcc", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                *map(str, srcs)]
        r = subprocess.run(base[:2] + ["-march=native", "-fno-math-errno"]
                           + base[2:], capture_output=True)
        if r.returncode != 0:  # conservative flags
            subprocess.run(base, check=True, capture_output=True)
        os.replace(tmp, so)
    return so


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}


def kernel_fn(stem: str, name: str, sig: str):
    """The C entry `name` of ``lib<stem>.so`` with its argument types
    (`sig`: one letter per argument, p pointer, i int) and an int result
    (the CUDA error code)."""
    fn = getattr(load_cuda(stem), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
    return fn


def check_tensor(fn: str, name: str, x, shape, dtype, device) -> None:
    """Raise unless x is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if (not isinstance(x, torch.Tensor) or x.device != device
            or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
               if isinstance(x, torch.Tensor) else type(x).__name__)
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor "
                         f"of shape {tuple(shape)} on {device}, got {got}")


def stream_of(x) -> int:
    """The current CUDA stream of x's device, as an int for ctypes."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
