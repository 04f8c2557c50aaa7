"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into an object — all
sources at once, one ``nvcc`` process each — and the objects link into one
shared library with a plain C interface, loaded with ``ctypes``.  Nothing is
built when a module is imported: the first kernel launch (or an explicit
``library()`` call) builds, into ``build/`` beside the package, under a name
that hashes the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  The build writes to a temporary directory and
renames the finished library into place, so concurrent processes never load
a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
#: CUTLASS's headers (``$CUTLASS_HOME/include``): flash_attention's wgmma
#: body takes its shared-memory descriptor type from CuTe
CUTLASS_INCLUDE = Path(os.environ.get("CUTLASS_HOME", "/usr/local/cutlass")) / "include"

#: sm_90a: the Hopper target with wgmma/setmaxnreg (plain sm_90 refuses them).
#: No -lcuda: the driver's cuTensorMapEncodeTiled is looked up at run time
#: (cudaGetDriverEntryPointByVersion in csrc/flash_attention.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-I", str(CUTLASS_INCLUDE),
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    **{
        f"tree_glasso_launch_{t}": (
            _I, [_P, _P, ctypes.c_longlong, ctypes.c_double, _P, _I, _I, _P],
        )
        for t in ("f64", "f32")
    },
    **{
        f"bucket_glasso_launch_{t}": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_double, _I, _P],
        )
        for t in ("f64", "f32")
    },
    "bucket_glasso_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "bucket_glasso_scratch_values": (ctypes.c_longlong, [_I, _I]),
    "threshold_cc_rows_launch": (
        _I, [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_double, _I, _P],
    ),
    **{
        name: (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, lam_t, _P])
        for name, lam_t in (("covgram_screen_launch", ctypes.c_double),
                            ("covgram_screen_launch_f32", ctypes.c_float))
    },
    **{f"covgram_launch_{t}": (_I, [_P, _P, _P, _I, _I, _P]) for t in ("f32", "bf16")},
    "covgram_division_mismatches": (_I, [_I, _P, _P]),
    **{
        name: (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P])
        for name in ("flash_attention_launch_f32", "flash_attention_wgmma_launch_bf16")
    },
    "flash_attention_instance_info": (_I, [_I, _I, _P]),
    **{
        f"joint_prox_launch_{t}": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        )
        for t in ("f64", "f32")
    },
    "joint_prox_scratch_values": (ctypes.c_longlong, [_I, _I, _I, _I, _I]),
    **{
        f"prox_l1_launch_{t}": (
            _I, [_P, _P, _P, ctypes.c_longlong, ctypes.c_double, _P, ctypes.c_longlong,
                 ctypes.c_double, _P, _I, _I, _P],
        )
        for t in ("f64", "f32")
    },
    **{
        f"shard_prox_launch_{t}": (
            _I, [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_double, _P, _P, _P, _P, _P, _P,
                 _I, ctypes.c_longlong, _P],
        )
        for t in ("f64", "f32")
    },
    "repro_torch_cuda_error_string": (ctypes.c_char_p, [_I]),
}

#: the dtypes the solve kernels have an instance for, and the suffix of
#: each instance's entry point
SOLVE_DTYPES = {torch.float64: "f64", torch.float32: "f32"}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels build on first "
            "use on a machine with the CUDA toolkit"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile and link the kernels if the library is missing.

    Returns (library path, build seconds, compiler output); seconds is 0.0
    and the output empty when an up-to-date library already existed."""
    target = library_path()
    if target.is_file():
        return target, 0.0, ""
    if not (CUTLASS_INCLUDE / "cute").is_dir():
        raise RuntimeError(
            f"CUTLASS headers not found at {CUTLASS_INCLUDE} (set CUTLASS_HOME); "
            "csrc/flash_attention.cu includes CuTe's cute/arch/mma_sm90_desc.hpp"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append(
                (src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ))
            )
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [exe, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_so),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        os.replace(tmp_so, target)
    return target, time.perf_counter() - t0, "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB


def check(status: int, kernel: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if status != 0:
        msg = library().repro_torch_cuda_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({msg})")


def lane_operand(
    kernel: str, name: str, x, n: int, like: torch.Tensor
) -> tuple[torch.Tensor | None, int, float]:
    """A per-lane kernel argument as (tensor, lane stride, value), the
    launcher's (pointer, stride, value): a Python scalar or a CPU 0-d tensor
    by value (no tensor); a 0-d tensor on ``like``'s device by pointer with
    stride 0, converted first when its dtype differs; an (n,) tensor of
    ``like``'s dtype and device by pointer with its own stride.  Nothing is
    filled, expanded or copied for the last two; the caller holds the
    returned tensor until the launch is enqueued (a converted one is new).
    Anything else raises ``ValueError``."""
    if not isinstance(x, torch.Tensor) or (x.ndim == 0 and x.device.type == "cpu"):
        return None, 0, float(x)
    if x.ndim == 0 and x.device == like.device:
        return (x if x.dtype == like.dtype else x.to(like.dtype)), 0, 0.0
    if x.shape != (n,) or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(
            f"{kernel}: {name} must be a scalar or ({n},) {like.dtype} on "
            f"{like.device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
        )
    return x, x.stride(0), 0.0


def instance(kernel: str, dtype: torch.dtype) -> str:
    """Suffix of the solve kernel's entry point for ``dtype`` ("f64" or
    "f32"); any other dtype raises ``TypeError``."""
    try:
        return SOLVE_DTYPES[dtype]
    except KeyError:
        raise TypeError(
            f"{kernel}: the CUDA kernel takes float64 or float32, got {dtype}"
        ) from None


def check_operands(kernel: str, blocks, *per_block) -> tuple[int, int]:
    """Validate a (N, b, b) float64 or float32 CUDA stack and its (N,)
    per-block vectors of the same dtype and device; returns (N, b)."""
    if blocks.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {blocks.device}")
    instance(kernel, blocks.dtype)
    if blocks.ndim != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"{kernel}: blocks must be (N, b, b), got {tuple(blocks.shape)}")
    n = blocks.shape[0]
    for v in per_block:
        if v.shape != (n,) or v.dtype != blocks.dtype or v.device != blocks.device:
            raise ValueError(
                f"{kernel}: per-block vectors must be ({n},) {blocks.dtype} on "
                f"{blocks.device}, got {tuple(v.shape)} {v.dtype} on {v.device}"
            )
    return n, blocks.shape[1]
