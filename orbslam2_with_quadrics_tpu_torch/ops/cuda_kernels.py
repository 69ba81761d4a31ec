"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Counterpart of the reference's ``ops/pallas_kernels.py``. One kernel:

``masked_hamming_best2`` — masked Hamming best/second-best
(``csrc/masked_hamming_best2.cu``), replacing the TPU Pallas kernel
``pallas_kernels.py::_kernel``. Its contract is the reference's
``best_two(where(mask, hamming_matrix, _BIG))``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernel is compiled at first use by ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` (a plain C entry point loaded with ``ctypes``).
``LAUNCHES`` counts kernel launches per kernel name.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_BIG = 1 << 20
_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "masked_hamming_best2.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

LAUNCHES = {"masked_hamming_best2": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build() -> Path:
    """Compile the kernel source to a shared library (cached by its hash)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{_SRC.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build()))
    fn = lib.masked_hamming_best2_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


def masked_hamming_best2_plain(qdesc, quv, qrad, qlvl, qvalid,
                               tdesc, tuv, tlvl, tvalid, level_tol: int = 1):
    """Plain PyTorch version: byte-LUT Hamming matrix + ``best_two``."""
    from .matching import best_two, hamming_matrix

    du = torch.abs(quv[:, 0:1] - tuv[None, :, 0])
    dv = torch.abs(quv[:, 1:2] - tuv[None, :, 1])
    mask = (
        (du <= qrad[:, None]) & (dv <= qrad[:, None])
        & (torch.abs(tlvl[None, :] - qlvl[:, None]) <= level_tol)
        & qvalid[:, None] & tvalid[None, :]
    )
    idx, best, second = best_two(hamming_matrix(qdesc, tdesc), mask)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


_SPEC = (  # name, dtype, trailing shape, byte alignment the kernel reads at
    ("qdesc", torch.int32, (8,), 16), ("quv", torch.float32, (2,), 8),
    ("qrad", torch.float32, (), 4), ("qlvl", torch.int32, (), 4),
    ("qvalid", torch.bool, (), 1), ("tdesc", torch.int32, (8,), 16),
    ("tuv", torch.float32, (2,), 8), ("tlvl", torch.int32, (), 4),
    ("tvalid", torch.bool, (), 1),
)


def _check(args):
    dev = args[0].device
    Q, N = args[0].shape[0], args[5].shape[0]
    for (name, dtype, tail, align), t in zip(_SPEC, args):
        rows = Q if name[0] == "q" else N
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != (rows,) + tail:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(rows,) + tail}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name} must be contiguous and {align}-byte aligned")
    return dev, Q, N


def masked_hamming_best2(qdesc, quv, qrad, qlvl, qvalid,
                         tdesc, tuv, tlvl, tvalid, level_tol: int = 1):
    """(bidx [Q], best [Q], second [Q]) int32 over the window-masked
    Hamming matrix. Shapes: qdesc [Q,8] int32, quv [Q,2] f32, qrad [Q] f32,
    qlvl [Q] int32, qvalid [Q] bool; t* likewise with N rows."""
    args = (qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid)
    dev, Q, N = _check(args)
    if dev.type == "cpu":
        return masked_hamming_best2_plain(*args, level_tol=level_tol)
    if dev.type != "cuda":
        raise ValueError(f"masked_hamming_best2: unsupported device {dev}")
    out = [torch.empty((Q,), dtype=torch.int32, device=dev) for _ in range(3)]
    if Q == 0:
        return tuple(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().masked_hamming_best2_launch(
            *[t.data_ptr() for t in args], Q, N, int(level_tol),
            *[t.data_ptr() for t in out], stream,
        )
    if err != 0:
        raise RuntimeError(f"masked_hamming_best2 launch failed: cudaError {err}")
    LAUNCHES["masked_hamming_best2"] += 1
    return tuple(out)
