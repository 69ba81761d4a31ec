"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Counterpart of the reference's ``ops/pallas_kernels.py``. One kernel:

``masked_hamming_best2`` — masked Hamming best/second-best, over one
problem or a batch of them in one launch
(``csrc/masked_hamming_best2.cu``), replacing the TPU Pallas kernel
``pallas_kernels.py::_kernel``. Its contract is the reference's
``best_two(where(mask, hamming_matrix, _BIG))``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernel is compiled at first use by ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` (a plain C entry point loaded with ``ctypes``).
``LAUNCHES`` counts kernel launches per kernel name.
"""

from __future__ import annotations

import contextlib
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
# limits of the kernel: the packed (distance, index) key keeps 22 index
# bits, the batch is the grid's y extent, a block takes 1..64 queries
_MAX_TARGETS = 1 << 22
_MAX_BATCH = 65535
_MAX_Q_PER_BLOCK = 64

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
    """Compile the kernel source to a shared library (cached by its hash).
    ptxas' resource report (registers, shared memory, spills) is kept
    beside it as ``<library>.ptxas.txt``."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{_SRC.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    Path(f"{out}.ptxas.txt").write_text(res.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _launcher():
    """The library's C entry point, built, loaded and typed once."""
    fn = ctypes.CDLL(str(build())).masked_hamming_best2_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _q_per_block(n_rows: int, n_sm: int) -> int:
    """Queries a block of 8 warps takes: a multiple of 8 in [8, 64], the
    smallest that leaves at most about two blocks per SM."""
    per = -(-n_rows // (2 * n_sm))
    return min(_MAX_Q_PER_BLOCK, max(8, 8 * -(-per // 8)))


def masked_hamming_best2_plain(qdesc, quv, qrad, qlvl, qvalid,
                               tdesc, tuv, tlvl, tvalid, level_tol: int = 1):
    """Plain PyTorch version: XOR + popcount Hamming matrix + ``best_two``.
    Queries [Q, ...] or [B, Q, ...]; targets [N, ...] (shared by the batch)
    or [B, N, ...]."""
    from .matching import best_two, hamming_matrix

    lead = qrad.shape
    N = tdesc.shape[-2]
    if tdesc.dim() == 3:
        ham = torch.stack([hamming_matrix(q, t) for q, t in zip(qdesc, tdesc)])
        tuv, tlvl, tvalid = tuv[:, None], tlvl[:, None], tvalid[:, None]
    else:
        ham = hamming_matrix(qdesc.reshape(-1, 8), tdesc).reshape(lead + (N,))
    du = torch.abs(quv[..., 0:1] - tuv[..., 0])
    dv = torch.abs(quv[..., 1:2] - tuv[..., 1])
    mask = (
        (du <= qrad[..., None]) & (dv <= qrad[..., None])
        & (torch.abs(tlvl - qlvl[..., None]) <= level_tol)
        & qvalid[..., None] & tvalid
    )
    idx, best, second = best_two(ham, mask)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


_SPEC = (  # name, dtype, trailing shape, byte alignment the kernel reads at
    ("qdesc", torch.int32, (8,), 16), ("quv", torch.float32, (2,), 8),
    ("qrad", torch.float32, (), 4), ("qlvl", torch.int32, (), 4),
    ("qvalid", torch.bool, (), 1), ("tdesc", torch.int32, (8,), 16),
    ("tuv", torch.float32, (2,), 8), ("tlvl", torch.int32, (), 4),
    ("tvalid", torch.bool, (), 1),
)


def _check(args):
    """Raise on what the kernel does not take; returns (device, query
    leading shape, target leading shape, the tensors' addresses)."""
    dev = args[0].device
    q_lead, t_lead = tuple(args[2].shape), tuple(args[7].shape)
    if len(q_lead) not in (1, 2) or len(t_lead) not in (1, 2) or (
            len(t_lead) == 2 and (len(q_lead) != 2 or t_lead[0] != q_lead[0])):
        raise ValueError(f"queries {q_lead} and targets {t_lead}: expected [Q] or [B, Q] "
                         f"queries with [N] or [B, N] targets")
    ptrs = []
    for (name, dtype, tail, align), t in zip(_SPEC, args):
        want = (q_lead if name[0] == "q" else t_lead) + tail
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
        ptr = t.data_ptr()
        if not t.is_contiguous() or ptr % align:
            raise ValueError(f"{name} must be contiguous and {align}-byte aligned")
        ptrs.append(ptr)
    return dev, q_lead, t_lead, ptrs


def masked_hamming_best2(qdesc, quv, qrad, qlvl, qvalid,
                         tdesc, tuv, tlvl, tvalid, level_tol: int = 1,
                         q_per_block: int | None = None):
    """(bidx, best, second) int32 over the window-masked Hamming matrix, each
    shaped like ``qrad``: [Q], or [B, Q] for a batch of B problems in one
    launch. Shapes: qdesc [.., Q, 8] int32, quv [.., Q, 2] f32, qrad [.., Q]
    f32, qlvl [.., Q] int32, qvalid [.., Q] bool; t* likewise with N rows,
    either [B, N, ...] or one [N, ...] target set shared by the batch.
    ``q_per_block`` (1..64, CUDA only) overrides the queries a block takes."""
    args = (qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid)
    dev, q_lead, t_lead, ptrs = _check(args)
    if dev.type == "cpu":
        return masked_hamming_best2_plain(*args, level_tol=level_tol)
    if dev.type != "cuda":
        raise ValueError(f"masked_hamming_best2: unsupported device {dev}")
    Q, N = q_lead[-1], t_lead[-1]
    B = q_lead[0] if len(q_lead) == 2 else 1
    if N >= _MAX_TARGETS or B > _MAX_BATCH:
        raise ValueError(f"masked_hamming_best2: N={N} or B={B} beyond the kernel's "
                         f"limits ({_MAX_TARGETS - 1} targets, {_MAX_BATCH} problems)")
    out = torch.empty((3,) + q_lead, dtype=torch.int32, device=dev)
    if B * Q == 0:
        return out.unbind(0)
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if q_per_block is None:
        q_per_block = _q_per_block(B * Q, _sm_count(index))
    elif not 1 <= q_per_block <= _MAX_Q_PER_BLOCK:
        raise ValueError(f"q_per_block={q_per_block} outside [1, {_MAX_Q_PER_BLOCK}]")
    o = out.data_ptr()
    # the launch goes to the tensors' card; switching is paid only when that
    # is not the current one
    with torch.cuda.device(index) if index != current else contextlib.nullcontext():
        err = _launcher()(
            *ptrs, B, Q, N, int(len(t_lead) == 2), q_per_block, int(level_tol),
            o, o + 4 * B * Q, o + 8 * B * Q, torch.cuda.current_stream(index).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"masked_hamming_best2 launch failed: cudaError {err}")
    LAUNCHES["masked_hamming_best2"] += 1
    return out.unbind(0)
