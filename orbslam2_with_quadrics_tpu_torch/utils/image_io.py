"""Image decoding for the drivers: the native prefetching loader
(``csrc/image_loader.cpp``), else OpenCV, else Pillow.

Counterpart of the reference package's ``native/`` binding (whose package
imports JAX, so its source is copied here rather than imported). The C++
library is built by ``g++`` at first use into ``build/torch_native/``
(cached by the source's hash) and bound with ``ctypes``.

The decoder is chosen once per process (:func:`decoder`): the native loader
if it builds and loads (it needs ``g++``, ``png.h`` and ``jpeglib.h``), then
``cv2``, then ``PIL``; none raises. The drivers print the choice and why an
earlier one was passed over. Every decoder gives the same contract: float32
grey [H, W] (BT.601 luma ``0.299 R + 0.587 G + 0.114 B`` in float32 for a
colour image), plus the raw uint16 counts of a 16-bit grey PNG (depth).
PNG and PNM are lossless, so on grey images all three give equal arrays; a
colour JPEG's grey differs between libjpeg (which returns luma itself) and
the others.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "image_loader.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
DECODERS = ("native", "cv2", "PIL")


def build(force: bool = False) -> Path:
    """Compile the loader to a shared library (cached by the source's hash;
    ``force`` compiles it again)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{_SRC.stem}_{digest}.so"
    if out.exists() and not force:
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, str(_SRC),
           "-lpng", "-ljpeg", "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}): {res.stderr.strip()[-2000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    """The native library, built, loaded and typed once (built again where a
    cached library does not load: one built on another machine)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except OSError:
        lib = ctypes.CDLL(str(build(force=True)))
    lib.slam_loader_create.restype = ctypes.c_void_p
    lib.slam_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.slam_loader_peek.restype = ctypes.c_int
    lib.slam_loader_peek.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.slam_loader_next.restype = ctypes.c_int
    lib.slam_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    lib.slam_loader_destroy.restype = None
    lib.slam_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class Decoder(NamedTuple):
    name: str   # one of DECODERS
    why: str    # why the decoders before it were passed over ("" for native)


@functools.lru_cache(maxsize=1)
def decoder() -> Decoder:
    """This process's image decoder, chosen at the first call: the native
    loader, then ``cv2``, then ``PIL``. Raises RuntimeError if none is
    present."""
    passed = []
    try:
        _lib()
        return Decoder("native", "")
    except (OSError, RuntimeError) as e:
        passed.append(f"native loader unavailable: {e}")
    for name in DECODERS[1:]:
        if importlib.util.find_spec(name) is not None:
            return Decoder(name, "; ".join(passed))
        passed.append(f"{name} not installed")
    raise RuntimeError("no image decoder: " + "; ".join(passed))


def _luma(rgb: np.ndarray) -> np.ndarray:
    """float32 BT.601 luma of an [H, W, 3] RGB array, in the native
    loader's order of operations."""
    r, g, b = (rgb[..., c].astype(np.float32) for c in range(3))
    return np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b


def _to_gray(arr: np.ndarray, bgr: bool):
    """(float32 grey, uint16 raw counts or None) of a decoded array."""
    if arr.ndim == 2:
        if arr.dtype == np.uint16:
            return arr.astype(np.float32), np.ascontiguousarray(arr)
        return arr.astype(np.float32), None
    if arr.dtype == np.uint16:  # a 16-bit colour image keeps its high bytes
        arr = (arr >> 8).astype(np.uint8)
    rgb = arr[..., 2::-1] if bgr else arr[..., :3]
    return _luma(rgb), None


def _decode_cv2(path: str):
    import cv2

    arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if arr is None:
        raise ValueError(f"cv2 cannot decode {path}")
    return _to_gray(arr, bgr=True)


def _decode_pil(path: str):
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I;16L", "I"):
            return _to_gray(np.asarray(im).astype(np.uint16), bgr=False)
        if im.mode == "L":
            return _to_gray(np.asarray(im), bgr=False)
        return _to_gray(np.asarray(im.convert("RGB")), bgr=False)


def decode(path, using: str | None = None):
    """(float32 grey [H, W], uint16 raw counts or None) of one image, by
    ``using`` (one of ``DECODERS``; default: this process's decoder)."""
    path = os.fspath(path)
    using = using or decoder().name
    if using == "native":
        with AsyncImageLoader([path], n_threads=1, capacity=2, using="native") as it:
            return next(it)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return {"cv2": _decode_cv2, "PIL": _decode_pil}[using](path)


def load_gray(path) -> np.ndarray:
    """float32 grey [H, W] of one image."""
    return decode(path)[0]


def load_raw16(path) -> np.ndarray:
    """uint16 counts [H, W] of a 16-bit grey PNG (a TUM depth map)."""
    _, raw16 = decode(path)
    if raw16 is None:
        raise ValueError(f"{path}: not a 16-bit single-channel image")
    return raw16


def write_png(path, img: np.ndarray):
    """Write a grey PNG with the standard library alone: uint8 [H, W] as
    8-bit grey, uint16 [H, W] as 16-bit grey (big-endian, as PNG stores
    it). zlib level 1, OpenCV's ``imwrite`` default."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: uint8 or uint16 [H, W], got {img.dtype} {img.shape}")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">"), copy=False).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 per row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


class AsyncImageLoader:
    """In-order prefetching decoder over a list of image paths: yields
    (float32 grey [H, W], uint16 raw counts or None) per path, decoding up
    to ``capacity`` frames ahead on ``n_threads`` threads (C++ threads for
    the native loader, a thread pool for ``cv2`` / ``PIL``). A frame that
    does not decode raises ValueError.

        with AsyncImageLoader(paths, n_threads=2) as it:
            for img, raw16 in it:
                ...
    """

    def __init__(self, paths, n_threads: int = 2, capacity: int = 8,
                 using: str | None = None):
        self.paths = [os.fspath(p) for p in paths]
        self.using = using or decoder().name
        self._n, self._i = len(self.paths), 0
        self._h = None
        self._pool = None
        capacity = max(capacity, 2)
        if self.using == "native":
            self._lib = _lib()
            self._cpaths = (ctypes.c_char_p * max(self._n, 1))(
                *[p.encode() for p in self.paths])
            self._h = self._lib.slam_loader_create(self._cpaths, self._n, max(n_threads, 1),
                                                   capacity)
        else:
            fn = {"cv2": _decode_cv2, "PIL": _decode_pil}[self.using]
            self._pool = concurrent.futures.ThreadPoolExecutor(max(n_threads, 1))
            self._ahead = collections.deque(
                self._pool.submit(fn, p) for p in self.paths[:capacity])
            self._fn, self._next_submit = fn, min(capacity, self._n)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._h:
            self._lib.slam_loader_destroy(self._h)
            self._h = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        path = self.paths[self._i]
        if self.using == "native":
            out = self._next_native(path)
        else:
            fut = self._ahead.popleft()
            if self._next_submit < self._n:
                self._ahead.append(self._pool.submit(self._fn, self.paths[self._next_submit]))
                self._next_submit += 1
            out = fut.result()
        self._i += 1
        return out

    def _next_native(self, path):
        if not self._h:
            raise ValueError("the loader is closed")
        h, w, is16 = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if not self._lib.slam_loader_peek(self._h, ctypes.byref(h), ctypes.byref(w),
                                          ctypes.byref(is16)):
            raise ValueError(f"cannot decode {path}")
        gray = np.empty((h.value, w.value), np.float32)
        raw16 = np.empty((h.value, w.value), np.uint16) if is16.value else None
        ok = self._lib.slam_loader_next(
            self._h, gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            raw16.ctypes.data_as(ctypes.c_void_p) if raw16 is not None else None)
        if not ok:
            raise ValueError(f"cannot decode {path}")
        return gray, raw16
