"""ctypes binding for the native host-side SWAR library.

Builds ``swar.cpp`` with the system C++ compiler on first use (cached next
to the source; rebuilt when the source changes) and exposes
:class:`NativeOps`, a numpy-buffer API with the same op surface as
:mod:`pint_jax.ops.word`.  Used by the host data pipeline (packing control
buffers without JAX dispatch overhead) and as a third independent
implementation for differential testing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from pint_jax.layout import PackedLayout

__all__ = ["NativeOps", "native_available", "load_library"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "swar.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None

BINOP_NAMES = (
    "add_wrap",
    "sub_wrap",
    "add_unsigned_saturate",
    "sub_unsigned_saturate",
    "add_signed_saturate",
    "sub_signed_saturate",
    "min_unsigned",
    "max_unsigned",
    "min_signed",
    "max_signed",
)
SHIFT_NAMES = ("shift_left", "shift_right_unsigned")


def _so_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    cache = Path(
        os.environ.get("PINT_NATIVE_CACHE", _HERE)
    )
    return cache / f"_pint_swar_{tag}.so"


def _build(so: Path) -> None:
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        "-o",
        str(so),
        str(_SRC),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def load_library() -> ctypes.CDLL:
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _BUILD_ERROR is not None:
            raise RuntimeError(_BUILD_ERROR)
        so = _so_path()
        try:
            if not so.exists():
                _build(so)
            _LIB = ctypes.CDLL(str(so))
        except Exception as e:  # record and re-raise once
            _BUILD_ERROR = f"native swar build failed: {e}"
            raise RuntimeError(_BUILD_ERROR) from e
        return _LIB


def native_available() -> bool:
    try:
        load_library()
        return True
    except RuntimeError:
        return False


_SUFFIX = {8: "u8", 16: "u16", 32: "u32", 64: "u64"}


class NativeOps:
    """Buffer-level SWAR ops for one layout, on contiguous numpy arrays."""

    def __init__(self, layout: PackedLayout):
        self.layout = layout
        lib = load_library()
        self._lib = lib
        size = lib.pint_layout_sizeof()
        self._desc = ctypes.create_string_buffer(size)
        widths = (ctypes.c_int * layout.num_lanes)(*layout.widths)
        self._widths = widths
        rc = lib.pint_layout_init(
            widths, layout.num_lanes, ctypes.byref(self._desc)
        )
        if rc != 0:
            raise ValueError(f"pint_layout_init failed with code {rc}")
        self._sfx = _SUFFIX[layout.word_bits]

    # -- helpers ------------------------------------------------------------

    def _words(self, x) -> np.ndarray:
        arr = np.ascontiguousarray(x, dtype=self.layout.word_dtype)
        return arr

    def _binop(self, name: str, a, b) -> np.ndarray:
        a = self._words(a)
        b = np.broadcast_to(self._words(b), a.shape)
        b = np.ascontiguousarray(b)
        out = np.empty_like(a)
        fn = getattr(self._lib, f"pint_{name}_{self._sfx}")
        fn(
            ctypes.byref(self._desc),
            a.ctypes.data_as(ctypes.c_void_p),
            b.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(a.size),
        )
        return out

    def _shift(self, name: str, v, amount: int) -> np.ndarray:
        v = self._words(v)
        out = np.empty_like(v)
        fn = getattr(self._lib, f"pint_{name}_{self._sfx}")
        fn(
            ctypes.byref(self._desc),
            v.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint(int(amount)),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(v.size),
        )
        return out

    # -- ops ----------------------------------------------------------------

    @property
    def _lane_dtype(self):
        """int32 lane buffers below 64-bit words, int64 for u64 (lane
        values up to 64 bits; pint.hpp ctor/get work at every Integer
        width, pint.hpp:768-774, 799-822)."""
        return np.int64 if self.layout.word_bits == 64 else np.int32

    def pack(self, lanes: np.ndarray) -> np.ndarray:
        """(..., n_lanes) int lanes -> (...) packed words, at every word
        width u8/u16/u32/u64 (truncating ctor semantics,
        pint.hpp:770-774)."""
        lanes = np.ascontiguousarray(lanes, dtype=self._lane_dtype)
        n_words = lanes.size // self.layout.num_lanes
        out = np.empty(lanes.shape[:-1], dtype=self.layout.word_dtype)
        fn = getattr(self._lib, f"pint_pack_{self._sfx}")
        fn(
            ctypes.byref(self._desc),
            self._widths,
            self.layout.num_lanes,
            lanes.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(n_words),
        )
        return out

    def unpack(self, words: np.ndarray, signed: bool = False) -> np.ndarray:
        """(...) packed words -> (..., n_lanes) lanes, every word width;
        ``signed`` sign-extends each lane (get_signed, pint.hpp:809-822)."""
        words = self._words(words)
        out = np.empty(
            words.shape + (self.layout.num_lanes,), dtype=self._lane_dtype
        )
        fn = getattr(
            self._lib,
            f"pint_unpack_signed_{self._sfx}"
            if signed
            else f"pint_unpack_{self._sfx}",
        )
        fn(
            ctypes.byref(self._desc),
            self._widths,
            self.layout.num_lanes,
            words.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(words.size),
        )
        return out


for _name in BINOP_NAMES:
    def _mk(name):
        def op(self, a, b):
            return self._binop(name, a, b)
        op.__name__ = name
        return op
    setattr(NativeOps, _name, _mk(_name))

for _name in SHIFT_NAMES:
    def _mks(name):
        def op(self, v, amount):
            return self._shift(name, v, amount)
        op.__name__ = name
        return op
    setattr(NativeOps, _name, _mks(_name))
