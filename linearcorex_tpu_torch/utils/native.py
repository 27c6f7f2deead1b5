"""ctypes bindings for the port's host-side C++ library.

`csrc/gaussianize.cpp` holds the two host kernels of the preprocessing
layer (empirical gaussianization with average-tie ranks and the AS241
inverse normal; sentinel mean-imputation) and `csrc/loader.cpp` the
streaming CSV block reader, each behind a plain C interface. They are the
port's own copies of the repo's `native/*.cpp` (a test holds the copies
byte-identical). `csrc/seeded_normal.cpp` is the port's own, with no
copy under `native/`: NumPy's legacy seeded normal stream bit for bit on
the host's threads (`lcx_seeded_normal`, called by `ops.seeded`).
`utils.build.build_host` compiles the three with g++ at first use into
`linearcorex_tpu_torch/_build/`; the library under `native/` is never
loaded and `make -C native` is never run.

Without g++ `available()` is False and callers take the torch, NumPy or
pure-Python paths, whose results are the same (held to double precision
by `tests/test_torch_native.py`, bitwise for the seeded draws by
`tests/test_torch_seeded_normal.py`). A g++ that is there and fails to
build the sources raises instead: a broken build is not taken for a
missing compiler. This is host code only: it never stands in for the
device or for a kernel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from linearcorex_tpu_torch.utils import build

_lib = None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the host library, or None when the
    machine has no g++. A g++ that fails on the sources, or a built
    library that does not load, raises with the compiler's log: only a
    missing compiler sends callers to the torch and pure-Python paths."""
    global _lib
    if _lib is not None:
        return _lib
    if build.find_cxx() is None:
        return None
    lib = ctypes.CDLL(build.build_host()["path"])
    i64, dp = ctypes.c_int64, ctypes.POINTER(ctypes.c_double)
    lib.lcx_empirical_gaussianize.argtypes = [dp, dp, i64, i64]
    lib.lcx_mean_impute.argtypes = [dp, i64, i64, ctypes.c_double]
    lib.lcx_mean_impute_nan.argtypes = [dp, i64, i64]
    lib.lcx_ndtri.argtypes = [dp, dp, i64]
    for void in (lib.lcx_empirical_gaussianize, lib.lcx_mean_impute,
                 lib.lcx_mean_impute_nan, lib.lcx_ndtri, lib.lcx_csv_close):
        void.restype = None
    lib.lcx_csv_open.argtypes = [ctypes.c_char_p, ctypes.c_char, i64]
    lib.lcx_csv_open.restype = ctypes.c_void_p
    lib.lcx_csv_cols.argtypes = [ctypes.c_void_p]
    lib.lcx_csv_cols.restype = i64
    lib.lcx_csv_read_block.argtypes = [ctypes.c_void_p, i64, dp]
    lib.lcx_csv_read_block.restype = i64
    lib.lcx_csv_close.argtypes = [ctypes.c_void_p]
    lib.lcx_seeded_normal.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_void_p, i64]
    lib.lcx_seeded_normal.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def empirical_gaussianize(x: np.ndarray) -> np.ndarray:
    """Column-wise rank-gaussianize (native): norm.ppf((rank-0.5)/n)."""
    lib = _require_lib()
    x = np.ascontiguousarray(x, dtype=np.float64)
    out = np.empty_like(x)
    n, p = x.shape
    lib.lcx_empirical_gaussianize(_as_c(x), _as_c(out), n, p)
    return out


def mean_impute(x: np.ndarray, sentinel: float) -> np.ndarray:
    """Replace sentinel entries by per-column observed means (native).
    A NaN sentinel dispatches to the isnan variant."""
    lib = _require_lib()
    out = np.ascontiguousarray(x, dtype=np.float64).copy()
    n, p = out.shape
    if isinstance(sentinel, float) and np.isnan(sentinel):
        lib.lcx_mean_impute_nan(_as_c(out), n, p)
    else:
        lib.lcx_mean_impute(_as_c(out), n, p, sentinel)
    return out


def ndtri(p: np.ndarray) -> np.ndarray:
    lib = _require_lib()
    p = np.ascontiguousarray(p, dtype=np.float64)
    out = np.empty_like(p)
    lib.lcx_ndtri(_as_c(p), _as_c(out), p.size)
    return out


class CsvReader:
    """Streaming block reader over a delimited numeric text file
    (`csrc/loader.cpp`): a single buffered pass, `std::from_chars`
    parsing, blocks landing in preallocated float64 NumPy buffers, O(block)
    memory instead of the whole file. Iterate to get (block_rows, cols)
    arrays; the last block may be shorter.

    Raises RuntimeError when the host library is unavailable: callers that
    want the pure-Python reader instead use `utils.streaming.
    iter_text_blocks`, which comes here when it can.
    """

    def __init__(self, path: str, block_rows: int = 8192,
                 delimiter: str = ",", skip_header: int = 0):
        lib = _require_lib()
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        self._lib = lib
        self._h = lib.lcx_csv_open(os.fsencode(path),
                                   delimiter.encode()[:1], skip_header)
        if not self._h:
            raise FileNotFoundError(path)
        self.cols = int(lib.lcx_csv_cols(self._h))
        if self.cols <= 0:
            self.close()
            raise ValueError(f"{path}: no parsable numeric rows")
        self.block_rows = block_rows

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is None:
            raise StopIteration
        out = np.empty((self.block_rows, self.cols), np.float64)
        got = self._lib.lcx_csv_read_block(self._h, self.block_rows,
                                           _as_c(out))
        if got < 0:
            self.close()
            raise ValueError("unparsable numeric row in input")
        if got == 0:
            self.close()
            raise StopIteration
        return out[:got]

    def close(self):
        if self._h is not None:
            self._lib.lcx_csv_close(self._h)
            self._h = None

    def __del__(self):
        # abandoned iteration (break / consumer exception) must not leak
        # the native FILE* and its 1 MB reader for the process lifetime
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
