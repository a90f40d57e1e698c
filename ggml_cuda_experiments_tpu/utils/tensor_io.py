"""Binary tensor I/O: the `.tensor` golden-file format, plus save support.

Wire-compatible with the reference's ``load_tensor_from_file``
(/root/reference/src/utils.h:110-150): little-endian

    int32 n_dims | int32 dtype (0=f32, 1=f16) | int32 ne[n_dims]
    | int32 name_len | name bytes | raw data

so golden tensors dumped from llama.cpp (as the reference does in
/root/reference/src/flash-matrix.cu:69-73) can be loaded directly. We add the
writer (the reference has none), a bf16 code (2) for bf16 device dumps, and
int8 (3) for quantized payloads.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import ml_dtypes

_DTYPES = {0: np.float32, 1: np.float16, 2: ml_dtypes.bfloat16, 3: np.int8}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_tensor(path, arr: np.ndarray, name: str = "") -> None:
    arr = np.ascontiguousarray(arr)
    code = _CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}; use f32/f16/bf16/int8")
    name_b = name.encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", arr.ndim, code))
        f.write(struct.pack(f"<{arr.ndim}i", *arr.shape))
        f.write(struct.pack("<i", len(name_b)))
        f.write(name_b)
        f.write(arr.tobytes())


def load_tensor(path) -> tuple[np.ndarray, str]:
    """Load a `.tensor` file; returns (array, name)."""
    data = Path(path).read_bytes()
    off = 0
    n_dims, code = struct.unpack_from("<ii", data, off); off += 8
    if not (0 < n_dims <= 4):
        raise ValueError(f"bad n_dims {n_dims} in {path}")
    ne = struct.unpack_from(f"<{n_dims}i", data, off); off += 4 * n_dims
    (name_len,) = struct.unpack_from("<i", data, off); off += 4
    name = data[off:off + name_len].decode(errors="replace"); off += name_len
    dtype = _DTYPES[code]
    arr = np.frombuffer(data, dtype=dtype, offset=off,
                        count=int(np.prod(ne))).reshape(ne)
    return arr.copy(), name
