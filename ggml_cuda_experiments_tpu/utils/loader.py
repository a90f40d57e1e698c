"""Checkpoint container + sharded-weight loader.

A GGUF-like single-file container ("GCTC") holding every tensor of a
(possibly quantized) param tree, mmap-read so loading is I/O-bound — the
sharded-weight-loader subsystem BASELINE.json names (the reference only has
the single-tensor dump reader, /root/reference/src/utils.h:104-150, which
``utils/tensor_io.py`` reproduces wire-compatibly).

Layout: little-endian
    magic "GCTC" | u32 version | u32 n_tensors | u64 data_offset
    n_tensors x { u16 name_len | name | u8 dtype | u8 ndim | u32 ne[ndim]
                  | u64 offset | u64 nbytes }
    ...data blobs (64-byte aligned)...

QuantLinear leaves flatten to one tensor per field with the quant metadata
encoded in the name (``<path>#q4_k#<N>x<K>#qs``), so the container needs no
side manifest. Loading with a mesh device_puts each leaf with its
tensor-parallel NamedSharding (each process touches only the bytes of its
shard thanks to mmap laziness).
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Any

import jax
import ml_dtypes
import numpy as np

from ggml_cuda_experiments_tpu.ops.quant_matmul import QuantLinear

_MAGIC = b"GCTC"
# Format history (load_container fails with a clear message on any other
# version — readers must not guess):
#   v2: q4 qs planes use the signed-friendly int8 packing; quantized
#       tensor names are "<path>#<fmt>[+<layout>]#NxK#<field>"
#   v3: q4_k gains the "s6" streaming scale encoding (name token
#       "q4_k~s6[+<layout>]", extra "d" field holding bf16 d|dmin)
#   v4: q6_k "qh" planes re-packed as two signed-friendly nibbles
#       (h0+4h1 | (h2+4h3)^8 per byte — quant_matmul.from_oracle) instead
#       of the 4x2-bit bitfield; same shape, different bit meaning, so
#       pre-v4 containers holding q6_k tensors are REJECTED on read
#       (re-quantize from the source weights); v2/v3 content without
#       q6_k reads unchanged
#   v5: q6_k lane order becomes SEGMENT-LOCAL for K % 4096 == 0
#       (quant_matmul._perm_q6 / _q6_seg — the hybrid int8-dot kernel's
#       layout); same shapes, different element order, so pre-v5
#       containers holding q6_k tensors with K % 4096 == 0 are REJECTED
#       on read; everything else reads unchanged
_VERSION = 5
_DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.float16),
           2: np.dtype(ml_dtypes.bfloat16), 3: np.dtype(np.int8),
           4: np.dtype(np.uint8), 5: np.dtype(np.int32)}
_CODES = {v: k for k, v in _DTYPES.items()}
_ALIGN = 64

_QFIELDS = ("qs", "d", "es", "em", "qh")


# ---------------------------------------------------------------------------
# container read/write
# ---------------------------------------------------------------------------

def save_container(path, tensors: dict[str, np.ndarray]) -> None:
    entries = []
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        code = _CODES[np.dtype(arr.dtype)]
        offset = -(-offset // _ALIGN) * _ALIGN
        entries.append((name.encode(), code, arr.shape, offset, arr.nbytes))
        blobs.append((offset, arr))
        offset += arr.nbytes

    header = bytearray()
    header += _MAGIC + struct.pack("<II", _VERSION, len(entries))
    body = bytearray()
    for name_b, code, shape, off, nbytes in entries:
        body += struct.pack("<H", len(name_b)) + name_b
        body += struct.pack("<BB", code, len(shape))
        body += struct.pack(f"<{len(shape)}I", *shape)
        body += struct.pack("<QQ", off, nbytes)
    data_offset = len(header) + 8 + len(body)
    data_offset = -(-data_offset // _ALIGN) * _ALIGN
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<Q", data_offset))
        f.write(body)
        f.write(b"\0" * (data_offset - len(header) - 8 - len(body)))
        for off, arr in blobs:
            f.seek(data_offset + off)
            f.write(arr.tobytes())


def load_container(path, lazy: bool = True) -> dict[str, np.ndarray]:
    """Read a container; with ``lazy`` the arrays are mmap-backed views."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(12)
        assert head[:4] == _MAGIC, f"{path} is not a GCTC container"
        version, n = struct.unpack("<II", head[4:12])
        # v5 reads v2-v4 content unchanged EXCEPT q6_k (qh bit meaning
        # changed in v4, lane order for K%4096==0 in v5 — history above)
        assert version in (2, 3, 4, _VERSION), f"unsupported version {version}"
        (data_offset,) = struct.unpack("<Q", f.read(8))
        entries = []
        for _ in range(n):
            (nl,) = struct.unpack("<H", f.read(2))
            name = f.read(nl).decode()
            code, ndim = struct.unpack("<BB", f.read(2))
            shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim))
            off, nbytes = struct.unpack("<QQ", f.read(16))
            entries.append((name, code, shape, off, nbytes))
        if version < _VERSION and any(
                "#q6_k" in name for name, *_ in entries):
            raise ValueError(
                f"{path} is a v{version} container holding q6_k tensors; "
                "the q6_k qh packing changed in v4 (same shape, different "
                "bit meaning) — re-quantize from the source weights")

    if lazy:
        buf = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        buf = np.fromfile(path, dtype=np.uint8)
    out = {}
    for name, code, shape, off, nbytes in entries:
        dt = _DTYPES[code]
        start = data_offset + off
        out[name] = buf[start:start + nbytes].view(dt).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# param tree <-> flat tensors
# ---------------------------------------------------------------------------

def _flatten(prefix: str, node, out: dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for key, sub in node.items():
            _flatten(f"{prefix}.{key}" if prefix else key, sub, out)
    elif isinstance(node, (list, tuple)):
        for i, sub in enumerate(node):
            _flatten(f"{prefix}.{i}", sub, out)
    elif isinstance(node, QuantLinear):
        n, k = node.shape
        fmt = node.fmt
        if getattr(node, "enc", "e") not in ("e", ""):
            fmt = f"{fmt}~{node.enc}"
        base = f"{prefix}#{fmt}#{n}x{k}"
        for f in _QFIELDS:
            a = getattr(node, f)
            if a is not None:
                out[f"{base}#{f}"] = np.asarray(a)
    elif node is None:
        pass
    else:
        out[prefix] = np.asarray(node)


def save_params(path, params: dict[str, Any]) -> None:
    flat: dict[str, np.ndarray] = {}
    _flatten("", params, flat)
    save_container(path, flat)


def _set_path(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for i, p in enumerate(parts[:-1]):
        nxt = parts[i + 1]
        if p.isdigit():
            p = int(p)
            while len(node) <= p:
                node.append({})
            if not isinstance(node[p], (dict, list)):
                node[p] = [] if nxt.isdigit() else {}
            node = node[p]
        else:
            default = [] if nxt.isdigit() else {}
            node = node.setdefault(p, default)
    last = parts[-1]
    if last.isdigit():
        last = int(last)
        while len(node) <= last:
            node.append(None)
        node[last] = value
    else:
        node[last] = value


def load_params(path, mesh=None, lazy: bool = True) -> dict[str, Any]:
    """Rebuild a param tree; with ``mesh``, leaves are device_put with the
    tensor-parallel NamedShardings from parallel/tp.py."""
    flat = load_container(path, lazy=lazy)

    # group quantized fields
    tree: dict[str, Any] = {}
    quants: dict[str, dict] = {}
    for name, arr in flat.items():
        if "#" in name:
            prefix, fmt, shape_s, field = name.split("#")
            fmt, _, layout = fmt.partition("+")
            if layout not in ("", "std"):
                raise ValueError(f"{name}: column layout {layout!r} is not "
                                 "supported (re-export the weights)")
            fmt, _, enc = fmt.partition("~")
            q = quants.setdefault(prefix, {
                "fmt": fmt, "enc": enc or "e",
                "shape": tuple(int(v) for v in shape_s.split("x"))})
            q[field] = arr
        else:
            _set_path(tree, name, jax.numpy.asarray(arr))
    import jax.numpy as jnp
    for prefix, q in quants.items():
        ql = QuantLinear(
            fmt=q["fmt"], shape=q["shape"], enc=q.get("enc", "e"),
            qs=jnp.asarray(q["qs"]),
            d=jnp.asarray(q["d"]) if "d" in q else None,
            es=jnp.asarray(q["es"]) if "es" in q else None,
            em=jnp.asarray(q["em"]) if "em" in q else None,
            qh=jnp.asarray(q["qh"]) if "qh" in q else None,
        )
        _set_path(tree, prefix, ql)

    if mesh is not None:
        from ggml_cuda_experiments_tpu.parallel import tp
        tree = tp.shard_params(tree, mesh)
    return tree
