"""msgpack manifest + raw-buffer checkpoints (port of
`repro/ckpt/checkpoint.py`), readable and writable by both packages.

Layout: <dir>/<step>/manifest.msgpack  ({"step", "arrays": [{"name",
        "shape", "dtype", "nbytes"}, ...]})
        <dir>/<step>/arrays.bin        (concatenated C-order buffers)

Atomic via a ``.tmp-<step>`` directory and a rename; keeps the newest
``keep`` checkpoints and sweeps stale ``.tmp-*`` directories left behind by
crashed saves. Restore is strict: the manifest must describe exactly the
leaves of ``like`` (count, shape, dtype) and every buffer must be read in
full; a truncated or mismatched checkpoint raises instead of handing back
partial state.

The port imports no ``msgpack``: `packb` / `unpackb` below encode the
manifest's subset of it (maps, arrays, str, non-negative ints up to
uint64, nil) with the bytes ``msgpack.packb`` gives. Trees flatten as JAX
flattens them: dicts in sorted key order, lists and tuples by index,
NamedTuples by field, None as no leaf; a leaf is named by its path, as
the reference's ``_paths`` names it (a dict key, an index, or ``.field``,
joined by ``/``). Leaves may be torch tensors on any device (copied to the
host) or numpy arrays. A bfloat16 leaf is written as its raw 2-byte words
under the dtype string ``"bfloat16"`` and read back as ``torch.bfloat16``.
Restored leaves come back as tensors on the device of the ``like`` leaf
they replace (numpy arrays for numpy ``like`` leaves).
"""
from __future__ import annotations

import os
import shutil
import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_TORCH_DTYPES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.uint16: "uint16",
    torch.uint32: "uint32", torch.uint64: "uint64", torch.bool: "bool",
}


# ======================================================== msgpack subset
def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        raise TypeError("bool is outside the manifest's msgpack subset")
    elif isinstance(obj, int):
        if obj < 0:
            raise ValueError(f"negative int {obj} is outside the manifest's "
                             "msgpack subset")
        if obj < 0x80:
            out.append(obj)
        elif obj <= 0xFF:
            out += b"\xcc" + struct.pack(">B", obj)
        elif obj <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", obj)
        elif obj <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", obj)
        elif obj <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + struct.pack(">Q", obj)
        else:
            raise OverflowError(f"int {obj} does not fit in uint64")
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += b"\xd9" + struct.pack(">B", n)
        elif n <= 0xFFFF:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n <= 0xFFFF:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n <= 0xFFFF:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"{type(obj).__name__} is outside the manifest's "
                        "msgpack subset")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for maps, arrays (lists, tuples), str,
    non-negative ints up to uint64 and None."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    if i >= len(buf):
        raise ValueError("truncated msgpack data")
    b = buf[i]
    i += 1

    def fixed(fmt):
        size = struct.calcsize(fmt)
        if i + size > len(buf):
            raise ValueError("truncated msgpack data")
        return struct.unpack_from(fmt, buf, i)[0], i + size

    def text(n, at):
        if at + n > len(buf):
            raise ValueError("truncated msgpack data")
        return buf[at:at + n].decode("utf-8"), at + n

    def items(n, at):
        out = []
        for _ in range(n):
            v, at = _unpack(buf, at)
            out.append(v)
        return out, at

    def pairs(n, at):
        out = {}
        for _ in range(n):
            k, at = _unpack(buf, at)
            v, at = _unpack(buf, at)
            out[k] = v
        return out, at

    if b < 0x80:
        return b, i
    if b == 0xC0:
        return None, i
    if b in _UINT:
        return fixed(_UINT[b])
    if 0xA0 <= b <= 0xBF:
        return text(b & 0x1F, i)
    if b in _STR:
        n, i = fixed(_STR[b])
        return text(n, i)
    if 0x90 <= b <= 0x9F:
        return items(b & 0x0F, i)
    if b in _ARRAY:
        n, i = fixed(_ARRAY[b])
        return items(n, i)
    if 0x80 <= b <= 0x8F:
        return pairs(b & 0x0F, i)
    if b in _MAP:
        n, i = fixed(_MAP[b])
        return pairs(n, i)
    raise ValueError(f"msgpack type byte {b:#04x} is outside the manifest's "
                     "subset")


def unpackb(buf: bytes):
    """``msgpack.unpackb(buf)`` for what `packb` writes."""
    obj, end = _unpack(bytes(buf), 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} bytes of trailing msgpack data")
    return obj


# ================================================================== trees
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in items:
        out.extend(_flatten_with_paths(sub, prefix + (name,)))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in `_flatten_with_paths` order."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _TORCH_DTYPES[leaf.dtype]
    dt = getattr(leaf, "dtype", None)
    return str(np.dtype(dt) if dt is not None else np.asarray(leaf).dtype)


def _shape(leaf) -> tuple:
    return tuple(int(d) for d in (leaf.shape if isinstance(leaf, torch.Tensor)
                                  else np.shape(leaf)))


def _host_buffer(leaf):
    """(C-order bytes-like, dtype name, shape) of a leaf, on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = _TORCH_DTYPES[t.dtype]
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return memoryview(words.numpy()).cast("B"), name, tuple(t.shape)
    arr = np.ascontiguousarray(np.asarray(leaf))
    return memoryview(arr.reshape(-1).view(np.uint8)), str(arr.dtype), \
        arr.shape


def _from_buffer(buf: bytearray, like, shape):
    if isinstance(like, torch.Tensor):
        t = (torch.frombuffer(buf, dtype=like.dtype) if len(buf)
             else torch.empty(0, dtype=like.dtype))
        return t.reshape(shape).to(like.device)
    return np.frombuffer(buf, dtype=np.asarray(like).dtype).reshape(shape)


# ============================================================== save/load
def save(directory: str, step: int, tree, keep: int = 3) -> str:
    tmp = os.path.join(directory, f".tmp-{step}")
    final = os.path.join(directory, str(step))
    if os.path.isdir(tmp):          # leftover from a crashed save of this step
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = []
    with open(os.path.join(tmp, "arrays.bin"), "wb") as f:
        for path, leaf in _flatten_with_paths(tree):
            buf, dtype, shape = _host_buffer(leaf)
            manifest.append({"name": "/".join(path),
                             "shape": [int(d) for d in shape],
                             "dtype": dtype, "nbytes": int(buf.nbytes)})
            f.write(buf)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb({"step": int(step), "arrays": manifest}))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def restore(directory: str, like, step: Optional[int] = None):
    """(the tree of ``like`` with the checkpoint's leaves, step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, str(step))
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    leaves = [leaf for _, leaf in _flatten_with_paths(like)]
    metas = manifest["arrays"]
    if len(metas) != len(leaves):
        raise ValueError(
            f"checkpoint step {step} holds {len(metas)} arrays but the "
            f"restore target has {len(leaves)} leaves — treedef mismatch "
            f"(zip would silently truncate)")
    out = []
    with open(os.path.join(path, "arrays.bin"), "rb") as f:
        for meta, leaf in zip(metas, leaves):
            buf = bytearray(meta["nbytes"])
            got = f.readinto(buf)
            if got != meta["nbytes"]:
                raise ValueError(
                    f"truncated checkpoint: {meta['name']} expected "
                    f"{meta['nbytes']} bytes, got {got}")
            want_dtype = _dtype_name(leaf)
            if meta["dtype"] != want_dtype:
                raise ValueError(
                    f"dtype mismatch for {meta['name']}: checkpoint holds "
                    f"{meta['dtype']}, restore target expects {want_dtype}")
            shape = tuple(meta["shape"])
            if int(np.prod(shape, dtype=np.int64)) * _itemsize(leaf) \
                    != meta["nbytes"]:
                raise ValueError(
                    f"{meta['name']}: {meta['nbytes']} bytes do not hold a "
                    f"{meta['dtype']} array of shape {shape}")
            if shape != _shape(leaf):
                raise ValueError(
                    f"shape mismatch for {meta['name']}: checkpoint holds "
                    f"{shape}, restore target expects {_shape(leaf)}")
            out.append(_from_buffer(buf, leaf, shape))
    return _unflatten(like, iter(out)), step


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.asarray(leaf).dtype.itemsize


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None


def _gc(directory: str, keep: int):
    steps = sorted(int(d) for d in os.listdir(directory) if d.isdigit())
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, str(s)), ignore_errors=True)
    for d in os.listdir(directory):     # crashed saves leak .tmp-<step> dirs
        if d.startswith(".tmp-"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
