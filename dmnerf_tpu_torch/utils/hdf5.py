"""A reader and a writer of one-dataset HDF5 files, in NumPy and the standard library.

The datasets keep their instance palette in ``ins_rgb.hdf5`` (dataset ``datasets``), and
the port must read and write it on hosts without h5py. This module covers the files
h5py writes by default (``h5py.File(path, "w").create_dataset(name, data=a)``):
superblock version 0, 8-byte offsets and lengths, version-1 object headers, a root group
indexed by a version-1 B-tree of symbol table nodes, and a dataset of fixed-point or IEEE
floating-point numbers in a compact or contiguous layout (layout message version 3).
Anything else (a newer superblock, chunked or filtered storage, compound types) raises
ValueError naming what was found. ``write_dataset`` writes the same structure as h5py, one dataset
at the root; h5py reads it back (``tests/test_torch_e2e_cycle.py``).
"""

from __future__ import annotations

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _INTERNAL_K = 4, 16        # h5py's defaults: symbols a node / 2, B-tree keys / 2
_FREE_NULL = 1                      # the local heap's end of its free list
# object header message types
_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _FILTERS, _SYMBOLS = 1, 3, 5, 8, 11, 17


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _File:
    def __init__(self, data: bytes, path: str):
        self.b, self.path = data, path

    def u(self, off: int, size: int) -> int:
        return int.from_bytes(self.b[off:off + size], "little")

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what} (the port's HDF5 reader reads one-dataset "
                         "files as h5py writes them by default)")

    def messages(self, addr: int) -> dict:
        """{type: data} of the messages of the version-1 object header at ``addr``."""
        if self.b[addr] != 1:
            self.fail(f"object header version {self.b[addr]} at {addr}")
        out, off = {}, addr + 16
        end = off + self.u(addr + 8, 4)
        while off + 8 <= end:
            mtype, msize = self.u(off, 2), self.u(off + 2, 2)
            out[mtype] = self.b[off + 8:off + 8 + msize]
            off += 8 + msize
        return out

    def symbols(self, btree: int, heap: int):
        """{name: object header address} of a group's B-tree and local heap."""
        if self.b[heap:heap + 4] != b"HEAP":
            self.fail(f"no local heap at {heap}")
        heap_data = self.u(heap + 24, 8)
        out = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop()
            if self.b[node:node + 4] != b"TREE" or self.b[node + 4] != 0:
                self.fail(f"no group B-tree node at {node}")
            level, used = self.b[node + 5], self.u(node + 6, 2)
            children = [self.u(node + 24 + 8 + 16 * i, 8) for i in range(used)]
            if level > 0:
                nodes.extend(children)
                continue
            for snod in children:
                if self.b[snod:snod + 4] != b"SNOD":
                    self.fail(f"no symbol table node at {snod}")
                for i in range(self.u(snod + 6, 2)):
                    entry = snod + 8 + 40 * i
                    name_at = heap_data + self.u(entry, 8)
                    name = self.b[name_at:self.b.index(b"\0", name_at)].decode()
                    out[name] = self.u(entry + 8, 8)
        return out


def _dtype(f: _File, body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits, size = body[1], int.from_bytes(body[4:8], "little")
    order = ">" if bits & 1 else "<"
    if cls == 0 and size in (1, 2, 4, 8):
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (2, 4, 8):
        return np.dtype(f"{order}f{size}")
    f.fail(f"datatype class {cls} (version {version}) of {size} bytes")


def _layout(f: _File, body: bytes):
    """The address of contiguous data, or the bytes of compact data."""
    if body[0] != 3:
        f.fail(f"layout message version {body[0]}")
    if body[1] == 0:
        return body[4:4 + int.from_bytes(body[2:4], "little")]
    if body[1] == 1:
        return int.from_bytes(body[2:10], "little")
    f.fail(f"storage layout class {body[1]} (chunked or virtual)")


def read_dataset(path: str, name: str) -> np.ndarray:
    """The array of the dataset ``name`` at the root of the HDF5 file ``path``."""
    with open(path, "rb") as fh:
        f = _File(fh.read(), path)
    if f.b[:8] != _SIGNATURE:
        f.fail("no HDF5 signature")
    if f.b[8] != 0:
        f.fail(f"superblock version {f.b[8]}")
    if f.b[13] != 8 or f.b[14] != 8 or f.u(24, 8) != 0:
        f.fail(f"offsets of {f.b[13]} and lengths of {f.b[14]} bytes, base {f.u(24, 8)}")
    # the root group's symbol table entry, its B-tree and heap cached in its scratch pad
    if f.u(56 + 16, 4) != 1:
        f.fail("a root group entry without its symbol table cached")
    objects = f.symbols(f.u(56 + 24, 8), f.u(56 + 32, 8))
    if name not in objects:
        raise KeyError(f"{path}: no dataset {name!r} at the root (found {sorted(objects)})")
    msgs = f.messages(objects[name])
    if _FILTERS in msgs:
        f.fail(f"a filter pipeline on {name!r}")
    if _DATASPACE not in msgs or _DATATYPE not in msgs or _LAYOUT not in msgs:
        f.fail(f"{name!r} is not a dataset")
    space = msgs[_DATASPACE]
    if space[0] != 1:
        f.fail(f"dataspace message version {space[0]}")
    shape = tuple(int.from_bytes(space[8 + 8 * i:16 + 8 * i], "little") for i in range(space[1]))
    dtype = _dtype(f, msgs[_DATATYPE])
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    where = _layout(f, msgs[_LAYOUT])
    if isinstance(where, bytes):
        raw = where[:nbytes]
    elif where == _UNDEF:                                # never written: the fill value, 0
        raw = bytes(nbytes)
    else:
        raw = f.b[where:where + nbytes]
    if len(raw) != nbytes:
        f.fail(f"{name!r} holds {len(raw)} of its {nbytes} bytes")
    return np.frombuffer(raw, dtype).reshape(shape).astype(dtype.newbyteorder("="))


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + bytes(_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: bytes, n: int) -> bytes:
    return struct.pack("<BBHII4x", 1, 0, n, 1, len(messages)) + messages


def write_dataset(path: str, name: str, data) -> None:
    """Writes a new HDF5 file ``path`` holding ``data`` (a NumPy array of integers or
    floats) as the dataset ``name`` at its root, contiguous, as h5py writes it."""
    a = np.ascontiguousarray(data)
    if a.dtype.kind not in "uif" or a.dtype.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"write_dataset takes integer or float arrays, got {a.dtype}")
    a = a.astype(a.dtype.newbyteorder("<"))
    name_b = name.encode() + b"\0"

    # addresses: superblock, root header, B-tree, heap (+ its data), dataset header,
    # symbol table node, data
    root_at = 96
    root_hdr_len = 16 + 8 + 16
    btree_at = root_at + root_hdr_len
    btree_len = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
    heap_at = btree_at + btree_len
    heap_data_len = 8 + _pad8(len(name_b)) + 16          # "", the name, one free block
    dset_at = heap_at + 32 + heap_data_len

    dims = b"".join(struct.pack("<Q", d) for d in a.shape)
    space = struct.pack("<BBBB4x", 1, a.ndim, 1, 0) + dims + dims
    if a.dtype.kind == "f":
        exp_bits, mant_bits = {2: (5, 10), 4: (8, 23), 8: (11, 52)}[a.dtype.itemsize]
        bits = 8 * a.dtype.itemsize
        dtype = struct.pack("<B3BI", 0x11, 0x20, bits - 1, 0, a.dtype.itemsize) + struct.pack(
            "<HHBBBBI", 0, bits, mant_bits, exp_bits, 0, mant_bits, (1 << (exp_bits - 1)) - 1)
    else:
        dtype = struct.pack("<B3BI", 0x10, 0x08 if a.dtype.kind == "i" else 0, 0, 0,
                            a.dtype.itemsize) + struct.pack("<HH", 0, 8 * a.dtype.itemsize)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    dset_msgs_wo_layout = (_message(_DATASPACE, space) + _message(_DATATYPE, dtype, 1)
                           + _message(_FILL, fill, 1))
    dset_len = 16 + len(dset_msgs_wo_layout) + 8 + 24
    snod_at = dset_at + dset_len
    snod_len = 8 + 2 * _LEAF_K * 40
    data_at = _pad8(snod_at + snod_len)
    eof = data_at + a.nbytes

    sb = (_SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _INTERNAL_K, 0)
          + struct.pack("<4Q", 0, _UNDEF, eof, _UNDEF)
          + struct.pack("<QQI4xQQ", 0, root_at, 1, btree_at, heap_at))
    root = _object_header(_message(_SYMBOLS, struct.pack("<QQ", btree_at, heap_at)), 1)
    btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
             + struct.pack("<QQQ", 0, snod_at, 8))
    btree += bytes(btree_len - len(btree))
    free_at = 8 + _pad8(len(name_b))
    heap = (b"HEAP" + struct.pack("<B3xQQQ", 0, heap_data_len, free_at, heap_at + 32)
            + bytes(8) + name_b + bytes(_pad8(len(name_b)) - len(name_b))
            + struct.pack("<QQ", _FREE_NULL, 16))
    layout = struct.pack("<BBQQ", 3, 1, data_at, a.nbytes)
    dset = _object_header(dset_msgs_wo_layout + _message(_LAYOUT, layout), 4)
    snod = b"SNOD" + struct.pack("<BBH", 1, 0, 1) + struct.pack("<QQI4x16x", 8, dset_at, 0)
    snod += bytes(snod_len - len(snod))
    out = sb + root + btree + heap + dset + snod
    assert len(sb) == root_at and len(out) == snod_at + snod_len, (len(sb), len(out))
    with open(path, "wb") as fh:
        fh.write(out + bytes(data_at - len(out)) + a.tobytes())
