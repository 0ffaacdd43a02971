"""netCDF-4 (HDF5) file IO in numpy and the standard library alone.

netCDF-4 files are HDF5 files.  :class:`File` reads the parts of the HDF5
format that h5py's defaults and the netCDF-C library write (HDF5 1.8
file-format bounds, creation order tracked, and ``libver="latest"``):

* superblocks v0-v3; object headers v1 and v2 with continuation blocks;
* groups: symbol tables (v1 B-tree, SNOD, local heap), compact link
  messages, dense links (link info, fractal heap, v2 B-tree);
* attributes: compact and dense (attribute info, fractal heap, v2 B-tree);
* datatypes: fixed-point and floating point in either byte order,
  fixed-length and variable-length strings (the global heap); object
  references and compounds far enough to skip the dimension-scale
  attributes ``DIMENSION_LIST`` / ``REFERENCE_LIST``;
* dataspaces: scalar, simple and null;
* layouts: compact, contiguous, chunked v3 (v1 B-tree) and v4 (single
  chunk, implicit and fixed-array indexes); the deflate, shuffle and
  fletcher32 filters; fill values, and storage never allocated read as
  the fill value;
* hyperslabs of ints and slices read only the bytes they select
  (``np.memmap`` of contiguous data, the intersecting chunks of chunked
  data).

Anything else (extensible-array or v2-B-tree chunk indexes, szip or other
filters, external storage, virtual datasets, shared messages, soft and
external links, huge fractal-heap objects, other datatypes, netCDF-3
files) raises
``NotImplementedError`` naming the feature and the file: the reader never
returns data it cannot decode.  Checksums are not verified.

:class:`FileWriter` writes what h5py's defaults write for the calls of
``ncio.Writer`` and the segment combiner: superblock v0, a symbol-table
root group, v1 object headers, contiguous datasets (a dataset defined
without data gets no storage and reads back as its fill value),
attributes of numbers, fixed-length byte strings and variable-length
UTF-8 strings, and dimension scales (``CLASS``, ``NAME``,
``REFERENCE_LIST``, ``DIMENSION_LIST``).  Variable data goes to the file
when it is given; the metadata is laid out at :meth:`FileWriter.close`.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# Object header message types.
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL, _LINK, _EXTERNAL = 0x04, 0x05, 0x06, 0x07
_LAYOUT, _FILTERS, _ATTRIBUTE = 0x08, 0x0B, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0x10, 0x11, 0x15

_FILTER_DEFLATE, _FILTER_SHUFFLE, _FILTER_FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scale-offset", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                 32015: "zstd"}


def _limit_enc_size(n: int) -> int:
    """Bytes that encode ``n`` (HDF5's H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int) -> int:
    return n.bit_length() - 1


class _Cursor:
    """Little-endian decoding over a bytes object."""

    def __init__(self, data: bytes, pos: int = 0, so: int = 8,
                 sl: int = 8):
        self.data, self.pos, self.so, self.sl = data, pos, so, sl

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated HDF5 structure")
        self.pos += n
        return b

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def u8(self):
        return self.uint(1)

    def u16(self):
        return self.uint(2)

    def u32(self):
        return self.uint(4)

    def addr(self) -> int:
        v = self.uint(self.so)
        return UNDEF if v == (1 << (8 * self.so)) - 1 else v

    def length(self) -> int:
        return self.uint(self.sl)

    def skip(self, n: int):
        self.pos += n

    def align(self, base: int, to: int = 8):
        self.pos = base + -(-(self.pos - base) // to) * to


# ---------------------------------------------------------------- datatypes

class _Type:
    """A decoded datatype: ``size`` in bytes, ``dtype`` (the numpy dtype
    of one stored element) and, for variable-length types, ``vlen``
    ("string" or "sequence") and ``base``."""

    def __init__(self, size, dtype, vlen=None, base=None, charset=0):
        self.size, self.dtype = size, dtype
        self.vlen, self.base, self.charset = vlen, base, charset


def _decode_datatype(c: _Cursor, where) -> _Type:
    b0 = c.u8()
    cls, version = b0 & 0x0F, b0 >> 4
    bits = c.take(3)
    size = c.u32()
    order = ">" if bits[0] & 1 else "<"
    if cls == 0:                                    # fixed-point
        offset, precision = c.u16(), c.u16()
        if offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"{where}: integer datatype of {precision} bits at offset "
                f"{offset} in {size} bytes")
        kind = "i" if bits[0] & 0x08 else "u"
        return _Type(size, np.dtype(f"{order}{kind}{size}"))
    if cls == 1:                                    # floating point
        c.skip(12)
        if bits[0] & 0x40 or size not in (2, 4, 8):
            raise NotImplementedError(
                f"{where}: floating-point datatype of {size} bytes"
                + (" in VAX order" if bits[0] & 0x40 else ""))
        return _Type(size, np.dtype(f"{order}f{size}"))
    if cls == 3:                                    # fixed-length string
        return _Type(size, np.dtype(f"S{size}"),
                     charset=bits[0] >> 4)
    if cls == 6:                                    # compound
        nmemb = bits[0] | bits[1] << 8
        names, formats, offsets = [], [], []
        for _ in range(nmemb):
            start = c.pos
            end = c.data.index(b"\0", c.pos)
            name = c.data[c.pos:end].decode()
            c.pos = end + 1
            if version < 3:
                c.align(start)
                off = c.u32()
                if version == 1:
                    c.skip(1 + 3 + 4 + 4 + 16)      # rank, perm, dims
            else:
                off = c.uint(_limit_enc_size(size))
            member = _decode_datatype(c, where)
            names.append(name)
            formats.append(member.dtype)
            offsets.append(off)
        return _Type(size, np.dtype(dict(
            names=names, formats=formats, offsets=offsets, itemsize=size)))
    if cls == 7:                                    # reference
        if version >= 4:
            raise NotImplementedError(
                f"{where}: HDF5 1.12 reference datatype")
        return _Type(size, np.dtype("<u8") if size == 8
                     else np.dtype(f"V{size}"))
    if cls == 9:                                    # variable-length
        base = _decode_datatype(c, where)
        kind = "string" if bits[0] & 0x0F == 1 else "sequence"
        return _Type(size, np.dtype("V16"), vlen=kind, base=base,
                     charset=bits[1] & 0x0F)
    raise NotImplementedError(f"{where}: datatype class {cls}")


def _decode_dataspace(c: _Cursor, where):
    """The dataspace's shape: () for scalar, None for null."""
    version = c.u8()
    rank = c.u8()
    flags = c.u8()
    if version == 1:
        c.skip(5)
        kind = 1 if rank else 0
    elif version == 2:
        kind = c.u8()
    else:
        raise NotImplementedError(f"{where}: dataspace version {version}")
    dims = tuple(c.length() for _ in range(rank))
    if kind == 2:
        return None
    return dims


# ------------------------------------------------------------------ reader

class File:
    """Read-only view of an HDF5 / netCDF-4 file.  ``f["name"]`` gives a
    :class:`Dataset` or :class:`Group` (``"/"``-separated paths), ``f.attrs``
    the root group's attributes."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._fh = open(self.path, "rb")
        self._gheaps = {}
        try:
            self._open()
        except BaseException:
            self._fh.close()
            raise

    def _open(self):
        head = self._fh.read(8)
        if head[:3] == b"CDF":
            raise NotImplementedError(
                f"{self.path}: netCDF-3 (classic) file")
        size = os.fstat(self._fh.fileno()).st_size
        base = 0
        while head != SIGNATURE:
            base = 512 if base == 0 else 2 * base
            if base >= size:
                raise ValueError(f"{self.path}: not an HDF5 file")
            self._fh.seek(base)
            head = self._fh.read(8)
        sb = self._fh.read(200)
        version = sb[0]
        if version in (0, 1):
            so, sl = sb[5], sb[6]
            pos = 8 + 4 + 4 + (4 if version == 1 else 0)
            c = _Cursor(sb, pos, so, sl)
            self._base = c.addr()
            c.skip(3 * so)                    # free space, EOF, driver
            c.length()                        # root entry: name offset
            root = c.addr()
        elif version in (2, 3):
            so, sl = sb[1], sb[2]
            c = _Cursor(sb, 4, so, sl)
            self._base = c.addr()
            c.skip(2 * so)                    # extension, EOF
            root = c.addr()
        else:
            raise NotImplementedError(
                f"{self.path}: superblock version {version}")
        if self._base == UNDEF or self._base == 0:
            self._base = base
        self.so, self.sl = so, sl
        self._root = Group(self, root, "/")

    # -- raw access
    def _read(self, addr: int, n: int) -> bytes:
        self._fh.seek(self._base + addr)
        b = self._fh.read(n)
        if len(b) != n:
            raise ValueError(f"{self.path}: read past the end of the file "
                             f"at {addr:#x}")
        return b

    def _cursor(self, addr: int, n: int) -> _Cursor:
        return _Cursor(self._read(addr, n), 0, self.so, self.sl)

    def _fail(self, feature: str):
        raise NotImplementedError(
            f"{self.path}: {feature} is not supported by the port's HDF5 "
            "reader")

    # -- object headers
    def _messages(self, addr: int):
        """[(type, flags, body)] of the object header at ``addr``."""
        out = []
        first = self._read(addr, 16)
        if first[:4] == b"OHDR":
            c = self._cursor(addr, 4 + 2 + 16 + 4 + 8)
            c.skip(5)
            flags = c.u8()
            if flags & 0x20:
                c.skip(16)
            if flags & 0x10:
                c.skip(4)
            size = c.uint(1 << (flags & 3))
            blocks = [(addr + c.pos, size, flags)]
            v2 = True
        else:
            if first[0] != 1:
                self._fail(f"object header version {first[0]}")
            size = int.from_bytes(first[8:12], "little")
            blocks = [(addr + 16, size, 0)]
            v2 = False
        while blocks:
            start, size, flags = blocks.pop(0)
            c = self._cursor(start, size)
            hdr = (4 + (2 if flags & 0x04 else 0)) if v2 else 8
            while c.pos + hdr <= size:
                if v2:
                    mtype, msize, mflags = c.u8(), c.u16(), c.u8()
                    if flags & 0x04:
                        c.skip(2)
                else:
                    mtype, msize, mflags = c.u16(), c.u16(), c.u8()
                    c.skip(3)
                body = c.take(msize)
                if mtype == _CONTINUATION:
                    bc = _Cursor(body, 0, self.so, self.sl)
                    caddr, clen = bc.addr(), bc.length()
                    if v2:     # "OCHK" ... checksum
                        blocks.append((caddr + 4, clen - 8, flags))
                    else:
                        blocks.append((caddr, clen, 0))
                    continue
                if mtype == _NIL:
                    continue
                if mflags & 0x02:
                    self._fail(f"shared object header message (type "
                               f"{mtype:#x})")
                out.append((mtype, body))
        return out

    # -- heaps
    def _global_heap_object(self, addr: int, index: int) -> bytes:
        if addr not in self._gheaps:
            c = self._cursor(addr, 16)
            if c.take(4) != b"GCOL":
                raise ValueError(f"{self.path}: bad global heap at "
                                 f"{addr:#x}")
            c.skip(4)
            size = c.length()
            c = self._cursor(addr, size)
            c.pos = 16
            objs = {}
            while c.pos + 8 + self.sl <= size:
                idx = c.u16()
                c.skip(6)
                n = c.length()
                if idx == 0:
                    break
                objs[idx] = c.data[c.pos:c.pos + n]
                c.pos += -(-n // 8) * 8
            self._gheaps[addr] = objs
        return self._gheaps[addr][index]

    def _local_heap(self, addr: int) -> bytes:
        c = self._cursor(addr, 8 + 2 * self.sl + self.so)
        if c.take(4) != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap at {addr:#x}")
        c.skip(4)
        size = c.length()
        c.length()
        return self._read(c.addr(), size)

    # -- B-trees
    def _btree1(self, addr: int, key_size: int):
        """(key bytes, child address) of every leaf entry of a v1 B-tree;
        keys are the entry's left key."""
        c = self._cursor(addr, 8 + 2 * self.so)
        if c.take(4) != b"TREE":
            raise ValueError(f"{self.path}: bad v1 B-tree node at "
                             f"{addr:#x}")
        c.u8()
        level, entries = c.u8(), c.u16()
        body = self._cursor(addr + 8 + 2 * self.so,
                            entries * (key_size + self.so) + key_size)
        out = []
        for _ in range(entries):
            key = body.take(key_size)
            child = body.addr()
            if level == 0:
                out.append((key, child))
            else:
                out.extend(self._btree1(child, key_size))
        return out

    def _btree2(self, addr: int):
        """Every record (bytes) of a v2 B-tree."""
        c = self._cursor(addr, 4 + 2 + 4 + 2 + 2 + 2 + self.so + 2
                         + self.sl)
        if c.take(4) != b"BTHD":
            raise ValueError(f"{self.path}: bad v2 B-tree at {addr:#x}")
        c.skip(2)
        node_size, rec_size, depth = c.u32(), c.u16(), c.u16()
        c.skip(2)
        root, root_nrec = c.addr(), c.u16()
        # Per-depth record counts and their encoded sizes (H5B2__hdr_init).
        max_nrec = [(node_size - 10) // rec_size]
        cum = [max_nrec[0]]
        cum_size = [0]
        nrec_size = _limit_enc_size(max_nrec[0])
        for d in range(1, depth + 1):
            ptr = self.so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
            cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
            cum_size.append(_limit_enc_size(cum[d]))
        out = []

        def walk(node, nrec, d):
            if node == UNDEF or nrec == 0 and d == 0:
                return
            c = self._cursor(node, node_size)
            c.skip(6)
            recs = [c.take(rec_size) for _ in range(nrec)]
            out.extend(recs)
            if d == 0:
                return
            for _ in range(nrec + 1):
                child = c.addr()
                n = c.uint(nrec_size)
                if d > 1:
                    c.uint(cum_size[d - 1])
                walk(child, n, d - 1)

        walk(root, root_nrec, depth)
        return out

    def _fractal_heap(self, addr: int) -> "_FractalHeap":
        return _FractalHeap(self, addr)

    # -- public
    @property
    def attrs(self):
        return self._root.attrs

    def __getitem__(self, name):
        return self._root[name]

    def __contains__(self, name):
        return name in self._root

    def __iter__(self):
        return iter(self._root)

    def keys(self):
        return self._root.keys()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _FractalHeap:
    """A fractal heap's managed and tiny objects (dense links and dense
    attributes)."""

    def __init__(self, f: File, addr: int):
        self.f = f
        c = f._cursor(addr, 22 + 12 * f.sl + 3 * f.so)
        if c.take(4) != b"FRHP":
            raise ValueError(f"{f.path}: bad fractal heap at {addr:#x}")
        c.u8()
        self.id_len, filter_len = c.u16(), c.u16()
        c.u8()
        max_man = c.u32()
        c.length()
        c.addr()                                  # huge objects' B-tree
        c.skip(f.sl)
        c.addr()
        c.skip(8 * f.sl)
        self.width = c.u16()
        self.start = c.length()
        self.max_direct = c.length()
        max_heap_bits = c.u16()
        c.u16()
        self.root, self.rows = c.addr(), c.u16()
        if filter_len:
            f._fail("filtered fractal heap")
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8,
                            _limit_enc_size(max_man))
        self.max_direct_rows = (_log2(self.max_direct) - _log2(self.start)
                                + 2)

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _locate(self, off: int) -> int:
        if self.rows == 0:
            return self.root + off
        block, nrows, block_off = self.root, self.rows, 0
        while True:
            f = self.f
            c = f._cursor(block, 4 + 1 + f.so + self.off_size
                          + nrows * self.width * f.so)
            if c.take(4) != b"FHIB":
                raise ValueError(f"{f.path}: bad fractal heap indirect "
                                 "block")
            c.skip(1 + f.so + self.off_size)
            pos = block_off
            for r in range(nrows):
                size = self._row_size(r)
                for _ in range(self.width):
                    child = c.addr()
                    if pos <= off < pos + size:
                        if r < self.max_direct_rows:
                            return child + (off - pos)
                        first_bits = _log2(self.start) + _log2(self.width)
                        block, nrows = child, _log2(size) - first_bits + 1
                        block_off = pos
                        break
                    pos += size
                else:
                    continue
                break
            else:
                raise ValueError(f"{f.path}: fractal heap offset {off} "
                                 "not found")

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 0:
            off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
            n = int.from_bytes(heap_id[1 + self.off_size:1 + self.off_size
                                       + self.len_size], "little")
            return self.f._read(self._locate(off), n)
        if kind == 2:
            if self.id_len <= 18:
                n = (heap_id[0] & 0x0F) + 1
                return heap_id[1:1 + n]
            n = ((heap_id[0] & 0x0F) << 8 | heap_id[1]) + 1
            return heap_id[2:2 + n]
        self.f._fail("huge fractal heap object")


def _parse_link(c: _Cursor, f: File):
    """(name, address or None for a soft / external link) of a link
    message."""
    c.u8()
    flags = c.u8()
    ltype = c.u8() if flags & 0x08 else 0
    if flags & 0x04:
        c.skip(8)
    if flags & 0x10:
        c.skip(1)
    n = c.uint(1 << (flags & 3))
    name = c.take(n).decode()
    return name, (c.addr() if ltype == 0 else None)


def _parse_attribute(body: bytes, f: File, where):
    c = _Cursor(body, 0, f.so, f.sl)
    version = c.u8()
    flags = c.u8()
    nsize, tsize, ssize = c.u16(), c.u16(), c.u16()
    if version >= 3:
        c.skip(1)
    if flags & 0x03:
        f._fail(f"shared datatype or dataspace of an attribute of {where}")
    pad = (lambda n: -(-n // 8) * 8) if version == 1 else (lambda n: n)
    name = c.data[c.pos:c.pos + nsize].split(b"\0")[0].decode()
    c.skip(pad(nsize))
    start = c.pos
    dtype = _decode_datatype(c, f"{f.path}: attribute {name} of {where}")
    c.pos = start + pad(tsize)
    start = c.pos
    shape = _decode_dataspace(c, f"{f.path}: attribute {name} of {where}")
    c.pos = start + pad(ssize)
    if shape is None:
        return name, None
    n = int(np.prod(shape))
    raw = c.data[c.pos:c.pos + n * dtype.size]
    return name, _values(f, dtype, raw, shape)


def _values(f: File, t: _Type, raw: bytes, shape):
    """Decode stored elements as h5py returns them: numpy scalars for a
    scalar dataspace, ``str`` for variable-length strings."""
    n = int(np.prod(shape))
    if t.vlen is None:
        arr = np.frombuffer(raw, t.dtype, n).reshape(shape).copy()
        return arr[()] if shape == () else arr
    out = np.empty(n, object)
    for i in range(n):
        c = _Cursor(raw, 16 * i, f.so, f.sl)
        count, heap, index = c.u32(), c.addr(), c.u32()
        data = b"" if count == 0 or heap in (0, UNDEF) else \
            f._global_heap_object(heap, index)
        if t.vlen == "string":
            out[i] = data[:count].decode(
                "utf-8" if t.charset == 1 else "ascii")
        else:
            out[i] = np.frombuffer(data[:count * t.base.size],
                                   t.base.dtype, count).copy()
    out = out.reshape(shape)
    return out[()] if shape == () else out


class _Attrs:
    """A mapping of an object's attributes, decoded when first read."""

    def __init__(self, obj):
        self._obj = obj
        self._cache = None

    def _all(self):
        if self._cache is None:
            self._cache = self._obj._load_attrs()
        return self._cache

    def __getitem__(self, name):
        return self._all()[name]

    def __contains__(self, name):
        return name in self._all()

    def __iter__(self):
        return iter(self._all())

    def keys(self):
        return self._all().keys()

    def items(self):
        return self._all().items()


class _Object:
    def __init__(self, f: File, addr: int, name: str, messages=None):
        self.file, self.addr, self.name = f, addr, name
        self._msgs = f._messages(addr) if messages is None else messages
        self.attrs = _Attrs(self)

    def _msg(self, mtype):
        for t, body in self._msgs:
            if t == mtype:
                return _Cursor(body, 0, self.file.so, self.file.sl)
        return None

    def _load_attrs(self):
        f = self.file
        out = {}
        for t, body in self._msgs:
            if t == _ATTRIBUTE:
                k, v = _parse_attribute(body, f, self.name)
                out[k] = v
        info = self._msg(_ATTR_INFO)
        if info is not None:
            info.u8()
            flags = info.u8()
            if flags & 0x01:
                info.skip(2)
            heap, names = info.addr(), info.addr()
            if heap != UNDEF:
                fh = f._fractal_heap(heap)
                for rec in f._btree2(names):
                    k, v = _parse_attribute(fh.get(rec[:8]), f, self.name)
                    out[k] = v
        return out


class Group(_Object):
    """A group: ``g["name"]``, ``name in g``, iteration over its members'
    names (in name order)."""

    def __init__(self, f, addr, name, messages=None):
        super().__init__(f, addr, name, messages)
        self._links = None

    def _load_links(self):
        f = self.file
        links = {}
        st = self._msg(_SYMBOL_TABLE)
        if st is not None:
            btree, heap_addr = st.addr(), st.addr()
            heap = f._local_heap(heap_addr)
            entry = f.sl + f.so + 4 + 4 + 16
            for _, snod in f._btree1(btree, f.sl):
                c = f._cursor(snod, 8)
                if c.take(4) != b"SNOD":
                    raise ValueError(f"{f.path}: bad symbol table node")
                c.skip(2)
                n = c.u16()
                c = f._cursor(snod + 8, n * entry)
                for _ in range(n):
                    off = c.length()
                    addr = c.addr()
                    c.skip(24)
                    name = heap[off:heap.index(b"\0", off)].decode()
                    links[name] = addr
        for t, body in self._msgs:
            if t == _LINK:
                name, addr = _parse_link(_Cursor(body, 0, f.so, f.sl), f)
                links[name] = addr
        info = self._msg(_LINK_INFO)
        if info is not None:
            info.u8()
            flags = info.u8()
            if flags & 0x01:
                info.skip(8)
            heap, names = info.addr(), info.addr()
            if heap != UNDEF:
                fh = f._fractal_heap(heap)
                for rec in f._btree2(names):
                    name, addr = _parse_link(
                        _Cursor(fh.get(rec[4:11]), 0, f.so, f.sl), f)
                    links[name] = addr
        return dict(sorted(links.items()))

    def _get_links(self):
        if self._links is None:
            self._links = self._load_links()
        return self._links

    def __contains__(self, name):
        try:
            self._resolve(name)
        except KeyError:
            return False
        return True

    def _resolve(self, name):
        obj, parts = self, [p for p in name.split("/") if p]
        for i, p in enumerate(parts):
            if not isinstance(obj, Group):
                raise KeyError(name)
            links = obj._get_links()
            if p not in links:
                raise KeyError(name)
            addr = links[p]
            if addr is None:
                self.file._fail(f"soft or external link {name!r}")
            path = "/" + "/".join(parts[:i + 1])
            msgs = self.file._messages(addr)
            kind = Dataset if any(t == _LAYOUT for t, _ in msgs) else Group
            obj = kind(self.file, addr, path, msgs)
        return obj

    def __getitem__(self, name):
        return self._resolve(name)

    def __iter__(self):
        return iter(self._get_links())

    def keys(self):
        return list(self._get_links())


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``attrs``, ``fillvalue``,
    ``allocated`` (whether any storage was written), ``read(sel)`` and
    ``ds[sel]``."""

    def __init__(self, f, addr, name, messages=None):
        super().__init__(f, addr, name, messages)
        where = f"{f.path}: dataset {name}"
        if self._msg(_EXTERNAL) is not None:
            f._fail(f"external storage ({name})")
        c = self._msg(_DATATYPE)
        if c is None:
            raise ValueError(f"{where} has no datatype")
        self._type = _decode_datatype(c, where)
        self.dtype = self._type.dtype
        self.shape = _decode_dataspace(self._msg(_DATASPACE), where)
        if self.shape is None:
            self.shape = ()
        self.fillvalue = self._fill()
        self._layout()
        self._filters = self._pipeline()

    def _fill(self):
        c = self._msg(_FILL)
        size, value = 0, b""
        if c is not None:
            version = c.u8()
            if version in (1, 2):
                c.skip(2)
                defined = c.u8()
                if version == 1 or defined:
                    size = c.u32()
            elif version == 3:
                flags = c.u8()
                if flags & 0x20:
                    size = c.u32()
            value = c.take(size) if size else b""
        else:
            c = self._msg(_FILL_OLD)
            if c is not None:
                size = c.u32()
                value = c.take(size)
        if self._type.vlen is not None:
            return None
        if size == self.dtype.itemsize:
            return np.frombuffer(value, self.dtype, 1)[0]
        return np.zeros((), self.dtype)[()]

    def _layout(self):
        f = self.file
        c = self._msg(_LAYOUT)
        version = c.u8()
        if version < 3:
            f._fail(f"data layout message version {version} ({self.name})")
        cls = c.u8()
        self._kind, self._chunk, self._index = None, None, None
        if cls == 0:
            n = c.u16()
            self._kind, self._compact = "compact", c.take(n)
        elif cls == 1:
            self._kind, self._addr = "contiguous", c.addr()
            c.length()
        elif cls == 2:
            self._kind = "chunked"
            if version == 3:
                ndims = c.u8()
                self._addr = c.addr()
                dims = [c.u32() for _ in range(ndims)]
                self._index = "btree1"
            else:
                flags = c.u8()
                ndims = c.u8()
                enc = c.u8()
                dims = [c.uint(enc) for _ in range(ndims)]
                index = c.u8()
                if index == 1:
                    self._index = "single"
                    self._single = (c.length(), c.u32()) if flags & 0x02 \
                        else (None, 0)
                    self._addr = c.addr()
                elif index == 2:
                    self._index, self._addr = "implicit", c.addr()
                elif index == 3:
                    c.u8()
                    self._index, self._addr = "fixed", c.addr()
                else:
                    f._fail({4: "extensible-array chunk index",
                             5: "v2-B-tree chunk index"}.get(
                        index, f"chunk index type {index}")
                        + f" ({self.name})")
            self._chunk = tuple(dims[:-1])
        else:
            f._fail(f"virtual dataset ({self.name})")

    def _pipeline(self):
        c = self._msg(_FILTERS)
        if c is None:
            return []
        version, n = c.u8(), c.u8()
        if version == 1:
            c.skip(6)
        filters = []
        for _ in range(n):
            fid = c.u16()
            nlen = c.u16() if version == 1 or fid >= 256 else 0
            c.u16()
            nvals = c.u16()
            if version == 1:
                c.skip(-(-nlen // 8) * 8)
            else:
                c.skip(nlen)
            vals = [c.u32() for _ in range(nvals)]
            if version == 1 and nvals % 2:
                c.skip(4)
            filters.append((fid, vals))
        return filters

    @property
    def allocated(self) -> bool:
        """Whether the dataset has storage (h5py: storage size > 0)."""
        if self._kind == "compact":
            return True
        if self._kind == "contiguous" or self._index == "single" or \
                self._index == "implicit":
            return self._addr != UNDEF
        return any(True for _ in self._chunks())

    # -- chunk index
    def _chunks(self):
        """(chunk offset, address, stored size, filter mask) of every
        allocated chunk."""
        f = self.file
        if self._addr == UNDEF:
            return
        full = int(np.prod(self._chunk)) * self.dtype.itemsize
        grid = [-(-s // c) for s, c in zip(self.shape, self._chunk)]
        if self._index == "btree1":
            rank = len(self._chunk)
            for key, child in f._btree1(self._addr, 8 + 8 * (rank + 1)):
                size, mask = struct.unpack_from("<II", key)
                offs = struct.unpack_from(f"<{rank}Q", key, 8)
                yield offs, child, size, mask
        elif self._index == "single":
            size, mask = self._single
            yield (0,) * len(self.shape), self._addr, size or full, mask
        elif self._index == "implicit":
            for i, idx in enumerate(np.ndindex(*grid)):
                yield (tuple(a * c for a, c in zip(idx, self._chunk)),
                       self._addr + i * full, full, 0)
        else:
            for i, (addr, size, mask) in enumerate(self._fixed_array()):
                if addr == UNDEF:
                    continue
                idx = np.unravel_index(i, grid)
                yield (tuple(int(a) * c for a, c in zip(idx, self._chunk)),
                       addr, size or full, mask)

    def _fixed_array(self):
        f = self.file
        c = f._cursor(self._addr, 4 + 4 + f.sl + f.so)
        if c.take(4) != b"FAHD":
            raise ValueError(f"{f.path}: bad fixed-array header")
        c.u8()
        client, esize, page_bits = c.u8(), c.u8(), c.u8()
        n, dblock = c.length(), c.addr()
        if dblock == UNDEF:
            return []
        page = 1 << page_bits
        prefix = 4 + 1 + 1 + f.so
        if n > page:
            npages = -(-n // page)
            bitmap = f._read(dblock + prefix, -(-npages // 8))
            spans, pos = [], dblock + prefix + len(bitmap) + 4
            for p in range(npages):
                k = min(page, n - p * page)
                if bitmap[p // 8] & (0x80 >> (p % 8)):
                    spans.append((p * page, pos, k))
                pos += k * esize + 4
        else:
            spans = [(0, dblock + prefix, n)]
        out = [(UNDEF, 0, 0)] * n
        for first, pos, k in spans:
            c = f._cursor(pos, k * esize)
            for i in range(k):
                addr = c.addr()
                if client == 1:
                    size = c.uint(esize - f.so - 4)
                    mask = c.u32()
                else:
                    size, mask = None, 0
                out[first + i] = (addr, size, mask)
        return out

    def _decode_chunk(self, raw: bytes, mask: int) -> bytes:
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, vals = self._filters[i]
            if fid == _FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == _FILTER_SHUFFLE:
                es = vals[0] if vals else self.dtype.itemsize
                n = len(raw) // es
                body = np.frombuffer(raw, np.uint8, n * es)
                raw = body.reshape(es, n).T.tobytes() + raw[n * es:]
            elif fid == _FILTER_FLETCHER32:
                raw = raw[:-4]
            else:
                self.file._fail(
                    f"the {_FILTER_NAMES.get(fid, f'id {fid}')} filter "
                    f"({self.name})")
        return raw

    # -- reads
    def __getitem__(self, sel):
        return self.read(sel)

    def read(self, sel=()):
        """The selected elements, as h5py returns them: ``sel`` is an int,
        a slice or a tuple of those (steps > 0), applied to the leading
        dimensions in stored order; ``()`` reads everything."""
        if not isinstance(sel, tuple):
            sel = (sel,)
        if len(sel) > len(self.shape):
            raise IndexError(f"{len(sel)} indices for the "
                             f"{len(self.shape)}-d dataset {self.name}")
        box, rel = [], []
        for i, n in enumerate(self.shape):
            s = sel[i] if i < len(sel) else slice(None)
            if isinstance(s, (int, np.integer)):
                j = int(s) + n if s < 0 else int(s)
                if not 0 <= j < n:
                    raise IndexError(f"index {s} out of range for axis "
                                     f"{i} of {self.name} ({n})")
                box.append((j, j + 1))
                rel.append(0)
            elif isinstance(s, slice):
                start, stop, step = s.indices(n)
                if step <= 0:
                    raise TypeError("only positive slice steps are read")
                count = max(0, -(-(stop - start) // step))
                hi = start + (count - 1) * step + 1 if count else start
                box.append((start, hi))
                rel.append(slice(0, hi - start, step))
            else:
                raise TypeError(f"unsupported selection {s!r}")
        if self._type.vlen is not None:
            raw = self._raw_box([(0, n) for n in self.shape])
            return _values(self.file, self._type, raw.tobytes(),
                           self.shape)[tuple(
                               slice(a, b) for a, b in box)][tuple(rel)]
        data = self._raw_box(box)[tuple(rel)]
        return data[()] if np.ndim(data) == 0 else np.ascontiguousarray(data)

    def _raw_box(self, box):
        """The elements of the box [lo, hi) per dimension."""
        shape = tuple(b - a for a, b in box)
        dtype = self.dtype if self._type.vlen is None else \
            np.dtype("V16")
        if self._kind == "compact":
            arr = np.frombuffer(self._compact, dtype,
                                int(np.prod(self.shape))).reshape(
                                    self.shape)
            return arr[tuple(slice(a, b) for a, b in box)]
        if self._kind == "contiguous":
            if self._addr == UNDEF:
                return np.full(shape, self.fillvalue, dtype)
            if self.shape == () or 0 in self.shape:
                n = int(np.prod(self.shape))
                return np.frombuffer(self.file._read(
                    self._addr, n * dtype.itemsize), dtype, n).reshape(
                        self.shape)[tuple(slice(a, b) for a, b in box)]
            mm = np.memmap(self.file.path, dtype, "r",
                           offset=self.file._base + self._addr,
                           shape=self.shape)
            out = np.array(mm[tuple(slice(a, b) for a, b in box)])
            del mm
            return out
        out = np.full(shape, self.fillvalue if self._type.vlen is None
                      else b"", dtype)
        if 0 in shape:
            return out
        for offs, addr, size, mask in self._chunks():
            lo = [max(a, o) for (a, _), o in zip(box, offs)]
            hi = [min(b, o + c) for (_, b), o, c in
                  zip(box, offs, self._chunk)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            raw = self._decode_chunk(self.file._read(addr, size), mask)
            chunk = np.frombuffer(raw, dtype, int(np.prod(self._chunk))) \
                .reshape(self._chunk)
            out[tuple(slice(l - a, h - a) for l, h, (a, _) in
                      zip(lo, hi, box))] = \
                chunk[tuple(slice(l - o, h - o) for l, h, o in
                            zip(lo, hi, offs))]
        return out


# ------------------------------------------------------------------ writer

_LEAF_K, _INTERNAL_K = 4, 16          # h5py's group B-tree constants
_SB_SIZE = 96                         # superblock v0 with its root entry


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _enc_dtype(dt: np.dtype) -> bytes:
    """A v1 datatype message for a little-endian number or a
    null-padded fixed-length byte string."""
    if dt.kind == "f" and dt.itemsize in (4, 8):
        sign, exp_loc, exp_size, mant, bias = \
            (31, 23, 8, 23, 127) if dt.itemsize == 4 else \
            (63, 52, 11, 52, 1023)
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0,
                           dt.itemsize, 0, 8 * dt.itemsize, exp_loc,
                           exp_size, 0, mant, bias)
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                           0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "S":
        return _enc_string_type(dt.itemsize, nullterm=False)
    raise TypeError(f"cannot write datatype {dt}")


def _enc_string_type(size: int, nullterm: bool) -> bytes:
    return struct.pack("<BBBBI", 0x13, 0 if nullterm else 1, 0, 0, size)


# h5py's variable-length UTF-8 string: a sequence of unsigned bytes.
_VLEN_STR = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0x00, 16) + \
    struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
_OBJ_REF = struct.pack("<BBBBI", 0x17, 0, 0, 0, 8)
# DIMENSION_LIST: a variable-length sequence of object references.
_VLEN_REFS = struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + _OBJ_REF


def _compound_member(name: str, offset: int, dtype: bytes) -> bytes:
    return _pad8(name.encode() + b"\0") + struct.pack("<IB3xII16x", offset,
                                                      0, 0, 0) + dtype


# REFERENCE_LIST: {dataset: object reference, dimension: uint32}, 16 bytes.
_REF_LIST = struct.pack("<BBBBI", 0x16, 2, 0, 0, 16) + \
    _compound_member("dataset", 0, _OBJ_REF) + \
    _compound_member("dimension", 8, struct.pack("<BBBBIHH", 0x10, 0, 0, 0,
                                                 4, 0, 32))


def _enc_dataspace(shape) -> bytes:
    if shape == ():
        return struct.pack("<BBBB4x", 1, 0, 0, 0)
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBB4x", 1, len(shape), 1, 0) + dims + dims


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _attribute(name: str, dtype: bytes, shape, data: bytes) -> bytes:
    nm = name.encode() + b"\0"
    space = _enc_dataspace(shape)
    return _message(_ATTRIBUTE, struct.pack(
        "<BBHHH", 1, 0, len(nm), len(dtype), len(space))
        + _pad8(nm) + _pad8(dtype) + _pad8(space) + data)


class _GlobalHeap:
    """The objects of one global heap collection, numbered from 1."""

    def __init__(self):
        self.objects = []
        self.addr = 0

    def add(self, data: bytes, count: int | None = None) -> bytes:
        """A 16-byte variable-length element pointing at ``data``: ``count``
        elements of a sequence, or a string's bytes."""
        self.objects.append(data)
        if len(self.objects) > 0xFFFF:
            raise ValueError("too many variable-length attribute values")
        return struct.pack("<IQI", len(data) if count is None else count,
                           self.addr, len(self.objects))

    def encode(self) -> bytes:
        body = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(o)) + _pad8(o)
                        for i, o in enumerate(self.objects))
        size = max(4096, 16 + len(body) + 16)
        free = size - 16 - len(body)
        return (b"GCOL" + struct.pack("<B3xQ", 1, size) + body
                + struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16))


class WrittenDataset:
    """A dataset of a :class:`FileWriter`: its shape and dtype, and
    ``attrs`` set before the file is closed."""

    def __init__(self, name, shape, dtype, addr, fillvalue):
        self.name, self.shape, self.dtype = name, shape, dtype
        self.addr, self.fillvalue = addr, fillvalue
        self.attrs = {}
        self.scale_name = None
        self.dims = [[] for _ in shape]       # attached scales per axis
        self.refs = []                        # (dataset, axis) attached


class FileWriter:
    """Write an HDF5 file the way h5py's defaults do (superblock v0, a
    symbol-table root group, v1 object headers, contiguous storage).

    ``create_dataset(name, data)`` writes the data at once;
    ``create_dataset(name, shape=, dtype=, fillvalue=)`` defines a dataset
    with no storage.  Attributes (``attrs`` of the file or a dataset) are
    numbers, ``str`` (variable-length UTF-8, as h5py stores it), ``bytes``
    and numpy arrays of numbers or fixed-length byte strings.
    :meth:`make_scale` and :meth:`attach_scale` are h5py's dimension-scale
    calls.  Everything else is laid out at :meth:`close`."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._fh = open(self.path, "wb")
        self._fh.write(b"\0" * _SB_SIZE)
        self._pos = _SB_SIZE
        self._datasets = {}
        self.attrs = {}

    def _append(self, data) -> int:
        self._pos += -self._pos % 8
        self._fh.seek(self._pos)
        addr = self._pos
        self._fh.write(data)
        self._pos = self._fh.tell()
        return addr

    def create_dataset(self, name: str, data=None, *, shape=None,
                       dtype=None, fillvalue=None) -> WrittenDataset:
        if name in self._datasets or "/" in name:
            raise ValueError(f"cannot create dataset {name!r}")
        if data is not None:
            arr = np.asarray(data)
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            _enc_dtype(arr.dtype)
            addr = self._append(np.ascontiguousarray(arr).tobytes()) \
                if arr.size else UNDEF
            shape, dtype = arr.shape, arr.dtype
        else:
            shape, dtype, addr = tuple(shape), np.dtype(dtype), UNDEF
        ds = WrittenDataset(name, tuple(int(s) for s in shape), dtype, addr,
                            None if fillvalue is None else
                            np.asarray(fillvalue, dtype))
        self._datasets[name] = ds
        return ds

    @staticmethod
    def make_scale(ds: WrittenDataset, name: str = ""):
        """h5py's ``ds.make_scale(name)``."""
        ds.scale_name = name

    @staticmethod
    def attach_scale(ds: WrittenDataset, scale: WrittenDataset, axis: int):
        """h5py's ``ds.dims[axis].attach_scale(scale)``."""
        ds.dims[axis].append(scale)
        scale.refs.append((ds, axis))

    # -- layout
    def _attributes(self, attrs: dict, heap: _GlobalHeap) -> bytes:
        out = []
        for name, v in attrs.items():
            if isinstance(v, str):
                out.append(_attribute(name, _VLEN_STR, (),
                                      heap.add(v.encode())))
                continue
            arr = np.asarray(v)
            if arr.dtype.kind == "U":
                raise TypeError(f"attribute {name}: arrays of str are not "
                                "written")
            if arr.dtype == np.float16 or arr.dtype.kind not in "fiuS":
                raise TypeError(f"attribute {name}: cannot write {arr.dtype}")
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            out.append(_attribute(name, _enc_dtype(arr.dtype), arr.shape,
                                  np.ascontiguousarray(arr).tobytes()))
        return b"".join(out)

    def _dataset_header(self, ds, addr_of, heap) -> bytes:
        msgs = [_message(_DATASPACE, _enc_dataspace(ds.shape)),
                _message(_DATATYPE, _enc_dtype(ds.dtype), 1)]
        if ds.fillvalue is None:
            msgs.append(_message(_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0),
                                 1))
        else:
            fv = ds.fillvalue.astype(ds.dtype).tobytes()
            msgs.append(_message(_FILL, struct.pack("<BBBBI", 2, 2, 2, 1,
                                                    len(fv)) + fv, 1))
            msgs.append(_message(_FILL_OLD, struct.pack("<I", len(fv)) + fv,
                                 1))
        nbytes = int(np.prod(ds.shape)) * ds.dtype.itemsize
        msgs.append(_message(_LAYOUT, struct.pack("<BBQQ", 3, 1, ds.addr,
                                                  nbytes)))
        attrs = b""
        if ds.scale_name is not None:
            for key, text in (("CLASS", "DIMENSION_SCALE"),
                              ("NAME", ds.scale_name)):
                s = text.encode() + b"\0"
                attrs += _attribute(key, _enc_string_type(len(s), True), (),
                                    s)
            if ds.refs:
                attrs += _attribute(
                    "REFERENCE_LIST", _REF_LIST, (len(ds.refs),),
                    b"".join(struct.pack("<QI4x", addr_of[d.name], axis)
                             for d, axis in ds.refs))
        if any(ds.dims):
            attrs += _attribute(
                "DIMENSION_LIST", _VLEN_REFS, (len(ds.dims),),
                b"".join(heap.add(b"".join(struct.pack("<Q",
                                                       addr_of[s.name])
                                           for s in scales), len(scales))
                         for scales in ds.dims))
        body = b"".join(msgs) + attrs + self._attributes(ds.attrs, heap)
        return body

    @staticmethod
    def _object_header(messages: bytes) -> bytes:
        n, pos = 0, 0
        while pos < len(messages):
            n += 1
            pos += 8 + struct.unpack_from("<H", messages, pos + 2)[0]
        return struct.pack("<BBHII4x", 1, 0, n, 1, len(messages)) + messages

    def _layout(self, start: int, addr_of: dict, heap: _GlobalHeap,
                names: list):
        """Every metadata block from ``start`` on, for given addresses:
        [(address, bytes)], the root header's address, the B-tree's and the
        local heap's, the leaf K, and the end of the file."""
        heap.objects = []
        heap.addr = start
        headers = {ds.name: self._dataset_header(ds, addr_of, heap)
                   for ds in self._datasets.values()}
        root_attrs = self._attributes(self.attrs, heap)
        blocks = [(start, heap.encode())]
        pos = start + len(blocks[0][1])
        new_addr = {}
        for name in self._datasets:
            hdr = self._object_header(headers[name])
            new_addr[name] = pos
            blocks.append((pos, hdr))
            pos += len(hdr)
        # The local heap: "" at offset 0, then the names in order.
        heap_data, offsets = b"\0" * 8, []
        for name in names:
            offsets.append(len(heap_data))
            heap_data += _pad8(name.encode() + b"\0")
        leaf_k = max(_LEAF_K, -(-len(names) // 2))
        root_addr = pos
        local_heap = root_addr + len(self._object_header(
            _message(_SYMBOL_TABLE, b"\0" * 16) + root_attrs))
        heap_data_addr = local_heap + 32
        btree = heap_data_addr + len(heap_data)
        btree_len = 8 + 16 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
        snod = btree + btree_len
        snod_len = 8 + 2 * leaf_k * 40
        root = self._object_header(
            _message(_SYMBOL_TABLE, struct.pack("<QQ", btree, local_heap))
            + root_attrs)
        blocks.append((root_addr, root))
        blocks.append((local_heap, b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap_data), 1, heap_data_addr)))
        blocks.append((heap_data_addr, heap_data))
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0,
                                     UNDEF, UNDEF)
        if names:
            node += struct.pack("<QQQ", 0, snod, offsets[-1])
        blocks.append((btree, node + b"\0" * (btree_len - len(node))))
        entries = b"".join(struct.pack("<QQII16x", off, new_addr[n], 0, 0)
                           for n, off in zip(names, offsets))
        sn = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries
        blocks.append((snod, sn + b"\0" * (snod_len - len(sn))))
        return blocks, new_addr, root_addr, btree, local_heap, leaf_k, \
            snod + snod_len

    def close(self):
        if self._fh.closed:
            return
        try:
            start = self._pos + -self._pos % 8
            names = sorted(self._datasets, key=lambda n: n.encode())
            heap = _GlobalHeap()
            # Sizes do not depend on addresses: one pass with placeholders
            # places every block, the second encodes the real addresses.
            addr_of = dict.fromkeys(self._datasets, 0)
            _, addr_of, *_ = self._layout(start, addr_of, heap, names)
            blocks, _, root, btree, lheap, leaf_k, eof = \
                self._layout(start, addr_of, heap, names)
            for addr, data in blocks:
                self._fh.seek(addr)
                self._fh.write(data)
            self._fh.seek(0)
            self._fh.write(
                SIGNATURE + struct.pack(
                    "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k,
                    _INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                + struct.pack("<QQII", 0, root, 1, 0)
                + struct.pack("<QQ", btree, lheap))
            self._fh.truncate(eof)
        finally:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
