"""A read-only HDF5 reader in pure numpy, for Keras-2 weight files.

The port has to load the reference model format on machines that have
numpy and PyTorch but no ``h5py``. This module reads the subset of HDF5
that Keras' ``save_weights`` (through h5py's default, earliest file
format) writes: superblock version 0/1, version-1 object headers with
continuation blocks, groups as symbol tables (v1 B-trees, local heaps)
or as link messages, contiguous or compact datasets without filters, and
attributes of fixed-point, floating-point, enum (numpy bool), fixed-length
and variable-length string types. Anything else raises ``ValueError``.

The interface is the part of h5py's that ``utils/io_h5.py`` uses:
``File`` (a context manager), ``Group`` (``in``, ``[]``, ``attrs``,
``visititems``) and ``Dataset`` (``[()]``, ``np.asarray``). Variable-length
strings read as ``str``, as in h5py; ``attr_charsets`` of a group or
dataset names the character set each was stored with ('ascii' or
'utf-8', h5py's encoding of ``bytes`` and ``str``).
"""

import numpy as np

_UNDEF = 0xFFFFFFFFFFFFFFFF


class _Reader:
    """Little-endian field reads at absolute file offsets."""

    def __init__(self, buf):
        self.buf = buf
        self.so = 8   # size of offsets
        self.sl = 8   # size of lengths

    def uint(self, pos, n):
        return int.from_bytes(self.buf[pos:pos + n], 'little')

    def offset(self, pos):
        return self.uint(pos, self.so)

    def length(self, pos):
        return self.uint(pos, self.sl)

    def cstring(self, pos):
        end = self.buf.index(b'\0', pos)
        return bytes(self.buf[pos:end]).decode('utf-8')


def _parse_datatype(r, pos):
    """Return (numpy dtype or marker, size in bytes) of a datatype message."""
    cls_ver = r.buf[pos]
    cls = cls_ver & 0x0F
    bits = r.buf[pos + 1:pos + 4]
    size = r.uint(pos + 4, 4)
    if cls == 0:                                   # fixed point
        endian = '>' if bits[0] & 1 else '<'
        kind = 'i' if bits[0] & 8 else 'u'
        return np.dtype('%s%s%d' % (endian, kind, size)), size
    if cls == 1:                                   # floating point
        endian = '>' if bits[0] & 1 else '<'
        return np.dtype('%sf%d' % (endian, size)), size
    if cls == 3:                                   # fixed-length string
        return np.dtype('S%d' % size), size
    if cls == 8:                                   # enum (h5py's bool)
        base, _ = _parse_datatype(r, pos + 8)
        if base.itemsize == 1:
            return np.dtype(bool), size
        return base, size
    if cls == 9 and (bits[0] & 0x0F) == 1:         # variable-length string
        return ('vlen_utf8' if bits[1] & 0x0F else 'vlen_ascii'), size
    raise ValueError('unsupported HDF5 datatype class %d' % cls)


def _parse_dataspace(r, pos):
    version, rank, flags = r.buf[pos], r.buf[pos + 1], r.buf[pos + 2]
    if version == 1:
        start = pos + 8
    elif version == 2:
        if r.buf[pos + 3] == 2:                    # null dataspace
            return None
        start = pos + 4
    else:
        raise ValueError('unsupported HDF5 dataspace version %d' % version)
    return tuple(r.length(start + i * r.sl) for i in range(rank))


def _read_vlen_strings(r, raw, count):
    """Decode `count` variable-length string references (length,
    global heap collection address, object index) into str."""
    out = []
    step = 4 + r.so + 4
    for i in range(count):
        base = i * step
        length = int.from_bytes(raw[base:base + 4], 'little')
        coll = int.from_bytes(raw[base + 4:base + 4 + r.so], 'little')
        index = int.from_bytes(raw[base + 4 + r.so:base + step], 'little')
        out.append(_global_heap_object(r, coll, index)[:length]
                   .decode('utf-8'))
    return out


def _global_heap_object(r, coll, index):
    if bytes(r.buf[coll:coll + 4]) != b'GCOL':
        raise ValueError('bad HDF5 global heap at %d' % coll)
    end = coll + r.length(coll + 8)
    pos = coll + 8 + r.sl
    while pos + 8 + r.sl <= end:
        obj_index = r.uint(pos, 2)
        size = r.length(pos + 8)
        data = pos + 8 + r.sl
        if obj_index == index:
            return bytes(r.buf[data:data + size])
        if obj_index == 0:
            break
        pos = data + ((size + 7) // 8) * 8
    raise ValueError('HDF5 global heap object %d not found' % index)


def _to_array(r, raw, dtype, shape):
    count = int(np.prod(shape)) if shape else 1
    if isinstance(dtype, str):
        vals = _read_vlen_strings(r, raw, count)
        arr = np.empty(count, dtype=object)
        arr[:] = vals
    else:
        arr = np.frombuffer(bytes(raw[:count * dtype.itemsize]),
                            dtype=dtype).copy()
    return arr.reshape(shape) if shape else arr.reshape(())


def _messages(r, addr):
    """Yield (type, data position, size) of a version-1 object header,
    following continuation messages."""
    if r.buf[addr] != 1:
        raise ValueError('unsupported HDF5 object header version %d'
                         % r.buf[addr])
    n_msgs = r.uint(addr + 2, 2)
    blocks = [(addr + 16, r.uint(addr + 8, 4))]
    seen = 0
    while blocks and seen < n_msgs:
        pos, size = blocks.pop(0)
        end = pos + size
        while pos + 8 <= end and seen < n_msgs:
            mtype, msize = r.uint(pos, 2), r.uint(pos + 2, 2)
            data = pos + 8
            seen += 1
            if mtype == 0x10:                      # continuation
                blocks.append((r.offset(data), r.length(data + r.so)))
            else:
                yield mtype, data, msize
            pos = data + msize


class Dataset:
    def __init__(self, r, addr):
        self._r = r
        self.attrs = {}
        # the character set of each variable-length string attribute
        self.attr_charsets = {}
        self._dtype = self.shape = self._layout = None
        for mtype, pos, _ in _messages(r, addr):
            if mtype == 0x01:
                self.shape = _parse_dataspace(r, pos)
            elif mtype == 0x03:
                self._dtype, _ = _parse_datatype(r, pos)
            elif mtype == 0x08:
                self._layout = pos
            elif mtype == 0x0B:
                raise ValueError('filtered (compressed) HDF5 datasets are '
                                 'not supported')
            elif mtype == 0x0C:
                _add_attribute(self, r, pos)

    def _raw(self):
        r, pos = self._r, self._layout
        version = r.buf[pos]
        nbytes = ((int(np.prod(self.shape)) if self.shape else 1)
                  * (self._dtype.itemsize if not isinstance(self._dtype, str)
                     else 4 + r.so + 4))
        if version == 3:
            cls = r.buf[pos + 1]
            if cls == 0:                           # compact
                size = r.uint(pos + 2, 2)
                return r.buf[pos + 4:pos + 4 + size]
            if cls == 1:                           # contiguous
                addr = r.offset(pos + 2)
                if addr == _UNDEF:
                    return bytes(nbytes)
                return r.buf[addr:addr + nbytes]
        elif version in (1, 2):
            rank, cls = r.buf[pos + 1], r.buf[pos + 2]
            if cls == 1:
                addr = r.offset(pos + 8)
                if addr == _UNDEF:
                    return bytes(nbytes)
                return r.buf[addr:addr + nbytes]
            if cls == 0:
                start = pos + 8 + 4 * rank
                size = r.uint(start, 4)
                return r.buf[start + 4:start + 4 + size]
        raise ValueError('unsupported HDF5 data layout (chunked storage?)')

    def read(self):
        return _to_array(self._r, self._raw(), self._dtype, self.shape)

    def __getitem__(self, key):
        if key != ():
            raise ValueError('only ds[()] reads are supported')
        arr = self.read()
        return arr[()] if arr.ndim == 0 else arr

    def __array__(self, dtype=None, copy=None):
        arr = self.read()
        return arr if dtype is None else arr.astype(dtype)


def _add_attribute(obj, r, pos):
    name, value, dtype = _parse_attribute(r, pos)
    obj.attrs[name] = value
    if isinstance(dtype, str):
        obj.attr_charsets[name] = 'utf-8' if dtype == 'vlen_utf8' else 'ascii'


def _parse_attribute(r, pos):
    version = r.buf[pos]
    name_size = r.uint(pos + 2, 2)
    dt_size = r.uint(pos + 4, 2)
    ds_size = r.uint(pos + 6, 2)
    if version == 1:
        pad = lambda n: (n + 7) // 8 * 8
        p = pos + 8
    elif version in (2, 3):
        pad = lambda n: n
        p = pos + 8 + (1 if version == 3 else 0)
    else:
        raise ValueError('unsupported HDF5 attribute version %d' % version)
    name = bytes(r.buf[p:p + name_size]).split(b'\0', 1)[0].decode('utf-8')
    p += pad(name_size)
    dtype, _ = _parse_datatype(r, p)
    p += pad(dt_size)
    shape = _parse_dataspace(r, p)
    p += pad(ds_size)
    if shape is None:
        return name, None, dtype
    value = _to_array(r, r.buf[p:], dtype, shape)
    if value.ndim == 0 and isinstance(dtype, str):
        value = value[()]
    return name, value, dtype


class Group:
    def __init__(self, r, addr):
        self._r = r
        self.attrs = {}
        # the character set of each variable-length string attribute
        self.attr_charsets = {}
        self._links = {}
        for mtype, pos, _ in _messages(r, addr):
            if mtype == 0x11:                      # symbol table
                self._read_symbol_table(r.offset(pos), r.offset(pos + r.so))
            elif mtype == 0x06:                    # link message
                name, target = _parse_link(r, pos)
                if target is not None:
                    self._links[name] = target
            elif mtype == 0x0C:
                _add_attribute(self, r, pos)

    def _read_symbol_table(self, btree, heap):
        r = self._r
        if bytes(r.buf[heap:heap + 4]) != b'HEAP':
            raise ValueError('bad HDF5 local heap at %d' % heap)
        heap_data = r.offset(heap + 8 + 2 * r.sl)
        stack = [btree]
        while stack:
            node = stack.pop()
            sig = bytes(r.buf[node:node + 4])
            if sig == b'SNOD':
                count = r.uint(node + 6, 2)
                entry = node + 8
                for _ in range(count):
                    name = r.cstring(heap_data + r.offset(entry))
                    self._links[name] = r.offset(entry + r.so)
                    entry += 2 * r.so + 24
                continue
            if sig != b'TREE':
                raise ValueError('bad HDF5 B-tree node at %d' % node)
            used = r.uint(node + 6, 2)
            pos = node + 8 + 2 * r.so              # first key
            for i in range(used):
                stack.append(r.offset(pos + r.sl + i * (r.so + r.sl)))

    def _object(self, addr):
        for mtype, _, _ in _messages(self._r, addr):
            if mtype in (0x11, 0x02, 0x06, 0x0A):  # group messages
                return Group(self._r, addr)
        return Dataset(self._r, addr)

    def keys(self):
        # h5py's default iteration order: by name
        return sorted(self._links)

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path):
        obj = self
        for part in (p for p in path.split('/') if p):
            if not isinstance(obj, Group) or part not in obj._links:
                raise KeyError(path)
            obj = obj._object(obj._links[part])
        return obj

    def visititems(self, fn, prefix=''):
        """Call fn(path, obj) for every object below, like h5py's."""
        for name in self.keys():
            obj = self[name]
            path = prefix + name
            result = fn(path, obj)
            if result is not None:
                return result
            if isinstance(obj, Group):
                result = obj.visititems(fn, path + '/')
                if result is not None:
                    return result
        return None


def _parse_link(r, pos):
    """(name, object header address) of a hard link message."""
    flags = r.buf[pos + 1]
    p = pos + 2
    link_type = 0
    if flags & 0x08:
        link_type = r.buf[p]
        p += 1
    if flags & 0x04:
        p += 8                                     # creation order
    if flags & 0x10:
        p += 1                                     # charset
    n = 1 << (flags & 3)
    name_len = r.uint(p, n)
    p += n
    name = bytes(r.buf[p:p + name_len]).decode('utf-8')
    p += name_len
    return name, (r.offset(p) if link_type == 0 else None)


class File(Group):
    """Open an HDF5 file read-only; the whole file is read into memory."""

    def __init__(self, filename, mode='r'):
        if mode != 'r':
            raise ValueError('read-only')
        with open(filename, 'rb') as f:
            buf = f.read()
        if bytes(buf[:8]) != b'\x89HDF\r\n\x1a\n':
            raise ValueError('%s is not an HDF5 file (or has a user block)'
                             % filename)
        r = _Reader(buf)
        version = buf[8]
        if version not in (0, 1):
            raise ValueError('unsupported HDF5 superblock version %d'
                             % version)
        r.so, r.sl = buf[13], buf[14]
        # the root group's symbol table entry follows the fixed fields
        # and four addresses (base, free space, end of file, I/O info)
        fixed = 24 if version == 0 else 28
        root_entry = fixed + 4 * r.so
        super().__init__(r, r.offset(root_entry + r.so))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._r = None
