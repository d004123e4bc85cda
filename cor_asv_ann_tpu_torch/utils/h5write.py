"""A write-only HDF5 writer in pure numpy, for Keras-2 weight files.

The port has to save the reference model format on machines that have
numpy and PyTorch but no ``h5py``. This module writes the subset of HDF5
that Keras' ``save_weights`` (through h5py's default, earliest file
format) produces, the same subset ``utils/h5read.py`` reads: a version-0
superblock, version-1 object headers, groups as symbol tables (one
version-1 B-tree node over symbol-table nodes, one local heap),
contiguous uncompressed datasets, and attributes. Supported element
types: little-endian integers and floats, numpy ``bool`` (h5py's
FALSE/TRUE enum), fixed-length byte strings (``S<n>`` arrays) and, for
scalar attributes, Python ``bytes``/``str`` as a variable-length string
in a global heap, which is how h5py stores them. Anything else raises
``ValueError``.

The interface is the part of h5py's that ``utils/io_h5.py`` uses:
``File(name, 'w')`` (a context manager; the file is written on close),
``create_group``, ``create_dataset(path, data=...)`` with nested paths,
and ``attrs[name] = value``.
"""

import struct

import numpy as np

_UNDEF = 0xFFFFFFFFFFFFFFFF
_SIGNATURE = b'\x89HDF\r\n\x1a\n'
_LEAF_K = 4            # symbol-table node holds up to 2K entries
_INTERNAL_K = 16       # B-tree node holds up to 2K children
_GCOL_SIZE = 4096      # the smallest global heap collection


def _pad8(b):
    return b + b'\0' * (-len(b) % 8)


def _datatype(dtype):
    """Datatype message body of a numpy dtype."""
    dtype = np.dtype(dtype)
    if dtype.byteorder == '>':
        raise ValueError('big-endian data is not supported')
    if dtype.kind == 'b':
        base = struct.pack('<BBBBIHH', 0x10, 0x08, 0, 0, 1, 0, 8)
        return (struct.pack('<BBBBI', 0x18, 2, 0, 0, 1) + base
                + _pad8(b'FALSE\0') + _pad8(b'TRUE\0') + b'\x00\x01')
    if dtype.kind in 'iu':
        return struct.pack('<BBBBIHH', 0x10, 0x08 if dtype.kind == 'i' else 0,
                           0, 0, dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == 'f' and dtype.itemsize in (4, 8):
        exp_size, mant_size = (8, 23) if dtype.itemsize == 4 else (11, 52)
        bits = 8 * dtype.itemsize
        return struct.pack('<BBBBIHHBBBBI', 0x11, 0x20, bits - 1, 0,
                           dtype.itemsize, 0, bits, mant_size, exp_size, 0,
                           mant_size, (1 << (exp_size - 1)) - 1)
    if dtype.kind == 'S' and dtype.itemsize > 0:
        # null-padded ASCII, numpy's convention
        return struct.pack('<BBBBI', 0x13, 0x01, 0, 0, dtype.itemsize)
    raise ValueError('unsupported dtype %s' % dtype)


# variable-length string: a sequence of 1-byte integers tagged as a string
_VLEN_STR = (struct.pack('<BBBBI', 0x19, 0x01, 0, 0, 16)
             + struct.pack('<BBBBIHH', 0x10, 0, 0, 0, 1, 0, 8))


def _dataspace(shape):
    return (struct.pack('<BBBBI', 1, len(shape), 0, 0, 0)
            + b''.join(struct.pack('<Q', n) for n in shape))


def _message(mtype, body, flags=0):
    body = _pad8(body)
    return struct.pack('<HHBBBB', mtype, len(body), flags, 0, 0, 0) + body


def _object_header(messages):
    data = b''.join(messages)
    return struct.pack('<BBHII', 1, 0, len(messages), 1, len(data)) \
        + b'\0' * 4 + data


class _Node:
    def __init__(self):
        self.attrs = {}


class Dataset(_Node):
    def __init__(self, data):
        super().__init__()
        self.data = np.array(data, order='C')   # keeps a 0-d shape
        _datatype(self.data.dtype)     # refuse early what cannot be written
        self.shape = self.data.shape


class Group(_Node):
    def __init__(self):
        super().__init__()
        self._children = {}

    def _descend(self, parts):
        obj = self
        for part in parts:
            child = obj._children.get(part)
            if child is None:
                child = obj._children[part] = Group()
            elif not isinstance(child, Group):
                raise ValueError('%r is a dataset, not a group' % part)
            obj = child
        return obj

    def create_group(self, path):
        parts = [p for p in path.split('/') if p]
        parent = self._descend(parts[:-1])
        if not parts or parts[-1] in parent._children:
            raise ValueError('cannot create group %r' % path)
        group = parent._children[parts[-1]] = Group()
        return group

    def create_dataset(self, path, data):
        parts = [p for p in path.split('/') if p]
        parent = self._descend(parts[:-1])
        if not parts or parts[-1] in parent._children:
            raise ValueError('cannot create dataset %r' % path)
        dataset = parent._children[parts[-1]] = Dataset(data)
        return dataset


class _Writer:
    """Serialises a tree of groups and datasets, children before parents
    (a parent's symbol table needs their addresses)."""

    def __init__(self):
        self.buf = bytearray(96)       # the superblock, filled in last
        # variable-length strings: (id(node), attribute name) -> index of
        # the object in the global heap collection at address 96
        self.vlen_index = {}

    def _append(self, data):
        self.buf += b'\0' * (-len(self.buf) % 8)
        addr = len(self.buf)
        self.buf += data
        return addr

    def _global_heap(self, root):
        """Collect every variable-length string attribute below `root`
        into one global heap collection, right after the superblock."""
        strings = []

        def collect(node):
            for name, value in node.attrs.items():
                if isinstance(value, (bytes, str)):
                    strings.append(value if isinstance(value, bytes)
                                   else value.encode('utf-8'))
                    self.vlen_index[(id(node), name)] = len(strings)
            if isinstance(node, Group):
                for child in node._children.values():
                    collect(child)

        collect(root)
        if not strings:
            return
        body = bytearray()
        for index, raw in enumerate(strings, 1):
            body += struct.pack('<HHIQ', index, 1, 0, len(raw)) + _pad8(raw)
        # header, objects, and the free-space object that ends them
        size = max(_GCOL_SIZE, 16 + len(body) + 16)
        body += struct.pack('<HHIQ', 0, 0, 0, size - 16 - len(body))
        gcol = b'GCOL' + struct.pack('<BBBBQ', 1, 0, 0, 0, size) + body
        self._append(gcol + b'\0' * (size - len(gcol)))

    def _attribute(self, node, name, value):
        name_b = name.encode('utf-8') + b'\0'
        if isinstance(value, (bytes, str)):
            raw = value if isinstance(value, bytes) else value.encode('utf-8')
            dtype, space = _VLEN_STR, _dataspace(())
            # length, address of the collection, index of the object
            data = struct.pack('<IQI', len(raw), 96,
                               self.vlen_index[(id(node), name)])
        else:
            arr = np.array(value, order='C')
            dtype, space = _datatype(arr.dtype), _dataspace(arr.shape)
            data = arr.tobytes()
        body = (struct.pack('<BBHHH', 1, 0, len(name_b), len(dtype),
                            len(space))
                + _pad8(name_b) + _pad8(dtype) + _pad8(space) + data)
        if len(body) > 0xFFF0:
            raise ValueError('attribute %r is too large' % name)
        return _message(0x0C, body)

    def _attributes(self, node):
        return [self._attribute(node, k, v) for k, v in node.attrs.items()]

    def dataset(self, node):
        raw = node.data.tobytes()
        addr = self._append(raw) if raw else _UNDEF
        messages = [
            _message(0x01, _dataspace(node.shape)),
            _message(0x03, _datatype(node.data.dtype), flags=1),
            # fill value: allocate late, write if set, none defined
            _message(0x05, struct.pack('<BBBBI', 2, 2, 2, 1, 0), flags=1),
            _message(0x08, struct.pack('<BBQQ', 3, 1, addr, len(raw))),
        ] + self._attributes(node)
        return self._append(_object_header(messages))

    def group(self, node):
        """Write a group; returns (header, B-tree, heap) addresses."""
        names = sorted(node._children, key=lambda n: n.encode('utf-8'))
        addrs = {}
        for name in names:
            child = node._children[name]
            addrs[name] = (self.group(child)[0] if isinstance(child, Group)
                           else self.dataset(child))
        # local heap: the empty name at offset 0, then every link name
        heap_data = bytearray(8)
        offsets = {}
        for name in names:
            offsets[name] = len(heap_data)
            heap_data += _pad8(name.encode('utf-8') + b'\0')
        data_addr = self._append(bytes(heap_data))
        heap_addr = self._append(
            b'HEAP' + struct.pack('<BBBBQQQ', 0, 0, 0, 0, len(heap_data),
                                  1, data_addr))   # 1: no free block
        # symbol-table nodes of up to 2K entries each, in name order
        per = 2 * _LEAF_K
        chunks = [names[i:i + per] for i in range(0, len(names), per)]
        if len(chunks) > 2 * _INTERNAL_K:
            raise ValueError('more than %d links in one group'
                             % (per * 2 * _INTERNAL_K))
        keys, snods = [0], []
        for chunk in chunks:
            node_b = bytearray(b'SNOD' + struct.pack('<BBH', 1, 0,
                                                     len(chunk)))
            for name in chunk:
                node_b += struct.pack('<QQII16x', offsets[name],
                                      addrs[name], 0, 0)
            node_b += b'\0' * (8 + per * 40 - len(node_b))
            snods.append(self._append(bytes(node_b)))
            keys.append(offsets[chunk[-1]])
        tree = bytearray(b'TREE' + struct.pack('<BBHQQ', 0, 0, len(snods),
                                               _UNDEF, _UNDEF))
        for key, child in zip(keys, snods):
            tree += struct.pack('<QQ', key, child)
        tree += struct.pack('<Q', keys[-1])
        tree += b'\0' * (24 + 2 * _INTERNAL_K * 8
                         + (2 * _INTERNAL_K + 1) * 8 - len(tree))
        tree_addr = self._append(bytes(tree))
        messages = [_message(0x11, struct.pack('<QQ', tree_addr, heap_addr))]
        messages += self._attributes(node)
        return self._append(_object_header(messages)), tree_addr, heap_addr

    def write(self, root):
        self._global_heap(root)
        header, tree, heap = self.group(root)
        self.buf[:96] = (
            _SIGNATURE + struct.pack('<BBBBBBBB', 0, 0, 0, 0, 0, 8, 8, 0)
            + struct.pack('<HHI', _LEAF_K, _INTERNAL_K, 0)
            + struct.pack('<QQQQ', 0, _UNDEF, len(self.buf), _UNDEF)
            + struct.pack('<QQII', 0, header, 1, 0)
            + struct.pack('<QQ', tree, heap))
        return bytes(self.buf)


class File(Group):
    """Create an HDF5 file; it is written when the file is closed."""

    def __init__(self, filename, mode='w'):
        if mode != 'w':
            raise ValueError('write-only')
        super().__init__()
        self._filename = filename

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()

    def close(self):
        if self._filename is None:
            return
        data = _Writer().write(self)
        with open(self._filename, 'wb') as f:
            f.write(data)
        self._filename = None
