"""Read the msgpack that ``flax.serialization.to_bytes`` writes.

eve_tpu's older checkpoints hold the optimizer state as
``optimizer_0.msgpack``: flax's state dict of the optax state, packed by
``msgpack`` with flax's extension types. This is a decoder of that subset
in pure Python and numpy, so the port reads such a file without the
``msgpack`` package:

- nil, bool, the integer and float formats, str, bin, array and map (a map
  key may arrive as str or as bin; both become str);
- ext 1, an ndarray packed as ``(shape, dtype name, C-order bytes)``, and
  ext 3, a numpy scalar in the same form;
- flax's chunked arrays, ``{'__msgpack_chunked_array__': True, 'shape':
  {'0': ...}, 'chunks': {'0': ...}}``, joined back into one array;
- the dtype name ``'bfloat16'`` (numpy has no such type): its uint16 bits
  viewed as a ``torch.bfloat16`` tensor.

Anything else (another ext type, the reserved byte 0xc1, a truncated
buffer) raises ``ValueError`` naming the type byte and its offset.
``train.checkpoint.flatten_tree`` flattens the decoded tree as eve_tpu's
``flatten_tree`` does.
"""

import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = '__msgpack_chunked_array__'

# Fixed-size formats: type byte -> struct format.
_FIXED = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
          0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# Formats with a length of 1, 2 or 4 bytes: type byte -> (kind, length).
_SIZED = {0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
          0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I'),
          0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
          0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
          0xde: ('map', '>H'), 0xdf: ('map', '>I')}
# fixext 1, 2, 4, 8 and 16: type byte -> data length.
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """One pass over a msgpack buffer."""

    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n, what):
        end = self.pos + n
        if end > len(self.data):
            raise ValueError('msgpack: %s at offset %d runs past the end of '
                             'the %d-byte buffer' % (what, self.pos,
                                                     len(self.data)))
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt, what):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt), what))[0]

    def value(self):
        at = self.pos
        byte = self.take(1, 'a type byte')[0]
        what = 'type byte 0x%02x' % byte
        if byte <= 0x7f:
            return byte
        if byte >= 0xe0:
            return byte - 0x100
        if 0x80 <= byte <= 0x8f:
            return self.map(byte & 0x0f)
        if 0x90 <= byte <= 0x9f:
            return [self.value() for _ in range(byte & 0x0f)]
        if 0xa0 <= byte <= 0xbf:
            return self.str(byte & 0x1f, what)
        if byte == 0xc0:
            return None
        if byte in (0xc2, 0xc3):
            return byte == 0xc3
        if byte in _FIXED:
            return self.unpack(_FIXED[byte], what)
        if byte in _SIZED:
            kind, fmt = _SIZED[byte]
            n = self.unpack(fmt, what)
            if kind == 'bin':
                return bytes(self.take(n, what))
            if kind == 'str':
                return self.str(n, what)
            if kind == 'array':
                return [self.value() for _ in range(n)]
            if kind == 'map':
                return self.map(n)
            return self.ext(n, byte, at)
        if byte in _FIXEXT:
            return self.ext(_FIXEXT[byte], byte, at)
        raise ValueError('msgpack: type byte 0x%02x at offset %d is not in '
                         'the subset flax writes' % (byte, at))

    def str(self, n, what):
        return bytes(self.take(n, what)).decode('utf-8')

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, bytes):
                key = key.decode('utf-8')
            out[key] = self.value()
        return out

    def ext(self, n, byte, at):
        code = self.unpack('>b', 'an ext type')
        data = self.take(n, 'ext %d' % code)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            array = _ndarray(data)
            return array if isinstance(array, torch.Tensor) else array[()]
        raise ValueError('msgpack: ext type %d (type byte 0x%02x at offset '
                         '%d) is not one of flax\'s ndarray (1) or numpy '
                         'scalar (3)' % (code, byte, at))


def _ndarray(data):
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    reader = _Reader(data)
    packed = reader.value()
    if not (isinstance(packed, list) and len(packed) == 3):
        raise ValueError('msgpack: an ndarray ext holds %r, not (shape, '
                         'dtype, bytes)' % (type(packed).__name__,))
    shape, name, buffer = packed
    if isinstance(name, bytes):
        name = name.decode('utf-8')
    if name == 'bfloat16':
        bits = np.frombuffer(buffer, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape, order='C')


def _unchunk(tree):
    """Join flax's chunked arrays (``_unchunk_array_leaves_in_place``)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data):
    """The object ``flax.serialization.msgpack_restore`` makes of ``data``
    (numpy arrays and scalars, dicts with str keys)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError('msgpack: %d bytes after the value'
                         % (len(reader.data) - reader.pos))
    return _unchunk(out)

