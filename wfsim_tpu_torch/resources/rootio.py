"""Minimal pure-python ROOT (CERN) file reader for GEANT4 optical input
(a copy of wfsim_tpu/resources/rootio.py).

The reference reads its optical Monte-Carlo photon lists with ``uproot``
(reference: wfsim/strax_interface.py:285-333); that package is not available
in every deployment, so this module implements the small subset of the ROOT
binary format those files actually use:

- sequential TKey walk of the file's record stream (TFile layout, small-file
  32-bit seeks and the 64-bit variant),
- ZLIB-compressed object payloads (multi-block, 9-byte ``ZL`` headers),
- TBasket decoding for (a) flat leaf-list branches (``name/I``-style titles,
  fixed-width big-endian elements) and (b) ``std::vector<T>`` element
  branches (per-entry 10-byte {bytecount, version, count} headers plus the
  basket's entry-offset table),
- branch dtype discovery by scanning the (decompressed) TTree metadata
  buffer for leaf-list titles and ``vector<T>`` class strings — a deliberate
  shortcut around the full TStreamerInfo machinery, sufficient for the flat
  ntuple trees GEANT4 writes.

API mirrors the sliver of uproot the optical path touches::

    events = rootio.open(path).get('events')
    ids = events['pmthitID'].array(library='np')   # object array of arrays

Anything outside this subset (other compression algorithms, split
branches, nested collections) raises with a clear message.
"""
from __future__ import annotations

import re
import struct
import zlib

import numpy as np

__all__ = ['open', 'RootFile']

_LEAF_DTYPES = {
    'B': '>i1', 'b': '>u1', 'S': '>i2', 's': '>u2',
    'I': '>i4', 'i': '>u4', 'L': '>i8', 'l': '>u8',
    'F': '>f4', 'D': '>f8', 'O': '>u1',
}
_VECTOR_DTYPES = {
    b'vector<int>': '>i4', b'vector<unsigned int>': '>u4',
    b'vector<float>': '>f4', b'vector<double>': '>f8',
    b'vector<long>': '>i8', b'vector<short>': '>i2',
}


def _tstring(buf, p):
    n = buf[p]
    if n == 255:
        n, = struct.unpack('>i', buf[p + 1:p + 5])
        p += 4
    return buf[p + 1:p + 1 + n], p + 1 + n


class _Key:
    __slots__ = ('pos', 'nbytes', 'objlen', 'keylen', 'classname', 'name',
                 'title', 'strend')

    def __init__(self, data, pos):
        self.pos = pos
        self.nbytes, = struct.unpack('>i', data[pos:pos + 4])
        kv, self.objlen, _datime, self.keylen, _cycle = struct.unpack(
            '>h i I h h', data[pos + 4:pos + 18])
        p = pos + 18 + (16 if kv > 1000 else 8)
        cls, p = _tstring(data, p)
        nm, p = _tstring(data, p)
        ti, p = _tstring(data, p)
        self.classname = cls.decode('latin1')
        self.name = nm.decode('latin1')
        self.title = ti.decode('latin1')
        self.strend = p

    def payload(self, data):
        """Decompressed object bytes."""
        raw = data[self.pos + self.keylen:self.pos + self.nbytes]
        if self.objlen == self.nbytes - self.keylen:
            return raw
        out = bytearray()
        q = 0
        while len(out) < self.objlen and q + 9 <= len(raw):
            algo = raw[q:q + 2]
            csz = raw[q + 3] | raw[q + 4] << 8 | raw[q + 5] << 16
            if algo != b'ZL':
                raise NotImplementedError(
                    f'ROOT compression {algo!r} not supported '
                    '(only ZLIB); install uproot for this file')
            out += zlib.decompress(raw[q + 9:q + 9 + csz])
            q += 9 + csz
        return bytes(out)


class _Branch:
    def __init__(self, tree, name):
        self._tree = tree
        self.name = name

    def array(self, library='np'):
        if library != 'np':
            raise NotImplementedError('only library="np" is supported')
        return self._tree._read_branch(self.name)


class RootTree:
    """One TTree: branch dtypes scanned from the tree's metadata buffer,
    entries decoded straight from the branch's TBasket records."""

    def __init__(self, rootfile, tree_key):
        self._file = rootfile
        self.name = tree_key.name
        self._meta = tree_key.payload(rootfile._data)
        # baskets carry the branch name as key-name and the tree name as
        # key-title, in entry order along the file
        self._baskets = {}
        for k in rootfile._keys:
            if k.classname == 'TBasket' and k.title == self.name:
                self._baskets.setdefault(k.name, []).append(k)

    def keys(self):
        return list(self._baskets)

    def __getitem__(self, name):
        if name not in self._baskets:
            raise KeyError(name)
        return _Branch(self, name)

    get = __getitem__

    def _branch_dtype(self, name):
        """(dtype, jagged) from the TTree metadata buffer: a leaf-list title
        like b'name/I' marks a flat branch; otherwise the first
        ``vector<T>`` class string after the branch name's first occurrence
        gives the element type."""
        nm = name.encode('latin1')
        m = re.search(re.escape(nm) + rb'/([A-Za-z])\x40?', self._meta)
        if m and m.group(1).decode() in _LEAF_DTYPES:
            return np.dtype(_LEAF_DTYPES[m.group(1).decode()]), False
        first = self._meta.find(nm)
        if first >= 0:
            best = None
            for cls, dt in _VECTOR_DTYPES.items():
                p = self._meta.find(cls, first)
                if p >= 0 and (best is None or p < best[0]):
                    best = (p, dt)
            if best is not None:
                return np.dtype(best[1]), True
        raise NotImplementedError(
            f'cannot infer dtype of branch {name!r} (split or non-vector '
            'collection branch); install uproot for this file')

    def _read_branch(self, name):
        dtype, jagged = self._branch_dtype(name)
        flats, entries = [], []
        for k in self._baskets[name]:
            raw = k.payload(self._file._data)
            p = k.strend
            _ver, _bufsize, nev_bufsize, nevbuf, last = struct.unpack(
                '>h i i i i', self._file._data[p:p + 18])
            border = last - k.keylen
            if not jagged:
                flats.append(np.frombuffer(raw[:border], dtype))
                continue
            if border + 4 + 4 * nevbuf > len(raw):
                raise ValueError(f'basket of {name!r} has no offset table')
            offs = np.frombuffer(
                raw[border + 4:border + 4 + 4 * nevbuf], '>i4') - k.keylen
            bounds = np.append(offs, border)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                ent = raw[lo:hi]
                if len(ent) < 10:
                    entries.append(np.zeros(0, dtype))
                    continue
                # std::vector entry: 4-byte bytecount (kByteCountMask),
                # 2-byte version, 4-byte element count
                n, = struct.unpack('>i', ent[6:10])
                vals = np.frombuffer(ent[10:10 + n * dtype.itemsize], dtype)
                entries.append(np.ascontiguousarray(vals))
        if not jagged:
            return (np.concatenate(flats) if flats
                    else np.zeros(0, dtype))
        out = np.empty(len(entries), object)
        for i, e in enumerate(entries):
            out[i] = e
        return out


class RootFile:
    def __init__(self, path):
        import io
        with io.open(path, 'rb') as fh:
            self._data = fh.read()
        d = self._data
        if d[:4] != b'root':
            raise ValueError(f'{path}: not a ROOT file')
        version, begin = struct.unpack('>ii', d[4:12])
        if version >= 1000000:
            end, = struct.unpack('>q', d[12:20])
        else:
            end, = struct.unpack('>i', d[12:16])
        self._keys = []
        pos = begin
        while pos < min(end, len(d)) - 4:
            nb, = struct.unpack('>i', d[pos:pos + 4])
            if nb <= 0:           # freed record: skip the gap
                pos += (-nb) if nb < 0 else 4
                continue
            try:
                self._keys.append(_Key(d, pos))
            except Exception:
                break
            pos += nb

    def keys(self):
        return [k.name for k in self._keys if k.classname == 'TTree']

    def get(self, name):
        for k in self._keys:
            if k.classname == 'TTree' and k.name == name:
                return RootTree(self, k)
        raise AttributeError(f'no TTree named {name!r} in file')

    __getitem__ = get


def open(path) -> RootFile:   # noqa: A001 — mirrors uproot.open
    return RootFile(path)
