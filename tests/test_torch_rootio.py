"""The port's GEANT4/ROOT reader (``wfsim_tpu_torch.resources.rootio``, a
copy of wfsim_tpu's).  The first three tests are tests/test_rootio.py's on
the GEANT4 fixture of the reference and skip without it.  The others
write a small file in the subset of the ROOT layout the reader decodes
(a key walk with a freed gap, flat and ``std::vector`` branches, plain and
ZLIB baskets, two baskets a branch) and hold both packages' readers, and
``read_optical`` through them, to the arrays written.
"""
import os
import struct
import zlib

import numpy as np
import pytest

from wfsim_tpu.resources import rootio as jax_rootio

from wfsim_tpu_torch.resources import rootio

FIXTURE = '/root/reference/tests/geant_test_data_small.root'

needs_fixture = pytest.mark.skipif(not os.path.exists(FIXTURE),
                                   reason='reference GEANT4 fixture not '
                                          'present')


@needs_fixture
def test_rootio_reads_fixture_branches():
    events = rootio.open(FIXTURE).get('events')
    g4id = events['eventid'].array(library='np')
    np.testing.assert_array_equal(g4id, np.arange(10))

    ids = events['pmthitID'].array(library='np')
    times = events['pmthitTime'].array(library='np')
    energies = events['pmthitEnergy'].array(library='np')
    assert len(ids) == len(times) == len(energies) == 10
    n_hits = sum(len(a) for a in ids)
    assert n_hits > 100
    for a, b, c in zip(ids, times, energies):
        assert len(a) == len(b) == len(c)
        assert a.dtype.kind == 'i'
        assert b.dtype.kind == 'f' and b.dtype.itemsize == 8
        assert c.dtype.kind == 'f' and c.dtype.itemsize == 4
    all_ids = np.hstack(ids)
    assert (all_ids >= 2000).mean() > 0.9
    all_e = np.hstack(energies)
    assert 0.5 < np.median(all_e) < 20.0
    all_t = np.hstack(times)
    assert np.all(np.isfinite(all_t)) and all_t.min() >= 0
    xp = events['xp_pri'].array(library='np')
    assert xp.dtype.kind == 'f' and xp.dtype.itemsize == 4 and len(xp) == 10


@needs_fixture
def test_rootio_matches_uproot_if_available():
    uproot = pytest.importorskip('uproot')
    a = rootio.open(FIXTURE).get('events')
    b = uproot.open(FIXTURE).get('events')
    for name in ('eventid', 'xp_pri'):
        np.testing.assert_array_equal(a[name].array(library='np'),
                                      b[name].array(library='np'))
    for name in ('pmthitID', 'pmthitTime'):
        aa = a[name].array(library='np')
        bb = b[name].array(library='np')
        assert len(aa) == len(bb)
        for x, y in zip(aa, bb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@needs_fixture
def test_read_optical_geant4_to_records_end_to_end():
    """read_optical on the fixture, then the nVeto optical chain on the
    CPU twins."""
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.dtypes import optical_extra_dtype
    from wfsim_tpu_torch.interface.instructions import read_optical
    from wfsim_tpu_torch.pipeline.chunker import ChunkRawRecords
    from wfsim_tpu_torch.pipeline.optical import RawDataOptical

    c = default_config(detector='XENONnT_neutron_veto')
    c['fax_file'] = FIXTURE
    c['seed'] = 4
    c['chunk_size'] = 1000
    c['_truth_extra_instruction_dtype'] = optical_extra_dtype
    ins, channels, timings = read_optical(c)
    assert len(ins) >= 10
    assert int((ins['_last'] - ins['_first']).sum()) == len(channels)
    assert channels.min() >= 0 and channels.max() < 120
    sim = ChunkRawRecords(c, device='cpu', rawdata_generator=RawDataOptical,
                          channels=channels, timings=timings)
    outs = list(sim(ins))
    rr = np.concatenate([o['raw_records'] for o in outs])
    truth = np.concatenate([o['truth'] for o in outs])
    assert len(rr) > 0 and len(truth) >= 10
    assert truth['n_photon'].sum() > 0 and rr['channel'].max() < 120


# ---------------------------------------------------------------------------
# a file written here


def tstring(s):
    b = s.encode('latin1')
    return bytes([len(b)]) + b


def key_length(classname, name, title, basket):
    """The key header (4 + 14 bytes, two 32-bit seeks, three strings) and,
    for a TBasket, its 19-byte basket header."""
    return 26 + len(tstring(classname) + tstring(name) + tstring(title)) \
        + (19 if basket else 0)


def key_record(classname, name, title, payload, *, basket=None, zipped=False):
    """One key record: the key header (version 4, 32-bit seeks), for a
    TBasket (``basket`` = (entries, bytes of entry data)) the basket
    header, then the object bytes, ZLIB-compressed in two ``ZL`` blocks
    where ``zipped``."""
    keylen = key_length(classname, name, title, basket)
    extra = b''
    if basket is not None:
        nevbuf, border = basket
        extra = struct.pack('>hiiii', 3, 32000, 4, nevbuf, keylen + border) \
            + b'\x00'
    body = payload
    if zipped:
        half = len(payload) // 2
        body = b''
        for part in (payload[:half], payload[half:]):
            c = zlib.compress(part)
            body += b'ZL\x08' + len(c).to_bytes(3, 'little') \
                + len(part).to_bytes(3, 'little') + c
    head = struct.pack('>i', keylen + len(body)) + struct.pack(
        '>hiIhh', 4, len(payload), 0, keylen, 1) + struct.pack('>ii', 0, 0)
    return head + tstring(classname) + tstring(name) + tstring(title) \
        + extra + body


def jagged_basket(name, entries, dtype, zipped):
    """``std::vector`` entries (a 10-byte header each), then the offset
    table the reader finds past the entry data."""
    data = b''
    offs = []
    for e in entries:
        offs.append(len(data))
        arr = np.asarray(e, dtype)
        data += struct.pack('>ihi', 0x40000000 | (6 + arr.nbytes), 9,
                            len(arr)) + arr.tobytes()
    keylen = key_length('TBasket', name, 'events', True)
    table = struct.pack('>i', len(entries) + 1) + np.asarray(
        [o + keylen for o in offs], '>i4').tobytes()
    return key_record('TBasket', name, 'events', data + table,
                      basket=(len(entries), len(data)), zipped=zipped)


def flat_basket(name, values, dtype, zipped):
    data = np.asarray(values, dtype).tobytes()
    return key_record('TBasket', name, 'events', data,
                      basket=(len(values), len(data)), zipped=zipped)


BRANCHES = (('eventid', 'flat', '>i4'), ('pmthitID', 'vector', '>i4'),
            ('pmthitTime', 'vector', '>f8'), ('pmthitEnergy', 'vector', '>f4'),
            ('xp_pri', 'flat', '>f4'), ('yp_pri', 'flat', '>f4'),
            ('zp_pri', 'flat', '>f4'))


def write_root(path, n_events=9, seed=1):
    """A small GEANT4-like ``events`` tree in the subset of the ROOT
    layout the reader decodes; returns {branch: the values written}."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(40, n_events)
    n[3] = 0
    vals = dict(
        eventid=np.arange(n_events, dtype=np.int32),
        pmthitID=[rng.integers(2000, 2120, k).astype(np.int32) for k in n],
        pmthitTime=[rng.exponential(2e-7, k) for k in n],
        pmthitEnergy=[rng.uniform(2.0, 4.1, k).astype(np.float32) for k in n],
        xp_pri=rng.uniform(-600, 600, n_events).astype(np.float32),
        yp_pri=rng.uniform(-600, 600, n_events).astype(np.float32),
        zp_pri=rng.uniform(-1400, 0, n_events).astype(np.float32))
    meta = b'TTree events'
    for name, kind, dt in BRANCHES:
        meta += b'\x00' + name.encode() + (
            b'/' + {'>i4': b'I', '>f4': b'F'}[dt] if kind == 'flat' else
            b'\x00' + {'>i4': b'vector<int>', '>f8': b'vector<double>',
                       '>f4': b'vector<float>'}[dt])
    records = [key_record('TTree', 'events', 'GEANT4 events', meta,
                          zipped=True),
               struct.pack('>i', -16) + b'\x00' * 12]        # a freed gap
    cut = n_events // 2
    for part, (lo, hi) in enumerate(((0, cut), (cut, n_events))):
        for name, kind, dt in BRANCHES:
            zipped = (part + len(name)) % 2 == 0
            make = flat_basket if kind == 'flat' else jagged_basket
            records.append(make(name, vals[name][lo:hi], dt, zipped))
    begin = 100
    body = b''.join(records)
    head = b'root' + struct.pack('>iii', 62206, begin, begin + len(body))
    with open(path, 'wb') as f:
        f.write(head.ljust(begin, b'\x00') + body)
    return vals


@pytest.mark.parametrize('mod', [rootio, jax_rootio],
                         ids=['port', 'wfsim_tpu'])
def test_rootio_reads_written_file(mod, tmp_path):
    """Both readers give back every branch written, with the element
    dtypes of the file, jagged branches as object arrays."""
    path = tmp_path / 'g4.root'
    vals = write_root(path)
    f = mod.open(str(path))
    assert f.keys() == ['events']
    events = f.get('events')
    assert sorted(events.keys()) == sorted(b[0] for b in BRANCHES)
    for name, kind, dt in BRANCHES:
        got = events[name].array(library='np')
        if kind == 'flat':
            assert got.dtype.str[1:] == np.dtype(dt).str[1:]
            np.testing.assert_array_equal(got, vals[name])
            continue
        assert got.dtype == object and len(got) == len(vals[name])
        for a, b in zip(got, vals[name]):
            assert a.dtype.str[1:] == np.dtype(dt).str[1:]
            np.testing.assert_array_equal(a, b)
    with pytest.raises(AttributeError):
        f.get('no_such_tree')


def test_read_optical_through_rootio_equal_wfsim_tpu(tmp_path, monkeypatch):
    """read_optical of both packages on the written file through their
    own rootio (no uproot): identical instructions, channels, timings."""
    import sys
    from wfsim_tpu.config import default_config as jax_default_config
    from wfsim_tpu.interface.instructions import read_optical as jax_read
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.interface.instructions import read_optical
    monkeypatch.setitem(sys.modules, 'uproot', None)     # import fails
    path = str(tmp_path / 'g4.root')
    vals = write_root(path, n_events=12, seed=3)
    out = []
    for make, read in ((default_config, read_optical),
                       (jax_default_config, jax_read)):
        c = make(detector='XENONnT_neutron_veto', seed=2)
        c['fax_file'] = path
        out.append(read(c) + (c['entry_stop'],))
    (ins, ch, t, stop), (ins_j, ch_j, t_j, stop_j) = out
    assert ins.tobytes() == ins_j.tobytes() and ins.dtype == ins_j.dtype
    np.testing.assert_array_equal(ch, ch_j)
    np.testing.assert_array_equal(t, t_j)
    assert stop == stop_j == 12
    # no QE table: every hit kept, channels from 0
    assert len(ch) == sum(len(x) for x in vals['pmthitID'])
    np.testing.assert_array_equal(np.sort(ch), np.sort(
        np.concatenate(vals['pmthitID']) - 2000))
