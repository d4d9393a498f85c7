"""The port's legacy pax output path against wfsim_tpu's: the pax data
model's ``to_dict`` / ``to_json`` (identical), ``PaxEventSimulator``
writing its zip archives and truth csv, and the legacy pulse generator
``RawData.__call__`` yielding wfsim_tpu's pulse tuples over the same
window records (both generators given one fixed ``iter_windows``), and
reassembling a small run's records exactly.
"""
import os
import pickle
import types
import zipfile
import zlib

import numpy as np
import pytest

from wfsim_tpu import pax_datastructure as jax_pax
from wfsim_tpu.pipeline.rawdata import RawDataTPU

from wfsim_tpu_torch import pax_datastructure as pax
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.dtypes import raw_record_dtype
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.interface.pax import PaxEventSimulator
from wfsim_tpu_torch.pipeline.rawdata import RawData


def event_of(mod):
    rng = np.random.default_rng(2)
    pulses = [mod.Pulse(channel=int(c), left=int(l),
                        raw_data=rng.integers(0, 16000, n).astype(np.int16))
              for c, l, n in ((3, 100, 7), (40, 90, 220), (3, 400, 1))]
    return mod.Event(event_number=5, start_time=np.int64(1000),
                     stop_time=2_000_000, n_channels=248,
                     sample_duration=10, pulses=pulses,
                     peaks=[mod.Peak(left=2, right=9, area=np.float32(3.5))],
                     interactions=[mod.Interaction()],
                     trigger_signals=[mod.TriggerSignal()])


@pytest.mark.parametrize('name', list(pax.__all__))
def test_pax_model_equal_wfsim_tpu(name):
    """Every model class: the same fields, defaults and coercions, so the
    dict and JSON forms of an event (and of a bare instance) are equal."""
    assert pax.__all__ == jax_pax.__all__
    ours, theirs = getattr(pax, name), getattr(jax_pax, name)
    assert ours._fields() == theirs._fields()
    if name == 'Event':
        a, b = event_of(pax), event_of(jax_pax)
        assert a.length() == b.length() == (2_000_000 - 1000) // 10
        assert [p.length for p in a.pulses] == [7, 220, 1]
    elif name == 'Model':
        return
    else:
        a, b = ours(), theirs()
    assert a.to_json() == b.to_json()
    da, db = a.to_dict(), b.to_dict()
    assert da.keys() == db.keys()
    assert repr(da) == repr(db)


def test_pax_event_simulator_writes_zip_and_truth(tmp_path):
    """PaxEventSimulator on the CPU twins: three one-event chunks of
    XENON1T events into zip archives of two events and one truth csv."""
    pytest.importorskip('pandas')
    cfg = dict(detector='XENON1T', n_chunk=3, event_rate=1, chunk_size=1,
               output_name=str(tmp_path), run_number=123, events_per_file=2,
               seed=11)
    sim = PaxEventSimulator(cfg, device='cpu')
    assert sim.pax_event.rawdata.device.type == 'cpu'
    sim.compute()
    outdir = os.path.join(str(tmp_path), 'XENON1T_MC_123')
    files = sorted(os.listdir(outdir))
    zips = [f for f in files if f.endswith('.zip')]
    csvs = [f for f in files if f.endswith('.csv')]
    assert len(zips) == 2 and csvs == ['XENON1T-123-truth.csv']
    events = []
    for z in zips:
        with zipfile.ZipFile(os.path.join(outdir, z)) as zf:
            events += [pickle.loads(zlib.decompress(zf.read(n)))
                       for n in zf.namelist()]
    assert [e.event_number for e in events] == [0, 1, 2]
    for event in events:
        assert isinstance(event, pax.Event) and len(event.pulses) > 0
        assert event.stop_time > event.start_time
        p = event.pulses[0]
        assert p.raw_data.dtype == np.int16 and p.length == len(p.raw_data)
        assert max(q.channel for q in event.pulses) < 248
    import pandas as pd
    truth = pd.read_csv(os.path.join(outdir, csvs[0]))
    assert len(truth) == len(sim.instructions)
    assert 'fill' not in truth.columns


def window_records():
    """Three windows of records as the digitizer packs them: time-sorted
    across channels, pulses of one to three records (the last one
    partial), one window without records."""
    rng = np.random.default_rng(8)
    wins = []
    for w, n_pulse in enumerate((6, 0, 9)):
        recs = []
        for _ in range(n_pulse):
            ch = int(rng.integers(0, 494))
            left = 10_000 * (w + 1) + int(rng.integers(0, 300))
            plen = int(rng.integers(1, 300))
            nrec = -(-plen // 110)
            r = np.zeros(nrec, raw_record_dtype(110))
            r['channel'] = ch
            r['pulse_length'] = plen
            r['record_i'] = np.arange(nrec)
            r['time'] = (left + 110 * np.arange(nrec)) * 10
            r['length'] = np.minimum(110, plen - 110 * np.arange(nrec))
            r['dt'] = 10
            for i in range(nrec):
                r['data'][i, :r['length'][i]] = rng.integers(
                    15000, 16001, r['length'][i])
            recs.append(r)
        recs = (np.concatenate(recs) if recs
                else np.zeros(0, raw_record_dtype(110)))
        recs = recs[np.lexsort((recs['channel'], recs['time']))]
        wins.append(dict(win_left=0, win_right=1, flush=True, records=recs))
    return wins


def test_legacy_pulses_equal_wfsim_tpu():
    """Both packages' ``__call__`` over the same windows (their
    ``iter_windows`` replaced by one that yields them): the same
    (channel, left, right, data) tuples in the same order."""
    wins = window_records()

    def fake():
        return types.SimpleNamespace(
            iter_windows=lambda inst, tb, **kw: iter(wins),
            const=types.SimpleNamespace(sample_duration=10))
    ours = list(RawData.__call__(fake(), None, []))
    theirs = list(RawDataTPU.__call__(fake(), None, []))
    assert len(ours) == len(theirs) == 15
    for a, b in zip(ours, theirs):
        assert a[:3] == b[:3]
        assert a[3].dtype == b[3].dtype == np.int16
        np.testing.assert_array_equal(a[3], b[3])
        assert a[2] - a[1] + 1 == len(a[3])


def test_legacy_pulses_reassemble_the_records():
    """A small run's pulses from ``__call__`` cut back into 110-sample
    records give the records of the same run through ``iter_windows``,
    and the generator keeps the least event number of each window."""
    cfg = default_config(seed=5)
    inst = bench_instructions(3, 300, 30)
    recs = np.concatenate([w['records'] for w in
                           RawData(cfg, device='cpu').iter_windows(inst)])
    rd = RawData(cfg, device='cpu')
    truth = []
    pulses, events = [], []
    for p in rd(inst, truth):
        pulses.append(p)
        events.append(rd.instruction_event_number)
    assert len(truth) == len(inst)
    assert sorted(set(events)) == [0, 1, 2]
    rebuilt = []
    for ch, left, right, data in pulses:
        n = right - left + 1
        for i in range(-(-n // 110)):
            seg = data[110 * i:110 * (i + 1)]
            rebuilt.append((ch, (left + 110 * i) * 10, len(seg), n, i,
                            np.pad(seg, (0, 110 - len(seg))).tobytes()))
    want = [(int(r['channel']), int(r['time']), int(r['length']),
             int(r['pulse_length']), int(r['record_i']), r['data'].tobytes())
            for r in recs]
    assert sorted(rebuilt) == sorted(want)
