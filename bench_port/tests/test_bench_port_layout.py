"""BENCHMARK.json and the files it names: the contract's shapes, and
configurations, mixes and metric readers found by name."""
import json
import re
from pathlib import Path

import pytest

from bench_port import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = dict(configs={'name', 'source', 'file', 'reduced', 'why'},
            workloads={'name', 'config', 'traffic', 'chips', 'why'},
            end_to_end={'name', 'unit', 'better', 'bound', 'source'},
            per_layer={'name', 'unit', 'better', 'source', 'layer',
                       'moves'})


def short_line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and '\n' not in text and '\t' not in text)


def test_top_level():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= BENCH['run_seconds'] <= 51
    assert BENCH['paths'] == ['bench_port']
    assert len(BENCH['command']) <= 32
    assert all(short_line(w) for w in BENCH['command'])
    assert (ROOT / BENCH['command'][1]).is_file()


@pytest.mark.parametrize('group', sorted(KEYS))
def test_entries_names_and_units(group):
    entries = BENCH[group]
    assert 1 <= len(entries)
    names = [e['name'] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = ({'workloads'} if group in ('end_to_end', 'per_layer')
                 else set())
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.match(e['name']), e['name']
        for key in ('why', 'layer', 'source'):
            if key in e:
                assert short_line(e[key]), (e['name'], key)
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        if group == 'configs':
            assert len(e['reduced']) <= 16
            assert all(NAME.match(k) for k in e['reduced'])
        if group == 'workloads':
            assert NAME.match(e['config']) and NAME.match(e['traffic'])
            assert e['chips'] in (1, 4)


def test_metrics_bounds_and_sources():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    cells = {w['name'] for w in BENCH['workloads']}
    for m in BENCH['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert m['moves'] in e2e
        moved = e2e[m['moves']]
        for cell in m.get('workloads', cells):
            assert cell in cells
            assert cell in moved.get('workloads', cells)
    for cell in cells:
        reported = [m for m in BENCH['end_to_end']
                    if cell in m.get('workloads', cells)]
        assert 'setup_s' in [m['name'] for m in reported]
        assert len(reported) >= 2
        assert harness.metric_names(BENCH, cell, True)


def test_every_name_is_found():
    for c in BENCH['configs']:
        assert c['file'].startswith('bench_port/')
        conf = harness.config_file(BENCH, c['name'])
        assert conf['source'] and conf['reduced'] == c['reduced']
    for w in BENCH['workloads']:
        harness.cell_of(BENCH, w['name'])
        traffic.load_mix(w['traffic'])
        assert w['config'] in {c['name'] for c in BENCH['configs']}
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert callable(harness.reader(m['name']))
    with pytest.raises(KeyError):
        harness.cell_of(BENCH, 'no.such_cell')
    with pytest.raises(FileNotFoundError):
        harness.reader('no_such_metric')


def test_a_new_file_is_picked_up(tmp_path, monkeypatch):
    # a new mix: a file beside the others
    mixes = tmp_path / 'traffic'
    mixes.mkdir()
    for f in traffic.TRAFFIC_DIR.glob('*.json'):
        (mixes / f.name).write_text(f.read_text())
    mix = json.loads((mixes / 'er_1_100kev.json').read_text())
    mix['energy_kev'] = [5.0, 6.0]
    (mixes / 'er_5_6kev.json').write_text(json.dumps(mix))
    monkeypatch.setattr(traffic, 'TRAFFIC_DIR', mixes)
    inst = traffic.instructions(traffic.load_mix('er_5_6kev'), 1,
                                tpc_radius=50.0, tpc_length=97.0,
                                drift_field=82.0, n_events=64)
    assert inst['e_dep'].min() >= 5.0 and inst['e_dep'].max() <= 6.0
    # a new metric: a reader file beside the others
    readers = tmp_path / 'metrics'
    readers.mkdir()
    (readers / 'records.per_event.py').write_text(
        'def read(ctx):\n    return ctx["records"] / ctx["events"]\n')
    read = harness.reader('records.per_event', readers)
    assert read(dict(records=10, events=4)) == 2.5
    # a new configuration and cell: entries naming their files
    conf = json.loads((ROOT / 'bench_port/configs/xenonnt_realistic.json')
                      .read_text())
    conf['overrides']['enable_noise'] = False
    path = tmp_path / 'xenonnt_quiet.json'
    path.write_text(json.dumps(conf))
    bench = json.loads(json.dumps(BENCH))
    bench['configs'].append(dict(name='xenonnt_quiet', source='x',
                                 file=str(path), reduced=[], why='x'))
    bench['workloads'].append(dict(name='nt_quiet.er', config='xenonnt_quiet',
                                   traffic='er_5_6kev', chips=1, why='x'))
    bench['per_layer'].append(dict(
        name='records.per_event', unit='records/event', better='lower',
        source='program_counter', layer='record collection',
        moves='events_per_s', workloads=['nt_quiet.er']))
    assert not harness.config_file(bench, 'xenonnt_quiet')['overrides'][
        'enable_noise']
    assert harness.cell_of(bench, 'nt_quiet.er')['traffic'] == 'er_5_6kev'
    assert 'records.per_event' in [
        m['name'] for m in harness.metric_names(bench, 'nt_quiet.er', True)]
    assert 'records.per_event' not in [
        m['name'] for m in harness.metric_names(bench, 'nt_he_grid.er',
                                                True)]
