"""The port's strax plugin layer, executed against the vendored shim
(tests/strax_mock), as tests/test_strax_plugins.py does for wfsim_tpu's:
two- and three-chunk computes with strax's stream invariants, the sort
check, the context factories, ``RawRecordsFromMcChain`` with a stub
``epix`` and the nVeto target (``RawRecordsFromFaxnVeto``) reading an
in-memory GEANT4 tree through a stub ``uproot``.  The plugins run the
plain twins through their ``device`` class attribute set to ``'cpu'``.
"""
import importlib
import sys
import types

import numpy as np
import pytest

from wfsim_tpu_torch.config import default_config, CHANNEL_MAPS
from wfsim_tpu_torch.dtypes import instruction_dtype
from wfsim_tpu_torch.resources.synthetic import (synthetic_g4_file,
                                                 synthetic_nv_pmt_qe)

PLUGINS = ('SimulatorPlugin', 'RawRecordsFromFaxNT', 'RawRecordsFromFax1T',
           'RawRecordsFromFaxOpticalNT', 'RawRecordsFromMcChain',
           'RawRecordsFromFaxnVeto', 'RawRecordsFromMcChain1T')


@pytest.fixture
def sp():
    import tests.strax_mock.strax as strax_m
    import tests.strax_mock.straxen as straxen_m
    import tests.strax_mock.immutabledict as imm_m
    names = ('strax', 'straxen', 'immutabledict')
    saved = {k: sys.modules.get(k) for k in names}
    sys.modules['strax'] = strax_m
    sys.modules['straxen'] = straxen_m
    sys.modules['immutabledict'] = imm_m
    import wfsim_tpu_torch.interface.strax_plugins as m
    import wfsim_tpu_torch.interface.contexts as ctx
    importlib.reload(m)
    importlib.reload(ctx)
    assert m.HAVE_STRAX and ctx.HAVE_STRAX
    m.SimulatorPlugin.device = 'cpu'
    try:
        yield m
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        importlib.reload(m)
        importlib.reload(ctx)


def _base_config(**extra):
    from tests.strax_mock.immutabledict import immutabledict
    over = default_config()
    over['seed'] = 7
    # default_config() doubles as the fax JSON here, and set_config applies
    # it over the plugin options: pin the plugin-level knobs in it too
    over.update(event_rate=2, chunk_size=1, n_chunk=2)
    over.update({k: v for k, v in extra.items() if k in over})
    c = dict(
        detector='XENONnT',
        event_rate=2, chunk_size=1, n_chunk=2, seed=7,
        fax_config='no_such_fax_config.json',   # shim resolves to {}
        fax_config_override=over,
        channel_map=immutabledict(CHANNEL_MAPS['XENONnT']['channel_map']),
        n_tpc_pmts=494, n_top_pmts=253,
        gain_model_mc=np.full(494, 0.0085),
    )
    c.update(extra)
    return c


def test_plugin_surface_equal_wfsim_tpu(sp):
    """The same plugin names and, per plugin, the same strax options
    (names, defaults, tracking) as wfsim_tpu's under the same shim: the
    device is a class attribute, not an option, so lineage is unchanged."""
    import wfsim_tpu.interface.strax_plugins as jm
    importlib.reload(jm)
    try:
        assert jm.HAVE_STRAX
        assert sp.__all__ == jm.__all__
        for name in PLUGINS:
            a, b = getattr(sp, name), getattr(jm, name)
            assert a.provides == b.provides
            assert {k: (o.default, o.track) for k, o in a.takes_config.items()
                    } == {k: (o.default, o.track)
                          for k, o in b.takes_config.items()}, name
            assert 'device' not in a.takes_config
    finally:
        for k in ('strax', 'straxen', 'immutabledict'):
            sys.modules.pop(k, None)
        importlib.reload(jm)


def test_fax_nt_two_chunk_compute(sp):
    """RawRecordsFromFaxNT.setup() + a two-chunk compute loop."""
    p = sp.RawRecordsFromFaxNT(config=_base_config())
    p.setup()
    assert len(p.instructions) > 0
    assert p.sim.rawdata.device.type == 'cpu'

    n_records = 0
    starts = []
    for _ in range(2):
        out = p.compute()
        assert set(out) == set(p.provides)
        rr = out['raw_records']
        assert rr.data.dtype == p.dtype_for('raw_records')
        assert rr.end >= rr.start
        starts.append(rr.start)
        n_records += len(rr.data)
        truth = out['truth'].data
        assert truth.dtype == p.dtype_for('truth')
        if len(rr.data) > 1:
            assert np.diff(rr.data['time']).min() >= 0
    assert n_records > 0
    assert starts[1] > starts[0]
    assert p.source_finished()


def test_fax_nt_three_chunk_strax_invariants(sp):
    """strax's stream contracts over a 3-chunk run: per-chunk
    time-sortedness and >= 1 us spacing to the previous chunk, monotone
    chunk bounds containing their records, and no two records of one
    channel overlapping in time (check_raw_record_overlaps)."""
    cfg = _base_config()
    cfg['fax_config_override'] = dict(cfg['fax_config_override'],
                                      event_rate=3, chunk_size=1, n_chunk=3)
    cfg.update(event_rate=3, chunk_size=1, n_chunk=3)
    p = sp.RawRecordsFromFaxNT(config=cfg)
    p.setup()
    dt = 10                                   # XENONnT sample_duration

    last_chunk_end_time = None
    prev_chunk_end = None
    total = 0
    while not p.source_finished():
        out = p.compute()
        rr = out['raw_records']
        data = rr.data
        assert rr.end >= rr.start
        if prev_chunk_end is not None:
            assert rr.start >= prev_chunk_end
        prev_chunk_end = rr.end
        if not len(data):
            continue
        total += len(data)
        assert np.diff(data['time'].astype(np.int64)).min() >= 0
        if last_chunk_end_time is not None:
            assert int(data['time'][0]) >= last_chunk_end_time + 1000
        last_chunk_end_time = int(data['time'][-1])
        assert int(data['time'][0]) >= rr.start
        ends = data['time'].astype(np.int64) + \
            data['length'].astype(np.int64) * dt
        assert int(ends.max()) <= rr.end
        order = np.lexsort((data['time'], data['channel']))
        d = data[order]
        same_ch = d['channel'][1:] == d['channel'][:-1]
        prev_end = (d['time'].astype(np.int64)
                    + d['length'].astype(np.int64) * dt)[:-1]
        assert np.all(~same_ch | (d['time'][1:].astype(np.int64)
                                  >= prev_end))
    assert total > 0


def test_fax_nt_sort_check_rejects_unsorted(sp):
    p = sp.RawRecordsFromFaxNT(config=_base_config())
    p.setup()
    bad = np.zeros(2, dtype=p.dtype_for('raw_records'))
    bad['time'] = [10_000_000, 5_000_000]
    with pytest.raises(RuntimeError, match='non-sorted'):
        p._sort_check(bad)


def test_context_factories(sp, tmp_path):
    """Every context factory registers the port's plugins."""
    import wfsim_tpu_torch.interface.contexts as ctx

    st1 = ctx.xenon1t_simulation(output_folder=str(tmp_path))
    assert st1._plugin_class_registry['raw_records'] \
        is sp.RawRecordsFromFax1T
    assert st1.config['detector'] == 'XENON1T'

    st = ctx.xenonnt_simulation(output_folder=str(tmp_path),
                                cmt_run_id_sim='026000')
    for p in sp.RawRecordsFromFaxNT.provides:
        assert st._plugin_class_registry[p] is sp.RawRecordsFromFaxNT
    assert st.config['gain_model_mc'][:2] == ('cmt_run_id', '026000')
    assert set(st.config['fax_config_override_from_cmt']) == {
        'electron_lifetime_liquid', 'drift_velocity_liquid',
        'drift_time_gate'}
    st_div = ctx.xenonnt_simulation(output_folder=str(tmp_path),
                                    cmt_run_id_sim='026000',
                                    cmt_run_id_proc='027000')
    assert st_div.config['gain_model'][1] == '027000'
    assert st_div.config['gain_model_mc'][1] == '026000'
    with pytest.raises(RuntimeError, match='at least one CMT run id'):
        ctx.xenonnt_simulation(output_folder=str(tmp_path))

    st_nv = ctx.xenonnt_simulation(output_folder=str(tmp_path),
                                   wfsim_registry='RawRecordsFromFaxnVeto',
                                   cmt_run_id_sim='026000')
    assert st_nv._plugin_class_registry['raw_records_nv'] \
        is sp.RawRecordsFromFaxnVeto

    st_off = ctx.xenonnt_simulation_offline(
        output_folder=str(tmp_path), run_id='026000',
        global_version='global_v9', fax_config='fax.json')
    assert st_off.applied_cmt_version == 'global_v9'
    assert st_off._plugin_class_registry['truth'] is sp.RawRecordsFromFaxNT
    with pytest.raises(ValueError):
        ctx.xenonnt_simulation_offline(output_folder=str(tmp_path))


def test_mc_chain_with_stub_epix(sp):
    """RawRecordsFromMcChain (tpc target) driven by a stub epix module: the
    epix hand-off, the shared event clock (set_timing), the in-TPC checks
    and the lock-step compute with empty nVeto outputs."""
    n_ev = 4
    rng = np.random.default_rng(3)
    inst = np.zeros(2 * n_ev, dtype=instruction_dtype)
    inst['event_number'] = np.repeat(np.arange(n_ev), 2)
    inst['g4id'] = np.repeat(np.arange(n_ev), 2)
    inst['type'] = np.tile([1, 2], n_ev)
    inst['time'] = 0
    inst['x'] = np.repeat(rng.uniform(-30, 30, n_ev), 2)
    inst['y'] = np.repeat(rng.uniform(-30, 30, n_ev), 2)
    inst['z'] = np.repeat(rng.uniform(-80, -20, n_ev), 2)
    inst['amp'] = np.tile([300, 40], n_ev)
    inst['recoil'] = 7

    epix = types.ModuleType('epix')
    calls = {}

    def _main(cfg, return_wfsim_instructions=True):
        calls['config'] = cfg
        assert return_wfsim_instructions
        return inst.copy()

    epix.run_epix = types.SimpleNamespace(setup=lambda cfg: cfg, main=_main)
    sys.modules['epix'] = epix
    try:
        p = sp.RawRecordsFromMcChain(config=_base_config(
            targets=('tpc',), fax_file='stub.root', epix_config={},
            chunk_size=100, n_chunk=1))
        p.setup()
        assert calls['config']['input_file'] == 'stub.root'
        assert np.all(p.instructions_epix['time'] > 0)

        out = p.compute()
        assert set(out) == set(p.provides)
        assert len(out['raw_records'].data) > 0
        assert len(out['truth'].data) == 2 * n_ev
        assert len(out['raw_records_nv'].data) == 0
        assert len(out['truth_nv'].data) == 0
        assert p.source_finished()
    finally:
        sys.modules.pop('epix', None)


def nveto_plugin_config(n_events=12):
    """A RawRecordsFromFaxnVeto config over an in-memory GEANT4 tree: the
    nVeto's fax config (with a flat 30 % QE) as its override, 100 Hz."""
    nv = default_config(detector='XENONnT_neutron_veto', seed=7,
                        enable_pmt_afterpulses=True)
    nv['nv_pmt_qe'] = synthetic_nv_pmt_qe(range(2000, 2120))
    g4 = synthetic_g4_file(n_events, 5, first_channel=2000, n_channels=120,
                           mean_hits=600, tau_ns=200.0, tail_every=5)
    cfg = _base_config(targets=('nveto',), fax_file='stub.root',
                       fax_config_nveto='no_such_nveto_config.json',
                       fax_config_override_nveto=nv,
                       gain_model_nv=np.full(120, 0.0085),
                       event_rate=100, chunk_size=100, n_chunk=1)
    cfg['fax_config_override'] = dict(cfg['fax_config_override'],
                                      event_rate=100, chunk_size=100)
    return cfg, g4


def test_nveto_target_with_stub_reader(sp, monkeypatch):
    """RawRecordsFromFaxnVeto: read_optical through the stub ``uproot``
    (QE thinning, channels from 0), the event clock, the optical chain and
    the lock-step compute; ``raw_records_nv`` carries the nVeto's channel
    numbers (2000-2119) again and ``truth_nv`` one row per optical
    instruction with its kept photons."""
    cfg, g4 = nveto_plugin_config()
    monkeypatch.setitem(sys.modules, 'uproot',
                        types.SimpleNamespace(open=lambda path: g4))
    p = sp.RawRecordsFromFaxnVeto(config=cfg)
    p.setup()
    assert p.config_nveto['detector'] == 'XENONnT_neutron_veto'
    assert p.sim_nv.rawdata.device.type == 'cpu'
    ins = p.instructions_nveto
    assert len(ins) > 12                     # events 4 and 9 were split
    assert p.config['entry_start'] == 0 and p.config['entry_stop'] == 12
    assert np.all(np.diff(np.unique(ins['time'])) > 0)
    out = p.compute()
    assert set(out) == {'raw_records_nv', 'truth_nv'}
    rr, truth = out['raw_records_nv'].data, out['truth_nv'].data
    assert rr.dtype == p.dtype_for('raw_records_nv')
    assert truth.dtype == p.dtype_for('truth_nv')
    assert len(rr) > 0
    assert rr['channel'].min() >= 2000 and rr['channel'].max() <= 2119
    assert np.diff(rr['time']).min() >= 0
    assert len(truth) == len(ins)
    kept = ins['_last'] - ins['_first']
    key = lambda g, n: sorted(zip(g.tolist(), n.tolist()))   # noqa: E731
    assert key(truth['g4id'], truth['n_photon']) == key(ins['g4id'], kept)
    assert p.source_finished()
