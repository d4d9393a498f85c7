"""The port's instruction readers against wfsim_tpu's: random events (the
analytic branch and, through a mock ``nestpy``, the NEST branch), csv
input and GEANT4 optical input (XENONnT and the nVeto with its QE
thinning) from an in-memory ``events`` tree put in ``uproot``'s place for
both packages.  Everything here is host numpy, so the arrays must be
identical.
"""
import sys
import types

import numpy as np
import pytest

from wfsim_tpu import config as jax_config
from wfsim_tpu.interface import instructions as jax_instructions

from wfsim_tpu_torch import config as torch_config
from wfsim_tpu_torch.interface import instructions
from wfsim_tpu_torch.resources.synthetic import (synthetic_g4_file,
                                                 synthetic_nv_pmt_qe)


def same_records(a, b):
    assert a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('kw', [
    dict(event_rate=5, chunk_size=2, n_chunk=1, drift_field=82,
         energy_range=[1, 50], tpc_radius=50, tpc_length=97, seed=3),
    dict(event_rate=20, chunk_size=1, n_chunk=3, drift_field=200,
         energy_range=[1, 100], nest_inst_types=[7, 0], seed=11),
])
def test_rand_instructions_equal_wfsim_tpu(kw):
    assert not jax_instructions.HAVE_NESTPY and not instructions.HAVE_NESTPY
    ours = instructions._rand_instructions(**kw)
    same_records(ours, jax_instructions._rand_instructions(**kw))
    same_records(instructions.random_instructions(**kw), ours)
    assert len(ours) and set(np.unique(ours['type'])) <= {1, 2}


def test_rand_instructions_from_config_equal_wfsim_tpu():
    c = dict(event_rate=4, chunk_size=1, n_chunk=2, seed=5)
    same_records(instructions.rand_instructions(c),
                 jax_instructions.rand_instructions(c))


def test_rand_instructions_take_the_nestpy_branch(monkeypatch):
    """With ``nestpy`` importable the quanta come from NEST (ROADMAP Queue 1
    item 2's dispatch guard): a mock module whose yields are a function of
    the energy stands in for it."""
    calls = []

    class Quanta:
        def __init__(self, e):
            self.photons, self.electrons, self.excitons = \
                int(40 * e), int(30 * e), int(4 * e)

    class NESTcalc:
        def __init__(self, detector):
            self.detector = detector

        def GetYields(self, interaction, e_dep, density, field, a, z):
            calls.append((interaction, e_dep, density, field, a, z))
            return e_dep

        def GetQuanta(self, yields, density):
            return Quanta(yields)

    mock = types.SimpleNamespace(NESTcalc=NESTcalc, VDetector=lambda: 'det',
                                 INTERACTION_TYPE=lambda i: ('itype', i))
    monkeypatch.setattr(instructions, 'nestpy', mock)
    monkeypatch.setattr(instructions, 'HAVE_NESTPY', True)
    inst = instructions.rand_instructions(dict(event_rate=3, chunk_size=1,
                                               n_chunk=1, seed=2,
                                               drift_field=150))
    assert len(calls) == 3
    assert all(c[0] == ('itype', 7) and c[2] == 2.862 and c[3] == 150
               for c in calls)
    e = np.asarray([c[1] for c in calls])
    s1, s2 = inst[inst['type'] == 1], inst[inst['type'] == 2]
    np.testing.assert_array_equal(s1['amp'], (40 * e).astype(int))
    np.testing.assert_array_equal(s2['amp'], (30 * e).astype(int))
    np.testing.assert_array_equal(s1['n_excitons'], (4 * e).astype(int))
    np.testing.assert_allclose(s1['e_dep'], e)
    # the analytic partition gives other quanta for the same draws
    ref = jax_instructions._rand_instructions(
        event_rate=3, chunk_size=1, n_chunk=1, drift_field=150,
        energy_range=[1, 100], nest_inst_types=[7], seed=2)
    np.testing.assert_array_equal(ref['x'], inst['x'])
    assert not np.array_equal(ref['amp'], inst['amp'])


def test_instruction_csv_roundtrip_equal_wfsim_tpu(tmp_path):
    pd = pytest.importorskip('pandas')
    inst = instructions.random_instructions(
        event_rate=3, chunk_size=1, n_chunk=2, drift_field=82,
        energy_range=[1, 10], seed=1)
    path = tmp_path / 'inst.csv'
    pd.DataFrame(inst).to_csv(path, index=False)
    ours = instructions.instruction_from_csv(str(path))
    same_records(ours, jax_instructions.instruction_from_csv(str(path)))
    for k in ('amp', 'time', 'type', 'event_number'):
        np.testing.assert_array_equal(ours[k], inst[k])


G4_CASES = {
    'tpc': dict(detector='XENONnT', first_channel=0, n_channels=494,
                mean_hits=300, tau_ns=25.0, entry=(None, None)),
    'nveto': dict(detector='XENONnT_neutron_veto', first_channel=2000,
                  n_channels=120, mean_hits=800, tau_ns=200.0,
                  entry=(None, None)),
    'nveto_entries': dict(detector='XENONnT_neutron_veto', first_channel=2000,
                          n_channels=120, mean_hits=500, tau_ns=200.0,
                          entry=(3, 40), qe=None),
}


def g4_config(module, case, seed=9):
    c = module.default_config(detector=case['detector'], seed=seed)
    c['fax_file'] = 'synthetic_g4.root'
    c['entry_start'], c['entry_stop'] = case['entry']
    if c['entry_start'] is None:
        del c['entry_start']
    if case['detector'] == 'XENONnT_neutron_veto' and 'qe' not in case:
        c['nv_pmt_qe'] = synthetic_nv_pmt_qe(range(2000, 2120))
        c['nv_pmt_ce_factor'] = 0.9
    return c


@pytest.mark.parametrize('name', list(G4_CASES))
def test_read_optical_equal_wfsim_tpu(name, monkeypatch):
    """read_optical from one in-memory events tree, given to both packages
    as ``uproot``: instructions (split by optical_adjustment where an
    event's hits spread past 1 us), channels and timings identical, and
    ``config['entry_stop']`` set alike."""
    case = G4_CASES[name]
    g4 = synthetic_g4_file(60, 4, first_channel=case['first_channel'],
                           n_channels=case['n_channels'],
                           mean_hits=case['mean_hits'], tau_ns=case['tau_ns'],
                           tail_every=7)
    opened = []
    monkeypatch.setitem(sys.modules, 'uproot', types.SimpleNamespace(
        open=lambda path: opened.append(path) or g4))
    c_ours, c_jax = g4_config(torch_config, case), g4_config(jax_config, case)
    ins, ch, t = instructions.read_optical(c_ours)
    ins_j, ch_j, t_j = jax_instructions.read_optical(c_jax)
    assert opened == ['synthetic_g4.root'] * 2
    same_records(ins, ins_j)
    np.testing.assert_array_equal(ch, ch_j)
    np.testing.assert_array_equal(t, t_j)
    assert ch.dtype == ch_j.dtype and t.dtype == t_j.dtype
    assert c_ours['entry_stop'] == c_jax['entry_stop']
    lo, hi = case['entry']
    assert c_ours['entry_stop'] == (60 if hi is None else hi)
    n_events = c_ours['entry_stop'] - (lo or 0)
    assert len(ins) > n_events                     # some events were split
    assert int((ins['_last'] - ins['_first']).sum()) == len(ch) == len(t)
    if case['detector'] == 'XENONnT_neutron_veto':
        assert ch.min() >= 0 and ch.max() < 120
        hits = sum(len(x) for x in g4.events['pmthitID'].array()[
            (lo or 0):c_ours['entry_stop']])
        # thinned by QE x CE (0.3 x 0.9 of the photons inside the QE band),
        # or kept whole without a QE table
        frac = len(ch) / hits
        assert (0.2 < frac < 0.3) if 'qe' not in case else frac == 1.0
    else:
        assert ch.max() < 494


def test_simulator_takes_random_and_csv_instructions(tmp_path):
    """``Simulator.get_arrays()`` without instructions: ``fax_file`` (a
    csv file) when set, else ``rand_instructions(config)``; a ROOT file
    or another format raises."""
    pd = pytest.importorskip('pandas')
    from wfsim_tpu_torch.interface.simulator import Simulator
    cfg = torch_config.default_config(seed=6, event_rate=2, chunk_size=1,
                                      n_chunk=1)
    inst = instructions.rand_instructions(cfg)
    out = Simulator(cfg, device='cpu').get_arrays()
    assert len(out['truth']) == len(inst) and len(out['raw_records'])
    path = tmp_path / 'inst.csv'
    pd.DataFrame(inst[:2]).to_csv(path, index=False)
    sim = Simulator(dict(cfg, fax_file=str(path)), device='cpu')
    same_records(sim.get_instructions(), inst[:2])
    assert len(sim.get_arrays()['truth']) == 2
    for name in ('g4.root', 'inst.json'):
        with pytest.raises(ValueError):
            Simulator(dict(cfg, fax_file=name), device='cpu').get_instructions()
