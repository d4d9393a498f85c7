"""The optical (GEANT4 photon-list) chain of wfsim_tpu_torch against
wfsim_tpu: ``optical_adjustment`` / ``find_optical_t_range`` (host numpy:
identical), the kept photons of a batch against wfsim_tpu's loop, the
optical response given the same draws against wfsim_tpu's
``_optical_response``, and ``RawDataOptical`` end to end for XENONnT and
the nVeto.

Tolerances of the optical response (as tests/test_torch_physics.py's):
channels, DPE flags and validity exact; times equal except photons whose
float32 TTS lands within rounding of an integer (at most 1 ns, at most
1e-3 of the photons); gains rtol 1e-6; truth rtol 1e-5.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from wfsim_tpu import utils as jax_utils
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.pipeline.optical import _optical_jit
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import utils
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.dtypes import instruction_dtype, optical_extra_dtype
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.pipeline.chunker import ChunkRawRecords
from wfsim_tpu_torch.pipeline.rawdata import RawData
from wfsim_tpu_torch.pipeline.optical import (RawDataOptical,
                                              optical_photons,
                                              optical_response)
from wfsim_tpu_torch.resources import load_config

from .test_torch_physics import trunc_mismatch


def photon_list(seed, n_inst=40, empty=(3, 17), long_every=6):
    """Optical instructions over a photon list: exponential times (tau
    200 ns) from 5 us, a few instructions without photons, every
    ``long_every``-th with a tail past 1 us (split by optical_adjustment),
    one with late photons past the 1 ms cutoff and one with negative
    times (dropped by the optical chain)."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(150, n_inst)
    n[list(empty)] = 0
    t = []
    for i, k in enumerate(n):
        ti = 5_000 + rng.exponential(200.0, k)
        if long_every and i % long_every == 1:
            late = rng.random(k) < 0.1
            ti[late] += rng.uniform(2_000, 30_000, late.sum())
        if i == 8:
            ti[:5] += 2_000_000
        if i == 9:
            ti[:3] = -50
        t.append(ti.astype(np.int64))
    inst = np.zeros(n_inst, dtype=instruction_dtype + optical_extra_dtype)
    inst['type'] = 1
    inst['recoil'] = 1
    inst['event_number'] = np.arange(n_inst)
    inst['time'] = (np.arange(n_inst) + 1) * 5_000_000
    inst['_last'] = np.cumsum(n)
    inst['_first'] = inst['_last'] - n
    return (inst, np.concatenate(t),
            rng.integers(0, 494, int(n.sum())).astype(np.int32))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_optical_adjustment_equal_wfsim_tpu(seed):
    """Same instructions (time moved to the first photon, long entries
    split, the splits appended), and the same in-place timings and
    channels."""
    inst, t, ch = photon_list(seed)
    t_j, ch_j = t.copy(), ch.copy()
    out = utils.optical_adjustment(inst, t, ch)
    out_j = jax_utils.optical_adjustment(inst, t_j, ch_j)
    assert out.dtype == out_j.dtype and out.tobytes() == out_j.tobytes()
    np.testing.assert_array_equal(t, t_j)
    np.testing.assert_array_equal(ch, ch_j)
    assert len(out) > len(inst)
    assert (out['_first'][:len(inst)] >= inst['_first']).all()
    empty = out['_first'] == out['_last']
    assert empty.sum() >= 2


def test_find_optical_t_range_equal_wfsim_tpu():
    """Empty entries get tmin = tmax = -1; the rest are shifted to start at
    zero, from ``start`` on only."""
    inst, t, _ = photon_list(5)
    res = []
    for mod in (utils, jax_utils):
        tt = t.copy()
        lo = np.zeros(len(inst), np.int64)
        hi = np.zeros(len(inst), np.int64)
        mod.find_optical_t_range(inst['_first'], inst['_last'], tt, lo, hi,
                                 start=2)
        res.append((tt, lo, hi))
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)
    tt, lo, hi = res[0]
    assert lo[3] == hi[3] == -1 and lo[17] == hi[17] == -1
    np.testing.assert_array_equal(tt[:inst['_last'][1]], t[:inst['_last'][1]])
    for i in range(2, len(inst)):
        seg = tt[inst['_first'][i]:inst['_last'][i]]
        assert not len(seg) or seg.min() == 0


def test_optical_photons_equal_wfsim_tpu_loop():
    """The kept photons of a batch: wfsim_tpu's loop over instructions
    (optical.py:54-65), with the 1 ms cutoff and negative times."""
    inst, t, ch = photon_list(3)
    sel = inst[5:30]
    base = int(sel['time'].min())
    cutoff = int(1e6)
    tt, cc, counts = optical_photons(sel, t, ch, base, cutoff)
    t_ref, c_ref, n_ref = [], [], []
    for ins in sel:
        lo, hi = int(ins['_first']), int(ins['_last'])
        ok = (t[lo:hi] >= 0) & (t[lo:hi] < cutoff)
        t_ref.append(t[lo:hi][ok] + (int(ins['time']) - base))
        c_ref.append(ch[lo:hi][ok])
        n_ref.append(int(ok.sum()))
    np.testing.assert_array_equal(tt, np.concatenate(t_ref).astype(np.int32))
    np.testing.assert_array_equal(cc, np.concatenate(c_ref))
    np.testing.assert_array_equal(counts, n_ref)
    assert tt.dtype == np.int32 and counts.dtype == np.int64
    assert n_ref[8 - 5] == len(range(*inst[['_first', '_last']][8])) - 5
    assert n_ref[9 - 5] == inst['_last'][9] - inst['_first'][9] - 3


@pytest.fixture(scope='module')
def both_params():
    cj = jax_default_config()
    c = default_config()
    return ((jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (build_params(c, load_config(c), 'cpu'), build_constants(c)))


def test_optical_response_given_draws(both_params):
    """The port's optical response (one pmt_response call, whose truth
    already holds the photon time statistics) against wfsim_tpu's
    ``_optical_response`` (pmt_response then photon_time_stats), given the
    draws wfsim_tpu makes from its key; rows without photons included."""
    (pj, kj), (pt, kt) = both_params
    rng = np.random.default_rng(4)
    rows = 24
    counts = rng.poisson(300, rows)
    counts[[0, 7, 23]] = 0
    n = int(counts.sum())
    t = (rng.exponential(200.0, n) + np.repeat(rng.integers(0, 10 ** 6, rows),
                                               counts)).astype(np.int32)
    ch = rng.integers(0, 494, n).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    truth_row = np.repeat(np.arange(rows), counts).astype(np.int32)
    key = jax.random.key(11)
    k = jax.random.split(key, 4)
    draws = dict(tts=jax.random.normal(k[0], (n,)),
                 dpe=jax.random.uniform(k[1], (n,)),
                 u1=jax.random.uniform(k[2], (n,)),
                 u2=jax.random.uniform(k[3], (n,)))
    phj, trj = _optical_jit(pj, kj, jnp.asarray(t), jnp.asarray(ch),
                            jnp.ones(n, bool), jnp.asarray(truth_row),
                            jnp.asarray(edges), key, n_truth_rows=rows)
    pht, trt = optical_response(
        pt, kt, torch.from_numpy(t), torch.from_numpy(ch),
        torch.from_numpy(counts.astype(np.int64)),
        {name: torch.from_numpy(np.array(v)) for name, v in draws.items()})
    trunc_mismatch(phj['t'], pht['t'])
    for name in ('ch', 'is_dpe', 'valid'):
        np.testing.assert_array_equal(np.asarray(phj[name]),
                                      pht[name].numpy(), name)
    np.testing.assert_allclose(np.asarray(phj['gain']), pht['gain'].numpy(),
                               rtol=1e-6)
    assert set(trj) == set(trt)
    for name, v in trj.items():
        np.testing.assert_allclose(np.asarray(v), trt[name].numpy(),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(trt['photon_count'].numpy(), counts)
    np.testing.assert_array_equal(trt['n_electron'].numpy(), 0)


@pytest.mark.parametrize('detector', ['XENONnT', 'XENONnT_neutron_veto'])
def test_rawdata_optical_end_to_end(detector):
    """ChunkRawRecords over RawDataOptical (tests/test_interfaces.py:41-70,
    :216-245 for wfsim_tpu): one truth row per optical instruction even
    with ``save_full_truth`` off (instructions 100 ns apart would group),
    ``n_photon`` the photons each keeps, records on the detector's
    channels, afterpulses on for the nVeto, an S2 instruction through the
    standard S2 chain on XENONnT."""
    n_ch = 494 if detector == 'XENONnT' else 120
    rng = np.random.default_rng(3)
    n_events, ppe = 4, 150
    channels = rng.integers(0, n_ch, n_events * ppe).astype(np.int32)
    timings = rng.integers(0, 300, n_events * ppe).astype(np.int64)
    timings[:4] = [-5, 2_000_000, 1_500_000, 0]     # three dropped
    inst = np.zeros(n_events, dtype=instruction_dtype + optical_extra_dtype)
    inst['type'] = 1
    inst['time'] = [20_000_000, 20_000_050, 40_000_000, 60_000_000]
    inst['event_number'] = np.arange(n_events)
    inst['recoil'] = 1
    inst['_first'] = np.arange(n_events) * ppe
    inst['_last'] = (np.arange(n_events) + 1) * ppe
    extra = dict(enable_pmt_afterpulses=True) \
        if detector != 'XENONnT' else {}
    c = default_config(detector=detector, seed=8, chunk_size=1,
                       save_full_truth=False, **extra)
    c['_truth_extra_instruction_dtype'] = optical_extra_dtype
    want = {int(e): ppe for e in range(n_events)}
    want[0] = ppe - 3
    if detector == 'XENONnT':
        s2 = np.zeros(1, dtype=inst.dtype)
        s2['type'] = 2
        s2['time'] = 80_000_000
        s2['z'] = -30.0
        s2['amp'] = 40
        s2['recoil'] = 7
        s2['event_number'] = n_events
        inst = np.concatenate([inst, s2])
    sim = ChunkRawRecords(c, device='cpu', rawdata_generator=RawDataOptical,
                          channels=channels, timings=timings)
    outs = list(sim(inst))
    rr = np.concatenate([o['raw_records'] for o in outs])
    truth = np.concatenate([o['truth'] for o in outs])
    assert len(rr) > 0 and rr['channel'].min() >= 0
    assert rr['channel'].max() < n_ch
    assert np.all(np.diff(rr['time']) >= 0)
    s1 = truth[truth['type'] == 1]
    assert len(s1) == n_events
    got = dict(zip(s1['event_number'].tolist(), s1['n_photon'].tolist()))
    assert got == want
    assert (s1['n_electron'] == 0).all()
    if detector == 'XENONnT':
        s2_rows = truth[truth['type'] == 2]
        assert len(s2_rows) == 1 and s2_rows['n_electron'][0] > 0
    else:
        assert sim.rawdata.diag.counts['pmt_ap_photons'] > 0


@pytest.mark.parametrize('n_inst, n_groups', [(6, 2), (10, 1)])
def test_f8_summaries_read_by_instruction(n_inst, n_groups, monkeypatch):
    """ROADMAP F8, the port's rule: with ``save_full_truth`` off, S2
    instructions within 2 mm of drift share a truth row, and the photon
    summaries that seed the electron afterpulses are read by instruction,
    as wfsim_tpu reads them (rawdata.py:648-649): instruction i takes row
    i's summaries, an instruction past the last row an empty row's.
    wfsim_tpu's rows are bucketed (``_bucket(n_rows, lo=8)``) and run out
    past the bucket, where it raises IndexError (the (10, 1) case); the
    port gives those instructions empty rows too."""
    from wfsim_tpu.pipeline.rawdata import _bucket as jax_bucket
    import wfsim_tpu_torch.pipeline.rawdata as rdm
    rows = {}
    real = rdm.photon_summaries

    def spy(photons, u, n_inst):
        out = real(photons, u, n_inst=n_inst)
        rows['counts'], rows['tz'] = (x.numpy().copy() for x in out)
        return out

    seen = []

    def generate(config, resource, rng, counts, tz, sel, base_time):
        seen.append((counts.copy(), tz.copy(), len(sel)))
        return np.zeros(0, sel.dtype)

    monkeypatch.setattr(rdm, 'photon_summaries', spy)
    monkeypatch.setattr(rdm, 'generate_pi_el_instructions', generate)
    inst = np.zeros(n_inst, dtype=instruction_dtype)
    inst['type'] = 2
    group = np.arange(n_inst) * n_groups // n_inst
    inst['time'] = 10_000_000 + 20_000_000 * group + 10 * np.arange(n_inst)
    inst['z'] = -20.0
    inst['amp'] = 60
    inst['recoil'] = 7
    inst['event_number'] = group
    c = default_config(seed=3, save_full_truth=False,
                       enable_electron_afterpulses=True)
    rd = RawData(c, device='cpu')
    truth = rd.simulate(inst)
    assert len(truth) == n_groups
    assert len(rows['counts']) == n_groups and (rows['counts'] > 0).all()
    (counts, tz, n_sel), = seen
    assert n_sel == n_inst
    cap = jax_bucket(n_groups, lo=8, hi=2 ** 16)
    expect = np.zeros(max(cap, n_inst), rows['counts'].dtype)
    expect[:n_groups] = rows['counts']
    np.testing.assert_array_equal(counts, expect[:n_inst])
    np.testing.assert_array_equal(tz[:n_groups], rows['tz'])
    assert (cap >= n_inst) == (n_inst == 6)
