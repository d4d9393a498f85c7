"""Where wfsim_tpu gives a result, the port gives the same: instructions
of types outside {1, 2, 4, 6}, resource files that resolve nowhere, an
electron-afterpulse file, the opt-in remote fetch and the sequential
hitfinder of ``native.py``.

Tolerances, per quantity:

- host framing of arrays with unknown types (super-batch cuts and
  ``safe_t``, ``_sim_batch_list`` index arrays, arrival clusters, window
  bounds given the same pulses): equal to wfsim_tpu's;
- truth types of a run: the S1 and S2 rows (event, type) equal to
  wfsim_tpu's; electron-afterpulse rows of type 4 only in both (their
  number is a draw, and the packages' generators differ, PARITY.md
  deviations 2 and 5);
- the port's records and truth with and without the unknown
  instructions, where the framing is unchanged: bitwise;
- resource fallbacks, the electron-afterpulse file, its parameters and
  the pi_el instructions from one numpy generator: equal to wfsim_tpu's;
- ``find_intervals_below_threshold``: bitwise wfsim_tpu's; against the
  ZLE twin (``trigger_window`` 0, holdoff at least 1, the twin's domain):
  the sequential intervals landed on even offsets as the twin lands them.
"""
import gzip
import pickle
import sys
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.interface.simulator import Simulator as JaxSimulator
from wfsim_tpu.models.afterpulse import (
    generate_pi_el_instructions as jax_generate_pi_el)
from wfsim_tpu.models.params import build_params as jax_build_params
from wfsim_tpu.native import (
    find_intervals_below_threshold as jax_find_intervals)
from wfsim_tpu.pipeline import digitize as jax_digitize
from wfsim_tpu.pipeline.rawdata import RawDataTPU, _Pulse as JaxPulse
from wfsim_tpu.resources.loader import Resource as JaxResource

from wfsim_tpu_torch import Simulator
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.dtypes import instruction_dtype
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.interface.simulator import check_instructions
from wfsim_tpu_torch.models.afterpulse import generate_pi_el_instructions
from wfsim_tpu_torch.models.params import build_params
from wfsim_tpu_torch.native import find_intervals_below_threshold
from wfsim_tpu_torch.ops.zle import zle_all_channels_ref
from wfsim_tpu_torch.pipeline.rawdata import RawData, _Pulse
from wfsim_tpu_torch.resources import loader
from wfsim_tpu_torch.resources.loader import Resource

from .ele_ap_hist import delay_hist

UNKNOWN_TYPES = (0, 3, 5, 7)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread while this module runs (as
    tests/test_torch_record_arena.py): its CPU runs are many small ops,
    which the runner's parallel workers slow down many times over when
    each op spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# instruction arrays


def mixed_instructions(seed=11, n=8):
    """``n`` events of an S1 and an S2 (event 5 50 ns after event 4 at
    nearly its place, so S1s and S2s group where ``save_full_truth`` is
    off), one instruction of each unknown type at every S1's time and
    place, and every other S2 copied with an unknown type; the array is
    shuffled, so unknown types sit among the S2 instructions."""
    rng = np.random.default_rng(seed)
    inst = np.zeros(2 * n, dtype=instruction_dtype)
    t = (np.arange(n) + 1) * 4_000_000 + rng.integers(0, 100_000, n)
    r = np.sqrt(rng.uniform(0, 40 ** 2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    x, y, z = r * np.cos(th), r * np.sin(th), rng.uniform(-90, -10, n)
    t[5], x[5], y[5], z[5] = t[4] + 50, x[4] + 0.01, y[4], z[4] - 0.01
    inst['event_number'] = np.repeat(np.arange(n), 2)
    inst['type'] = np.tile([1, 2], n)
    inst['time'] = np.repeat(t, 2)
    for k, v in (('x', x), ('y', y), ('z', z)):
        inst[k] = np.repeat(v, 2)
    inst['amp'] = np.stack([rng.integers(800, 3000, n),
                            rng.integers(150, 400, n)], 1).ravel()
    inst['recoil'] = 7
    s1 = inst[inst['type'] == 1]
    extra = np.repeat(s1, len(UNKNOWN_TYPES))
    extra['type'] = np.tile(UNKNOWN_TYPES, len(s1))
    s2 = inst[inst['type'] == 2][::2].copy()
    s2['type'] = rng.choice(UNKNOWN_TYPES, len(s2))
    out = np.concatenate([inst, extra, s2])
    return out[rng.permutation(len(out))]


def known(inst):
    return inst[np.isin(inst['type'], (1, 2, 4, 6))]


def bench_with_unknown(every):
    """The 512-event bench array with one instruction of each unknown
    type at the time and place of every ``every``-th S1."""
    inst = bench_instructions(512, 2000, 300)
    s1 = inst[inst['type'] == 1][::every]
    extra = np.repeat(s1, len(UNKNOWN_TYPES))
    extra['type'] = np.tile(UNKNOWN_TYPES, len(s1))
    return np.concatenate([inst, extra])


def test_check_instructions_pass_unknown_types():
    """Neither package's instruction check rejects another type."""
    inst = mixed_instructions()
    cfg = default_config()
    ours = check_instructions(inst, cfg)
    ref = JaxSimulator.check_instructions(
        types.SimpleNamespace(config=jax_default_config()), inst)
    assert ours.tobytes() == ref.tobytes() == inst.tobytes()


# ---------------------------------------------------------------------------
# host framing against wfsim_tpu, given the same pulses


def pulse_rows(rd, inst, idx, kind, clusters):
    """One pulse a truth row of a batch: first and last photon at the
    rows' least arrival and their greatest arrival plus 2 us (S1) or
    20 us; (t_min, t_max, event number) and the batch's base time."""
    arrival = rd._arrival_times(inst[idx])
    span = 2_000 if kind == 's1' else 20_000
    rows = []
    for r in range(int(clusters.max()) + 1):
        m = np.flatnonzero(clusters == r)
        rows.append((int(arrival[m].min()), int(arrival[m].max()) + span,
                     int(inst['event_number'][idx[m[0]]])))
    return rows, min(t for t, _, _ in rows)


def batch_photons(rows, base):
    """Two photons a pulse (its first and last), relative to ``base``."""
    t = np.asarray([[a - base, b - base] for a, b, _ in rows],
                   np.int32).ravel()
    return t, np.zeros(len(t), np.int32), np.ones(len(t), np.float32)


def port_framing(inst, cfg):
    rd = RawData(cfg, device='cpu')
    arrival = rd._arrival_times(inst)
    out = []
    for order_k, safe_t in rd._split_super_batches(
            arrival, np.argsort(arrival, kind='stable')):
        rnd = dict(order=order_k.tolist(), safe_t=safe_t, batches=[],
                   clusters=[])
        for kind, idx in rd._sim_batch_list(inst, order_k):
            clusters = rd._truth_rows(inst, idx, kind)
            rnd['batches'].append((kind, idx.tolist()))
            rnd['clusters'].append(clusters.tolist())
            rows, base = pulse_rows(rd, inst, idx, kind, clusters)
            t, ch, g = batch_photons(rows, base)
            bid = rd._add_buffer(dict(t=torch.from_numpy(t),
                                      ch=torch.from_numpy(ch),
                                      gain=torch.from_numpy(g)))
            for r, (a, b, ev) in enumerate(rows):
                rd._pulses.append(_Pulse(bid, 2 * r, 2, a, b, base, ev))
        rnd['windows'] = [(w['win_left'], w['win_right'], w['flush'])
                          for w in rd._windows(safe_t)]
        out.append(rnd)
    return out


def jax_framing(inst, cfg, monkeypatch):
    """wfsim_tpu's framing of the same array and pulses (its digitize
    kernels stubbed: only the window descriptors are read)."""
    def stub(*args, **kwargs):
        z = jnp.int32(0)
        return dict(n_records=z, n_values=z, n_intervals=z)
    monkeypatch.setattr(jax_digitize, 'gather_digitize', stub)
    rd = RawDataTPU(cfg)
    rd._buffers, rd._buf_ctr, rd._pulses = {}, 0, []
    rd._pipeline_live = True
    arrival = rd._arrival_times(inst)
    out = []
    for order_k, safe_t in rd._split_super_batches(
            arrival, np.argsort(arrival, kind='stable')):
        rnd = dict(order=order_k.tolist(), safe_t=safe_t, batches=[],
                   clusters=[])
        for kind, idx in rd._sim_batch_list(inst, order_k):
            clusters = rd._prepare_type_batch(inst, idx, kind)['truth_rows']
            rnd['batches'].append((kind, np.asarray(idx).tolist()))
            rnd['clusters'].append(clusters.tolist())
            rows, base = pulse_rows(rd, inst, idx, kind, clusters)
            t, ch, g = batch_photons(rows, base)
            bid = rd._append_buffer(dict(t=jnp.asarray(t), ch=jnp.asarray(ch),
                                         gain=jnp.asarray(g)), base)
            for r, (a, b, ev) in enumerate(rows):
                rd._pulses.append(JaxPulse(
                    inst_idx=np.array([0]), buf=bid, buf_start=2 * r,
                    pool_count=2, t_min=a, t_max=b, truth_key=-1,
                    event_number=ev, base_time=base))
        state = rd._dispatch_digitize(safe_t, int(cfg['right_raw_extension']),
                                      int(cfg['sample_duration']))
        rnd['windows'] = ([] if state is None else
                          [(w['win_left'], w['win_right'], w['flush'])
                           for w in state['wins']])
        out.append(rnd)
    return out


FRAMING_CASES = dict(
    mixed=lambda: mixed_instructions(),
    bench_every_s1=lambda: bench_with_unknown(1),
    bench_every_4th_s1=lambda: bench_with_unknown(4))


@pytest.mark.parametrize('case', sorted(FRAMING_CASES))
def test_framing_matches_jax(case, monkeypatch):
    """The arrays with unknown types frame as in wfsim_tpu: every
    instruction counts in the super-batch cuts, no unknown one joins a
    batch or a cluster, and the windows of the same pulses are equal.
    With an unknown instruction at every bench S1 the framing of the
    known instructions is that of the array without them (chip_smoke.py's
    phase 4v holds its records and digest to the default run's); at every
    fourth S1 the cuts move, in both packages alike."""
    inst = FRAMING_CASES[case]()
    over = dict(save_full_truth=False)
    if case == 'mixed':
        over['pipeline_min_batch'] = 4
    ours = port_framing(inst, dict(default_config(**over), seed=7))
    ref = jax_framing(inst, dict(jax_default_config(), seed=7, **over),
                      monkeypatch)
    assert ours == ref
    assert len(ours) == 3
    kinds = inst['type']
    for rnd in ours:
        for _kind, idx in rnd['batches']:
            assert np.isin(kinds[idx], (1, 2)).all()
    if case.startswith('bench'):
        base = port_framing(known(inst), dict(default_config(**over),
                                              seed=7))
        same = [r['windows'] for r in ours] == [r['windows'] for r in base]
        cuts = [r['safe_t'] for r in ours] == [r['safe_t'] for r in base]
        assert same == cuts == (case == 'bench_every_s1')
    else:
        assert any(max(c) + 1 < len(c) for r in ours for c in r['clusters'])


# ---------------------------------------------------------------------------
# runs


@pytest.fixture(scope='module')
def jax_truth():
    """wfsim_tpu's truth rows of the mixed array with electron
    afterpulses on: its own host code (``_sim_dispatch`` /
    ``_sim_finalize``, which ``iter_windows`` runs) over the primaries,
    then the secondaries they seed; no digitize (the truth does not
    depend on it)."""
    inst = mixed_instructions()
    rd = RawDataTPU(jax_default_config(seed=3, enable_electron_afterpulses=True))
    rd._buffers, rd._buf_ctr, rd._pulses = {}, 0, []
    order = np.argsort(rd._arrival_times(inst), kind='stable')
    truth, sec = [], []
    rd._sim_finalize(rd._sim_dispatch(inst, order, True), inst, truth, sec)
    sec = np.concatenate([s for s in sec if len(s)])
    order = np.argsort(rd._arrival_times(sec), kind='stable')
    rd._sim_finalize(rd._sim_dispatch(sec, order, False), sec, truth, None)
    return truth


def port_run(inst, ele_ap):
    cfg = default_config(seed=3, enable_electron_afterpulses=ele_ap)
    return Simulator(cfg, device='cpu').get_arrays(inst)


@pytest.fixture(scope='module')
def port_runs():
    inst = mixed_instructions()
    return {(ap, unk): port_run(inst if unk else known(inst), ap)
            for ap in (False, True) for unk in (False, True)}


def primaries(rows):
    return sorted((int(r['event_number']), int(r['type'])) for r in rows
                  if int(r['type']) in (1, 2))


@pytest.mark.parametrize('ele_ap', [False, True])
def test_truth_types_match_jax(jax_truth, port_runs, ele_ap):
    """Both packages run the array; their S1 and S2 rows are the same
    (event, type) pairs, one an instruction of type 1 or 2, and no row
    has another type but 4 (with electron afterpulses on)."""
    inst = mixed_instructions()
    truth = port_runs[ele_ap, True]['truth']
    want = sorted((int(e), int(t)) for e, t in
                  zip(inst['event_number'], inst['type']) if t in (1, 2))
    assert primaries(truth) == primaries(jax_truth) == want
    assert set(truth['type'].tolist()) == ({1, 2, 4} if ele_ap else {1, 2})
    assert {int(r['type']) for r in jax_truth} == {1, 2, 4}


def test_run_cuts_count_unknown_types(monkeypatch):
    """A run of the mixed array in three super-batches simulates the
    super-batches that wfsim_tpu's cuts of the whole array give, unknown
    instructions included."""
    inst = mixed_instructions()
    seen = []
    simulate = RawData.simulate

    def spy(self, instructions, order=None):
        seen.append(np.asarray(order).tolist())
        return simulate(self, instructions, order)
    monkeypatch.setattr(RawData, 'simulate', spy)
    out = Simulator(default_config(seed=3, pipeline_min_batch=4),
                    device='cpu').get_arrays(inst)
    ref = types.SimpleNamespace(config=dict(jax_default_config(),
                                            pipeline_min_batch=4))
    arrival = RawDataTPU._arrival_times(ref, inst)
    want = RawDataTPU._split_super_batches(
        ref, arrival, np.argsort(arrival, kind='stable'))
    assert seen == [o.tolist() for o, _ in want]
    assert len(seen) == 3 and len(out['truth']) == 16


@pytest.mark.parametrize('ele_ap', [False, True])
def test_records_unchanged_by_unknown_types(port_runs, ele_ap):
    """One super-batch, so the framing is unchanged: the port's records
    and truth with the unknown instructions are bitwise those without
    (with electron afterpulses on, the summaries seed the same
    secondaries: F8's mapping holds with unknown types among the S2
    instructions)."""
    a, b = port_runs[ele_ap, True], port_runs[ele_ap, False]
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert len(a['raw_records']) > 1000


# ---------------------------------------------------------------------------
# resource files that resolve nowhere


NVETO = dict(detector='XENONnT_neutron_veto')
FALLBACKS = dict(
    noise_file=dict(enable_noise=True),
    photon_ap_cdfs=dict(enable_pmt_afterpulses=True),
    photon_area_distribution=dict(),
    nv_pmt_qe=NVETO)


def fallback_arrays(key, res):
    """The arrays the entry ``key`` gives, as numpy (the port's noise bank
    is channel-major; wfsim_tpu's is (length, channels))."""
    if key == 'noise_file':
        bank = getattr(res, 'noise_bank', None)
        return [np.asarray(bank if bank is not None else res.noise_data.T)]
    if key == 'photon_ap_cdfs':
        d = res.uniform_to_pmt_ap
        return [(e, f, np.asarray(d[e][f])) for e in sorted(d)
                for f in sorted(d[e])]
    if key == 'photon_area_distribution':
        return [np.asarray(res.uniform_to_pe)]
    return [res.nv_pmt_qe]


def same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert x[:2] == y[:2]
            x, y = x[2], y[2]
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('key', sorted(FALLBACKS))
def test_file_found_nowhere_falls_back(key, tmp_path, monkeypatch):
    """A name that resolves nowhere gives wfsim_tpu's synthetic asset (no
    QE table for ``nv_pmt_qe``) and the port's arrays with the entry
    unset."""
    monkeypatch.delenv('WFSIM_TPU_ALLOW_DOWNLOAD', raising=False)
    over = dict(FALLBACKS[key], url_base=str(tmp_path))
    name = {'noise_file': 'noise.npz', 'photon_ap_cdfs': 'pmt_ap.json.gz',
            'photon_area_distribution': 'spe.csv',
            'nv_pmt_qe': 'nveto_pmt_qe.json'}[key]
    nowhere = fallback_arrays(key, Resource(default_config(**over,
                                                           **{key: name})))
    unset = fallback_arrays(key, Resource(default_config(**over,
                                                         **{key: None})))
    ref = fallback_arrays(key, JaxResource(dict(jax_default_config(**over),
                                                **{key: name})))
    same_arrays(nowhere, unset)
    same_arrays(nowhere, ref)
    if key == 'nv_pmt_qe':
        assert nowhere == [None]


# ---------------------------------------------------------------------------
# electron-afterpulse files


@pytest.fixture(scope='module')
def ele_ap_files(tmp_path_factory):
    d = tmp_path_factory.mktemp('ele_ap')
    hist = delay_hist()
    with open(d / 'ele_ap.pkl', 'wb') as f:
        pickle.dump(hist, f)
    with gzip.open(d / 'ele_ap.pkl.gz', 'wb') as f:
        pickle.dump(hist, f)
    return d, hist


@pytest.mark.parametrize('name', ['ele_ap.pkl', 'ele_ap.pkl.gz'])
def test_ele_ap_file_matches_jax(ele_ap_files, name):
    """The file is read as wfsim_tpu reads it (the pickled object, its
    class from tests/ele_ap_hist.py); the parameters built from it and
    the pi_el instructions drawn from one numpy generator are wfsim_tpu's."""
    d, hist = ele_ap_files
    over = dict(enable_electron_afterpulses=True, ele_ap_pdfs=name,
                url_base=str(d))
    cfg, jcfg = default_config(**over), dict(jax_default_config(), **over)
    ours, ref = Resource(cfg).uniform_to_ele_ap, \
        JaxResource(jcfg).uniform_to_ele_ap
    assert type(ours) is type(ref) is type(hist)
    for a in ('n', 'bin_edges', 'histogram', 'bin_centers'):
        np.testing.assert_array_equal(getattr(ours, a), getattr(ref, a))
        np.testing.assert_array_equal(getattr(ours, a), getattr(hist, a))
    p = build_params(cfg, Resource(cfg), 'cpu')
    jp = jax_build_params(jcfg, JaxResource(jcfg))
    for f in ('ele_ap_bin_centers', 'ele_ap_cdf'):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    assert cfg['_ele_ap_n'] == jcfg['_ele_ap_n'] == hist.n

    src = known(mixed_instructions())
    src = src[src['type'] == 2]
    rng = np.random.default_rng(21)
    counts = rng.integers(0, 40_000, len(src))
    tz = rng.integers(0, 2_000_000, (len(src), 16)).astype(np.int32)
    base = 123_456_789
    got = generate_pi_el_instructions(cfg, Resource(cfg),
                                      np.random.default_rng(4), counts, tz,
                                      src, base)
    want = jax_generate_pi_el(jcfg, JaxResource(jcfg),
                              np.random.default_rng(4), counts, tz, src, base)
    assert len(got) > 10 and (got['type'] == 4).all()
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the opt-in remote fetch (urllib mocked: no network)


def test_get_file_path_remote_chain(tmp_path, monkeypatch):
    """tests/test_resources.py's test of wfsim_tpu's fetch, on the port:
    off by default; with ``WFSIM_TPU_ALLOW_DOWNLOAD=1`` an http
    ``url_base`` is tried first, then the public raw bases, into the
    cache, which serves the second call.  straxen is made unimportable,
    so its downloader is skipped."""
    import urllib.request
    monkeypatch.setitem(sys.modules, 'straxen', None)
    cfg = {'url_base': 'https://example.invalid/aux'}

    monkeypatch.delenv('WFSIM_TPU_ALLOW_DOWNLOAD', raising=False)
    calls = []
    monkeypatch.setattr(urllib.request, 'urlretrieve',
                        lambda url, dst: calls.append(url))
    assert loader.get_file_path(cfg, 'no_such_map.json') is None
    assert not calls

    monkeypatch.setenv('WFSIM_TPU_ALLOW_DOWNLOAD', '1')
    monkeypatch.setenv('WFSIM_TPU_DOWNLOAD_CACHE', str(tmp_path))

    def fake_retrieve(url, dst):
        calls.append(url)
        if url.startswith('https://example.invalid'):
            raise OSError('unreachable')
        with open(dst, 'w') as f:
            f.write('{"ok": 1}')
    monkeypatch.setattr(urllib.request, 'urlretrieve', fake_retrieve)
    p = loader.get_file_path(cfg, 'fax_map.json')
    assert p == str(tmp_path / 'fax_map.json')
    assert loader._read_any(p) == {'ok': 1}
    assert calls[0] == 'https://example.invalid/aux/fax_map.json'
    assert calls[1] == loader._GITHUB_RAW_BASES[0] + 'fax_map.json'
    n = len(calls)
    assert loader.get_file_path(cfg, 'fax_map.json') == p
    assert len(calls) == n
    assert not list(tmp_path.glob('*.part'))


# ---------------------------------------------------------------------------
# the sequential hitfinder


def waveform(seed, T=3000):
    """A noisy baseline with negative pulses of a few to tens of samples."""
    rng = np.random.default_rng(seed)
    w = 16_000 + rng.normal(0, 2.0, T)
    for s in rng.integers(0, T - 40, 40):
        w[s:s + rng.integers(1, 40)] -= rng.uniform(5, 60)
    return np.round(w).astype(np.int64)


HITFINDER_CASES = [(seed, thr, holdoff, K)
                   for seed, thr, holdoff, K in (
                       (1, 15_985, 0, 64), (2, 15_985, 1, 64),
                       (3, 15_990, 5, 64), (4, 15_960, 101, 64),
                       (5, 15_990, 3, 4), (6, 15_995, 1, 1),
                       (7, 15_000, 3, 8), (8, 16_010, 7, 16))]


@pytest.mark.parametrize('seed,thr,holdoff,K', HITFINDER_CASES)
def test_find_intervals_matches_jax(seed, thr, holdoff, K):
    """Bitwise wfsim_tpu's (count and buffer), a full buffer included;
    then, for holdoff >= 1 and trigger_window 0, the ZLE twin's intervals
    of the same samples on one channel."""
    w = waveform(seed)
    if seed == 8:
        w[-3:] = 15_000                 # a run that reaches the last sample
    ours = np.full((K, 2), -7, np.int64)
    ref = ours.copy()
    n = find_intervals_below_threshold(w, thr, holdoff, ours)
    assert n == jax_find_intervals(w, thr, holdoff, ref)
    np.testing.assert_array_equal(ours, ref)
    if seed == 7:
        assert n == 0
    elif seed in (5, 6):
        assert n == K                   # the buffer is full
        assert find_intervals_below_threshold(
            w, thr, holdoff, np.zeros((K + 64, 2), np.int64)) > K
    else:
        assert 0 < n < K
    if holdoff == 0:
        return                          # outside the twin's domain
    T = len(w)
    starts, ends, counts = zle_all_channels_ref(
        torch.from_numpy(w.astype(np.int16))[None],
        torch.tensor([thr], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
        torch.tensor([T - 1], dtype=torch.int32),
        torch.ones(1, dtype=torch.bool), holdoff=holdoff, trigger_window=0,
        max_intervals=K)
    assert int(counts[0]) == n
    even_start = np.minimum(ours[:n, 0], T - 1)
    np.testing.assert_array_equal(starts[0, :n].numpy(),
                                  (even_start + 1) // 2 * 2)
    np.testing.assert_array_equal(ends[0, :n].numpy(), ours[:n, 1] // 2 * 2)
