"""The super-batch stream of wfsim_tpu_torch's ``RawData`` against
wfsim_tpu's on the CPU: the cuts and ``safe_t`` of
``_split_super_batches``, the flush-group deferral of a digitize round,
and what a multi-batch run changes and keeps.

Tolerances, per quantity:

- cuts and ``safe_t``: equal to wfsim_tpu's;
- a fixed pulse set digitized in rounds split by ``safe_t``: windows and
  records bitwise those of one round; the window framing (win_left,
  win_right, flush) of every round equal to wfsim_tpu's;
- depth 1 against depth 4 (the draws differ, as PARITY.md deviation 5
  says of wfsim_tpu): record counts within 5 %, S1 and S2 truth rows
  equal in number, afterpulse rows within 6 sigma + 3, photons within 6
  sigma; a rerun at depth 4 bitwise equal;
- the chunker yields its first chunk before the last super-batch is
  simulated.
"""
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.pipeline import digitize as jax_digitize
from wfsim_tpu.pipeline.rawdata import (RawDataTPU,
                                        _Pulse as JaxPulse)

from wfsim_tpu_torch import Simulator, ChunkRawRecords, RawData
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.pipeline.rawdata import _Pulse


# ---------------------------------------------------------------------------
# the cuts


def arrivals(pattern, n, rng):
    """Arrival times (ns) of ``n`` signals with gaps of one kind."""
    if pattern == 'events':         # bench-like: S1 then S2, 4 ms apart
        t = np.repeat((np.arange(n // 2) + 1) * 4_000_000, 2)
        t[1::2] += rng.integers(75_000, 700_000, n // 2)
        return t
    if pattern == 'bursts':         # clusters of 10, 1-3 ms between
        gaps = np.where(np.arange(n) % 10 == 0,
                        rng.integers(1_000_000, 3_000_000, n),
                        rng.integers(0, 50_000, n))
        return np.cumsum(gaps)
    if pattern == 'dense':          # no gap above the threshold
        return np.cumsum(rng.integers(0, 500_000, n))
    return np.cumsum(rng.exponential(800_000, n).astype(np.int64))


@pytest.mark.parametrize('depth', [1, 3, 4])
@pytest.mark.parametrize('pattern,n', [('events', 400), ('bursts', 400),
                                       ('dense', 400), ('poisson', 1000),
                                       ('events', 100)])
def test_split_super_batches_matches_jax(pattern, n, depth):
    rng = np.random.default_rng(n + depth)
    arrival = arrivals(pattern, n, rng)
    rng.shuffle(arrival)
    order = np.argsort(arrival, kind='stable')
    cfg = dict(default_config(), pipeline_depth=depth, pipeline_min_batch=32)
    ours = RawData._split_super_batches(types.SimpleNamespace(config=cfg),
                                        arrival, order)
    ref = RawDataTPU._split_super_batches(types.SimpleNamespace(config=cfg),
                                          arrival, order)
    assert len(ours) == len(ref)
    for (oa, ta), (ob, tb) in zip(ours, ref):
        np.testing.assert_array_equal(oa, ob)
        assert ta == tb
    if depth > 1 and pattern in ('events', 'bursts') and n >= 400:
        assert len(ours) == depth
    if pattern == 'dense':
        assert len(ours) == 1


# ---------------------------------------------------------------------------
# the deferral of a digitize round


PULSE_STARTS = (0, 35_000, 400_000, 3_000_000, 3_060_000, 9_000_000,
                9_150_000, 9_190_000)


def photon_buffers(seed):
    """One photon buffer per entry of :data:`PULSE_STARTS`: (t, ch, gain)
    numpy arrays relative to the pulse start."""
    rng = np.random.default_rng(seed)
    out = []
    for k, _ in enumerate(PULSE_STARTS):
        n = 200 + 50 * k
        out.append((np.sort(rng.integers(0, 20_000, n)).astype(np.int32),
                    rng.integers(0, 64, n).astype(np.int32),
                    rng.uniform(1e6, 3e6, n).astype(np.float32)))
    return out


def port_round_windows(splits, with_records=True):
    """The port's windows of the pulse set digitized in rounds, one per
    ``safe_t`` in ``splits``; each round adds the pulses that start before
    its ``safe_t``.  Returns (windows, buffer ids left after each round)."""
    rd = RawData(dict(default_config(), seed=7), device='cpu')
    bufs = photon_buffers(11)
    wins, left = [], []
    added = 0
    for safe_t in splits:
        while added < len(PULSE_STARTS) and PULSE_STARTS[added] < safe_t:
            t, ch, g = bufs[added]
            base = PULSE_STARTS[added]
            bid = rd._add_buffer(dict(t=torch.from_numpy(t),
                                      ch=torch.from_numpy(ch),
                                      gain=torch.from_numpy(g)))
            rd._pulses.append(_Pulse(bid, 0, len(t), int(t[0]) + base,
                                     int(t[-1]) + base, base))
            added += 1
        if with_records:
            w, recs = rd._collect_round(rd._dispatch_digitize(safe_t))
            wins.extend(dict(x, records=r) for x, r in zip(w, recs))
        else:
            wins.append([(x['win_left'], x['win_right'], x['flush'])
                         for x in rd._windows(safe_t)])
        left.append(sorted(rd._buffers))
    return wins, left


SPLITS = ([np.inf], [6_000_000, np.inf], [3_050_000, 9_100_000, np.inf],
          [100_000, 3_020_000, 9_180_000, np.inf])


@pytest.mark.parametrize('splits', SPLITS[1:])
def test_deferral_matches_single_round(splits):
    """The port of tests/test_pipeline.py's
    test_digitize_deferral_matches_single_round: a fixed pulse set
    digitized in rounds split by safe_t gives bitwise the windows and
    records of one round, and a round drops the buffers no deferred pulse
    uses."""
    single, _ = port_round_windows([np.inf])
    split, left = port_round_windows(splits)
    assert len(single) == len(split) >= 4
    for wa, wb in zip(single, split):
        assert (wa['win_left'], wa['win_right'], wa['flush']) == \
            (wb['win_left'], wb['win_right'], wb['flush'])
        np.testing.assert_array_equal(wa['records'], wb['records'])
    assert left[-1] == []
    if splits[0] == 6_000_000:
        # pulses 0-4 digitized in round 1; 5-7 had not arrived
        assert left[0] == []


def jax_round_windows(splits, monkeypatch):
    """wfsim_tpu's framing of the same pulse set in the same rounds
    (its digitize kernels stubbed: only the window descriptors are read)."""
    def stub(*args, **kwargs):
        z = jnp.int32(0)
        return dict(n_records=z, n_values=z, n_intervals=z)
    monkeypatch.setattr(jax_digitize, 'gather_digitize', stub)
    c = jax_default_config()
    c['seed'] = 7
    rd = RawDataTPU(c)
    rd._buffers, rd._buf_ctr, rd._pulses = {}, 0, []
    rd._pipeline_live = True
    bufs = photon_buffers(11)
    rounds = []
    added = 0
    for safe_t in splits:
        while added < len(PULSE_STARTS) and PULSE_STARTS[added] < safe_t:
            t, ch, g = bufs[added]
            base = PULSE_STARTS[added]
            bid = rd._append_buffer(dict(t=jnp.asarray(t), ch=jnp.asarray(ch),
                                         gain=jnp.asarray(g)), base)
            rd._pulses.append(JaxPulse(
                inst_idx=np.array([0]), buf=bid, buf_start=0,
                pool_count=len(t), t_min=int(t[0]) + base,
                t_max=int(t[-1]) + base, truth_key=-1, event_number=added,
                base_time=base))
            added += 1
        state = rd._dispatch_digitize(safe_t, int(c['right_raw_extension']),
                                      10)
        rounds.append([] if state is None else
                      [(w['win_left'], w['win_right'], w['flush'])
                       for w in state['wins']])
    return rounds


@pytest.mark.parametrize('splits', SPLITS)
def test_round_framing_matches_jax(splits, monkeypatch):
    ours, _ = port_round_windows(splits, with_records=False)
    ref = jax_round_windows(splits, monkeypatch)
    assert ours == ref
    assert sum(len(r) for r in ours) >= 4


# ---------------------------------------------------------------------------
# multi-batch runs


@pytest.mark.parametrize('noise', [False, True])
def test_super_batches_statistics(noise):
    """The port of tests/test_pipeline.py's
    test_pipelined_super_batches_statistics: depth 4 draws other numbers
    than depth 1 (the generator runs super-batch by super-batch), but from
    the same physics, and deterministically."""
    kw = dict(enable_noise=noise, enable_pmt_afterpulses=noise,
              enable_electron_afterpulses=noise)
    inst = bench_instructions(40)
    outs = {}
    for depth in (1, 4):
        c = default_config(seed=99, chunk_size=1000, pipeline_depth=depth,
                           pipeline_min_batch=16, **kw)
        sim = Simulator(c, device='cpu')
        outs[depth] = sim.get_arrays(inst)
        assert sim.sim.rawdata.diag.counts['super_batches'] == \
            (1 if depth == 1 else 4)
        if depth == 4:
            out2 = Simulator(c, device='cpu').get_arrays(inst)
            for k in ('raw_records', 'truth'):
                assert out2[k].tobytes() == outs[4][k].tobytes(), k
    a, b = outs[1], outs[4]
    assert abs(len(a['raw_records']) - len(b['raw_records'])) \
        < 0.05 * len(a['raw_records'])
    for typ in (1, 2):
        assert np.count_nonzero(a['truth']['type'] == typ) \
            == np.count_nonzero(b['truth']['type'] == typ) == 40
    n4a = np.count_nonzero(a['truth']['type'] > 2)
    n4b = np.count_nonzero(b['truth']['type'] > 2)
    assert abs(n4a - n4b) <= 6 * np.sqrt(max(n4a, 1)) + 3
    if noise:
        assert n4a > 0 and n4b > 0
    pa = a['truth']['n_photon'].sum()
    pb = b['truth']['n_photon'].sum()
    assert abs(pa - pb) < 6 * np.sqrt(pa)
    for out in (a, b):
        assert np.all(np.diff(out['raw_records']['time']) >= 0)


def test_chunker_yields_before_the_last_super_batch():
    """With 40 events in 4 super-batches and 20 ms chunks, the first chunk
    comes out before the last super-batch is simulated, and the truth
    buffer holds a super-batch and what is pending, never the run; it
    grows where the pending rows leave too little room."""
    c = default_config(seed=5, chunk_size=0.02, pipeline_depth=4,
                       pipeline_min_batch=16)
    chunker = ChunkRawRecords(c, device='cpu')
    inst = bench_instructions(40)
    seen, pending, n_truth = [], [], 0
    for chunk in chunker(inst):
        seen.append(chunker.rawdata.diag.counts['super_batches'])
        pending.append(int(chunker.truth_buffer['fill'].sum()))
        n_truth += len(chunk['truth'])
    assert seen[0] < 4 and seen[-1] == 4
    assert len(seen) >= 4
    assert n_truth == len(inst)
    assert max(pending) <= len(inst) // 2
    assert pending[-1] == 0

    buf = chunker.truth_buffer
    chunker.truth_buffer = np.zeros(3, buf.dtype)
    chunker._store_truth([dict(type=1, time=5)])
    chunker._store_truth([dict(type=2, time=t) for t in range(6)])
    tb = chunker.truth_buffer
    assert len(tb) >= 7 and int(tb['fill'].sum()) == 7
    assert sorted(tb['time'][tb['fill']].tolist()) == [0, 1, 2, 3, 4, 5, 5]
