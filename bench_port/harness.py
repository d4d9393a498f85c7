"""One run of one benchmark cell (see ``run.py``).

The run loads the cell's configuration and traffic files by name, draws
the instruction stream from the seed, builds the program's simulator and
iterates ``Simulator.run`` over the whole stream, chunk by chunk: the
stream's first burst of chunks is the warm-up, then the window lasts the
given seconds.  Each chunk is counted, the records of the sampled digitize
batches and the truth rows are kept, and the chunk is dropped.  After the
window the kept output is held to the plain reference (``reference.py``
for the digitizer and the records, ``physics.py`` for the truth) and the
metrics the cell reports are read by their readers
(``metrics/<name>.py``).

What the run takes from the program: the simulator, its ``Timers``
(``rawdata.diag``), the photons of a sampled digitize batch as the
digitizer receives them (by wrapping ``RawData.plan_digitize``), and, in a
traced run, the tensors of the superposition and PMT-afterpulse calls (by
wrapping their wrappers) and the profiler's kernel records.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import physics, reference, traffic, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / 'build' / 'bench_port'

#: top-level module names the run may never hold
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'wfsim_tpu')

#: the digitize rounds among which the compared batches are drawn (the
#: first, how many), and how many are drawn
CAPTURE_FIRST, CAPTURE_ROUNDS, CAPTURES = 3, 8, 2
#: the profiled span of a traced run: from the start of the window's burst
#: TRACE_FIRST (counted from 1) to the start of TRACE_FIRST + TRACE_BURSTS,
#: so it holds whole bursts (each one or more whole rounds)
TRACE_FIRST, TRACE_BURSTS = 2, 2
#: seconds past the window's close that a compared batch's records may take
LATE_S = 60.0


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    with open('/proc/uptime') as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf('SC_CLK_TCK')


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules
                   if m.split('.', 1)[0] in FORBIDDEN})


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config_file(bench: dict, name: str) -> dict:
    for c in bench['configs']:
        if c['name'] == name:
            return json.loads((ROOT / c['file']).read_text())
    raise KeyError(f'no configuration {name!r} in BENCHMARK.json')


def metric_names(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones (each where its ``workloads`` list names
    the cell, or everywhere without the list)."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in group
            if 'workloads' not in m or cell in m['workloads']]


def reader(name: str, metrics_dir: Path | None = None):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = (metrics_dir or HERE / 'metrics') / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(f'no reader for metric {name!r} ({path})')
    spec = importlib.util.spec_from_file_location(
        f'bench_port_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def production_dir(conf: dict) -> Path | None:
    """The configuration's production files, written once into a fixed
    directory of the checkout (``build/bench_port/<seed>``) and read by
    every later run; None where the configuration names none."""
    prod = conf.get('production_files')
    if not prod:
        return None
    from wfsim_tpu_torch.resources.synthetic import write_production_files
    out = CACHE / f'production_{int(prod["seed"])}_{int(prod["noise_length"])}'
    done = out / 'complete'
    if not done.is_file():
        tmp = out.with_name(out.name + f'.partial{os.getpid()}')
        write_production_files(tmp, int(prod['seed']),
                               noise_length=int(prod['noise_length']))
        (tmp / 'complete').write_text('ok\n')
        try:
            os.replace(tmp, out)
        except OSError:          # another run finished first
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def program_config(conf: dict, seed: int, n_instructions: int) -> dict:
    """The program's configuration dict of a configuration file."""
    from wfsim_tpu_torch import default_config
    over = dict(conf['overrides'])
    aux = production_dir(conf)
    if aux is not None:
        over['url_base'] = str(aux)
        over.update(conf['production_files']['files'])
    per = int(conf['stream']['instructions_per_super_batch'])
    over['pipeline_depth'] = max(1, -(-n_instructions // per))
    return default_config(conf['detector'], seed=int(seed) + 1, **over)


def reference_tables(conf: dict, cfg: dict) -> dict:
    """The reference's resource tables, each made from the recipe the
    configuration file states (``resources``): the noise bank (Cn, L)
    int16, the PMT-afterpulse species and the photoionization PMF (None
    where the effect is off), and ``files_differing``: the entries of the
    resource files the program reads that differ from those recipes."""
    res = conf['resources']
    out = dict(bank=None, elements=None, pmf=None, files_differing=0)
    if cfg.get('enable_noise'):
        spec = res['noise']
        bank = reference.synthetic_noise(
            int(spec['channels']), int(spec['length']),
            float(spec['sigma_adc']), int(spec['seed']))
        if spec['kind'] == 'file':
            with np.load(_resource_file(conf, cfg, spec)) as z:
                got = z['arr_0']
            out['files_differing'] += (
                int(np.count_nonzero(got != bank)) if got.shape == bank.shape
                else bank.size)
        out['bank'] = reference.channel_major(bank)
    if cfg.get('enable_pmt_afterpulses'):
        spec = res['pmt_afterpulses']
        out['elements'] = physics.pmt_ap_elements(int(cfg['n_tpc_pmts']),
                                                  float(spec['p_ap']))
        if spec['kind'] == 'file':
            got = json.loads(_resource_file(conf, cfg, spec).read_text())
            for name, el in out['elements'].items():
                for key in ('amplitude_cdf', 'delaytime_cdf'):
                    want = np.asarray(el[key])
                    want = want[0] if want.ndim == 2 else want
                    have = np.asarray(got.get(name, {}).get(key, []))
                    out['files_differing'] += (
                        int(np.count_nonzero(have != want))
                        if have.shape == want.shape else want.size)
    if cfg.get('enable_electron_afterpulses'):
        spec = res['electron_afterpulses']
        out['pmf'] = physics.ele_ap_pmf(float(spec['rate_per_photon']),
                                        int(spec['n_bins']),
                                        float(spec['t_max']))
    return out


def _resource_file(conf: dict, cfg: dict, spec: dict) -> Path:
    return Path(cfg['url_base']) / conf['production_files']['files'][
        spec['key']]


class Capture:
    """Wraps ``RawData.plan_digitize`` of one simulator: counts its rounds
    and copies the photons of the digitize batches drawn for the
    comparison."""

    def __init__(self, rawdata, seed: int):
        self.rd = rawdata
        rng = np.random.default_rng([int(seed), 7])
        self.rounds = set((CAPTURE_FIRST + rng.choice(
            CAPTURE_ROUNDS, CAPTURES, replace=False)).tolist())
        self.rng = rng
        self.round = 0
        self.batches = []
        from wfsim_tpu_torch.pipeline.rawdata import RawData
        self.cls = RawData
        self.orig = RawData.__dict__['plan_digitize']
        cap = self

        def plan_digitize(rd, safe_t=np.inf):
            out = cap.orig(rd, safe_t)
            if rd is cap.rd:
                cap.on_round(*out)
            return out
        RawData.plan_digitize = plan_digitize

    def close(self):
        self.cls.plan_digitize = self.orig

    def on_round(self, wins, arena, batches):
        """Called inside the program's ``digitize_plan`` and ``digitize``
        phases: the time spent here (a batch's copy) is the benchmark's,
        and is taken off both."""
        t0 = time.perf_counter()
        r = self.round
        self.round += 1
        if r in self.rounds and batches:
            j = int(self.rng.integers(len(batches)))
            self.batches.append(self.copy_batch(wins, arena, batches[j]))
        spent = time.perf_counter() - t0
        for phase in ('digitize_plan', 'digitize'):
            self.rd.diag.seconds[phase] -= spent

    def copy_batch(self, wins, arena, batch):
        """The batch's photons in gather order (window, then its pieces),
        window-relative times; pieces that continue each other in the
        arena are read back as one run."""
        ids, T_cap, pieces, nix = batch
        dt = self.rd.const.sample_duration
        runs = []                       # [arena lo, count, t offset, window]
        for bi in range(len(ids)):
            for lo, cnt, toff in pieces[bi]:
                if cnt <= 0:
                    continue
                if runs and runs[-1][3] == bi and runs[-1][2] == toff \
                        and runs[-1][0] + runs[-1][1] == lo:
                    runs[-1][1] += int(cnt)
                else:
                    runs.append([int(lo), int(cnt), int(toff), bi])
        ts, chs, gains, ws = [], [], [], []
        for lo, cnt, toff, bi in runs:
            sl = slice(lo, lo + cnt)
            ts.append(arena[0][sl].cpu().numpy().astype(np.int64) + toff)
            chs.append(arena[1][sl].cpu().numpy())
            gains.append(arena[2][sl].cpu().numpy())
            ws.append(np.full(cnt, bi, np.int64))

        def cat(xs, dtype):
            return np.concatenate(xs) if xs else np.zeros(0, dtype)
        left = np.asarray([wins[i]['win_left'] for i in ids], np.int64)
        right = np.asarray([wins[i]['win_right'] for i in ids], np.int64)
        return dict(T=int(T_cap), win_left=left, win_right=right,
                    t0=left * dt, t1=(right + 1) * dt,
                    noise_ix=np.asarray(nix, np.int64),
                    t=cat(ts, np.int64), ch=cat(chs, np.int32),
                    gain=cat(gains, np.float32), w=cat(ws, np.int64),
                    records={k: [] for k in reference.OUTPUTS},
                    delivered=False)


def truth_missing(instructions: np.ndarray, truth: np.ndarray,
                  horizon_ns: int) -> int:
    """S1 and S2 instructions before ``horizon_ns`` without exactly one
    truth row (missing rows plus rows delivered more than once)."""
    inst = instructions[np.isin(instructions['type'], (1, 2))
                        & (instructions['time'] < horizon_ns)]
    rows = truth[np.isin(truth['type'], (1, 2))]
    want = physics.row_keys(inst)
    u, c = np.unique(physics.row_keys(rows), return_counts=True)
    dup = int((c - 1).sum())
    missing = int((~np.isin(want, u)).sum())
    return missing + dup


class Stream:
    """What the run keeps of the chunks it receives."""

    def __init__(self, capture: Capture):
        self.cap = capture
        self.truth = []
        self.events = 0
        #: (seconds into the window, events delivered) at each burst's start
        self.bursts = []
        self.end_ns = None

    def take(self, chunk: dict, in_window: bool):
        truth = chunk['truth']
        self.truth.append(truth)
        if in_window:
            self.events += int((truth['type'] == 2).sum())
        self.end_ns = int(chunk['end'])
        for b in self.cap.batches:
            if b['delivered']:
                continue
            for name in reference.OUTPUTS:
                recs = chunk.get(name)
                if recs is None or not len(recs):
                    continue
                t = recs['time']
                lo, hi = np.searchsorted(t, b['t0'], 'left'), \
                    np.searchsorted(t, b['t1'], 'left')
                for a, z in zip(lo, hi):
                    if z > a:
                        b['records'][name].append(recs[a:z].copy())
            b['delivered'] = self.end_ns >= int(b['t1'].max())

    def pending(self) -> bool:
        return any(not b['delivered'] for b in self.cap.batches)


def _seconds(diag) -> dict:
    return {k: float(v) for k, v in diag.seconds.items()}


def _minus(a, b):
    """(Timers seconds, events, own seconds) a - b."""
    return ({k: v - b[0].get(k, 0.0) for k, v in a[0].items()},
            a[1] - b[1], a[2] - b[2])


def _next_chunk(gen, tracer=None) -> dict:
    """The stream's next chunk; in the traced span inside a profiler
    range, so that the device's idle time under the program's untimed
    code is told from the benchmark's own."""
    span = (tracer.span('bench:next chunk (Simulator.run)')
            if tracer is not None else contextlib.nullcontext())
    try:
        with span:
            return next(gen)
    except StopIteration:
        raise RuntimeError('the stream ended inside the window: the mix '
                           'needs more events') from None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = 'cuda', n_events: int | None = None,
             overrides: dict | None = None, bench: dict | None = None,
             fault=None, fault_config: dict | None = None,
             control: bool = False) -> dict:
    """One run; returns the result line's dict (``checks`` last).

    ``device='cuda'`` needs a card and raises without one.  ``n_events``
    shortens the stream and ``overrides`` change the configuration of
    both sides (the tests' small sizes); ``fault`` (a context manager
    factory taking the simulator) breaks the timed path underneath and
    ``fault_config`` changes the program's configuration alone: both
    plant faults, for the tests and ``control.py`` only.  ``control`` adds
    the control's numbers under ``compared`` (``control.py``)."""
    os.environ.setdefault('USE_FLAX', '0')
    os.environ['WFSIM_TPU_ALLOW_DOWNLOAD'] = '0'
    import torch
    if device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('the benchmark measures the card: '
                           'torch.cuda.is_available() is false')
    from wfsim_tpu_torch import Simulator

    bench = load_benchmark() if bench is None else bench
    cell = cell_of(bench, workload)
    conf = config_file(bench, cell['config'])
    mix = traffic.load_mix(cell['traffic'])
    dev = torch.device(device)

    # the stream (instruction rows only) and the program's configuration
    from wfsim_tpu_torch import default_config
    geo = default_config(conf['detector'], **conf['overrides'])
    inst = traffic.instructions(mix, seed, tpc_radius=geo['tpc_radius'],
                                tpc_length=geo['tpc_length'],
                                drift_field=geo['drift_field'],
                                n_events=n_events)
    cfg = program_config(conf, seed, len(inst))
    cfg.update(overrides or {})

    tracer = tracing.Tracer(dev) if trace else None
    sim = Simulator(dict(cfg, **fault_config) if fault_config else cfg,
                    device=dev)
    rd = sim.sim.rawdata
    cap = Capture(rd, seed)
    hooks = tracing.Hooks(tracer) if trace else None
    stream = Stream(cap)
    breaker = fault(sim) if fault is not None else contextlib.nullcontext()
    try:
        with breaker:
            gen = sim.run(inst)
            # chunks come in bursts, those of one round's collection; the
            # window runs from the first chunk of a burst to the first
            # chunk of the first burst that starts ``seconds`` later, and
            # counts the events of the bursts between.  The stream's first
            # burst is set-up: it loads the kernels and fills the pipeline,
            # the caches and the pools on the cell's own shapes (the
            # warm-up).
            chunk = _next_chunk(gen)
            first = cap.round
            while cap.round == first:
                stream.take(chunk, False)
                chunk = _next_chunk(gen)
            if dev.type == 'cuda':
                torch.cuda.reset_peak_memory_stats(dev)
            timers0 = _seconds(rd.diag)
            setup_s = process_age_s()
            t0 = time.perf_counter()
            burst = cap.round
            # the benchmark's own time between chunks (taking a chunk, the
            # profiler's start and stop): the program's chunker phase holds
            # it, as it holds all of its caller's time, and adds it when the
            # next chunk is asked for; so does ``own``
            own = pending = 0.0
            span = left_out = None
            while True:
                t_own = time.perf_counter()
                with (tracer.span('bench:chunk taken and checked')
                      if tracer is not None else contextlib.nullcontext()):
                    stream.take(chunk, True)
                del chunk
                own += pending + time.perf_counter() - t_own
                pending = 0.0
                chunk = _next_chunk(gen, tracer)
                if cap.round != burst:
                    now = time.perf_counter() - t0
                    stream.bursts.append((now, stream.events))
                    n = len(stream.bursts)
                    if tracer is not None and n in (
                            TRACE_FIRST, TRACE_FIRST + TRACE_BURSTS):
                        t_own = time.perf_counter()
                        if n == TRACE_FIRST:
                            tracer.start()
                        else:
                            tracer.stop()
                        pending = time.perf_counter() - t_own
                        state = (_seconds(rd.diag), stream.events, own)
                        if n == TRACE_FIRST:
                            span = state
                        elif span is not None:
                            left_out = _minus(state, span)
                    if now >= seconds:
                        break
                    burst = cap.round
            window_s = time.perf_counter() - t0
            # the per-layer times: the window's, less the profiled span
            # (the profiler slows the host) and less the benchmark's own
            timed = _minus((_seconds(rd.diag), stream.events, own),
                           (timers0, 0, 0.0))
            if left_out is not None:
                timed = _minus(timed, left_out)
            timers, timed_events, own_timed = timed
            timers['chunker_final'] = (timers.get('chunker_final', 0.0)
                                       - own_timed)
            if tracer is not None:
                tracer.stop()
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == 'cuda' else 0)
            # compared batches whose records are still to come: late,
            # not wrong
            stream.take(chunk, False)
            del chunk
            t_late = time.perf_counter()
            while stream.pending() and time.perf_counter() - t_late < LATE_S:
                try:
                    chunk = next(gen)
                except StopIteration:
                    break
                stream.take(chunk, False)
                del chunk
            gen.close()
    finally:
        cap.close()
        if hooks is not None:
            hooks.close()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f'modules of JAX or the JAX package loaded: '
                           f'{found}')
    trace_info = tracer.result() if tracer is not None else None
    roofline = hooks.result(trace_info) if hooks is not None else {}
    del sim, rd, gen
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    checks, compared = compare(conf, cfg, inst, stream, cap, dev,
                               control_seed=seed if control else None)
    correct = all(c['value'] <= c['limit'] for c in checks.values())

    ctx = dict(events=stream.events, window_s=window_s, setup_s=setup_s,
               peak_bytes=peak, timers=timers, timed_events=timed_events,
               trace=trace_info, roofline=roofline)
    metrics = {}
    for m in metric_names(bench, workload, trace):
        v = reader(m['name'])(ctx)
        if v is not None:
            metrics[m['name']] = dict(value=v, unit=m['unit'])
    kind = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'
    device_info = dict(platform='gpu' if dev.type == 'cuda' else 'cpu',
                       kind=kind, count=int(cell['chips']),
                       memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=int(stream.events),
               failed=int(checks['truth_missing']['value']),
               metrics=metrics, device=device_info, compared=compared,
               timers_s=timers, bursts=stream.bursts)
    if trace_info is not None:
        device_info['busy_s'] = trace_info['busy_s']
        device_info['window_s'] = trace_info['window_s']
        out['breakdown'] = trace_info['breakdown']
    out['checks'] = checks
    return out


#: the limits of the compared numbers (PERF.md gives the readings each
#: was set from: the sound runs' largest and the control's or a planted
#: fault's least): the records, the truth rows and the resource files
#: exact; each |z| above the geometric mean of its two readings and well
#: below the upper one
LIMITS = dict(records_differing=0, truth_missing=0, resource_files_differing=0,
              s1_photons_z=15.0, s2_electrons_z=100.0, s2_photons_z=10.0,
              electron_time_z=200.0, electron_spread_z=80.0, pmt_ap_z=8.0,
              ele_ap_z=35.0)
#: the physics numbers the control redraws (``physics.control_truth``)
CONTROL_PHYSICS = ('s2_electrons_z', 's2_photons_z')


def _in_windows(t: np.ndarray, t0: np.ndarray, t1: np.ndarray) -> np.ndarray:
    """Which times lie in one of the disjoint windows [t0, t1)."""
    order = np.argsort(t0)
    t0, t1 = t0[order], t1[order]
    k = np.searchsorted(t0, t, 'right') - 1
    ok = k >= 0
    ok[ok] = t[ok] < t1[k[ok]]
    return ok


def ap_counts(b: dict, truth: np.ndarray, n_channels: int) -> tuple:
    """(photons the digitizer received, the photons and photoelectrons of
    the truth rows whose first photon lies in one of the batch's
    windows) of a compared batch."""
    ch = b['ch']
    got = int(((ch >= 0) & (ch < n_channels)).sum())
    t = truth['t_first_photon']
    fin = np.isfinite(t)
    rows = truth[fin][_in_windows(t[fin], b['t0'].astype(np.float64),
                                  b['t1'].astype(np.float64))]
    return (got, int(rows['n_photon'].astype(np.int64).sum()),
            int(rows['n_pe'].astype(np.int64).sum()))


def compare(conf, cfg, inst, stream: Stream, cap: Capture, dev, *,
            control_seed: int | None = None):
    """The compared numbers, each with its limit: the sampled batches'
    records against the reference's, the truth rows' presence, the
    resource files against their recipes and the physics numbers
    (``physics.py``); and what was compared.  With ``control_seed`` also
    the control's numbers: the reference in the program's place in the
    precision below the configuration's (bfloat16 superposition; S2
    truth drawn with bfloat16 probabilities and yield)."""
    import torch
    truth = (np.concatenate(stream.truth) if stream.truth
             else np.zeros(0, inst.dtype))
    tables = reference_tables(conf, cfg)
    dg = reference.Digitizer(cfg, tables['bank'])
    differing = compared = ctrl_differing = 0
    for b in cap.batches:
        ref = reference.digitize(dg, b, dev)
        prog = {k: (np.concatenate(v) if v else
                    np.zeros(0, reference.RECORD_DTYPE))
                for k, v in b['records'].items()}
        d, n = reference.records_differing(prog, ref, dg)
        if not b['delivered']:
            d = max(d, n)
        differing += d
        compared += n
        if control_seed is not None:
            low = reference.digitize(dg, b, dev, acc_dtype=torch.bfloat16)
            ctrl_differing += reference.records_differing(
                reference.by_output(low, dg), ref, dg)[0]
    end = stream.end_ns or 0
    phys = physics.physics_numbers(
        cfg, truth, end, inst, elements=tables['elements'], pmf=tables['pmf'],
        ap_batches=[ap_counts(b, truth, dg.C) for b in cap.batches
                    if b['delivered']])

    def limited(name, value):
        return dict(value=value, limit=LIMITS[name])
    checks = dict(
        records_differing=limited('records_differing', differing),
        truth_missing=limited('truth_missing',
                              truth_missing(inst, truth, end - 2_000_000)),
        resource_files_differing=limited('resource_files_differing',
                                         tables['files_differing']))
    for name in ('s1_photons_z', 's2_electrons_z', 's2_photons_z',
                 'electron_time_z', 'electron_spread_z', 'pmt_ap_z',
                 'ele_ap_z'):
        if name in phys:
            checks[name] = limited(name, round(phys[name], 4))
    what = dict(batches=len(cap.batches), records=compared,
                rounds=cap.round, truth_rows=len(truth),
                **{k: v for k, v in phys.items() if not k.endswith('_z')})
    if control_seed is not None:
        low = physics.physics_numbers(
            cfg, physics.control_truth(cfg, truth, control_seed), end, inst)
        ctrl = dict(records_differing=limited('records_differing',
                                              ctrl_differing))
        for name in CONTROL_PHYSICS:
            ctrl[name] = limited(name, round(low[name], 4))
        what['control'] = ctrl
    return checks, what
