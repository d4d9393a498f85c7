"""The traced run's instruments: a profiler over whole bursts, spans
around the program's timed phases, and the byte and operation counts of
the superposition and PMT-afterpulse calls made while the profiler runs.

The busy union is ``chip_smoke.py busy_union`` / ``device_busy``
(``ab_port.py --busy``) with the union kept as intervals, so that the
idle gaps between them can be named; the bound arithmetic and the
superposition's counts are frozen copies of ``chip_smoke.py bound`` and
``superpose_measure``; the PMT-afterpulse count is ``chip_smoke.py
ap_work`` with its 32-byte sectors replaced by the bytes the algorithm
needs: each input byte read once, each output byte written once.
"""
from __future__ import annotations

import contextlib
import time

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
#: float32 and float64 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12

#: the device kernels of each roofline metric's calls
KERNELS = {
    'superpose': ('superpose_rows_kernel', 'sum_rows_kernel'),
    'pmt_afterpulse': ('ap_select_kernel', 'ap_rows_kernel',
                       'ap_emit_kernel'),
}

#: the breakdown's label of an idle gap inside no timed phase and no span
#: of the benchmark (``bench:...``)
UNTIMED = 'outside every span'


def bound_s(n_bytes, ops32=0, ops64=0) -> float:
    """The least time the call can take: the larger of the bytes over the
    memory rate and the operations over the peak rates."""
    return max(n_bytes / PEAK_BYTES, ops32 / PEAK_F32 + ops64 / PEAK_F64)


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Tracer:
    """A ``torch.profiler`` session started and stopped once, on burst
    starts, its span timed on the host's clock."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        self.cuda = device.type == 'cuda'
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.torch = torch
        self.device = device
        self.prof = profile(activities=acts)
        self.active = False
        self.done = False
        self.t0 = self.t1 = None

    def span(self, name: str):
        """A profiler range named ``name`` while the span is traced."""
        if not self.active:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def start(self):
        if self.active or self.done:
            return
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self):
        if not self.active:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.active = False
        self.done = True

    def result(self):
        """busy_s, window_s, the device seconds by kernel name and the
        breakdown (the ten kernels that took most device time, the ten
        host phases under which the device idled longest); None where no
        whole span was traced."""
        if not self.done:
            return None
        from torch.autograd import DeviceType
        evs = self.prof.events()
        # the phases' ranges also appear on the device's timeline as
        # annotations: only kernels, copies and sets count
        dev = [e for e in evs if e.device_type == DeviceType.CUDA
               and 'Activity Buffer' not in e.name
               and not e.name.startswith(('phase:', 'bench:'))]
        spans = [(e.time_range.start, e.time_range.end,
                  e.name[6:] if e.name.startswith('phase:') else e.name)
                 for e in evs if e.device_type == DeviceType.CPU
                 and e.name.startswith(('phase:', 'bench:'))]
        busy = merged((e.time_range.start, e.time_range.end) for e in dev)
        by_name = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e6
        starts = [e.time_range.start for e in evs]
        ends = [e.time_range.end for e in evs]
        gaps = {}
        if starts:
            edges = [[min(starts), min(starts)], *busy,
                     [max(ends), max(ends)]]
            for (_a, b), (c, _d) in zip(edges[:-1], edges[1:]):
                if c <= b:
                    continue
                mid = (b + c) / 2
                inside = [s for s in spans if s[0] <= mid <= s[1]]
                label = (min(inside, key=lambda s: s[1] - s[0])[2]
                         if inside else UNTIMED)
                gaps[label] = gaps.get(label, 0.0) + (c - b) / 1e6
        busy_s = sum(b - a for a, b in busy) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return dict(busy_s=busy_s, window_s=self.t1 - self.t0,
                    kernels=by_name,
                    breakdown=dict(device_ops=[[k, v] for k, v in top],
                                   idle_gaps=[[k, v] for k, v in idle]))


def _nbytes(*xs) -> int:
    import torch
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


class Hooks:
    """Wraps, while the tracer runs: each ``Timers.phase`` in a profiler
    range ``phase:<name>``, and the superposition and PMT-afterpulse
    wrappers, whose calls' bounds it keeps."""

    def __init__(self, tracer: Tracer):
        import torch
        from wfsim_tpu_torch.diagnostics import Timers
        from wfsim_tpu_torch.pipeline import digitize, rawdata
        self.tracer = tracer
        self.calls = {k: [] for k in KERNELS}
        self.undo = []
        orig_phase = Timers.__dict__['phase']
        record = torch.profiler.record_function

        @contextlib.contextmanager
        def phase(timers, name):
            if tracer.active:
                with record('phase:' + name), orig_phase(timers, name):
                    yield
            else:
                with orig_phase(timers, name):
                    yield
        self._patch(Timers, 'phase', phase)

        for name in ('superpose_adc', 'superpose_adc_full'):
            self._patch(digitize, name, self._wrap(
                getattr(digitize, name), self._superpose_work,
                'superpose'))
        self._patch(rawdata, 'pmt_afterpulse_photons', self._wrap(
            rawdata.pmt_afterpulse_photons, self._ap_work,
            'pmt_afterpulse'))

    def _patch(self, owner, name, new):
        self.undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, new)

    def close(self):
        for owner, name, old in reversed(self.undo):
            setattr(owner, name, old)
        self.undo = []

    def _wrap(self, fn, work, key):
        tracer = self.tracer
        calls = self.calls[key]

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if tracer.active:
                calls.append(work(args, kw, out))
            return out
        wrapped.__wrapped__ = fn
        return wrapped

    @staticmethod
    def _superpose_work(args, kw, out):
        """Bytes and operations of one superposition call, the parts that
        depend on the rows' extents as device scalars.  Bytes: the inputs,
        the int16 grid and an int16 bank read a windowed sample of every
        banked row; operations: a template tap a photon, the epilogue a
        TPC sample, the HE epilogue and the bottom sum."""
        import torch
        t, gain, row_ptr, templates, left, right, has = args[:7]
        bank, nix = kw.get('noise_bank'), kw.get('noise_ix')
        T = int(kw['n_samples'])
        C = int(kw.get('n_channels') or 0) or int(has.numel())
        B = int(has.numel()) // C
        he = kw.get('he_start') is not None
        span = torch.where(has, right - left + 1, 0).reshape(B, C)
        reads = span.new_zeros(())
        if bank is not None:
            reads = span[:, :min(C, int(bank.shape[0]))].sum()
            if he:
                reads = reads + span[:, :int(kw['n_top'])].sum()
        L = int(templates.shape[1])
        ops = int(t.numel()) * L * 2 + B * C * T * 3
        if he:
            n_top = int(kw['n_top'])
            ops += B * n_top * T * 4 + B * (C - n_top) * T * 2
        static = (_nbytes(t, gain, row_ptr, templates, left, right, has, nix)
                  + 2 * int(out.numel()))
        return dict(bytes=static, ops=ops, dyn_bytes=2 * reads,
                    dyn_ops=reads)

    @staticmethod
    def _ap_work(args, kw, out):
        """Bytes and operations of one PMT-afterpulse call (K11): the
        selection draw of every (element, valid photon) slot; per photon
        its channel, double-PE flag and valid flag; per selected slot its
        other draw, its photon's time, truth row and gain, the two delay
        values its inversion ends on (the least a slot reads) and its
        outputs (t, ch, gain, is_dpe, valid, truth row); per (element,
        channel) three table values; per truth row its count, t_min and
        t_max.  Operations: six a slot."""
        params, _const, photons, draws = args[:4]
        info = out[1]
        E = int(draws['u0'].shape[0])
        n = int(photons['t'].shape[0])
        C = int(params.pmt_ap_delay_cdf.shape[1])
        total = int(info['total'])
        rows = int(kw.get('n_truth_rows') or 0)
        static = (6 * n + total * (4 + 4 + 8 + 4 + 22 + 8) + E * C * 12
                  + rows * 12)
        return dict(bytes=static, ops=E * n * 6,
                    dyn_bytes=photons['valid'].sum() * (4 * E), dyn_ops=0)

    def result(self, trace_info) -> dict:
        """{metric key: (bound seconds, device seconds)} over the traced
        calls: the bounds summed, the device time of the calls' kernels
        summed from the trace."""
        if trace_info is None:
            return {}
        out = {}
        for key, calls in self.calls.items():
            if not calls:
                continue
            b = sum(bound_s(c['bytes'] + float(c['dyn_bytes']),
                            c['ops'] + float(c['dyn_ops'])) for c in calls)
            d = sum(s for name, s in trace_info['kernels'].items()
                    if any(k in name for k in KERNELS[key]))
            out[key] = (b, d, len(calls))
        return out
