"""The plain reference that decides ``correct``.

Plain NumPy and PyTorch; it imports nothing of the program.  The
physics passes have their reference in ``physics.py``.

* **Digitizer and records** (``digitize``): the photons of a digitize
  batch (the windows' photons in the order the program gathered them,
  window-relative times, channels, gains) go through the upstream
  digitizer (XENONnT/WFSim ``core/pulse.py:146-187, 276-318`` and
  ``core/rawdata.py:204-311, 398-458``): each window's per-channel extents,
  the SPE-template superposition (float32 products and sums, photon by
  photon in gather order within a channel), the ADC conversion
  (round half to even), the noise bank read at the window's offset, the
  baseline and the clip at 0 inside each channel's extent, on the full
  grid the high-energy copies of the top array, then zero-length encoding
  (runs below threshold merged across ``holdoff`` samples, padded by the
  trigger window, clipped and put on even samples, at most
  ``max_intervals`` a channel) and strax records of 110 samples.  The
  records are then the rows the program must deliver, in the chunk output
  their channel belongs to (``raw_records``, ``raw_records_he``,
  ``raw_records_aqmon``).

The superposition can run in another dtype (``acc_dtype``): the control
runs it in bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

SAMPLES_PER_RECORD = 110

RECORD_DTYPE = np.dtype([
    (('Start time since unix epoch [ns]', 'time'), np.int64),
    (('Length of the interval in samples', 'length'), np.int32),
    (('Width of one sample [ns]', 'dt'), np.int16),
    (('Channel/PMT number', 'channel'), np.int16),
    (('Length of pulse to which the record belongs (without zero-padding)',
      'pulse_length'), np.int32),
    (('Fragment number in the pulse', 'record_i'), np.int16),
    (('Baseline determined by the digitizer (if this is supported)',
      'baseline'), np.int16),
    (('Waveform data in raw ADC counts', 'data'), np.int16,
     SAMPLES_PER_RECORD),
])

OUTPUTS = ('raw_records', 'raw_records_he', 'raw_records_aqmon')


# ---------------------------------------------------------------------------
# inputs the benchmark makes: the noise bank and the SPE templates


def synthetic_noise(n_channels: int, length: int, sigma_adc: float,
                    seed: int) -> np.ndarray:
    """The synthetic noise bank (length, n_channels) int64: white Gaussian
    noise plus a slow component interpolated from a coarser draw (the
    recipe the configuration states)."""
    rng = np.random.default_rng(seed)
    white = rng.normal(0, sigma_adc, (length, n_channels))
    slow = rng.normal(0, sigma_adc / 2, (length // 100 + 2, n_channels))
    idx = np.linspace(0, slow.shape[0] - 1.001, length)
    i0 = idx.astype(int)
    w = (idx - i0)[:, None]
    drift = slow[i0] * (1 - w) + slow[i0 + 1] * w
    return np.round(white + drift).astype(np.int64)


def channel_major(bank: np.ndarray) -> np.ndarray:
    """(length, Cn) bank -> (Cn, length) int16."""
    return np.ascontiguousarray(np.asarray(bank).T.astype(np.int16))


def spe_templates(pe_pulse_ts, pe_pulse_ys, dt: int, before: int,
                  after: int) -> np.ndarray:
    """(dt, before + after) float32 SPE current templates, one per 1-ns
    phase of a photon's time within its sample (reference pulse.py:146-187):
    the pulse's CDF differenced over the sample edges, normalised."""
    ts = np.asarray(pe_pulse_ts, dtype=np.float64)
    cdf_y = np.cumsum(np.asarray(pe_pulse_ys, dtype=np.float64))
    edges = np.linspace(-before * dt, after * dt, 1 + before + after)
    out = []
    for r in range(dt):
        cur = np.diff(np.interp(edges - r, ts, cdf_y, left=0.0,
                                right=1.0)) / dt
        cur *= (1 / dt) / np.sum(cur)
        out.append(cur)
    return np.asarray(out, dtype=np.float32)


class Digitizer:
    """The digitizer's constants, read from the configuration dict."""

    def __init__(self, cfg: dict, bank: np.ndarray | None):
        cm = cfg['channel_map']
        self.dt = int(cfg['sample_duration'])
        self.C = int(cfg['n_tpc_pmts'])
        self.n_top = int(cfg['n_top_pmts'])
        self.he_start, self.he_end = (int(cm['he'][0]), int(cm['he'][1])) \
            if 'he' in cm else (None, None)
        self.deamp = int(cfg['high_energy_deamplification_factor'])
        self.baseline = int(cfg['digitizer_reference_baseline'])
        c2a = (cfg['pmt_circuit_load_resistor'] * cfg['external_amplification']
               / (cfg['digitizer_voltage_range']
                  / 2 ** cfg['digitizer_bits']))
        self.c2a = float(np.float32(c2a))
        self.threshold = self.baseline - int(cfg['zle_threshold']) - 1
        if cfg.get('special_thresholds'):
            raise NotImplementedError('special_thresholds')
        self.tw = int(cfg['trigger_window'])
        self.holdoff = 2 * self.tw + 1
        self.max_intervals = int(cfg.get('zle_max_intervals', 64))
        self.pad_left = (int(cfg['samples_to_store_before'])
                         + int(cfg['samples_before_pulse_center']))
        self.pad_right = (int(cfg['samples_to_store_after'])
                          + int(cfg['samples_after_pulse_center']))
        self.templates = spe_templates(
            cfg['pe_pulse_ts'], cfg['pe_pulse_ys'], self.dt,
            int(cfg['samples_before_pulse_center']),
            int(cfg['samples_after_pulse_center']))
        self.bank = None if not cfg.get('enable_noise') else bank
        # the full digitizer grid (reference rawdata.py:242 casts the
        # factor; a bank wider than the TPC also asks for it)
        self.full = self.deamp != 0 or (
            self.bank is not None and self.bank.shape[0] > self.C)
        self.he = (self.full and cfg['detector'] == 'XENONnT'
                   and self.he_start is not None)


# ---------------------------------------------------------------------------
# the digitizer


def _superpose(t, gain, row, n_rows, T, templates, acc_dtype):
    """(n_rows, T) current waveform: each photon adds ``gain *
    templates[t % dt]`` from sample ``t // dt``, products and sums in
    ``acc_dtype``, photon after photon in the given order within a row."""
    dt, L = templates.shape
    dev = t.device
    s = torch.div(t, dt, rounding_mode='floor')
    r = t - s * dt
    keep = s < T
    s, r, gain, row = s[keep], r[keep], gain[keep], row[keep]
    W = torch.zeros((n_rows, T + L), dtype=acc_dtype, device=dev)
    if row.numel() == 0:
        return W[:, :T]
    row_sorted, order = torch.sort(row, stable=True)
    counts = torch.bincount(row_sorted, minlength=n_rows)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(row.numel(), device=dev) - first[row_sorted]
    rank_sorted, o2 = torch.sort(rank, stable=True)
    by_rank = order[o2]
    sizes = torch.bincount(rank_sorted).tolist()
    k = torch.arange(L, device=dev)
    tm = torch.as_tensor(templates, device=dev).to(acc_dtype)
    g = gain.to(acc_dtype)
    pos = 0
    for n in sizes:
        sel = by_rank[pos:pos + n]
        pos += n
        rr = row[sel][:, None]
        cols = s[sel][:, None] + k[None, :]
        W[rr, cols] = W[rr, cols] + g[sel][:, None] * tm[r[sel]]
    return W[:, :T]


def _intervals(below, holdoff: int, K: int):
    """Runs of True per row of ``below`` merged across gaps of at most
    ``holdoff`` samples: (rows, starts, ends) of each row's first ``K``."""
    rows, cols = torch.nonzero(below, as_tuple=True)
    if rows.numel() == 0:
        e = rows.new_zeros(0)
        return e, e, e
    n = rows.numel()
    new_row = torch.ones(n, dtype=torch.bool, device=rows.device)
    new_row[1:] = rows[1:] != rows[:-1]
    gap = torch.zeros(n, dtype=torch.bool, device=rows.device)
    gap[1:] = (cols[1:] - cols[:-1]) > holdoff
    start = new_row | gap
    end = torch.zeros_like(start)
    end[:-1] = start[1:]
    end[-1] = True
    s_rows, s_cols = rows[start], cols[start]
    e_cols = cols[end]
    # the rank of each interval within its row: keep the first K
    first = torch.ones_like(s_rows, dtype=torch.bool)
    first[1:] = s_rows[1:] != s_rows[:-1]
    idx = torch.arange(s_rows.numel(), device=rows.device)
    row_first = torch.cummax(torch.where(first, idx, 0), 0).values
    keep = (idx - row_first) < K
    return s_rows[keep], s_cols[keep], e_cols[keep]


#: grid samples (windows x TPC rows x samples) the reference digitizes at
#: once; a batch's windows go in groups of at most this many
GROUP_SAMPLES = 2 ** 25


def digitize(dg: Digitizer, cap: dict, device, acc_dtype=torch.float32):
    """The strax records of one captured digitize batch, as a structured
    array of ``RECORD_DTYPE``.

    ``cap`` holds ``T`` (the batch's grid length), ``win_left`` (B,)
    absolute samples, ``noise_ix`` (B,), and per photon ``w`` (window),
    ``t`` (ns from the window's left edge), ``ch``, ``gain``, in the
    order the program gathered them (window, then its pieces).  Windows
    are independent: they are digitized in groups that fit
    ``GROUP_SAMPLES``."""
    B = len(cap['win_left'])
    per = max(1, GROUP_SAMPLES // (dg.C * int(cap['T'])))
    w = np.asarray(cap['w'])
    parts = []
    for lo in range(0, B, per):
        hi = min(B, lo + per)
        sel = (w >= lo) & (w < hi)
        sub = dict(T=cap['T'], win_left=cap['win_left'][lo:hi],
                   noise_ix=cap['noise_ix'][lo:hi], w=w[sel] - lo,
                   t=cap['t'][sel], ch=cap['ch'][sel],
                   gain=cap['gain'][sel])
        parts.append(_digitize_group(dg, sub, device, acc_dtype))
    return (np.concatenate(parts) if parts
            else np.zeros(0, RECORD_DTYPE))


def _digitize_group(dg: Digitizer, cap: dict, device, acc_dtype):
    """:func:`digitize` of a group of windows."""
    B = len(cap['win_left'])
    C, T, dt = dg.C, int(cap['T']), dg.dt
    t = torch.as_tensor(cap['t'], device=device).to(torch.int64)
    ch = torch.as_tensor(cap['ch'], device=device).to(torch.int64)
    gain = torch.as_tensor(cap['gain'], device=device).to(torch.float32)
    w = torch.as_tensor(cap['w'], device=device).to(torch.int64)
    ok = (ch >= 0) & (ch < C)
    t, ch, gain, w = t[ok], ch[ok], gain[ok], w[ok]
    R = B * C
    row = w * C + ch

    # each row's extent (reference pulse.py:117-127, rawdata.py:231-235)
    s = torch.div(t, dt, rounding_mode='floor')
    big = 2 ** 40
    smin = torch.full((R,), big, dtype=torch.int64, device=device)
    smax = torch.full((R,), -big, dtype=torch.int64, device=device)
    smin.scatter_reduce_(0, row, s, reduce='amin')
    smax.scatter_reduce_(0, row, s, reduce='amax')
    has = smax >= smin
    left = torch.clamp(smin - dg.pad_left - dg.tw, 0, T - 1)
    right = torch.clamp(smax + dg.pad_right + dg.tw, 0, T - 1)

    W = _superpose(t, gain, row, R, T, dg.templates, acc_dtype)
    adc = (-torch.round(W.to(torch.float32) * dg.c2a)).to(torch.int64)
    del W
    u = torch.arange(T, device=device)
    in_win = (u[None, :] >= left[:, None]) & (u[None, :] <= right[:, None]) \
        & has[:, None]

    def noise(cols, win_of_row, left_of_row):
        bank = torch.as_tensor(dg.bank, device=device)
        L = bank.shape[1]
        nix = torch.as_tensor(np.asarray(cap['noise_ix'], np.int64),
                              device=device)[win_of_row]
        x = torch.remainder(nix[:, None] + u[None, :] - left_of_row[:, None],
                            L)
        return bank[cols[:, None], x].to(torch.int64)

    rows_all = torch.arange(R, device=device)
    c_of = rows_all % C
    add = torch.full_like(adc, dg.baseline)
    if dg.bank is not None:
        on = c_of < dg.bank.shape[0]
        add[on] += noise(c_of[on], rows_all[on] // C, left[on])
    tpc = adc + torch.where(in_win, add, 0)
    tpc = torch.where(in_win, torch.clamp_min(tpc, 0), tpc)
    # the grid's rows: (window, grid channel, int16 samples, extent)
    grids = [(rows_all // C, c_of, _int16(tpc), left, right, has)]
    if dg.he:
        top = rows_all[c_of < dg.n_top]
        add = torch.full((top.numel(), T), dg.baseline, dtype=torch.int64,
                         device=device)
        cols = dg.he_start + top % C
        if dg.bank is not None:
            on = cols < dg.bank.shape[0]
            add[on] += noise(cols[on], top[on] // C, left[top[on]])
        win = in_win[top]
        he = _wrap_i32(adc[top] * dg.deamp + torch.where(win, add, 0))
        he = torch.where(win, torch.clamp_min(he, 0), he)
        grids.append((top // C, cols, _int16(he), left[top], right[top],
                      has[top]))
    del adc, add, in_win

    parts = [_records(dg, g, cap, device) for g in grids]
    recs = np.concatenate([p for p in parts]) if parts else \
        np.zeros(0, RECORD_DTYPE)
    return recs


def _int16(x):
    """The low 16 bits of int64 values, as int16 (an int32 grid cast)."""
    return (torch.remainder(x + 2 ** 15, 2 ** 16) - 2 ** 15).to(torch.int16)


def _wrap_i32(x):
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _records(dg: Digitizer, grid, cap, device) -> np.ndarray:
    """ZLE and record rows of one set of grid rows (see :func:`digitize`)."""
    win, chan, data, left, right, has = grid
    n, T = data.shape
    u = torch.arange(T, device=device)
    x = data.to(torch.int64)
    below = ((x < dg.threshold) & (u[None, :] >= left[:, None])
             & (u[None, :] <= right[:, None]) & has[:, None])
    if dg.full:
        below &= x >= 0
    rows, st, en = _intervals(below, dg.holdoff, dg.max_intervals)
    lo, hi = left[rows], right[rows] - left[rows]
    zero = torch.zeros_like(hi)
    st = torch.minimum(torch.maximum(st - lo - dg.tw, zero), hi)
    en = torch.minimum(torch.maximum(en - lo + dg.tw, zero), hi)
    st = torch.div(st + 1, 2, rounding_mode='floor') * 2
    en = torch.div(en, 2, rounding_mode='floor') * 2
    plen = en - st + 1
    spr = SAMPLES_PER_RECORD
    nrec = torch.where(plen > 0, torch.div(plen + spr - 1, spr,
                                           rounding_mode='floor'), 0)
    itv = torch.repeat_interleave(torch.arange(rows.numel(), device=device),
                                  nrec)
    first = torch.cumsum(nrec, 0) - nrec
    rec_i = torch.arange(itv.numel(), device=device) - first[itv]
    start = lo[itv] + st[itv] + rec_i * spr
    length = torch.clamp(plen[itv] - rec_i * spr, 0, spr)
    j = torch.arange(spr, device=device)
    colx = torch.clamp(start[:, None] + j[None, :], 0, T - 1)
    samples = data[rows[itv][:, None], colx]
    samples = torch.where(j[None, :] < length[:, None], samples, 0)
    wl = torch.as_tensor(np.asarray(cap['win_left'], np.int64),
                         device=device)
    out = np.zeros(itv.numel(), RECORD_DTYPE)
    out['time'] = ((wl[win[rows[itv]]] + start) * dg.dt).cpu().numpy()
    out['length'] = length.cpu().numpy()
    out['dt'] = dg.dt
    out['channel'] = chan[rows[itv]].cpu().numpy()
    out['pulse_length'] = plen[itv].cpu().numpy()
    out['record_i'] = rec_i.cpu().numpy()
    out['data'] = samples.cpu().numpy()
    return out


def output_of(channels: np.ndarray, dg: Digitizer) -> np.ndarray:
    """The chunk output (index into ``OUTPUTS``) of each channel: TPC
    channels to raw_records, the HE range to raw_records_he, the sum
    channel 800 to raw_records_aqmon; -1 where none takes it."""
    out = np.full(len(channels), -1, np.int8)
    out[channels < dg.C] = 0
    if dg.he_start is not None:
        out[(channels >= dg.he_start) & (channels <= dg.he_end)] = 1
    out[channels == 800] = 2
    return out


def by_output(recs: np.ndarray, dg: Digitizer) -> dict:
    """Records split into the chunk outputs their channels go to."""
    out = output_of(recs['channel'], dg)
    return {name: recs[out == i] for i, name in enumerate(OUTPUTS)}


def records_differing(program: dict, reference: np.ndarray,
                      dg: Digitizer) -> tuple[int, int]:
    """(rows in one side and not the other, counted with multiplicity,
    rows the reference expects): ``program`` maps each output name to its
    records in the compared windows; every field but the digitizer
    baseline is compared, with the output the row came out in."""
    def keyed(recs: np.ndarray, out_ix: np.ndarray) -> np.ndarray:
        recs = np.ascontiguousarray(recs)
        buf = np.zeros((len(recs), RECORD_DTYPE.itemsize + 1), np.uint8)
        r = recs.copy()
        r['baseline'] = 0
        buf[:, :-1] = r.view(np.uint8).reshape(len(r), RECORD_DTYPE.itemsize)
        buf[:, -1] = out_ix.astype(np.uint8)
        return buf
    ref_keys = keyed(reference, output_of(reference['channel'], dg))
    prog = [keyed(np.asarray(program[name]).astype(RECORD_DTYPE),
                  np.full(len(program[name]), i))
            for i, name in enumerate(OUTPUTS) if name in program]
    prog_keys = (np.concatenate(prog) if prog
                 else np.zeros((0, ref_keys.shape[1]), np.uint8))
    a = _counts(ref_keys)
    b = _counts(prog_keys)
    diff = sum(abs(a.get(k, 0) - b.get(k, 0)) for k in set(a) | set(b))
    return diff, len(reference)


def _counts(keys: np.ndarray) -> dict:
    if len(keys) == 0:
        return {}
    u, c = np.unique(keys, axis=0, return_counts=True)
    return {bytes(row): int(n) for row, n in zip(u, c)}
