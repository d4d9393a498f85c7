"""Afterpulse models (counterpart of wfsim_tpu/models/afterpulse.py;
reference: wfsim/core/afterpulse.py).

1. PMT afterpulses (device): per incident photon and per ion species
   (element), a uniform draw against the channel's delay-time CDF selects
   an afterpulse photon; its delay and amplitude come from CDF inversions
   (reference: afterpulse.py:143-249).  Hand-written kernels with plain
   twins carry it (``csrc/pmt_afterpulse.cu``): *select* writes the
   selected (element, photon) slots as a bit mask and counts them by tile,
   *rows* gives each truth row its photon range and each (row, element)
   the offset of its first afterpulse, *emit* writes each selected slot's
   photon at its final position (grouped stably by truth row, without a
   sort); one ``torch.cumsum`` over the tile counts and one read-back of
   the total a call are the glue.  For the electron afterpulses, *valid
   tiles* writes the valid photons as a bit mask counted by tile and,
   after one ``torch.cumsum``, *summaries* gives each instruction its
   valid-photon count and draws its time-zero candidates, with nothing
   read back.  Eager torch knows the selected count before it allocates,
   so wfsim_tpu's ``ap_capacity`` and its capacity retries fall away.

2. Electron afterpulses (host): photoionization (pi_el, type 4) and gate
   photoelectric (pe_el, type 6) emit *new instructions* that re-enter the
   simulation (reference: afterpulse.py:14-139).  The device gives each
   instruction's photon count and candidate time-zeros
   (:func:`photon_summaries`); the numpy functions below, carried over
   unchanged from wfsim_tpu, synthesize the instructions.

Every stochastic function takes its draws explicitly, so the tests can
hand both packages the same uniforms.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._build import Kernel, P, I, F, check_tensor, ptr, stream_of
from ..ops.randsample import search_sorted_rows

__all__ = ['pmt_ap_draws', 'pmt_afterpulse_photons',
           'pmt_afterpulse_photons_ref', 'summary_draws', 'photon_summaries',
           'photon_summaries_ref', 'generate_pi_el_instructions',
           'generate_pe_el_instructions', 'reduce_instruction_timing']

#: time-zero candidates per instruction (wfsim_tpu photon_summaries default)
K_CANDIDATES = 64

_select_kernel = Kernel('wfsim_pmt_ap_select',
                        [P, P, P, P, P, I, I, P, I, P, P, F, I, P, P, P])
_rows_kernel = Kernel('wfsim_pmt_ap_rows',
                      [P, I, I, I, P, P, I, P, P, P, P, P, P])
_emit_kernel = Kernel('wfsim_pmt_ap_emit',
                      [P, P, P, I, I, P, P, P, P, P, P, P, I, I, I, P, I, I,
                       P, I, P, F, F, P, P, P, P, P, P, P, P, P, P, P, P])
_valid_tiles_kernel = Kernel('wfsim_ap_valid_tiles', [P, I, I, P, P, P])
_summ_kernel = Kernel('wfsim_ap_photon_summaries',
                      [P, P, I, P, P, I, I, P, P, P, P])


def pmt_ap_draws(gen, n_elements: int, n: int, device) -> dict:
    """The draws of :func:`pmt_afterpulse_photons`: three (E, n) float32
    uniforms ``u0``, ``u1``, ``u2`` per element and photon, as wfsim_tpu
    draws them from its three keys per element: the selection draw is
    ``1 - u0``, the auxiliary draw ``u1`` for a uniform element and
    ``1 - u2`` for any other."""
    return {k: torch.rand((n_elements, n), generator=gen, device=device,
                          dtype=torch.float32) for k in ('u0', 'u1', 'u2')}


def summary_draws(gen, n_inst: int, device, k: int = K_CANDIDATES):
    """The (n_inst, k) float32 uniforms of :func:`photon_summaries`."""
    return torch.rand((n_inst, k), generator=gen, device=device,
                      dtype=torch.float32)


# ---------------------------------------------------------------------------
# element metadata and the per-slot uniforms


@functools.lru_cache(maxsize=None)
def _element_tensors(uniform, delay_bin, amp_bin, device):
    return (torch.tensor(uniform, dtype=torch.bool, device=device),
            torch.tensor(delay_bin, dtype=torch.float32, device=device),
            torch.tensor(amp_bin, dtype=torch.float32, device=device))


def _meta(const, device):
    """Per-element (uniform, delay bin, amplitude bin) as (E,) tensors, made
    once per set of values and device (callers only read them)."""
    return _element_tensors(tuple(const.pmt_ap_element_uniform),
                            tuple(const.pmt_ap_delay_bin),
                            tuple(const.pmt_ap_amp_bin), torch.device(device))


def _uniforms(const, draws, uniform_e, is_dpe, e=None, i=None):
    """Selection draw rU0 and auxiliary draw per slot: (E, n) arrays, or
    the slots (e, i) only.  ``rU0 = (1 - u0) / pmt_ap_modifier``, halved
    for a double-PE photon (afterpulse.py:88-90); the divisor is a tensor,
    so the division is a true float32 division on every device."""
    u0, u1, u2 = draws['u0'], draws['u1'], draws['u2']
    if e is not None:
        u0, u1, u2, uni, dpe = u0[e, i], u1[e, i], u2[e, i], uniform_e[e], \
            is_dpe[i]
    else:
        uni, dpe = uniform_e[:, None], is_dpe[None, :]
    r0 = 1.0 - u0
    r0 = r0 / torch.full_like(r0, const.pmt_ap_modifier)
    r0 = torch.where(dpe, r0 / 2.0, r0)
    return r0, torch.where(uni, u1, 1.0 - u2)


def _argmin_abs_monotone(rows, row_idx, r):
    """Index minimizing ``|rows[row_idx, i] - r|`` on non-decreasing rows,
    the lower index on a tie (the reference's
    ``np.argmin(np.abs(cdf - r))``, afterpulse.py:219-233; wfsim_tpu
    afterpulse.py:29-52): the first index at or above r and its
    predecessor are the only candidates."""
    R = rows.shape[1]
    i1 = search_sorted_rows(rows, row_idx, r, side='left').to(torch.int64)
    i0 = torch.clamp(i1 - 1, 0, R - 1)
    row_idx = row_idx.to(torch.int64)
    v0, v1 = rows[row_idx, i0], rows[row_idx, i1]
    return torch.where((v0 - r).abs() <= (v1 - r).abs(), i0, i1)


# ---------------------------------------------------------------------------
# select: which (element, photon) slots make an afterpulse


def _select_ref(params, const, photons, draws):
    """(E, n) bool: photon valid, ``rU0 <= delay_cdf[e, ch, -1]`` and, for a
    non-uniform element, a positive amplitude: ``2 aux > amp_cdf[e, ch, 0]
    + amp_cdf[e, ch, 1]`` (argmin index 0 holds exactly when aux lies at or
    below that midpoint) and a positive amplitude bin (afterpulse.py:
    85-105)."""
    delay, amp = params.pmt_ap_delay_cdf, params.pmt_ap_amp_cdf
    C = delay.shape[1]
    dev = photons['t'].device
    uni, _dbin, abin = _meta(const, dev)
    chc = torch.clamp(photons['ch'], 0, C - 1).to(torch.int64)
    r0, aux = _uniforms(const, draws, uni, photons['is_dpe'])
    sel = photons['valid'][None, :] & (r0 <= delay[:, :, -1][:, chc])
    if amp.shape[2] >= 2:
        amp_pos = 2.0 * aux > amp[:, :, 0][:, chc] + amp[:, :, 1][:, chc]
    else:
        amp_pos = torch.zeros_like(sel)
    return sel & (uni[:, None] | (amp_pos & (abin > 0)[:, None]))


# ---------------------------------------------------------------------------
# emit: the afterpulse photon of each selected slot


def _emit_ref(params, const, photons, draws, take):
    """Per selected flat slot ``take = e * n + i``: time ``t[i] +
    trunc(delay)``, channel, gain ``gains[ch] * amp`` and truth row
    (afterpulse.py:131-162).  A uniform element's delay is ``(lo + aux (hi -
    lo)) * delay_bin`` from the row's first two CDF values and its
    amplitude 1; another element's delay is ``argmin|cdf - rU0| *
    delay_bin - pmt_ap_t_modifier`` and its amplitude ``argmin|amp_cdf -
    aux| * amp_bin``."""
    delay, amp = params.pmt_ap_delay_cdf, params.pmt_ap_amp_cdf
    E, C, Td = delay.shape
    n = photons['t'].shape[0]
    dev = photons['t'].device
    uni, dbin, abin = _meta(const, dev)
    e_of, i_of = take // n, take % n
    ch_s = torch.clamp(photons['ch'][i_of], 0, C - 1).to(torch.int64)
    r0, aux = _uniforms(const, draws, uni, photons['is_dpe'], e_of, i_of)
    ridx = e_of * C + ch_s
    drows = delay.reshape(E * C, Td)
    arows = amp.reshape(E * C, -1)
    uniform_e = uni[e_of]
    delay_bin = dbin[e_of]
    lo0, hi0 = drows[ridx, 0], drows[ridx, min(1, Td - 1)]
    delay_u = (lo0 + aux * (hi0 - lo0)) * delay_bin
    didx = _argmin_abs_monotone(drows, ridx, r0)
    delay_s = didx.to(torch.float32) * delay_bin - const.pmt_ap_t_modifier
    ap_delay = torch.where(uniform_e, delay_u, delay_s)
    aidx = _argmin_abs_monotone(arows, ridx, aux)
    amp_s = torch.where(uniform_e, 1.0, aidx.to(torch.float32) * abin[e_of])
    # float32 -> int32 truncates toward zero, as astype does (delays reach
    # down to -pmt_ap_t_modifier, so the sign matters)
    t = photons['t'][i_of] + ap_delay.to(torch.int32)
    return (t.to(torch.int32), photons['ch'][i_of],
            params.gains[ch_s] * amp_s, photons['truth_row'][i_of])


# ---------------------------------------------------------------------------
# the full generator


def _check_ap_inputs(params, const, photons, draws):
    E, C, Td = params.pmt_ap_delay_cdf.shape
    n = photons['t'].shape[0]
    dev = photons['t'].device
    if E * n >= 2 ** 31:
        raise ValueError(f'{E} x {n} afterpulse slots exceed int32')
    if len(const.pmt_ap_element_uniform) != E:
        raise ValueError(f'{E} afterpulse elements in the tables, '
                         f'{len(const.pmt_ap_element_uniform)} in the constants')
    if any(const.pmt_ap_element_uniform) and Td < 2:
        raise ValueError('a uniform afterpulse element needs >= 2 delay bins')
    for name, x, dtype, shape in (
            ('t', photons['t'], torch.int32, (n,)),
            ('ch', photons['ch'], torch.int32, (n,)),
            ('is_dpe', photons['is_dpe'], torch.bool, (n,)),
            ('valid', photons['valid'], torch.bool, (n,)),
            ('truth_row', photons['truth_row'], torch.int64, (n,)),
            ('u0', draws['u0'], torch.float32, (E, n)),
            ('u1', draws['u1'], torch.float32, (E, n)),
            ('u2', draws['u2'], torch.float32, (E, n))):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev \
                or not x.is_contiguous():
            raise TypeError(f'{name}: need contiguous {dtype} {shape} on '
                            f'{dev}, got {x.dtype} {tuple(x.shape)} on '
                            f'{x.device}')
    for name, x in (('pmt_ap_delay_cdf', params.pmt_ap_delay_cdf),
                    ('pmt_ap_amp_cdf', params.pmt_ap_amp_cdf),
                    ('gains', params.gains)):
        if x.dtype != torch.float32 or x.device != dev \
                or not x.is_contiguous():
            raise TypeError(f'{name}: need contiguous float32 on {dev}')


def _afterpulses(params, const, photons, draws, n_truth_rows, select, emit):
    _check_ap_inputs(params, const, photons, draws)
    dev = photons['t'].device
    sel = select(params, const, photons, draws)
    # flat element-major slot order, as wfsim_tpu compacts (:120-136)
    take = torch.nonzero(sel.reshape(-1)).squeeze(1)
    t, ch, gain, row = emit(params, const, photons, draws, take)
    row, order = torch.sort(row, stable=True)
    total = int(take.shape[0])
    out = dict(t=t[order], ch=ch[order], gain=gain[order],
               is_dpe=torch.zeros(total, dtype=torch.bool, device=dev),
               valid=torch.ones(total, dtype=torch.bool, device=dev),
               truth_row=row)
    info = dict(total=total)
    if n_truth_rows:
        BIG = 2 ** 31 - 1
        info['counts'] = torch.bincount(row, minlength=n_truth_rows).to(
            torch.int32)
        info['t_min'] = torch.full((n_truth_rows,), BIG, dtype=torch.int32,
                                   device=dev).scatter_reduce_(
            0, row, out['t'], reduce='amin')
        info['t_max'] = torch.full((n_truth_rows,), -BIG, dtype=torch.int32,
                                   device=dev).scatter_reduce_(
            0, row, out['t'], reduce='amax')
    return out, info


#: photons a tile of the select and emit kernels (32 mask words)
_TILE = 1024


@functools.lru_cache(maxsize=2)
def _select_limits(delay, amp):
    """(E, C, 2) float32: per (element, channel) the delay row's last value
    and the sum of the amplitude row's first two (NaN without two), what
    the select kernel compares a slot's draws with; made once per pair of
    tables (the tables are never written after they are built)."""
    mid = (amp[:, :, 0] + amp[:, :, 1] if amp.shape[2] >= 2
           else torch.full_like(amp[:, :, 0], float('nan')))
    return torch.stack([delay[:, :, -1], mid], dim=-1).contiguous()


#: the afterpulse photons' fields and dtypes
_AP_FIELDS = dict(t=torch.int32, ch=torch.int32, gain=torch.float32,
                  is_dpe=torch.bool, valid=torch.bool, truth_row=torch.int64)


def _empty_afterpulses(dev, n_truth_rows):
    out = {k: torch.empty(0, dtype=d, device=dev)
           for k, d in _AP_FIELDS.items()}
    info = dict(total=0)
    if n_truth_rows:
        BIG = 2 ** 31 - 1
        i32 = dict(dtype=torch.int32, device=dev)
        info.update(counts=torch.zeros(n_truth_rows, **i32),
                    t_min=torch.full((n_truth_rows,), BIG, **i32),
                    t_max=torch.full((n_truth_rows,), -BIG, **i32))
    return out, info


def _afterpulses_cuda(params, const, photons, draws, n_truth_rows):
    """The select, rows and emit kernels: one cumsum over the tile counts
    and one read-back of [total, status] between rows and emit (a second
    one, of the last truth row, only without ``n_truth_rows``)."""
    _check_ap_inputs(params, const, photons, draws)
    delay, amp = params.pmt_ap_delay_cdf, params.pmt_ap_amp_cdf
    E, C, Td = delay.shape
    Ta = amp.shape[2]
    dev = photons['t'].device
    n = photons['t'].shape[0]
    if n == 0:
        return _empty_afterpulses(dev, n_truth_rows)
    if E > 32:
        raise ValueError(f'{E} afterpulse elements: the kernels take 32')
    R = n_truth_rows or int(photons['truth_row'][-1]) + 1
    if not 0 < R <= (2 ** 31 - 1) // E:
        raise ValueError(f'{R} truth rows: need 1 to 2^31 / {E}')
    uni, dbin, abin = _meta(const, dev)
    modifier = float(np.float32(const.pmt_ap_modifier))
    n_tiles = -(-n // _TILE)
    stream = stream_of(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    mask = torch.empty((E, -(-n // 32)), **i32)
    tile_counts = torch.empty(E * n_tiles, **i32)
    _select_kernel(ptr(draws['u0']), ptr(draws['u2']), ptr(photons['ch']),
                   ptr(photons['is_dpe']), ptr(photons['valid']), n, E,
                   ptr(_select_limits(delay, amp)), C, ptr(uni), ptr(abin),
                   modifier, n_tiles, ptr(mask), ptr(tile_counts), stream)
    # the (element, tile) order is the flat element-major slot order
    incl = torch.cumsum(tile_counts, 0, dtype=torch.int32)
    offsets = torch.empty(R * E, **i32)
    counts, t_min, t_max = (torch.empty(R, **i32) for _ in range(3))
    status = torch.empty(2, **i32)
    _rows_kernel(ptr(photons['truth_row']), n, R, E, ptr(mask), ptr(incl),
                 n_tiles, ptr(offsets), ptr(counts), ptr(t_min), ptr(t_max),
                 ptr(status), stream)
    total, bad = status.cpu().tolist()       # the call's one read-back
    if bad:
        raise ValueError(f'truth rows outside [0, {R})')
    out = {k: torch.empty(total, dtype=d, device=dev)
           for k, d in _AP_FIELDS.items()}
    if total:
        _emit_kernel(ptr(mask), ptr(incl), ptr(offsets), n_tiles, total,
                     ptr(draws['u0']), ptr(draws['u1']), ptr(draws['u2']),
                     ptr(photons['t']), ptr(photons['ch']),
                     ptr(photons['is_dpe']), ptr(photons['truth_row']), n, E,
                     R, ptr(delay), C, Td, ptr(amp), Ta, ptr(params.gains),
                     modifier, float(np.float32(const.pmt_ap_t_modifier)),
                     ptr(uni), ptr(dbin), ptr(abin),
                     *(ptr(x) for x in out.values()),
                     ptr(t_min), ptr(t_max), stream)
    info = dict(total=total)
    if n_truth_rows:
        info.update(counts=counts, t_min=t_min, t_max=t_max)
    return out, info


def pmt_afterpulse_photons(params, const, photons, draws, *,
                           n_truth_rows: int = 0):
    """PMT afterpulse photons of a primary photon batch.

    :param photons: dict from ``pmt_response``: t (int32), ch (int32),
        is_dpe, valid (bool), truth_row (int64, ascending, in [0,
        n_truth_rows) when that is given)
    :param draws: dict from :func:`pmt_ap_draws`
    :returns: (photons, info): the afterpulse photons with preset gains
        (t, ch, gain, is_dpe, valid, truth_row), grouped stably by truth row,
        and info with ``total`` and, for ``n_truth_rows``, the per-row
        ``counts``, ``t_min`` and ``t_max``

    CPU tensors run the plain twins; CUDA tensors launch the select, rows
    and emit kernels (``csrc/pmt_afterpulse.cu``) and read back once; a
    truth row outside [0, n_truth_rows) raises there."""
    dev = photons['t'].device
    if dev.type == 'cpu':
        return _afterpulses(params, const, photons, draws, n_truth_rows,
                            _select_ref, _emit_ref)
    if dev.type != 'cuda':
        raise NotImplementedError(f'pmt afterpulses on {dev}')
    return _afterpulses_cuda(params, const, photons, draws, n_truth_rows)


def pmt_afterpulse_photons_ref(params, const, photons, draws, *,
                               n_truth_rows: int = 0):
    """Plain twin of :func:`pmt_afterpulse_photons` on any device."""
    return _afterpulses(params, const, photons, draws, n_truth_rows,
                        _select_ref, _emit_ref)


# ---------------------------------------------------------------------------
# photon summaries for the electron afterpulses


def _summary_plan(photons, n_inst):
    valid = photons['valid']
    counts = torch.bincount(photons['truth_row'][valid],
                            minlength=n_inst)[:n_inst].to(torch.int32)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return counts, offsets


def _summaries_ref(t, counts, offsets, u):
    n = t.shape[0]
    cnt = torch.clamp_min(counts, 1).to(torch.float32)
    slot = offsets[:, None].to(torch.int64) \
        + (u * cnt[:, None]).to(torch.int32)
    return t[torch.clamp(slot, 0, max(n - 1, 0))]


def photon_summaries_ref(photons, u, *, n_inst: int):
    """Plain twin of :func:`photon_summaries` on any device."""
    counts, offsets = _summary_plan(photons, n_inst)
    if photons['t'].shape[0] == 0:       # no photon to draw a time from
        return counts, torch.zeros(u.shape, dtype=torch.int32,
                                   device=u.device)
    return counts, _summaries_ref(photons['t'], counts, offsets, u)


def _summaries_cuda(photons, u, n_inst):
    """The valid-tiles kernel, one cumsum over its tile counts and the
    summaries kernel; nothing read back."""
    t, valid, rows = photons['t'], photons['valid'], photons['truth_row']
    dev = t.device
    n, K = t.shape[0], u.shape[1]
    for name, x, dtype in (('valid', valid, torch.bool),
                           ('truth_row', rows, torch.int64)):
        check_tensor(name, x, dtype, (n,), dev)
    if n >= 2 ** 31 or n_inst * K >= 2 ** 31:
        raise ValueError(f'{n} photons, {n_inst} x {K} candidates: the '
                         f'kernels take fewer than 2^31')
    i32 = dict(dtype=torch.int32, device=dev)
    if n == 0:                           # no photon to draw a time from
        return torch.zeros(n_inst, **i32), torch.zeros((n_inst, K), **i32)
    counts = torch.empty(n_inst, **i32)
    out = torch.empty((n_inst, K), **i32)
    if n_inst == 0:
        return counts, out
    n_tiles = -(-n // _TILE)
    stream = stream_of(dev)
    mask = torch.empty(-(-n // 32), **i32)
    tile_counts = torch.empty(n_tiles, **i32)
    _valid_tiles_kernel(ptr(valid), n, n_tiles, ptr(mask), ptr(tile_counts),
                        stream)
    incl = torch.cumsum(tile_counts, 0, dtype=torch.int32)
    _summ_kernel(ptr(t), ptr(rows), n, ptr(mask), ptr(incl), n_inst, K,
                 ptr(u), ptr(counts), ptr(out), stream)
    return counts, out


def photon_summaries(photons, u, *, n_inst: int):
    """Per-instruction valid-photon counts and random time-zero candidates
    for the electron afterpulses (wfsim_tpu afterpulse.py:183-198; the
    reference samples t-zeros from the pulse's photons, afterpulse.py:
    48-51).

    Candidate ``k`` of instruction ``i`` is ``t[offset[i] + floor(u[i, k] *
    max(count[i], 1))]``, clipped to the array: the counts are of valid
    photons and the slot indexes the full array, invalid photons included,
    exactly as wfsim_tpu does.

    :param photons: dict with t (int32), valid (bool), truth_row (int64,
        ascending, invalid photons included)
    :param u: (n_inst, K) float32 uniforms (:func:`summary_draws`)
    :returns: (counts (n_inst,) int32, t_zero (n_inst, K) int32)

    CPU tensors run the plain twin; CUDA tensors launch the valid-tiles and
    summaries kernels (``csrc/pmt_afterpulse.cu``) and read nothing back
    (rows below 0 count nowhere there; the twin raises on them)."""
    t = photons['t']
    dev = t.device
    if t.dtype != torch.int32 or u.dtype != torch.float32 \
            or u.dim() != 2 or u.shape[0] != n_inst or u.device != dev \
            or not (t.is_contiguous() and u.is_contiguous()):
        raise TypeError('photon_summaries: need contiguous int32 t and '
                        f'float32 (n_inst, K) u on {dev}')
    if dev.type == 'cpu':
        return photon_summaries_ref(photons, u, n_inst=n_inst)
    if dev.type != 'cuda':
        raise NotImplementedError(f'photon_summaries on {dev}')
    return _summaries_cuda(photons, u, n_inst)


# ---------------------------------------------------------------------------
# host: electron-afterpulse instruction synthesis (numpy, as wfsim_tpu)


_coarse_grid_cache: dict = {}


def _coarse_grid(bin_centers, config):
    """The diffusion-matched coarse delay grid of reduce_instruction_timing.
    It depends only on (bin_centers, two config scalars), not on the delays
    being binned, so it is built once per key and cached."""
    bc = np.asarray(bin_centers)
    key = (bc.tobytes(), float(config['diffusion_constant_longitudinal']),
           float(config['drift_velocity_liquid']))
    coarse = _coarse_grid_cache.get(key)
    if coarse is None:
        spread = np.sqrt(2 * config['diffusion_constant_longitudinal'] * bc)
        spread = spread / config['drift_velocity_liquid']
        grid, ct = [], 100.0
        while ct < bc[-1]:
            grid.append(ct)
            ct += spread[np.argmin(np.abs(ct - bc))]
        coarse = np.array(grid)
        if len(_coarse_grid_cache) > 16:
            _coarse_grid_cache.clear()
        _coarse_grid_cache[key] = coarse
    return coarse


def reduce_instruction_timing(ap_delay, bin_centers, config):
    """Coarse-bin photoionization delays so electrons that diffuse together
    share one instruction (reference: afterpulse.py:63-80)."""
    coarse = _coarse_grid(bin_centers, config)
    sel = ap_delay < coarse[-1]
    idx = np.digitize(ap_delay[sel], coarse)
    idxs, n = np.unique(idx, return_counts=True)
    return coarse[np.clip(idxs, 0, len(coarse) - 1)], n


def generate_pi_el_instructions(config, resource, rng, counts, t_zero_cand,
                                source_inst, base_time):
    """Photoionization (pi_el, type 4) instruction synthesis (reference:
    afterpulse.py:29-61), one pass over the source S2 instructions.

    :param counts: per-source-instruction detected photon counts (numpy)
    :param t_zero_cand: (I, K) candidate photon times (batch-relative)
    :param source_inst: the numpy instruction array the photons came from
    :param base_time: int64 absolute base of the relative times
    :returns: numpy instruction array (possibly empty)
    """
    hist = resource.uniform_to_ele_ap
    out = []
    for i in range(len(source_inst)):
        n_photons = int(counts[i])
        if n_photons <= 0:
            continue
        n_electron = rng.poisson(hist.n * n_photons
                                 * config['photoionization_modifier'])
        if n_electron <= 0:
            continue
        ap_delay = hist.get_random(n_electron, rng=rng)
        delay_i, n_i = reduce_instruction_timing(ap_delay, hist.bin_centers,
                                                 config)
        n_instruction = len(delay_i)
        if n_instruction == 0:
            continue
        cand = t_zero_cand[i]
        # cand holds int32 batch-relative times; promote before adding the
        # int64 absolute base (spans past ~2.1 s overflow int32)
        t_zeros = base_time + cand[rng.integers(
            0, len(cand), n_instruction)].astype(np.int64)
        new = np.repeat(source_inst[i:i + 1], n_instruction)
        new['type'] = 4
        new['time'] = t_zeros - config['drift_time_gate']
        r = np.sqrt(rng.uniform(0, config['tpc_radius'] ** 2, n_instruction))
        angle = rng.uniform(-np.pi, np.pi, n_instruction)
        new['x'], new['y'] = r * np.cos(angle), r * np.sin(angle)
        new['z'] = -delay_i * config['drift_velocity_liquid']
        new['amp'] = n_i
        out.append(new)
    if not out:
        return np.zeros(0, dtype=source_inst.dtype)
    return np.concatenate(out)


def generate_pe_el_instructions(config, rng, counts, t_zero_cand,
                                source_inst, base_time):
    """Gate photoelectric (pe_el, type 6) instruction synthesis (reference:
    afterpulse.py:92-139)."""
    out = []
    for i in range(len(source_inst)):
        n_photons = int(counts[i])
        if n_photons <= 0:
            continue
        n_electron = rng.poisson(config['photoelectric_p'] * n_photons
                                 * config['photoelectric_modifier'])
        if n_electron <= 0:
            continue
        ap_delay = np.clip(
            rng.normal(config['photoelectric_t_center']
                       + config['drift_time_gate'],
                       config['photoelectric_t_spread'], n_electron), 0, None)
        cand = t_zero_cand[i]
        t_zeros = base_time + cand[rng.integers(
            0, len(cand), n_electron)].astype(np.int64)
        new = np.repeat(source_inst[i:i + 1], n_electron)
        new['type'] = 6
        new['time'] = t_zeros + config['drift_time_gate']
        r = np.sqrt(rng.uniform(0, config['tpc_radius'] ** 2, n_electron))
        angle = rng.uniform(-np.pi, np.pi, n_electron)
        new['x'], new['y'] = r * np.cos(angle), r * np.sin(angle)
        new['z'] = -ap_delay * config['drift_velocity_liquid']
        new['amp'] = 1
        out.append(new)
    if not out:
        return np.zeros(0, dtype=source_inst.dtype)
    return np.concatenate(out)
