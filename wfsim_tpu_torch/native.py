"""Host numpy counterpart of wfsim_tpu/native.py.

``find_intervals_below_threshold`` is the reference's sequential
hitfinder (reference: wfsim/utils.py:14-58), the numpy path of
wfsim_tpu's function: same signature, same return value, same writes
into ``result_buffer``.  It is plain Python over the samples, for
checks and single waveforms; the pipeline's ZLE runs every channel at
once (``ops.zle``).  wfsim_tpu's optional C extension is not ported:
the port builds nothing but its CUDA kernels.

Left out, with the encoded transport they serve (ROADMAP "Code the port
leaves out"; the port ships dense records): ``pack_windows``, which packs
photon-pool ranges into padded device inputs, and
``decode_residual_records``, which decodes wfsim_tpu's residual record
stream.
"""
from __future__ import annotations

__all__ = ['find_intervals_below_threshold']


def find_intervals_below_threshold(w, threshold, holdoff, result_buffer):
    """Write the runs of ``w`` below ``threshold`` into ``result_buffer``
    ((K, 2): first and last sample of each run) and return their number.

    A run ends at the first sample at or above threshold at least
    ``holdoff`` samples past its last sample below (so runs closer than
    that merge), or at the end of ``w``.  Once K runs are stored the scan
    stops at the next run's end, and K is returned (wfsim_tpu
    native.py:109-138)."""
    n = 0
    in_interval = False
    start = end = -1
    T = len(w)
    K = len(result_buffer)
    for i, x in enumerate(w):
        if x < threshold:
            if not in_interval:
                in_interval = True
                start = i
            end = i
        if in_interval and ((i == T - 1)
                            or (x >= threshold and i >= end + holdoff)):
            in_interval = False
            if n < K:
                result_buffer[n, 0] = start
                result_buffer[n, 1] = end
                n += 1
            else:
                break
    return n
