"""Build and bind the hand-written CUDA kernels of ``wfsim_tpu_torch/csrc``.

The sources have a plain C interface.  At first use one ``nvcc -c`` per
source runs, all started together, and their objects are linked into one
shared library, ``build/wfsim_tpu_torch/libkernels.so`` under the
repository root; the library is rebuilt whenever the sha256 of the
sources and flags changes.  ``ctypes`` binds each entry
point: pointers travel as ``c_void_p`` from ``tensor.data_ptr()``, the
stream is ``torch.cuda.current_stream().cuda_stream``, and every entry
point returns ``cudaGetLastError()`` right after its launch.

Nothing here runs at import time: the CPU tests import every module of
the package on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ['Kernel', 'KERNELS', 'build', 'load_library', 'LIB_PATH',
           'check_tensor']

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'wfsim_tpu_torch'
LIB_PATH = BUILD_DIR / 'libkernels.so'
_HASH_PATH = BUILD_DIR / 'libkernels.sha256'
#: compile flags of every source; never --use_fast_math: the kernels
#: reproduce their twins' float rounding bit for bit
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC')

#: every Kernel by its C symbol; chip_smoke.py reads the launch counts here
KERNELS: dict = {}


def _sources():
    return sorted(_CSRC.glob('*.cu'))


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(_CSRC.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cands = [os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc')
             if os.environ.get('CUDA_HOME') else None,
             shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels of wfsim_tpu_torch '
                       'are compiled on the machine with the card')


def build(force: bool = False, ptxas_verbose: bool = False) -> dict:
    """Compile the kernels if the library is missing or stale.

    Returns ``dict(path, built, seconds, log)``; ``log`` holds nvcc's output
    (register and shared-memory use with ``ptxas_verbose``)."""
    digest = _digest()
    if (not force and LIB_PATH.exists() and _HASH_PATH.exists()
            and _HASH_PATH.read_text().strip() == digest):
        return dict(path=str(LIB_PATH), built=False, seconds=0.0, log='')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f'{src.stem}.{tag}.o'
        cmd = [nvcc, *NVCC_FLAGS, *(['-Xptxas', '-v'] if ptxas_verbose else []),
               '-c', '-o', str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f'{src.name} ({proc.returncode}):\n{out}')
    objs = [obj for _src, obj, _proc in jobs]
    try:
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        tmp = BUILD_DIR / f'libkernels.{tag}.so'
        link = subprocess.run([nvcc, '-shared', '-o', str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({link.returncode}):\n'
                               f'{link.stdout}\n{link.stderr}')
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, LIB_PATH)
    _HASH_PATH.write_text(digest + '\n')
    return dict(path=str(LIB_PATH), built=True, seconds=seconds,
                log=''.join(logs) + link.stdout + link.stderr)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.wfsim_error_string.argtypes = [ctypes.c_int]
    lib.wfsim_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of the kernel library plus its launch count.

    ``launches`` grows by one per successful launch and nowhere else, so a
    run can show that its main path went through the kernel."""

    def __init__(self, symbol: str, argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        KERNELS[symbol] = self

    def __call__(self, *args):
        lib = load_library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f'{self.symbol}: CUDA error {err} '
                f'({lib.wfsim_error_string(err).decode()})')
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def check_tensor(name, x, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel's pointer argument takes)."""
    if x.dtype != dtype:
        raise TypeError(f'{name}: dtype {x.dtype}, expected {dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(x.shape)}, expected {shape}')
    if x.device != device:
        raise ValueError(f'{name}: on {x.device}, expected {device}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: not contiguous')


def ptr(t) -> int:
    """Device pointer of a contiguous tensor, as ctypes takes it."""
    return t.data_ptr()


def stream_of(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
