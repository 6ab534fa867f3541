"""Build and bind the hand-written CUDA kernels (Hopper, sm_90a).

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``. The build runs at first
use, one ``nvcc`` process per source, all started together, into
``build/<hash>/`` beside this file; the hash covers the sources and the
flags, so one checkout builds once and an edited source builds anew.
Nothing is compiled at import: the CPU tests import every module, and this
machine may have no ``nvcc``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0, so a launch
the card refuses (too many threads, too much shared memory) cannot pass
unnoticed.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / 'csrc'
BUILD_ROOT = Path(__file__).parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C symbol -> (source file, argtypes). Every pointer and the stream are
# c_void_p: ctypes would pass a bare Python int as a 32-bit int.
SIGNATURES = {
    # x, w, b, out, M, K, N, stream
    'ppgs_qkv_proj': ('qkv_proj.cu', (_P, _P, _P, _P, _I, _I, _I, _P)),
    # q, k, v, row_stride, mask, out, out_stride, B, T, H, scale_log2,
    # causal, stream
    'ppgs_attention': ('attention.cu', (_P, _P, _P, _L, _P, _P, _L,
                                        _I, _I, _I, _F, _I, _P)),
    # a, w, bias, x, gamma, beta, out, M, stream
    'ppgs_out_proj_ln': ('out_proj_ln.cu', (_P, _P, _P, _P, _P, _P, _P,
                                            _I, _P)),
    # x, w1, b1, w2, b2, gamma, beta, out, M, F, round_input, stream
    'ppgs_ffn_ln': ('ffn_ln.cu', (_P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _P)),
}
SOURCES = tuple(sorted({src for src, _ in SIGNATURES.values()}))

_lock = threading.Lock()
_functions = {}
build_log = {}          # library name -> nvcc/ptxas output of its build


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError(
            'nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels '
            'of ppgs_tpu_torch are built from source at first use')
    return path


def build_dir() -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in ('.cu', '.cuh'):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build() -> dict:
    """Compile every source that is not built yet; returns {source: .so}.

    All nvcc processes start together and are all waited for before any
    failure is raised, so none is left running."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src: out / (Path(src).stem + '.so') for src in SOURCES}
    todo = [src for src, so in libs.items() if not so.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = libs[src].with_name(f'{libs[src].stem}.{os.getpid()}.tmp.so')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[src] = log
        if proc.returncode:
            failed.append(f'--- {src} (nvcc exit {proc.returncode})\n{log}')
        else:
            os.replace(tmp, libs[src])
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return libs


def function(symbol):
    """The bound C entry point, building and loading its library once."""
    with _lock:
        if symbol not in _functions:
            src, argtypes = SIGNATURES[symbol]
            lib = ctypes.CDLL(str(build()[src]))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[symbol] = fn
    return _functions[symbol]


def launch(symbol, *args, device):
    """Launch a kernel on the current stream of ``device``; raise if the
    launch reports an error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = function(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f'{symbol}: CUDA launch failed with error {err}')


def build_all():
    """Build every kernel now and return the seconds it took (0 when the
    libraries were already built)."""
    start = time.perf_counter()
    build()
    for symbol in SIGNATURES:
        function(symbol)
    return time.perf_counter() - start


def require(tensor, name, dtype, device, shape=None):
    """Raise unless ``tensor`` is a contiguous ``dtype`` tensor on ``device``
    (of ``shape`` when given): the kernels take nothing else."""
    if tensor.device != device or tensor.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype} on {device}, got '
                         f'{tensor.dtype} on {tensor.device}')
    if not tensor.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got '
                         f'{tuple(tensor.shape)}')
