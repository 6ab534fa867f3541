"""Build and bind the hand-written CUDA kernels (Hopper, sm_90a).

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``. The build runs at first
use, one ``nvcc`` process per source, all started together, into
``build/<hash>/`` beside this file; the hash covers the sources and the
flags, so one checkout builds once and an edited source builds anew.
Nothing is compiled at import: the CPU tests import every module, and this
machine may have no ``nvcc``. A kernel takes its width at run time where
it can (K1, K3 and K4 take any C % 128 == 0 up to 2048 in a few
compile-time forms each), so the build does not grow with the widths: the
twelve sources take about 65 s together on an H100 machine's 8 cores
(``chip_smoke.py`` phase 2 prints it), ``ffn_ln.cu`` the longest.

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
_U = ctypes.c_uint
# A dropout site (ops/dropout.py Drop.c_args): seed_lo, seed_hi, site,
# threshold, scale
_DROP = (_U, _U, _U, _U, _F)

# C symbol -> (source file, argtypes). Every pointer and the stream are
# c_void_p: ctypes would pass a bare Python int as a 32-bit int.
SIGNATURES = {
    # q, k, v, rs, mask, out, out32, out_stride, lse, keep, B, T, H, d,
    # scale_log2, causal, *drop, stream
    'ppgs_attention_train_fwd': ('attention_train.cu', (
        _P, _P, _P, _L, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _F, _I,
        *_DROP, _P)),
    # q, k, v, rs, mask, lse, keep, dout, do_stride, d_row, dq16, dq32,
    # dk16, dk32, dv16, dv32, d_stride, B, T, H, d, scale_log2, sm_scale,
    # causal, drop_scale, stream
    'ppgs_attention_train_bwd': ('attention_train_bwd.cu', (
        _P, _P, _P, _L, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _L,
        _I, _I, _I, _I, _F, _F, _I, _F, _P)),
    # x, ldx, y, ldy, out, B, T, H, d, is_f32, stream
    'ppgs_row_dot': ('attention_train.cu', (_P, _L, _P, _L, _P, _I, _I, _I,
                                            _I, _I, _P)),
    # g, g_is_bf16, n, rstd, gamma, dz_out, masked_out, partial, M, C,
    # *drop, stream
    'ppgs_ln_dropout_bwd': ('layer_train.cu', (
        _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, *_DROP, _P)),
    # in, R, N, splits, chunk, scratch, out, round_bf16, stream
    'ppgs_colsum': ('layer_train.cu', (_P, _L, _L, _I, _L, _P, _P, _I, _P)),
    # x, x_is_f32, dy, w1t, b1, w2, w1, w2t, words, residual, dx32, dx16,
    # hd_out, dh_out, db1_partial, mask, M, F, C, scale, stream
    'ppgs_ffn_train_bwd': ('ffn_train.cu', (
        _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
        _I, _I, _F, _P)),
    # a, a_is_f32, ta, lda, b, tb, ldb, out32, out16, residual, ldc, M, N,
    # K, splits, stream
    'ppgs_gemm': ('gemm.cu', (_P, _I, _I, _L, _P, _I, _L, _P, _P, _P, _L,
                              _I, _I, _I, _I, _P)),
    # x, w, b, out, M, K, N, stream
    'ppgs_qkv_proj': ('qkv_proj.cu', (_P, _P, _P, _P, _I, _I, _I, _P)),
    # q, k, v, row_stride, mask, out, out_stride, B, T, H, d_head,
    # scale_log2, causal, stream
    'ppgs_attention': ('attention.cu', (_P, _P, _P, _L, _P, _P, _L,
                                        _I, _I, _I, _I, _F, _I, _P)),
    # a, w, bias, x, gamma, beta, out, n_out, rstd, M, C, clusters, *drop,
    # stream
    'ppgs_out_proj_ln': ('out_proj_ln.cu', (_P, _P, _P, _P, _P, _P, _P, _P,
                                            _P, _I, _I, _I, *_DROP, _P)),
    # x, w1, b1, w2, b2, gamma, beta, out, n_out, rstd, y_out, h,
    # keep_out, M, F, C, act, round_input, seed_lo, seed_hi, site_h,
    # site_y, threshold, scale, stream
    'ppgs_ffn_ln': ('ffn_ln.cu', (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _U, _U,
                                  _U, _U, _U, _F, _P)),
    # q_u, q_rs, k, v, kv_rs, q_v, qv_rs, pos, pos_rs, mask, out, out_rs,
    # B, T, H, d, scale_log2, stream
    'ppgs_rel_attention': ('rel_attention.cu', (
        _P, _L, _P, _P, _L, _P, _L, _P, _L, _P, _P, _L, _I, _I, _I, _I, _F,
        _P)),
    # blocks, batch_stride, hop, T, B, frames, pitch, basis, mel, out,
    # stream
    'ppgs_fused_mel': ('fused_mel.cu', (_P, _L, _I, _I, _I, _I, _I, _P, _P,
                                        _P, _P)),
    # audio, S, w0, k0, s0, T0, B, tiles, partial, sums, tickets, stream
    'ppgs_conv_stats': ('conv_stack.cu', (_P, _L, _P, _I, _I, _I, _I, _I, _P,
                                          _P, _P, _P)),
    # audio, S, w0, k0, s0, T0, B, tiles, window, sums, gamma, beta, act,
    # guarded, stream
    'ppgs_conv0_gelu': ('conv_stack.cu', (_P, _L, _P, _I, _I, _I, _I, _I, _I,
                                          _P, _P, _P, _P, _P, _P)),
    # x, x_batch, w, k, s, T_out, B, tiles, blocks, out, stream
    'ppgs_conv_gelu': ('conv_stack.cu', (_P, _L, _P, _I, _I, _I, _I, _I, _I,
                                         _P, _P)),
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


def ptr(tensor):
    """The device address of ``tensor``, or None (a null pointer) for
    None: what an entry point takes for an output it may skip."""
    return None if tensor is None else tensor.data_ptr()


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
