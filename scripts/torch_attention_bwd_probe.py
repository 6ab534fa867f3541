#!/usr/bin/env python3
"""Time the port's attention_train_bwd on one CUDA card, dropout on and off.

    python3 scripts/torch_attention_bwd_probe.py [--root DIR]
        [--d-heads 128,256] [--reps N] [--variants loads_only]

Builds this checkout's kernels and, with ``--root``, the
``attention_train_bwd.cu`` of another checkout with the same entry point
(e.g. ``git archive <commit> ppgs_tpu_torch`` unpacked under ``runs/``;
nvcc into ``runs/attention_bwd_probe/``, gitignored, ptxas's registers and
spills printed), and runs both through this checkout's wrapper at
chip_smoke.py's training shape (256 windows x T = 512, ragged windows, one
wholly masked, bf16 and fp32 outputs), 2 heads of each d_head in
``--d-heads`` (128: the mel model; 256: the w2v2fb head). It prints
whether the root's dq, dk and dv equal this checkout's bit for bit, then
times both with dropout 0.1 and with the dropout off (threshold 0) in
turns (this, root, root, this; on, off, off, on): CUDA-event medians of
``--reps`` runs and the profiler's device time per launch by kernel (the
dq pass, the dk/dv pass). The gap between dropout on and off is what
reading the keep bits costs the backward (chip_smoke.py's
``keep_bits_probe``). Prints the card's name and power limit, then one
JSON line. ``--variants`` builds text-substituted copies of this
checkout's source beside it (a loads-only walk: whether the stream or the
products set the pace) and times them too. Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SYMBOL = 'ppgs_attention_train_bwd'


# Text substitutions of this checkout's source: a loads-only walk of both
# passes (every tile streamed, nothing multiplied, zeros written)
VARIANTS = {
    'loads_only': (
        ('    const bool live =\n'
         '        valid != 0 && wg_row < T && !(causal && k0 > wg_row + 63);',
         '    const bool live = false;'),
        ('    const bool live = kvalid != 0 && !(causal && q0 + TILE - 1 < '
         'wg_key);', '    const bool live = false;'),
        ('    const bool live = !(causal && q0 + TILE - 1 < k0b);',
         '    const bool live = false;')),
}


def build(sources, out_dir):
    """nvcc each {name: (source text, include dir)}, all at once; their C
    functions."""
    from ppgs_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include) in sources.items():
        cu = out_dir / f'{name}.cu'
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, '-I', str(include), '-o',
             str(out_dir / f'{name}.so'), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    functions = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if 'Used' in line or 'spill' in line or 'error' in line:
                print(f'  {name}: {line.strip()[:160]}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed:\n{log}')
        fn = getattr(ctypes.CDLL(str(out_dir / f'{name}.so')), SYMBOL)
        fn.argtypes = kernels.SIGNATURES[SYMBOL][1]
        fn.restype = ctypes.c_int
        functions[name] = fn
    return functions


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--root', default=None,
                        help='a checkout whose attention_train_bwd.cu is '
                        'checked and timed beside this one\'s')
    parser.add_argument('--d-heads', default='128,256',
                        help='comma-separated d_head values (128, 256)')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--variants', default='',
                        help='comma-separated subset of ' + ','.join(VARIANTS)
                        + ', timed too')
    args = parser.parse_args()
    d_heads = [int(d) for d in args.d_heads.split(',')]
    if not set(d_heads) <= {128, 256}:
        sys.exit('--d-heads: a subset of 128,256')
    if not torch.cuda.is_available():
        sys.exit('torch_attention_bwd_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch import kernels
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    kernels.build_all()
    for line in kernels.build_log.get(kernels.SIGNATURES[SYMBOL][0],
                                      '').splitlines():
        if 'Used' in line or 'spill' in line:
            print(f'  this: {line.strip()[:160]}', flush=True)
    builds = {'this': kernels.function(SYMBOL)}
    src = kernels.SIGNATURES[SYMBOL][0]
    sources = {}
    for name in filter(None, args.variants.split(',')):
        text = (kernels.CSRC / src).read_text()
        for old, new in VARIANTS[name]:
            text = text.replace(old, new)
        sources[name] = (text, kernels.CSRC)
    if args.root:
        csrc = Path(args.root).resolve() / 'ppgs_tpu_torch' / 'kernels'
        sources['root'] = ((csrc / 'csrc' / src).read_text(), csrc / 'csrc')
    builds.update(build(sources, REPO / 'runs' / 'attention_bwd_probe'))
    dev = torch.device('cuda')
    B, T, H = cs.TRAIN_B, cs.TRAIN_T, 2
    result = {'card': card, 'equal': {}, 'event_ms': {}, 'device_ms': {}}
    for D in d_heads:
        C = H * D
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 53)
        lengths = T - torch.randint(0, T // 2, (B,), generator=gen,
                                    device=dev)
        lengths[0], lengths[-1] = T, 0
        mask = torch.arange(T, device=dev)[None] < lengths[:, None]
        qkv = torch.randn(B, T, 3 * C, generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        do = torch.randn(B, T, C, generator=gen, device=dev)
        sl, sm = fa.LOG2E / math.sqrt(D), 1 / math.sqrt(D)
        drops = {'on': dropout.Drop(cs.SEED + 17, dropout.site(0, 'probs'),
                                    cs.DROPOUT)}
        drops['off'] = dropout.Drop(drops['on'].seed, drops['on'].site, 0.0)
        with torch.no_grad():
            fwd = fa.attention_train_fwd(q, k, v, mask, H, sl, False,
                                         drops['on'], want_f32=True)
            d_row = fa.row_dot(do, fwd[1], H)
            do16 = do.to(torch.bfloat16)

            def run(name, key):
                kernels._functions[SYMBOL] = builds[name]
                return fa.attention_train_bwd(
                    q, k, v, mask, fwd[2], fwd[3], do16, d_row, H, sl, sm,
                    False, drops[key], want32=True)

            if 'root' in builds:
                for key in drops:
                    got, want = run('root', key), run('this', key)
                    torch.cuda.synchronize()
                    equal = {f'{part}{bits}': torch.equal(
                        a[..., i * C:(i + 1) * C], b[..., i * C:(i + 1) * C])
                        for part, i in (('dq', 0), ('dk', 1), ('dv', 2))
                        for bits, a, b in zip((16, 32), got, want)}
                    result['equal'][f'd{D} {key}'] = equal
                    print(f'd_head {D}, dropout {drops[key].rate}: the '
                          f'root\'s bf16 and fp32 outputs equal this '
                          f'build\'s bit for bit: {equal}', flush=True)
            order = list(builds)   # this, the variants, root
            for name in order + order[::-1]:
                for key in ('on', 'off', 'off', 'on'):
                    label = f'd{D} {name} {key}'
                    result['event_ms'].setdefault(label, []).append(
                        cs.time_ms(lambda: run(name, key), args.reps, 2))
            for name in order:
                for key in drops:
                    label = f'd{D} {name} {key}'
                    result['device_ms'][label] = cs.kernel_device_ms(
                        f'attention_train_bwd d_head {D} {name}, dropout '
                        f'{drops[key].rate}', lambda: run(name, key), card)
            kernels._functions[SYMBOL] = builds['this']
        for label in result['event_ms']:
            if label.startswith(f'd{D} '):
                print(f'{label}: event {result["event_ms"][label]} ms, '
                      f'device {result["device_ms"][label]} ms [{card}]',
                      flush=True)
        del q, k, v, qkv, do, do16, fwd, d_row
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
