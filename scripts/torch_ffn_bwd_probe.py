#!/usr/bin/env python3
"""Time variants of the port's ffn_train_bwd kernel on one CUDA card.

    python3 scripts/torch_ffn_bwd_probe.py [--parent DIR] [--sibling DIR]
        [--reps N] [--variants this,loads_only,...]

Builds ``ppgs_tpu_torch/kernels/csrc/ffn_train.cu`` as it is and as the
variants below (``--variants``, all by default; each a text substitution:
a loads-only walk that streams every weight piece, stages x and dy and
writes the outputs but multiplies nothing; a walk that computes everything
but issues no TMA store of hd and bf16(dh)); with ``--parent``, the same
file of another checkout whose kernel still draws its keep bits (the
right-first wmma kernel, whose C entry point takes W1 and the Philox site
instead of W1^T and the words); with ``--sibling``, the same file of a
checkout whose entry point is this one's (another form of this kernel).
Each is built with nvcc into ``runs/ffn_bwd_probe/`` (gitignored), and
ptxas's registers, spills and warnings are printed. On chip_smoke.py's
training shape (M = 256 x 512 rows, C = 256, F = 2048, the fp32 x with its
residual, B4's form, and the bf16 x, ffn_train's) it checks every variant
that computes the function against this checkout's build (bit for bit on
what it writes, the sibling too but for its db1 partials, which it may sum
in another order; those and the parent's dx to within chip_smoke.py's
limits), then times each with dropout 0.1 and off, in turns (the variants
in order, then reversed): CUDA-event medians of ``--reps`` runs and the
profiler's device time per launch. Whether the
loads-only walk takes most of the kernel's time says whether the stream or
the products set its pace. Prints the card's name and power limit, then
one JSON line. Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
SOURCE = 'ffn_train.cu'
VARIANTS = {
    'this': (),
    'loads_only': (('constexpr bool LIVE = true;',
                    'constexpr bool LIVE = false;'),),
    'no_stores': (('if (lane == 0 && wrow < M) {', 'if (false) {'),),
}
_P, _I, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
# The wmma kernel's entry point: x, x_is_f32, dy, w1, b1, w2, residual,
# dx32, dx16, hd, dh, partial, M, F, seed_lo, seed_hi, site, threshold,
# scale, stream
PARENT_ARGS = (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _U,
               _U, _U, _U, _F, _P)


def build(variants, others, out_dir):
    """Write and compile every variant and the other checkouts' sources
    ({name: checkout}), all nvcc processes at once; returns {name: ctypes
    function}."""
    from ppgs_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    text = (CSRC / SOURCE).read_text()
    jobs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f'{name}: {old!r} is not in {SOURCE}')
            src = src.replace(old, new)
        jobs[name] = (src, CSRC)
    for name, root in others.items():
        pcsrc = root / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
        jobs[name] = ((pcsrc / SOURCE).read_text(), pcsrc)
    procs = {}
    for name, (src, include) in jobs.items():
        cu = out_dir / f'{name}.cu'
        cu.write_text(src)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, '-I', str(include),
               '-o', str(out_dir / f'{name}.so'), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    functions = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if ('bwd_kernel' in line or 'Used' in line or 'spill' in line
                    or 'warning' in line or 'error' in line):
                print(f'  {name}: {line.strip()}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed:\n{log}')
        fn = ctypes.CDLL(str(out_dir / f'{name}.so')).ppgs_ffn_train_bwd
        fn.argtypes = (PARENT_ARGS if name == 'parent' else
                       kernels.SIGNATURES['ppgs_ffn_train_bwd'][1])
        fn.restype = ctypes.c_int
        functions[name] = fn
    return functions


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='a checkout with the wmma kernel, timed too')
    parser.add_argument('--sibling', default=None,
                        help='a checkout with another form of this kernel '
                        '(the same entry point), checked and timed too')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    args = parser.parse_args()
    names = args.variants.split(',')
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not torch.cuda.is_available():
        sys.exit('torch_ffn_bwd_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch.ops import dropout, fused_ffn

    card = cs.card_line()
    print(card, flush=True)
    others = {name: Path(path).resolve() for name, path in (
        ('parent', args.parent), ('sibling', args.sibling)) if path}
    functions = build({name: VARIANTS[name] for name in names}, others,
                      REPO / 'runs' / 'ffn_bwd_probe')

    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    M, C, Fh = cs.TRAIN_B * cs.TRAIN_T, 256, 2048
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 59)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    w1 = rnd(C, Fh, scale=C ** -0.5).to(bf16)
    w2 = rnd(Fh, C, scale=Fh ** -0.5).to(bf16)
    w1t = w1.t().contiguous()
    b1 = rnd(Fh, scale=0.1)
    x, res = rnd(M, C), rnd(M, C)
    x16, dy = x.to(bf16), rnd(M, C).to(bf16)
    drops = {'on': dropout.Drop(cs.SEED + 29, 3, cs.DROPOUT)}
    drops['off'] = dropout.Drop(drops['on'].seed, 3, 0.0)
    words = fused_ffn.keep_words_reference(drops['on'], M, Fh, dev)
    forms = {'fp32': (x, res), 'bf16': (x16, None)}
    out = {'fp32': torch.empty(M, C, device=dev),
           'bf16': torch.empty(M, C, dtype=bf16, device=dev),
           'hd': torch.empty(M, Fh, dtype=bf16, device=dev),
           'dh': torch.empty(M, Fh, dtype=bf16, device=dev),
           'partial': torch.empty(-(-M // 64), Fh, device=dev)}

    def run(name, key, form):
        xf, resf = forms[form]
        drop = drops[key]
        dx32 = out['fp32'] if form == 'fp32' else None
        dx16 = out['bf16'] if form == 'bf16' else None
        stream = torch.cuda.current_stream().cuda_stream
        common = (out['hd'].data_ptr(), out['dh'].data_ptr(),
                  out['partial'].data_ptr(), M, Fh)
        if name == 'parent':
            err = functions[name](
                xf.data_ptr(), int(form == 'fp32'), dy.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                None if resf is None else resf.data_ptr(),
                None if dx32 is None else dx32.data_ptr(),
                None if dx16 is None else dx16.data_ptr(), *common,
                *drop.c_args(), stream)
        else:
            err = functions[name](
                xf.data_ptr(), int(form == 'fp32'), dy.data_ptr(),
                w1t.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                words.data_ptr() if drop.on else None,
                None if resf is None else resf.data_ptr(),
                None if dx32 is None else dx32.data_ptr(),
                None if dx16 is None else dx16.data_ptr(), *common,
                float(drop.scale), stream)
        if err:
            raise RuntimeError(f'{name}: launch failed with error {err}')

    cases = [(key, form) for key in drops for form in forms]
    with torch.no_grad():
        want = {}
        for key, form in cases:
            run('this', key, form)
            torch.cuda.synchronize()
            want[key, form] = {k: out[k].clone()
                               for k in (form, 'hd', 'dh', 'partial')}
        for name in functions:
            if name in ('this', 'loads_only'):
                continue
            for key, form in cases:
                for t in out.values():
                    t.zero_()
                run(name, key, form)
                torch.cuda.synchronize()
                if name == 'parent':
                    label = ('dx (fp32 + residual)' if form == 'fp32'
                             else 'dx (bf16)')
                    atol, rtol, share, bound_on = cs.FFN_BWD_LIMITS[label]
                    cs.check(f'parent {label} {key}', out[form],
                             want[key, form][form], atol, rtol, share=share,
                             **bound_on)
                    continue
                written = ((form, 'partial') if name == 'no_stores'
                           else (form, 'hd', 'dh', 'partial'))
                if name == 'sibling':
                    # another form may sum the db1 partials in another order
                    atol, rtol, share, bound_on = cs.FFN_BWD_LIMITS[
                        'db1 partial sums']
                    cs.check(f'sibling db1 partial sums {key} {form}',
                             out['partial'], want[key, form]['partial'],
                             atol, rtol, share=share, **bound_on)
                    written = (form, 'hd', 'dh')
                if not all(torch.equal(out[k], want[key, form][k])
                           for k in written):
                    raise SystemExit(f'{name} differs from this checkout\'s '
                                     f'build ({key}, {form})')
        print('every variant that computes the function equals this build '
              'bit for bit on what it writes (the sibling\'s partials and the '
              'parent\'s dx within their limits)', flush=True)

        labels = [f'{name} {key} {form}' for name in functions
                  for key, form in cases]
        event = {label: [] for label in labels}
        order = list(functions)
        for name in order + order[::-1]:
            for key, form in cases:
                event[f'{name} {key} {form}'].append(cs.time_ms(
                    lambda: run(name, key, form), args.reps, 2))
        device = {f'{name} {key} {form}': cs.kernel_device_ms(
            f'{name}, dropout {drops[key].rate}, x {form}',
            lambda: run(name, key, form), card)
            for name in functions for key, form in cases}
    for label in labels:
        print(f'{label}: event {event[label]} ms, device {device[label]} ms '
              f'[{card}]', flush=True)
    print(json.dumps({'card': card, 'event_ms': event, 'device_ms': device}),
          flush=True)


if __name__ == '__main__':
    main()
