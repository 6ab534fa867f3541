#!/usr/bin/env python3
"""Time variants of the port's ffn_train_bwd kernel on one CUDA card.

    python3 scripts/torch_ffn_bwd_probe.py [--parent DIR] [--widths 256,512]
        [--reps N] [--variants this,loads_only,...]

Builds ``ppgs_tpu_torch/kernels/csrc/ffn_train.cu`` as it is and as the
variants below (``--variants``, all by default; each a text substitution:
a loads-only walk that streams every weight piece, stages x and dy and
writes the outputs but multiplies nothing; a walk that computes everything
but issues no TMA store of hd and bf16(dh) (at C = 512 its dx pass then
reads no dh: only its partials are checked)); with ``--parent``, the
same file of another checkout (an older form of this kernel, e.g. ``git
archive <commit> ppgs_tpu_torch`` unpacked under ``runs/``; its entry
point this one's, or this one's without the mask scratch). Each is built
with nvcc into ``runs/ffn_bwd_probe/`` (gitignored), and ptxas's
registers, spills and warnings are printed. At
chip_smoke.py's training rows (M = 256 x 512) and F = 2048, at each width
C of ``--widths`` (256: the mel model; 512: the w2v2fb head), with the fp32
x and its residual (B4's form) and the bf16 x (ffn_train's), it checks
every variant that computes the function against this checkout's build bit
for bit on what it writes, and the parent likewise but for its db1
partials, which another form may sum in another order (those within
chip_smoke.py's limits; whether they are equal is printed); then it times
each with dropout 0.1 and off, in turns (the builds in order, then
reversed): CUDA-event medians of ``--reps`` runs and the profiler's device
time per launch by kernel (three at C = 512: the hd, dh and dx passes).
Whether the loads-only walk takes most of the kernel's time says whether
the stream or the products set its pace. Prints the card's name and power
limit, then one JSON line. Imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
SOURCE = 'ffn_train.cu'
MASK_ARG = 13            # the entry point's mask scratch, after db1_partial
VARIANTS = {
    'this': (),
    'loads_only': (('constexpr bool LIVE = true;',
                    'constexpr bool LIVE = false;'),),
    'no_stores': (('if (lane == 0 && wrow < M) {', 'if (false) {'),),
}


def build(variants, parent, out_dir):
    """Write and compile every variant and the parent's source, all nvcc
    processes at once; returns {name: ctypes function}."""
    import ctypes

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
    # an entry point without the mask scratch (the one-launch form's)
    no_mask = set()
    if parent is not None:
        pcsrc = parent / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
        jobs['parent'] = ((pcsrc / SOURCE).read_text(), pcsrc)
        if 'void* mask,' not in jobs['parent'][0]:
            no_mask.add('parent')
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
            if ('Compiling entry' in line or 'Used' in line or 'spill' in line
                    or 'warning' in line or 'error' in line):
                print(f'  {name}: {line.strip()[:160]}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed:\n{log}')
        fn = ctypes.CDLL(str(out_dir / f'{name}.so')).ppgs_ffn_train_bwd
        argtypes = kernels.SIGNATURES['ppgs_ffn_train_bwd'][1]
        fn.argtypes = (argtypes[:MASK_ARG] + argtypes[MASK_ARG + 1:]
                       if name in no_mask else argtypes)
        fn.restype = ctypes.c_int
        functions[name] = (fn, name not in no_mask)
    return functions


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='a checkout with another form of this kernel '
                        '(the same entry point), checked and timed too')
    parser.add_argument('--widths', default='256,512',
                        help='comma-separated widths C (256, 512)')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    args = parser.parse_args()
    names = args.variants.split(',')
    widths = [int(c) for c in args.widths.split(',')]
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not set(widths) <= {256, 512}:
        sys.exit('--widths: a subset of 256,512')
    if not torch.cuda.is_available():
        sys.exit('torch_ffn_bwd_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch.ops import dropout, fused_ffn

    card = cs.card_line()
    print(card, flush=True)
    parent = Path(args.parent).resolve() if args.parent else None
    functions = build({name: VARIANTS[name] for name in names}, parent,
                      REPO / 'runs' / 'ffn_bwd_probe')

    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    M, Fh = cs.TRAIN_B * cs.TRAIN_T, 2048
    drops = {'on': dropout.Drop(cs.SEED + 29, 3, cs.DROPOUT)}
    drops['off'] = dropout.Drop(drops['on'].seed, 3, 0.0)
    words = fused_ffn.keep_words_reference(drops['on'], M, Fh, dev)
    result = {'card': card, 'event_ms': {}, 'device_ms': {},
              'partials_equal': {}}
    for C in widths:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 59)

        def rnd(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device=dev)

        w1 = rnd(C, Fh, scale=C ** -0.5).to(bf16)
        w2 = rnd(Fh, C, scale=Fh ** -0.5).to(bf16)
        w1t = w1.t().contiguous()
        b1 = rnd(Fh, scale=0.1)
        x, res = rnd(M, C), rnd(M, C)
        x16, dy = x.to(bf16), rnd(M, C).to(bf16)
        forms = {'fp32': (x, res), 'bf16': (x16, None)}
        out = {'fp32': torch.empty(M, C, device=dev),
               'bf16': torch.empty(M, C, dtype=bf16, device=dev),
               'hd': torch.empty(M, Fh, dtype=bf16, device=dev),
               'dh': torch.empty(M, Fh, dtype=bf16, device=dev),
               'partial': torch.empty(-(-M // 64), Fh, device=dev)}
        words_c = fused_ffn.bwd_mask_words(M, Fh, C)
        mask = (torch.empty(words_c, dtype=torch.int32, device=dev)
                if words_c else None)

        def run(name, key, form):
            xf, resf = forms[form]
            drop = drops[key]
            fn, takes_mask = functions[name]
            scratch = ((None if mask is None else mask.data_ptr(),)
                       if takes_mask else ())
            err = fn(
                xf.data_ptr(), int(form == 'fp32'), dy.data_ptr(),
                w1t.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                words.data_ptr() if drop.on else None,
                None if resf is None else resf.data_ptr(),
                out['fp32'].data_ptr() if form == 'fp32' else None,
                out['bf16'].data_ptr() if form == 'bf16' else None,
                out['hd'].data_ptr(), out['dh'].data_ptr(),
                out['partial'].data_ptr(), *scratch, M, Fh, C,
                float(drop.scale), torch.cuda.current_stream().cuda_stream)
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
                    # without its stores, dx's pass at C = 512 reads no dh
                    written = ((('partial',) if C == 512 else
                                (form, 'partial')) if name == 'no_stores'
                               else (form, 'hd', 'dh', 'partial'))
                    if name == 'parent':
                        # another form may sum the db1 partials in another
                        # order
                        atol, rtol, share, bound_on = cs.FFN_BWD_LIMITS[
                            'db1 partial sums']
                        cs.check(f'C={C} parent db1 partial sums {key} {form}',
                                 out['partial'], want[key, form]['partial'],
                                 atol, rtol, share=cs.flip_share(share, C),
                                 **bound_on)
                        result['partials_equal'][f'{C} {key} {form}'] = (
                            torch.equal(out['partial'],
                                        want[key, form]['partial']))
                        written = (form, 'hd', 'dh')
                    if not all(torch.equal(out[k], want[key, form][k])
                               for k in written):
                        raise SystemExit(
                            f'C={C} {name} differs from this checkout\'s '
                            f'build ({key}, {form}); equal: ' + str({
                                k: torch.equal(out[k], want[key, form][k])
                                for k in written}))
            print(f'C={C}: every build that computes the function equals this '
                  f'one bit for bit on what it writes (the parent\'s db1 '
                  f'partials within their limits; equal: '
                  f'{result["partials_equal"]})', flush=True)

            labels = [f'C={C} {name} {key} {form}' for name in functions
                      for key, form in cases]
            event = {label: [] for label in labels}
            order = list(functions)
            for name in order + order[::-1]:
                for key, form in cases:
                    event[f'C={C} {name} {key} {form}'].append(cs.time_ms(
                        lambda: run(name, key, form), args.reps, 2))
            device = {f'C={C} {name} {key} {form}': cs.kernel_device_ms(
                f'C={C} {name}, dropout {drops[key].rate}, x {form}',
                lambda: run(name, key, form), card)
                for name in functions for key, form in cases}
        for label in labels:
            print(f'{label}: event {event[label]} ms, device {device[label]} '
                  f'ms [{card}]', flush=True)
        result['event_ms'].update(event)
        result['device_ms'].update(device)
        del w1, w2, w1t, x, res, x16, dy, out, mask
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
