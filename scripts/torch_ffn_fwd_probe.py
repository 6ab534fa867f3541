#!/usr/bin/env python3
"""Time variants of the port's K4 (ffn_ln.cu) train forms on one CUDA card.

    python3 scripts/torch_ffn_fwd_probe.py [--parent DIR] [--reps N]
        [--variants this,loads_only,...] [--cases b4,y_out,...]

Builds ``ppgs_tpu_torch/kernels/csrc/ffn_ln.cu`` as it is and as the
variants below (``--variants``, all by default; each a text substitution in
the source or a header it includes: a loads-only walk that streams every
operand and writes the outputs but multiplies nothing (and, in the hidden
launch, draws no keep bits), a walk that multiplies but runs no epilogue,
one that draws no keep bits, both of the first two, and the output launch's
LayerNorm epilogue without its residual reads, without its stores of the
normalised rows, or without its output dropout's draws), and, with
``--parent``, the same file of another checkout (an unpacked ``git archive``
of an older commit, whose C entry point takes the same arguments), each with
its headers into ``runs/ffn_fwd_probe/<name>/`` (gitignored), all nvcc
processes at once, and prints ptxas's registers, spills and warnings. The
cases (``--cases``): K4's two train forms at the w2v2fb head's width (C =
512, F = 2048) on chip_smoke.py's training rows (256 x 512), dropout 0.1
with the hidden's keep words: ``b4`` (fp32 x, the cluster LayerNorm, the
normalised rows and 1/std: the whole-layer step's form) and ``y_out`` (bf16
x and output: ffn_train's); the same two with the dropout off (``b4_off``,
``y_out_off``: the inference instances' hidden launch); the C = 256 fused
kernel's B4 form (``fused256``); and the inference instances at the head's
shape (``ln512``: 128 x 500 rows, round_input 0) and the wav2vec2 trunk's
(``ln768``: 64 x 400 rows, GELU, F = 3072). Every build that computes the
function is checked against this checkout's bit for bit on every output, the
parent likewise; the diagnostic variants are only timed, on the C = 512
train cases. Then each build and case is timed in turns (the builds in
order, then reversed): CUDA-event medians of ``--reps`` runs and the
profiler's device time per launch by kernel (the hidden's launch and the
output's apart). Whether the loads-only walk takes most of a launch's time
says whether the stream or the products set its pace. Prints the card's name
and power limit, then one JSON line. Imports nothing of JAX.
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
SOURCE = 'ffn_ln.cu'
# name -> ((file, old, new), ...): the substitutions that make it from this
# checkout's sources
LOADS = (('ffn_ln.cu', 'constexpr bool LIVE = true;',
          'constexpr bool LIVE = false;'),
         ('residual_ln.cuh', 'constexpr bool RING_LIVE = true;',
          'constexpr bool RING_LIVE = false;'))
NO_EPILOGUE = (('ffn_ln.cu', 'constexpr bool EPILOGUE = true;',
                'constexpr bool EPILOGUE = false;'),)
VARIANTS = {
    'this': (),
    'loads_only': LOADS,
    'no_epilogue': NO_EPILOGUE,
    'loads_only_no_epilogue': LOADS + NO_EPILOGUE,
    'no_philox': (('ffn_ln.cu', 'constexpr bool PHILOX = true;',
                   'constexpr bool PHILOX = false;'),),
    # the output launch's LayerNorm epilogue without one of its parts
    'ln_no_residual': (
        ('residual_ln.cuh', 'if (r0 < M) x0 = *reinterpret_cast',
         'if (false) x0 = *reinterpret_cast'),
        ('residual_ln.cuh', 'if (r1 < M) x1 = *reinterpret_cast',
         'if (false) x1 = *reinterpret_cast')),
    'ln_no_n_store': (
        ('residual_ln.cuh', 'if (n_out) *reinterpret_cast',
         'if (false) *reinterpret_cast')),
    'ln_no_philox': (
        ('residual_ln.cuh',
         'if (drop.threshold) keep4(drop, r0, r1, C, n0 + 8 * j, t, keep);',
         'if (false) keep4(drop, r0, r1, C, n0 + 8 * j, t, keep);'),),
}
DIAGNOSTIC = {'loads_only', 'no_epilogue', 'loads_only_no_epilogue',
              'no_philox', 'ln_no_residual', 'ln_no_n_store', 'ln_no_philox'}
CASES = ('b4', 'y_out', 'b4_off', 'y_out_off', 'fused256', 'ln512', 'ln768')
TRAIN_CASES = ('b4', 'y_out')


def build(variants, parent, out_dir):
    """Write and compile every variant and the parent's source, all nvcc
    processes at once; returns {name: ctypes function}."""
    from ppgs_tpu_torch import kernels

    headers = {p.name: p.read_text() for p in CSRC.glob('*.cuh')}
    jobs = {}
    for name, subs in variants.items():
        files = dict(headers, **{SOURCE: (CSRC / SOURCE).read_text()})
        for file, old, new in subs:
            if old not in files[file]:
                raise SystemExit(f'{name}: {old!r} is not in {file}')
            files[file] = files[file].replace(old, new)
        jobs[name] = files
    if parent is not None:
        pcsrc = parent / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
        jobs['parent'] = {p.name: p.read_text()
                          for p in [*pcsrc.glob('*.cuh'), pcsrc / SOURCE]}
    procs = {}
    for name, files in jobs.items():
        where = out_dir / name
        where.mkdir(parents=True, exist_ok=True)
        for file, text in files.items():
            (where / file).write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, '-I', str(where),
               '-o', str(where / 'ffn_ln.so'), str(where / SOURCE)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    argtypes = kernels.SIGNATURES['ppgs_ffn_ln'][1]
    functions = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if ('Compiling entry' in line or 'Used' in line or 'spill' in line
                    or 'warning' in line or 'error' in line):
                print(f'  {name}: {line.strip()[:160]}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed:\n{log}')
        fn = ctypes.CDLL(str(out_dir / name / 'ffn_ln.so')).ppgs_ffn_ln
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        functions[name] = fn
    return functions


def make_case(case, cs, dev):
    """(the C entry's arguments but the stream, {output name: tensor}) of
    one case, on seeded random weights and inputs."""
    from ppgs_tpu_torch.ops import dropout, fused_ffn

    bf16 = torch.bfloat16
    C, Fh, M, act, round_input = {
        'fused256': (256, 2048, cs.TRAIN_B * cs.TRAIN_T, 0, 0),
        'ln512': (512, 2048, 128 * 500, 0, 0),
        'ln768': (768, 3072, 64 * 400, 1, 0),
    }.get(case, (512, 2048, cs.TRAIN_B * cs.TRAIN_T, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 71)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device=dev)

    w1 = rnd(C, Fh, scale=C ** -0.5).to(bf16)
    w2 = rnd(Fh, C, scale=Fh ** -0.5).to(bf16)
    b1, b2 = rnd(Fh, scale=0.1), rnd(C, scale=0.1)
    gamma, beta = rnd(C, scale=0.1, base=1.0), rnd(C, scale=0.1)
    train = case in ('b4', 'y_out', 'fused256')
    y_form = case.startswith('y_out')
    drop = dropout.Drop(cs.SEED + 23, 3, cs.DROPOUT if train else 0.0)
    x = rnd(M, C).to(bf16) if y_form else rnd(M, C)
    out = {}
    if y_form:
        out['y'] = torch.empty(M, C, dtype=bf16, device=dev)
    else:
        out['out'] = torch.empty(M, C, device=dev)
        if case in ('b4', 'b4_off', 'fused256'):
            out['n'] = torch.empty(M, C, device=dev)
            out['rstd'] = torch.empty(M, device=dev)
    if train:
        out['keep'] = torch.empty(fused_ffn.keep_words_shape(M, Fh),
                                  dtype=torch.int32, device=dev)
    hidden = fused_ffn.hidden_scratch(M, Fh, C, dev)
    if train and hidden is not None:
        out['h'] = hidden          # the two launches' hidden, compared too
    lo, hi, site_h, threshold, scale = drop.c_args()

    def ptr(key):
        return out[key].data_ptr() if key in out else None

    args = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), None if y_form else gamma.data_ptr(),
            None if y_form else beta.data_ptr(), ptr('out'), ptr('n'),
            ptr('rstd'), ptr('y'), None if hidden is None else
            hidden.data_ptr(), ptr('keep'), M, Fh, C, act, round_input, lo,
            hi, site_h, drop.at(4).site, threshold, scale)
    keep_alive = (x, w1, w2, b1, b2, gamma, beta, hidden)
    return args, out, keep_alive


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='another checkout whose ffn_ln.cu is checked '
                        'and timed too')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    parser.add_argument('--cases', default=','.join(CASES),
                        help='comma-separated subset of ' + ','.join(CASES))
    args = parser.parse_args()
    names = args.variants.split(',')
    cases = args.cases.split(',')
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not set(cases) <= set(CASES):
        sys.exit(f'--cases: a subset of {list(CASES)}')
    if not torch.cuda.is_available():
        sys.exit('torch_ffn_fwd_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    parent = Path(args.parent).resolve() if args.parent else None
    functions = build({name: VARIANTS[name] for name in names}, parent,
                      REPO / 'runs' / 'ffn_fwd_probe')
    dev = torch.device('cuda')
    result = {'card': card, 'event_ms': {}, 'device_ms': {}, 'equal': {}}
    for case in cases:
        call_args, out, keep_alive = make_case(case, cs, dev)
        builds = [name for name in functions
                  if name not in DIAGNOSTIC or case in TRAIN_CASES]

        def run(name):
            err = functions[name](*call_args,
                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f'{name} {case}: launch failed with error '
                                   f'{err}')

        with torch.no_grad():
            run('this')
            torch.cuda.synchronize()
            want = {k: t.clone() for k, t in out.items()}
            for name in builds:
                if name == 'this' or name in DIAGNOSTIC:
                    continue
                for t in out.values():
                    t.zero_()
                run(name)
                torch.cuda.synchronize()
                equal = {k: torch.equal(out[k], want[k]) for k in out}
                result['equal'][f'{case} {name}'] = equal
                if not all(equal.values()):
                    raise SystemExit(f'{case}: {name} differs from this '
                                     f'checkout\'s build: {equal}')
            checked = [b for b in builds if b not in DIAGNOSTIC]
            print(f'{case}: {", ".join(checked)} equal bit for bit on '
                  f'{sorted(out)}', flush=True)
            event = {f'{case} {name}': [] for name in builds}
            for name in builds + builds[::-1]:
                event[f'{case} {name}'].append(cs.time_ms(
                    lambda: run(name), args.reps, 2))
            device = {f'{case} {name}': cs.kernel_device_ms(
                f'{case} {name}', lambda: run(name), card)
                for name in builds}
        for label in event:
            print(f'{label}: event {event[label]} ms, device {device[label]}'
                  f' ms [{card}]', flush=True)
        result['event_ms'].update(event)
        result['device_ms'].update(device)
        del call_args, out, keep_alive, want
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
