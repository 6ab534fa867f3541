#!/usr/bin/env python3
"""Time variants of the port's K3 kernel (out_proj_ln.cu) on one CUDA card.

    python3 scripts/torch_out_proj_probe.py [--parent DIR] [--sibling DIR]
        [--reps N] [--variants this,loads_only,...]
        [--shapes c768,c512,c256,train]

Builds ``ppgs_tpu_torch/kernels/csrc/out_proj_ln.cu`` as it is and as the
variants below (``--variants``, all by default; each a text substitution
of the source, none of which computes the function: a loads-only walk
that streams a, Wo and x through shared memory and reads x but multiplies
and writes nothing; the products and the residual without the LayerNorm
or any output; everything but the TMA stores); K4's output launch
(``ffn_out_kernel`` of ``ffn_ln.cu``) taken as it is with depth C, the
attention output in place of the hidden and Wo in place of W2, through an
entry point appended to a copy of that source; with ``--parent``, the
same file of another checkout whose entry point takes no cluster count
(the wmma kernel of the commit before this design); and, with
``--sibling``, the same file of a checkout whose entry point is this
one's (another form of this kernel). Each is built with nvcc into
``runs/out_proj_probe/`` (gitignored), and ptxas's registers, spills and
warnings are printed.

At the four shapes K3 runs at on the main paths (``--shapes``: the
wav2vec2 trunk, 25,600 rows at C = 768; the w2v2fb head, 64,000 at 512;
mel, 64,000 at 256; the train step's form, 131,072 rows at 256 with
dropout 0.1, the normalised rows and 1/std) it holds this checkout's build
against the plain version at chip_smoke.py's limits, and K4's launch, the
parent and the sibling against this build at the same limits, then times
each in turns (the variants in order, then reversed): CUDA-event medians
of ``--reps`` runs and the profiler's device time per launch, beside the
library call (``addmm`` + ``layer_norm``, with ``dropout`` in the train
form). Prints the card's name and power limit, then one JSON line.
Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
SOURCE = 'out_proj_ln.cu'
# name -> the substitutions that make it from this checkout's source
VARIANTS = {
    'this': (),
    'loads_only': (('constexpr bool LIVE = true;',
                    'constexpr bool LIVE = false;'),),
    'no_layer_norm': (('constexpr bool LAYER_NORM = true;',
                       'constexpr bool LAYER_NORM = false;'),),
    'no_store': (('constexpr bool STORE = true;',
                  'constexpr bool STORE = false;'),),
}
# K4's output launch with K3's entry point: h := a, W2 := Wo, F := C
FFN_OUT_ENTRY = '''
extern "C" int ppgs_out_proj_ln(const void* a, const void* w,
                                const void* bias, const void* x,
                                const void* gamma, const void* beta,
                                void* out, void* n_out, void* rstd, int M,
                                int C, int clusters, unsigned seed_lo,
                                unsigned seed_hi, unsigned site,
                                unsigned threshold, float scale,
                                void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap ma, mw;
  if (!encode(&ma, a, false, M, C, C, 64, BM) ||
      !encode(&mw, w, false, C, C, C, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(ffn_out_kernel, THREADS, Ring<false, OUT_BN>::SMEM,
                dim3(C / OUT_BN, (M + BM - 1) / BM), C / OUT_BN,
                static_cast<cudaStream_t>(stream), ma, mw,
                static_cast<const float*>(x), static_cast<const float*>(bias),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta), static_cast<float*>(out),
                static_cast<float*>(n_out), static_cast<float*>(rstd), M, C,
                C, 0, ppgs::make_dropout(seed_lo, seed_hi, site, threshold,
                                         scale));
}
'''
_P, _I, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
# The wmma kernel's entry point: no cluster count
PARENT_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _U, _U,
               _F, _P)
# name -> (rows, C, the train form)
SHAPES = {'c768': (25_600, 768, False), 'c512': (64_000, 512, False),
          'c256': (64_000, 256, False), 'train': (131_072, 256, True)}


def build(variants, others, out_dir):
    """Write and compile every variant, K4's launch and the other
    checkouts' sources ({name: checkout}), all nvcc processes at once;
    returns {name: ctypes function}."""
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
    jobs['ffn_out'] = ((CSRC / 'ffn_ln.cu').read_text() + FFN_OUT_ENTRY,
                       CSRC)
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
        entry = ''
        for line in log.splitlines():
            if 'Compiling entry function' in line:
                entry = line
            # of ffn_ln.cu's kernels, the output launch's alone
            if name == 'ffn_out' and 'ffn_out_kernel' not in entry:
                continue
            if any(key in line for key in ('entry function', 'Used',
                                           'spill', 'warning', 'error')):
                print(f'  {name}: {line.strip()}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed:\n{log}')
        fn = ctypes.CDLL(str(out_dir / f'{name}.so')).ppgs_out_proj_ln
        fn.argtypes = (PARENT_ARGS if name == 'parent' else
                       kernels.SIGNATURES['ppgs_out_proj_ln'][1])
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
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    parser.add_argument('--shapes', default=','.join(SHAPES),
                        help='comma-separated subset of ' + ','.join(SHAPES))
    args = parser.parse_args()
    names, shapes = args.variants.split(','), args.shapes.split(',')
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not set(shapes) <= set(SHAPES):
        sys.exit(f'--shapes: a subset of {list(SHAPES)}')
    if not torch.cuda.is_available():
        sys.exit('torch_out_proj_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import encoder_layer_train as elt

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    others = {name: Path(path).resolve() for name, path in (
        ('parent', args.parent), ('sibling', args.sibling)) if path}
    variants = {name: VARIANTS[name] for name in names}
    functions = build(variants, others, REPO / 'runs' / 'out_proj_probe')

    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 61)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device=dev)

    event, device, library = {}, {}, {}
    for shape in shapes:
        M, C, train = SHAPES[shape]
        a = rnd(M, C, scale=0.5).to(bf16)
        w = rnd(C, C, scale=C ** -0.5).to(bf16)
        bo, gamma, beta = (rnd(C, scale=0.1), rnd(C, scale=0.1, base=1.0),
                           rnd(C, scale=0.1))
        x = rnd(M, C)
        drop = (dropout.Drop(cs.SEED + 37, 5, cs.DROPOUT) if train
                else dropout.OFF)
        out = torch.empty(M, C, device=dev)
        n = torch.empty(M, C, device=dev) if train else None
        rstd = torch.empty(M, device=dev) if train else None
        clusters = elk.out_proj_ln_plan(M, C)[3]

        def run(name):
            head = (a.data_ptr(), w.data_ptr(), bo.data_ptr(), x.data_ptr(),
                    gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                    None if n is None else n.data_ptr(),
                    None if rstd is None else rstd.data_ptr(), M, C)
            tail = (*drop.c_args(), torch.cuda.current_stream().cuda_stream)
            err = (functions[name](*head, *tail) if name == 'parent' else
                   functions[name](*head, clusters, *tail))
            if err:
                raise RuntimeError(f'{name}: launch failed with error {err}')

        def outputs():
            return [t.clone() for t in (out, n, rstd) if t is not None]

        with torch.no_grad():
            run('this')
            torch.cuda.synchronize()
            want = outputs()
            if train:
                plain = elt.out_proj_ln_train_reference(a, w, bo, x, gamma,
                                                        beta, drop)
                limits = (1e-4, 1e-4, 1e-5)
            else:
                plain = (elk.out_proj_residual_ln_reference(a, w, bo, x,
                                                            gamma, beta),)
                limits = (1e-3,)
            for label, got, ref, atol in zip(('r', 'n', 'rstd'), want, plain,
                                             limits):
                cs.check(f'{shape} this {label} against the plain version',
                         got, ref, atol, 1e-5 if label == 'rstd' else 0.0)
            del plain
            got = None
            for name in functions:
                if name in variants:    # this, and what does not compute
                    continue
                for t in (out, n, rstd):
                    if t is not None:
                        t.zero_()
                run(name)
                torch.cuda.synchronize()
                got = outputs()
                for label, g, ref, atol in zip(('r', 'n', 'rstd'), got,
                                               want, limits):
                    cs.check(f'{shape} {name} {label} against this', g, ref,
                             atol, 1e-5 if label == 'rstd' else 0.0)
            del want, got
            print(f'{shape}: ffn_out, the parent and the sibling agree with '
                  f'this build within the limits', flush=True)

            order = list(functions)
            for name in order:
                event[f'{shape} {name}'] = []
            for name in order + order[::-1]:
                event[f'{shape} {name}'].append(
                    cs.time_ms(lambda: run(name), args.reps, 3))
            for name in order:
                device[f'{shape} {name}'] = cs.kernel_device_ms(
                    f'{shape} {name}', lambda: run(name), card)
            x3, a2 = x.view(M, C), a.view(M, C)
            if train:
                library[shape] = cs.time_ms(lambda: F.layer_norm(
                    x3 + F.dropout(torch.addmm(bo.to(bf16), a2, w),
                                   cs.DROPOUT), (C,), gamma, beta),
                    args.reps, 3)
            else:
                library[shape] = cs.time_ms(lambda: F.layer_norm(
                    x3 + torch.addmm(bo.to(bf16), a2, w), (C,), gamma,
                    beta), args.reps, 3)
        for name in order:
            label = f'{shape} {name}'
            print(f'{label}: event {event[label]} ms, device {device[label]} '
                  f'ms; library {library[shape]:.4f} ms [{card}]', flush=True)
        del a, w, x, out, n, rstd
        torch.cuda.empty_cache()
    print(json.dumps({'card': card, 'event_ms': event, 'device_ms': device,
                      'library_ms': library}), flush=True)


if __name__ == '__main__':
    main()
