#!/usr/bin/env python3
"""Time the port's B10 convs (conv_stack.cu) and variants of them on one
CUDA card.

    python3 scripts/torch_conv_probe.py [--parent DIR] [--reps N]
        [--variants this,exact_gelu,loads_only] [--convs 1,2,...]

Builds ``ppgs_tpu_torch/kernels/csrc/conv_stack.cu`` as it is and as the
variants below (``--variants``), each with nvcc into ``runs/conv_probe/``
(gitignored), printing ptxas's registers, spills and warnings:
``exact_gelu``, the epilogue's GELU by tanhf (0.5 x (1 + tanhf(u)), the
plain version's formula) instead of by ex2 and rcp (the share of outputs
they round apart is counted); ``loads_only``, a walk that streams every
operand and stores the output but multiplies nothing. With ``--parent``,
DIR's ``conv_stack.cu`` is built and timed too; DIR must have the entry
point of before conv0_gelu (the wmma kernel, whose ppgs_conv_gelu takes
the first form's conv-0 arguments).

On seeded inputs at the w2v2fb slice's shape (64 utterances x 8 s of
padded audio, 128,080 samples; wav2vec2-base's geometry) it runs the chain
conv 1 .. conv 6 with this build, holds each build that computes the
function against the plain version at chip_smoke.py's limits (atol 1e-3,
rtol 1e-2; printed, not raised) and against this build, calls this build
three more times to see that it repeats bit for bit, and times each (CUDA-
event medians of ``--reps`` runs, in turns: the variants in order, then
reversed) beside the profiler's device time per call, the bound and
cuDNN's bf16 conv + GELU at that shape (conv 1's on a stored conv-0
activation). Conv 1 in this build is conv0_gelu then the product; it is
also timed alone as ``conv0``. Prints the card's name and power limit,
then one JSON line. Imports nothing of JAX.
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
SOURCE = 'conv_stack.cu'
# name -> substitutions of this checkout's source
VARIANTS = {
    'this': (),
    'exact_gelu': (('constexpr bool FAST_GELU = true;',
                    'constexpr bool FAST_GELU = false;'),),
    'loads_only': (('constexpr bool LIVE = true;',
                    'constexpr bool LIVE = false;'),),
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ppgs_conv_gelu of the parent (the wmma kernel): x, x_batch, w, k, s,
# T_out, B, out, w0, k0, s0, T0, sums, gamma, beta, stream
PARENT_ARGS = (_P, _L, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P)


def build(names, parent, out_dir):
    """Write and compile every variant and the parent's source, all nvcc
    processes at once; returns {name: ctypes library}."""
    from ppgs_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = (CSRC / SOURCE).read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f'{name}: {old!r} is not in its source')
            src = src.replace(old, new)
        jobs[name] = (src, CSRC)
    if parent:
        pcsrc = parent / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
        jobs['parent'] = ((pcsrc / SOURCE).read_text(), pcsrc)
    procs = {}
    for name, (src, include) in jobs.items():
        cu = out_dir / f'{name}.cu'
        cu.write_text(src)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, '-I', str(include),
               '-o', str(out_dir / f'{name}.so'), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(key in line for key in ('entry function', 'Used',
                                           'spill', 'warning', 'error')):
                print(f'  {name}: {line.strip()}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed:\n{log}')
        libs[name] = ctypes.CDLL(str(out_dir / f'{name}.so'))
    return libs


def bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def disagreement(name, got, want, atol=1e-3, rtol=1e-2):
    """Print where ``got`` leaves atol + rtol |want| (count, the first few
    places in (utterance, row, column), both values) and return the max
    |got - want|."""
    err = (got.float() - want.float()).abs()
    beyond = err > atol + rtol * want.float().abs()
    n = int(beyond.sum().item())
    worst = err.max().item()
    place = ''
    if n:
        place = ': ' + '; '.join(
            f'(b {b}, t {t}, col {c}): got {got[b, t, c].item():.6g} want '
            f'{want[b, t, c].item():.6g}'
            for b, t, c in torch.nonzero(beyond)[:8].tolist())
    print(f'{name}: max |diff| {worst:.3g}, {n} elements beyond atol {atol} '
          f'rtol {rtol}{place}', flush=True)
    return worst


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='a checkout whose conv_stack.cu is timed too')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    parser.add_argument('--convs', default='1,2,3,4,5,6')
    args = parser.parse_args()
    names = args.variants.split(',')
    convs = [int(i) for i in args.convs.split(',')]
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not torch.cuda.is_available():
        sys.exit('torch_conv_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch import kernels
    from ppgs_tpu_torch.ops import conv_stack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    parent = Path(args.parent).resolve() if args.parent else None
    libs = build(names, parent, REPO / 'runs' / 'conv_probe')
    sig = kernels.SIGNATURES
    gemm = {n: bind(lib, 'ppgs_conv_gelu', sig['ppgs_conv_gelu'][1])
            for n, lib in libs.items() if n != 'parent'}
    conv0 = {n: bind(lib, 'ppgs_conv0_gelu', sig['ppgs_conv0_gelu'][1])
             for n, lib in libs.items() if n != 'parent'}
    if parent:
        parent_conv = bind(libs['parent'], 'ppgs_conv_gelu', PARENT_ARGS)

    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    C = conv_stack.CHANNELS
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 71)
    ks, ss = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
    B, S = cs.W2V2_BATCH, cs.W2V2_SECONDS * 16_000 + 80
    audio = (0.1 * torch.randn(B, S, generator=gen, device=dev)).to(bf16)
    w0 = (0.3 * torch.randn(ks[0], C, generator=gen, device=dev)).to(bf16)
    taps = [((k * C) ** -0.5 * 1.5 * torch.randn(k * C, C, generator=gen,
                                                  device=dev)).to(bf16)
            for k in ks[1:]]
    gamma = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
    beta = 0.1 * torch.randn(C, generator=gen, device=dev)
    sums = conv_stack.conv_stats_reference(audio, w0, ks[0], ss[0])
    plan0 = conv_stack.conv0_gelu_plan(S, ks[0], ss[0])
    T0 = plan0['T0']
    act = torch.empty(B, T0, C, dtype=bf16, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(err):
        if err:
            raise RuntimeError(f'launch failed with error {err}')

    def run_conv0(name):
        check(conv0[name](audio.data_ptr(), S, w0.data_ptr(), ks[0], ss[0],
                          T0, B, plan0['tiles'], plan0['window'],
                          sums.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                          act.data_ptr(), stream()))

    def run_gemm(name, x, i, out):
        plan = conv_stack.conv_gelu_plan(B, x.shape[1], ks[i], ss[i])
        check(gemm[name](x.data_ptr(), x.shape[1] * C, taps[i - 1].data_ptr(),
                         ks[i], ss[i], plan['T_out'], B, plan['tiles'],
                         plan['blocks'], out.data_ptr(), stream()))

    def run_parent(x, i, out):
        if i == 1:
            head = (x.data_ptr(), S)
            tail = (w0.data_ptr(), ks[0], ss[0], T0, sums.data_ptr(),
                    gamma.data_ptr(), beta.data_ptr())
        else:
            head = (x.data_ptr(), x.shape[1] * C)
            tail = (None, 0, 0, 0, None, None, None)
        check(parent_conv(*head, taps[i - 1].data_ptr(), ks[i], ss[i],
                          out.shape[1], B, out.data_ptr(), *tail,
                          stream()))

    def conv1(name, out):
        run_conv0(name)
        run_gemm(name, act, 1, out)

    event, device, library, bounds, errors, shares = {}, {}, {}, {}, {}, {}
    x, T = audio, T0
    with torch.no_grad():
        for i in range(1, 7):
            k, s = ks[i], ss[i]
            T_out = (T - k) // s + 1
            out = torch.empty(B, T_out, C, dtype=bf16, device=dev)
            runs = {}
            for name in gemm:
                if i == 1:
                    runs[name] = (lambda n=name: conv1(n, out))
                else:
                    runs[name] = (lambda n=name: run_gemm(n, x, i, out))
            if i == 1:
                runs['conv0'] = lambda: run_conv0('this')
            if parent:
                runs['parent'] = lambda: run_parent(x, i, out)
            runs['this']()
            torch.cuda.synchronize()
            this = out.clone()
            if i not in convs:
                x, T = this, T_out
                continue
            fst = (w0, ks[0], ss[0], sums, gamma, beta) if i == 1 else None
            plain = conv_stack.conv_gelu_reference(x, taps[i - 1], k, s, fst)
            errors[f'conv{i} this'] = disagreement(
                f'conv {i} this against the plain version', this, plain)
            for _ in range(3):      # a race would show as a difference
                out.zero_()
                runs['this']()
                torch.cuda.synchronize()
                if not torch.equal(out, this):
                    print(f'conv {i} this: another call differs from the '
                          f'first in {(out != this).sum().item()} elements',
                          flush=True)
            for name in runs:
                if name in ('this', 'conv0', 'loads_only'):
                    continue
                out.zero_()
                runs[name]()
                torch.cuda.synchronize()
                errors[f'conv{i} {name}'] = disagreement(
                    f'conv {i} {name} against the plain version', out, plain)
                disagreement(f'conv {i} {name} against this', out, this)
                if name == 'exact_gelu':
                    shares[f'conv{i}'] = (out != this).float().mean().item()
                    print(f'conv {i}: the fast GELU rounds '
                          f'{shares[f"conv{i}"]:.3e} of the outputs apart '
                          f'from tanhf\'s', flush=True)
            del plain
            if i == 1:
                run_conv0('this')
                x_nct = act.transpose(1, 2).contiguous()
            else:
                x_nct = x.transpose(1, 2).contiguous()
            w_oik = taps[i - 1].view(k, C, C).permute(2, 1, 0).contiguous()

            def cudnn(x_nct=x_nct, w_oik=w_oik, s=s):
                return F.gelu(F.conv1d(x_nct, w_oik, stride=s),
                              approximate='tanh')

            order = list(runs)
            for name in order:
                event[f'conv{i} {name}'] = []
            for name in order + order[::-1]:
                event[f'conv{i} {name}'].append(
                    cs.time_ms(runs[name], args.reps, 2))
            for name in order:
                device[f'conv{i} {name}'] = cs.kernel_device_ms(
                    f'conv {i} {name}', runs[name], card)
            library[f'conv{i}'] = cs.time_ms(cudnn, args.reps, 2)
            device[f'conv{i} cudnn'] = cs.kernel_device_ms(
                f'conv {i} cuDNN conv + GELU', cudnn, card)
            flops = 2 * B * T_out * k * C * C + (2 * B * T0 * ks[0] * C
                                                 if i == 1 else 0)
            nbytes = ((B * S * 2 if i == 1 else B * T * C * 2)
                      + k * C * C * 2 + B * T_out * C * 2)
            bounds[f'conv{i}'] = cs.bound(flops, nbytes)[0]
            for name in order:
                label = f'conv{i} {name}'
                print(f'conv {i} {name}: event {event[label]} ms, device '
                      f'{device[label]} ms; bound {bounds[f"conv{i}"]:.4f} '
                      f'ms; cuDNN conv + GELU {library[f"conv{i}"]:.4f} ms '
                      f'[{card}]', flush=True)
            del x_nct, cudnn
            x, T = this, T_out
            torch.cuda.empty_cache()
    print(json.dumps({'card': card, 'event_ms': event, 'device_ms': device,
                      'library_ms': library, 'bound_ms': bounds,
                      'max_abs_err': errors, 'fast_gelu_share': shares}),
          flush=True)


if __name__ == '__main__':
    main()
