#!/usr/bin/env python3
"""Time the port's B10 kernels (conv_stack.cu) and variants of them on one
CUDA card.

    python3 scripts/torch_conv_probe.py [--parent DIR] [--reps N]
        [--variants this,...] [--parent-variants parent_stats_regs,...]
        [--stages stats,conv0,convs] [--convs 1,2,...]

Builds ``ppgs_tpu_torch/kernels/csrc/conv_stack.cu`` as it is and as the
variants below (``--variants``), each with nvcc into ``runs/conv_probe/``
(gitignored), all at once, printing ptxas's registers, spills and
warnings. Variants of this source:

- ``exact_gelu``: conv_gelu's epilogue GELU by tanhf (the share of outputs
  it rounds apart from the ex2/rcp form is counted);
- ``loads_only``: conv_gelu streaming every operand and storing its output
  but multiplying nothing;
- ``conv0_tanhf``: conv0_gelu's GELU by tanhf for every element (no fast
  form, no guard): its output must equal this build's bit for bit, which
  is what the guard promises;
- ``conv0_unguarded``: conv0_gelu's fast GELU with no guard (the outputs
  it rounds apart from tanhf's are counted);
- ``conv0_fma``: conv0_gelu with conv 0 by FMAs in tap order on the CUDA
  cores (the parent's sums) in place of the tensor cores;
- ``conv0_stores_only``: conv0_gelu's grid staging and storing zeros;
- ``conv0_check_only``: conv0_gelu's guard checked and counted but no
  pair made by tanhf (timed, not checked);
- ``conv0_6blocks``: conv0_gelu compiled for 6 blocks an SM (85
  registers a thread), not 7 (72);
- ``stats_no_dmma``: conv_stats with one fp64 FMA a group of frames in
  place of its m16n8k8 products (timed, not checked);
- ``stats_no_tail``: conv_stats without the last block's sums and
  contraction (timed, not checked);
- ``stats_no_stage``: conv_stats without its 16-byte copies of the audio
  (timed, not checked);
- ``stats_f2304``, ``stats_f1152``: conv_stats with blocks of 2304 or 1152
  frames (and a stage to match), not 4608.

With ``--parent DIR`` (a checkout of the tree before the conv_stats and
conv0_gelu redesign, e.g. ``git archive 1f87162 ppgs_tpu_torch |
tar -x -C DIR``), DIR's ``conv_stack.cu`` is built and timed too, and the
variants of it in ``--parent-variants``: ``parent_stats_regs``, its
conv_stats with the samples read from a register in place of shared
memory (the same FMAs); ``parent_conv0_zeros``, its conv0_gelu grid
writing zeros (a store-only walk).

On seeded inputs at the w2v2fb slice's shape (64 utterances x 8 s of
padded audio, 128,080 samples; wav2vec2-base's geometry) it runs, by
stage: ``stats``, conv_stats of each build against the plain version
(atol 1e-3, rtol 1e-4) and an fp64 oracle, on a normal draw and a loud one
with a DC offset, this build three more times (bit for bit), and the
times; ``conv0``, conv0_gelu of each build on the same statistics against
the plain version (atol 1e-3, rtol 1e-2), the share of outputs that differ
from the parent's and from this build's, this build's guard share, and the
times; ``convs``, the chain conv 1 .. conv 6 of each build against the
plain version, and the times beside cuDNN's bf16 conv + GELU at that shape.
Times are CUDA-event medians of ``--reps`` runs, in turns (the builds in
order, then reversed), and the profiler's device time per call, beside the
bound. Prints the card's name and power limit, then one JSON line. Imports
nothing of JAX.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
SOURCE = 'conv_stack.cu'
# conv0_gelu's conv 0 on the tensor cores, and the conv0_fma variant's in
# its place: by fmaf in tap order, the sums of the CUDA-core kernel before
# the redesign (W0 read from its swizzled boxes)
CONV0_WGMMA = '''\
      wgmma_fence();
      wgmma_rs<C0_COLS>(
          acc, a[rg],
          sw128_desc(w0_addr + C0_BOXES * q * W0_BOX, W0_BOX, 1024), false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
'''
CONV0_FMA = '''\
      zero(acc);
      for (int p = 0; p < f.k0; ++p) {
        const float x0 = __uint_as_float(sample(r, p) << 16);
        const float x1 = __uint_as_float(sample(r + 8, p) << 16);
#pragma unroll
        for (int j = 0; j < C0_COLS / 8; ++j) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              sm + (C0_BOXES * q + j / 8) * W0_BOX + p * 128 +
              (((j % 8) ^ (p & 7)) << 4) + 4 * t);
          const float w_lo = __uint_as_float(w << 16);
          const float w_hi = __uint_as_float(w & 0xffff0000u);
          acc[4 * j] = fmaf(x0, w_lo, acc[4 * j]);
          acc[4 * j + 1] = fmaf(x0, w_hi, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(x1, w_lo, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(x1, w_hi, acc[4 * j + 3]);
        }
      }
'''
# name -> substitutions of this checkout's source
VARIANTS = {
    'this': (),
    'exact_gelu': (('constexpr bool FAST_GELU = true;',
                    'constexpr bool FAST_GELU = false;'),),
    'loads_only': (('constexpr bool LIVE = true;',
                    'constexpr bool LIVE = false;'),),
    'conv0_tanhf': (('  const float f0 = gelu_fast(x0), '
                     'f1 = gelu_fast(x1);\n',
                     '  unsafe = 0u;\n'
                     '  return pack_bf16(ppgs::gelu_tanh(x0), '
                     'ppgs::gelu_tanh(x1));\n'
                     '  const float f0 = gelu_fast(x0), '
                     'f1 = gelu_fast(x1);\n'),),
    'conv0_unguarded': (('  unsafe = hi ^ pack_bf16(f0 - m0, f1 - m1);\n'
                         '  return hi;',
                         '  unsafe = 0u;\n'
                         '  return pack_bf16(f0, f1);'),),
    'conv0_fma': ((CONV0_WGMMA, CONV0_FMA),),
    'conv0_stores_only': (('constexpr bool CONV0_LIVE = true;',
                           'constexpr bool CONV0_LIVE = false;'),),
    'conv0_check_only': (('      if (CONV0_LIVE) {\n'
                          '        while (bad) {',
                          '      taken += 2 * __popc(bad);\n'
                          '      if (false) {\n'
                          '        while (bad) {'),),
    'conv0_6blocks': (('__global__ void __launch_bounds__(128, 7)',
                       '__global__ void __launch_bounds__(128, 6)'),),
    'stats_no_dmma': (('      dmma(d0[i], x, y, x4, y4, x, x4);\n'
                       '      if (base_high) dmma(d1[i], x, y, x4, y4, y, y4);',
                       '      d0[i][0] = fma(x, y4, d0[i][0]);'),),
    'stats_no_tail': (('  if (!last) return;', '  return;'),),
    'stats_no_stage': (
        ('    reinterpret_cast<uint4*>(samples + head)[i] =\n'
         '        reinterpret_cast<const uint4*>(src + head)[i];', '    ;'),),
    'stats_f2304': (('constexpr int STATS_FRAMES = 4608;',
                     'constexpr int STATS_FRAMES = 2304;'),
                    ('constexpr int STATS_SAMPLES = 24576;',
                     'constexpr int STATS_SAMPLES = 12288;')),
    'stats_f1152': (('constexpr int STATS_FRAMES = 4608;',
                     'constexpr int STATS_FRAMES = 1152;'),
                    ('constexpr int STATS_SAMPLES = 24576;',
                     'constexpr int STATS_SAMPLES = 6144;')),
}
# name -> substitutions of --parent's source (1f87162's conv_stack.cu)
PARENT_VARIANTS = {
    'parent_stats_regs': (
        ('float sum = 0.f, sq = 0.f;', 'float sum = 0.f, sq = 0.f, a_f = 0.f;'),
        ('const float* a = s_audio + s0 * f;', 'a_f += 1.f;'),
        ('if (p < k0) x = fmaf(a[p], w[p], x);',
         'if (p < k0) x = fmaf(a_f, w[p], x);')),
    'parent_conv0_zeros': (
        ('pack_bf16(ppgs::gelu_tanh((x0 - mean[0]) * rstd[0] * g[0] + be[0]),\n'
         '                  ppgs::gelu_tanh((x1 - mean[1]) * rstd[1] * g[1] + '
         'be[1]));', '0u;'),),
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The entry points of a source before the redesign: ppgs_conv0_gelu
# without the guard count (audio, S, w0, k0, s0, T0, B, tiles, window,
# sums, gamma, beta, act, stream), 128 frames a block; ppgs_conv_stats
# without tiles (audio, S, w0, k0, s0, T0, B, partial, sums, tickets,
# stream)
OLD_CONV0_ARGS = (_P, _L, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P)
OLD_CONV0_FRAMES = 128
OLD_STATS_ARGS = (_P, _L, _P, _I, _I, _I, _I, _P, _P, _P, _P)


def build(names, parent, parent_names, out_dir):
    """Write and compile every variant and the parent's source, all nvcc
    processes at once; returns {name: (ctypes library, source text)}."""
    from ppgs_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    sources = [(names, VARIANTS, CSRC)]
    if parent:
        pcsrc = parent / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
        sources.append((['parent', *parent_names],
                        {'parent': (), **PARENT_VARIANTS}, pcsrc))
    for group, table, include in sources:
        for name in group:
            src = (include / SOURCE).read_text()
            for old, new in table[name]:
                if old not in src:
                    raise SystemExit(f'{name}: {old!r} is not in its source')
                src = src.replace(old, new)
            jobs[name] = (src, include)
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
        libs[name] = (ctypes.CDLL(str(out_dir / f'{name}.so')),
                      jobs[name][0])
    return libs


def bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def disagreement(name, got, want, atol=1e-3, rtol=1e-2):
    """Print where ``got`` leaves atol + rtol |want| (count, the first few
    places, both values) and return the max |got - want|."""
    err = (got.float() - want.float()).abs()
    beyond = err > atol + rtol * want.float().abs()
    n = int(beyond.sum().item())
    worst = err.max().item()
    place = ''
    if n:
        place = ': ' + '; '.join(
            f'({", ".join(map(str, idx))}): got '
            f'{got[tuple(idx)].item():.6g} want {want[tuple(idx)].item():.6g}'
            for idx in torch.nonzero(beyond)[:8].tolist())
    print(f'{name}: max |diff| {worst:.3g}, {n} elements beyond atol {atol} '
          f'rtol {rtol}{place}', flush=True)
    return worst


def stats_oracle(audio, w0, k0, s0):
    """conv 0's per-channel sum and sum of squares in fp64, directly (conv 0
    in fp64 one utterance at a time, no Gram matrix)."""
    w = w0.double()
    out = []
    for a in audio:
        x = a.double().unfold(-1, k0, s0) @ w               # (T0, C)
        out.append(torch.stack([x.sum(0), (x * x).sum(0)]))
    return torch.stack(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='a checkout whose conv_stack.cu is timed too')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    parser.add_argument('--parent-variants', default=','.join(PARENT_VARIANTS),
                        help='comma-separated subset of '
                        + ','.join(PARENT_VARIANTS))
    parser.add_argument('--stages', default='stats,conv0,convs')
    parser.add_argument('--convs', default='1,2,3,4,5,6')
    args = parser.parse_args()
    names = args.variants.split(',')
    parent_names = [n for n in args.parent_variants.split(',') if n]
    stages = set(args.stages.split(','))
    convs = [int(i) for i in args.convs.split(',') if i]
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not set(parent_names) <= set(PARENT_VARIANTS):
        sys.exit(f'--parent-variants: a subset of {list(PARENT_VARIANTS)}')
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
    libs = build(names, parent, parent_names if parent else [],
                 REPO / 'runs' / 'conv_probe')
    sig = kernels.SIGNATURES
    # a source whose conv0_gelu counts its guard takes one pointer more,
    # one whose conv_stats stages its samples the plan's tiles
    counted = {n: 'guarded' in src for n, (_, src) in libs.items()}
    staged = {n: 'stats_frames' in src for n, (_, src) in libs.items()}
    stats = {n: bind(lib, 'ppgs_conv_stats', sig['ppgs_conv_stats'][1]
                     if staged[n] else OLD_STATS_ARGS)
             for n, (lib, _) in libs.items()}
    conv0 = {n: bind(lib, 'ppgs_conv0_gelu', sig['ppgs_conv0_gelu'][1]
                     if counted[n] else OLD_CONV0_ARGS)
             for n, (lib, _) in libs.items()}
    gemm = {n: bind(lib, 'ppgs_conv_gelu', sig['ppgs_conv_gelu'][1])
            for n, (lib, _) in libs.items() if not n.startswith('parent_')}

    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    C = conv_stack.CHANNELS
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 71)
    ks, ss = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
    k0, s0 = ks[0], ss[0]
    B, S = cs.W2V2_BATCH, cs.W2V2_SECONDS * 16_000 + 80
    audio = (0.1 * torch.randn(B, S, generator=gen, device=dev)).to(bf16)
    w0 = (0.3 * torch.randn(k0, C, generator=gen, device=dev)).to(bf16)
    taps = [((k * C) ** -0.5 * 1.5 * torch.randn(k * C, C, generator=gen,
                                                  device=dev)).to(bf16)
            for k in ks[1:]]
    gamma = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
    beta = 0.1 * torch.randn(C, generator=gen, device=dev)
    loud = (0.9 + 0.05 * torch.randn(B, S, generator=gen, device=dev)
            ).to(bf16)
    sums = conv_stack.conv_stats_reference(audio, w0, k0, s0)
    T0 = (S - k0) // s0 + 1
    act = torch.empty(B, T0, C, dtype=bf16, device=dev)
    # scratch for every build's conv_stats (the parent's partials are the
    # larger: (B, ceil(T0 / 256), 2, C) fp32)
    scratch = torch.zeros(B * (-(-T0 // 256)) * 2 * C + 4096,
                          dtype=torch.float64, device=dev)
    # a build's own tickets: stats_no_tail leaves its own raised
    tickets = {n: torch.zeros(B, dtype=torch.int32, device=dev) for n in libs}
    guarded = torch.zeros(1, dtype=torch.int64, device=dev)
    out_stats = torch.empty(B, 2, C, dtype=torch.float32, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(err):
        if err:
            raise RuntimeError(f'launch failed with error {err}')

    def stats_tiles(name):
        # the build's own blocks (conv_stats_plan's rule, its constants)
        src = libs[name][1]
        frames, samples = (int(re.search(rf'constexpr int {key} = (\d+);',
                                         src).group(1))
                           for key in ('STATS_FRAMES', 'STATS_SAMPLES'))
        frames = min(frames, (samples - conv_stack.MAX_K0) // s0 + 1)
        return -(-T0 // frames)

    def run_stats(name, a=audio):
        tiles = (stats_tiles(name),) if staged[name] else ()
        check(stats[name](a.data_ptr(), S, w0.data_ptr(), k0, s0, T0, B,
                          *tiles, scratch.data_ptr(), out_stats.data_ptr(),
                          tickets[name].data_ptr(), stream()))

    def run_conv0(name, count=None):
        if counted[name]:
            plan = conv_stack.conv0_gelu_plan(S, k0, s0)
            tiles, window = plan['tiles'], plan['window']
            tail = (count.data_ptr() if count is not None else None,)
        else:
            tiles = -(-T0 // OLD_CONV0_FRAMES)
            window, tail = s0 * (OLD_CONV0_FRAMES - 1) + k0, ()
        check(conv0[name](audio.data_ptr(), S, w0.data_ptr(), k0, s0, T0, B,
                          tiles, window, sums.data_ptr(), gamma.data_ptr(),
                          beta.data_ptr(), act.data_ptr(), *tail, stream()))

    def run_gemm(name, x, i, out):
        plan = conv_stack.conv_gelu_plan(B, x.shape[1], ks[i], ss[i])
        check(gemm[name](x.data_ptr(), x.shape[1] * C, taps[i - 1].data_ptr(),
                         ks[i], ss[i], plan['T_out'], B, plan['tiles'],
                         plan['blocks'], out.data_ptr(), stream()))

    def timed(label, runs, work, library=None):
        """Event and device times of each run in turns, beside the bound
        and the library call's (by both clocks)."""
        order = list(runs)
        for name in order:
            event[f'{label} {name}'] = []
        for name in order + order[::-1]:
            event[f'{label} {name}'].append(cs.time_ms(runs[name], args.reps,
                                                       2))
        for name in order:
            device[f'{label} {name}'] = cs.kernel_device_ms(
                f'{label} {name}', runs[name], card)
        bounds[label] = cs.bound(*work)[0]
        lib = ''
        if library is not None:
            what, fn = library
            library_ms[label] = cs.time_ms(fn, args.reps, 2)
            device[f'{label} library'] = cs.kernel_device_ms(
                f'{label} library ({what})', fn, card)
            lib = (f'; library ({what}) {library_ms[label]:.4f} ms, device '
                   f'{device[f"{label} library"]} ms')
        for name in order:
            key = f'{label} {name}'
            print(f'{key}: event {event[key]} ms, device {device[key]} ms; '
                  f'bound {bounds[label]:.4f} ms{lib} [{card}]', flush=True)

    event, device, library_ms, bounds, errors, shares = {}, {}, {}, {}, {}, {}
    builds = list(libs)
    w0_oik = w0.T[:, None, :].contiguous()
    with torch.no_grad():
        if 'stats' in stages:
            for draw, a in (('normal', audio), ('loud', loud)):
                plain = conv_stack.conv_stats_reference(a, w0, k0, s0)
                exact = stats_oracle(a, w0, k0, s0)
                scale = exact.abs().amax().item()
                print(f'conv_stats, {draw} draw: the plain version against '
                      f'fp64: max |diff| '
                      f'{(plain.double() - exact).abs().max().item():.3g} '
                      f'(max |sum| {scale:.4g})', flush=True)
                for name in builds:
                    run_stats(name, a)
                    torch.cuda.synchronize()
                    got = out_stats.clone()
                    errors[f'stats {draw} {name}'] = disagreement(
                        f'conv_stats {draw} {name} against the plain version',
                        got, plain, atol=1e-3, rtol=1e-4)
                    disagreement(f'conv_stats {draw} {name} against fp64',
                                 got, exact.float(), atol=1e-3, rtol=1e-4)
                    if name == 'this':
                        for _ in range(3):
                            run_stats('this', a)
                            torch.cuda.synchronize()
                            if not torch.equal(out_stats, got):
                                print('conv_stats this: another call differs '
                                      'from the first', flush=True)
            runs = {name: (lambda n=name: run_stats(n)) for name in builds}
            frames = B * T0
            pairs = k0 * (k0 + 1) // 2 + k0

            def library_stats():
                x = F.conv1d(audio[:, None], w0_oik, stride=s0)
                return torch.stack([x.float().sum(-1),
                                    (x.float() * x.float()).sum(-1)], 1)

            # the Gram route's fp64 products count at the fp64 tensor peak
            timed('conv_stats', runs,
                  (2 * frames * pairs * cs.PEAK_BF16_FLOPS / cs.PEAK_FP64_FLOPS,
                   B * S * 2 + k0 * C * 2 + B * 2 * C * 4),
                  ('cuDNN bf16 conv 0, sum, sum of squares', library_stats))
        if 'conv0' in stages:
            plain = conv_stack.conv0_gelu_reference(audio, w0, k0, s0, sums,
                                                    gamma, beta)
            outs = {}
            for name in builds:
                act.zero_()
                run_conv0(name)
                torch.cuda.synchronize()
                outs[name] = act.clone()
                errors[f'conv0 {name}'] = disagreement(
                    f'conv0_gelu {name} against the plain version',
                    outs[name], plain)
            n = plain.numel()
            for ref in ('parent', 'this'):
                if ref not in outs:
                    continue
                for name, got in outs.items():
                    if name != ref:
                        share = (got != outs[ref]).sum().item() / n
                        shares[f'conv0 {name} vs {ref}'] = share
                        print(f'conv0_gelu {name}: {share:.4e} of the outputs '
                              f'differ from {ref}\'s', flush=True)
            if counted['this']:
                guarded.zero_()
                run_conv0('this', guarded)
                torch.cuda.synchronize()
                shares['conv0 guard'] = guarded.item() / n
                print(f'conv0_gelu this: the guard took {guarded.item()} of '
                      f'{n} outputs by tanhf ({guarded.item() / n:.4e})',
                      flush=True)
                for _ in range(3):
                    run_conv0('this')
                    torch.cuda.synchronize()
                    if not torch.equal(act, outs['this']):
                        print('conv0_gelu this: another call differs from '
                              'the first', flush=True)
            del outs, plain
            runs = {name: (lambda n=name: run_conv0(n)) for name in builds}

            def library_conv0():
                x = F.conv1d(audio[:, None], w0_oik, stride=s0).float()
                x = F.group_norm(x, C, gamma, beta, 1e-5)
                return F.gelu(x, approximate='tanh').to(bf16)

            timed('conv0_gelu', runs,
                  (2 * B * T0 * k0 * C,
                   B * S * 2 + k0 * C * 2 + B * 2 * C * 4 + 2 * C * 4
                   + B * T0 * C * 2),
                  ('cuDNN bf16 conv 0, group_norm, gelu, cast', library_conv0))
        if 'convs' in stages and convs:
            conv_stages(cs, conv_stack, libs, gemm, run_conv0, run_gemm,
                        timed, errors, shares, audio, act, w0, sums, gamma,
                        beta, taps, ks, ss, convs, B, T0, dev)
    print(json.dumps({'card': card, 'event_ms': event, 'device_ms': device,
                      'library_ms': library_ms, 'bound_ms': bounds,
                      'max_abs_err': errors, 'shares': shares}), flush=True)


def conv_stages(cs, conv_stack, libs, gemm, run_conv0, run_gemm, timed,
                errors, shares, audio, act, w0, sums, gamma, beta, taps, ks,
                ss, convs, B, T0, dev):
    """Convs 1 .. 6 (conv 1: conv0_gelu, then the product) of each build
    that has conv_gelu, against the plain version, timed beside cuDNN."""
    C = conv_stack.CHANNELS
    names = [n for n in gemm if n == 'this' or n in ('exact_gelu',
                                                     'loads_only', 'parent')]
    x, T = audio, T0
    for i in range(1, 7):
        k, s = ks[i], ss[i]
        T_out = (T - k) // s + 1
        out = torch.empty(B, T_out, C, dtype=torch.bfloat16, device=dev)
        runs = {}
        for name in names:
            if i == 1:
                def conv1(n=name):
                    run_conv0(n)
                    run_gemm(n, act, 1, out)
                runs[name] = conv1
            else:
                runs[name] = (lambda n=name: run_gemm(n, x, i, out))
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
        for name in runs:
            if name in ('this', 'loads_only'):
                continue
            out.zero_()
            runs[name]()
            torch.cuda.synchronize()
            errors[f'conv{i} {name}'] = disagreement(
                f'conv {i} {name} against the plain version', out, plain)
            if name == 'exact_gelu':
                shares[f'conv{i} exact_gelu'] = (out != this).float().mean(
                    ).item()
                print(f'conv {i}: the fast GELU rounds '
                      f'{shares[f"conv{i} exact_gelu"]:.3e} of the outputs '
                      f'apart from tanhf\'s', flush=True)
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

        flops = 2 * B * T_out * k * C * C + (2 * B * T0 * ks[0] * C
                                             if i == 1 else 0)
        nbytes = ((audio.numel() * 2 if i == 1 else B * T * C * 2)
                  + k * C * C * 2 + B * T_out * C * 2)
        timed(f'conv{i}', runs, (flops, nbytes),
              ('cuDNN conv + GELU' + (' on a stored conv-0 activation'
                                      if i == 1 else ''), cudnn))
        del x_nct, cudnn
        x, T = this, T_out
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
