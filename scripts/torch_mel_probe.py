#!/usr/bin/env python3
"""Check and time the port's B9 fused log-mel (fused_mel.cu), variants of
it, and colsum (layer_train.cu) on one CUDA card.

    python3 scripts/torch_mel_probe.py [--parent DIR] [--reps N]
        [--variants this,loads_only,unpadded,lds32,fold16,...] [--no-colsum]

Builds ``ppgs_tpu_torch/kernels/csrc/fused_mel.cu`` as it is and as the
variants below (``--variants``), each with nvcc into ``runs/mel_probe/``
(gitignored), printing ptxas's registers, spills and warnings:
``loads_only``, a walk that loads the stretch, every basis stage and mel
slot and stores the output but multiplies nothing; ``unpadded``, the
stretch's rows at a pitch of hop samples (8 frames of an ldmatrix on two
bank groups at hop 160); ``lds32``, the A fragments by four 32-bit loads
at every hop, not by ldmatrix; ``fold16``, ``fold8``, ``fold1``, the
products of 16, 8 or 1 stages (not 4) summed on the tensor cores before
they are added to the chunk's sums in fp32 (16: one chain of 64 k-steps a
chunk, as the parent's kernel). With ``--parent``, DIR's ``fused_mel.cu``
and ``layer_train.cu`` are built and timed too (DIR: a checkout whose
ppgs_fused_mel takes separate cos, -sin and transposed mel bases, and
whose ppgs_colsum takes no chunk, as before the wgmma kernel).

B9, on seeded inputs: each build against the plain version
(``stft.fused_log_mel_reference``) at odd shapes (B 1-3, T 1 ... 1000, hop
100, 160, 320, 640 and 1024, silent and loud audio) and at the mel
slice's shape (64 utterances x 8 s, hop 160), there also against the
plain version's function in fp64 sums, at chip_smoke.py's limits (atol
8e-3; 99.9% of the values within 1e-4, pooled over the odd shapes;
printed), this build three more times bit for bit; then each timed at the
slice's shape (CUDA-event medians of ``--reps`` runs, in turns: the builds
in order, then reversed) beside the profiler's device time per call, the
bound, the plain version and the cuDNN bf16 chain. colsum: this build
against ``colsum_reference`` (atol 1e-3, rtol 1e-4), its bf16 rounding
the rounding of its own sums, and bit for bit over two calls at each shape
of a 256 x 512 train step, timed by events and device time beside the
parent's, ``t.sum(0)``'s and those of builds whose first pass takes one
row lane (``colsum_lanes1``) or four (``colsum_lanes4``) at every shape.
Prints the card's name and power limit, then one JSON line; exits 1 if a
check of this build failed. Imports nothing of JAX.
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
SOURCE = 'fused_mel.cu'
# name -> substitutions of this checkout's source
VARIANTS = {
    'this': (),
    'loads_only': (('constexpr bool LIVE = true;',
                    'constexpr bool LIVE = false;'),),
    'unpadded': (('constexpr bool PAD = true;',
                  'constexpr bool PAD = false;'),),
    'lds32': (('const bool ldm = hop % 8 == 0;', 'const bool ldm = false;'),),
    'fold16': (('constexpr int FOLD = 4;', 'constexpr int FOLD = 16;'),),
    'fold8': (('constexpr int FOLD = 4;', 'constexpr int FOLD = 8;'),),
    'fold1': (('constexpr int FOLD = 4;', 'constexpr int FOLD = 1;'),),
}
# colsum's builds: layer_train.cu as it is and with other first-pass forms
COLSUM_VARIANTS = {
    'colsum': (),
    'colsum_lanes1': (('LANES4_ROWS = 32, LANES2_ROWS = 16;',
                       'LANES4_ROWS = 1 << 30, LANES2_ROWS = 1 << 30;'),),
    'colsum_lanes4': (('LANES4_ROWS = 32, LANES2_ROWS = 16;',
                       'LANES4_ROWS = 0, LANES2_ROWS = 0;'),),
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The parent's entry points: ppgs_fused_mel(blocks, batch_stride, hop, T,
# B, basis_re, basis_im, mel_t, out, stream) and ppgs_colsum(in, R, N,
# splits, scratch, out, round_bf16, stream)
PARENT_MEL = (_P, _L, _I, _I, _I, _P, _P, _P, _P, _P)
PARENT_COLSUM = (_P, _L, _L, _I, _P, _P, _I, _P)
ODD = ((1, 1, 160), (2, 7, 100), (3, 127, 320), (1, 128, 160),
       (2, 129, 100), (3, 255, 160), (1, 803, 320), (2, 1000, 160),
       (2, 129, 640), (1, 200, 1024))


def build(names, parent, out_dir):
    """Write and compile every variant and the parent's sources, all nvcc
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
    for name, subs in COLSUM_VARIANTS.items():
        src = (CSRC / 'layer_train.cu').read_text()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f'{name}: {old!r} is not in its source')
            src = src.replace(old, new)
        jobs[name] = (src, CSRC)
    if parent:
        pcsrc = parent / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
        jobs['parent'] = ((pcsrc / SOURCE).read_text(), pcsrc)
        jobs['parent_colsum'] = ((pcsrc / 'layer_train.cu').read_text(),
                                 pcsrc)
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


def plan(name, hop):
    """The (frames, pitch) that variant ``name``'s entry point takes."""
    from ppgs_tpu_torch.ops import stft

    frames, pitch = stft.fused_mel_plan(hop)
    if name != 'unpadded':
        return frames, pitch
    taps = -(-1024 // hop)
    fits = stft._SMEM_FIXED + (127 + taps) * hop * 2 <= stft._SMEM_MAX
    return (128 if fits else 64), hop


def compare(name, got, want):
    """(max |got - want|, count within 1e-4, count), printed."""
    err = (got - want).abs()
    worst, close = err.max().item(), int((err <= 1e-4).sum().item())
    flag = '' if worst <= 8e-3 else ' FAILS atol 8e-3'
    print(f'{name}: max |kernel - plain| {worst:.3g}, within 1e-4 '
          f'{close / err.numel():.6f}{flag}', flush=True)
    return worst, close, err.numel()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='a checkout whose fused_mel.cu and colsum are '
                             'timed too')
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    parser.add_argument('--no-colsum', action='store_true')
    args = parser.parse_args()
    names = args.variants.split(',')
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not torch.cuda.is_available():
        sys.exit('torch_mel_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch import kernels
    from ppgs_tpu_torch.ops import backward, stft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    parent = Path(args.parent).resolve() if args.parent else None
    libs = build(names, parent, REPO / 'runs' / 'mel_probe')
    sig = kernels.SIGNATURES
    mel_fns = {n: bind(libs[n], 'ppgs_fused_mel', sig['ppgs_fused_mel'][1])
               for n in names}
    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    geometry = (16000, 1024, 1024)            # rate, n_fft, window

    def check(err):
        if err:
            raise RuntimeError(f'launch failed with error {err}')

    parent_weights = {}

    def runner(name, blocks, T, hop):
        """A call of build ``name`` on (B, T + taps - 1, hop) ``blocks``."""
        B = blocks.shape[0]
        taps = -(-1024 // hop)
        out = torch.empty(B, 80, T, device=dev)
        if name == 'parent':
            if hop not in parent_weights:
                re, im, mel_t = stft.mel_kernel_host(*geometry, hop, 80)
                pad = [torch.zeros(r, c, device=dev)
                       for r, c in ((1024, 576), (1024, 576), (576, 80))]
                for p_, a in zip(pad, (re[:1024], im[:1024], mel_t)):
                    p_[:a.shape[0], :a.shape[1]] = torch.from_numpy(a)
                parent_weights[hop] = [p_.to(bf16) for p_ in pad]
            w = parent_weights[hop]
            fn = bind(libs['parent'], 'ppgs_fused_mel', PARENT_MEL)
            return out, lambda: check(fn(
                blocks.data_ptr(), (T + taps - 1) * hop, hop, T, B,
                w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),
                out.data_ptr(), stream()))
        basis, mel = stft._fused_mel_weights(*geometry, hop, dev)
        frames, pitch = plan(name, hop)
        return out, lambda: check(mel_fns[name](
            blocks.data_ptr(), (T + taps - 1) * hop, hop, T, B, frames,
            pitch, basis.data_ptr(), mel.data_ptr(), out.data_ptr(),
            stream()))

    checked = [n for n in names if not n.startswith('loads_only')]
    if parent:
        checked.append('parent')
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 31)
    results = {'card': card, 'checks': {}, 'ms': {}, 'device_ms': {}}
    failed = []
    with torch.no_grad():
        # The odd shapes, then silent and loud audio, pooled per build
        pooled = {n: [0.0, 0, 0] for n in checked}
        cases = [(B, T, hop, 0.1) for B, T, hop in ODD]
        cases += [(2, 129, 160, 0.0), (2, 129, 160, 30.0), (1, 300, 100, 0.0),
                  (3, 64, 320, 30.0)]
        for B, T, hop, scale in cases:
            taps = -(-1024 // hop)
            blocks = scale * torch.randn(B, T + taps - 1, hop, generator=gen,
                                         device=dev)
            want = stft.fused_log_mel_reference(blocks, T, *geometry, hop, 80)
            for n in checked:
                out, run = runner(n, blocks, T, hop)
                run()
                torch.cuda.synchronize()
                worst, close, count = compare(
                    f'{n} B={B} T={T} hop={hop} x{scale:g}', out, want)
                p_ = pooled[n]
                p_[0], p_[1], p_[2] = max(p_[0], worst), p_[1] + close, \
                    p_[2] + count
        for n, (worst, close, count) in pooled.items():
            ok = worst <= 8e-3 and close >= 0.999 * count
            print(f'{n} odd shapes pooled: max {worst:.3g}, within 1e-4 '
                  f'{close / count:.6f} ({"ok" if ok else "FAILS"})',
                  flush=True)
            results['checks'][f'{n} odd'] = [worst, close / count]
            if not ok and n == 'this':
                failed.append(f'{n} odd shapes')

        # The mel slice's shape
        samples = cs.SECONDS * 16000
        audio = 0.1 * torch.randn(cs.BATCH, 1, samples, generator=gen,
                                  device=dev)
        blocks, T = stft._audio_to_blocks(audio, 1024, 160)
        blocks = blocks.contiguous()
        want = stft.fused_log_mel_reference(blocks, T, *geometry, 160, 80)
        runs = {n: runner(n, blocks, T, 160) for n in names}
        if parent:
            runs['parent'] = runner('parent', blocks, T, 160)
        runs['this'][1]()
        torch.cuda.synchronize()
        this = runs['this'][0].clone()
        want64 = exact_reference(stft, blocks, T, geometry, 160)
        compare('plain (fp32 sums) against fp64 sums', want, want64)
        for n in checked:
            runs[n][1]()
            torch.cuda.synchronize()
            compare(f'{n} against fp64 sums', runs[n][0], want64)
            worst, close, count = compare(f'{n} {cs.BATCH} x {T} frames',
                                          runs[n][0], want)
            results['checks'][n] = [worst, close / count]
            if n == 'this' and (worst > 8e-3 or close < 0.999 * count):
                failed.append('this at the slice shape')
        for _ in range(3):
            runs['this'][1]()
            torch.cuda.synchronize()
            if not torch.equal(runs['this'][0], this):
                failed.append('this repeats')
                print('this: another call differs from the first', flush=True)

        n_freqs, M = 513, cs.BATCH * T
        work = (2 * 2 * M * 1024 * n_freqs + 2 * M * n_freqs * 80,
                blocks.numel() * 4 + 2 * 1024 * n_freqs * 2 + n_freqs * 80 * 2
                + M * 80 * 4)
        bound_ms, bound_by = cs.bound(*work)
        wconv = stft._conv_weight(1024, 1024, 160, dev).to(bf16)
        wmel = stft._mel_weight(16000, 1024, 80, dev).to(bf16)

        def library_mel():
            spec = F.conv1d(blocks.transpose(1, 2).to(bf16), wconv).float()
            re, im = spec[:, :n_freqs], spec[:, n_freqs:]
            mag = torch.sqrt(re * re + im * im + 1e-6).to(bf16)
            return torch.log(torch.clamp((wmel @ mag).float(), min=1e-5))

        order = list(runs)
        ms = {n: [] for n in order}
        for names_ in (order, order[::-1]):
            for n in names_:
                ms[n].append(cs.time_ms(runs[n][1], args.reps))
        for n in order:
            results['ms'][n] = ms[n]
            results['device_ms'][n] = cs.kernel_device_ms(
                f'B9 {n}', runs[n][1], card)
        results['library_ms'] = cs.time_ms(library_mel, args.reps)
        results['plain_ms'] = cs.time_ms(
            lambda: stft.fused_log_mel_reference(blocks, T, *geometry, 160,
                                                 80), 3, 1)
        results['bound_ms'] = bound_ms
        for n in order:
            print(f'B9 {n}: events {ms[n][0]:.4f} / {ms[n][1]:.4f} ms, device '
                  f'{results["device_ms"][n]} ms, bound {bound_ms:.4f} '
                  f'({bound_by}), cuDNN chain {results["library_ms"]:.4f}, '
                  f'plain {results["plain_ms"]:.4f} [{card}]', flush=True)
        del audio, blocks, want, runs, this

        if not args.no_colsum:
            results['colsum'] = colsum_probe(libs, parent, backward, cs, card,
                                             gen, args.reps, failed, check,
                                             stream)
    print(json.dumps(results), flush=True)
    if failed:
        sys.exit(f'failed: {failed}')


def exact_reference(stft, blocks, T, geometry, hop):
    """The plain version's function with its DFT and mel sums in fp64
    (the same bf16 roundings), to see how far each side's fp32 sums are
    from exact ones."""
    f64 = torch.float64
    basis_re, basis_im, mel_t = (
        torch.from_numpy(a).to(blocks.device, torch.bfloat16).to(f64)
        for a in stft.mel_kernel_host(*geometry, hop, 80))
    taps = basis_re.shape[0] // hop
    idx = (torch.arange(T, device=blocks.device)[:, None]
           + torch.arange(taps, device=blocks.device)[None])
    out = []
    for x in blocks:
        w = x[idx].reshape(T, taps * hop).to(torch.bfloat16).to(f64)
        re, im = w @ basis_re, w @ basis_im
        mag = torch.sqrt(re * re + im * im + 1e-6).float()
        mel = mag.to(torch.bfloat16).to(f64) @ mel_t
        out.append(torch.log(torch.clamp(mel, min=1e-5)).T.float())
    return torch.stack(out)


def device_per_call(fn, reps=10):
    """The device milliseconds of all kernels a call of ``fn`` launches
    (torch.profiler over ``reps`` calls after a warm-up, summed, over
    reps): two launches of one kernel count twice."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps


def colsum_probe(libs, parent, backward, cs, card, gen, reps, failed, check,
                 stream):
    """colsum at each shape of a 256 x 512 step against its plain version,
    bit for bit twice, and timed beside the parent's and t.sum(0)."""
    from ppgs_tpu_torch import kernels

    dev = torch.device('cuda')
    fns_by = {n: bind(libs[n], 'ppgs_colsum',
                      kernels.SIGNATURES['ppgs_colsum'][1])
              for n in COLSUM_VARIANTS}
    pfn = bind(libs['parent_colsum'], 'ppgs_colsum', PARENT_COLSUM) \
        if parent else None
    M, C, Fh = 256 * 512, 256, 2048
    shapes = {'dbqkv': (M, 3 * C), 'ln_part': (M // 64, 3 * C),
              'db1_part': (M // 64, Fh)}
    for name, (m, n) in {'dW1': (C, Fh), 'dW2': (Fh, C), 'dWo': (C, C),
                         'dWqkv': (C, 3 * C)}.items():
        shapes[name] = (backward.split_count(m, n, M), m * n)
    out = {}
    for name, (R, N) in shapes.items():
        t = torch.randn(R, N, generator=gen, device=dev)
        res = torch.empty(N, device=dev)

        def run(round_bf16=0, name='colsum'):
            splits, chunk = backward.colsum_plan(R, N)
            scratch = torch.empty(splits, N, device=dev) if splits > 1 \
                else None
            check(fns_by[name](t.data_ptr(), R, N, splits, chunk,
                               kernels.ptr(scratch), res.data_ptr(),
                               round_bf16, stream()))

        def run_parent():
            splits = max(1, min(512, R // 256))
            scratch = torch.empty(splits, N, device=dev) if splits > 1 \
                else None
            check(pfn(t.data_ptr(), R, N, splits, kernels.ptr(scratch),
                      res.data_ptr(), 0, stream()))

        run()
        torch.cuda.synchronize()
        first = res.clone()
        want = backward.colsum_reference(t)
        err = (first - want).abs()
        ok = bool((err <= 1e-3 + 1e-4 * want.abs()).all())
        run()
        torch.cuda.synchronize()
        same = torch.equal(res, first)
        run(1)                  # the bf16 rounding of the same sums
        torch.cuda.synchronize()
        rounded = torch.equal(res, first.to(torch.bfloat16).float())
        print(f'colsum {name} ({R} x {N}): max |kernel - plain| '
              f'{err.max().item():.3g} ({"ok" if ok else "FAILS"} atol 1e-3 '
              f'rtol 1e-4), two calls {"bit for bit" if same else "DIFFER"}, '
              f'rounded {"= bf16(sums)" if rounded else "WRONG"}', flush=True)
        if not (ok and same and rounded):
            failed.append(f'colsum {name}')
        fns = {'this': run, 'torch_sum': lambda: t.sum(0)}
        for n in COLSUM_VARIANTS:
            if n != 'colsum':
                fns[n] = lambda n=n: run(0, n)
        if pfn:
            fns['parent'] = run_parent
        row = {}
        for k, f_ in fns.items():
            row[k] = (cs.time_ms(f_, reps), device_per_call(f_))
        nbytes = R * N * 4 + N * 4
        row['bound_ms'] = cs.bound(R * N, nbytes)[0]
        print(f'colsum {name} ({R} x {N}): ' + ', '.join(
            f'{k} events {v[0]:.4f} device {v[1]}' for k, v in row.items()
            if k != 'bound_ms') + f', bound {row["bound_ms"]:.4f} [{card}]',
            flush=True)
        out[name] = row
        del t
    return out


if __name__ == '__main__':
    main()
