#!/usr/bin/env python3
"""Time variants of the port's attention_train_fwd kernel on one CUDA card.

    python3 scripts/torch_attention_fwd_probe.py [--parent DIR] [--reps N]
        [--variants this,draw_in_pass1,...]

Builds ``ppgs_tpu_torch/kernels/csrc/attention_train.cu`` as it is and as
the variants below (``--variants``, all by default; each a text
substitution: stages and blocks an SM, pass 1 drawing the keep bits, pass
1 with one K tile a stage instead of two, blocks of 4 warpgroups (256
rows), a loads-only walk that streams every tile, writes the outputs and
computes nothing), and, with ``--parent``, the
same file of another checkout (such as an unpacked ``git archive`` of an
older commit; its C entry point must take the same arguments), each with
nvcc into ``runs/fwd_probe/`` (gitignored), and prints ptxas's registers,
spills and warnings. On chip_smoke.py's training shape (256 windows x T =
512, 2 heads of 128, ragged windows, one wholly masked, the fp32 output)
it checks every variant that computes the function against this
checkout's build (bit for bit; the parent to within chip_smoke.py's
limits), then times each with dropout 0.1 and off (threshold 0), in turns
(the variants in order, then reversed): CUDA-event medians of ``--reps``
runs and the profiler's device time per launch, beside
scaled_dot_product_attention with dropout. Prints the card's name and
power limit, then one JSON line. Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / 'ppgs_tpu_torch' / 'kernels' / 'csrc'
SOURCE = 'attention_train.cu'
LIVE = 'const bool live = i < wg_tiles && valid != 0;'
PASS1 = ('constexpr bool DRAW_IN_PASS2 = true;',
         'constexpr bool DRAW_IN_PASS2 = false;')
ONE_TILE = ('constexpr int PASS1_TILES = 2;', 'constexpr int PASS1_TILES = 1;')
# name -> the substitutions that make it from this checkout's source
VARIANTS = {
    'this': (),
    'stages3_blocks1': (
        ('static constexpr int STAGES = 2;',
         'static constexpr int STAGES = 3;'),
        ('static constexpr int BLOCKS = 4 / WGS;',
         'static constexpr int BLOCKS = 1;')),
    'stages4_blocks1': (
        ('static constexpr int STAGES = 2;',
         'static constexpr int STAGES = 4;'),
        ('static constexpr int BLOCKS = 4 / WGS;',
         'static constexpr int BLOCKS = 1;')),
    'draw_in_pass1': (PASS1,),
    'pass1_one_tile': (ONE_TILE,),
    'draw_in_pass1_one_tile': (PASS1, ONE_TILE),
    'wgs4': (('constexpr int WGS = 2;', 'constexpr int WGS = 4;'),),
    'wgs4_stages3': (
        ('constexpr int WGS = 2;', 'constexpr int WGS = 4;'),
        ('static constexpr int STAGES = 2;',
         'static constexpr int STAGES = 3;')),
    'loads_only': ((LIVE, 'const bool live = false;'),),
    'wgs4_loads_only': (('constexpr int WGS = 2;', 'constexpr int WGS = 4;'),
                        (LIVE, 'const bool live = false;')),
}


def build(variants, parent, out_dir):
    """Write and compile every variant, all nvcc processes at once;
    returns {name: ctypes function}."""
    from ppgs_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    text = (CSRC / SOURCE).read_text()
    jobs = {}
    for name, subs in variants.items():
        src, include = text, CSRC
        for old, new in subs:
            if old not in src:
                raise SystemExit(f'{name}: {old!r} is not in {SOURCE}')
            src = src.replace(old, new)
        jobs[name] = (src, include)
    if parent is not None:
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
    argtypes = kernels.SIGNATURES['ppgs_attention_train_fwd'][1]
    functions = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if ('fwd_kernel' in line or 'Used' in line or 'spill' in line
                    or 'warning' in line or 'error' in line):
                print(f'  {name}: {line.strip()}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed:\n{log}')
        fn = ctypes.CDLL(str(out_dir / f'{name}.so')).ppgs_attention_train_fwd
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        functions[name] = fn
    return functions


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='another checkout whose forward is timed too')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    args = parser.parse_args()
    names = args.variants.split(',')
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    if not torch.cuda.is_available():
        sys.exit('torch_attention_fwd_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    parent = Path(args.parent).resolve() if args.parent else None
    functions = build({name: VARIANTS[name] for name in names}, parent,
                      REPO / 'runs' / 'fwd_probe')

    dev = torch.device('cuda')
    B, T, H, D = cs.TRAIN_B, cs.TRAIN_T, 2, 128
    C = H * D
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 53)
    lengths = T - torch.randint(0, T // 2, (B,), generator=gen, device=dev)
    lengths[0], lengths[-1] = T, 0
    mask = torch.arange(T, device=dev)[None] < lengths[:, None]
    qkv = torch.randn(B, T, 3 * C, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    sl = fa.LOG2E / math.sqrt(D)
    rs = fa._train_fwd_args(q, k, v, mask, H)
    drops = {'on': dropout.Drop(cs.SEED + 17, dropout.site(0, 'probs'),
                                cs.DROPOUT)}
    drops['off'] = dropout.Drop(drops['on'].seed, drops['on'].site, 0.0)

    def outputs():
        return (torch.empty(B, T, C, dtype=torch.bfloat16, device=dev),
                torch.empty(B, T, C, device=dev),
                torch.empty(B, H, T, device=dev),
                torch.zeros(fa.keep_words_shape(B, H, T), dtype=torch.int32,
                            device=dev))

    outs = {key: outputs() for key in drops}

    def run(name, key):
        o16, o32, lse, keep = outs[key]
        drop = drops[key]
        stream = torch.cuda.current_stream().cuda_stream
        err = functions[name](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rs, mask.data_ptr(),
            o16.data_ptr(), o32.data_ptr(), C, lse.data_ptr(),
            keep.data_ptr() if drop.on else None, B, T, H, sl, 0,
            *drop.c_args(), stream)
        if err:
            raise RuntimeError(f'{name}: launch failed with error {err}')

    with torch.no_grad():
        want = {}
        for key in drops:
            run('this', key)
            torch.cuda.synchronize()
            want[key] = [t.clone() for t in outs[key]]
        for name in functions:
            if name == 'this' or name.endswith('loads_only'):
                continue
            for key in drops:
                outs[key][3].zero_()
                run(name, key)
                torch.cuda.synchronize()
                got = outs[key]
                if name == 'parent':
                    cs.check(f'parent o (fp32) {key}', got[1], want[key][1],
                             atol=2e-3, rtol=1e-2)
                    cs.check(f'parent lse {key}', got[2], want[key][2],
                             atol=1e-4)
                elif not all(torch.equal(a, b)
                             for a, b in zip(got, want[key])):
                    raise SystemExit(f'{name} differs from this checkout\'s '
                                     f'build with the dropout {key}')
        print('every variant but the loads-only ones equals this build bit '
              'for bit '
              '(the parent within its limits)', flush=True)

        heads = [t.view(B, T, H, D).transpose(1, 2) for t in (q, k, v)]
        sdpa_mask = mask[:, None, None, :]
        event = {f'{name} {key}': [] for name in functions for key in drops}
        event['sdpa dropout'] = []
        order = list(functions)
        for name in order + order[::-1]:
            for key in drops:
                event[f'{name} {key}'].append(cs.time_ms(
                    lambda: run(name, key), args.reps, 2))
        for _ in range(2):
            event['sdpa dropout'].append(cs.time_ms(
                lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=sdpa_mask, dropout_p=cs.DROPOUT),
                args.reps, 2))
        device = {f'{name} {key}': cs.kernel_device_ms(
            f'{name}, dropout {drops[key].rate}', lambda: run(name, key),
            card) for name in functions for key in drops}
    for label, times in event.items():
        print(f'{label}: event {times} ms, device {device.get(label)} ms '
              f'[{card}]', flush=True)
    print(json.dumps({'card': card, 'event_ms': event, 'device_ms': device}),
          flush=True)


if __name__ == '__main__':
    main()
