#!/usr/bin/env python3
"""Time the port's layer kernels K1, K3 and K4, the train kernels and the
attention kernels at the registered widths on one CUDA card, beside
another checkout's.

    python3 scripts/torch_layer_width_probe.py [--root DIR] [--reps N]
        [--variants ...] [--only PREFIXES]

Builds this checkout's kernels and, with ``--root``, the ``qkv_proj.cu``,
``out_proj_ln.cu``, ``ffn_ln.cu``, ``ffn_train.cu`` and ``layer_train.cu``
of another checkout with the same entry points (e.g. ``git archive
<commit> ppgs_tpu_torch`` unpacked under
``runs/``; nvcc into ``runs/layer_width_probe/``, gitignored, ptxas's
registers and spills printed), and runs both through this checkout's
wrappers at chip_smoke.py's main-path shapes of the registered widths: K1
at mel (64,000 x 256), the w2v2fb head (64,000 x 512), the wav2vec2-base
trunk (25,600 x 768) and the training shape (131,072 x 256); K3 at the
first three; K4 at mel (ReLU, F = 2048), the head (ReLU, F = 2048), the
trunk (GELU, F = 3072) and C = 768 with ReLU (64,000 rows, F = 2048); and
the train forms at C = 256, 512 and 768 on the training shape (131,072
rows, F = 2048, dropout 0.1): K3's, K4's LayerNorm and y_out forms,
ffn_train_bwd (fp32 x) and ln_dropout_bwd; K2 at mel (128 x 500, 2 heads
of 128), the head (2 heads of 256) and the trunk (64 x 400, 12 heads of
64), and attention_train_fwd (fp32 o too), row_dot and
attention_train_bwd (bf16 and fp32) at d_head 128 and 256 on the training
shape (256 x 512, ragged windows, dropout 0.1); the wide routes at 2
heads of 512 and of 1024: K2 at 128 x 500, attention_train_fwd on the
training shape. It prints whether the root's outputs (every output of a
train form) equal this checkout's bit for bit, or, on the wide routes,
whose S the root may sum in another order, how far they differ (each
output's largest difference and the share of its elements that differ;
the keep words must still be equal), then times both in turns (this,
root, root, this): CUDA-event medians of ``--reps`` runs and the
profiler's device time per call by kernel. Prints the card's name and
power limit, then one JSON line. ``--variants`` builds text-substituted
copies of this checkout's sources beside it and times their kernel
through them too: K4's output launch with only its 256-column epilogue
compiled (``wide_only``), and that with every W2 box loaded
(``wide_only_all_boxes``); K1's walk over the depth unrolled by 2 or 4
(``k1_unroll2``, ``k1_unroll4``); the wide routes of K2 and of the train
forward walking their items only (``k2_loads_only``, ``fwd_loads_only``)
and those with the cluster sum of zero partials too
(``k2_exchange_only``, ``fwd_exchange_only``), on the wide cases only.
``--only`` keeps the cases whose label starts with one of its
comma-separated prefixes (e.g. ``K2,attn_row_dot``), so that a call
checks one kernel against the root in a minute or two. Imports nothing of
JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SYMBOLS = ('ppgs_qkv_proj', 'ppgs_out_proj_ln', 'ppgs_ffn_ln',
           'ppgs_ffn_train_bwd', 'ppgs_ln_dropout_bwd', 'ppgs_attention',
           'ppgs_attention_train_fwd', 'ppgs_row_dot',
           'ppgs_attention_train_bwd')
# (label, rows, C) of K1 and K3; (label, rows, C, activation, F) of K4
K1_CASES = (('mel', 64_000, 256), ('head', 64_000, 512),
            ('trunk', 25_600, 768), ('train', 131_072, 256))
K3_CASES = K1_CASES[:3]
# Text substitutions of this checkout's sources: name -> (C entry point,
# substitutions, the label prefix of the cases they run on or '' for all)
WIDE_ONLY = ('    if (TILES == WIDE || ln_groups(C, n0) == OUT_BN / 8)\n'
             '      residual_ln(',
             '    if (true)\n      residual_ln(')
K1_LOOP = '\n  for (int k = 0; k < plan.steps; ++k) {'   # the consumers'
VARIANTS = {
    'wide_only': ('ppgs_ffn_ln', (WIDE_ONLY,), ''),
    'wide_only_all_boxes': ('ppgs_ffn_ln', (WIDE_ONLY, (
        '                             n0, ln_groups(C, n0) / 8);',
        '                             n0);')), ''),
    'k1_unroll2': ('ppgs_qkv_proj',
                   ((K1_LOOP, '\n#pragma unroll 2' + K1_LOOP),), ''),
    'k1_unroll4': ('ppgs_qkv_proj',
                   ((K1_LOOP, '\n#pragma unroll 4' + K1_LOOP),), ''),
}
# The wide routes' walks, which compute nothing to compare, as
# substitutions of the call sites in the kernels' tile loops: loads_only
# waits for and releases the items (no product, no cluster sum, no
# softmax, no keep bits, no P V: scores_resident's `live` false skips the
# products); exchange_only adds the cluster sum of zero partials (pass 2's
# pd at the owners too), its sums read into l0 so that none is dropped
def off(text):
    return text.replace('live', 'false')


SCORES = 'wide::scores_resident(sc, q_addr, kring, i, NA, live, lane, load_k);'
SCORES2 = ('wide::scores_resident(sc, q_addr, kring, tiles + i, NA, live, '
           'lane,\n                          load_k);')
ZERO = '\n    zero(sc);'
PUT, GET = '    ex.put(sc, i, live);\n', '    ex.get(sc, i, live);\n'
PACKED = '    ex.put(sc, tiles + i, live);\n    ex.get_packed('
SOFTMAX = '    if (live) {\n      float corr0, corr1;'
PENDING = '    pending = live;'
DRAW = '    if (DROP && live)\n      draw_keep'
ROW_STATS = '    if (live)\n      row_stats('
PV = '    vring.wait(i);\n    if (live) {'
SUM_SC = '    if (live)\n      for (int e = 0; e < BKV / 2; ++e) l0 += sc[e];\n'
SUM_PD = ('    if (live)\n      for (int k = 0; k < BKV / 16; ++k) '
          'l0 += __uint_as_float(a[k][0]);\n')
WALKS = {
    'k2_loads_only': ('ppgs_attention', (
        (SCORES, off(SCORES)), (PUT, ''), (GET, ''),
        (SOFTMAX, off(SOFTMAX)), (PENDING, off(PENDING))), 'K2 wide'),
    'k2_exchange_only': ('ppgs_attention', (
        (SCORES, off(SCORES) + ZERO), (SOFTMAX, SUM_SC + off(SOFTMAX)),
        (PENDING, off(PENDING))), 'K2 wide'),
    'fwd_loads_only': ('ppgs_attention_train_fwd', (
        (SCORES, off(SCORES)), (SCORES2, off(SCORES2)), (PUT, ''),
        (GET, ''), (PACKED, '    if (false) ex.get_packed('),
        (DRAW, off(DRAW)), (ROW_STATS, off(ROW_STATS)), (PV, off(PV))),
        'attn_train_fwd wide'),
    'fwd_exchange_only': ('ppgs_attention_train_fwd', (
        (SCORES, off(SCORES) + ZERO), (SCORES2, off(SCORES2) + ZERO),
        (DRAW, off(DRAW)), (ROW_STATS, SUM_SC + off(ROW_STATS)),
        (PV, SUM_PD + off(PV))), 'attn_train_fwd wide'),
}
VARIANTS.update(WALKS)
K4_CASES = (('mel', 64_000, 256, 'relu', 2048),
            ('head', 64_000, 512, 'relu', 2048),
            ('trunk', 25_600, 768, 'gelu', 3072),
            ('c768', 64_000, 768, 'relu', 2048))
# The train forms: the registered widths at the training shape
TRAIN_C, TRAIN_M, TRAIN_F, TRAIN_RATE = (256, 512, 768), 131_072, 2048, 0.1
# (label, windows, T, heads, d_head) of K2; the train attention's d_head at
# the training shape (256 windows of 512 frames)
K2_CASES = (('mel', 128, 500, 2, 128), ('head', 128, 500, 2, 256),
            ('trunk', 64, 400, 12, 64), ('wide512', 128, 500, 2, 512),
            ('wide1024', 128, 500, 2, 1024))
# Cases whose S the root may sum in another order: compared by difference
SUM_ORDER = ('K2 wide', 'attn_train_fwd wide')
ATTN_TRAIN_D, ATTN_B, ATTN_T = (128, 256), 256, 512
# The train forward's wide route on the training shape: 2 heads of these
ATTN_WIDE_D = (512, 1024)


def build(jobs, out_dir):
    """nvcc each {(build, symbol): (source text, include dir)}, all at
    once; {build: {symbol: C function}}."""
    from ppgs_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (name, symbol), (text, include) in jobs.items():
        cu = out_dir / f'{name}_{symbol}.cu'
        cu.write_text(text)
        so = cu.with_suffix('.so')
        procs[name, symbol] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, '-I', str(include), '-o',
             str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    functions = {}
    for (name, symbol), (so, proc) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if 'Function properties for' in line:
                print(f'  {so.stem}: {line.split(" for ", 1)[1][:96]}')
            elif 'Used' in line or 'spill' in line or 'error' in line:
                print(f'  {so.stem}: {line.strip()[:160]}', flush=True)
        if proc.returncode:
            raise SystemExit(f'{so.stem}: nvcc failed:\n{log}')
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = kernels.SIGNATURES[symbol][1]
        fn.restype = ctypes.c_int
        functions.setdefault(name, {})[symbol] = fn
    return functions


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--root', default=None,
                        help='a checkout whose K1, K3 and K4 are checked and '
                        'timed beside this one\'s')
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--variants', default='',
                        help='comma-separated subset of ' + ','.join(VARIANTS)
                        + ', timed too')
    parser.add_argument('--only', default='',
                        help='comma-separated label prefixes of the cases '
                        'kept (all by default)')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('torch_layer_width_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch import kernels
    from ppgs_tpu_torch.ops import backward, dropout
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import encoder_layer_train as elt
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    card = cs.card_line()
    print(card, flush=True)
    kernels.build_all()
    builds = {'this': {s: kernels.function(s) for s in SYMBOLS}}
    jobs = {}
    for name in filter(None, args.variants.split(',')):
        symbol, subs, _ = VARIANTS[name]
        src = kernels.SIGNATURES[symbol][0]
        text = (kernels.CSRC / src).read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f'{name}: {old!r} is not in {src} once')
            text = text.replace(old, new)
        jobs[name, symbol] = (text, kernels.CSRC)
    if args.root:
        csrc = Path(args.root).resolve() / 'ppgs_tpu_torch' / 'kernels'
        for symbol in SYMBOLS:
            src = csrc / 'csrc' / kernels.SIGNATURES[symbol][0]
            jobs['root', symbol] = (src.read_text(), csrc / 'csrc')
    builds.update(build(jobs, REPO / 'runs' / 'layer_width_probe'))
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 59)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device=dev)

    cases = []
    for label, M, C in K1_CASES:
        args_k1 = (rnd(M, C), rnd(C, 3 * C, scale=C ** -0.5).to(bf16),
                   rnd(3 * C, scale=0.1))
        cases.append((f'K1 {label} {M} x {C}', 'ppgs_qkv_proj',
                      lambda a=args_k1: elk.qkv_proj(*a)))
    for label, M, C in K3_CASES:
        args_k3 = (rnd(M, C, scale=0.5).to(bf16),
                   rnd(C, C, scale=C ** -0.5).to(bf16), rnd(C, scale=0.1),
                   rnd(M, C), rnd(C, scale=0.1, base=1.0), rnd(C, scale=0.1))
        cases.append((f'K3 {label} {M} x {C}', 'ppgs_out_proj_ln',
                      lambda a=args_k3: elk.out_proj_residual_ln(*a)))
    for label, M, C, act, Fh in K4_CASES:
        args_k4 = (rnd(M, C), rnd(C, Fh, scale=C ** -0.5).to(bf16),
                   rnd(Fh, scale=0.1), rnd(Fh, C, scale=Fh ** -0.5).to(bf16),
                   rnd(C, scale=0.1), rnd(C, scale=0.1, base=1.0),
                   rnd(C, scale=0.1))
        cases.append((f'K4 {label} {M} x {C} {act} F={Fh}', 'ppgs_ffn_ln',
                      lambda a=args_k4, act=act: fused_ffn.ffn_residual_ln(
                          *a, activation=act)))
    M, Fh = TRAIN_M, TRAIN_F
    drop = dropout.Drop(cs.SEED + 37, 3, TRAIN_RATE)
    for C in TRAIN_C:
        k3 = (rnd(M, C, scale=0.5).to(bf16),
              rnd(C, C, scale=C ** -0.5).to(bf16), rnd(C, scale=0.1),
              rnd(M, C), rnd(C, scale=0.1, base=1.0), rnd(C, scale=0.1),
              drop.at(5))
        cases.append((f'K3 train {M} x {C}', 'ppgs_out_proj_ln',
                      lambda a=k3: elt.out_proj_ln_train(*a)))
        x, w1, b1 = (rnd(M, C), rnd(C, Fh, scale=C ** -0.5).to(bf16),
                     rnd(Fh, scale=0.1))
        w2, b2 = rnd(Fh, C, scale=Fh ** -0.5).to(bf16), rnd(C, scale=0.1)
        ln = (rnd(C, scale=0.1, base=1.0), rnd(C, scale=0.1))
        b4 = (x, w1, b1, w2, b2, drop, drop.at(4), ln)
        cases.append((f'K4 train B4 {M} x {C} F={Fh}', 'ppgs_ffn_ln',
                      lambda a=b4: fused_ffn.ffn_train_fwd(*a)))
        b6 = (x.to(bf16), w1, b1, w2, b2, drop, drop.at(4))
        cases.append((f'K4 train y_out {M} x {C} F={Fh}', 'ppgs_ffn_ln',
                      lambda a=b6: fused_ffn.ffn_train_fwd(*a)))
        keep = fused_ffn.keep_words_reference(drop, M, Fh, dev)
        bwd = (x, rnd(M, C).to(bf16), w1, b1, w2, drop, keep, rnd(M, C))
        cases.append((f'ffn_train_bwd {M} x {C} F={Fh}',
                      'ppgs_ffn_train_bwd',
                      lambda a=bwd: fused_ffn.ffn_train_bwd(*a)))
        lnb = (rnd(M, C), rnd(M, C), torch.rand(M, generator=gen,
                                                device=dev) + 0.5,
               ln[0], drop.at(6), bf16)
        cases.append((f'ln_dropout_bwd {M} x {C}', 'ppgs_ln_dropout_bwd',
                      lambda a=lnb: backward.ln_dropout_bwd(*a)))
    for label, Bw, Tw, H, D in K2_CASES:
        C = H * D
        qkv = rnd(Bw, Tw, 3 * C).to(bf16)
        mask = torch.ones(Bw, Tw, dtype=torch.bool, device=dev)
        mask[1::2, Tw - 50:] = False
        k2 = (qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], mask, H,
              1.0)
        cases.append((f'K2 {label} {Bw} x {Tw} {H} x {D}', 'ppgs_attention',
                      lambda a=k2: fa.attention(*a)))
    lengths = ATTN_T - torch.randint(0, ATTN_T // 2, (ATTN_B,),
                                     generator=gen, device=dev)
    lengths[0], lengths[-1] = ATTN_T, 0
    mask = torch.arange(ATTN_T, device=dev)[None] < lengths[:, None]
    for D in ATTN_TRAIN_D:
        H, C = 2, 2 * D
        qkv = rnd(ATTN_B, ATTN_T, 3 * C).to(bf16)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        do = rnd(ATTN_B, ATTN_T, C).to(bf16)
        sl, sm = fa.LOG2E / D ** 0.5, D ** -0.5
        fwd = (q, k, v, mask, H, sl, False, drop.at(1))
        cases.append((f'attn_train_fwd {ATTN_B} x {ATTN_T} 2 x {D}',
                      'ppgs_attention_train_fwd',
                      lambda a=fwd: fa.attention_train_fwd(*a,
                                                           want_f32=True)))
        _, o32, lse, keep = fa.attention_train_fwd(*fwd, want_f32=True)
        do32 = do.float()
        cases.append((f'attn_row_dot {ATTN_B} x {ATTN_T} 2 x {D}',
                      'ppgs_row_dot',
                      lambda a=(do32, o32, H): fa.row_dot(*a)))
        bwd = (q, k, v, mask, lse, keep, do, fa.row_dot(do32, o32, H), H,
               sl, sm, False, drop.at(1))
        cases.append((f'attn_train_bwd {ATTN_B} x {ATTN_T} 2 x {D}',
                      'ppgs_attention_train_bwd',
                      lambda a=bwd: fa.attention_train_bwd(*a,
                                                           want32=True)))
    for D in ATTN_WIDE_D:
        H, C = 2, 2 * D
        qkv = rnd(ATTN_B, ATTN_T, 3 * C).to(bf16)
        fwd = (qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], mask, H,
               fa.LOG2E / D ** 0.5, False, drop.at(1))
        cases.append((f'attn_train_fwd wide{D} {ATTN_B} x {ATTN_T} 2 x {D}',
                      'ppgs_attention_train_fwd',
                      lambda a=fwd: fa.attention_train_fwd(*a,
                                                           want_f32=True)))
    if args.only:
        prefixes = tuple(args.only.split(','))
        cases = [case for case in cases if case[0].startswith(prefixes)]

    def same(a, b):
        """Every output equal bit for bit (a train form's tuple too)."""
        if isinstance(a, tuple):
            return all(x is y or (x is not None and y is not None
                                  and torch.equal(x, y))
                       for x, y in zip(a, b))
        return torch.equal(a, b)

    def difference(a, b):
        """Each floating output's largest difference and the share of its
        elements that differ; the integer ones (keep words) equal or not."""
        out = []
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if x is None or y is None:
                continue
            if not x.is_floating_point():
                out.append({'equal': torch.equal(x, y)})
                continue
            x, y = x.float(), y.float()
            out.append({'max_abs': (x - y).abs().max().item(),
                        'share': (x != y).double().mean().item()})
        return out

    result = {'card': card, 'equal': {}, 'event_ms': {}, 'device_ms': {}}
    with torch.no_grad():
        for label, symbol, fn in cases:
            # this, the variants of its source, root
            order = [name for name in builds if symbol in builds[name]
                     and label.startswith(VARIANTS[name][2]
                                          if name in VARIANTS else '')]

            def run(name):
                kernels._functions[symbol] = builds[name][symbol]
                return fn()

            for name in order[1:]:
                if name in WALKS:
                    continue
                got, want = run(name), run('this')
                if label.startswith(SUM_ORDER):
                    diff = difference(got, want)
                    result['equal'][f'{label} {name}'] = diff
                    print(f'{label}: {name}\'s outputs against this '
                          f'build\'s: {diff}', flush=True)
                    continue
                equal = same(got, want)
                result['equal'][f'{label} {name}'] = equal
                print(f'{label}: {name}\'s output equals this build\'s bit '
                      f'for bit: {equal}', flush=True)
            for name in order + order[::-1]:
                result['event_ms'].setdefault(f'{label} {name}', []).append(
                    cs.time_ms(lambda: run(name), args.reps, 2))
            for name in order:
                result['device_ms'][f'{label} {name}'] = cs.kernel_device_ms(
                    f'{label} {name}', lambda: run(name), card)
            kernels._functions[symbol] = builds['this'][symbol]
            for name in order:
                key = f'{label} {name}'
                print(f'{key}: event {result["event_ms"][key]} ms, device '
                      f'{result["device_ms"][key]} ms [{card}]', flush=True)
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
