#!/usr/bin/env python3
"""Check and time the port's B8 rel-pos attention (rel_attention.cu) and
variants of it on one CUDA card.

    python3 scripts/torch_rel_attention_probe.py [--parent DIR]
        [--source FILE] [--reps N] [--variants this,loads_only,...]

Builds ``ppgs_tpu_torch/kernels/csrc/rel_attention.cu`` as it is and as the
variants below (``--variants``), each with nvcc into
``runs/rel_attention_probe/`` (gitignored), printing ptxas's registers,
spills and warnings: ``loads_only``, a walk that loads the resident tiles
and every stage of both passes and writes the output but computes nothing;
``stages5``, a ring of 5 stages, not 6; ``recompute_band``, every tile
forms its band's half A by a product of its own in place of taking the
last tile's half B. Timed but not checked, the kernel less one part of
its work: ``x_no_band`` (no band products), ``x_no_skew`` (the
band not added: no conversions, no shuffles), ``x_no_shfl`` (the skew's
shuffles left out, its selects and adds kept), ``x_one_skew`` (every warp
runs warp 0's skew code), ``x_no_exp`` (no ex2), ``x_no_s`` (no QK^T),
``x_no_pv`` (no PV, and so no pass-2 ex2 or packing), ``x_pass1_only``
(pass 2 loads and walks, computes nothing). With ``--parent``, DIR's
``rel_attention.cu`` is built and timed too (DIR: a checkout whose
ppgs_rel_attention takes the (B, H, T + 1, T) position term, as the wmma
kernel before this design; its term is formed once, outside the timing).
With ``--source``, FILE (another form of ``rel_attention.cu`` with this
entry point) is built, checked and timed as ``source``.

Each build, on seeded inputs (k and v views of one fused buffer as in the
bottleneck slice), against the plain version
(``flash_attention.rel_attention_reference``) at chip_smoke.py's limits
(``B8_ATOL``, ``B8_RTOL``): the slice's shape (64 x 800, q x 4 as the
slice's weights make it, ragged rows and a wholly masked one) and T = 1,
63, 64, 65, 129, 803 and 2048 (4 rows, ragged); beside the plain version,
the same function with the position term rounded to bf16 from fp64 sums,
which says whose rounding of the term a difference comes from. Then each
timed at the slice's shape (CUDA-event medians of ``--reps`` runs, in
turns: the builds in order, then reversed) beside the profiler's device
time per call, the bound, the plain version and the library route (the
term by cuBLAS, its shifted slice times the scale as SDPA's bf16 mask).

Prints the card's name and power limit, then one JSON line; exits 1 if a
check of a build failed. Imports nothing of JAX.
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
SOURCE = 'rel_attention.cu'
# name -> substitutions of this checkout's source
VARIANTS = {
    'this': (),
    'loads_only': (('constexpr bool LIVE = true;',
                    'constexpr bool LIVE = false;'),),
    'stages5': (('constexpr int STAGES = 6;', 'constexpr int STAGES = 5;'),),
    'recompute_band': (('formed == tt - 1', 'false'),),
    # Timed, not checked: the kernel less one part of its work
    'x_no_band': (
        ('      product<KS>(bd, tt <= td ? qv : qv1,\n'
         '                  stage_of(n + WGS - 1 - c) + ST_POS);\n', ''),
        ('    product<KS>(bd2, tt < td ? qv : qv1, stage_of(n + WGS - c) + '
         'ST_POS);\n', '')),
    'x_no_skew': (('    skew_add<0>(warp, sc, bd2, wa, skew);\n', ''),
                  ('    skew_add<1>(warp, sc, bd2, wa, skew);\n', '')),
    'x_no_exp': (('exp2_approx(fmaf(', '(fmaf('),),
    'x_no_shfl': (('        const uint32_t got = __shfl_sync(\n'
                   '            0xffffffffu, k.next[e] ? second : first, '
                   'k.src[e]);',
                   '        const uint32_t got = k.next[e] ? second : '
                   'first;'),),
    'x_one_skew': tuple((f'    {case}: skew_add<{w}, PART>',
                         f'    {case}: skew_add<0, PART>')
                        for case, w in (('case 1', 1), ('case 2', 2),
                                        ('default', 3))),
    'x_no_s': (('    product<KS>(sc, qu, stage_of(n + WGS) + ST_K);\n', ''),),
    'x_no_pv': (('        wgmma_rs<NO>(o, a[k],',
                 '        if (false) wgmma_rs<NO>(o, a[k],'),),
    'x_pass1_only': (('    wait_full(n + WGS);\n    if (wg_live && valid) {',
                      '    wait_full(n + WGS);\n    if (false) {'),),
}
CHECKED_T = (1, 63, 64, 65, 129, 803, 2048)
B, T, H, DK = 64, 800, 4, 36
LOG2E = 1.4426950408889634
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# The parent's entry point: ppgs_rel_attention(q, q_rs, k, v, kv_rs, bias,
# mask, out, out_rs, B, T, H, d, sm_scale, stream)
PARENT_SIG = (_P, _L, _P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _F, _P)


def build(names, parent, source, out_dir):
    """Write and compile every variant, the parent's source and ``source``,
    all nvcc processes at once; returns {name: ctypes library}."""
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
    if source:
        jobs['source'] = (source.read_text(), CSRC)
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


def operands(gen, dev, batch, length, peak, lengths=None):
    """q_u, k, v, q_v (batch, length, H, d_k), pos (length, H, d_k), mask:
    k and v views of one fused (batch, length, 3C) buffer, q_u and q_v
    scaled by ``peak``."""
    from ppgs_tpu_torch.ops import masking

    C = H * DK
    qkv = torch.randn(batch, length, 3 * C, generator=gen, device=dev)
    qkv[..., :C] *= peak
    qkv = qkv.to(torch.bfloat16)
    q_u = qkv[..., :C].contiguous().view(batch, length, H, DK)
    k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (H, DK))
            for i in (1, 2))
    q_v = (peak * torch.randn(batch, length, H, DK, generator=gen,
                              device=dev)).to(torch.bfloat16)
    pos = torch.randn(length, H, DK, generator=gen, device=dev).to(
        torch.bfloat16)
    if lengths is None:
        lengths = torch.full((batch,), length, device=dev)
    return q_u, k, v, q_v, pos, masking.mask_from_lengths(lengths, length)


def exact_term_reference(q_u, k, v, q_v, pos, mask):
    """The plain version with the position term's sums in fp64, rounded
    once to bf16: the correctly rounded term."""
    from ppgs_tpu_torch.ops import flash_attention as fa

    pos_z = F.pad(pos.transpose(0, 1)[None].double(), (0, 0, 1, 0))
    bd = q_v.transpose(1, 2).double() @ pos_z.transpose(-1, -2)
    Bx, _, Tx, _ = bd.shape
    bias = bd.to(torch.bfloat16).view(Bx, H, Tx + 1, Tx)
    return fa.fused_attention_bias_reference(q_u, k, v, bias, mask, H)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None,
                        help='a checkout whose bias-form rel_attention.cu is '
                             'timed too')
    parser.add_argument('--source', default=None,
                        help='another rel_attention.cu with this entry '
                             'point, checked and timed too')
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--variants', default=','.join(VARIANTS),
                        help='comma-separated subset of ' + ','.join(VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('torch_rel_attention_probe.py needs a CUDA device')
    names = [n for n in args.variants.split(',') if n]
    if 'this' not in names or not set(names) <= set(VARIANTS):
        sys.exit(f'--variants: a subset of {list(VARIANTS)} with "this"')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ppgs_tpu_torch import kernels
    from ppgs_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    parent = Path(args.parent).resolve() if args.parent else None
    source = Path(args.source).resolve() if args.source else None
    libs = build(names, parent, source, REPO / 'runs' / 'rel_attention_probe')
    if source:
        names.append('source')
    sig = kernels.SIGNATURES['ppgs_rel_attention'][1]
    fns = {n: bind(libs[n], 'ppgs_rel_attention', sig) for n in names}
    dev = torch.device('cuda')
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def run(name, q_u, k, v, q_v, pos, mask):
        Bx, Tx, Hx, dk = q_u.shape
        out = torch.empty(q_u.shape, dtype=q_u.dtype, device=dev)
        rs = [fa._tma_rows(x, 'x', tuple(x.shape), x.device)
              for x in (q_u, k, q_v, pos)]
        err = fns[name](q_u.data_ptr(), rs[0], k.data_ptr(), v.data_ptr(),
                        rs[1], q_v.data_ptr(), rs[2], pos.data_ptr(), rs[3],
                        mask.data_ptr(), out.data_ptr(), Hx * dk, Bx, Tx,
                        Hx, dk, LOG2E / math.sqrt(dk), stream())
        if err:
            raise RuntimeError(f'{name}: launch failed with error {err}')
        return out

    gen = torch.Generator(device=dev).manual_seed(16)
    failed = []
    results = {'card': card, 'checks': {}, 'times': {}}
    cases = [('slice 64 x 800, q x 4', operands(
        gen, dev, B, T, 4.0, torch.tensor(
            [T] + [T - 7 * i for i in range(1, B - 1)] + [0], device=dev)))]
    for Tx in CHECKED_T:
        lens = torch.tensor([Tx, max(Tx - 5, 1), min(37, Tx), 0], device=dev)
        cases.append((f'T={Tx}', operands(gen, dev, 4, Tx, 1.0, lens)))
    with torch.no_grad():
        for label, ops in cases:
            want = fa.rel_attention_reference(*ops, H)
            exact = exact_term_reference(*ops)
            for name in names:
                if name == 'loads_only' or name.startswith('x_'):
                    continue
                got = run(name, *ops)
                torch.cuda.synchronize()
                tag = f'{name} {label}'
                try:
                    err = cs.check(tag, got, want, cs.B8_ATOL, cs.B8_RTOL)
                except AssertionError as e:
                    print(f'{tag}: FAILED {e}', flush=True)
                    failed.append(tag)
                    err = (got.float() - want.float()).abs().max().item()
                exact_err = (got.float() - exact.float()).abs().max().item()
                off = (want.float() - exact.float()).abs().max().item()
                print(f'  {tag}: max |kernel - plain with the term from fp64 '
                      f'sums| {exact_err:.3g}; |plain - that| {off:.3g}; '
                      f'wholly masked row zero: '
                      f'{bool(got[-1].abs().max().item() == 0)}', flush=True)
                if got[-1].abs().max().item() != 0:
                    failed.append(f'{tag} masked row')
                results['checks'][tag] = [err, exact_err]

        # Times at the slice's shape, every key valid
        q_u, k, v, q_v, pos, mask = operands(gen, dev, B, T, 4.0)
        fns_timed = {n: (lambda n=n: run(n, q_u, k, v, q_v, pos, mask))
                     for n in names}
        if parent:
            pfn = bind(libs['parent'], 'ppgs_rel_attention', PARENT_SIG)
            bias = fa.position_term(q_v.transpose(1, 2),
                                    pos.transpose(0, 1)[None])
            pout = torch.empty_like(q_u)

            def parent_run():
                err = pfn(q_u.data_ptr(), H * DK, k.data_ptr(),
                          v.data_ptr(), 3 * H * DK, bias.data_ptr(),
                          mask.data_ptr(), pout.data_ptr(), H * DK, B, T, H,
                          DK, 1.0 / math.sqrt(DK), stream())
                if err:
                    raise RuntimeError(f'parent: launch failed ({err})')
            parent_run()
            torch.cuda.synchronize()
            want = fa.fused_attention_bias_reference(q_u, k, v, bias, mask, H)
            print(f'parent (its term given): max |kernel - plain| '
                  f'{(pout.float() - want.float()).abs().max().item():.3g}',
                  flush=True)
            fns_timed['parent'] = parent_run
        scale = 1.0 / math.sqrt(DK)
        q4, k4, v4, qv4 = (t.transpose(1, 2) for t in (q_u, k, v, q_v))
        pos_z = F.pad(pos.transpose(0, 1)[None], (0, 0, 1, 0))

        def library_route():
            bd = (qv4 @ pos_z.transpose(-1, -2)).view(B, H, T + 1, T)
            shifted = (bd[:, :, 1:].float() * scale).to(torch.bfloat16)
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=shifted,
                                                  scale=scale)
        fns_timed['library route'] = library_route
        order = list(fns_timed)
        events = {n: [] for n in order}
        for turn in (order, order[::-1]):
            for n in turn:
                events[n].append(cs.time_ms(fns_timed[n], args.reps))
        bound_ms, bound_by = cs.bound(
            6 * B * H * T * T * DK,
            5 * B * T * H * DK * 2 + T * H * DK * 2 + B * T)
        plain_ms = cs.time_ms(
            lambda: fa.rel_attention_reference(q_u, k, v, q_v, pos, mask, H),
            3, 1)
        print(f'bound {bound_ms:.4f} ms ({bound_by}); plain {plain_ms:.4f} '
              f'ms [{card}]', flush=True)
        for n in order:
            dev_ms = cs.kernel_device_ms(f'{n} {B} x {T}', fns_timed[n], card)
            print(f'{n}: events {events[n][0]:.4f} / {events[n][1]:.4f} ms, '
                  f'device {dev_ms if dev_ms is None else round(dev_ms, 4)} '
                  f'ms [{card}]', flush=True)
            results['times'][n] = {'events_ms': events[n], 'device_ms': dev_ms}
        results.update(bound_ms=bound_ms, bound_by=bound_by,
                       plain_ms=plain_ms)

    print(json.dumps(results))
    if failed:
        sys.exit(f'checks failed: {failed}')


if __name__ == '__main__':
    main()
