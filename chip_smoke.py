#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``ppgs_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

The phases run in order; each raises on failure and nothing is caught, so
any failure exits non-zero before the result line:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ppgs_tpu_torch/kernels/csrc with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (128 windows x 500 frames of the mel model: C = 256,
   2 heads of 128, FFN 2048), plus the attention kernel at T = 1536 with
   and without the causal mask and a wholly masked window, the per-layer
   FFN variant, and the whole 5-layer stack;
4. the main path, ``from_audio`` on 64 utterances x 8 s of seeded random
   audio with seeded random weights: shape, softmax columns, every kernel
   launched, and the first rows against ``from_audio(..., device='cpu')``;
   then ``legacy_mode`` on a 12 s utterance (T = 1200 > 1024), which takes
   the per-layer path through the attention and FFN kernels;
5. times with CUDA events (warm-up, then the median of 20 runs) of each
   kernel, its plain version and a PyTorch library call computing the same
   function (``nn.TransformerEncoder`` for the whole stack), beside the
   kernel's bound; end-to-end audio-seconds per second of ``from_audio``;
   and the device time by kernel of one ``from_audio`` call
   (torch.profiler) with the card's idle share.

Before the last line it prints one JSON object with a record per kernel;
the last line is {"ok": true, "device": {...}}. Imports nothing of JAX or
of the JAX package.
"""

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH, SECONDS = 64, 8           # main path: 64 utterances x 8 s
LEGACY_SECONDS = 12              # one utterance past the 1024-frame stack
LONG_T = 1536                    # the attention kernel's long-input check
REPS = 20

# Published peaks of an H100 SXM (dense bf16, HBM3), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def phase(name):
    print(f'== {name}', flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn):
    """Median milliseconds of ``fn`` on the card over REPS runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops, nbytes):
    """(least milliseconds, what bounds it) on an H100 for the work."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops > t_bytes else 'bytes')


def check(name, got, want, atol, rtol=0.0, rows=None):
    """Raise unless |got - want| <= atol + rtol |want| everywhere (on
    ``rows`` when given); return the max |got - want|. The mean |want| is
    printed beside it, so that the limit can be read against the size of
    what it bounds."""
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: non-finite values')
    err = (got - want).abs()
    worst = err.max().item()
    typical = want.abs().mean().item()
    if (err > atol + rtol * want.abs()).any():
        raise AssertionError(
            f'{name}: max |kernel - plain| {worst:.3g} exceeds atol {atol} '
            f'rtol {rtol} (mean |plain| {typical:.3g})')
    print(f'{name}: max |kernel - plain| = {worst:.3g} '
          f'(atol {atol}, rtol {rtol}; mean |plain| {typical:.3g})',
          flush=True)
    return worst


def random_params(port, config, seed):
    """Seeded weights in the JAX package's layout: the model's init, with
    biases and LayerNorm parameters drawn at random too, so that every term
    of the kernels is exercised."""
    gen = torch.Generator().manual_seed(seed)
    params = port.models.transformer.init(config, gen)

    def jitter(tree, path=''):
        for key, value in list(tree.items()):
            if isinstance(value, dict):
                jitter(value, key)
            elif key.startswith('b') or (path.startswith('norm')):
                noise = torch.randn(value.shape, generator=gen).numpy()
                base = 1.0 if key == 'scale' else 0.0
                tree[key] = (base + 0.1 * noise).astype(np.float32)

    for layer in params['layers']:
        jitter(layer)
    return params


def library_encoder(model, config, dev):
    """``torch.nn.TransformerEncoder`` in bf16 with the model's weights:
    post-LN, ReLU, batch-first, every row computed (no nested tensors). It
    is one PyTorch call for the encoder stack's function, timed as its
    yardstick; the port never calls it."""
    C, H = config.hidden_channels, config.attention_heads
    layer = torch.nn.TransformerEncoderLayer(
        C, H, config.ffn_channels, dropout=0.0, batch_first=True,
        norm_first=False)
    encoder = torch.nn.TransformerEncoder(
        layer, config.num_hidden_layers, enable_nested_tensor=False).to(dev)
    with torch.no_grad():
        for dst, src in zip(encoder.layers, model.layers):
            pairs = (
                (dst.self_attn.in_proj_weight, src.attn.wqkv.T),
                (dst.self_attn.in_proj_bias, src.attn.bqkv),
                (dst.self_attn.out_proj.weight, src.attn.wo.T),
                (dst.self_attn.out_proj.bias, src.attn.bo),
                (dst.linear1.weight, src.ffn.w1.T),
                (dst.linear1.bias, src.ffn.b1),
                (dst.linear2.weight, src.ffn.w2.T),
                (dst.linear2.bias, src.ffn.b2),
                (dst.norm1.weight, src.norm1.scale),
                (dst.norm1.bias, src.norm1.bias),
                (dst.norm2.weight, src.norm2.scale),
                (dst.norm2.bias, src.norm2.bias))
            for param, value in pairs:
                param.copy_(value)
    return encoder.to(torch.bfloat16).eval().requires_grad_(False)


def profile_from_audio(port, audio, checkpoint, card):
    """Device time by kernel in one from_audio call (torch.profiler), and
    the share of the call's wall time in which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        port.from_audio(audio, checkpoint=checkpoint)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print('device time by kernel: not measured (the profiler saw no '
              'device activity)')
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(by_name.values())
    print(f'profiled from_audio: wall {wall_ms:.3f} ms, kernels {busy:.3f} ms '
          f'({len(kernels)} launches), idle share '
          f'{max(0.0, 1 - busy / wall_ms):.3f} [{card}]')
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f'  {ms:9.3f} ms  {name[:90]}')


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py needs a CUDA device; none is available')
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import ppgs_tpu_torch as port
    from ppgs_tpu_torch import kernels
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    dev = torch.device('cuda')
    # Plain fp32 products and convs in full fp32 (cuDNN runs fp32 convs in
    # TF32 by default); the entry points set the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase('1 card')
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    phase('2 build')
    seconds = kernels.build_all()
    print(f'built {len(kernels.SOURCES)} kernel sources with nvcc (sm_90a) '
          f'in {seconds:.1f} s into {kernels.build_dir()}', flush=True)
    for src, log in sorted(kernels.build_log.items()):
        for line in log.splitlines():
            if 'Used' in line or 'spill' in line:
                print(f'  {src}: {line.strip()}')

    config = port.config.get()            # the mel model, bf16 compute
    C, H = config.hidden_channels, config.attention_heads
    Fh, L = config.ffn_channels, config.num_hidden_layers
    frames = port.ops.stft.frame_count(
        SECONDS * config.sample_rate, config.num_fft, config.hopsize)
    stride, n_blocks = port.models.transformer.chunk_layout(
        frames, config.chunk_length, config.chunk_overlap)
    W, T = BATCH * n_blocks, config.chunk_length    # 128 windows x 500
    M = W * T

    workdir = tempfile.TemporaryDirectory()
    checkpoint = Path(workdir.name) / 'random-mel.npz'
    port.load.save_params(checkpoint, random_params(port, config, SEED))
    model, _ = port.load.model(checkpoint=checkpoint, config=config,
                               device=dev)
    # Layer 0's weights as encoder_stack hands them to the kernels: the
    # prepared ones of convert.prepare and the fp32 parameter vectors
    layer0 = model.layers[0]
    p0 = layer0.prepared
    w = {'wqkv': p0.wqkv_folded, 'bqkv': p0.bqkv_folded, 'wo': p0.wo,
         'bo': layer0.attn.bo, 'g1': layer0.norm1.scale,
         'be1': layer0.norm1.bias, 'w1': p0.w1, 'b1': layer0.ffn.b1,
         'w2': p0.w2, 'b2': layer0.ffn.b2, 'g2': layer0.norm2.scale,
         'be2': layer0.norm2.bias}

    phase(f'3 kernels against their plain versions ({W} windows x T={T})')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(W, T, C, generator=gen, device=dev)
    # The main path's window lengths: 500 and 450 valid frames
    win_len = torch.tensor([min(T, frames + config.chunk_overlap - i * stride)
                            for i in range(n_blocks)], device=dev)
    lengths = win_len.repeat(BATCH)
    mask = port.ops.masking.mask_from_lengths(lengths, T)
    qkv = elk.qkv_proj(x, w['wqkv'], w['bqkv'])
    err = {'qkv_proj': check('K1 qkv_proj', qkv, elk.qkv_proj_reference(
        x, w['wqkv'], w['bqkv']), atol=1e-2, rtol=1e-2)}
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    a = fa.attention(q, k, v, mask, H, 1.0)
    # K2's limit: about 1.3x the worst error seen on these seeded inputs,
    # a tenth of the typical output, so that a dropped key tile or a wrong
    # rescale cannot pass
    err['attention'] = check('K2 attention', a, fa.attention_reference(
        q, k, v, mask, H, 1.0), atol=5e-3)
    r = elk.out_proj_residual_ln(a, w['wo'], w['bo'], x, w['g1'], w['be1'])
    err['out_proj_residual_ln'] = check(
        'K3 out_proj_residual_ln', r, elk.out_proj_residual_ln_reference(
            a, w['wo'], w['bo'], x, w['g1'], w['be1']), atol=1e-3)
    ffn_args = (w['w1'], w['b1'], w['w2'], w['b2'], w['g2'], w['be2'])
    y = fused_ffn.ffn_residual_ln(r, *ffn_args)
    err['ffn_residual_ln'] = check(
        'K4 ffn_residual_ln', y,
        fused_ffn.ffn_residual_ln_reference(r, *ffn_args), atol=1e-2)
    check('K4 ffn_residual_ln (round_input, per-layer path)',
          fused_ffn.ffn_residual_layernorm(r[:3], *ffn_args),
          fused_ffn.ffn_residual_layernorm_reference(r[:3], *ffn_args),
          atol=1e-2)

    # The long-input attention: 4 windows of T = 1536, ragged lengths and
    # one wholly masked window, with and without the causal mask
    long_len = torch.tensor([LONG_T, 1000, 37, 0], device=dev)
    long_mask = port.ops.masking.mask_from_lengths(long_len, LONG_T)
    lq, lk, lv = (torch.randn(4, LONG_T, C, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    for causal in (False, True):
        out = fa.flash_attention(lq, lk, lv, long_mask, H, causal=causal)
        check(f'K2 attention T={LONG_T} causal={causal}', out,
              fa.flash_attention_reference(lq, lk, lv, long_mask, H,
                                           causal=causal),
              atol=5e-3)
        if not torch.equal(out[3], torch.zeros_like(out[3])):
            raise AssertionError('a wholly masked window did not give 0')
    print('K2: the wholly masked window gives exactly 0', flush=True)

    stack_mask = mask.clone()
    stack_mask[-1] = False                        # one wholly masked window
    got = elk.encoder_stack(x, stack_mask, model.layers, H)
    want = elk.encoder_stack_reference(x, stack_mask, model.layers, H)
    check(f'encoder_stack ({L} layers)', got, want, atol=8e-2,
          rows=stack_mask)
    if not torch.isfinite(got).all():
        raise AssertionError('encoder_stack: non-finite values')
    del got, want

    phase(f'4 from_audio: {BATCH} x {SECONDS} s (main path)')
    samples = SECONDS * config.sample_rate
    audio = 0.1 * torch.randn(BATCH, 1, samples, generator=gen, device=dev)
    counters = {'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
                'out_proj_residual_ln': elk.out_proj_residual_ln,
                'ffn_residual_ln': fused_ffn.ffn_residual_ln}
    for fn in counters.values():
        fn.launches = 0
    ppg = port.from_audio(audio, checkpoint=checkpoint)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f'launches in one from_audio call: {launches}', flush=True)
    if min(launches.values()) == 0:
        raise AssertionError(f'a kernel of the main path never launched: '
                             f'{launches}')
    if tuple(ppg.shape) != (BATCH, config.output_channels, frames):
        raise AssertionError(f'from_audio shape {tuple(ppg.shape)}')
    if ppg.device.type != 'cuda' or not torch.isfinite(ppg).all():
        raise AssertionError('from_audio: not finite or not on the card')
    col_err = (ppg.sum(dim=1) - 1).abs().max().item()
    if col_err > 1e-4:
        raise AssertionError(f'PPG columns do not sum to 1 ({col_err})')

    def agree(name, got, want):
        diff = (got.float().cpu() - want).abs().max().item()
        same = (got.cpu().argmax(1) == want.argmax(1)).float().mean().item()
        print(f'{name}: max |card - cpu| = {diff:.3g} (atol 2e-2), argmax '
              f'agreement {same:.4f} (>= 0.995)', flush=True)
        if diff > 2e-2 or same < 0.995:
            raise AssertionError(f'{name}: the card disagrees with the cpu')

    agree('from_audio rows 0-3 against device=cpu', ppg[:4],
          port.from_audio(audio[:4].cpu(), checkpoint=checkpoint,
                          device='cpu'))

    phase(f'4b from_audio legacy_mode: 1 x {LEGACY_SECONDS} s (T > 1024)')
    long_audio = 0.1 * torch.randn(1, 1, LEGACY_SECONDS * config.sample_rate,
                                   generator=gen, device=dev)
    for fn in counters.values():
        fn.launches = 0
    legacy = port.from_audio(long_audio, checkpoint=checkpoint,
                             legacy_mode=True)
    torch.cuda.synchronize()
    legacy_launches = {name: fn.launches for name, fn in counters.items()}
    print(f'launches in one legacy_mode call: {legacy_launches}', flush=True)
    if not (legacy_launches['attention'] and
            legacy_launches['ffn_residual_ln']):
        raise AssertionError('legacy_mode did not run the K2 and K4 kernels')
    agree('from_audio legacy_mode against device=cpu', legacy,
          port.from_audio(long_audio.cpu(), checkpoint=checkpoint,
                          device='cpu', legacy_mode=True))

    phase(f'5 times on {card} (median of {REPS}, CUDA events)')
    bf16 = torch.bfloat16
    b_qkv = w['bqkv'].to(bf16)
    attn_pairs = mask.sum(dim=1).double().sum().item() * T  # query x key
    work = {
        'qkv_proj': (2 * M * C * 3 * C,
                     M * C * 4 + C * 3 * C * 2 + 3 * C * 4 + M * 3 * C * 2),
        'attention': (4 * attn_pairs * C, M * 3 * C * 2 + M + M * C * 2),
        'out_proj_residual_ln': (2 * M * C * C,
                                 M * C * 2 + 2 * M * C * 4 + C * C * 2
                                 + 3 * C * 4),
        'ffn_residual_ln': (4 * M * C * Fh,
                            2 * M * C * 4 + 2 * C * Fh * 2 + (Fh + 3 * C) * 4),
    }
    q4, k4, v4 = (t.view(W, T, H, C // H).transpose(1, 2) for t in (q, k, v))
    sdpa_mask = mask[:, None, None, :]
    runs = {
        'qkv_proj': (
            lambda: elk.qkv_proj(x, w['wqkv'], w['bqkv']),
            lambda: elk.qkv_proj_reference(x, w['wqkv'], w['bqkv']),
            lambda: torch.addmm(b_qkv, x.view(M, C).to(bf16), w['wqkv'])),
        'attention': (
            lambda: fa.attention(q, k, v, mask, H, 1.0),
            lambda: fa.attention_reference(q, k, v, mask, H, 1.0),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=sdpa_mask, scale=math.log(2))),
        'out_proj_residual_ln': (
            lambda: elk.out_proj_residual_ln(a, w['wo'], w['bo'], x,
                                             w['g1'], w['be1']),
            lambda: elk.out_proj_residual_ln_reference(
                a, w['wo'], w['bo'], x, w['g1'], w['be1']),
            lambda: F.layer_norm(
                x + torch.addmm(w['bo'].to(bf16), a.view(M, C), w['wo'])
                .view(W, T, C), (C,), w['g1'], w['be1'])),
        'ffn_residual_ln': (
            lambda: fused_ffn.ffn_residual_ln(r, *ffn_args),
            lambda: fused_ffn.ffn_residual_ln_reference(r, *ffn_args),
            lambda: F.layer_norm(
                r + torch.addmm(
                    w['b2'].to(bf16),
                    torch.relu(torch.addmm(w['b1'].to(bf16),
                                           r.view(M, C).to(bf16), w['w1'])),
                    w['w2']).view(W, T, C), (C,), w['g2'], w['be2'])),
    }
    sources = {'qkv_proj': 'qkv_proj.cu', 'attention': 'attention.cu',
               'out_proj_residual_ln': 'out_proj_ln.cu',
               'ffn_residual_ln': 'ffn_ln.cu'}
    replaces = {
        'qkv_proj': 'ppgs_tpu/ops/encoder_layer_kernel.py:152',
        'attention': 'ppgs_tpu/ops/flash_attention.py:43',
        'out_proj_residual_ln': 'ppgs_tpu/ops/encoder_layer_kernel.py:152',
        'ffn_residual_ln': 'ppgs_tpu/ops/fused_ffn.py:33',
    }
    records = []
    for name, (kernel_fn, plain_fn, library_fn) in runs.items():
        ms, plain_ms, library_ms = (time_ms(kernel_fn), time_ms(plain_fn),
                                    time_ms(library_fn))
        bound_ms, bound_by = bound(*work[name])
        print(f'{name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms '
              f'({bound_by}), plain {plain_ms:.4f} ms, library '
              f'{library_ms:.4f} ms, {launches[name]} launches per main-path '
              f'call [{card}]', flush=True)
        records.append({
            'name': name, 'route': 'cuda',
            'source': f'ppgs_tpu_torch/kernels/csrc/{sources[name]}',
            'replaces': replaces[name], 'launches': launches[name],
            'max_abs_err': err[name], 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms})

    stack_ms = time_ms(lambda: elk.encoder_stack(x, mask, model.layers, H))
    stack_plain_ms = time_ms(
        lambda: elk.encoder_stack_reference(x, mask, model.layers, H))
    # The library's yardstick: the same post-LN stack in one call, with
    # the same key-padding mask (the main path's windows have no wholly
    # masked row); its output is held to the kernels' on the valid rows
    # (its residual is bf16, the kernels' fp32)
    encoder = library_encoder(model, config, dev)
    x_bf16, pad = x.to(bf16), ~mask

    def library_stack():
        return encoder(x_bf16, src_key_padding_mask=pad)

    stack_library_ms = time_ms(library_stack)
    gap = (library_stack().float() - elk.encoder_stack(
        x, mask, model.layers, H))[mask].abs()
    print(f'nn.TransformerEncoder against encoder_stack, valid rows: max '
          f'|diff| {gap.max().item():.3g}, mean {gap.mean().item():.3g} '
          f'(mean < 0.1)', flush=True)
    if not gap.mean().item() < 0.1:
        raise AssertionError('the library encoder computes another function')
    del encoder, gap
    # The chain's bound: each of its kernels at its own bound, per layer
    stack_bound = L * sum(bound(*w_)[0] for w_ in work.values())
    print(f'encoder_stack ({L} layers, {W} x {T}): kernels {stack_ms:.4f} ms, '
          f'bound {stack_bound:.4f} ms, plain {stack_plain_ms:.4f} ms, '
          f'library {stack_library_ms:.4f} ms (nn.TransformerEncoder) '
          f'[{card}]', flush=True)

    e2e = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        port.from_audio(audio, checkpoint=checkpoint)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - start)
    e2e_s = statistics.median(e2e)
    print(f'from_audio {BATCH} x {SECONDS} s: {e2e_s * 1e3:.3f} ms, '
          f'{BATCH * SECONDS / e2e_s:.1f} audio-s/s (median of 5) [{card}]',
          flush=True)
    profile_from_audio(port, audio, checkpoint, card)

    workdir.cleanup()
    print(json.dumps({'kernels': records}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
