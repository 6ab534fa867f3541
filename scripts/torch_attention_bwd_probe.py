#!/usr/bin/env python3
"""Time the port's attention_train_bwd on one CUDA card, dropout on and off.

    python3 scripts/torch_attention_bwd_probe.py [--root DIR]

Imports ``ppgs_tpu_torch`` from the checkout at ``--root`` (default: this
one; another checkout, such as an unpacked ``git archive`` of an older
commit, times that commit's kernel with the same inputs), builds its
kernels, and times ``attention_train_bwd`` at chip_smoke.py's training
shape (256 windows x T = 512, 2 heads of 128, ragged windows, one wholly
masked, bf16 and fp32 outputs) with dropout 0.1 and with the dropout off
(threshold 0) in turns (on, off, off, on): CUDA-event medians of 10 runs
and the profiler's device time per launch by kernel. The gap between the
two is what the keep bits cost the backward (chip_smoke.py's
``keep_bits_probe``, which times it): drawing them, where the backward
draws them, as it did before the forward handed them on. Prints the card's name and power
limit, then one JSON line. Imports nothing of JAX.
"""

import argparse
import json
import math
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--root', default=str(REPO),
                        help='checkout whose ppgs_tpu_torch is timed')
    root = Path(parser.parse_args().root).resolve()
    if not torch.cuda.is_available():
        sys.exit('torch_attention_bwd_probe.py needs a CUDA device')
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from ppgs_tpu_torch import kernels
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    kernels.build_all()
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
    do = torch.randn(B, T, C, generator=gen, device=dev)
    sl, sm = fa.LOG2E / math.sqrt(D), 1 / math.sqrt(D)
    drop = dropout.Drop(cs.SEED + 17, dropout.site(0, 'probs'), cs.DROPOUT)
    with torch.no_grad():
        fwd = fa.attention_train_fwd(q, k, v, mask, H, sl, False, drop,
                                     want_f32=True)
        d_row = fa.row_dot(do, fwd[1], H)
        # (lse, keep words) since the forward hands its keep bits on; lse
        # alone before
        saved = fwd[2:]
        result = cs.keep_bits_probe(
            'attention_train_bwd',
            lambda *a: fa.attention_train_bwd(*a, want32=True),
            (q, k, v, mask, *saved, do.to(torch.bfloat16), d_row, H, sl, sm,
             False, drop), card)
    print(json.dumps({'root': str(root), **result}), flush=True)


if __name__ == '__main__':
    main()
