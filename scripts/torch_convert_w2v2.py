"""Convert a wav2vec2 or Charsiu state-dict file to the npz layout that both
packages load, without JAX and without the network.

Usage:
    python scripts/torch_convert_w2v2.py pytorch_model.bin wav2vec2-base.npz
    python scripts/torch_convert_w2v2.py --charsiu pytorch_model.bin \
        charsiu-w2v2-fc.npz

The input is a torch state dict (read with ``weights_only``): a
transformers ``Wav2Vec2Model``'s (keys with or without 'wav2vec2.'), or
with ``--charsiu`` the Charsiu frame classifier's (charsiu/en_w2v2_fc_10ms:
the 'wav2vec2.' trunk and the linear 'cls_head'), which is written as
{'w2v2': trunk, 'head': {'weight', 'bias'}}. The conv and layer counts come
from the keys. Point ``preprocess.w2v2fb.W2V2FB_CHECKPOINT`` (or
``preprocess.w2v2fc.W2V2FC_CHECKPOINT``) at the output.
"""

import argparse
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ppgs_tpu_torch import load as load_mod
from ppgs_tpu_torch.convert import w2v2_params_from_state_dict


def count(state_dict, pattern):
    """1 + the largest index that ``pattern`` captures in the keys."""
    return 1 + max(int(match.group(1)) for key in state_dict
                   for match in [re.match(pattern, key)] if match)


def trunk_params(state_dict):
    """The trunk's pytree from a Wav2Vec2Model state dict of numpy arrays
    (no 'wav2vec2.' prefix)."""
    return w2v2_params_from_state_dict(
        state_dict,
        num_feat_layers=count(state_dict,
                              r'feature_extractor\.conv_layers\.(\d+)\.'),
        num_layers=count(state_dict, r'encoder\.layers\.(\d+)\.'))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('state_dict', help='torch state-dict file')
    parser.add_argument('output', help='Output .npz')
    parser.add_argument('--charsiu', action='store_true',
                        help='The Charsiu frame classifier (trunk + head)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    full = {k: v.detach().cpu().numpy() for k, v in torch.load(
        args.state_dict, map_location='cpu', weights_only=True).items()}
    trunk = {k.removeprefix('wav2vec2.'): v for k, v in full.items()
             if k.startswith('wav2vec2.') or not args.charsiu}
    params = trunk_params(trunk)
    if args.charsiu:
        params = {'w2v2': params,
                  'head': {'weight': full['cls_head.weight'].T,
                           'bias': full['cls_head.bias']}}
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    load_mod.save_params(args.output, params)
    print(f'Converted {args.state_dict} -> {args.output}')


if __name__ == '__main__':
    main()
