"""Convert a reference PyTorch transformer checkpoint (.pt) to the npz
layout that both packages load, without JAX and without the network.

Usage:
    python scripts/torch_convert_checkpoint.py mel-800k.pt mel-800k.npz

The state dict is read with ``weights_only`` (flat, or under 'model'); the
model's geometry (layers, widths, kernel size) comes from the checkpoint
itself. Load the output with ``ppgs_tpu_torch.load.model(checkpoint=...)``.
"""

import argparse
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ppgs_tpu_torch import load as load_mod
from ppgs_tpu_torch.convert import (
    load_torch_checkpoint,
    transformer_params_from_state_dict,
)


def layer_count(state_dict):
    """The number of encoder layers in a reference state dict."""
    return 1 + max(int(match.group(1)) for key in state_dict
                   for match in [re.match(r'model\.layers\.(\d+)\.', key)]
                   if match)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('checkpoint', help='Reference .pt checkpoint')
    parser.add_argument('output', help='Output .npz')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    state_dict = load_torch_checkpoint(args.checkpoint)
    layers = layer_count(state_dict)
    params = transformer_params_from_state_dict(state_dict,
                                                num_layers=layers)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    load_mod.save_params(args.output, params)
    print(f'Converted {args.checkpoint} ({layers} layers) -> {args.output}')


if __name__ == '__main__':
    main()
