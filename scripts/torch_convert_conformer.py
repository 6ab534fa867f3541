"""Convert the published ESPnet conformer checkpoint (24epoch.pth) to the
npz layout that both packages load, without JAX and without the network.

Usage:
    python scripts/torch_convert_conformer.py 24epoch.pth conformer-24epoch.npz

The checkpoint is read with ``weights_only``; its 'encoder.' tensors are
mapped block by block (the block count comes from the keys). Point
``ppgs_tpu_torch.preprocess.bottleneck.BOTTLENECK_CHECKPOINT`` at the
output.
"""

import argparse
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ppgs_tpu_torch import load as load_mod
from ppgs_tpu_torch.convert import conformer_params_from_checkpoint


def block_count(path):
    """The number of conformer blocks ('encoder.encoders.{i}.') in a
    checkpoint."""
    keys = torch.load(path, map_location='cpu', weights_only=True)
    return 1 + max(int(match.group(1)) for key in keys
                   for match in [re.match(r'encoder\.encoders\.(\d+)\.', key)]
                   if match)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('checkpoint', help='ESPnet checkpoint (.pth)')
    parser.add_argument('output', help='Output .npz')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    blocks = block_count(args.checkpoint)
    params = conformer_params_from_checkpoint(args.checkpoint, blocks)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    load_mod.save_params(args.output, params)
    print(f'Converted {args.checkpoint} ({blocks} blocks) -> {args.output}')


if __name__ == '__main__':
    main()
