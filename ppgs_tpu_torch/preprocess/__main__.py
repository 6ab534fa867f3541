"""CLI: cache input representations (reference: ppgs/preprocess/__main__.py).

    python -m ppgs_tpu_torch.preprocess --datasets commonvoice \
        --representations mel w2v2fb

``--device cpu`` runs on the CPU; the card is the default.
"""

import argparse

from ppgs_tpu_torch import config as config_mod
from ppgs_tpu_torch.preprocess import core


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Preprocess input representations')
    parser.add_argument('--datasets', nargs='+', default=None)
    parser.add_argument('--representations', nargs='+', default=None)
    parser.add_argument('--config', default=None)
    parser.add_argument('--partition', default=None)
    parser.add_argument('--device', default=None,
                        help="Torch device (default: 'cuda')")
    args = parser.parse_args(argv)

    config = config_mod.use(args.config) if args.config else None
    core.datasets(args.datasets, args.representations, config,
                  args.partition, device=args.device)


if __name__ == '__main__':
    main()
