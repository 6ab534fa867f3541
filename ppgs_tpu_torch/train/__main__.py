"""CLI: train a model (reference: ppgs/train/__main__.py).

    python -m ppgs_tpu_torch.train --config mel --dataset commonvoice

``--device cpu`` trains on the CPU; the card is the default.
"""

import argparse
from pathlib import Path

from ppgs_tpu_torch import config as config_mod


def main(argv=None):
    parser = argparse.ArgumentParser(description='Train a PPG model')
    parser.add_argument('--config', default=None,
                        help='Named config (mel, w2v2fb, ...)')
    parser.add_argument('--dataset', default=None)
    parser.add_argument('--directory', default=None,
                        help='Run directory (default runs/<config>)')
    parser.add_argument('--steps', type=int, default=None)
    parser.add_argument('--device', default=None,
                        help="Torch device (default: 'cuda')")
    args = parser.parse_args(argv)

    config = config_mod.use(args.config) if args.config else \
        config_mod.default()
    dataset = args.dataset or config.training_dataset
    directory = Path(args.directory or config_mod.RUNS_DIR / config.config)

    from ppgs_tpu_torch import devices
    from ppgs_tpu_torch.train import train

    devices.resolve(args.device)    # raises without the card, first
    directory.mkdir(parents=True, exist_ok=True)
    # Record config provenance in the run directory
    with open(directory / 'config.txt', 'w') as file:
        file.write(repr(config))
    train(dataset, directory, config=config, max_steps=args.steps,
          device=args.device)


if __name__ == '__main__':
    main()
