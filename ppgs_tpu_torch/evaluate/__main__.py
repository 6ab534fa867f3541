"""CLI: objective evaluation (reference: ppgs/evaluate/__main__.py).

    python -m ppgs_tpu_torch.evaluate --config mel --datasets timit arctic

``--device cpu`` evaluates on the CPU; the card is the default.
"""

import argparse

from ppgs_tpu_torch import config as config_mod
from ppgs_tpu_torch.evaluate import datasets


def main(argv=None):
    parser = argparse.ArgumentParser(description='Evaluate a PPG model')
    parser.add_argument('--datasets', nargs='+', default=None)
    parser.add_argument('--checkpoint', default=None)
    parser.add_argument('--config', default=None)
    parser.add_argument('--device', default=None,
                        help="Torch device (default: 'cuda')")
    args = parser.parse_args(argv)

    config = config_mod.use(args.config) if args.config else None
    results = datasets(args.datasets, args.checkpoint, config,
                       device=args.device)
    for name, metrics in results.items():
        if 'Accuracy' in metrics:
            print(f'{name}: accuracy={metrics["Accuracy"]:.4f} '
                  f'JSD={metrics.get("JSD", float("nan")):.4f}')
    return results


if __name__ == '__main__':
    main()
