"""CLI: partition datasets (reference: ppgs/partition/__main__.py).

    python -m ppgs_tpu_torch.partition --datasets commonvoice
"""

import argparse

from ppgs_tpu_torch.partition import datasets


def main(argv=None):
    parser = argparse.ArgumentParser(description='Partition datasets')
    parser.add_argument('--datasets', nargs='+', default=None)
    args = parser.parse_args(argv)
    datasets(args.datasets)


if __name__ == '__main__':
    main()
