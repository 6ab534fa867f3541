"""CLI: download and format datasets (reference:
ppgs/data/download/__main__.py).

    python -m ppgs_tpu_torch.data.download --datasets timit --format-only
"""

import argparse

from ppgs_tpu_torch.data.download import datasets


def main(argv=None):
    parser = argparse.ArgumentParser(description='Download datasets')
    parser.add_argument('--datasets', nargs='+', default=None)
    parser.add_argument('--format-only', action='store_true')
    args = parser.parse_args(argv)
    datasets(args.datasets, format_only=args.format_only)


if __name__ == '__main__':
    main()
