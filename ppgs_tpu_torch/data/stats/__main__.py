"""CLI: dataset statistics (reference: ppgs/data/stats/__main__.py).

    python -m ppgs_tpu_torch.data.stats --datasets commonvoice
"""

import argparse

from ppgs_tpu_torch.data.stats import process


def main(argv=None):
    parser = argparse.ArgumentParser(description='Dataset statistics')
    parser.add_argument('--datasets', nargs='+', default=None)
    args = parser.parse_args(argv)
    process(args.datasets)


if __name__ == '__main__':
    main()
