"""CLI: accuracy bar chart (reference: ppgs/plot/accuracy/__main__.py).

    python -m ppgs_tpu_torch.plot.accuracy --output_file accuracy.jpg

Reads the evaluation JSONs under the config's EVAL_DIR; needs no device.
"""

import argparse

from ppgs_tpu_torch.plot.accuracy import from_eval


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Plot accuracy bars')
    parser.add_argument('--output_file', required=True)
    parser.add_argument('--datasets', nargs='+', default=None)
    parser.add_argument('--representations', nargs='+', default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from_eval(args.output_file, args.datasets, args.representations)


if __name__ == '__main__':
    main()
