"""CLI: plot PPGs (reference: ppgs/plot/__main__.py).

    python -m ppgs_tpu_torch.plot --output_paths a.png --ppg_paths a.npy

The JAX package's flags (``python -m ppgs_tpu.plot``), plus ``--device``:
PPGs inferred from ``--audio_paths`` run on the card by default, on the CPU
with ``--device cpu``.
"""

import argparse

from ppgs_tpu_torch import plot


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Plot PPGs')
    parser.add_argument('--output_paths', nargs='+', required=True)
    parser.add_argument('--ppg_paths', nargs='+', default=None)
    parser.add_argument('--audio_paths', nargs='+', default=None)
    parser.add_argument('--second_ppg_paths', nargs='+', default=None)
    parser.add_argument('--textgrid_paths', nargs='+', default=None)
    parser.add_argument('--checkpoint', default=None)
    parser.add_argument('--device', default=None,
                        help="Torch device of the inference (default: "
                             "'cuda')")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    plot.from_files_to_files(
        args.output_paths,
        ppg_files=args.ppg_paths,
        audio_files=args.audio_paths,
        second_ppg_files=args.second_ppg_paths,
        textgrid_files=args.textgrid_paths,
        checkpoint=args.checkpoint,
        device=args.device)


if __name__ == '__main__':
    main()
