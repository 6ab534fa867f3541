"""CLI: infer PPGs from audio files (reference: ppgs/__main__.py:12-59).

    python -m ppgs_tpu_torch --input_paths a.wav b.wav --output_paths a.npy b.npy

The JAX package's CLI (``python -m ppgs_tpu``) with its arguments, plus
``--device``: the card by default, ``--device cpu`` to run on the CPU.
"""

import argparse
from pathlib import Path

import ppgs_tpu_torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Infer phonetic posteriorgrams from audio')
    parser.add_argument('--input_paths', nargs='+', required=True,
                        help='Audio files or directories')
    parser.add_argument('--output_paths', nargs='+', default=None,
                        help='Output .npy files (default: alongside inputs)')
    parser.add_argument('--representation', default=None,
                        help='Input representation (mel, w2v2fb, ...)')
    parser.add_argument('--checkpoint', default=None)
    parser.add_argument('--config', default=None,
                        help='Named config (mel, w2v2fb, ...)')
    parser.add_argument('--num-workers', type=int, default=0,
                        help='Data loader workers (0: a file at a time)')
    parser.add_argument('--max-frames', type=int, default=None,
                        help='Maximum frames per inference batch '
                             '(num_workers > 0 path)')
    parser.add_argument('--legacy-mode', action='store_true')
    parser.add_argument('--device', default=None,
                        help="Torch device (default: 'cuda')")
    return parser.parse_args(argv)


def expand(paths):
    files = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.glob('*.wav')) + sorted(p.glob('*.mp3')))
        else:
            files.append(p)
    return files


def main(argv=None):
    args = parse_args(argv)
    config = ppgs_tpu_torch.config.use(args.config) if args.config else None
    inputs = expand(args.input_paths)
    if args.output_paths:
        outputs = [Path(p) for p in args.output_paths]
    else:
        ext = ppgs_tpu_torch.representation_file_extension(config)
        outputs = [f.with_suffix('').with_name(f.stem + ext) for f in inputs]
    ppgs_tpu_torch.from_files_to_files(
        inputs, outputs,
        representation=args.representation,
        checkpoint=args.checkpoint,
        num_workers=args.num_workers,
        max_frames=args.max_frames,
        legacy_mode=args.legacy_mode,
        config=config,
        device=args.device)


if __name__ == '__main__':
    main()
