#!/usr/bin/env bash
# Full paper-reproduction pipeline on the PyTorch/CUDA port (run.sh step for
# step, reference: run.sh:13-64): download -> partition -> {preprocess,
# train, evaluate} per representation -> accuracy plot. Every step runs on
# the CUDA card (pass --device cpu to the computing steps to run on the
# CPU). Requires datasets placed per the download docs; the encodec
# representation needs the encodec package and its codebook asset
# (scripts/convert_codebooks.py).
set -euo pipefail

# All five trained representations of the paper (reference run.sh:22-56:
# default/bottleneck, w2v2fb, w2v2fc, mel, encodec)
REPRESENTATIONS=(mel w2v2fb w2v2fc bottleneck encodec)

# Download and format datasets (TIMIT/Common Voice need user-supplied blobs)
python -m ppgs_tpu_torch.data.download --datasets commonvoice arctic timit

# Partition
python -m ppgs_tpu_torch.partition --datasets commonvoice arctic timit

for rep in "${REPRESENTATIONS[@]}"; do
    # Cache input representations
    python -m ppgs_tpu_torch.preprocess --datasets commonvoice arctic timit \
        --representations "$rep" --config "$rep"

    # Train
    python -m ppgs_tpu_torch.train --config "$rep" --dataset commonvoice

    # Evaluate
    python -m ppgs_tpu_torch.evaluate --config "$rep" --datasets timit arctic
done

# Accuracy bar chart across representations
python -m ppgs_tpu_torch.plot.accuracy --output_file eval/accuracy.png \
    --representations "${REPRESENTATIONS[@]}"
