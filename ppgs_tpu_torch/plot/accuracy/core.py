"""Accuracy bar chart across representations
(reference: ppgs/plot/accuracy/core.py:21-135); the counterpart of
``ppgs_tpu/plot/accuracy/core.py``.

Reads the EVAL_DIR/<representation>/<dataset>.json files that
evaluate.datasets writes and draws grouped bars per dataset plus the
average with matplotlib (imported when called, Agg backend). No device is
used.
"""

import json

from ... import config as config_mod


REPRESENTATION_MAP = {
    'bottleneck': 'ASR bottleneck',
    'encodec': 'EnCodec',
    'dac': 'DAC',
    'mel': 'Mel spectrogram',
    'w2v2fb': 'Wav2vec 2.0',
    'w2v2fc': 'Charsiu',
}

DATASET_MAP = {
    'commonvoice': 'Common Voice',
    'arctic': 'Arctic',
    'timit': 'TIMIT',
}


def from_eval(output_file, datasets=None, representations=None, config=None):
    """Plot framewise accuracy per dataset and representation."""
    import matplotlib

    matplotlib.use('Agg')
    from matplotlib import pyplot as plt

    config = config_mod.get(config)
    datasets = list(datasets or config.datasets)
    representations = list(representations or config.all_representations)

    # Load results
    accuracies = {dataset: {} for dataset in datasets}
    available = []
    for representation in representations:
        rep_dir = config_mod.EVAL_DIR / representation
        values = {}
        for dataset in datasets:
            path = rep_dir / f'{dataset}.json'
            if path.exists():
                with open(path) as file:
                    values[dataset] = json.load(file)['Accuracy']
        if values:
            available.append(representation)
            for dataset, value in values.items():
                accuracies[dataset][representation] = value
    if not available:
        raise FileNotFoundError(
            f'No evaluation results found under {config_mod.EVAL_DIR}')

    # Sort representations by average accuracy, descending
    def average(representation):
        values = [accuracies[d].get(representation) for d in datasets]
        values = [v for v in values if v is not None]
        return sum(values) / max(len(values), 1)

    available.sort(key=average, reverse=True)

    panels = datasets + ['average']
    figure, axes = plt.subplots(
        1, len(panels), figsize=(4 * len(panels), 4), sharey=True)
    if len(panels) == 1:
        axes = [axes]
    for axis, panel in zip(axes, panels):
        for i, representation in enumerate(available):
            if panel == 'average':
                value = average(representation)
            else:
                value = accuracies[panel].get(representation)
            if value is None:
                continue
            axis.bar(i, value,
                     label=REPRESENTATION_MAP.get(representation,
                                                  representation))
        axis.set_title(DATASET_MAP.get(panel, panel.capitalize()))
        axis.set_ylim(0.3, 0.9)
        axis.set_xticks([])
    axes[0].set_ylabel('Framewise phoneme accuracy')
    axes[-1].legend(fontsize=8)
    figure.tight_layout()
    figure.savefig(output_file, dpi=150)
    plt.close(figure)
    return output_file
