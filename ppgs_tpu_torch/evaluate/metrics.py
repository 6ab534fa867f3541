"""Evaluation metrics (reference: ppgs/evaluate/metrics.py:14-414).

Counterpart of the accumulators of ``ppgs_tpu/evaluate/metrics.py``: the
metric state is a dict of sums (``init_state``), ``_update`` adds one
batch's contribution to every metric at once, and ``Metrics`` turns the
sums into the reference's scalars and, with ``include_figures``, its
confusion and distance figures (matplotlib, imported only when a figure is
drawn, with the Agg backend).
"""

import functools
import importlib.util

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from ..phonemes import PHONEMES

TOP_K = 3


@functools.lru_cache(maxsize=1)
def similarity_matrix():
    """40x40 acoustic phoneme similarity matrix (the JAX package's asset,
    read by path), as a float32 numpy array."""
    with np.load(config_mod.SIMILARITY_MATRIX_PATH) as data:
        return np.asarray(data['similarity'], dtype=np.float32)


def init_state(num_classes=40, device=None):
    """Zeroed metric accumulators."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        'count': torch.zeros((), dtype=torch.int64, device=device),
        'true_positives': z(),
        'top_k_correct': z(),
        'jsd_total': z(),
        'loss_total': z(),
        'class_totals': z(num_classes),
        'class_counts': z(num_classes),
        'confusion': z(num_classes, num_classes),
        # Probability-mass confusion: row target, summed softmax probs
        'prob_confusion': z(num_classes, num_classes),
        # Weighted distance matrix: row weighted-argmax prediction, summed
        # weighted probs
        'distance_matrix': z(num_classes, num_classes),
    }


@torch.no_grad()
def _update(state, logits, targets, similarity, class_weights,
            distance_weights):
    """Add one batch to every metric. logits: (B, C, T) raw model outputs;
    targets: (B, T) with -100 padding; class_weights None for unweighted
    loss."""
    num_classes = logits.shape[1]
    flat_logits = logits.transpose(1, 2).reshape(-1, num_classes).float()
    flat_targets = targets.reshape(-1)
    valid = flat_targets != -100
    validf = valid.float()
    safe_targets = torch.where(valid, flat_targets,
                               torch.zeros_like(flat_targets))

    count = valid.sum()
    predicted = flat_logits.argmax(dim=-1)
    true_positives = ((predicted == flat_targets) & valid).sum()

    kth = torch.sort(flat_logits, dim=-1).values[:, num_classes - TOP_K]
    target_logit = flat_logits.gather(1, safe_targets[:, None])[:, 0]
    top_k_correct = ((target_logit >= kth) & valid).sum()

    pred_onehot = F.one_hot(predicted, num_classes).float() * validf[:, None]
    target_onehot = (F.one_hot(safe_targets, num_classes).float()
                     * validf[:, None])
    class_totals = (pred_onehot * target_onehot).sum(dim=0)
    class_counts = target_onehot.sum(dim=0)
    confusion = target_onehot.T @ pred_onehot

    log_probs = F.log_softmax(flat_logits, dim=-1)
    nll = -log_probs.gather(1, safe_targets[:, None])[:, 0]
    if class_weights is not None:
        nll = nll * class_weights[safe_targets]
    loss_total = torch.where(valid, nll, torch.zeros_like(nll)).sum()

    probs = F.softmax(flat_logits, dim=-1)
    jsd = _jsd_sum(probs, target_onehot, valid, similarity)

    masked_probs = probs * validf[:, None]
    prob_confusion = target_onehot.T @ masked_probs

    weighted = probs * distance_weights[None, :]
    weighted_pred = weighted.argmax(dim=-1)
    pred_w_onehot = (F.one_hot(weighted_pred, num_classes).float()
                     * validf[:, None])
    distance_matrix = pred_w_onehot.T @ (weighted * validf[:, None])

    update = {
        'count': count, 'true_positives': true_positives,
        'top_k_correct': top_k_correct, 'jsd_total': jsd,
        'loss_total': loss_total, 'class_totals': class_totals,
        'class_counts': class_counts, 'confusion': confusion,
        'prob_confusion': prob_confusion, 'distance_matrix': distance_matrix,
    }
    return {key: state[key] + update[key].to(state[key].dtype)
            for key in state}


def _jsd_sum(probs, target_onehot, valid, similarity, exponent=1.2):
    """Summed normalized JSD between rows of probs and one-hot targets
    (reference JensenShannon.update -> ppgs.distance(reduction='sum'))."""
    x = probs.clamp(1e-8, 1 - 1e-8)
    y = target_onehot.clamp(1e-8, 1 - 1e-8)
    weight = similarity.T ** exponent
    x = x @ weight.T
    y = y @ weight.T
    log_average = torch.log((x + y) / 2)
    kl_x = x * (torch.log(x) - log_average)
    kl_y = y * (torch.log(y) - log_average)
    average_kl = ((kl_x + kl_y) / 2).clamp_min(0.0)
    jsd = torch.sqrt(average_kl).sum(dim=-1)
    return torch.where(valid, jsd, torch.zeros_like(jsd)).sum()


class Metrics:
    """Stateful wrapper with the reference's dict-of-scalars interface."""

    def __init__(self, include_figures=False, config=None, device=None):
        self.include_figures = include_figures
        self.config = config_mod.get(config)
        self.device = torch.device('cpu' if device is None else device)
        self.similarity = torch.from_numpy(similarity_matrix()).to(
            self.device)
        weights = None
        if self.config.class_balanced:
            from .. import load as load_mod

            weights = load_mod.phoneme_weights(self.config, self.device)
        self.class_weights = weights
        # The distance matrix is always weighted by the asset's weights
        try:
            with np.load(config_mod.CLASS_WEIGHT_FILE) as data:
                distance = torch.from_numpy(
                    np.asarray(data['weights'], np.float32))
        except (FileNotFoundError, OSError):
            distance = torch.ones(self.config.output_channels)
        self.distance_weights = distance.to(self.device)
        self.reset()

    def reset(self):
        self.state = init_state(self.config.output_channels, self.device)

    def update(self, predicted_logits, target_indices):
        self.state = _update(
            self.state, torch.as_tensor(predicted_logits).to(self.device),
            torch.as_tensor(target_indices).to(self.device),
            self.similarity, self.class_weights, self.distance_weights)

    def __call__(self):
        s = {key: value.cpu().numpy() for key, value in self.state.items()}
        count = max(float(s['count']), 1.0)
        results = {
            'Accuracy': float(s['true_positives']) / count,
            f'Top-{TOP_K} Accuracy/': float(s['top_k_correct']) / count,
            'JSD': float(s['jsd_total']) / count,
            'loss': float(s['loss_total']) / count,
        }
        for i, phoneme in enumerate(PHONEMES):
            denom = max(float(s['class_counts'][i]), 1.0)
            results[f'Accuracy/{phoneme}'] = float(
                s['class_totals'][i]) / denom
            results[f'Total/{phoneme}'] = float(s['class_totals'][i])
            results[f'Count/{phoneme}'] = float(s['class_counts'][i])
        if self.include_figures:
            results['ConfusionMatrix'] = self.confusion_figure(
                s['prob_confusion'])
            results['DistanceMatrix'] = self.distance_figure(
                s['distance_matrix'])
        return results

    @staticmethod
    def confusion_figure(confusion):
        """Probability-mass confusion figure (reference
        metrics.py:255-270)."""
        plt = _pyplot()
        row_sums = confusion.sum(axis=1, keepdims=True)
        normalized = confusion / np.maximum(row_sums, 1e-12)
        figure, axis = plt.subplots(figsize=(6, 6), dpi=200)
        axis.matshow(normalized)
        axis.set_xticks(range(len(PHONEMES)))
        axis.set_yticks(range(len(PHONEMES)))
        axis.set_xticklabels(PHONEMES, rotation='vertical', fontsize=5)
        axis.set_yticklabels(PHONEMES, fontsize=5)
        axis.set_ylabel('Ground Truth Phoneme')
        axis.set_xlabel('Model Predicted Probabilities')
        return figure

    @staticmethod
    def distance_figure(matrix):
        """Weighted distance-matrix figure with a PowerNorm render and
        f/v, s/z, sh/zh highlight boxes (reference metrics.py:301-364)."""
        plt = _pyplot()
        from matplotlib.colors import PowerNorm

        row_sums = matrix.sum(axis=1, keepdims=True)
        normalized = matrix / np.maximum(row_sums, 1e-12)
        figure, axis = plt.subplots(figsize=(6, 6), dpi=200)
        image = axis.matshow(normalized, norm=PowerNorm(gamma=1 / 3))
        axis.set_xticks(range(len(PHONEMES)))
        axis.set_yticks(range(len(PHONEMES)))
        axis.set_xticklabels(PHONEMES, rotation='vertical', fontsize=5)
        axis.set_yticklabels(PHONEMES, fontsize=5)
        figure.colorbar(image, ax=axis, fraction=0.046)

        padding = 0.7
        for phone0, phone1 in [('f', 'v'), ('s', 'z'), ('sh', 'zh')]:
            idx0, idx1 = PHONEMES.index(phone0), PHONEMES.index(phone1)
            for cx, cy in [(idx0, idx1), (idx1, idx0)]:
                axis.add_patch(plt.Rectangle(
                    (cx - padding, cy - padding), 2 * padding, 2 * padding,
                    facecolor='none', edgecolor='red', linewidth=0.5))
        return figure


def _pyplot():
    """matplotlib's pyplot on the Agg backend (no display)."""
    import matplotlib

    matplotlib.use('Agg')
    from matplotlib import pyplot

    return pyplot


def figures_available():
    """Whether the figures can be drawn: matplotlib imports. Where it
    does not, the evaluation writes its scalars and tensors only."""
    return importlib.util.find_spec('matplotlib') is not None


def close_figures(figures):
    """Close matplotlib figures once they are written."""
    figures = list(figures)
    if figures:
        plt = _pyplot()
        for figure in figures:
            plt.close(figure)
