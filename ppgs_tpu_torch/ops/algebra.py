"""PPG algebra: pronunciation distance, interpolation, sparsification.

Counterpart of ``ppgs_tpu/ops/algebra.py`` (reference: ppgs/core.py:
399-543), on (P, T) or (..., P, T) posteriorgrams. A tensor argument is
computed on where it lies; anything else (a numpy array) is moved to
``devices.resolve(device)``, the card unless the caller names the CPU.
"""

import functools

import numpy as np
import torch

from .. import config as config_mod
from .. import devices


def as_tensor(x, device=None):
    """``x`` as it is when it is a tensor; otherwise a tensor of it on
    ``devices.resolve(device)``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=devices.resolve(device))


###############################################################################
# Similarity matrix (host-side cache)
###############################################################################


@functools.lru_cache(maxsize=1)
def _similarity_host():
    with np.load(config_mod.SIMILARITY_MATRIX_PATH) as data:
        return np.asarray(data['similarity'], dtype=np.float32)


def similarity_matrix():
    """The 40 x 40 acoustic phoneme similarity matrix (the JAX package's
    asset, read by path once), as a float32 CPU tensor of its own."""
    return torch.tensor(_similarity_host())


###############################################################################
# Distance (normalized Jensen-Shannon divergence)
###############################################################################


def _reverse(x):
    """All axes reversed, as jnp's ``.T`` does for any rank."""
    return x.permute(*range(x.ndim - 1, -1, -1))


def distance(ppg_x, ppg_y, reduction='mean', normalize=True, exponent=None,
             matrix=None, device=None):
    """Pronunciation distance between two aligned PPGs of shape (P, T).

    Reference semantics (ppgs/core.py:399-469): clamp, optional similarity
    normalization S.T**exp @ ppg, symmetric KL about the parameter-space
    average, sqrt, sum over classes, then reduce over frames.
    """
    ppg_x = as_tensor(ppg_x, device)
    ppg_y = as_tensor(ppg_y, ppg_x.device)
    if exponent is None:
        exponent = config_mod.default().similarity_exponent
    ppg_x = torch.clamp(ppg_x, 1e-8, 1 - 1e-8)
    ppg_y = torch.clamp(ppg_y, 1e-8, 1 - 1e-8)

    if normalize:
        if matrix is None:
            matrix = similarity_matrix()
        matrix = torch.as_tensor(matrix).to(ppg_x.device, ppg_x.dtype)
        weight = matrix.T ** exponent
        ppg_x = _reverse(weight @ ppg_x)           # (T, P)
        ppg_y = _reverse(weight @ ppg_y)
    else:
        ppg_x, ppg_y = _reverse(ppg_x), _reverse(ppg_y)

    # Average in parameter space
    log_average = torch.log((ppg_x + ppg_y) / 2)

    # KL divergences in both directions: kl(p || avg) pointwise
    kl_x = ppg_x * (torch.log(ppg_x) - log_average)
    kl_y = ppg_y * (torch.log(ppg_y) - log_average)

    average_kl = torch.clamp((kl_x + kl_y) / 2, min=0.0)
    jsd = torch.sqrt(average_kl).sum(dim=1)        # (T,)

    if reduction == 'mean':
        return jsd.mean(dim=0)
    if reduction in ('none', None):
        return jsd
    if reduction == 'sum':
        return jsd.sum(dim=0)
    raise ValueError(f'Reduction method {reduction} not defined')


###############################################################################
# Interpolation
###############################################################################


def interpolate(ppg_x, ppg_y, interp, device=None):
    """Linear interpolation (1 - t) * X + t * Y (ppgs/core.py:477-499);
    ``interp`` a number or per-frame weights."""
    ppg_x = as_tensor(ppg_x, device)
    ppg_y = as_tensor(ppg_y, ppg_x.device)
    if not isinstance(interp, (int, float)):
        interp = as_tensor(interp, ppg_x.device)
    return (1.0 - interp) * ppg_x + interp * ppg_y


###############################################################################
# Sparsification
###############################################################################


def percentile(ppg, q):
    """The per-frame ``q`` quantile over the classes (dim -2), kept as a
    dimension: ``jnp.quantile(ppg, q, axis=-2, keepdims=True)``'s linear
    interpolation in its arithmetic on the CPU, bit for bit. Sorted with
    ``torch.sort``: ``torch.quantile`` takes only fp32 and fp64 (and, over
    a whole tensor, at most 2^24 elements).

    The rank q (n - 1) and the weights are taken in the PPG's dtype. XLA
    contracts an fp32 low (1 - w) + high w into one fused multiply-add (high
    w rounded, then the sum rounded once), which float64 replays exactly,
    since it holds the product low (1 - w) exactly; in bf16 each product
    and the sum round to bf16. The contraction decides a tie: where low ==
    high, the fused form gives that value back, the separately rounded
    one may not."""
    n = ppg.shape[-2]
    rank = torch.tensor(q, dtype=ppg.dtype) * torch.tensor(n - 1,
                                                           dtype=ppg.dtype)
    low, high = torch.floor(rank), torch.ceil(rank)
    high_weight = rank - low
    low_weight = 1 - high_weight
    low = int(min(max(low.item(), 0), n - 1))
    high = int(min(max(high.item(), 0), n - 1))
    ordered = torch.sort(ppg, dim=-2).values
    low_value = ordered[..., low:low + 1, :]
    high_part = ordered[..., high:high + 1, :] * high_weight.to(ppg.device)
    if ppg.dtype == torch.float32:
        return (low_value.double() * low_weight.item()
                + high_part.double()).float()
    return low_value * low_weight.to(ppg.device) + high_part


def sparsify(ppg, method='percentile', threshold=0.85, device=None):
    """Sparsify a (..., P, T) posteriorgram (ppgs/core.py:507-543).

    method='constant':   zero entries <= threshold (absolute probability)
    method='percentile': zero entries <= the per-frame quantile over classes
    method='topk':       keep the top-k classes per frame (threshold = k),
                         and every class tied with the k-th
    Always renormalizes via softmax(log(p + 1e-8)) over the class dim.
    """
    ppg = as_tensor(ppg, device)
    if method in ('constant', 'percentile'):
        if method == 'percentile':
            thresh = percentile(ppg, threshold)
        else:
            thresh = threshold
        ppg = torch.where(ppg > thresh, ppg, 0.0)
    elif method == 'topk':
        k = int(threshold)
        # The k-th largest value per frame along the class dim
        kth = torch.topk(ppg, k, dim=-2).values[..., k - 1:k, :]
        ppg = torch.where(ppg >= kth, ppg, 0.0)
    else:
        raise ValueError(f'Sparsification method {method} is not defined')

    # Renormalize
    return torch.softmax(torch.log(ppg + 1e-8), dim=-2)
