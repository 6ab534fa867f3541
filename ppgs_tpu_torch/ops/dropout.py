"""Counter-based dropout masks: Philox4x32-10, one stream for every site.

Counterpart of the JAX package's in-kernel dropout streams:
``_Stream`` (``ppgs_tpu/ops/encoder_layer_train.py:58-82``),
``_dropout_keep`` (``ppgs_tpu/ops/flash_attention.py:420-435``) and
``_keep_bits``/``_train_keys`` (``ppgs_tpu/ops/fused_ffn.py:116-132``),
and of the ``jax.random.bernoulli`` sites of the XLA train path. Those
draw from the TPU's hardware generator (threefry in interpret mode), in an
order tied to each kernel's blocks; their bits cannot be reproduced here,
and the port does not try: tests compare the port's masks with
themselves, or run at rate 0.

Here the keep bit of an element is a pure function of
``(seed, site, flat element index)``:

    bits = philox4x32_10(counter=(g_lo, g_hi, site, 0),
                         key=(seed_lo, seed_hi))[index % 4],
    g = index // 4,    keep = bits >= threshold(rate)

The flat index is the row-major index of the element in the array the
site drops from, batch first, so a mask does not depend on how a kernel
tiles the work, and the leading rows of a batch draw the same bits
whatever the batch size. Sites number the random draws of one forward
pass. The PPG transformer's (``site``): 0 is the positional encoding,
layer i owns 1 + 4i (attention probabilities), 2 + 4i (attention
output), 3 + 4i (FFN hidden) and 4 + 4i (FFN output). The whole-layer
kernel and the per-layer path use the same sites, so both drop the same
elements; so do the CUDA kernels (``kernels/csrc/philox.cuh``) and the
plain version here, which carries the uint32 arithmetic in int64.

wav2vec2's train mode (``w2v2_site``, the JAX package's
``jax.random.split`` streams of ``ppgs_tpu/models/w2v2.py:374-536``)
numbers its sites from ``W2V2_SITES`` = 2^20 on:

    2^20 + 0        the feature projection's output (feat_proj_dropout)
    2^20 + 1        spec-augment's span starts (B x num draws, row-major)
    2^20 + 2        the hidden state after the positional conv
    2^20 + 3 + 5i   layer i's attention probabilities
    2^20 + 4 + 5i   layer i's attention output
    2^20 + 5 + 5i   layer i's activation (the FFN hidden)
    2^20 + 6 + 5i   layer i's FFN output
    2^20 + 7 + 5i   layer i's LayerDrop draw (one element)

The pipeline's stage bodies (``parallel/pipeline.py``) key a layer's four
sites by the global (layer, microbatch) from ``PIPELINE_SITES`` = 2^22 on
(``pipeline_site``): 2^22 + 4 (layer M + microbatch) + 0 ... 3 for M
microbatches, so that the masks do not depend on the stage count.

A span start is ``(bits * hi) >> 32`` for the row's ``hi`` valid starts,
and a layer is kept when its one draw is at least ``threshold(layerdrop)``
(JAX's ``uniform >= layerdrop``).
"""

from typing import NamedTuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57        # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
ROUNDS = 10
_U32 = 0xFFFFFFFF


def site(layer, kind):
    """The site number of dropout point ``kind`` of encoder layer
    ``layer``: 'probs', 'attention', 'hidden' or 'output'."""
    return 1 + 4 * layer + ('probs', 'attention', 'hidden',
                            'output').index(kind)


PE_SITE = 0

PIPELINE_SITES = 1 << 22


def pipeline_site(layer, microbatch, microbatches):
    """The first of layer ``layer``'s four sites (probabilities,
    attention output, FFN hidden, FFN output) for microbatch
    ``microbatch`` of ``microbatches`` in a pipelined forward."""
    return PIPELINE_SITES + 4 * (layer * microbatches + microbatch)

W2V2_SITES = 1 << 20
_W2V2_GLOBAL = ('projection', 'spec_augment', 'pos_conv')
_W2V2_LAYER = ('probs', 'attention', 'activation', 'output', 'layerdrop')


def w2v2_site(kind, layer=None):
    """The site number of wav2vec2's draw ``kind``: 'projection',
    'spec_augment' or 'pos_conv', or with ``layer`` one of encoder layer
    ``layer``'s: 'probs', 'attention', 'activation', 'output' or
    'layerdrop'."""
    if layer is None:
        return W2V2_SITES + _W2V2_GLOBAL.index(kind)
    return W2V2_SITES + len(_W2V2_GLOBAL) + len(_W2V2_LAYER) * layer + (
        _W2V2_LAYER.index(kind))


def threshold(rate):
    """The uint32 below which a draw drops its element."""
    return min(int(float(rate) * 4294967296.0), _U32)


def seed_words(seed):
    """(lo, hi) uint32 words of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _U32, seed >> 32


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of a * m for uint32 a (int64 tensor) and the
    constant m, without leaving int64: m is split in 16-bit halves."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    x = a * m_hi                      # < 2^48
    y = a * m_lo                      # < 2^48
    hi = (x + (y >> 16)) >> 16
    lo = ((x & 0xFFFF) << 16) + y
    return hi & _U32, lo & _U32


def philox(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 words.

    counter: four broadcastable tensors (c0, c1, c2, c3); key: (k0, k1)
    ints. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & _U32, (k1 + W1) & _U32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits(numel, seed, site_id, device=None, first=0):
    """The uint32 draws (int64 tensor) of the flat indices first ..
    first + numel - 1 (``first`` a multiple of 4)."""
    if first % 4:
        raise ValueError(f'first must be a multiple of 4, got {first}')
    groups = (numel + 3) // 4
    g = torch.arange(first // 4, first // 4 + groups, dtype=torch.int64,
                     device=device)
    lo, hi = seed_words(seed)
    words = philox((g & _U32, g >> 32, torch.full_like(g, int(site_id)),
                    torch.zeros_like(g)), (lo, hi))
    return torch.stack(words, dim=1).reshape(-1)[:numel]


KEEP_CHUNK = 1 << 26    # elements a pass of keep_mask draws at most


def keep_mask(shape, seed, site_id, rate, device=None):
    """Bool keep-mask of ``shape``: True where the element is kept. The
    draws are made ``KEEP_CHUNK`` elements at a time, so that the int64
    words of a large mask (wav2vec2's B x 12 x T x T probabilities) never
    exist at once."""
    shape = tuple(shape)
    numel = 1
    for n in shape:
        numel *= n
    keep = torch.empty(numel, dtype=torch.bool, device=device)
    for first in range(0, numel, KEEP_CHUNK):
        n = min(KEEP_CHUNK, numel - first)
        keep[first:first + n] = bits(n, seed, site_id, device,
                                     first) >= threshold(rate)
    return keep.reshape(shape)


class Drop(NamedTuple):
    """One dropout site of one step: what a kernel and its plain version
    need to draw the site's mask."""

    seed: int
    site: int
    rate: float

    @property
    def on(self):
        return self.rate > 0.0

    @property
    def scale(self):
        return 1.0 / (1.0 - self.rate) if self.on else 1.0

    def c_args(self):
        """(seed_lo, seed_hi, site, threshold, scale) for a CUDA entry."""
        lo, hi = seed_words(self.seed)
        return (lo, hi, int(self.site), threshold(self.rate) if self.on
                else 0, float(self.scale))

    def keep(self, shape, device=None):
        """The bool keep-mask of the site's array of ``shape``."""
        return keep_mask(shape, self.seed, self.site, self.rate, device)

    def at(self, site_id):
        return self._replace(site=site_id)


OFF = Drop(0, 0, 0.0)    # no dropout: what a kernel takes for a site it skips


def dropout(x, seed, site_id, rate):
    """Plain dropout of ``x`` on the Philox stream: kept elements scaled by
    1 / (1 - rate), dropped ones 0; identity at rate 0 (differentiable)."""
    if rate <= 0.0:
        return x
    keep = keep_mask(x.shape, seed, site_id, rate, x.device)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))
