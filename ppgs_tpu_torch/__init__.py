"""ppgs_tpu_torch: the PyTorch/CUDA port of ppgs_tpu for NVIDIA Hopper.

Phonetic posteriorgrams on an H100: the mel, w2v2fb (wav2vec2-base) and
bottleneck (ESPnet conformer) frontends, the transformer model, the
inference API and single-device training, with every TPU kernel of the JAX
package rewritten by hand in CUDA C++ (``kernels/csrc``). The JAX package ``ppgs_tpu`` is the
reference this package is tested against; this package never imports it
(nor JAX). What is ported so far, and what is still to come, is listed in
ROADMAP.md.
"""

from . import config
from .config import Config
from .phonemes import (
    PHONEMES,
    PHONEME_TO_INDEX_MAPPING,
    NUM_PHONEMES,
    VOICED,
    CHARSIU_PERMUTE,
    TIMIT_TO_ARCTIC_MAPPING,
    SILENCE,
)
from . import convert
from . import evaluate
from . import kernels
from . import load
from . import models
from . import ops
from . import preprocess
from . import train
from .core import (
    from_audio,
    from_features,
    from_file,
    from_file_to_file,
    infer,
    resample,
)

__version__ = '0.1.0'
