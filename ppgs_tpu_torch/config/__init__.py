"""Configuration system (copy of the JAX package's registry).

Configuration is a frozen dataclass: functions take an explicit ``config``
argument, and a module-level default can be swapped with ``use(name)``.
The fields and the named experiment configs are identical to
``ppgs_tpu.config``, so one name selects the same hyperparameters in both
packages.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple


###############################################################################
# Config dataclass
###############################################################################


@dataclasses.dataclass(frozen=True)
class Config:
    """All hyperparameters (reference: ppgs/config/defaults.py:1-214)."""

    # Metadata
    config: str = 'ppgs'

    # Audio parameters
    hopsize: int = 160              # samples
    num_fft: int = 1024
    num_mels: int = 80
    sample_rate: int = 16000
    window_size: int = 1024

    # Data parameters
    all_features: Tuple[str, ...] = ('audio', 'phonemes')
    all_representations: Tuple[str, ...] = (
        'bottleneck', 'w2v2fb', 'w2v2fc', 'mel', 'encodec')
    datasets: Tuple[str, ...] = ('commonvoice', 'arctic', 'timit')
    best_representation: str = 'mel'
    representation: str = 'mel'
    representation_kind: str = 'ppg'    # One of ['ppg', 'latents']
    training_dataset: str = 'commonvoice'

    # Logging parameters
    checkpoint_interval: int = 25000    # steps
    default_evaluation_steps: int = 16
    evaluation_interval: int = 1000     # steps

    # Model parameters
    local_checkpoint: Optional[str] = None
    attention_heads: int = 2
    attention_window_size: int = 4      # unused (parity with reference)
    is_causal: bool = False
    frontend: Optional[str] = None      # name of a codebook frontend, if any
    hidden_channels: int = 256
    input_channels: int = 80
    kernel_size: int = 5
    model: str = 'transformer'          # ['convolution', 'transformer',
                                        #  'W2V2FC', 'Wav2Vec2.0']
    num_hidden_layers: int = 5
    output_channels: int = 40
    chunk_overlap: int = 50             # context overlap between chunks
    chunk_length: int = 500             # maximum frames in a chunk
    ffn_channels: int = 2048            # torch TransformerEncoderLayer default
    dropout: float = 0.1
    max_len: int = 5000                 # positional encoding table length

    # Training parameters
    buckets: int = 1
    class_balanced: bool = False
    gradient_clip_threshold_inf: Optional[float] = None
    gradient_clip_threshold_l2: Optional[float] = None
    learning_rate: float = 2e-4
    max_training_frames: int = 150000
    max_preprocess_frames: int = 10000
    max_inference_frames: int = 100000  # reference: inf; finite for batching
    steps: int = 500000
    num_workers: int = 8
    random_seed: int = 1234

    # Distance parameters
    similarity_exponent: float = 1.2

    # Accelerator parameters (no reference equivalent; the names are the
    # JAX package's, kept so that both packages read one registry)
    batched_test_eval: bool = True      # frame-budget test batches (exact;
                                        # False = reference batch-1 parity)
    remat: bool = False                 # rematerialize encoder layers in
                                        # the backward pass (trade FLOPs
                                        # for activation HBM at large
                                        # frame budgets)
    compute_dtype: str = 'bfloat16'     # matmul dtype inside the encoder
    param_dtype: str = 'float32'
    checkpoint_backend: str = 'npz'     # 'npz' | 'orbax' (async saves)
    mesh_shape: Tuple[int, ...] = (-1,)     # data-parallel axis by default
    mesh_axis_names: Tuple[str, ...] = ('data',)

    # Derived properties ------------------------------------------------

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hopsize

    def replace(self, **kwargs) -> 'Config':
        return dataclasses.replace(self, **kwargs)


###############################################################################
# Directories (host-side; overridable via environment)
###############################################################################


ROOT_DIR = Path(os.environ.get('PPGS_ROOT_DIR', Path(__file__).parents[2]))
# Assets are shared with the JAX package and read by path
ASSETS_DIR = Path(__file__).parents[2] / 'ppgs_tpu' / 'assets'
SOURCES_DIR = ROOT_DIR / 'data' / 'sources'
CACHE_DIR = ROOT_DIR / 'data' / 'cache'
DATA_DIR = ROOT_DIR / 'data' / 'datasets'
EVAL_DIR = ROOT_DIR / 'eval'
RUNS_DIR = ROOT_DIR / 'runs'
CHECKPOINT_DIR = ASSETS_DIR / 'checkpoints'
PARTITION_DIR = ASSETS_DIR / 'partitions'
SIMILARITY_MATRIX_PATH = ASSETS_DIR / 'balanced_similarity.npz'
CLASS_WEIGHT_FILE = ASSETS_DIR / 'phoneme_weights.npz'


###############################################################################
# Named experiment configs (reference: config/*.py)
###############################################################################


def _registry() -> dict:
    base = Config()
    return {
        'ppgs': base,
        'mel': base.replace(config='mel', representation='mel',
                            input_channels=80),
        'w2v2fb': base.replace(config='w2v2fb', representation='w2v2fb',
                               input_channels=768, hidden_channels=512,
                               steps=1000000),
        'w2v2fc': base.replace(config='w2v2fc', representation='w2v2fc',
                               input_channels=768, hidden_channels=512),
        'w2v2fc-pretrained': base.replace(
            config='w2v2fc-pretrained', representation='w2v2fc',
            model='W2V2FC'),
        'w2v2ft': base.replace(config='w2v2ft', representation='wav',
                               model='Wav2Vec2.0'),
        'bottleneck': base.replace(config='bottleneck',
                                   representation='bottleneck',
                                   input_channels=144),
        'encodec': base.replace(config='encodec', representation='encodec',
                                input_channels=128, frontend='encodec'),
        'dac': base.replace(config='dac', representation='dac',
                            input_channels=96, frontend='dac'),
        'balanced': base.replace(config='balanced', class_balanced=True),
        'causal_transformer': base.replace(config='causal_transformer',
                                           is_causal=True),
        'convolution': base.replace(config='convolution',
                                    model='convolution'),
    }


REGISTRY = _registry()

# Inference-time hyperparameters used when loading the published w2v2fb
# checkpoint (reference: ppgs/config/w2v2fb.py, used at ppgs/load.py:36-42)
W2V2FB_INFERENCE = REGISTRY['w2v2fb']

_default = REGISTRY['ppgs']


def get(name: Optional[str] = None) -> Config:
    """Look up a named config; None returns the current default."""
    if name is None:
        return _default
    if isinstance(name, Config):
        return name
    return REGISTRY[name]


def use(name: str) -> Config:
    """Set the module default config (CLI --config parity)."""
    global _default
    _default = get(name)
    return _default


def default() -> Config:
    return _default

