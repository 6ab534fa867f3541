from . import audio, stats, textgrid
from . import download
from . import datasets as datasets
from .collate import Collate
from .dataset import Dataset, Metadata
from .loader import Loader, loader
from .sampler import Sampler, SequentialSampler, sampler
