"""Evaluation: the metric accumulators (``metrics``) and the evaluation of
datasets' test partitions (``datasets``)."""

from . import metrics
from .core import datasets
from .metrics import Metrics
