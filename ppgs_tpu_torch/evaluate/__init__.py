"""Evaluation: the metric accumulators (``metrics``); the evaluation
entry points are not ported yet (ROADMAP.md A9)."""

from . import metrics
