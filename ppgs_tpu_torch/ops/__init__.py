"""Tensor ops: masking, the mel frontend, the Philox dropout stream, and the
encoder's kernel wrappers for inference and training (each beside its plain
PyTorch version)."""
