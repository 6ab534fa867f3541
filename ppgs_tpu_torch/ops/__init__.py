"""Tensor ops: masking, the mel frontend, and the encoder's kernel wrappers
(each beside its plain PyTorch version)."""
