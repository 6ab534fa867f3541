"""The device rule of the public entry points.

Every entry point takes ``device``: None means 'cuda', and without a CUDA
device the call raises instead of running on the CPU; the CPU is used only
when the caller names it (``device='cpu'``).
"""

import torch


def resolve(device=None):
    """The torch device for an entry point: 'cuda' unless the caller names
    one; raise when CUDA is asked for and absent."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'ppgs_tpu_torch runs on a CUDA device by default and none '
                "is available; pass device='cpu' to run on the CPU")
        # fp32 products and convs in full fp32: cuDNN would run fp32 convs
        # in TF32 by default (the mel frontend and the model's convs)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
