"""Device resolution for the port's public entry points."""

import torch


def init_device(device):
    """Return `torch.device(device)`.  For a CUDA device, check that a card
    is present (a missing card is an error, never a quiet CPU run) and
    turn TF32 off: float32 products then run in full float32, which the
    precision='SP' results and the kernel tolerances assume."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device=%r was requested but "
                               "torch.cuda.is_available() is False" % (device,))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
