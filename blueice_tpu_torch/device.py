"""Device and dtype policy of the port.

A likelihood compiles onto one torch device: the card unless the caller asks
for the CPU with ``device='cpu'``, never the CPU as a quiet fallback;
float32 on a CUDA device (the kernels' type), float64 on the CPU unless
asked otherwise. On CUDA the
float32 matrix products and convolutions are held to full float32: TF32
keeps about three decimal digits, and the reference lost the XENON profile
statistic to a reduced-precision combine (median t 0.140 -> 0.073).
"""

import torch

__all__ = ['resolve']


def resolve(device=None, dtype=None):
    """(torch.device, torch.dtype) for a compile request.

    :param device: None or 'cuda' / 'cuda:N' / a torch.device for a GPU
      (None: the current CUDA device), 'cpu' for the CPU. A CUDA device
      without CUDA raises.
    :param dtype: None picks float32 on CUDA and float64 on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the CUDA device by default, and CUDA is "
                "not available here: pass device='cpu' to run on the CPU")
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("device %s requested but CUDA is not available"
                               % device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != 'cpu':
        raise ValueError("the port runs on 'cpu' or 'cuda' devices, got %s"
                         % device)
    if dtype is None:
        dtype = torch.float32 if device.type == 'cuda' else torch.float64
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("dtype must be float32 or float64, got %s" % dtype)
    return device, dtype
