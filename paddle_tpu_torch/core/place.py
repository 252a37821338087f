"""Device places.

Reference parity: paddle/platform/place.h (CPUPlace / CUDAPlace), as
paddle_tpu/core/place.py carries them.  Here a place is a
``torch.device``.  The card is the default, and asking for it on a host
without CUDA raises: nothing falls back to the CPU unless the caller asks
for the CPU.
"""
import torch

__all__ = ['CPUPlace', 'CUDAPlace', 'default_place', 'resolve_device']


def CPUPlace():
    return torch.device('cpu')


def CUDAPlace(device_id=0):
    """``torch.device('cuda', device_id)``; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDAPlace(%d) asked for, but torch sees no CUDA device; pass "
            "device='cpu' to run on the CPU" % device_id)
    if not 0 <= device_id < torch.cuda.device_count():
        raise ValueError("no CUDA device %d (%d present)"
                         % (device_id, torch.cuda.device_count()))
    return torch.device('cuda', device_id)


def default_place():
    """The default place: CUDA device 0.  Raises when no card is present."""
    return CUDAPlace(0)


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means the default place."""
    if device is None:
        return default_place()
    device = torch.device(device)
    if device.type == 'cuda':
        return CUDAPlace(0 if device.index is None else device.index)
    if device.type != 'cpu':
        raise ValueError("unsupported device %s (cuda or cpu)" % device)
    return device
