"""Device selection shared by the port's entry points, and the card's
facts the kernels' launch plans read."""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA device.  There is no silent fallback: with no
    CUDA device the caller must ask for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


SMEM_PER_SM = 228 * 1024      # H100: shared memory of an SM
SMEM_PER_CTA_RESERVED = 1024  # what the card reserves for each CTA


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
