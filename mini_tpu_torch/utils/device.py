"""Where the port places data: on the card unless the caller asks for the
CPU.

Every entry point that places data (``GraphSlice.from_host``, the model
``*_init`` functions, ``params_from_jax``, ``Frontier.empty``/``full``,
``BandedLayout.dev``, ``time_fn``) takes ``device=None`` and resolves it
here.  ``None`` is the card; without one it raises rather than run on the
CPU unasked.  ``device="cpu"`` runs the plain torch versions (the tests).
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda``; raises ``RuntimeError`` when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mini_tpu_torch runs on a CUDA device by default and none is "
            "available (torch.cuda.is_available() is False); pass "
            'device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
