"""greengage_tpu_torch — the PyTorch/CUDA port of greengage_tpu.

The port mirrors the JAX package's module paths (``ops/agg.py`` here is the
counterpart of ``greengage_tpu/ops/agg.py``) and is tested against it on the
same inputs. It imports torch and numpy only, never jax and nothing of
``greengage_tpu``: modules it needs from there are kept as its own copies.

Where the JAX package runs one program per segment under
``shard_map`` over a device mesh, the port keeps the ``nseg`` segments as a
leading tensor axis ``[nseg, cap]`` on one device — the concatenation that
``PartitionSpec("seg")`` gives — so one kernel launch covers every segment.

Torch has native int64 and float64 (no x64 switch) and no compilation cache
to configure. Device choice is explicit: every entry point takes a
``device`` argument, defaults to the GPU, and raises when none is visible;
the CPU runs only when the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> str:
    """The device an entry point runs on when the caller names none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return "cuda"


def resolve_device(device=None) -> torch.device:
    return torch.device(default_device() if device is None else device)
