"""Seeding and RNG state (counterpart of ``pytorch_toolbelt_tpu/utils/random_utils.py``).

``set_manual_seed`` seeds python, numpy and torch (CPU and every CUDA
device) and returns a seeded ``torch.Generator``, where the JAX version
returns a PRNGKey for the caller to thread.  ``get_rng_state`` holds only
python numbers, lists and tensors, so a checkpoint that holds it loads with
``torch.load(weights_only=True)``.
"""

import random
from typing import Dict

import numpy as np
import torch

from .namesgenerator import get_random_name

__all__ = ["set_manual_seed", "get_random_name", "get_rng_state", "set_rng_state"]


def set_manual_seed(seed: int) -> torch.Generator:
    """Seed python's, numpy's and torch's global RNGs; return a CPU
    ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.cuda.manual_seed_all(seed)  # deferred until CUDA starts; a no-op without a card
    return torch.Generator().manual_seed(seed)


def get_rng_state() -> Dict:
    """The python, numpy, torch CPU and (once CUDA has started) per-device
    CUDA generator states."""
    version, internal, gauss_next = random.getstate()
    kind, keys, pos, has_gauss, cached_gaussian = np.random.get_state()
    state = {
        "python": [version, list(internal), gauss_next],
        "numpy": [kind, torch.from_numpy(keys.astype(np.int64)), int(pos), int(has_gauss), float(cached_gaussian)],
        "torch": torch.get_rng_state(),
    }
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state_all()
    return state


def set_rng_state(state: Dict) -> None:
    """Restore what :func:`get_rng_state` captured, exactly."""
    version, internal, gauss_next = state["python"]
    random.setstate((version, tuple(internal), gauss_next))
    kind, keys, pos, has_gauss, cached_gaussian = state["numpy"]
    np.random.set_state((kind, keys.numpy().astype(np.uint32), pos, has_gauss, cached_gaussian))
    torch.set_rng_state(state["torch"])
    if "cuda" in state:
        torch.cuda.set_rng_state_all(state["cuda"])
