"""Reproducibility helper (reference `src/utils/seed.py:9-14`).

The trainer threads explicit `torch.Generator`s through every draw of a
step; this seeds the ambient generators that host-side code may still use
(python `random`, numpy, torch's global CPU and CUDA generators).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

__all__ = ["set_seed"]


def set_seed(seed: int = 42) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)  # seeds the CUDA generators too, lazily
