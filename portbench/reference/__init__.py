"""The benchmark's plain references, one module a model (``<name>.py``
holding ``Model(cfg, precision)``), found by a configuration's
``reference`` key. They import torch alone: nothing of the system under
test."""
from __future__ import annotations

import importlib


def build(cfg: dict, precision: str = "fp32"):
    """The reference model that ``cfg["reference"]`` names, on the CPU, in
    eval mode, its parameters as constructed (load a state dict into it)."""
    module = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    return module.Model(cfg, precision).eval()
