"""The system under test: the entry points of ``crop2seg_tpu_torch`` that a
cell's window drives. Only this module of the benchmark imports the
program."""
from __future__ import annotations

import torch

from crop2seg_tpu_torch.inference.tile import make_tile_predictor
from crop2seg_tpu_torch.learning.trainer import StepConfig, create_train_state, make_train_step
from crop2seg_tpu_torch.models.factory import get_model


def build_model(cfg: dict, state: dict, device) -> torch.nn.Module:
    """The factory's model for ``cfg`` on ``device``, the benchmark's state
    dict loaded into it."""
    model = get_model(cfg, device=device)
    model.load_state_dict(state)
    return model


def tile_predictor(cfg: dict, state: dict, mix: dict, device):
    """``predict(tile, dates, length) -> {"proba", "classes"}``, the
    webapp's whole-tile entry at the configuration's dtype."""
    model = build_model(cfg, state, device)
    return make_tile_predictor(model, batch_size=mix["batch_size"], device=device,
                               dtype=getattr(torch, cfg["dtype"]))


def train_step(cfg: dict, state: dict, mix: dict, device):
    """``step(batch, generator) -> aux``, the trainer's step at the
    configuration's dtype with Adam at the mix's rate, and its model
    (``step.optimizer`` holds the Adam state)."""
    model = build_model(cfg, state, device)
    weights = tuple(0.0 if k == mix["ignore_class"] else 1.0 for k in range(mix["classes"]))
    step_cfg = StepConfig(num_classes=mix["classes"], ignore_index=mix["ignore_class"],
                          class_weights=weights)
    step = make_train_step(model, step_cfg, create_train_state(model, mix["lr"]),
                           device=device, dtype=getattr(torch, cfg["dtype"]))
    return step, model
