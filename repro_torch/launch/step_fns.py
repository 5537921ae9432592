"""Step functions: the entry points the launcher and the smoke run drive
(the port of ``repro.launch.step_fns``).  PyTorch runs eagerly, so each is
the plain function the reference hands to ``jax.jit``."""
from __future__ import annotations

from repro_torch.core.substrate import not_ported
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def make_train_step(cfg: ModelConfig, **_):
    raise not_ported("make_train_step", "Queue 1, training and "
                     "distribution")


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, _ = transformer.forward(params, cfg, batch)
        return logits
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def step(params, cache, tokens, pos):
        return transformer.serve_step(params, cfg, cache, tokens, pos)
    return step
