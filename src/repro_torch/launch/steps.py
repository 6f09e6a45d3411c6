"""Step functions of the server: ``prefill_step`` and ``serve_step``.

The reference jit-compiles these; PyTorch runs them eagerly.  Training's
``train_step`` comes with the training slice of the port.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import transformer as tf


def make_prefill_step(cfg) -> Callable:
    def prefill_step(params, batch):
        logits, caches, _ = tf.forward(params, batch["tokens"], cfg,
                                       collect_cache=True, last_logit_only=True)
        return logits, caches

    return prefill_step


def make_serve_step(cfg) -> Callable:
    def serve_step(params, tokens, caches, pos):
        return tf.decode_step(params, tokens, caches, pos, cfg)

    return serve_step
