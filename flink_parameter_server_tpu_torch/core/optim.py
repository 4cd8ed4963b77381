"""Optimizer factories with optax's defaults.

The reference hands ``DenseParameterServer`` an optax
``GradientTransformation`` (``optax.adamw(lr)``, ``optax.adam(lr)``,
``optax.sgd(lr)``).  Here each factory returns a function from parameters
to a ``torch.optim`` optimizer configured as optax configures its own:

* ``adamw``: ``weight_decay=1e-4`` (torch's default is 1e-2), decoupled
  and applied to every parameter, norm gains included (optax masks none);
  ``eps`` added outside the square root, no ``eps_root``.
* ``adam``: the same without decay.
* ``sgd``: plain ``p -= lr·g``, with optax's optional (Nesterov) momentum
  trace, which matches torch's with no dampening.

Moments take the parameter's dtype in both libraries.  The update is the
same formula in both; float32 results agree to rounding.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)

    return make


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerFactory:
    def make(params):
        return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=0.0)

    return make


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> OptimizerFactory:
    def make(params):
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum or 0.0,
                               nesterov=nesterov)

    return make


__all__ = ["OptimizerFactory", "adamw", "adam", "sgd"]
