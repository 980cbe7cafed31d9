"""A guard for the backward of a custom autograd function that has no rule
for the next order.

``torch.autograd.function.once_differentiable`` does not raise on its own
when a higher-order pass asks ``torch.autograd.grad`` for the gradient of
some inputs: it hangs an error node off detached copies of the outputs,
which that pass prunes, so the terms through the function are dropped
without a word.  :func:`last_order` raises instead, at the backward itself,
whenever it runs with gradients recorded (``create_graph=True``).
"""
from __future__ import annotations

import functools

import torch


def last_order(what: str):
    """Decorates a ``backward`` (a staticmethod's function) so that it
    raises ``NotImplementedError`` naming ``what`` when called with grad
    mode on, i.e. in a pass that would differentiate it once more; a plain
    backward runs as before."""
    def wrap(backward):
        @functools.wraps(backward)
        def guarded(ctx, *grads):
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    f"{what} has no rule for a higher-order gradient "
                    "(create_graph=True through it is not ported)")
            return backward(ctx, *grads)
        return guarded
    return wrap
