"""The optimizers of the JAX factory other than AdamW, written from optax's
update rules one parameter at a time.

↔ ``amcontrast3d_tpu/optim/__init__.py:39-133`` (optax's ``adam``, ``sgd``,
``radam``, ``adabelief``, ``adafactor``, ``lamb``, ``lars``, ``nadam``,
``novograd``, ``rmsprop`` and ``lion`` in optax 0.2.6, with the factory's
arguments) and ``amcontrast3d_tpu/optim/extras.py`` (``adamp``, ``sgdp``,
``madgrad``, ``lookahead``, ``scale_by_layer_decay``, ``vit_layer_id``).
These are optax's rules, not the ``torch.optim`` classes of the same
names, which differ: optax's ``rmsprop`` takes ``eps`` inside the square
root, its ``nadam`` has no momentum-decay schedule, its ``radam`` its own
rectification threshold, and its chains put a coupled L2 term
(``add_decayed_weights``) ahead of the adam and sgd family.

:class:`Chain` is the ``torch.optim.Optimizer`` that runs a rule.  A rule
maps (parameter, gradient, the parameter's state dict, the step's
learning rate) to optax's additive update, which already holds the rate
and the sign.  Every float32 step follows optax's expression, the bias
corrections ``1 − β^t`` included (in float32, as optax computes them), so
a step lands within rounding of optax's.  The decay mask is optax's
``ndim > 1``; a port Linear's weight is the transpose of the flax kernel,
which only :func:`adafactor`'s factoring reads, so it factors the
transpose.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# (parameter, gradient, state, learning rate) → update
Rule = Callable[[torch.Tensor, torch.Tensor, Dict, float], torch.Tensor]


def _bias_correction(decay: float, count: int) -> float:
    """``1 − decay^count`` in float32 (optax's ``tree_bias_correction``)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _decayed(p: torch.Tensor, g: torch.Tensor, weight_decay: float
             ) -> torch.Tensor:
    """``add_decayed_weights`` under the factory's mask (``ndim > 1``)."""
    if not weight_decay or p.ndim <= 1:
        return g
    return torch.add(g, p, alpha=weight_decay)


def _count(st: Dict) -> int:
    """The rule's step count after this update (optax's ``count_inc``)."""
    st["count"] = st.get("count", 0) + 1
    return st["count"]


def _moments(st: Dict, g: torch.Tensor, b1: float, b2: float):
    """optax's ``update_moment`` of the first and second moments."""
    mu = st.get("mu", torch.zeros_like(g))
    nu = st.get("nu", torch.zeros_like(g))
    st["mu"] = (1 - b1) * g + b1 * mu
    st["nu"] = (1 - b2) * (g * g) + b2 * nu
    return st["mu"], st["nu"]


def _trust_ratio(p: torch.Tensor, u: torch.Tensor,
                 coefficient: float = 1.0, eps: float = 0.0) -> torch.Tensor:
    """optax's ``scale_by_trust_ratio`` (no minimum norm)."""
    pn = torch.linalg.vector_norm(p)
    un = torch.linalg.vector_norm(u)
    ratio = coefficient * pn / (un + eps)
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)
    return u * ratio


def _trace(st: Dict, u: torch.Tensor, decay: float, nesterov: bool,
           key: str = "trace") -> torch.Tensor:
    """optax's ``trace``: t = u + decay·t, the update t (nesterov: u +
    decay·t)."""
    t = u + decay * st.get(key, torch.zeros_like(u))
    st[key] = t
    return u + decay * t if nesterov else t


def scale_by_adam(b1: float, b2: float, eps: float, eps_root: float = 0.0,
                  nesterov: bool = False) -> Rule:
    def rule(p, g, st, lr):
        mu, nu = _moments(st, g, b1, b2)
        t = _count(st)
        if nesterov:
            mu_hat = (b1 * (mu / _bias_correction(b1, t + 1))
                      + (1 - b1) * (g / _bias_correction(b1, t)))
        else:
            mu_hat = mu / _bias_correction(b1, t)
        nu_hat = nu / _bias_correction(b2, t)
        return mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
    return rule


def scale_by_radam(b1: float, b2: float, eps: float,
                   threshold: float = 5.0) -> Rule:
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def rule(p, g, st, lr):
        mu, nu = _moments(st, g, b1, b2)
        t = _count(st)
        b2t = np.float32(b2) ** np.float32(t)
        ro = np.float32(ro_inf) - np.float32(2) * np.float32(t) * b2t \
            / (np.float32(1) - b2t)
        mu_hat = mu / _bias_correction(b1, t)
        if ro < threshold:
            return mu_hat
        r = np.sqrt((ro - np.float32(4)) * (ro - np.float32(2))
                    * np.float32(ro_inf)
                    / (np.float32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        nu_hat = nu / _bias_correction(b2, t)
        return float(r) * mu_hat / (torch.sqrt(nu_hat) + eps)
    return rule


def scale_by_belief(b1: float, b2: float, eps: float,
                    eps_root: float = 1e-16) -> Rule:
    def rule(p, g, st, lr):
        mu = (1 - b1) * g + b1 * st.get("mu", torch.zeros_like(g))
        err = g - mu
        nu = (1 - b2) * (err * err) + b2 * st.get("nu", torch.zeros_like(g))
        nu = nu + eps_root
        st["mu"], st["nu"] = mu, nu
        t = _count(st)
        return (mu / _bias_correction(b1, t)) / (
            torch.sqrt(nu / _bias_correction(b2, t)) + eps)
    return rule


def scale_by_rms(decay: float, eps: float) -> Rule:
    """optax's ``scale_by_rms`` (``eps_in_sqrt``, no bias correction)."""
    def rule(p, g, st, lr):
        nu = (1 - decay) * (g * g) + decay * st.get("nu", torch.zeros_like(g))
        st["nu"] = nu
        return torch.rsqrt(nu + eps) * g
    return rule


def scale_by_lion(b1: float = 0.9, b2: float = 0.99) -> Rule:
    def rule(p, g, st, lr):
        mu = st.get("mu", torch.zeros_like(g))
        u = torch.sign((1.0 - b1) * g + b1 * mu)
        st["mu"] = (1 - b2) * g + b2 * mu
        _count(st)
        return u
    return rule


def scale_by_novograd(b1: float, b2: float, eps: float,
                      weight_decay: float) -> Rule:
    """optax's layer-wise ``scale_by_novograd``; the decay reaches every
    parameter (the factory gives it no mask)."""
    def rule(p, g, st, lr):
        t = _count(st)
        sq = torch.linalg.vector_norm(g) ** 2
        nu = sq if t == 1 else (1 - b2) * sq + b2 * st["nu"]
        u = g / (torch.sqrt(nu) + eps) + weight_decay * p
        st["nu"] = nu
        st["mu"] = u if t == 1 else b1 * st["mu"] + u
        return st["mu"]
    return rule


def adafactor(weight_decay_rate: Optional[float], decay_rate: float = 0.8,
              min_dim_size_to_factor: int = 128, eps: float = 1e-30,
              clipping_threshold: float = 1.0, min_scale: float = 1e-3
              ) -> Rule:
    """optax's ``adafactor`` at its defaults, whole (the factored second
    moments, the block-RMS clip, the rate, the parameter's RMS scale, the
    decay on every parameter, the sign); a 2-D parameter is factored in
    the flax kernel's layout (the port's weight transposed)."""
    def rule(p, g, st, lr):
        flip = p.ndim == 2
        gk, pk = (g.t(), p.t()) if flip else (g, p)
        t = st.get("count", 0)
        decay = float(np.float32(1.0) - np.float32(t + 1) ** np.float32(-decay_rate))
        shape = gk.shape
        g2 = gk * gk + eps
        dims = None
        if gk.ndim >= 2:
            order = np.argsort(shape, kind="stable")
            if shape[order[-2]] >= min_dim_size_to_factor:
                dims = int(order[-2]), int(order[-1])
        if dims is not None:
            d1, d0 = dims
            vr = decay * st.get("v_row", 0.0) + (1.0 - decay) * g2.mean(d0)
            vc = decay * st.get("v_col", 0.0) + (1.0 - decay) * g2.mean(d1)
            st["v_row"], st["v_col"] = vr, vc
            rd1 = d1 - 1 if d1 > d0 else d1
            row = (vr / vr.mean(rd1, keepdim=True)) ** -0.5
            u = gk * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
        else:
            v = decay * st.get("v", 0.0) + (1.0 - decay) * g2
            st["v"] = v
            u = gk * v ** -0.5
        st["count"] = t + 1
        u = u / torch.clamp_min(torch.sqrt((u * u).mean()) / clipping_threshold,
                                1.0)
        u = lr * u
        rms = torch.sqrt((pk * pk).mean())
        u = u * torch.where(rms <= min_scale, torch.full_like(rms, min_scale),
                            rms)
        if weight_decay_rate is not None:
            u = u + weight_decay_rate * pk
        u = -1 * u
        return u.t() if flip else u
    return rule


# ---------------------------------------------------------------------------
# the vendored optimizers of the reference, as the JAX package writes them
# ---------------------------------------------------------------------------

def _row_cosine_max(x2d: torch.Tensor, y2d: torch.Tensor, eps: float):
    dot = (x2d * y2d).sum(1)
    denom = torch.clamp_min(torch.linalg.vector_norm(x2d, dim=1)
                            * torch.linalg.vector_norm(y2d, dim=1), eps)
    return (dot.abs() / denom).max()


def _projection(p, grad, perturb, delta: float, wd_ratio: float, eps: float):
    """↔ ``extras.py::_projection``: project the perturbation onto the
    tangent space of ``p`` in the channel view, else the layer view, where
    the gradient is (near-)orthogonal to the weight there, and shrink the
    weight decay by ``wd_ratio``.  A port weight is the transpose of the
    flax kernel, so the views read the transpose."""
    if p.ndim <= 1:
        return perturb, 1.0
    flip = p.ndim == 2
    pk, gk, uk = (p.t(), grad.t(), perturb.t()) if flip else (p, grad, perturb)
    expand = (-1,) + (1,) * (pk.ndim - 1)
    views = (lambda x: x.reshape(x.shape[0], -1), lambda x: x.reshape(1, -1))
    for view in views:
        n_col = view(pk).shape[1]
        if _row_cosine_max(view(gk), view(pk), eps) < delta / math.sqrt(n_col):
            p_n = pk / (torch.linalg.vector_norm(view(pk), dim=1)
                        + eps).reshape(expand)
            coeff = view(p_n * uk).sum(1).reshape(expand)
            out = uk - p_n * coeff
            return (out.t() if flip else out), wd_ratio
    return perturb, 1.0


def adamp(b1: float, b2: float, eps: float, weight_decay: float,
          delta: float, wd_ratio: float, nesterov: bool) -> Rule:
    def rule(p, g, st, lr):
        mu, nu = _moments(st, g, b1, b2)
        t = _count(st)
        denom = torch.sqrt(nu) / math.sqrt(_bias_correction(b2, t)) + eps
        perturb = ((b1 * mu + (1 - b1) * g) / denom) if nesterov \
            else mu / denom
        perturb, wd = _projection(p, g, perturb, delta, wd_ratio, eps)
        u = -(lr / _bias_correction(b1, t)) * perturb
        if weight_decay > 0 and p.ndim > 1:
            u = u - lr * weight_decay * wd * p
        return u
    return rule


def sgdp(momentum: float, dampening: float, weight_decay: float,
         nesterov: bool, eps: float, delta: float, wd_ratio: float) -> Rule:
    def rule(p, g, st, lr):
        b = momentum * st.get("momentum", torch.zeros_like(g)) \
            + (1.0 - dampening) * g
        d_p = (g + momentum * b) if nesterov else b
        d_p, wd = _projection(p, g, d_p, delta, wd_ratio, eps)
        # the reference's aliasing: without nesterov the projection also
        # rewrites the momentum buffer
        st["momentum"] = b if nesterov else d_p
        u = -lr * d_p
        if weight_decay != 0 and p.ndim > 1:
            u = u - lr * weight_decay * wd / (1.0 - momentum) * p
        return u
    return rule


def madgrad(momentum: float, weight_decay: float, eps: float,
            decoupled_decay: bool) -> Rule:
    if not 0 <= momentum < 1:
        raise ValueError(f"momentum {momentum} must be in [0,1)")
    ck = 1.0 - momentum

    def rule(p, g, st, lr):
        t = st.get("count", 0) + 1
        st["count"] = t
        lamb = (lr + eps) * math.sqrt(t)
        p_eff = p
        if weight_decay != 0 and p.ndim > 1:
            if decoupled_decay:
                p_eff = p * (1.0 - lr * weight_decay)
            else:
                g = g + weight_decay * p_eff
        gss = st.get("grad_sum_sq", torch.zeros_like(p))
        s = st.get("s", torch.zeros_like(p))
        if momentum == 0:
            x0 = p_eff + s / (torch.pow(gss, 1 / 3) + eps)
        else:
            x0 = st.setdefault("x0", p.clone())
        gss = gss + lamb * g * g
        s = s + lamb * g
        z = x0 - s / (torch.pow(gss, 1 / 3) + eps)
        p_new = z if momentum == 0 else (1.0 - ck) * p_eff + ck * z
        st["grad_sum_sq"], st["s"] = gss, s
        if momentum == 0:
            st["x0"] = x0
        return p_new - p
    return rule


def lookahead(base: Rule, alpha: float = 0.5, k: int = 6) -> Rule:
    """Every ``k`` steps the fast weights move to ``slow + alpha·(fast −
    slow)``; the first sync takes the slow weights from the fast ones (the
    reference's lazy buffer), so it leaves them as they are."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"invalid slow update rate {alpha}")
    if k < 1:
        raise ValueError(f"invalid lookahead steps {k}")

    def rule(p, g, st, lr, **extra):
        u = base(p, g, st.setdefault("base", {}), lr, **extra)
        slow = st.setdefault("slow", p.clone())
        count = st.get("la_count", 0) + 1
        st["la_count"] = count
        if count % k:
            return u
        fast = p + u
        target = fast if count == k else slow
        st["slow"] = target + alpha * (fast - target)
        return st["slow"] - p
    return rule


def vit_layer_id(path_str: str, num_max_layer: int) -> int:
    """↔ ``get_num_layer_for_vit`` on a parameter's path joined with '.':
    ``encoder.`` prefixes stripped, ``block{i}`` → layer i + 1, the
    embeddings → 0, everything else → ``num_max_layer − 1``."""
    name = path_str.replace("encoder.", "")
    if any(key in name for key in ("cls_token", "mask_token", "cls_pos",
                                   "pos_embed", "patch_embed", "GroupEmbed")):
        return 0
    if "rel_pos_bias" in name:
        return num_max_layer - 1
    if name.startswith("block"):
        digits = "".join(ch for ch in name.split(".")[0] if ch.isdigit())
        if digits:
            return int(digits) + 1
    return num_max_layer - 1


def layer_decay_scale(name: str, layer_decay: float, num_layers: int
                      ) -> float:
    """``scale_by_layer_decay``'s factor on a parameter's update."""
    lid = vit_layer_id(name, num_layers + 2)
    return layer_decay ** (num_layers + 1 - lid)


def scaled(rule: Rule, factor: float) -> Rule:
    """``rule``'s update times a constant (the layer decay of one
    parameter)."""
    def scaled_rule(p, g, st, lr, **extra):
        return rule(p, g, st, lr, **extra) * factor
    return scaled_rule


class Chain(torch.optim.Optimizer):
    """An optax chain as a ``torch.optim.Optimizer``: ``rule_for(name)``
    gives the rule of the parameter of that name (one of this module's;
    the name reaches only the layer decay), whose update is scaled by the
    plateau factor and added.

    The train step sets ``lr`` (the schedule's rate times the plateau
    factor, as for ``torch.optim.AdamW``) and ``lr_scale`` (the factor) in
    every group each step: the rule takes the schedule's rate
    ``lr / lr_scale`` where optax's chain reads it, and the factor scales
    the final update, as the JAX chain's ``scale_by_plateau`` does.  A
    parameter with no gradient is updated with a zero one, as optax
    updates every leaf.  ``step(hess=...)`` hands each rule its
    parameter's Hutchinson diagonal (one tensor a parameter, in the
    groups' order), as optax's extra arguments reach adahessian through
    the chain and, in the port, through lookahead and the layer decay."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 rule_for: Callable[[str], Rule], lr: float):
        named = list(named_params)
        super().__init__([{"params": [p for _, p in named],
                           "names": [n for n, _ in named]}],
                         {"lr": lr, "lr_scale": 1.0})
        self.rules = [rule_for(n) for n, _ in named]

    @torch.no_grad()
    def step(self, closure=None, hess=None):
        if closure is not None:
            raise ValueError("a closure is not supported")
        rules = iter(self.rules)
        hess = iter(hess) if hess is not None else None
        for group in self.param_groups:
            scale = group["lr_scale"]
            lr = group["lr"] / scale
            for p, rule in zip(group["params"], rules):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                extra = {} if hess is None else {"hess": next(hess)}
                u = rule(p, g, self.state[p], lr, **extra)
                p.add_(u if scale == 1.0 else u * scale)
