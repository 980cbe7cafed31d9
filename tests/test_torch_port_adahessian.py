"""The adahessian step of the port against the JAX package on the CPU.

* The update rule against ``amcontrast3d_tpu.optim.adahessian.adahessian``
  on the same gradient and diagonal sequences (and ``lookahead_adahessian``
  against JAX's ``lookahead`` over that rule with the diagonal handed in:
  JAX's own ``lookahead`` drops the extra argument): every parameter within
  1e-6·(1 + max|θ|).
* ``hutchinson_diag`` on a quadratic, whose ``z ⊙ (H z)`` is known, and
  against JAX's ``hutchinson_diag`` with its own probes (three samples).
* The base, AA and MM steps (``make_train_step(needs_hessian=True)``) from
  the same state as JAX's jitted step, with JAX's probes
  (``rademacher_tree`` of the step's key) handed in: the Hutchinson
  diagonal (JAX: the ``hess`` its step hands the optimizer, one
  ``jax.jvp`` of ``jax.grad``), the loss and the parameters after the
  update.  The batch and the batch statistics are arguments of JAX's
  ``jit``, not constants.
* The Hessian-vector product of one stage's contrast loss (through
  ``_ContrastVJP``'s second order) and of a smooth function of the
  CrossMask refinement (through ``_DualMasksCrossBackward``'s), each alone,
  against ``jax.jvp`` of ``jax.grad`` of the JAX function, on a dyadic grid
  with no tie at any neighbourhood's edge: within 1e-4 relative L2 and 1e-4
  of the largest entry.
* ``gradcheck`` / ``gradgradcheck`` in float64 of each second-order rule's
  plain twin on tiny shapes; the fused aggregation tail's diagonal against
  the gather tail's on one model (the same function); a second-order pass
  through a function without a rule raises.

The models and batches are those of ``test_torch_port_train.py`` (B = 2,
N = 2048, the AA model at width 16, the MM one with APM towers of 8/4/2
channels) and of ``test_torch_port_base.py`` (width 8, three stages,
N = 512).  Tolerances of
the diagonal are relative to each parameter's largest entry (the
contrast's exp terms make the entries large): see the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amcontrast3d_tpu.engine import train as jtrain
from amcontrast3d_tpu.loss import build_criterion_from_cfg as jax_criterion
from amcontrast3d_tpu.loss import contrast as jcontrast
from amcontrast3d_tpu.models import BaseSeg_AMContrast3D as JaxAA
from amcontrast3d_tpu.models import BaseSeg_M_AMContrast3D as JaxMM
from amcontrast3d_tpu.models import build_model_from_cfg as jax_model
from amcontrast3d_tpu.models import refine as jrefine
from amcontrast3d_tpu.optim.adahessian import adahessian as jax_adahessian
from amcontrast3d_tpu.optim.adahessian import hutchinson_diag as jax_hutchinson
from amcontrast3d_tpu.optim.adahessian import rademacher_tree
from amcontrast3d_tpu.optim import build_optimizer_from_cfg as jax_optimizer
from amcontrast3d_tpu.optim import extras as jextras
from amcontrast3d_tpu_torch.engine import make_train_step
from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
from amcontrast3d_tpu_torch.loss import point_contrast_margin
from amcontrast3d_tpu_torch.models import (BaseSeg_AMContrast3D,
                                           BaseSeg_M_AMContrast3D,
                                           build_model_from_cfg)
from amcontrast3d_tpu_torch.models import refine as port_refine
from amcontrast3d_tpu_torch.ops import aggregate as pagg
from amcontrast3d_tpu_torch.ops import contrast as pcontrast
from amcontrast3d_tpu_torch.ops import interpolate as pinterp
from amcontrast3d_tpu_torch.ops import refine as prefine
from amcontrast3d_tpu_torch.optim import (build_optimizer_from_cfg,
                                          hutchinson_diag, rademacher_like)
from amcontrast3d_tpu_torch.optim.adahessian import adahessian as adahessian_rule
from amcontrast3d_tpu_torch.optim.extras import Chain
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_base import CFG as BASE_CFG
from test_torch_port_base import _model_cfg as _base_args
from test_torch_port_train import CFG as AA_CFG
from test_torch_port_train import (AMB, B, CLS, ENCODER, MM_AMB, MM_ARGS, MM_CFG,
                                   NCLS, _batch, _t)
from torch_threads import default_threads  # noqa: F401

# tolerances read with torch's default thread count (tests/torch_threads.py)
pytestmark = pytest.mark.usefixtures("default_threads")

BASE_N = 512
LR, WD, CLIP = 0.01, 1e-4, 10.0
OPT = {"NAME": "adahessian", "weight_decay": WD}


AA_ARGS = dict(encoder_args=ENCODER, decoder_args={}, cls_args=CLS)


def _base_batch(rng):
    """``test_torch_port_base.py``'s batch: a 1/64 grid, so that both
    packages' FPS and ball query agree exactly."""
    batch = {"pos": (rng.randint(0, 128, (B, BASE_N, 3)) / 64).astype(np.float32),
             "x": rng.rand(B, BASE_N, 4).astype(np.float32)}
    centres = rng.rand(B, NCLS, 3) * 2
    batch["y"] = ((batch["pos"][:, :, None] - centres[:, None]) ** 2
                  ).sum(-1).argmin(-1).astype(np.int64)
    return batch


def _jax_side(kind):
    """(model, criterion, ambiguity args) of JAX and the port's
    constructor arguments for ``kind``."""
    if kind == "base":
        return (jax_model(_base_args()), jax_criterion(BASE_CFG.criterion_args),
                {})
    if kind == "aa":
        return (JaxAA(**AA_ARGS), jax_criterion(AA_CFG.criterion_args_Ace), AMB)
    return (JaxMM(**MM_ARGS), jax_criterion(MM_CFG.criterion_args_AcePre),
            MM_AMB)


def _port_side(kind, variables):
    if kind == "base":
        model = build_model_from_cfg(_base_args())
        criterion = build_criterion_from_cfg(BASE_CFG.criterion_args)
        amb = {}
    elif kind == "aa":
        model = BaseSeg_AMContrast3D(**AA_ARGS)
        criterion = build_criterion_from_cfg(AA_CFG.criterion_args_Ace)
        amb = AMB
    else:
        model = BaseSeg_M_AMContrast3D(**MM_ARGS)
        criterion = build_criterion_from_cfg(MM_CFG.criterion_args_AcePre)
        amb = MM_AMB
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model, criterion, amb


def _capturing(tx):
    """``tx`` whose state also holds the last ``hess`` it was handed, so
    that JAX's step shows the diagonal it computed."""
    def init(params):
        return (tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params))

    def update(grads, state, params=None, *, hess=None, **extra):
        updates, inner = tx.update(grads, state[0], params, hess=hess)
        return updates, (inner, hess)
    return optax.GradientTransformationExtraArgs(init, update)


@pytest.fixture(scope="module", params=["base", "aa", "mm"])
def reference(request):
    """One JAX ``make_train_step(needs_hessian=True)`` step (jitted, batch
    and state as arguments) of ``kind`` from seeded variables: the batch,
    the variables, the probes its key draws, the diagonal, the loss and
    the parameters and batch statistics after it."""
    kind = request.param
    rng = np.random.RandomState(0)
    batch = _base_batch(rng) if kind == "base" else _batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model, criterion, amb = _jax_side(kind)
    variables = jax.jit(lambda p, x: model.init(
        {"params": jax.random.PRNGKey(0)}, p, x, training=False))(
        jbatch["pos"], jbatch["x"])
    # build_tx's chain, with the factory's rule recording its diagonal
    tx = optax.chain(optax.clip_by_global_norm(CLIP),
                     _capturing(jax_optimizer(OPT, lr=LR)))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    key = jax.random.PRNGKey(1)
    step = jax.jit(jtrain.make_train_step(model, criterion, tx, kind, NCLS,
                                          None, amb, needs_hessian=True))
    new, metrics = step(state, jbatch, key)
    probes = rademacher_tree(
        jax.random.fold_in(jax.random.fold_in(key, 0), 7), variables["params"])
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"kind": kind, "batch": batch, "variables": tree(variables),
            "probes": tree(probes), "hess": tree(new.opt_state[1][1]),
            "loss": float(metrics["loss"]),
            "after": tree({"params": new.params,
                           "batch_stats": new.batch_stats})}


def _port_step(ref):
    """The port's adahessian step from JAX's variables with JAX's probes:
    (metrics, the diagonal handed to the optimizer by name, the model)."""
    model, criterion, amb = _port_side(ref["kind"], ref["variables"])
    optimizer = build_optimizer_from_cfg(OPT, model, lr=LR)
    names = [n for n, _ in model.named_parameters()]
    probes = from_jax_variables({"params": ref["probes"]})
    step = make_train_step(model, criterion, optimizer, LR, ref["kind"], NCLS,
                           None, amb, CLIP, needs_hessian=True)
    seen = []
    inner = optimizer.step

    def spy(closure=None, hess=None):
        seen.append(hess)
        return inner(closure, hess=hess)
    optimizer.step = spy
    out = step({k: _t(v) for k, v in ref["batch"].items()},
               probes=[probes[n].numpy() for n in names])
    return out, dict(zip(names, seen[0])), model


@pytest.fixture(scope="module")
def port_step(reference):
    return _port_step(reference)


def _relative_to_largest(got, want):
    """max |got − want| over the largest |want| of the leaf (1 for a zero
    leaf)."""
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def test_hessian_diagonal_matches_jax(reference, port_step):
    """The Hutchinson diagonal of the step, with JAX's probes, against the
    ``hess`` JAX's step hands its optimizer (forward-over-reverse there,
    reverse-over-reverse here): each parameter within 5e-2 of its leaf's
    largest entry and 5e-2 relative L2, and 2e-2 relative L2 over all
    parameters.  Max-pool near-ties route the gradient, and so its
    derivative, to another slot now and then, as for the gradients in
    ``test_torch_port_train.py`` (0.4 % over all, up to 1.7 % a tensor
    there); measured here (N = 2048) base 7.5e-5 of the largest entry at
    worst and 3.9e-5 over all, AA 3.2e-2 (the decoder's fp0 BatchNorm) and
    4.4e-3, MM 3.8e-2 and 4.8e-3, a leaf's relative L2 at most 3.3e-2.
    The two hand-written second orders that only AA and MM run are each
    held alone to JAX's jvp at 1e-4 (measured: the contrast loss at most
    4.4e-7 relative L2 and 4.9e-7 of the largest entry, the CrossMask
    3.9e-8 and 5.8e-8;
    ``test_contrast_hessian_vector_product_matches_jax``,
    ``test_crossmask_hessian_vector_product_matches_jax``), so the larger
    gap on those two models comes from the ties, not from a missing term.  A
    bias ahead of a BatchNorm has an exact diagonal of 0 and holds
    rounding noise (up to 1.4e-4 of the model's largest entry an element
    on AA): the relative L2 has a floor of 2e-4 of that entry an
    element."""
    _, hess, _ = port_step
    want = from_jax_variables({"params": reference["hess"]})
    assert set(want) == set(hess)
    top = max(np.abs(w.numpy()).max() for w in want.values())
    num = den = 0.0
    for name, w in want.items():
        w, g = w.numpy().astype(np.float64), hess[name].numpy()
        assert g.shape == w.shape, name
        assert _relative_to_largest(g, w) <= 5e-2, name
        assert (np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)
                + 2e-4 * top * np.sqrt(w.size)), name
        num, den = num + np.sum((g - w) ** 2), den + np.sum(w ** 2)
    assert den > 0 and np.sqrt(num / den) <= 2e-2, np.sqrt(num / den)


def test_adahessian_step_matches_jax(reference, port_step):
    """The loss within 1e-5 relative, the batch statistics after the step
    within 1e-4·(1 + max), and the parameters after it.  The first update
    is −lr·g/(|hess| + eps) (plus the decay), so an element whose diagonal
    is small moves by lr·|g|/|hess| and carries any difference of ``hess``
    (see above) into the parameter: over all parameters, each element's
    difference over 1 + max|θ| of its leaf is held within 1e-5 on 97 % of
    the elements, 1e-4 on 99 % and 1e-3 on 99.5 % (measured 97.9 / 99.3 /
    99.8 % at worst, AA).  And the port's update is its rule applied to
    the clipped gradient and the unclipped diagonal of the step, to
    1e-6·(1 + max|θ|)."""
    out, hess, model = port_step
    np.testing.assert_allclose(out["loss"].item(), reference["loss"], rtol=1e-5)
    want = from_jax_variables(reference["after"])
    before = from_jax_variables(reference["variables"])
    got = model.state_dict()
    params = dict(model.named_parameters())
    rule = adahessian_rule(weight_decay=WD)
    diffs = []
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        g, w = got[name].numpy(), w.numpy()
        scale = 1 + np.abs(w).max()
        if name.endswith(("running_mean", "running_var")):
            assert np.abs(g - w).max() <= 1e-4 * scale, name
            continue
        diffs.append((np.abs(g - w) / scale).ravel())
        p0 = before[name]
        own = p0 + rule(p0, params[name].grad, {}, LR, hess=hess[name])
        assert torch.allclose(got[name], own, rtol=0,
                              atol=1e-6 * (1 + p0.abs().max().item())), name
    diffs = np.concatenate(diffs)
    for bound, share in ((1e-5, 0.97), (1e-4, 0.99), (1e-3, 0.995)):
        assert (diffs <= bound).mean() >= share, (bound, (diffs <= bound).mean())


def _tie_free_dyadic_cloud(rng, n, k):
    """Two clouds of ``n`` points on a 1/64 grid in [0, 4)³ (every d² exact
    in float32), redrawn where a point's k-th and (k+1)-th nearest d² tie
    (self included), so that no neighbourhood's edge is tied."""
    p = (rng.randint(0, 256, (2, n, 3)) / 64).astype(np.float32)
    for _ in range(100):
        d2 = np.sort(((p[:, :, None].astype(np.float64) - p[:, None]) ** 2)
                     .sum(-1), -1)
        bad = ~(d2[..., k] > d2[..., k - 1])
        if not bad.any():
            return p
        p[bad] = rng.randint(0, 256, (int(bad.sum()), 3)) / 64
    raise AssertionError("no tie-free cloud")


def _hvp_close(got, want):
    """Within 1e-4 relative L2 and 1e-4 of the largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _port_hvp(loss_of, f, v):
    """Reverse over reverse: the gradient of ⟨∇L(f), v⟩ in f."""
    ft = _t(f).requires_grad_()
    (g,) = torch.autograd.grad(loss_of(ft), ft, create_graph=True)
    (hv,) = torch.autograd.grad(g, ft, grad_outputs=_t(v))
    return g.detach().numpy(), hv.numpy()


@pytest.mark.parametrize("over", [{}, {"margin": "learned"}],
                         ids=["aa_cfg", "learned"])
def test_contrast_hessian_vector_product_matches_jax(over):
    """One stage's contrast loss (``cfgs/s3dis/AMContrast3D-AA.yaml``'s
    Method2, adaptive margin, nsample 24, T 0.3; and the learned margin,
    whose s_pos / s_neg sums add the VJP's s terms), N = 512, C = 32,
    Voronoi labels: the port's H·v (the second order of ``_ContrastVJP``,
    the plain twin of kernels 15/16's second order) against
    ``jax.jvp(jax.grad(L), (f,), (v,))`` of JAX's ``point_contrast_margin``
    (its gather path, what it runs on the CPU), and the gradient beside it.
    The features are the one input with a derivative: JAX takes the
    ambiguity under ``stop_gradient`` from the labels."""
    rng = np.random.RandomState(21)
    p = _tie_free_dyadic_cloud(rng, 512, AMB["nsample"])
    centres = rng.rand(2, 4, 3) * 4
    y = ((p[:, :, None] - centres[:, None]) ** 2).sum(-1).argmin(-1)
    labels = np.eye(4, dtype=np.float32)[y]
    f = rng.randn(2, 512, 32).astype(np.float32)
    v = rng.randn(2, 512, 32).astype(np.float32)
    args = {**AMB, **over}
    g, hv = _port_hvp(lambda ft: point_contrast_margin(
        _t(p), ft, _t(labels), args)[0], f, v)

    def jloss(ff):
        return jcontrast.point_contrast_margin(
            jnp.asarray(p), ff, jnp.asarray(labels), {**args, "fused": False})[0]
    jg, jhv = jax.jvp(jax.grad(jloss), (jnp.asarray(f),), (jnp.asarray(v),))
    _hvp_close(g, jg)
    _hvp_close(hv, jhv)


@pytest.mark.parametrize("fusion,gamma", [("MIN", 1.0), ("MIN_ALL0", 0.5)])
def test_crossmask_hessian_vector_product_matches_jax(fusion, gamma):
    """L = Σ w·r + Σ u·r² + Σ r³ / 10 of the refined features r =
    ``dual_masks(p, f, a, 12, fusion, 0.5, 1.0, gamma)`` (N = 300, C = 16,
    an ambiguity with 40 % exact zeros): the port's H·v (the second order
    of ``_DualMasksCrossBackward``, the plain twin of kernel 19's second
    order) against JAX's jvp of the gradient of the same L over
    ``models/refine.py::dual_masks``.  The masks are discrete in a, so f is
    the one input with a derivative in both packages."""
    rng = np.random.RandomState(22)
    p = _tie_free_dyadic_cloud(rng, 300, 12)
    f, w, v = (rng.randn(2, 300, 16).astype(np.float32) for _ in range(3))
    u = rng.rand(2, 300, 16).astype(np.float32)
    a = np.where(rng.rand(2, 300) < 0.4, 0.0, rng.rand(2, 300)).astype(np.float32)

    def smooth(r, lib):
        return (r * lib.asarray(w)).sum() + (r ** 2 * lib.asarray(u)).sum() + \
            (r ** 3).sum() / 10

    def port_loss(ft):
        r, rate = port_refine.dual_masks(_t(p), ft, _t(a), 12, fusion, 0.5,
                                         1.0, gamma)
        assert 5 < rate.item() < 95
        return smooth(r, torch)

    def jloss(ff):
        r, _ = jrefine.dual_masks(jnp.asarray(p), ff, jnp.asarray(a), 12,
                                  fusion, 0.5, 1.0, gamma)
        return smooth(r, jnp)
    g, hv = _port_hvp(port_loss, f, v)
    jg, jhv = jax.jvp(jax.grad(jloss), (jnp.asarray(f),), (jnp.asarray(v),))
    _hvp_close(g, jg)
    _hvp_close(hv, jhv)


GROUP = {"NAME": "ballquery", "radius": 0.15, "nsample": 8, "normalize_dp": True}
COMMON = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"},
              conv_args={"order": "conv-norm-act"})


@pytest.mark.parametrize("kind", ["local", "set_abstraction"])
def test_fused_tail_diagonal_matches_the_gather_tail(kind):
    """A separable aggregation (an InvResMLP block's ``LocalAggregation``, a
    ``SetAbstraction``) in train mode, with BatchNorm scales of both signs
    (the fused tail then takes minima on some channels): the Hutchinson
    diagonal of a smooth function of its output, in its parameters and its
    input features, through the fused tail (``AMC3D_AGG_FUSED=on``: kernel
    21's second order, ``aggregate_backward2``'s twin, and autograd through
    ``GroupStatsBN``) against the gather tail's, the same function: within
    1e-4 of each leaf's largest entry (measured ≤ 4.8e-6).  On a whole model
    the two tails' gradients already differ by 1.5 % relative L2 (max-pool
    near-ties at the deep stages' few points), and their diagonals by
    more, so the rule is held here, where neither routes apart."""
    from amcontrast3d_tpu_torch.models import pointnext as ppn
    from amcontrast3d_tpu_torch.ops import spatial

    rng = np.random.RandomState(11 if kind == "local" else 12)
    p = _t((rng.randint(0, 64, (2, 260, 3)) / 64).astype(np.float32))
    f = _t(rng.randn(2, 260, 16).astype(np.float32))
    weights = rng.randn(2, 260 if kind == "local" else 65, 24).astype(np.float32)
    diags = []
    for mode in ("off", "on"):
        torch.manual_seed(0)
        if kind == "local":
            module = ppn.LocalAggregation([16, 24], group_args=GROUP, **COMMON)
        else:
            module = ppn.SetAbstraction(in_channels=16, out_channels=24,
                                        layers=1, stride=4, group_args=GROUP,
                                        **COMMON)
        with torch.no_grad():
            for name, t in module.named_parameters():
                if "BatchNorm" in name and name.endswith("weight"):
                    mag = torch.from_numpy(np.random.RandomState(3).uniform(
                        0.5, 1.5, t.shape).astype(np.float32))
                    sign = torch.from_numpy(np.random.RandomState(4).rand(
                        *t.shape) < 0.4)
                    t.copy_(torch.where(sign, -mag, mag))
        module.train()
        ft = f.clone().requires_grad_()
        params = [ft] + list(module.parameters())
        pagg.set_agg_fused(mode)
        try:
            if kind == "local":
                out = module(p, ft, cloud=spatial.sort_support(p))
            else:
                sampled = module.sample(p)
                out = module(p, ft, sampled, cloud=spatial.sort_support(p),
                             query_cloud=spatial.sort_support(sampled[1]))[1]
            loss = (out * _t(weights)).sum() + 0.5 * (out ** 2).sum()
            grads = torch.autograd.grad(loss, params, create_graph=True)
            probes = rademacher_like(params, torch.Generator().manual_seed(5))
            diags.append(hutchinson_diag(grads, params, [probes]))
        finally:
            pagg.set_agg_fused("off")
    for a, b in zip(*diags):
        assert _relative_to_largest(b.numpy(), a.numpy()) <= 1e-4


@pytest.mark.parametrize("power", [1.0, 0.5])
def test_update_rule_matches_jax(power):
    """``adahessian`` (and ``lookahead_adahessian``, k = 2) over 4 steps
    of the same gradients and diagonals, against JAX's rule under the
    factory's decay mask: every parameter within 1e-6·(1 + max|θ|)."""
    rng = np.random.RandomState(1)
    init = {"w": rng.randn(6, 5).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    seq = [({k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()},
            {k: (rng.randn(*v.shape) * 10 ** rng.uniform(-3, 2, v.shape))
             .astype(np.float32) for k, v in init.items()}) for _ in range(4)]
    mask = {"w": True, "b": False}
    for look in (False, True):
        rule = jax_adahessian(LR, weight_decay=WD, hessian_power=power,
                              mask=mask)
        cur = {}
        tx = rule
        if look:
            base = optax.GradientTransformation(
                rule.init, lambda g, s, p=None: rule.update(g, s, p,
                                                            hess=cur["h"]))
            tx = jextras.lookahead(base, alpha=0.5, k=2)
        params = {k: jnp.asarray(v) for k, v in init.items()}
        state = tx.init(params)
        tiny = torch.nn.Module()
        tiny.w = torch.nn.Parameter(_t(init["w"]).clone())
        tiny.b = torch.nn.Parameter(_t(init["b"]).clone())
        name = "lookahead_adahessian" if look else "adahessian"
        opt = build_optimizer_from_cfg(
            {"NAME": name, "weight_decay": WD, "hessian_power": power,
             "lookahead_k": 2}, tiny, lr=LR)
        assert isinstance(opt, Chain)
        for g, h in seq:
            cur["h"] = {k: jnp.asarray(v) for k, v in h.items()}
            if look:
                updates, state = tx.update(
                    {k: jnp.asarray(v) for k, v in g.items()}, state, params)
            else:
                updates, state = tx.update(
                    {k: jnp.asarray(v) for k, v in g.items()}, state, params,
                    hess=cur["h"])
            params = optax.apply_updates(params, updates)
            tiny.w.grad, tiny.b.grad = _t(g["w"]).clone(), _t(g["b"]).clone()
            opt.step(hess=[_t(h["w"]), _t(h["b"])])
            for k in init:
                want = np.asarray(params[k])
                np.testing.assert_allclose(
                    getattr(tiny, k).detach().numpy(), want, rtol=0,
                    atol=1e-6 * (1 + np.abs(want).max()), err_msg=(name, k))
        with pytest.raises(ValueError, match="Hutchinson"):
            opt.step()


def test_hutchinson_diag_on_a_quadratic_and_against_jax():
    """L = ½ xᵀ A x over two parameters coupled by A: ``z ⊙ (H z)`` is
    exactly z ⊙ (A z) for each probe set, averaged over the sets; and with
    JAX's three probe sets of one key, the same as JAX's
    ``hutchinson_diag`` (to 1e-6 relative)."""
    rng = np.random.RandomState(2)
    a = rng.randn(7, 7)
    a = (a + a.T).astype(np.float32)
    x0 = rng.randn(7).astype(np.float32)
    params = [torch.nn.Parameter(_t(x0[:3]).clone()),
              torch.nn.Parameter(_t(x0[3:]).clone())]
    at = _t(a)

    def loss_of(p1, p2):
        x = torch.cat([p1, p2])
        return 0.5 * x @ (at @ x) + (x ** 3).sum() / 3

    grads = torch.autograd.grad(loss_of(*params), params, create_graph=True)
    key = jax.random.PRNGKey(4)
    keys = [key] + [jax.random.fold_in(key, i) for i in range(1, 3)]
    sets = [[_t(np.asarray(z)) for z in rademacher_tree(k, {
        "a": jnp.zeros(3), "b": jnp.zeros(4)}).values()] for k in keys]
    got = hutchinson_diag(grads, params, sets)
    hmat = a + np.diag(2 * x0)
    want = np.mean([np.concatenate([z.numpy() for z in zs])
                    * (hmat @ np.concatenate([z.numpy() for z in zs]))
                    for zs in sets], 0)
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=1e-5,
                               atol=1e-5)
    jgot = jax_hutchinson(
        jax.grad(lambda p: 0.5 * jnp.concatenate([p["a"], p["b"]])
                 @ (a @ jnp.concatenate([p["a"], p["b"]]))
                 + (jnp.concatenate([p["a"], p["b"]]) ** 3).sum() / 3),
        {"a": jnp.asarray(x0[:3]), "b": jnp.asarray(x0[3:])}, key, n_samples=3)
    np.testing.assert_allclose(
        torch.cat(got).numpy(),
        np.concatenate([np.asarray(jgot["a"]), np.asarray(jgot["b"])]),
        rtol=1e-6, atol=1e-6)
    zs = rademacher_like(params, torch.Generator().manual_seed(0))
    assert all(set(torch.unique(z).tolist()) <= {-1.0, 1.0} for z in zs)


D = torch.float64


def _gradcheck_cases():
    """(name, function, inputs): each second-order rule's first-order
    function in float64, whose ``gradgradcheck`` (or, where the function is
    the VJP itself, ``gradcheck``) holds its second-order twin."""
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=D, requires_grad=True)
    p1 = torch.rand(2, 7, 3, generator=g)
    p2 = torch.rand(2, 5, 3, generator=g)
    idx, w = pinterp.three_interpolation_weights(p1, p2)
    sel = torch.randint(-1, 6, (2, 6, 3), generator=g, dtype=torch.int32)
    pc = torch.rand(1, 12, 3, generator=g, dtype=D)
    lab = torch.randint(0, 2, (1, 12), generator=g).to(D)
    kth = torch.full((1, 12), 0.3, dtype=D)
    u = rnd(2, 9, 4)
    qp = rnd(2, 5, 4)
    aidx = torch.randint(0, 9, (2, 5, 3), generator=g, dtype=torch.int32)
    sgn = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=D)

    def contrast(need_s):
        return lambda f: pcontrast._ContrastReductions.apply(
            pc, f, lab, kth, 0.7, False, need_s, True, True, None,
            None)[..., :4]

    def aggregate(stats):
        return lambda u, qp: pagg._SlotReduce.apply(
            u, qp if stats else None, aidx, sgn, stats, True, None)
    return [
        ("interpolation VJP", "grad", lambda gr: pinterp._ThreeInterpolationBackward
         .apply(gr, idx, w.to(D), 5, None, None, True), (rnd(2, 7, 4),)),
        ("CrossMask VJP", "grad", lambda gr: prefine._DualMasksCrossBackward
         .apply(gr, sel, 0.5, True), (rnd(2, 6, 4),)),
        ("contrast VJP", "grad", lambda f, g4: pcontrast._ContrastVJP.apply(
            f, g4, 0.7, True, True, (pc, lab, kth)), (rnd(1, 12, 3),
                                                        rnd(1, 12, 4))),
        ("contrast", "gradgrad", contrast(True), (rnd(1, 12, 3),)),
        ("contrast without S", "gradgrad", contrast(False), (rnd(1, 12, 3),)),
        ("aggregation", "gradgrad", aggregate(True), (u, qp)),
        ("aggregation in eval mode", "gradgrad", aggregate(False), (u, qp)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_second_order_twins_pass_gradgradcheck(case):
    """Each second-order twin is the exact derivative of its first-order
    twin: float64 finite differences at torch's default tolerances."""
    name, how, fn, inputs = _gradcheck_cases()[case]
    check = (torch.autograd.gradcheck if how == "grad"
             else torch.autograd.gradgradcheck)
    assert check(fn, inputs), name


def test_a_function_without_a_rule_raises_on_a_second_order_pass(tmp_path):
    """A third order through a second-order rule raises (each backward is
    guarded by ``ops._autograd.last_order``), as does a second order
    through the synced BatchNorm and the differentiable all_reduce (no rule
    ported; a gloo group of one process): at the backward with
    ``create_graph=True``, so no later pass can drop their terms
    (``once_differentiable`` would: ``autograd.grad`` prunes its error
    node); the adahessian step refuses ``distributed=True`` by name."""
    gr = torch.randn(1, 4, 2, dtype=D, requires_grad=True)
    idx = torch.zeros(1, 4, 3, dtype=torch.int32)
    w = torch.full((1, 4, 3), 1 / 3, dtype=D)
    df2 = pinterp._ThreeInterpolationBackward.apply(gr, idx, w, 2, None, None,
                                                    True)
    with pytest.raises(NotImplementedError, match="second order"):
        torch.autograd.grad((df2 ** 2).sum(), gr, create_graph=True)
    (gu,) = torch.autograd.grad((df2 ** 2).sum(), gr)
    assert gu.shape == gr.shape
    from amcontrast3d_tpu_torch import parallel
    from amcontrast3d_tpu_torch.models import layers
    parallel.init_process_group(0, 1, torch.device("cpu"), "gloo",
                                f"file://{tmp_path / 'group'}")
    try:
        bn = parallel.sync_batchnorm_(layers.batch_norm(3)).train()
        for fn, name in ((bn, "synced BatchNorm"),
                         (lambda x: parallel._AllReduceSum.apply(x, None),
                          "all_reduce")):
            x = torch.randn(5, 3, requires_grad=True)
            with pytest.raises(NotImplementedError, match=name):
                torch.autograd.grad((fn(x) ** 3).sum(), x, create_graph=True)
            (gx,) = torch.autograd.grad((fn(x) ** 3).sum(), x)
            assert torch.isfinite(gx).all()
    finally:
        parallel.destroy_process_group()
    model = torch.nn.Linear(2, 2)
    opt = build_optimizer_from_cfg(OPT, model)
    with pytest.raises(NotImplementedError, match="distributed"):
        make_train_step(model, None, opt, LR, "base", NCLS, distributed=True,
                        needs_hessian=True)
