"""The port's fused grouped aggregation against the JAX package's on the
CPU: ``grouped_slot_reduce`` (forward and VJP) against the Pallas kernels
in interpret mode, and ``LocalAggregation`` / ``SetAbstraction`` with the
fused GroupStatsBN tail against JAX's fused modules and against the port's
own gather tail, in train mode (running statistics included) and in eval
mode.

JAX runs as ``tests/test_aggregate_pallas.py`` runs it
(``set_agg_fused('on')``, interpret mode), the port with
``ops.aggregate.set_agg_fused('on')``; both are switched off again in a
``finally``.  Inputs come from numpy seeds; positions lie on a 1/64 grid,
where the ball query and FPS agree exactly between the two.  Tolerances:
ext 1e-6, su and sq 1e-5 (``assert_allclose`` rtol = atol, as the JAX
package's own tests); du and dqp 1e-4, since JAX splits γ into two bf16
pieces (16 bits of mantissa); modules 2e-4, as ``tests/test_aggregate_pallas.py``
holds the fused tail against the gather tail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.models import pointnext as jpn
from amcontrast3d_tpu.ops import aggregate_pallas as jagg
from amcontrast3d_tpu.ops import ball_query as jax_ball_query
from amcontrast3d_tpu.ops import knn as jax_knn
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.models import pointnext as ppn
from amcontrast3d_tpu_torch.ops import aggregate as pagg
from amcontrast3d_tpu_torch.ops import spatial
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(rng, shape, cells=64, spread=1.0):
    return (rng.randint(0, int(cells * spread), shape) / cells).astype(np.float32)


# ---- grouped_slot_reduce -----------------------------------------------------------

CASES = {
    # name: (N, M, C, K, radius or None for kNN slots, sgn, qp, need_stats)
    "ball": (300, 90, 12, 8, 0.2, "pos", False, True),
    "ball-qp-mixed-sgn": (300, 90, 12, 8, 0.2, "mixed", True, True),
    "knn-c20": (300, 90, 20, 8, None, "neg", True, True),
    "multichunk": (1400, 260, 8, 8, 0.25, "mixed", True, True),
    "eval": (300, 90, 12, 8, 0.2, "mixed", False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_slot_reduce_matches_pallas_kernel(case):
    """Forward and VJP against ``aggregate_pallas.grouped_slot_reduce`` in
    interpret mode, with ball-query slots (repeat padding makes max ties,
    split evenly on both sides), kNN slots, negative and mixed ``sgn``, a
    per-query offset ``qp``, several support chunks (which the JAX entry
    kd-sorts) and the eval mode without moments."""
    _check_case(case, with_layout=False)


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_slot_reduce_with_the_query_layout(case):
    """Given the queries' layout (``spatial.sort_support``, as the encoder
    hands ``query_cloud`` on), ``grouped_slot_reduce`` gives the same bits
    as without it, forward and gradients, and the Pallas kernels' answer."""
    _check_case(case, with_layout=True)


def _check_case(case, with_layout: bool):
    n, m, c, k, radius, sign, with_qp, stats = CASES[case]
    rng = np.random.RandomState(len(case) + n)
    spread = 3.0 if n > 1000 else 1.0
    # the queries are support points, as in the model, so no ball is empty
    # (the TPU kernel prunes the far index 0 an empty ball pads with)
    sup = _grid(rng, (2, n, 3), spread=spread)
    q = np.ascontiguousarray(sup[:, rng.permutation(n)[:m]])
    if radius is None:
        idx = np.asarray(jax_knn(jnp.asarray(sup), jnp.asarray(q), k)[0])
    else:
        idx = np.asarray(jax_ball_query(jnp.asarray(sup), jnp.asarray(q), radius, k))
    np.testing.assert_array_equal(
        idx, (ops.knn(_t(sup), _t(q), k)[0] if radius is None
              else ops.ball_query(_t(sup), _t(q), radius, k)).numpy())
    if radius is not None:
        assert (idx[..., -1] == idx[..., 0]).any()        # repeat-padded slots
    u = rng.randn(2, n, c).astype(np.float32)
    sgn = {"pos": np.ones(c), "neg": -np.ones(c),
           "mixed": np.where(rng.rand(c) < 0.5, -1.0, 1.0)}[sign].astype(np.float32)
    qp = rng.randn(2, m, c).astype(np.float32) if with_qp else None
    gs = [rng.randn(2, m, c).astype(np.float32) for _ in range(3 if stats else 1)]

    def port(layout):
        ut = _t(u).requires_grad_()
        qpt = _t(qp).requires_grad_() if with_qp else None
        got = pagg.grouped_slot_reduce(ut, _t(idx), _t(sgn), qp=qpt,
                                       need_stats=stats, query_cloud=layout)
        sum(((o * _t(g)).sum() for o, g in zip(got, gs)),
            torch.zeros(())).backward()
        return got, ut, qpt

    got, ut, qpt = port(spatial.sort_support(_t(q)) if with_layout else None)
    if with_layout:
        plain, ut0, qpt0 = port(None)
        for a, b in zip(got, plain):
            assert (a is None and b is None) or torch.equal(a, b)
        assert torch.equal(ut.grad, ut0.grad)
        assert not with_qp or torch.equal(qpt.grad, qpt0.grad)

    def jfn(u_, qp_):
        return jagg.grouped_slot_reduce(
            jnp.asarray(sup), jnp.asarray(q), u_, jnp.asarray(idx),
            jnp.asarray(sgn), radius=radius, need_stats=stats, qp=qp_,
            interpret=True)
    jqp = jnp.asarray(qp) if with_qp else None
    want = jfn(jnp.asarray(u), jqp)
    if not stats:
        assert got[1] is None and got[2] is None and want[1] is None
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(got[1:] if stats else (), want[1:]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)

    def down(u_, qp_):
        outs = jfn(u_, qp_)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs))
    argnums = (0, 1) if with_qp else (0,)
    jgrads = jax.grad(down, argnums=argnums)(jnp.asarray(u), jqp)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(jgrads[0]),
                               rtol=1e-4, atol=1e-4)
    if with_qp:
        np.testing.assert_allclose(qpt.grad.numpy(), np.asarray(jgrads[1]),
                                   rtol=1e-4, atol=1e-4)


def test_twin_backward_is_autograd_of_the_gather():
    """The twin's γ (with the even split of tied maxima) equals PyTorch's
    autograd through gather + ``amax`` + the moments."""
    rng = np.random.RandomState(3)
    sup, q = _grid(rng, (2, 200, 3)), _grid(rng, (2, 60, 3))
    idx = ops.ball_query(_t(sup), _t(q), 0.15, 8)
    u = _t(rng.randn(2, 200, 6).astype(np.float32))
    sgn = _t(np.array([1, -1, 1, 1, -1, -1], np.float32))
    qp = _t(rng.randn(2, 60, 6).astype(np.float32))
    gs = [_t(rng.randn(2, 60, 6).astype(np.float32)) for _ in range(3)]
    ut, qt = u.clone().requires_grad_(), qp.clone().requires_grad_()
    outs = pagg.grouped_slot_reduce(ut, idx, sgn, qp=qt)
    sum((o * g).sum() for o, g in zip(outs, gs)).backward()
    ur, qr = u.clone().requires_grad_(), qp.clone().requires_grad_()
    slot = torch.gather(ur, 1, idx.reshape(2, -1, 1).long().expand(-1, -1, 6)
                        ).view(2, 60, 8, 6)
    h = slot - qr[:, :, None]
    ref = (torch.amax(slot * sgn, 2) * sgn, h.sum(2), (h * h).sum(2))
    sum((o * g).sum() for o, g in zip(ref, gs)).backward()
    np.testing.assert_allclose(ut.grad.numpy(), ur.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qt.grad.numpy(), qr.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_forward_counts_the_ties_directly():
    """The tie count the forward keeps for the VJP (a byte a query and
    channel) is the number of slots whose value equals the extremum,
    counted here slot by slot on a cloud of few distinct values (ties in
    most channels), with index repeats from the ball query's padding; eval
    mode keeps none unless asked, and more than 255 slots are refused."""
    rng = np.random.RandomState(21)
    sup, q = _grid(rng, (2, 150, 3)), _grid(rng, (2, 40, 3))
    idx = ops.ball_query(_t(sup), _t(q), 0.2, 12)
    u = _t(rng.randint(-2, 3, (2, 150, 5)).astype(np.float32))
    sgn = _t(np.array([1, -1, 1, -1, 1], np.float32))
    ext, _, _, ties = pagg.aggregate_forward(u, idx, sgn, keep_ties=True)
    assert ties.dtype == torch.uint8
    want = np.zeros(ties.shape, np.int64)
    un, xn, ix = u.numpy(), ext.numpy(), idx.numpy()
    for b, i, k, c in np.ndindex(*ix.shape, un.shape[-1]):
        want[b, i, c] += un[b, ix[b, i, k], c] == xn[b, i, c]
    np.testing.assert_array_equal(ties.numpy(), want)
    assert (want > 1).mean() > 0.5
    assert pagg.aggregate_forward(u, idx, sgn, need_stats=False)[3] is None
    with pytest.raises(ValueError):
        pagg.aggregate_forward(u, idx.repeat(1, 1, 22), sgn, keep_ties=True)


def test_fused_tail_rule_is_the_cards_over_the_gate_table():
    """The port's rule (the fused tail wherever the switch is on and the
    activation monotone: on the card its kernels took less device time
    than the gather tail's at every shape of the gate table,
    ``tools/profile_aggregation.GATE_CLOUDS``) against the JAX package's
    VMEM rule over the table's shapes: JAX keeps the largest supports on
    the gather tail (ScanNet's 64000-point stage 0, the subclouds' first
    stages), the port takes the fused tail at all of them; nothing with
    the switch off or a non-monotone activation."""
    from amcontrast3d_tpu_torch.tools.profile_aggregation import (GATE_CLOUDS,
                                                                  K, WIDTHS)
    supports = {(n // 4 ** (s - 1), c) for _, _, n, _, _, _ in GATE_CLOUDS
                for s, c in enumerate(WIDTHS, 1)}
    refused = {sc for sc in supports if not jagg.agg_fused_fits(*sc, K)}
    assert {(64000, 128), (106496, 128), (311296, 128), (77824, 256)} <= refused
    assert not ppn._fused("relu")                      # the switch is off
    try:
        pagg.set_agg_fused("on")
        assert all(ppn._fused(a) for a in ppn._MONOTONE_ACTS)
        assert not ppn._fused("gelu")
    finally:
        pagg.set_agg_fused("off")


def test_modules_dispatch_by_the_rule(monkeypatch):
    """With the switch on, a set abstraction over 64000 support points (a
    support the JAX package's VMEM rule refuses) takes the fused tail (one
    ``grouped_slot_reduce``) in train and eval mode, and gives the gather
    tail's output within 2e-4; with the switch off it takes the gather
    tail."""
    rng = np.random.RandomState(9)
    n, m, c, k = 64000, 16000, 8, 8
    assert not jagg.agg_fused_fits(n, c, k)
    p = _t(rng.rand(1, n, 3).astype(np.float32))
    f = _t(rng.randn(1, n, 4).astype(np.float32))
    q = p[:, :m].contiguous()
    idx = torch.from_numpy(rng.randint(0, n, (1, m, k)).astype(np.int32))
    monkeypatch.setattr(ppn, "_group_idx", lambda *a: idx)
    calls = []
    real = ppn.grouped_slot_reduce
    monkeypatch.setattr(ppn, "grouped_slot_reduce",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    sa = ppn.SetAbstraction(in_channels=4, out_channels=c, stride=4,
                            group_args=GROUP, **COMMON)
    outs = {}
    for train in (True, False):
        sa.train(train)
        for mode in ("on", "off"):
            pagg.set_agg_fused(mode)
            try:
                before = len(calls)
                with torch.no_grad():
                    outs[train, mode] = sa(p, f, (None, q))[1]
                assert len(calls) - before == (mode == "on")
            finally:
                pagg.set_agg_fused("off")
    for train in (True, False):
        _close(outs[train, "on"], outs[train, "off"], 2e-4,
               f"fused vs gather tail, train={train}")


# ---- the modules -------------------------------------------------------------------

GROUP = {"NAME": "ballquery", "radius": 0.15, "nsample": 8, "normalize_dp": True}
COMMON = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"},
              conv_args={"order": "conv-norm-act"})


def _random_bn(variables, rng):
    """Random BatchNorm scales of both signs (so the fused tail takes
    minima on some channels), shifts and running statistics."""
    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, np.asarray(v))
                for k, v in tree.items()}

    def param(k, v):
        if k == "scale":
            mag = rng.uniform(0.5, 1.5, v.shape)
            return (np.where(rng.rand(*v.shape) < 0.4, -mag, mag)).astype(np.float32)
        if k == "bias":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v

    def stat(k, v):
        if k == "mean":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    tree = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    return {"params": walk(tree(variables["params"]), param),
            "batch_stats": walk(tree(variables["batch_stats"]), stat)}


def _modules(kind):
    if kind == "local":
        jm = jpn.LocalAggregation(channels=[16, 24], group_args=GROUP, **COMMON)
        pm = ppn.LocalAggregation([16, 24], group_args=GROUP, **COMMON)
    else:
        args = dict(in_channels=16, out_channels=24, layers=1, stride=4,
                    group_args=GROUP, **COMMON)
        jm, pm = jpn.SetAbstraction(**args), ppn.SetAbstraction(**args)
    return jm, pm


def _close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("kind", ["local", "set_abstraction"])
def test_fused_module_matches_jax_and_the_gather_tail(kind):
    """The module with the fused tail against JAX's fused module and against
    the port's gather tail, in train mode (output and running statistics)
    and in eval mode (running statistics, no moments), within 2e-4."""
    rng = np.random.RandomState(11 if kind == "local" else 12)
    p = _grid(rng, (2, 260, 3))
    f = rng.randn(2, 260, 16).astype(np.float32)
    jm, pm = _modules(kind)
    jargs = (jnp.asarray(p), jnp.asarray(f))
    variables = _random_bn(jm.init(jax.random.PRNGKey(0), *jargs, training=False),
                           rng)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    pg = _modules(kind)[1]          # the same weights, for the gather tail
    pg.load_state_dict(from_jax_variables(variables), strict=True)

    pt, ft = _t(p), _t(f)

    def port(model, train: bool):
        """The module with the layouts of its points, as the encoder hands
        them on: a block's ``cloud``, a set abstraction's support and query
        layouts beside its sampled queries."""
        model.train(train)
        with torch.no_grad():
            if kind == "local":
                return model(pt, ft, cloud=spatial.sort_support(pt))
            sampled = model.sample(pt)
            return model(pt, ft, sampled, cloud=spatial.sort_support(pt),
                         query_cloud=spatial.sort_support(sampled[1]))[1]

    try:
        jagg.set_agg_fused("on")
        pagg.set_agg_fused("on")
        jout, jstate = jm.apply(variables, *jargs, training=True,
                                mutable=["batch_stats"])
        # eval mode with the running statistics the train step moved
        jeval = jm.apply({"params": variables["params"], **jstate}, *jargs,
                         training=False)
        got = port(pm, True)
        got_eval = port(pm, False)
    finally:
        jagg.set_agg_fused("off")
        pagg.set_agg_fused("off")
    if kind != "local":
        jout, jeval = jout[1], jeval[1]
    want_gather = port(pg, True)
    _close(got, jout, 2e-4, "train output vs JAX")
    _close(got, want_gather, 2e-4, "train output vs the gather tail")
    stats = from_jax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, jstate["batch_stats"])})
    for name, w in stats.items():
        if name.endswith(("running_mean", "running_var")):
            _close(pm.state_dict()[name], w, 2e-4, name)
            _close(pg.state_dict()[name], w, 2e-4, f"gather {name}")
    _close(got_eval, jeval, 2e-4, "eval output vs JAX")
    _close(got_eval, port(pg, False), 2e-4, "eval output vs the gather tail")
