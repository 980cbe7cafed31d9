"""The interpolation (kernel 3, ``csrc/interpolate.cu``'s listed scan) and
its VJP (kernel 9) with the decoder's stage layouts, on the CPU.

A layout changes no result: ``three_interpolation`` given the layouts of
``spatial.sort_stages`` returns exactly what it returns without them, and
the JAX package's plain path within 1e-5, forward and gradient; a layout of
another tensor, or one taken before an in-place change, raises; each
``fp{k}`` of the AA, MM and PointNet++ decoders hands the interpolation
the layouts of its own fine and coarse stage.  The kernels themselves run on the card
(``test_torch_port_cuda.py``), their visit schedules in
``test_torch_port_pruned.py``.
"""
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.ops import interpolate as jinterp
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.models import pointnext
from amcontrast3d_tpu_torch.models.build import build_model_from_cfg, init_weights_
from amcontrast3d_tpu_torch.ops import spatial
from amcontrast3d_tpu_torch.utils.config import EasyConfig

CFGS = Path(__file__).resolve().parent.parent / "cfgs" / "s3dis"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stages(rng, b, n, count=4):
    """A cloud on a 1/256 grid in [0, 1)³ (every product and sum of d² is
    exact in float32, so JAX's matmul form of d² is the port's direct one)
    and the clouds after it, each a quarter of the one before by FPS."""
    stages = [_t((rng.randint(0, 256, (b, n, 3)) / 256).astype(np.float32))]
    for _ in range(count - 1):
        prev = stages[-1]
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).contiguous())
    return stages


def _jax(p1, p2, f2):
    return np.asarray(jinterp.three_interpolation(
        jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()), jnp.asarray(f2.numpy())))


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("c", [8, 13])
def test_interpolation_over_the_stage_layouts_matches_jax_plain(s, c):
    """Stage s onto stage s − 1 with both layouts of one ``sort_stages``:
    the same bits as without them, and JAX's plain path within 1e-5."""
    rng = np.random.RandomState(10 * s + c)
    stages = _stages(rng, 2, 1024)
    clouds = spatial.sort_stages(stages)
    p1, p2 = stages[s - 1], stages[s]
    f2 = _t(rng.randn(2, p2.shape[1], c).astype(np.float32))
    got = ops.three_interpolation(p1, p2, f2, clouds[s], clouds[s - 1])
    assert got.shape == (2, p1.shape[1], c)
    assert torch.equal(got, ops.three_interpolation(p1, p2, f2))
    assert torch.equal(got, ops.three_interpolation_plain(p1, p2, f2, clouds[s],
                                                          clouds[s - 1]))
    np.testing.assert_allclose(got.numpy(), _jax(p1, p2, f2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 3])
def test_interpolation_gradient_over_the_stage_layouts_matches_jax_plain(s):
    """The VJP into the coarse features through ``_ThreeInterpolation``
    with both layouts: the same bits as without them, and ``jax.vjp`` of
    JAX's plain path within 1e-5."""
    rng = np.random.RandomState(s)
    stages = _stages(rng, 2, 1024)
    clouds = spatial.sort_stages(stages)
    p1, p2 = stages[s - 1], stages[s]
    f2 = rng.randn(2, p2.shape[1], 16).astype(np.float32)
    g = _t(rng.randn(2, p1.shape[1], 16).astype(np.float32))
    grads = []
    for layouts in ((clouds[s], clouds[s - 1]), ()):
        ft = _t(f2).requires_grad_()
        out = ops.three_interpolation(p1, p2, ft, *layouts)
        assert type(out.grad_fn).__name__ == "_ThreeInterpolationBackward"
        out.backward(g)
        grads.append(ft.grad)
    assert torch.equal(grads[0], grads[1])
    _, vjp = jax.vjp(lambda f: jinterp.three_interpolation(
        jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()), f), jnp.asarray(f2))
    np.testing.assert_allclose(grads[0].numpy(),
                               np.asarray(vjp(jnp.asarray(g.numpy()))[0]),
                               rtol=1e-5, atol=1e-5)


def test_interpolation_refuses_a_layout_of_another_tensor():
    """A layout made from another cloud (of the same shape, or the other
    stage's), or from this one before an in-place change, raises
    ``ValueError`` on the CPU as on the card, for the coarse layout and the
    fine one, in ``three_interpolation`` and ``three_interpolation_small``."""
    rng = np.random.RandomState(4)
    p1, p2 = _stages(rng, 2, 512, 2)
    other1, other2 = (p.clone() for p in (p1, p2))
    cloud, query_cloud = spatial.sort_stages([p2, p1])
    f2 = _t(rng.randn(2, p2.shape[1], 4).astype(np.float32))
    for c, qc in ((spatial.sort_support(other2), query_cloud),
                  (cloud, spatial.sort_support(other1)),
                  (query_cloud, cloud),                 # the stages swapped
                  (query_cloud, None), (None, cloud)):
        with pytest.raises(ValueError):
            ops.three_interpolation(p1, p2, f2, c, qc)
        with pytest.raises(ValueError):
            ops.three_interpolation_small(p1, p2, f2, False, c, qc)
    want = ops.three_interpolation(p1, p2, f2)
    assert torch.equal(ops.three_interpolation(p1, p2, f2, cloud, query_cloud), want)
    p2.add_(0.0)   # an in-place change, even one that moves no point
    with pytest.raises(ValueError):
        ops.three_interpolation(p1, p2, f2, cloud, query_cloud)
    assert torch.equal(ops.three_interpolation(p1, p2, f2, None, query_cloud), want)
    p1.add_(0.0)
    with pytest.raises(ValueError):
        ops.three_interpolation(p1, p2, f2, None, query_cloud)


@pytest.mark.parametrize("kind", ["AA", "MM", "pointnet++"])
def test_each_decoder_stage_hands_the_interpolation_its_layouts(kind):
    """In a forward of the AA and the MM model each ``fp{k}`` hands the
    interpolation the layouts the encoder made of its own fine (``p1``)
    and coarse (``p2``) stage: four calls, fp3 first, each layout's
    ``source`` that of its stage's tensor, the coarse stage a quarter of
    the fine one.  PointNet++'s decoder, handed no layouts, sorts its
    stage clouds once and hands them on the same way."""
    name = "pointnet++" if kind == "pointnet++" else f"AMContrast3D-{kind}"
    cfg = EasyConfig()
    cfg.load(str(CFGS / f"{name}.yaml"), recursive=True)
    cfg.update({"AA": ["model.encoder_args.width=16",
                       "model.encoder_args.blocks=[1,1,1,1,1]"],
                "MM": ["model.encoder_args.width=16",
                       "model.encoder_args.blocks=[1,1,1,1,1]",
                       "model.APM_args.feature_dim=[16,32,64,128]"],
                "pointnet++": ["model.encoder_args.width=8",
                               "model.encoder_args.layers=2"]}[kind])
    model = build_model_from_cfg(cfg.model).eval()
    init_weights_(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    pos = _t((rng.rand(2, 1024, 3) * 2).astype(np.float32))
    x = _t(rng.rand(2, 1024, 4).astype(np.float32))
    calls, sorts = [], []
    real, sort_stages = pointnext.three_interpolation, spatial.sort_stages

    def recording(p1, p2, f2, cloud=None, query_cloud=None):
        calls.append((p1, p2, cloud, query_cloud))
        return real(p1, p2, f2, cloud, query_cloud)

    def counted_sort(stages):
        sorts.append(len(stages))
        return sort_stages(stages)

    with mock.patch.object(pointnext, "three_interpolation", recording), \
            mock.patch.object(spatial, "sort_stages", counted_sort), \
            torch.no_grad():
        model(pos, x)
    assert len(calls) == 4 and len(sorts) == 1
    if kind != "pointnet++":
        assert [(p1.shape[1], p2.shape[1]) for p1, p2, *_ in calls] == \
            [(16, 4), (64, 16), (256, 64), (1024, 256)]
    for p1, p2, cloud, query_cloud in calls:
        assert cloud is not None and query_cloud is not None
        assert cloud.source == spatial._source(p2)
        assert query_cloud.source == spatial._source(p1)
        spatial.check_layout(cloud, p2)
        spatial.check_layout(query_cloud, p1)
