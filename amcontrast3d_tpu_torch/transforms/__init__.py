"""Data transforms (numpy, per-sample) — ↔ ``amcontrast3d_tpu/transforms``.

Every class of the JAX package, copied: numpy arrays in, numpy arrays out,
drawing from the process RNG (``np.random``) in the same order, so one seed
gives one sample in both packages (the loader's workers reseed numpy each,
``data/build.py``).  The reference splits them between a CPU file and a
"GPU" file; both run per sample on the host.

Factory contract (``transforms_factory.py:45-60``): a list of names plus one
shared ``kwargs`` dict composes into a single callable.
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import expm, norm

from ..utils.registry import Registry

DataTransforms = Registry("datatransforms")


@DataTransforms.register_module()
class PointsToTensor:
    """No-op placeholder for API parity (arrays stay numpy until they go to
    the device); float64 arrays become float32."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data):
        for k, v in data.items():
            if isinstance(v, np.ndarray) and v.dtype == np.float64:
                data[k] = v.astype(np.float32)
        return data


@DataTransforms.register_module()
class PointCloudToTensor:
    """↔ point_transformer_gpu.py:18-32.  The reference torch version also
    transposes ``normals``/``colors`` to channel-first; the pipeline here is
    channels-last end to end, so this is a float32 cast only."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data):
        for k in ("pos", "normals", "colors"):
            if k in data and isinstance(data[k], np.ndarray):
                data[k] = data[k].astype(np.float32)
        return data


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@DataTransforms.register_module()
class PointCloudCenterAndNormalize:
    """↔ point_transformer_gpu.py:36-68."""

    def __init__(self, centering=True, normalize=True, gravity_dim=2, **kwargs):
        self.centering = centering
        self.normalize = normalize
        self.gravity_dim = gravity_dim

    def __call__(self, data):
        pos = data["pos"]
        if "heights" not in data:
            data["heights"] = (pos[:, self.gravity_dim:self.gravity_dim + 1]
                               - pos[:, self.gravity_dim:self.gravity_dim + 1].min())
        if self.centering:
            pos = pos - pos.mean(0, keepdims=True)
        if self.normalize:
            m = np.max(np.sqrt(np.sum(pos ** 2, axis=1)))
            pos = pos / np.maximum(m, 1e-6)
        data["pos"] = pos
        return data


@DataTransforms.register_module()
class PointCloudXYZAlign:
    """Center xy, shift z-min to 0 (↔ point_transformer_gpu.py:71-89)."""

    def __init__(self, gravity_dim=2, **kwargs):
        self.gravity_dim = gravity_dim

    def __call__(self, data):
        pos = data["pos"]
        pos = pos - pos.mean(axis=0, keepdims=True)
        pos[:, self.gravity_dim] -= pos[:, self.gravity_dim].min()
        data["pos"] = pos
        return data


@DataTransforms.register_module()
class PointCloudScaling:
    """Anisotropic scale + optional mirror (↔ point_transformer_gpu.py:136-164)."""

    def __init__(self, scale=[2. / 3, 3. / 2], anisotropic=True,
                 scale_xyz=[True, True, True], mirror=[0, 0, 0], **kwargs):
        self.scale_min, self.scale_max = float(scale[0]), float(scale[1])
        self.anisotropic = anisotropic
        self.scale_xyz = scale_xyz
        self.mirror = np.array(mirror)
        self.use_mirroring = np.sum(self.mirror > 0) != 0

    def __call__(self, data):
        scale = np.random.rand(3 if self.anisotropic else 1).astype(np.float32) * (
            self.scale_max - self.scale_min) + self.scale_min
        if self.use_mirroring:
            mirror = (np.random.rand(3) > self.mirror).astype(np.float32) * 2 - 1
            scale = scale * mirror
        for i, s in enumerate(self.scale_xyz):
            if not s:
                scale[i] = 1.0
        data["pos"] = data["pos"] * scale
        return data


@DataTransforms.register_module()
class PointCloudTranslation:
    """↔ point_transformer_gpu.py:168-180."""

    def __init__(self, shift=[0.2, 0.2, 0.], **kwargs):
        self.shift = np.array(shift, dtype=np.float32)

    def __call__(self, data):
        t = (np.random.rand(3).astype(np.float32) * 2 - 1) * self.shift
        data["pos"] = data["pos"] + t
        return data


@DataTransforms.register_module()
class PointCloudScaleAndTranslate:
    def __init__(self, scale=[2. / 3, 3. / 2], scale_xyz=[True, True, True],
                 anisotropic=True, shift=[0.2, 0.2, 0.2], **kwargs):
        self.scaler = PointCloudScaling(scale=scale, scale_xyz=scale_xyz,
                                        anisotropic=anisotropic)
        self.translator = PointCloudTranslation(shift=shift)

    def __call__(self, data):
        return self.translator(self.scaler(data))


@DataTransforms.register_module()
class PointCloudJitter:
    """Clamped gaussian jitter (↔ point_transformer_gpu.py:217-229)."""

    def __init__(self, jitter_sigma=0.01, jitter_clip=0.05, **kwargs):
        self.noise_std = jitter_sigma
        self.noise_clip = jitter_clip

    def __call__(self, data):
        noise = np.random.randn(*data["pos"].shape).astype(np.float32) * self.noise_std
        data["pos"] = data["pos"] + np.clip(noise, -self.noise_clip, self.noise_clip)
        return data


@DataTransforms.register_module()
class PointCloudScaleAndJitter:
    def __init__(self, scale=[2. / 3, 3. / 2], scale_xyz=[True, True, True],
                 anisotropic=True, jitter_sigma=0.01, jitter_clip=0.05,
                 mirror=[0, 0, 0], **kwargs):
        self.scaler = PointCloudScaling(scale=scale, scale_xyz=scale_xyz,
                                        anisotropic=anisotropic, mirror=mirror)
        self.jitter = PointCloudJitter(jitter_sigma=jitter_sigma,
                                       jitter_clip=jitter_clip)

    def __call__(self, data):
        return self.jitter(self.scaler(data))


@DataTransforms.register_module()
class PointCloudRotation:
    """Random-order axis rotations (↔ point_transformer_gpu.py:268-312)."""

    def __init__(self, angle=[0, 0, 0], **kwargs):
        self.angle = np.array(angle) * np.pi

    @staticmethod
    def M(axis, theta):
        return expm(np.cross(np.eye(3), axis / norm(axis) * theta))

    def __call__(self, data):
        rot_mats = []
        for axis_ind, rot_bound in enumerate(self.angle):
            theta = 0.0
            axis = np.zeros(3)
            axis[axis_ind] = 1
            if rot_bound is not None:
                theta = np.random.uniform(-rot_bound, rot_bound)
            rot_mats.append(self.M(axis, theta))
        np.random.shuffle(rot_mats)
        rot = (rot_mats[0] @ rot_mats[1] @ rot_mats[2]).astype(np.float32)
        data["pos"] = data["pos"] @ rot.T
        return data


@DataTransforms.register_module()
class RandomDropout:
    """↔ point_transformer_gpu.py:93-109."""

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.2, **kwargs):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data):
        if np.random.rand() < self.dropout_application_ratio:
            n = len(data["pos"])
            inds = np.random.permutation(n)[: int(n * (1 - self.dropout_ratio))]
            for k, v in data.items():
                if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
                    data[k] = v[inds]
        return data


@DataTransforms.register_module()
class RandomHorizontalFlip:
    """↔ point_transformer_gpu.py:112-133."""

    def __init__(self, upright_axis="z", p=0.5, **kwargs):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = [a for a in range(3) if a != self.upright_axis]
        self.p = p

    def __call__(self, data):
        for ax in self.horz_axes:
            if np.random.rand() < self.p:
                pos = data["pos"]
                pos[:, ax] = pos[:, ax].max() - pos[:, ax]
                data["pos"] = pos
        return data


# ---------------------------------------------------------------------------
# chromatic
# ---------------------------------------------------------------------------

@DataTransforms.register_module()
class ChromaticAutoContrast:
    """↔ point_transform_cpu.py:192-209."""

    def __init__(self, p=0.2, blend_factor=None, **kwargs):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data):
        if np.random.rand() < self.p:
            lo = np.min(data["x"][:, :3], 0, keepdims=True)
            hi = np.max(data["x"][:, :3], 0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (data["x"][:, :3] - lo) * scale
            blend = np.random.rand() if self.blend_factor is None else self.blend_factor
            data["x"][:, :3] = (1 - blend) * data["x"][:, :3] + blend * contrast
        return data


@DataTransforms.register_module()
class ChromaticTranslation:
    """↔ point_transform_cpu.py:213-223."""

    def __init__(self, p=0.95, ratio=0.05, **kwargs):
        self.p = p
        self.ratio = ratio

    def __call__(self, data):
        if np.random.rand() < self.p:
            tr = (np.random.rand(1, 3) - 0.5) * 255 * 2 * self.ratio
            data["x"][:, :3] = np.clip(tr + data["x"][:, :3], 0, 255)
        return data


@DataTransforms.register_module()
class ChromaticJitter:
    """↔ point_transform_cpu.py:226-237."""

    def __init__(self, p=0.95, std=0.005, **kwargs):
        self.p = p
        self.std = std

    def __call__(self, data):
        if np.random.rand() < self.p:
            noise = np.random.randn(data["x"].shape[0], 3) * self.std * 255
            data["x"][:, :3] = np.clip(noise + data["x"][:, :3], 0, 255)
        return data


@DataTransforms.register_module()
class ChromaticDropGPU:
    """Drop all colors with probability p (↔ point_transformer_gpu.py:374-381)."""

    def __init__(self, color_drop=0.2, **kwargs):
        self.color_drop = color_drop

    def __call__(self, data):
        if np.random.rand() < self.color_drop:
            data["x"][:, :3] = 0
        return data


@DataTransforms.register_module()
class ChromaticPerDropGPU:
    """↔ point_transformer_gpu.py:385-392."""

    def __init__(self, color_drop=0.2, **kwargs):
        self.color_drop = color_drop

    def __call__(self, data):
        drop = (np.random.rand(data["x"].shape[0], 1) > self.color_drop)
        data["x"][:, :3] = data["x"][:, :3] * drop.astype(np.float32)
        return data


@DataTransforms.register_module()
class ChromaticNormalize:
    """↔ point_transformer_gpu.py:396-409."""

    def __init__(self, color_mean=[0.5136457, 0.49523646, 0.44921124],
                 color_std=[0.18308958, 0.18415008, 0.19252081], **kwargs):
        self.color_mean = np.array(color_mean, dtype=np.float32)
        self.color_std = np.array(color_std, dtype=np.float32)

    def __call__(self, data):
        if data["x"][:, :3].max() > 1:
            data["x"][:, :3] = data["x"][:, :3] / 255.0
        data["x"][:, :3] = (data["x"][:, :3] - self.color_mean) / self.color_std
        return data


@DataTransforms.register_module()
class RandomDropFeature:
    """↔ point_transform_cpu.py:304-315."""

    def __init__(self, feature_drop=0.2, drop_dim=[0, 3], **kwargs):
        self.p = feature_drop
        self.dim = drop_dim

    def __call__(self, data):
        if np.random.rand() < self.p:
            data["x"][:, self.dim[0]:self.dim[-1]] = 0
        return data


@DataTransforms.register_module()
class NumpyChromaticNormalize:
    """↔ point_transform_cpu.py:318-332."""

    def __init__(self, color_mean=None, color_std=None, **kwargs):
        self.color_mean = (np.array(color_mean, dtype=np.float32)
                           if color_mean is not None else None)
        self.color_std = (np.array(color_std, dtype=np.float32)
                          if color_std is not None else None)

    def __call__(self, data):
        if data["x"][:, :3].max() > 1:
            data["x"][:, :3] = data["x"][:, :3] / 255.0
        if self.color_mean is not None:
            data["x"][:, :3] = (data["x"][:, :3] - self.color_mean) / self.color_std
        return data


# legacy CPU aliases (point_transform_cpu.py names)
@DataTransforms.register_module()
class RandomRotate:
    """↔ point_transform_cpu.py:23-40."""

    def __init__(self, angle=[0, 0, 1], **kwargs):
        self.rot = PointCloudRotation(angle=angle)

    def __call__(self, data):
        return self.rot(data)


@DataTransforms.register_module()
class RandomRotateZ:
    """↔ point_transform_cpu.py:43-67."""

    def __init__(self, angle=1.0, rotate_dim=2, random_rotate=True, **kwargs):
        self.angle = angle * np.pi
        self.random_rotate = random_rotate
        self.rotate_dim = rotate_dim

    def __call__(self, data):
        theta = (np.random.uniform(-self.angle, self.angle)
                 if self.random_rotate else self.angle)
        c, s = np.cos(theta), np.sin(theta)
        dims = [d for d in range(3) if d != self.rotate_dim]
        rot = np.eye(3, dtype=np.float32)
        rot[dims[0], dims[0]] = c
        rot[dims[0], dims[1]] = -s
        rot[dims[1], dims[0]] = s
        rot[dims[1], dims[1]] = c
        data["pos"] = data["pos"] @ rot.T
        return data


@DataTransforms.register_module()
class RandomScale:
    """↔ point_transform_cpu.py:70-96."""

    def __init__(self, scale=[0.8, 1.2], scale_anisotropic=False,
                 scale_xyz=[True, True, True], mirror=[-1, -1, -1], **kwargs):
        self.scale_min, self.scale_max = scale
        self.anisotropic = scale_anisotropic
        self.scale_xyz = scale_xyz
        self.mirror = np.array(mirror)

    def __call__(self, data):
        scale = np.random.uniform(self.scale_min, self.scale_max,
                                  3 if self.anisotropic else 1)
        if len(scale) == 1:
            scale = scale.repeat(3)
        if (self.mirror > 0).sum() > 0:
            mirror = (np.random.rand(3) > self.mirror) * 2 - 1
            scale *= mirror
        for i, s in enumerate(self.scale_xyz):
            if not s:
                scale[i] = 1
        data["pos"] = data["pos"] * scale.astype(np.float32)
        return data


@DataTransforms.register_module()
class RandomShift:
    """↔ point_transform_cpu.py:132-143."""

    def __init__(self, shift=[0.2, 0.2, 0], **kwargs):
        self.shift = shift

    def __call__(self, data):
        s = [np.random.uniform(-m, m) for m in self.shift]
        data["pos"] = data["pos"] + np.array(s, dtype=np.float32)
        return data


@DataTransforms.register_module()
class RandomScaleAndTranslate:
    def __init__(self, scale=[0.9, 1.1], shift=[0.2, 0.2, 0],
                 scale_xyz=[1, 1, 1], **kwargs):
        self.scaler = RandomScale(scale=scale, scale_xyz=scale_xyz)
        self.shifter = RandomShift(shift=shift)

    def __call__(self, data):
        return self.shifter(self.scaler(data))


@DataTransforms.register_module()
class RandomFlip:
    """↔ point_transform_cpu.py:167-177."""

    def __init__(self, p=0.5, **kwargs):
        self.p = p

    def __call__(self, data):
        if np.random.rand() < self.p:
            data["pos"][:, 0] = -data["pos"][:, 0]
        if np.random.rand() < self.p:
            data["pos"][:, 1] = -data["pos"][:, 1]
        return data


@DataTransforms.register_module()
class RandomJitter:
    """↔ point_transform_cpu.py:180-189."""

    def __init__(self, jitter_sigma=0.01, jitter_clip=0.05, **kwargs):
        self.jitter = PointCloudJitter(jitter_sigma=jitter_sigma,
                                       jitter_clip=jitter_clip)

    def __call__(self, data):
        return self.jitter(data)


@DataTransforms.register_module()
class RandomScaleAndJitter:
    """↔ point_transform_cpu.py:99-129: one anisotropic-or-isotropic scale
    plus clipped gaussian jitter in a single transform."""

    def __init__(self, scale=[0.8, 1.2], scale_xyz=[True, True, True],
                 scale_anisotropic=False, jitter_sigma=0.01,
                 jitter_clip=0.05, mirror=[-1, -1, -1], **kwargs):
        self.scale = scale
        self.scale_xyz = scale_xyz
        self.anisotropic = scale_anisotropic
        self.noise_sigma = jitter_sigma
        self.noise_clip = jitter_clip
        self.mirror = np.array(mirror)
        self.use_mirroring = np.sum(self.mirror > 0) != 0

    def __call__(self, data):
        scale = np.random.uniform(self.scale[0], self.scale[1],
                                  3 if self.anisotropic else 1)
        if len(scale) == 1:
            scale = scale.repeat(3)
        if self.use_mirroring:
            mirror = (np.random.rand(3) > self.mirror).astype(np.float32) * 2 - 1
            scale *= mirror
        for i, s in enumerate(self.scale_xyz):
            if not s:
                scale[i] = 1
        jitter = np.clip(
            self.noise_sigma * np.random.randn(data["pos"].shape[0], 3),
            -self.noise_clip, self.noise_clip)
        data["pos"] = (data["pos"] * scale + jitter).astype(np.float32)
        return data


@DataTransforms.register_module()
class HueSaturationTranslation:
    """↔ point_transform_cpu.py:240-301: random hue shift + saturation scale
    on 0-255 RGB features via the colorsys-style hsv round-trip (including
    the reference's uint8 truncation on the way back)."""

    @staticmethod
    def rgb_to_hsv(rgb):
        rgb = rgb.astype("float")
        hsv = np.zeros_like(rgb)
        hsv[..., 3:] = rgb[..., 3:]
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        maxc = np.max(rgb[..., :3], axis=-1)
        minc = np.min(rgb[..., :3], axis=-1)
        hsv[..., 2] = maxc
        mask = maxc != minc
        hsv[mask, 1] = (maxc - minc)[mask] / maxc[mask]
        rc = np.zeros_like(r)
        gc = np.zeros_like(g)
        bc = np.zeros_like(b)
        rc[mask] = (maxc - r)[mask] / (maxc - minc)[mask]
        gc[mask] = (maxc - g)[mask] / (maxc - minc)[mask]
        bc[mask] = (maxc - b)[mask] / (maxc - minc)[mask]
        hsv[..., 0] = np.select([r == maxc, g == maxc],
                                [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc)
        hsv[..., 0] = (hsv[..., 0] / 6.0) % 1.0
        return hsv

    @staticmethod
    def hsv_to_rgb(hsv):
        rgb = np.empty_like(hsv)
        rgb[..., 3:] = hsv[..., 3:]
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = (h * 6.0).astype("uint8")
        f = (h * 6.0) - i
        p = v * (1.0 - s)
        q = v * (1.0 - s * f)
        t = v * (1.0 - s * (1.0 - f))
        i = i % 6
        conditions = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
        rgb[..., 0] = np.select(conditions, [v, q, p, p, t, v], default=v)
        rgb[..., 1] = np.select(conditions, [v, v, v, q, p, p], default=t)
        rgb[..., 2] = np.select(conditions, [v, p, t, v, v, q], default=p)
        return rgb.astype("uint8")

    def __init__(self, hue_max=0.5, saturation_max=0.2, **kwargs):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, data):
        hsv = HueSaturationTranslation.rgb_to_hsv(data["x"][:, :3])
        hue_val = (np.random.rand() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (np.random.rand() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        data["x"][:, :3] = np.clip(
            HueSaturationTranslation.hsv_to_rgb(hsv), 0, 255)
        return data


def _one_hot_np(y, num_classes, on_value, off_value):
    out = np.full((y.size, num_classes), off_value, np.float32)
    out[np.arange(y.size), y.reshape(-1).astype(np.int64)] = on_value
    return out


def mixup_target(target, num_classes, lam=1.0, smoothing=0.0):
    """↔ point_transformer_gpu.py:417-423 on host numpy."""
    off_value = smoothing / num_classes
    on_value = 1.0 - smoothing + off_value
    y1 = _one_hot_np(target, num_classes, on_value, off_value)
    y2 = _one_hot_np(target[::-1], num_classes, on_value, off_value)
    return y1 * lam + y2 * (1.0 - lam)


@DataTransforms.register_module()
class Cutmix:
    """↔ point_transformer_gpu.py:425-461: batch-level cutmix — splice the
    last ``lam·N`` points of each cloud from the batch-flipped clouds and
    return the lam-blended smoothed one-hot target.

    Channels-last layout: ``pos``/``x`` are (B, N, C).  Call as
    ``data, target = cutmix(data, target)`` on an already-collated batch."""

    def __init__(self, cutmix_alpha=0.3, prob=1.0, label_smoothing=0.1,
                 num_classes=1000, **kwargs):
        self.cutmix_alpha = cutmix_alpha
        self.mix_prob = prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def _mix_batch(self, data):
        lam = np.random.beta(self.cutmix_alpha, self.cutmix_alpha)
        if hasattr(data, "keys"):
            n = data["pos"].shape[1]
            n_mix = int(n * lam)
            if n_mix > 0:
                # .copy(): torch's flip(0) materializes; numpy's [::-1] is an
                # aliasing view and in-place assignment would corrupt the swap
                data["pos"][:, -n_mix:] = data["pos"][::-1].copy()[:, -n_mix:]
                if "x" in data.keys():
                    data["x"][:, -n_mix:] = data["x"][::-1].copy()[:, -n_mix:]
        else:
            n_mix = int(data.shape[1] * lam)
            if n_mix > 0:
                data[:, -n_mix:] = data[::-1].copy()[:, -n_mix:]
        return lam

    def __call__(self, data, target):
        lam = self._mix_batch(data)
        target = mixup_target(target, self.num_classes, lam,
                              self.label_smoothing)
        return data, target


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def build_transforms_from_cfg(split: str, datatransforms_cfg) -> Compose:
    """↔ transforms_factory.py:45-60: cfg[split] is a name list, cfg.kwargs
    the shared kwargs."""
    if datatransforms_cfg is None:
        return Compose([])
    cfg = dict(datatransforms_cfg)
    names = cfg.get(split) or []
    kwargs = dict(cfg.get("kwargs") or {})
    transforms = [DataTransforms.build(name, **kwargs) for name in names]
    return Compose(transforms)
