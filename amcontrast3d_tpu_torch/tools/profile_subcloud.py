"""Time one room subcloud's forward, as the whole-scene test runs it, on one
CUDA device.

    python3 -m amcontrast3d_tpu_torch.tools.profile_subcloud [--buckets 106496,221184] [--runs R]

For each bucket: a room-like cloud of that many points (the faces of a
7 x 6 x 3 m room and four solid boxes, one point a voxel: 0.04 m to 155648
points as the S3DIS recipe, 0.02 m from 221184 as the ScanNet recipe) and
random input features, through ``BaseSeg_AMContrast3D`` of the recipe's AA
cfg (``cfgs/s3dis/AMContrast3D-AA.yaml`` or ``cfgs/scannet/...``;
PointNeXt-XL, random weights from a seed, fp32, TF32 off) at B = 1 under
``torch.inference_mode``, as ``Runner.predict_fn`` scores a subcloud.  It
prints, with the card's name and power limit:

1. wall ms per forward (``torch.cuda.synchronize()`` on both sides):
   median, quartiles and extremes of R forwards after 2 warm-up ones;
2. device ms per forward of the interpolation's kernels (by name: the
   listed ``interp_kernel``, the lane-a-point ``interp_big_kernel``) and
   of every kernel, from ``torch.profiler`` over 3 forwards, and the
   card's idle share of that wall time.

It reads only what every version of the package has, so
``tools/profile_ab.sh`` runs it over a parent's package
(``AB_TOOLS=profile_subcloud``).  Without a CUDA device it exits non-zero
before measuring anything.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

AB_BOTH_PACKAGES = True
SEED = 0
BUCKETS = (106496, 155648, 221184, 311296)
S3DIS_MAX = 155648          # buckets to here are the S3DIS recipe's
ROOT = Path(__file__).resolve().parents[2]
INTERP = ("interp_kernel", "interp_big_kernel")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def room_cloud(rng, n: int, voxel: float) -> np.ndarray:
    """(1, n, 3) f32: the faces of a 7 x 6 x 3 m room (1 cm of noise) and
    four solid boxes, one point a voxel, 2 % of the points repeated."""
    pts = rng.rand(4 * n, 3) * [7, 6, 3]
    axis = rng.randint(0, 3, len(pts))
    side = rng.randint(0, 2, len(pts)) * np.array([7, 6, 3])[axis]
    pts[np.arange(len(pts)), axis] = side + 0.01 * rng.randn(len(pts))
    solid = rng.rand(n, 3) * [1.2, 1.0, 0.8] + \
        rng.randint(1, 5, (n, 1)) * [1.2, 1.0, 0.0]
    pts = np.concatenate([pts, solid])
    _, first = np.unique(np.floor(pts / voxel).astype(np.int64), axis=0,
                         return_index=True)
    if len(first) < n:
        raise ValueError(f"room holds {len(first)} voxels, fewer than {n}")
    pts = pts[rng.permutation(first)[:n]]
    pts[rng.randint(0, n, n // 50)] = pts[rng.randint(0, n, n // 50)]
    return pts[None].astype(np.float32)


def forward_ms(model, pos, x, n: int) -> list:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            model(pos, x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def kernel_ms(model, pos, x, n: int):
    """(wall ms a forward, {kernel name: device ms a forward}) over ``n``
    profiled forwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            for _ in range(n):
                model(pos, x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:   # the attribute's name before PyTorch 2.4
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and us > 0 and \
                not getattr(e, "is_user_annotation", False):
            rows[e.key] = rows.get(e.key, 0.0) + us / 1e3 / n
    return wall, rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--buckets", default=",".join(map(str, BUCKETS)))
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_subcloud: no CUDA device")
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    tag = card()
    print(f"{tag}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for bucket in map(int, args.buckets.split(",")):
        recipe = "s3dis" if bucket <= S3DIS_MAX else "scannet"
        cfg = EasyConfig()
        cfg.load(str(ROOT / "cfgs" / recipe / "AMContrast3D-AA.yaml"),
                 recursive=True)
        model = build_model_from_cfg(cfg.model)
        init_weights_(model, torch.Generator().manual_seed(SEED))
        model = model.to(dev).eval()
        rng = np.random.RandomState(SEED + bucket)
        pos = torch.from_numpy(room_cloud(
            rng, bucket, 0.04 if recipe == "s3dis" else 0.02)).to(dev)
        x = torch.from_numpy(rng.rand(1, bucket, cfg.model.encoder_args.in_channels)
                             .astype(np.float32)).to(dev)
        forward_ms(model, pos, x, 2)
        ts = forward_ms(model, pos, x, args.runs)
        q1, _, q3 = statistics.quantiles(ts, n=4)
        wall, rows = kernel_ms(model, pos, x, 3)
        interp = {k: v for k, v in rows.items() if any(n in k for n in INTERP)
                  and "bwd" not in k}
        busy = sum(rows.values())
        print(f"subcloud {bucket} ({recipe} AA, B=1): forward median "
              f"{statistics.median(ts):.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}, min "
              f"{min(ts):.3f}, max {max(ts):.3f}, n={args.runs}); profiled "
              f"wall {wall:.3f} ms, kernel device time {busy:.3f} ms, idle "
              f"share {1 - busy / wall:.4f}; interpolation kernels "
              + ", ".join(f"{k.split('(')[0][-40:]} {v:.4f} ms"
                          for k, v in sorted(interp.items()))
              + f" (sum {sum(interp.values()):.4f})  [{tag}]")
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
