"""Build and run the measurement kernels of the whole-room FPS on an
NVIDIA GPU: ``tools/fps_handover.cu`` (the chunk-pruned kernel whose late
picks run in one block, handed over on the device) and
``tools/fps_micro.cu`` (the pieces of a pick in clock cycles).

Neither is a path of the package: ``ops/fps.py`` does not launch them.
``tools/profile_room_fps.py --handover T --micro`` times them beside the
shipped kernels, ``chip_smoke.py`` holds the handover kernel's picks
against the twin at the rooms' stages, and ``tests/test_torch_port_cuda.py``
covers it on the card.  Each source builds with nvcc (the package's flags,
``csrc/`` on the include path) into ``amcontrast3d_tpu_torch/_build/``,
named by a hash of the sources; nothing is built at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Dict, Optional, Tuple

import torch

from amcontrast3d_tpu_torch.ops import _build, spatial

SOURCES = {"handover": "fps_handover.cu", "micro": "fps_micro.cu"}
# the narrow kernel keeps 44 bytes a chunk in shared memory, this many
# chunks (tools/fps_handover.cu::kMaxChunks): 327680 points.  A larger
# cloud runs with handover 0, the wide kernel alone.
MAX_CHUNKS = 5120
MAX_POINTS = MAX_CHUNKS * spatial.CHUNK
# the wide kernel's cluster keeps 4 chunks a lane (16 x 512 x 4 chunks)
WIDE_MAX_POINTS = 16 * 512 * 4 * spatial.CHUNK
# hand over after the first pick that visits fewer chunks than this
HANDOVER = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "handover": {
        # sorted points (N,4) f32 with the index bits in w, boxes
        # (ceil(N/64),6), xyz (N,3) in the original order, mind (N)
        # scratch, hkey (ceil(N/64)) u64, hpos (ceil(N/64),4) f32, hnext (1)
        # i32, out (npoint) i32, visits (1) u64 zeroed or null, N, npoint,
        # handover, stream
        "amc3d_fps_handover": (_P,) * 9 + (_I, _I, _I, _P),
    },
    "micro": {
        "amc3d_micro_primitives": (_P, _P, _I, _P, _I),
        "amc3d_micro_visit_round": (_P, _P, _I, _I, _I, _P),
        "amc3d_micro_pick_round": (_I, _I, _P),
    },
}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Build (once for these sources and flags) and load ``SOURCES[name]``;
    raises :class:`_build.KernelBuildError` where nvcc fails."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       SOURCES[name])
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for path in [src, *sorted(map(str, _build.CSRC_DIR.glob("*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    so = _build.BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
               "-I", str(_build.CSRC_DIR), "-o", str(tmp), src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise _build.KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.amc3d_tool_error.argtypes = [ctypes.c_int]
    lib.amc3d_tool_error.restype = ctypes.c_char_p
    return lib


def _raise(lib: ctypes.CDLL, entry: str, err: int) -> None:
    if err != 0:
        msg = lib.amc3d_tool_error(err).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed ({err}: {msg})")


def furthest_point_sample_handover(
        xyz: torch.Tensor, npoint: int, handover: int = HANDOVER,
        visits: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cloud, xyz (1, N, 3) f32 on the card → (idx (1, npoint) int32,
    the first pick the one-block kernel took, a (1,) int32 CUDA tensor:
    npoint where the wide kernel took every pick).  The picks are those of
    ``ops.furthest_point_sample_plain``.  The wide kernel hands over after
    the first pick that visits fewer than ``handover`` chunks; a cloud of
    more than :data:`MAX_CHUNKS` chunks, or ``handover`` 0, runs the wide
    kernel alone.  ``visits``, a zeroed (1,) int64 CUDA tensor, gains the
    chunk visits.  A launch the card refuses raises."""
    if xyz.device.type != "cuda" or not xyz.is_contiguous() \
            or xyz.dim() != 3 or xyz.shape[0] != 1 or xyz.shape[2] != 3 \
            or xyz.dtype != torch.float32:
        raise ValueError(f"the handover fps kernel takes one contiguous (1, N,"
                         f" 3) float32 CUDA cloud, got {tuple(xyz.shape)} "
                         f"{xyz.dtype} on {xyz.device}")
    n = xyz.shape[1]
    if not 1 <= npoint <= n:
        raise ValueError(f"fps npoint={npoint} not in [1, N={n}]")
    nc = -(-n // spatial.CHUNK)
    if nc > MAX_CHUNKS:
        handover = 0
    cloud = spatial.sort_stages([xyz])[0]
    dev = xyz.device
    mind = torch.empty(n, dtype=torch.float32, device=dev)
    hkey = torch.empty(nc, dtype=torch.int64, device=dev)
    hpos = torch.empty(nc, 4, dtype=torch.float32, device=dev)
    hnext = torch.full((1,), npoint, dtype=torch.int32, device=dev)
    out = torch.empty(1, npoint, dtype=torch.int32, device=dev)
    lib = library("handover")
    err = lib.amc3d_fps_handover(
        cloud.packed.data_ptr(), cloud.boxes.data_ptr(), xyz.data_ptr(),
        mind.data_ptr(), hkey.data_ptr(), hpos.data_ptr(), hnext.data_ptr(),
        out.data_ptr(), None if visits is None else visits.data_ptr(), n,
        npoint, handover, torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, "amc3d_fps_handover", err)
    return out, hnext


MICRO_PRIMITIVES = ("warp_max (two redux)", "one 32-bit redux",
                    "64-bit shuffle butterfly", "16 keys from shared memory",
                    "__syncthreads", "dependent L2 float4 load",
                    "dependent min-distance load and store",
                    "shared atomicAdd and broadcast", "ballot")


def micro(dev: torch.device) -> Dict[str, int]:
    """The clock cycles of the pieces of a pick on one multiprocessor (a
    311296-point cloud's worth of points in device memory): each primitive
    at 32 and 512 threads; a round of late-pick visits by 1, 9 and 16 warps
    (with and without the min-distance stores) and a block barrier; the
    one-block kernel's pick phase over 3 and 152 groups, its body once and
    as one of 8 copies."""
    lib = library("micro")
    n = 311296
    pts = torch.rand(n, 4, device=dev)
    pts[:, 3] = torch.arange(n, device=dev).to(torch.int32).view(torch.float32)
    mind = torch.rand(n, device=dev) * 100
    out = torch.zeros(9, dtype=torch.int64, device=dev)
    got = {}
    for threads in (32, 512):
        for _ in range(2):   # the second run is the one read
            _raise(lib, "amc3d_micro_primitives", lib.amc3d_micro_primitives(
                pts.data_ptr(), mind.data_ptr(), n, out.data_ptr(), threads))
        for name, cycles in zip(MICRO_PRIMITIVES, out.tolist()):
            got[f"{name}, {threads} threads"] = cycles
    mind.fill_(1e10)
    for store in (0, 1):
        for visitors in (1, 9, 16):
            for _ in range(2):
                _raise(lib, "amc3d_micro_visit_round", lib.amc3d_micro_visit_round(
                    pts.data_ptr(), mind.data_ptr(), n // spatial.CHUNK,
                    visitors, store, out.data_ptr()))
            got[f"visit round, {visitors} warps visiting, "
                f"{'with' if store else 'without'} stores"] = int(out[0])
    for groups in (3, 152):
        for copies in (1, 8):
            for _ in range(2):
                _raise(lib, "amc3d_micro_pick_round", lib.amc3d_micro_pick_round(
                    groups, copies, out.data_ptr()))
            got[f"pick phase, {groups} groups, {copies} "
                f"cop{'y' if copies == 1 else 'ies'}"] = int(out[0])
    return got
