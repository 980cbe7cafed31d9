"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):
one nvcc per source, all started together, then one link.  The
library is written to ``amcontrast3d_tpu_torch/_build/``, named by a hash
of the sources and flags, so an edit to any kernel rebuilds it and an
unchanged tree reuses it.  Without ``nvcc``, or when the build fails, this
raises :class:`KernelBuildError`; nothing falls back to another path.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after the launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# where the CUDA toolkit lives when neither CUDA_HOME nor PATH names it
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

# -fmad=false: no FMA contraction, so d² = (dx·dx + dy·dy) + dz·dz rounds
# exactly as the plain PyTorch twins (separate mul/add ops) round it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: (argtypes), all returning the cudaError_t as an int
_SIGNATURES = {
    # xyz (B,N,3) f32, out (B,npoint) i32, B, N, npoint, cluster size S,
    # stream
    "amc3d_fps": (_P, _P, _I, _I, _I, _I, _P),
    # S → how many clusters of S blocks the device holds at once (negative:
    # an error)
    "amc3d_fps_clusters": (_I,),
    # the grid kernel, one cloud: xyz (1,N,3) f32, out (npoint) i32, best
    # (npoint) u64 zeroed, arrived (npoint) u32 zeroed, N, npoint, stream
    "amc3d_fps_grid": (_P, _P, _P, _P, _I, _I, _P),
    # chunk-pruned, one cluster: sorted points (N,4) f32 with the index
    # bits in w, boxes (ceil(N/64),6), xyz of point 0, mind (N) scratch, out
    # (npoint) i32, visits (1) u64 zeroed or null, N, npoint, stream
    "amc3d_fps_pruned": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # sorted support (B,N,4) f32 with the index bits in w, boxes
    # (B,ceil(N/64),6), the queries as sorted (B,M,4) with their index bits
    # or as query (B,M,3) with order (B,M) i32 (the other null), out
    # (B,M,ld) i32, B, N, M, k of the pass (≤ 128), ld, first slot, r²,
    # stream
    "amc3d_ball_query": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                         _P),
    # the coarse cloud's layout: sorted (B,N2,4) f32 with the index bits in
    # w, boxes (B,ceil(N2/64),6), sorted Morton codes (B,N2) i64, the frame's
    # lo (B rows of 3 f32) and row stride, scale (B f32) and stride; p1
    # (B,N1,3), the fine points' order (B,N1) i32 and its element stride,
    # home (B,N1) i32 or null, f2 (B,N2,C), out (B,N1,C), idx_out (B,N1,3)
    # i32 or null, w_out (B,N1,3) or null, B, N1, N2, C, stream
    "amc3d_three_interpolate": (_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P,
                                _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # a lane a fine point: amc3d_three_interpolate's arguments to w_out,
    # then visits (1) u64 zeroed or null, B, N1, N2, C, stream
    "amc3d_three_interpolate_big": (_P, _P, _P, _P, _I, _P, _I, _P, _P, _I,
                                    _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _P),
    # g (B,N1,C), idx (B,N1,3) i32, w (B,N1,3), the fine points' order
    # (B,N1) i32 or null and its element stride, df2 (B,N2,C) (zeroed by the
    # entry point), B, N1, N2, C, stream
    "amc3d_three_interpolate_backward": (_P, _P, _P, _P, _I, _P, _I, _I, _I,
                                         _I, _P),
    # deterministic, over per-row lists: g, idx, w, the coarse rows' order
    # (B,N2) i32 or null and its element stride, work (i32 scratch on 16
    # bytes, its size in ops/interpolate.py), df2 (B,N2,C) (every element
    # written), B, N1, N2, C, stream
    "amc3d_three_interpolate_backward_big": (_P, _P, _P, _P, _I, _P, _P, _I,
                                             _I, _I, _I, _P),
    # every contrast kernel reads the sorted cloud (B,N,4) f32 with the
    # index bits in w, (label, threshold) of each sorted point (B,N,2) and
    # boxes (B,ceil(N/64),6).  Forward: those, f (B,N,C), out (B,N,9), B, N,
    # C, tinv, cctype_root, need_s, need_d, stream
    "amc3d_contrast_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                               _I, _P),
    # rows: the layout, f, g4 (B,N,4) (gradients of P, Q, Spos, Sneg),
    # df (B,N,C), B, N, C, tinv, need_s, stream
    "amc3d_contrast_grad_rows": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                                 _P),
    # support: the layout, the largest threshold a chunk (B,ceil(N/64)),
    # f, g4, df (B,N,C), B, N, C, tinv, need_s, stream
    "amc3d_contrast_grad_support": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _F, _I, _P),
    # sorted support (B,N,4) f32 with the index bits in w, boxes
    # (B,ceil(N/64),6), query (B,M,3), order (B,M) i32, home (B,M) i32,
    # idx and d2 at the pass's first slot of (B,M,ld) i32 / f32, B, N, M,
    # k of the pass (≤ 128), ld, first slot, stream
    "amc3d_knn": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the stage clouds (T,3) f32 one after another, the first row of each
    # (stage, cloud) segment (nseg+1) i64, keys (T) i64, frame (nseg,4) f32,
    # nseg, stream
    "amc3d_layout_keys": (_P, _P, _P, _P, _I, _P),
    # points (T,3), perm and sorted keys (T) i64, segment rows (nseg+1) i64,
    # segment chunks (nseg+1) i32, packed (T,4) f32, codes (T) i64, index
    # (T) i64, boxes (chunks,6) f32, nseg, chunks, stream
    "amc3d_layout_pack": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # a layout's perm (B,n) i64, lab (B,n), kth (B,n), aux (B,n,2) f32, cmax
    # (B,ceil(n/64)) f32, B, n, stream
    "amc3d_support_aux": (_P, _P, _P, _P, _P, _I, _I, _P),
    # the stage's sorted points (B,N,4) f32 with the index bits in w, boxes
    # (B,ceil(N/64),6), f (B,N,C), a (B,N), out (B,N,C), sel (B,N) or
    # (B,N,k-1) i32 or null, B, N, C, k, fusion_min, stream
    "amc3d_refine_cross": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # g (B,N,C), sel (B,N,slots) i32, df (B,N,C) (zeroed by the entry
    # point), B, N, C, slots, scale, stream
    "amc3d_refine_cross_backward": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # the cloud's sorted points (B,N,4) f32 with the index bits in w, boxes
    # (B,ceil(N/64),6), out (B,N) f32 thresholds, B, N, k, stream
    "amc3d_contrast_select": (_P, _P, _P, _I, _I, _I, _P),
    # sorted support (B,N,4) with the index bits in w, boxes, its sorted
    # Morton codes (B,N) i64, the frame's lo (B rows of 3 f32) and row
    # stride, scale (B f32) and stride, labels (B,N) i32, the queries
    # sorted (B,M,4) with their index bits, out (B,M) i32, B, N, M, k,
    # number of classes, stream
    "amc3d_label_vote": (_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I,
                         _I, _I, _P),
    # u (B,N,C), idx (B,M,K) i32, sgn (C), qp (B,M,C) or null, the queries'
    # order (B,M) i32 or null and its stride within a row, ext, su, sq
    # (B,M,C) (su, sq null without stats), ties (B,M,C) u8 or null, B, N, M,
    # K, C, need_stats, stream
    "amc3d_aggregate_forward": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _P),
    # u, idx, qp or null, ext, ties, g_ext, g_sum, g_sq (null without
    # stats), order or null and its stride, du (B,N,C), B, N, M, K, C,
    # has_stats, stream
    "amc3d_aggregate_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                 _I, _I, _I, _I, _I, _I, _P),
    # the bfloat16 forms: u (B,N,C) bf16, the rest as above; the VJP's
    # float32 accumulator (B,N,C) ahead of du (B,N,C) bf16
    "amc3d_aggregate_forward_bf16": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _P),
    "amc3d_aggregate_backward_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the second-order kernels of the adahessian step.  The interpolation
    # VJP's: u (B,N2,C), idx (B,N1,3) i32, w (B,N1,3), out (B,N1,C), B, N1,
    # N2, C, stream
    "amc3d_three_interpolate_gather": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the CrossMask VJP's: u (B,N,C), sel (B,N,slots) i32, out (B,N,C), B,
    # N, C, slots, scale, stream
    "amc3d_refine_cross_gather": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # the contrast VJP's rows half: the layout, f, v (B,N,C), g4, gf
    # (B,N,C), gg4 (B,N,4), B, N, C, tinv, need_s, stream
    "amc3d_contrast_grad2_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _F, _I, _P),
    # its support half: the layout, cmax, f, v, g4, gf, B, N, C, tinv,
    # need_s, stream
    "amc3d_contrast_grad2_support": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _F, _I, _P),
    # the fused aggregation VJP's: u, idx, qp or null, ext, ties, g_sq or
    # null, w (B,N,C), order or null and its stride, dg_ext, dg_sum, dg_sq,
    # dqp (B,M,C) (the last three null without stats), du (B,N,C) or null,
    # B, N, M, K, C, has_stats, stream
    "amc3d_aggregate_backward2": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the default
    toolkit directory.  Raises :class:`KernelBuildError` if none has it."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for nvcc in candidates:
        if nvcc.is_file() and os.access(nvcc, os.X_OK):
            return str(nvcc)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of "
        f"{CSRC_DIR} cannot be built.  CUDA tensors need them; CPU tensors "
        "run the plain PyTorch ops and need no build.")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in cu + cuh:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libamc3d_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    Returns the library path; the compiler's output (``-Xptxas=-v``:
    registers, shared memory and spills per kernel) is kept beside it as
    ``.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    work = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    work.mkdir()
    try:
        cu, _ = _sources()
        objs = [work / f"{src.stem}.o" for src in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(cu, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        log = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        lib = work / so.name
        cmd = [nvcc, "-shared", "-o", str(lib), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text("".join(log))
        os.replace(lib, so)   # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.amc3d_error_string.argtypes = [ctypes.c_int]
    lib.amc3d_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` and raise if its launch failed."""
    lib = load_library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.amc3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
