"""Package-level checks of the PyTorch port: it imports no JAX, and its
kernel build fails loudly (never silently) without nvcc."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from amcontrast3d_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = ("import sys, amcontrast3d_tpu_torch, amcontrast3d_tpu_torch.models, "
            "amcontrast3d_tpu_torch.ops, amcontrast3d_tpu_torch.engine, "
            "amcontrast3d_tpu_torch.utils.convert, amcontrast3d_tpu_torch.utils.metrics, "
            "amcontrast3d_tpu_torch.tools.profile_eval, "
            "amcontrast3d_tpu_torch.tools.profile_train, amcontrast3d_tpu_torch.loss, "
            "amcontrast3d_tpu_torch.tools.profile_big_kernels, "
            "amcontrast3d_tpu_torch.tools.profile_room_fps, "
            "amcontrast3d_tpu_torch.tools.fps_handover, "
            "amcontrast3d_tpu_torch.optim, amcontrast3d_tpu_torch.scheduler, "
            "amcontrast3d_tpu_torch.data, amcontrast3d_tpu_torch.data.semantickitti, "
            "amcontrast3d_tpu_torch.transforms, amcontrast3d_tpu_torch.engine.cli, "
            "amcontrast3d_tpu_torch.engine.evaluate, amcontrast3d_tpu_torch.engine.runner, "
            "amcontrast3d_tpu_torch.utils.ckpt, amcontrast3d_tpu_torch.utils.logger, "
            "amcontrast3d_tpu_torch.utils.random, amcontrast3d_tpu_torch.utils.vis, "
            "amcontrast3d_tpu_torch.ops.spatial, "
            "amcontrast3d_tpu_torch.data.s3dis, amcontrast3d_tpu_torch.data.scannet, "
            "amcontrast3d_tpu_torch.data.s3dis_sphere, amcontrast3d_tpu_torch.data.build, "
            "amcontrast3d_tpu_torch.scheduler.plateau_lr, "
            "amcontrast3d_tpu_torch.utils.summary; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'amcontrast3d_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_import():
    """No import statement of the port, of ``chip_smoke.py`` or of the
    port's example mains names jax, flax, optax or the JAX package (their
    comments may point at the JAX files they mirror)."""
    import ast
    files = [*REPO.glob("amcontrast3d_tpu_torch/**/*.py"), REPO / "chip_smoke.py",
             *REPO.glob("examples/segmentation/*_torch.py")]
    assert len(files) > 40
    banned = {"jax", "jaxlib", "flax", "optax", "amcontrast3d_tpu"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad = [n for n in names if n.split(".")[0] in banned]
            assert not bad, f"{path}: imports {bad}"


def _run_tool(name, *args):
    return subprocess.run(
        [sys.executable, "-m", f"amcontrast3d_tpu_torch.tools.{name}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_profile_eval_needs_a_cuda_device():
    proc = _run_tool("profile_eval")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout


def test_profile_train_needs_a_cuda_device():
    proc = _run_tool("profile_train")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout


def test_profile_train_recipe_and_loader_modes_need_a_cuda_device():
    proc = _run_tool("profile_train", "--cfg",
                     str(REPO / "cfgs" / "scannet" / "AMContrast3D-AA.yaml"),
                     "--loader")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout


def test_idle_gaps_go_to_the_launch_after_them():
    """``profile_train.gap_table`` on a hand-made trace: a gap whose next
    kernel was launched after the card fell idle is the host's, put down to
    the phase and the innermost operator around that launch; a gap before a
    kernel launched earlier is idle but not host-paced."""
    from amcontrast3d_tpu_torch.tools.profile_train import NO_PHASE, gap_table

    def ev(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "forward", 0, 100),
        ev("cpu_op", "aten::mm", 10, 20),
        ev("cpu_op", "aten::addmm", 50, 30),
        ev("cpu_op", "aten::inner", 55, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 3, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 56, 3, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 57, 1, corr=3),
        ev("cpu_op", "aten::sum", 200, 10, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 205, 1, tid=2, corr=4),
        ev("kernel", "k1", 20, 10, tid=7, corr=1),
        ev("kernel", "k2", 62, 10, tid=7, corr=2),
        ev("kernel", "k3", 75, 10, tid=7, corr=3),
        ev("kernel", "k4", 210, 5, tid=7, corr=4),
    ]
    g = gap_table(events, ("forward", "loss"))
    assert g["idle"] == 32 + 3 + 125 and g["paced"] == 32 + 125
    assert g["span"] == 215 - 20
    assert g["phase"] == {"forward": (32, 1), NO_PHASE: (125, 1)}
    assert g["op"] == {"aten::inner": (32, 1), "aten::sum": (125, 1)}
    assert sorted(g["gaps"])[-1] == (125, NO_PHASE, "aten::sum", "k4")
    assert gap_table([], ("forward",))["idle"] == 0


def test_every_c_entry_point_is_declared_once_with_its_arguments():
    """No compiler runs here, so hold the ctypes signatures against the
    sources: every ``extern "C"`` entry point of ``csrc/*.cu`` has a
    signature in ``_build._SIGNATURES`` with as many arguments as the C
    function takes (pointers as ``void*``, then ints and floats), and no
    signature names a function the sources lack."""
    import ctypes
    import re
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C" (?:const )?([\w ]+?\*?)\s*(amc3d_\w+)\(([^)]*)\)',
                             text):
            args = [a.strip() for a in m.group(3).split(",") if a.strip()]
            assert m.group(2) not in found, m.group(2)
            found[m.group(2)] = args
    assert set(found) - {"amc3d_error_string"} == set(_build._SIGNATURES)
    assert "amc3d_three_interpolate_backward_big" in found
    kinds = {ctypes.c_void_p: ("*",), ctypes.c_int: ("int ",),
             ctypes.c_float: ("float ",)}
    for name, argtypes in _build._SIGNATURES.items():
        assert len(argtypes) == len(found[name]), name
        for ctype, arg in zip(argtypes, found[name]):
            assert any(k in arg for k in kinds[ctype]) and \
                (ctype is ctypes.c_void_p) == ("*" in arg), (name, arg)


def test_tool_entry_points_are_declared_with_their_arguments():
    """The measurement kernels of ``tools/*.cu`` against the ctypes
    signatures of ``tools/fps_handover.py``, as the package's are held
    against ``_build._SIGNATURES``: every entry point declared once, with
    as many arguments of the right kinds, and each source its own set."""
    import ctypes
    import re
    from amcontrast3d_tpu_torch.tools import fps_handover
    kinds = {ctypes.c_void_p: ("*",), ctypes.c_int: ("int ",)}
    for name, source in fps_handover.SOURCES.items():
        text = re.sub(r"//[^\n]*", "", (REPO / "amcontrast3d_tpu_torch" /
                                         "tools" / source).read_text())
        found = {m.group(1): [a.strip() for a in m.group(2).split(",")
                              if a.strip()]
                 for m in re.finditer(
                     r'extern "C" (?:const )?[\w ]+?\*?\s*(amc3d_\w+)'
                     r'\(([^)]*)\)', text)}
        assert set(found) - {"amc3d_tool_error"} == \
            set(fps_handover._SIGNATURES[name]), name
        for entry, argtypes in fps_handover._SIGNATURES[name].items():
            assert len(argtypes) == len(found[entry]), entry
            for ctype, arg in zip(argtypes, found[entry]):
                assert any(k in arg for k in kinds[ctype]) and \
                    (ctype is ctypes.c_void_p) == ("*" in arg), (entry, arg)


def test_handover_tool_refuses_a_cpu_cloud_and_builds_nothing_at_import():
    """The one-block handover kernel is a tool of the card: a CPU cloud is
    refused before anything is built, and importing it builds nothing."""
    import torch
    from amcontrast3d_tpu_torch.tools import fps_handover
    with pytest.raises(ValueError, match="CUDA cloud"):
        fps_handover.furthest_point_sample_handover(torch.zeros(1, 10, 3), 4)
    assert fps_handover.library.cache_info().currsize == 0
    assert fps_handover.MAX_POINTS == 327680


def test_profile_room_fps_needs_a_cuda_device():
    proc = _run_tool("profile_room_fps", "--handover", "32", "--micro")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout


def test_profile_big_kernels_needs_a_cuda_device():
    proc = _run_tool("profile_big_kernels")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout


@pytest.mark.parametrize("main", ["main_AA_torch.py", "main_MM_torch.py"])
def test_example_mains_need_a_cuda_device_unless_cpu_is_named(main, tmp_path):
    """Without a card the port's mains stop before they write anything."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "segmentation" / main),
         "--cfg", str(REPO / "cfgs" / "synthetic" / "AMContrast3D-AA.yaml"),
         "mode=test", f"root_dir={tmp_path}"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not list(tmp_path.iterdir())


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds nothing else of the repository the smoke
    script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_needs_a_cuda_device():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_reports_compiler_failure(monkeypatch, tmp_path):
    """A failing nvcc raises with its output and leaves no library behind."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    for name in ("fps.cu", "ball_query.cu", "interpolate.cu", "contrast.cu",
                 "fps_pruned.cu", "knn.cu", "layout.cu", "listed_knn.cuh",
                 "chunks.cuh"):
        assert (_build.CSRC_DIR / name).is_file()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    first = _build.library_path()
    (csrc / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
