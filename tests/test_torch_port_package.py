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
            "amcontrast3d_tpu_torch.tools.profile_eval; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'amcontrast3d_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_profile_eval_needs_a_cuda_device():
    proc = subprocess.run(
        [sys.executable, "-m", "amcontrast3d_tpu_torch.tools.profile_eval"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
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
    for name in ("fps.cu", "ball_query.cu", "interpolate.cu"):
        assert (_build.CSRC_DIR / name).is_file()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    first = _build.library_path()
    (csrc / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
