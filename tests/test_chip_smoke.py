"""chip_smoke.py's phases, rehearsed on the CPU at tiny sizes (kernels in
interpret mode), and its refusal to report anything without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_device_phase_fails_without_gpu():
    with pytest.raises(chip_smoke.PhaseError, match="no GPU"):
        chip_smoke.phase_device()


def test_main_fails_on_cpu_and_prints_no_result(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script must fail without printing a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("tile,pack", [(16, "chunk"), (32, "none")])
def test_kernel_phase_tiny(tile, pack):
    img_err, rel, n = chip_smoke.compare_kernel(
        400, 96, 64, tile, pack, max_pairs=20_000)
    assert n > 0
    assert img_err <= chip_smoke.IMAGE_MAX_ABS
    assert max(rel.values()) <= chip_smoke.DPAYLOAD_REL_L2, rel


def test_render_phase_tiny():
    step_ms = chip_smoke.phase_render(
        n_gaussians=3000, width=160, height=96, reps=1, entry_budget=2000,
        cfg_kwargs=dict(max_pairs=40_000, tile=32, pack_mode="none",
                        tile_cull=True, max_pairs_sorted=30_000,
                        payload_dtype="bf16", sort_mode="fused"))
    assert step_ms > 0


def test_train_phase_tiny():
    chip_smoke.phase_train(n_active=600, capacity=1024, width=64, height=48,
                           n_views=2, steps=2, max_pairs=30_000)


def test_sharded_phase_tiny():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_sharded(
        n_gaussians=2000, width=96, height=64, max_pairs=40_000,
        train_width=64, train_height=48, train_active=500,
        train_capacity=1024)
