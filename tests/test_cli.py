"""In-process CLI smoke tests (render_cli + train_cli)."""

import numpy as np


def test_render_cli_synthetic(tmp_path):
    from luisacomputegaussiansplatting_jax.apps.render_cli import main

    rc = main([
        "--synthetic", "2000", "--res", "96x64", "--exp_N", "2",
        "--max-pairs", "50000", "--out", str(tmp_path),
    ])
    assert rc == 0
    out = tmp_path / "synthetic2000_cpu.png"
    assert out.exists()
    from PIL import Image

    im = np.asarray(Image.open(out))
    assert im.shape == (64, 96, 3)
    assert im.std() > 1.0


def test_render_cli_ply_roundtrip(tmp_path):
    from luisacomputegaussiansplatting_jax.apps.render_cli import main
    from luisacomputegaussiansplatting_jax.io.ply import save_ply
    from luisacomputegaussiansplatting_jax.io.synthetic import random_scene

    ply = tmp_path / "scene.ply"
    save_ply(random_scene(500, seed=3), str(ply))
    rc = main([
        "--ply", str(ply), "--res", "80x60", "--max-pairs", "30000",
        "--world", "blender", "--cam-pos", "3,-3,2", "--cam-target", "0,0,0",
        "--out", str(tmp_path),
    ])
    assert rc == 0
    assert (tmp_path / "scene_cpu.png").exists()


def test_train_cli_smoke(tmp_path):
    from luisacomputegaussiansplatting_jax.apps.train_cli import main

    rc = main([
        "--synthetic-gt", "300", "--views", "2", "--res", "48x32",
        "--iters", "20", "--capacity", "300", "--init-points", "150",
        "--max-pairs", "20000", "--log-every", "10", "--eval-every", "20",
        "--densify-interval", "8", "--densify-from", "4",
        "--out", str(tmp_path),
    ])
    assert rc == 0
    assert (tmp_path / "syntheticgt300_trained.ply").exists()
    assert (tmp_path / "syntheticgt300_view0.png").exists()


def test_train_cli_grows_capacity_on_overflow(tmp_path, capsys):
    """Render-pair overflow mid-training must trigger grow_capacity:
    max_pairs doubles, the steps recompile, and training completes —
    the detected-overflow answer to the reference's silent corruption
    past its hard L=20M cap (app/main.cpp:245)."""
    from luisacomputegaussiansplatting_jax.apps.train_cli import main

    rc = main([
        "--synthetic-gt", "300", "--views", "2", "--res", "48x32",
        "--iters", "8", "--capacity", "300", "--init-points", "200",
        "--max-pairs", "256",  # far below the ~1k+ entries 200 splats emit
        "--log-every", "4", "--densify-interval", "1000",
        "--out", str(tmp_path),
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "[overflow] raising max_pairs to 512" in err
    assert (tmp_path / "syntheticgt300_trained.ply").exists()
