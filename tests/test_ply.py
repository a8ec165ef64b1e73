"""PLY IO: roundtrip, activations, layout parity with the reference reader."""

import numpy as np

from luisacomputegaussiansplatting_jax.io.ply import load_ply, save_ply
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.models.gaussians import GaussianScene


def test_roundtrip(tmp_path):
    scene = random_scene(37, seed=4)
    path = tmp_path / "scene.ply"
    save_ply(scene, path)
    back = load_ply(path)
    np.testing.assert_allclose(np.asarray(back.means), np.asarray(scene.means), atol=1e-6)
    np.testing.assert_allclose(np.asarray(back.scales), np.asarray(scene.scales), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(back.opacities), np.asarray(scene.opacities), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(back.sh), np.asarray(scene.sh), atol=1e-6)
    # quats saved raw, loaded normalised; scene quats are already unit
    np.testing.assert_allclose(np.asarray(back.quats), np.asarray(scene.quats), atol=1e-6)


def test_activation_semantics(tmp_path):
    """Stored values are pre-activation, as in reference gaussians.cpp:137-168."""
    scene = random_scene(5, seed=1)
    path = tmp_path / "scene.ply"
    save_ply(scene, path)
    raw = load_ply(path, apply_activations=False)
    # sigmoid(raw opacity) == activated opacity
    sig = 1.0 / (1.0 + np.exp(-np.asarray(raw.opacities)))
    np.testing.assert_allclose(sig, np.asarray(scene.opacities), atol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(raw.scales)), np.asarray(scene.scales), rtol=1e-5
    )


def test_sh_rest_channel_major_layout(tmp_path):
    """f_rest_i must be channel-major: i = c*(K-1) + k  ->  sh[:, k+1, c]
    (reference gaussians.cpp:124-135)."""
    n, k = 3, 16
    sh = np.zeros((n, k, 3), np.float32)
    # unique value per (coeff, channel)
    for kk in range(1, k):
        for c in range(3):
            sh[:, kk, c] = 100 * c + kk
    scene = GaussianScene(
        means=np.zeros((n, 3), np.float32),
        scales=np.full((n, 3), 0.1, np.float32),
        quats=np.tile(np.array([0, 0, 0, 1.0], np.float32), (n, 1)),
        opacities=np.full((n,), 0.5, np.float32),
        sh=sh,
    )
    path = tmp_path / "layout.ply"
    save_ply(scene, path)

    # parse the raw table directly and verify the column convention
    from luisacomputegaussiansplatting_jax.io.ply import _read_vertex_table

    cols, _ = _read_vertex_table(str(path))
    for c in range(3):
        for kk in range(15):
            np.testing.assert_allclose(
                cols[f"f_rest_{c * 15 + kk}"], 100 * c + (kk + 1)
            )

    back = load_ply(path)
    np.testing.assert_allclose(np.asarray(back.sh), sh, atol=1e-6)


def test_ascii_write_roundtrip(tmp_path):
    """save_ply(fmt='ascii') round-trips through load_ply (happly writes
    both ascii and binary; so do we)."""
    scene = random_scene(23, seed=7)
    path = tmp_path / "scene_ascii.ply"
    save_ply(scene, path, fmt="ascii")
    with open(path, "rb") as f:
        assert b"format ascii 1.0" in f.readline() + f.readline()
    back = load_ply(path)
    np.testing.assert_allclose(np.asarray(back.means), np.asarray(scene.means), atol=1e-6)
    np.testing.assert_allclose(np.asarray(back.scales), np.asarray(scene.scales), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(back.opacities), np.asarray(scene.opacities), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(back.sh), np.asarray(scene.sh), atol=1e-6)
    np.testing.assert_allclose(np.asarray(back.quats), np.asarray(scene.quats), atol=1e-6)


def test_ascii_ply(tmp_path):
    """ASCII PLY variant parses identically (happly supports both)."""
    scene = random_scene(4, seed=2, sh_degree=0)
    # hand-write an ascii file with degree-0 SH
    path = tmp_path / "a.ply"
    means = np.asarray(scene.means)
    names = (
        ["x", "y", "z"]
        + [f"f_dc_{i}" for i in range(3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex 4\n")
        for nm in names:
            f.write(f"property float {nm}\n")
        f.write("end_header\n")
        sh = np.asarray(scene.sh)
        op = np.asarray(scene.opacities)
        sc = np.log(np.asarray(scene.scales))
        q = np.asarray(scene.quats)[:, [3, 0, 1, 2]]
        logit = np.log(op) - np.log1p(-op)
        for i in range(4):
            row = (
                list(means[i])
                + list(sh[i, 0])
                + [logit[i]]
                + list(sc[i])
                + list(q[i])
            )
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
    back = load_ply(path)
    np.testing.assert_allclose(np.asarray(back.means), means, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(back.opacities), np.asarray(scene.opacities), atol=1e-5
    )
    assert back.sh.shape == (4, 1, 3)
