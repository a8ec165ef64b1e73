"""Viewer server tests: page HTML + JPEG frame rendering via live HTTP.

The reference's equivalent component is the ImGui display window
(app/display.{h,cpp}); here it's a stateless HTTP render server, so it can
be tested headlessly end-to-end.
"""

import io
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.apps.viewer import (
    ViewerServer,
    make_handler,
)
from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import create_cube_scene


@pytest.fixture(scope="module")
def viewer():
    scene = create_cube_scene(nx=4)
    srv = ViewerServer(
        scene,
        width=96,
        height=64,
        cfg=RenderConfig(max_pairs=50_000),
        name="cube",
        init_pos=(3.0, -2.5, 2.0),
        init_target=(0.0, 0.0, 0.0),
        world_up=(0.0, 0.0, 1.0),
        fov=70.0,
    )
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()


def test_page_served(viewer):
    with urllib.request.urlopen(viewer + "/") as r:
        body = r.read().decode()
    assert r.status == 200
    assert "lcgs viewer" in body
    assert "/frame?" in body  # the JS render loop


def test_frame_renders(viewer):
    from PIL import Image

    url = (
        viewer
        + "/frame?pos=3,-2.5,2&front=-0.66,0.55,-0.44&up=0,0,1"
        + "&fov=70&bg=%23000000"
    )
    with urllib.request.urlopen(url) as r:
        data = r.read()
    assert r.headers["Content-Type"] == "image/jpeg"
    img = np.asarray(Image.open(io.BytesIO(data)))
    assert img.shape == (64, 96, 3)
    assert img.mean() > 1.0  # the cube is visible, not a black frame


def test_bg_color_applied(viewer):
    from PIL import Image

    # camera looking away from the scene: frame == background colour
    url = (
        viewer
        + "/frame?pos=50,50,50&front=0.577,0.577,0.577&up=0,0,1"
        + "&fov=70&bg=%23ff0000"
    )
    with urllib.request.urlopen(url) as r:
        img = np.asarray(Image.open(io.BytesIO(r.read())))
    assert img[..., 0].mean() > 200  # red
    assert img[..., 1].mean() < 30  # no green


def test_frame_is_upright():
    """A gaussian ABOVE the look-at target must appear in the TOP rows of
    the served JPEG (the renderer emits bottom-up rows; render_jpeg must
    flip to the upright convention like render_cli's PNGs)."""
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.models.gaussians import (
        GaussianScene,
    )

    scene = GaussianScene(
        means=jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
        scales=jnp.full((1, 3), 0.25, jnp.float32),
        quats=jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32),
        opacities=jnp.ones((1,), jnp.float32),
        sh=jnp.zeros((1, 16, 3), jnp.float32).at[:, 0, :].set(2.0),
    )
    srv = ViewerServer(
        scene, width=64, height=64, cfg=RenderConfig(max_pairs=10_000),
        name="dot", init_pos=(4.0, 0.0, 0.0), init_target=(0.0, 0.0, 0.0),
        world_up=(0.0, 0.0, 1.0), fov=60.0,
    )
    from PIL import Image

    jpeg = srv.render_jpeg((4.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                           60.0, (0.0, 0.0, 0.0))
    img = np.asarray(Image.open(io.BytesIO(jpeg)), np.float32)
    rows = img.sum(axis=(1, 2))
    com = float((rows * np.arange(64)).sum() / max(rows.sum(), 1e-9))
    assert com < 32, "viewer frame is upside-down"


def test_bad_query_is_400_not_crash(viewer):
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(viewer + "/frame?pos=1,2")
    assert ei.value.code == 400
    # server still alive afterwards
    with urllib.request.urlopen(viewer + "/") as r:
        assert r.status == 200
