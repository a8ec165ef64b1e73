"""Compiled-kernel checks that need the card (``gpu`` marker).

On the CPU they skip; on the card run
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``. The same
comparisons run at larger sizes in chip_smoke.py phase 1."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda pytest -m gpu)")


@pytest.mark.parametrize("tile,pack", [(16, "chunk"), (32, "none")])
def test_compiled_blend_matches_reference(gpu, tile, pack):
    import chip_smoke

    img_err, rel, n = chip_smoke.compare_kernel(
        20_000, 256, 256, tile, pack, max_pairs=400_000)
    assert n > 0
    assert img_err <= chip_smoke.IMAGE_MAX_ABS
    assert max(rel.values()) <= chip_smoke.DPAYLOAD_REL_L2, rel
