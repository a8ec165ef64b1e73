"""The blend kernels lower to Triton IR — checked on the CPU, without a
GPU: every primitive the kernels use must have a Triton lowering rule
and the emitted module must verify. Catches what interpret-mode tests
cannot (e.g. an operation the Triton route does not lower) before a run
on the card."""

import jax
import jax.numpy as jnp
import pytest
from jax._src.pallas.triton import lowering

from luisacomputegaussiansplatting_jax import backend
from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.ops import rasterize_pallas as rp


def _triton_module(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    calls = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    if not calls:  # vmapped: the pallas_call sits one level down
        calls = [e for eqn in jaxpr.jaxpr.eqns
                 for sub in jax.core.jaxprs_in_params(eqn.params)
                 for e in sub.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    params = calls[0].params
    result = lowering.lower_jaxpr_to_triton_module(
        params["jaxpr"], params["grid_mapping"], "cuda")
    result.module.operation.verify()
    return str(result.module)


@pytest.fixture
def compiled_route(monkeypatch):
    """Trace the kernels as the GPU route would (no interpreter)."""
    monkeypatch.setitem(backend.ROUTES, "cpu", backend.ROUTES["gpu"])


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("tile", [16, 32])
def test_blend_kernels_lower_to_triton(compiled_route, tile, kind):
    cfg = RenderConfig(tile=tile)
    nt, cap, pix = 12, 4096, tile * tile
    p = jnp.zeros((rp.FIELDS, cap))
    s = jnp.zeros((nt,), jnp.int32)
    if kind == "fwd":
        ir = _triton_module(
            lambda p, s: rp.rasterize_forward(p, s, s, 4, 64, 48, cfg), p, s)
    else:
        ir = _triton_module(
            lambda p, s, r: rp.rasterize_backward(p, s, s, r, 4, 64, 48, cfg),
            p, s, jnp.zeros((nt, 8, pix)))
    assert "tt.load" in ir and "tt.store" in ir and "scf.while" in ir


def test_vmapped_forward_lowers_to_triton(compiled_route):
    """The multi-view training step vmaps the render: the batched
    kernel (one more grid axis) must lower too."""
    cfg = RenderConfig(tile=32)
    nt, cap = 6, 2048
    p = jnp.zeros((2, rp.FIELDS, cap))
    s = jnp.zeros((2, nt), jnp.int32)
    ir = _triton_module(jax.vmap(
        lambda p, s: rp.rasterize_forward(p, s, s, 3, 96, 64, cfg)), p, s)
    assert "tt.get_program_id" in ir
