"""backend.py: the one module that decides how kernels run."""

import pytest

from luisacomputegaussiansplatting_jax import backend


@pytest.mark.parametrize("platform,interpret,donate", [
    ("gpu", False, True),
    ("cpu", True, False),
])
def test_route_per_platform(platform, interpret, donate):
    r = backend.route(platform)
    assert (r.platform, r.interpret, r.donate) == (platform, interpret,
                                                  donate)


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.route(platform)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_pallas_calls_name_triton_and_interpret_only_on_cpu(platform):
    kw = backend.pallas_call_kwargs(num_warps=8, platform=platform)
    assert kw["backend"] == "triton"
    assert kw["interpret"] is (platform == "cpu")
    assert kw["compiler_params"].num_warps == 8


def test_this_process_is_the_cpu_route():
    assert backend.route().platform == "cpu"
    assert backend.donate_argnums(0, 1) == ()


@pytest.mark.parametrize("env,want", [
    ({}, str(backend.DEFAULT_CACHE_DIR)),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, str(backend.DEFAULT_CACHE_DIR)),
])
def test_compile_cache_dir_rule(env, want):
    assert backend.compile_cache_dir(env) == want


def test_default_cache_dir_is_fixed_inside_checkout():
    root = backend.DEFAULT_CACHE_DIR.parent
    assert (root / "luisacomputegaussiansplatting_jax").is_dir()
    assert backend.DEFAULT_CACHE_DIR.name == ".jax_cache"
