"""The one place that decides how this process runs its kernels.

Routes, keyed by ``jax.default_backend()``:

  * ``gpu``: every Pallas kernel is compiled through Triton
    (``backend="triton"``) and jitted steps donate their state buffers.
  * ``cpu``: Pallas kernels run in interpret mode. This route exists only
    for the test-suite and for CPU rehearsals of the GPU runs at tiny
    sizes; it is not a deployment target and measures nothing.

Any other platform is an error: there is no silent fallback to the
interpreter on an accelerator the kernels were not written for.

The persistent compile cache follows ``JAX_COMPILATION_CACHE_DIR`` when
it is set (JAX reads that variable itself); otherwise it lives at a
fixed directory inside the checkout, so a later run of the same code
finds what an earlier one compiled.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import jax

#: fixed in-checkout compile cache (listed in .gitignore)
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


@dataclasses.dataclass(frozen=True)
class Route:
    platform: str
    #: run Pallas kernels in the interpreter (CPU tests only)
    interpret: bool
    #: donate jitted-step state buffers
    donate: bool


ROUTES = {
    "gpu": Route("gpu", interpret=False, donate=True),
    "cpu": Route("cpu", interpret=True, donate=False),
}


def route(platform: str | None = None) -> Route:
    """The route for ``platform`` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    try:
        return ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: the kernels run "
            "compiled through Triton on 'gpu', or interpreted on 'cpu' "
            "(tests only)"
        ) from None


def pallas_call_kwargs(num_warps: int, platform: str | None = None) -> dict:
    """Keyword arguments that route a ``pl.pallas_call`` (always Triton,
    interpreted only on the CPU route). One pipeline stage: Triton
    pipelines only ``for`` loops, and the kernels loop with ``while``."""
    from jax.experimental.pallas import triton as plgpu

    return dict(
        backend="triton",
        interpret=route(platform).interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
    )


def donate_argnums(*argnums: int) -> tuple:
    """``donate_argnums`` for a jitted step: ``argnums`` on routes that
    donate, none on the CPU route (which would warn on every call)."""
    return tuple(argnums) if route().donate else ()


def compile_cache_dir(environ=None) -> str:
    """The persistent compile-cache directory for this process."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already uses it and
    nothing is changed here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
