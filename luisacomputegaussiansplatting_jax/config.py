"""Render configuration and pipeline constants.

The numeric constants reproduce the reference renderer's behaviour
(values documented in /root/reference, cited per field) so that images are
comparable; everything else (capacities, padding) is static-shape design.
"""

from __future__ import annotations

import dataclasses

# Tile edge in pixels. One rasterizer grid step covers one TILE x TILE tile.
# Reference: lcgs/include/lcgs/module.h:17 (block 16x16).
TILE = 16

# Alignment of each tile's entry range under pack_mode="chunk" (and the
# tail padding of the no-pack stream).
CHUNK = 128


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the splatting pipeline.

    All fields are Python ints/floats (static under jit); changing any of
    them triggers recompilation, mirroring how the reference bakes them into
    its JIT-compiled shaders.
    """

    # --- image-independent pipeline constants (reference parity) ---
    #: near-plane cull: gaussians with view-space z below this are dropped.
    #: Reference: lcgs/src/gs_projector/shader.cpp:121.
    near: float = 0.2
    #: low-pass filter added to the 2D covariance diagonal.
    #: Reference: lcgs/src/gs_tile_splatter/shader.cpp:139-140.
    lowpass: float = 0.3
    #: splat radius in standard deviations: radius = ceil(k * sqrt(lambda_max)).
    #: Reference: gs_tile_splatter/shader.cpp:148 (k = 3).
    radius_sigma: float = 3.0
    #: alpha is clamped to at most this value.
    #: Reference: gs_tile_splatter/shader.cpp:259.
    alpha_max: float = 0.99
    #: contributions with alpha below this are skipped.
    #: Reference: gs_tile_splatter/shader.cpp:260 (1/255).
    alpha_min: float = 1.0 / 255.0
    #: blending stops once transmittance would drop below this.
    #: Reference: gs_tile_splatter/shader.cpp:262 (1e-4).
    transmittance_eps: float = 1e-4
    #: frustum clamp factor for the EWA Jacobian linearisation point.
    #: Reference: gs_projector/shader.cpp:150-151 (1.3 * tanfov).
    frustum_clamp: float = 1.3
    #: epsilon added to the homogeneous w before division.
    #: Reference: gs_projector/shader.cpp:116 (1e-6).
    w_eps: float = 1e-6
    #: epsilon added to the 2D covariance determinant before inversion.
    #: Reference: gs_tile_splatter/shader.cpp:143 (1e-6).
    det_eps: float = 1e-6
    #: znear / zfar of the projection matrix (only affects NDC z, unused by
    #: the splatting math). Reference: lcgs/include/lcgs/util/camera.h:54.
    znear: float = 0.1
    zfar: float = 100.0

    #: EWA Jacobian variant. True (reference default, gs_projector.h:42)
    #: projects the covariance straight to pixel units with focal-scaled
    #: J (gaussian.hpp:52-70). False reproduces shad_project_gs
    #: (gs_projector/shader.cpp:18-80): unit-focal J, rescaled to NDC
    #: units by 1/tanfov^2 in the projector, then to pixel units by
    #: res^2/4 in allocate_tiles (gs_tile_splatter/shader.cpp:132-138) —
    #: including the reference's cov.z factor of H*W/4 (not H^2/4), which
    #: makes the two paths differ by W/H on that term for non-square
    #: images.
    use_focal: bool = True

    #: rasterizer tile edge in pixels. 16 reproduces the reference's
    #: binning semantics exactly (module.h:17); 32 roughly halves the
    #: binning/sort work for scenes of small splats at slightly more
    #: blend compute, with tiny image differences at tile borders (a
    #: gaussian's 3-sigma rect rounds to different pixel sets).
    tile: int = 16

    #: optional tile HEIGHT (None = square tile x tile). Rectangular
    #: tiles (e.g. 32 x 16) trade more binning entries for fewer pixels
    #: blended per entry: the rasterizer kernels scale with entries x
    #: pixels-per-tile, the entry-side stages with entries. tile *
    #: tile_h must be a power of two (the blend kernel lays a tile's
    #: pixels along one Triton block axis).
    tile_h: int | None = None

    #: tile-rect clamp convention. "lcgs" clamps the *exclusive* max tile
    #: index to grid-1 (reference lcgs/src/module.cpp:33-35, which never bins
    #: into the last tile row/column); "inria" clamps to grid like the
    #: original graphdeco CUDA rasterizer (the BASELINE.json validation
    #: oracle), which is the default.
    rect_mode: str = "inria"

    # --- capacities (static shapes; replacement for the reference's
    # dynamic num_rendered readback, app/main.cpp:245 uses L = 20'000'000) ---
    #: maximum number of (tile, depth) pairs before per-tile chunk padding.
    max_pairs: int = 2_000_000

    #: optional smaller static capacity for the POST-sort entry stream
    #: (None = max_pairs). With tile_cull on, culled slots sort last, so
    #: the payload gather / rasterizer / backward reduction can run at
    #: the post-cull size while expansion still covers the full AABB
    #: count. Truncating a valid entry raises the overflow flag.
    max_pairs_sorted: int | None = None

    #: exact ellipse-tile culling during binning: drop AABB entries whose
    #: tile cannot receive any alpha >= 1/255 contribution (closed-form
    #: minimum of the conic quadratic over the tile). Output exact up to
    #: float summation regrouping. Shrinks every per-tile rasterizer
    #: range by the AABB-vs-ellipse overcount (bench.py uses it); the
    #: default stays False to keep strict reference binning counts.
    tile_cull: bool = False

    #: splat-entry layout for the rasterizer. "chunk" (reference-faithful
    #: packing): every tile's sorted range is repacked to CHUNK-aligned
    #: offsets. "none": kernels read each tile's range straight from the
    #: raw sorted stream with masked loads — no repacking pass and no
    #: slot remap gather.
    pack_mode: str = "chunk"

    # --- kernel switches ---
    #: use the Pallas rasterizer ("pallas") or the pure-jnp reference
    #: rasterizer ("jnp", only viable for tiny scenes).
    rasterizer: str = "pallas"

    #: shrink each splat's pixel radius from the fixed radius_sigma
    #: (reference 3 sigma, shader.cpp:139-148) to the exact alpha_min
    #: reach sqrt(2 ln(opacity/alpha_min)) sigma (clamped to
    #: radius_sigma). Images identical up to float reduction order (the
    #: blend kernel skips alpha < alpha_min contributions anyway,
    #: shader.cpp:257-266; removing them regroups chunked prefix sums);
    #: low-opacity splats just stop occupying expansion slots for tiles
    #: they cannot touch. Changes RenderAux.radii values (densify
    #: screen-size stats see the tight radius).
    tight_radius: bool = False
    #: entry-sort key layout: "2key" (stable (tile, f32-depth) sort —
    #: exact reference tie-break parity, shader.cpp:59-62) or "fused"
    #: (single quantized uint32 key, one sort operand fewer; blend order
    #: differs only between depths colliding within ~2^-13 relative at
    #: 1080p. See ops.binning._sort_entries).
    sort_mode: str = "2key"
    #: per-entry payload precision through the capacity-axis row gather:
    #: "f32" (exact, 9 f32 columns) or "bf16" (opacity+rgb ride the
    #: gather as bf16 pairs, shrinking the row to 7 int32 columns;
    #: mean/conic stay f32). The ~2^-9 relative rounding on
    #: opacity/colour is below the 1/255 output quantisation; gradients
    #: are computed at the rounded values and reduced in f32. Its speed
    #: on the GPU is not measured yet.
    payload_dtype: str = "f32"

    @property
    def tile_wh(self) -> tuple:
        """(tile width, tile height) in pixels."""
        return self.tile, self.tile_h if self.tile_h else self.tile

    def pairs_capacity(self, num_tiles: int) -> int:
        """Total padded entry capacity: every tile's range is padded to a
        multiple of CHUNK so rasterizer chunks never straddle tiles."""
        return self.max_pairs + num_tiles * CHUNK
