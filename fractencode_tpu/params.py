"""Encoder/decoder configuration.

Replacement for ``encode_parameters_t``
(``/root/reference/encode/encode_parameters.h:5-14``) and the CLI-level decode
knobs (``main.cpp:29-104``).  The struct is frozen/hashable so it can be a
static argument to ``jax.jit``.

Mode flags (design decisions documented in SURVEY.md section 7):
  * ``criterion='raw'`` ranks pairs by the reference's metric — the plain MSE
    between the range and the 2x2-average-sampled domain *without* applying
    (s, o), normalized by the domain area (``transformmatcher.h:87,120``,
    ``metrics.h:49``).  ``'affine'`` ranks by the true fractal-coding
    objective: the residual after the optimal affine map, normalized by range
    area.  'affine' gives strictly better decoded PSNR at identical search
    cost and is the default; 'raw' exists for bit-parity with the reference.
  * ``so_mode='ls'`` solves the textbook least squares ``range ~ s*domain+o``
    (what the decoder actually applies, ``DecodeUtils.hpp:22``).
    ``'reference'`` reproduces the reference's quirk: it regresses the
    *domain on the range* and uses denominator ``N*SumA^2 - (SumA-1)*SumA``
    (note the ``-1``; ``transformmatcher.h:103,136``).
"""
from __future__ import annotations

import dataclasses

__all__ = ["EncoderConfig", "DecoderConfig", "REFERENCE_COMPAT"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    # Geometry (reference defaults: encode_parameters.h:6-8)
    source_size: int = 16  # domain block edge
    target_size: int = 4  # range block edge
    lattice: int = 2  # domain step = source_size // lattice (main.cpp:147)

    # Search space
    num_transforms: int = 4  # reference searches Id/90/180/270 only
    #   (transformmatcher.h:41-46); 8 = full dihedral group.
    rms_threshold: float = 0.0  # early-accept threshold, MSE units
    s_max: float = -1.0  # |s| clamp; <=0 disables (transformmatcher.h:27-31)
    use_classifier: bool = True  # brightness-block 6-class equality prune

    # Semantics
    criterion: str = "affine"  # 'affine' | 'raw'
    so_mode: str = "ls"  # 'ls' | 'reference'

    # Learned pruning: train an LBG codebook (encode/vq.py — the component
    # the reference built for exactly this and never wired,
    # CodebookGenerator.hpp:84-162) over contrast/brightness-normalized
    # domain vectors and use the codeword id as the class bin through the
    # SAME classed layout/kernels as the brightness classifier.
    # 0 = off (use the brightness classifier per use_classifier);
    # 1..7 = replace it with that many learned bins (1 ~= noclassifier).
    vq_classes: int = 0
    vq_sample_limit: int = 65536  # LimitRange-style training subsample
    vq_seed: int = 0  # deterministic seeding

    # Execution
    range_chunk: int = 2048  # ranges scored per scan step of the plain route
    # search route: 'auto' | 'jnp' | 'pallas' | 'pallas_interpret'
    # (encode/route.py is the one place that resolves it)
    backend: str = "auto"

    def __post_init__(self):
        if self.target_size >= self.source_size or self.target_size < 2:
            raise ValueError("invalid source/target size")  # main.cpp:99-102
        if self.source_size % self.lattice:
            raise ValueError("source_size must be divisible by lattice")
        if self.criterion not in ("affine", "raw"):
            raise ValueError(f"bad criterion {self.criterion}")
        if self.so_mode not in ("ls", "reference"):
            raise ValueError(f"bad so_mode {self.so_mode}")
        if not 1 <= self.num_transforms <= 8:
            raise ValueError("num_transforms must be in 1..8")
        if self.backend not in ("auto", "jnp", "pallas", "pallas_interpret"):
            raise ValueError(f"bad backend {self.backend}")
        if not 0 <= self.vq_classes <= 7:
            raise ValueError("vq_classes must be 0 (off) or 1..7 (the classed "
                             "kernel layout carries 7 class bins)")

    @property
    def domain_step(self) -> int:
        return self.source_size // self.lattice


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    max_iterations: int = 300  # Encoder2.hpp:62
    epsilon: float = 1e-5  # inter-iterate MSE stop (main.cpp:34)
    initial_value: int = 100  # flat start image (Encoder2.hpp:69)
    # Stop when the inter-iterate MSE has not MATERIALLY improved (by a
    # stall_rtol relative margin over the best seen) for this many steps:
    # u8 truncation traps the iteration in limit cycles (period 2 is caught
    # exactly; longer/chaotic orbits flicker at a constant MSE floor until
    # max_iterations — measured: quantized 256^2 streams never exactly
    # repeat within 60 steps, so only a patience exit fires; the reference
    # would spin to 300, Encoder2.hpp:76-87).  A genuine contraction shrinks
    # the MSE by large factors per step, while orbit-phase noise produces
    # sub-percent "new minima" — the relative margin stops those from
    # resetting the patience, which lets the window be short (round 4: 24
    # absolute-improvement steps -> 8 material-improvement steps; decoded
    # PSNR unchanged to ~0.01 dB, any orbit state is a valid rendering).
    # 0 disables the heuristic (strict reference iteration count).
    stall_window: int = 8
    stall_rtol: float = 0.02
    # "flat": start from the flat initial_value image (reference semantics,
    # Encoder2.hpp:68-70).  "means": solve the block-mean fixed point first
    # (a tiny [R]-sized contraction — each range's decoded mean is
    # s*mean(domain) + o and a domain's mean is the mean of the range
    # blocks it covers), then start the full-res loop from that piecewise-
    # constant image.  Removes the DC transient (measured: ~2 fewer
    # full-res iterations; the detail contraction dominates).  Same decode
    # semantics per step; the start point differs, so the u8 fixed point
    # can in principle differ by the odd +-1 limit-cycle pixel (measured
    # identical on the 128^2 fixture).
    initial: str = "flat"
    mean_init_iters: int = 30  # block-mean fixed-point steps ("means" mode)
    # Coarse-to-fine ("pyramid") initialization: PIFS maps are resolution-
    # independent, so the same (domain, transform, s, o) set decodes at any
    # scale whose geometry divides evenly.  Iterating first at half
    # resolution costs ~0.4x a full-res step (pool build, box sums and
    # gather rows all shrink), and the upsampled result starts the
    # fixed-count full-res refinement a few contraction steps from the
    # fixed point — measured ~2x faster to the same PSNR
    # (measured on bits and PSNR, which do not depend on the device).  OFF by default: the flat start is the
    # reference-parity mode (Encoder2.hpp:68-70) pinned pixel-identical by
    # tests/test_reference_parity.py; the CLI and bench enable it.
    pyramid: bool = False
    # Measured (512^2 and 2048^2 Lenna fixtures, raw + quantized): decoded
    # PSNR is unchanged to 0.001 dB down to (coarse=6, full=5); the
    # defaults keep a safety margin above that floor.
    pyramid_steps: int = 8  # iterations at the coarsest scale
    pyramid_refine_steps: int = 4  # iterations at intermediate scales
    # Coarse scales to use (1 => half resolution only).  A half-res step
    # moves about a quarter of a full-res step's pixels; whether deeper
    # levels pay on the H100 awaits measurement (ROADMAP Queue 1 item 4).
    pyramid_levels: int = 1
    # Full-res iterations after the pyramid init.  Measured (scripts/
    # measure_pyramid_steps.py): PSNR saturates after 4-5 full-res steps
    # from the pyramid start (vs ~9 from flat) on natural images, while
    # the inter-iterate MSE keeps contracting geometrically (~0.5-0.85 per
    # step) essentially forever — so a convergence-based continuation
    # cannot tell the PSNR-irrelevant tail apart and measurably pays ~9
    # extra steps per decode (tried and reverted in round 5).  With
    # ``pyramid=True`` the decoder therefore runs exactly this many
    # full-res steps and reports it as the iteration count.  On knife-edge
    # synthetic content whose pre-truncation values sit on integer
    # boundaries, the result can be a +-1-gray alternate rendering of the
    # flat path's fixed point (both are exact fixed points of the map;
    # tests/test_roundtrip.py content matrix) — use ``pyramid=False`` for
    # the fully-converged reference-semantics mode.
    pyramid_full_steps: int = 6


def REFERENCE_COMPAT(**overrides) -> EncoderConfig:
    """Config matching the reference C++ encoder bit-for-bit in ranking and
    (s, o) semantics."""
    base = dict(criterion="raw", so_mode="reference", num_transforms=4)
    base.update(overrides)
    return EncoderConfig(**base)
