"""Global configuration for ecw_cc_tpu.

The reference implementation (MilaimKas/ECW_CC) is pure float64 NumPy; to match
it to 1e-8 the device kernels run in float64 (`Config.x64`, the default dtype,
also the CPU test mode).  Production runs use float32 (ECW_CC_TPU_DTYPE /
set_config), optionally with an f64 polish pass (solvers/gs.polish_f64).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    # Working dtype for device kernels: 'float64' for parity tests,
    # 'float32' for production/bench.
    dtype: str = "float64"
    # Enable jax x64 mode at import time of ecw_cc_tpu.ops.
    x64: bool = True
    # Default DIIS settings (mirrors reference Solver_GS defaults).
    maxdiis: int = 15
    mindiis: int = 2
    # Route for the v^4 'ladder' contraction (ops/ladder.py):
    #   'dense'   — one (o^2,v^2)x(v^2,v^2) matmul (reads the full v^4 block
    #               and does 4x redundant FLOPs),
    #   'packed'  — antisymmetry-packed triangle pairs: exact, 4x fewer
    #               FLOPs and 4x less vvvv HBM traffic, one gather+scatter
    #               of o^2 v^2/2 per call; no spin-structure requirement,
    #   'sectors' — exact spin-block decomposition (strided slice/scatter
    #               relayouts; kept as a tested option, never auto-chosen),
    #   'auto'    — packed at nvir >= ladder_packed_min_nvir, else dense.
    #               The gate sits between C2H2/6-31G (nvir=30, mixed
    #               result) and C2H2/cc-pVDZ (nvir=62, the sorted route won)
    #               where it was last measured; not yet re-measured on the
    #               GPU (ROADMAP Speed 6).
    ladder_mode: str = "auto"
    ladder_packed_min_nvir: int = 48
    # Degenerate-threshold used when dividing by orbital-energy gaps.
    # (The reference divides without protection; 0.0 reproduces that.)
    eia_shift: float = 0.0
    # Matmul precision for the DEVICE SOLVER iterations: 'highest' (true
    # FP32 products, the parity mode), 'high' and 'default' (on the H100
    # both run f32 products in TF32 on the tensor cores, f32 storage),
    # 'bf16' (bf16 products AND bf16-stored blocks/amplitudes in the
    # t/lambda updates — halves the HBM traffic of the bandwidth-bound
    # soup).  Lower precisions converge to a coarser fixed point; combine
    # with SCF_device(refine=True) to recover 1e-8 parity.
    # 'hybrid' runs reduced-precision iterations (at hybrid_fast) until the
    # residual drops below hybrid_switch or stalls, then finishes with
    # 'highest' iterations — same fixed point as 'highest'.
    iter_precision: str = "highest"
    hybrid_switch: float = 1e-4
    # RETIRED (kept for API compatibility): the r2 cond(S) gate for the
    # host-f64 ERI-transform fallback.  The S^{-1/2} half of the transform
    # now always runs in f64 on the host (models/eris.build_eris_device),
    # so the f32 device build is accurate at any realistic cond(S) and no
    # fallback exists.
    eri_f32_cond_max: float = 1e5
    # Precision of the hybrid fast leg ('high' / 'default' = TF32 products
    # on the H100, 'bf16' = bf16 products + bf16 storage).  'high' kept
    # DIIS effective down to ~1e-4 residuals where it was last measured; a
    # noisier fast leg defeated DIIS.
    hybrid_fast: str = "high"
    # Round-3 soup optimizations in the device solver iteration: stacked
    # t+lambda ladder GEMM (the packed operand read once/iteration)
    # and pre-permuted loop-invariant ERI views for the hot o^3v^3 terms
    # (ops/ccsd.SoupViews).  Exact restructurings — same math, different
    # association; parity is tested either way.
    soup_opt: bool = True
    # Spin-sorted MO layout for the f32 production ERI build (alpha first
    # within occ and vir; ops/ladder.spin_sort_perm): the packed ladder
    # operand becomes block-diagonal over spin sectors (SectoredVVVV — an
    # exact further 2.67x FLOP / 2.67x HBM cut on the dominant GEMM) with
    # zero per-iteration permutation cost.  Amplitude/rdm1 boundaries stay
    # in the reference (alternating) convention (Solver_CCSD(mo_perm=...)).
    spin_sorted: bool = True
    # Sector-blocked soup kernels (ops/ccsd_sect.py) in the device solver
    # when the layout is spin-sorted AND the Vexp target/potential matrices
    # are spin-block-diagonal (checked at solver build): every o^3 v^3
    # contraction drops to ~15.6% of its dense-layout FLOPs by skipping
    # the structurally-zero spin blocks.  Exact; parity-tested.
    soup_sector: bool = True
    # Closed-shell spin-flip symmetry (ops/spinsect.py sym mode) on top of
    # the sectored kernels: mirror spin blocks are equal arrays for an
    # RHF-derived GHF with spin-restricted Vexp (checked at solver build,
    # incl. a numerical ERI flip-symmetry check), so only canonical blocks
    # are computed — a further exact ~2x FLOP cut (soup + ladder).
    soup_sym: bool = True
    # Emission scheme for the sector-blocked sub-GEMMs (~25 small-M GEMMs
    # at M=49-98 per iteration):
    #   'sep'     — one dot per surviving spin assignment
    #   'kconcat' — contributions summed into one output block ride ONE
    #               dot with the contraction axes concatenated (3-4x fewer
    #               GEMMs; operand concat copies are ~KB-scale)
    #   'flip'    — emit the transposed orientation (stream the LARGE free
    #               dim as the GEMM M) when N >= 2M
    #   'kconcat+flip' — both
    # 'kconcat' won where the modes were last compared (the blocked route,
    # C2H2/cc-pVTZ); the flip orientation's extra transposes cost more than
    # they bought.  Not yet re-measured on the GPU (ROADMAP Design 4).
    # Parity-tested all modes (exact: same multiply-add sets, flat
    # reduction order).
    soup_gemm: str = "kconcat"


_config = Config(
    dtype=os.environ.get("ECW_CC_TPU_DTYPE", "float64"),
    x64=os.environ.get("ECW_CC_TPU_X64", "1") != "0",
    ladder_mode=os.environ.get("ECW_CC_TPU_LADDER", "auto"),
    iter_precision=os.environ.get("ECW_CC_TPU_ITERPREC", "highest"),
    soup_opt=os.environ.get("ECW_CC_TPU_SOUP", "1") != "0",
    spin_sorted=os.environ.get("ECW_CC_TPU_SORTED", "1") != "0",
    soup_sector=os.environ.get("ECW_CC_TPU_SOUPSECT", "1") != "0",
    soup_sym=os.environ.get("ECW_CC_TPU_SOUPSYM", "1") != "0",
    soup_gemm=os.environ.get("ECW_CC_TPU_SOUPGEMM", "kconcat"),
)


def get_config() -> Config:
    return _config


_CHOICES = {
    "dtype": ("float32", "float64"),
    "soup_gemm": ("sep", "kconcat", "flip", "kconcat+flip"),
    "ladder_mode": ("auto", "dense", "packed", "sectors"),
    "iter_precision": ("highest", "high", "default", "bf16", "hybrid"),
    "hybrid_fast": ("high", "default", "bf16"),
}


def set_config(**kwargs) -> Config:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config field {k!r}")
        if k in _CHOICES and v not in _CHOICES[k]:
            raise ValueError(f"config.{k} must be one of {_CHOICES[k]}, "
                             f"got {v!r}")
        setattr(_config, k, v)
    return _config


def setup_jax():
    """Apply the x64 setting and the matmul precision to JAX, and place the
    persistent compilation cache.  Call before building device arrays.

    f32 products run at 'highest' precision: on an H100 JAX's default f32
    precision may run dots in TF32 (10-bit mantissa), which costs ~3 digits
    on chained CC contractions; 'highest' keeps true FP32.

    Compilation cache: where JAX_COMPILATION_CACHE_DIR is set, JAX already
    uses it and nothing is set here; otherwise the cache is the fixed
    directory <repo>/.jax_cache (a fixed path, so every run hits the same
    entries)."""
    import jax

    jax.config.update("jax_enable_x64", bool(_config.x64))
    jax.config.update("jax_default_matmul_precision", "highest")
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(repo, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def np_dtype():
    import numpy as np

    return np.dtype(_config.dtype)
