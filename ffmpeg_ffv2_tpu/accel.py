"""How the device encoder's stages run on the platform JAX finds.

One decision point for the whole device path:

* on the GPU every stage is one jitted program, and the stages that have
  a hand-written kernel (``KERNEL_STAGES``) call it;
* on the CPU (tests, the virtual multi-device mesh) the stages run
  eagerly through their plain XLA references;
* any other accelerator jits the plain references.

A hand-written kernel runs in interpret mode only where a caller asks for
it explicitly; asking for a compiled kernel anywhere but on the GPU is an
error, never a quiet fallback.

The module also places JAX's persistent compilation cache
(``setup_compile_cache``) and names the card (``card_info``).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess

import jax

# stages with a hand-written Pallas (Triton) kernel beside their plain
# XLA reference: the range-coder arithmetic, the range-coder adaptation
# walk and the Golomb-Rice VLC-state walk
KERNEL_STAGES = ("coder", "adapt", "vlc")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class StagePlan:
    platform: str
    jit: bool                       # one jitted program per stage
    kernels: frozenset              # stages that call their kernel

    def impl(self, stage: str) -> str:
        """"kernel" or "xla" for one of KERNEL_STAGES."""
        if stage not in KERNEL_STAGES:
            raise KeyError(f"unknown kernel stage {stage!r}")
        return "kernel" if stage in self.kernels else "xla"

    def describe(self) -> str:
        return " ".join(f"{s}={self.impl(s)}" for s in KERNEL_STAGES)


def stage_plan(platform: str | None = None) -> StagePlan:
    """The plan for ``platform`` (default: ``jax.default_backend()``)."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return StagePlan(platform, True, frozenset(KERNEL_STAGES))
    if platform == "cpu":
        return StagePlan(platform, False, frozenset())
    return StagePlan(platform, True, frozenset())


def check_kernel_platform(name: str, interpret: bool) -> None:
    """Refuse a compiled kernel call off the GPU."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            f"{name}: the compiled kernel needs a GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it "
            "in the Pallas interpreter")


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    set below its maximum power runs slower under load, so every number
    kept goes with this line)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({type(e).__name__})"


def setup_compile_cache() -> str:
    """Place JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here.  Otherwise the cache goes to the fixed
    ``<repo>/.jax_cache`` (the path is part of the cache key, so a moving
    directory would never hit)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
