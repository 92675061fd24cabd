import os
import sys

# Tests run on the CPU: a virtual 8-device mesh (the multi-device sharding
# tests run here) and the plain XLA stage references; Pallas kernels run
# only where a test asks for interpret mode.  Checks that need the GPU are
# the phases of chip_smoke.py at the repo root.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax  # noqa: E402

from ffmpeg_ffv2_tpu.accel import setup_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
setup_compile_cache()


# ---------------------------------------------------------------------------
# Speed tiers (markers registered in pyproject.toml):
#   python -m pytest tests/ -m "not slow"   -> fast suite
#   python -m pytest tests/                 -> full suite
# Tests measured heavy on the CPU are marked slow below; the fast tier
# still covers every component (each slow matrix keeps at least one fast
# representative).
# ---------------------------------------------------------------------------

_SLOW_PATTERNS = (
    "test_shift_compact_expand_randomized",
    "test_device_encoder_batch_intra",
    "test_device_encoder_byte_exact",
    "test_device_encoder_mega_groups_small_gcap",
    "test_render_bytes_fast_matches_slow",
    "test_render_bytes_matches_compact_lane",
    "test_native_matches_python",
    "test_native_session_reuse",
    "test_cli_ffv2_roundtrip",
    "test_cli_ffv1_roundtrip",
    "test_cli_mkv_roundtrip",
    "test_ffv2_ours_to_reference",
    "test_fate_golden_rgb",
    "test_ffv2_split_tree_to_reference",
    # each matrix keeps one fast representative (versions: [4-0-4];
    # nonuniform: [yuv420p-wh1]; parallel: the [0]-coder case; rice:
    # the remaining whs)
    "test_device_encoder_nonuniform_geometry[bgr0",
    "test_device_encoder_nonuniform_geometry[yuv420p-wh0",
    "test_device_encoder_nonuniform_geometry[yuv420p-wh2",
    "test_device_encoder_nonuniform_geometry[yuv420p-wh3",
    "test_twopass_pass2_device_byte_exact",
    "test_device_encoder_versions_byte_exact[0-",
    "test_device_encoder_versions_byte_exact[1-",
    "test_device_encoder_versions_byte_exact[4-1",
    "test_device_encoder_v4_rgb_rct_search",
    "test_device_encoder_rgb48",
    "test_parallel_rgb_range",
    "test_parallel_matches_host_and_carries_state[1]",
    "test_sharded_packet_byte_identical",
    "test_sharded_front_matches_single",
    "test_device_rice_encoder_byte_exact[gray-wh1]",
)


def pytest_collection_modifyitems(config, items):
    import pytest
    for item in items:
        if any(item.name.startswith(p) or p in item.name
               for p in _SLOW_PATTERNS):
            item.add_marker(pytest.mark.slow)
