"""RenderSettings.resolved_light_path_count policy (frontend/renderer.py).

The default light-path count follows the reference (w*h/2,
cmd_line.h:237-239) but is capped per algorithm family — 2^16 for
merge-free BPT/LT, 2^17 for merging VCM/PPM — a quality/speed tradeoff.
An explicit --light-path-count always wins; IMBA_VCM_LPC_CAP overrides
the cap.
"""

import pytest

from imbatracer_tpu.frontend.renderer import RenderSettings


def test_explicit_lpc_wins():
    s = RenderSettings(width=1024, height=1024, algorithm="vcm",
                       light_path_count=524288)
    assert s.resolved_light_path_count() == 524288


def test_small_frame_uses_reference_default():
    s = RenderSettings(width=128, height=128, algorithm="vcm")
    assert s.resolved_light_path_count() == 128 * 128 // 2


@pytest.mark.parametrize("algo,cap", [
    ("vcm", 1 << 17), ("ppm", 1 << 17), ("vcm_pt", 1 << 17),
    ("bpt", 1 << 16), ("lt", 1 << 16),
])
def test_large_frame_caps_per_family(algo, cap):
    s = RenderSettings(width=1024, height=1024, algorithm=algo)
    assert s.resolved_light_path_count() == cap


def test_env_cap_override(monkeypatch):
    monkeypatch.setenv("IMBA_VCM_LPC_CAP", "4096")
    s = RenderSettings(width=1024, height=1024, algorithm="vcm")
    assert s.resolved_light_path_count() == 4096
