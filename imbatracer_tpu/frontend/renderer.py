"""Progressive render orchestration (the reference's render loop, headless).

Plays the role of RenderWindow::render_loop (reference:
frontend/render_window.cpp:50-122): accumulate per-frame films, stop on a
sample or time budget, report samples/fps/ms-per-frame in the same stdout
format the bench harness parses (render_window.cpp:84-88), dump
intermediate images, and write the final tone-mapped PNG.  The interactive
SDL window is replaced by headless operation (+ optional periodic PNG
preview), keeping `-q` as the primary mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..io.image import store_png
from ..render.camera import Camera, make_camera
from ..render.film import tonemap
from ..utils.log import logger


@dataclass
class RenderSettings:
    """Mirror of the reference's UserSettings knobs that affect rendering
    (reference: frontend/cmd_line.h:13-80)."""

    width: int = 512
    height: int = 512
    fov: float = 60.0
    spp: int = 1
    max_path_len: int = 10
    gamma: float = 0.5
    max_samples: int = 2 ** 31 - 1
    max_time_sec: float = float("inf")
    algorithm: str = "pt"
    light_path_count: int = 0      # 0 -> width*height/2 (cmd_line.h:237-239)
    num_connections: int = 1
    num_knn: int = 10
    radius_factor: float = 2.0
    intermediate_path: str = ""
    intermediate_time: float = float("inf")

    def resolved_light_path_count(self):
        if self.light_path_count:
            return self.light_path_count
        # Reference default is width*height/2 (cmd_line.h:237-239).  The
        # light pass and the frame-sized vertex-cache tables dominate the
        # VCM frame at high resolutions, and the estimator is unbiased for
        # ANY light-path count (MIS weights carry 1/lpc explicitly), so
        # fewer, cheaper frames can win at a fixed wall-clock budget.  Cap
        # the *default* only; an explicit --light-path-count still wins.
        # Merge-free estimators (BPT/LT) need no photon density, while VCM
        # starves its merge technique below 2^17 paths, so the cap is
        # per family.  (These caps were tuned on the previous accelerator
        # and have not been measured on the H100.)
        import os
        merge_free = self.algorithm in ("bpt", "lt")
        default_cap = 1 << 16 if merge_free else 1 << 17
        cap = int(os.environ.get("IMBA_VCM_LPC_CAP", str(default_cap)))
        return min((self.width * self.height) // 2, cap)


class ProgressiveRenderer:
    """Accumulates frames from a frame-render function.

    frame_fn(frame_index: uint32) must return an un-normalised (H*W, 3)
    radiance-sum film for `spp` samples per pixel.
    """

    def __init__(self, frame_fn, settings: RenderSettings, reset_fn=None):
        self.frame_fn = frame_fn
        self.s = settings
        self.reset_fn = reset_fn
        self.reset()

    def reset(self):
        """Restart accumulation (camera moved / scene changed), like
        RenderWindow::clear -> integrator.reset()
        (reference: render_window.cpp:164-175)."""
        self.accum = jnp.zeros((self.s.width * self.s.height, 3), jnp.float32)
        self.frames = 0
        if self.reset_fn is not None:
            self.reset_fn()

    def step(self):
        film = self.frame_fn(jnp.uint32(self.frames))
        self.accum = self.accum + film
        self.frames += 1

    def run(self, quiet: bool = False):
        """Render until the sample or time budget is exhausted; prints the
        reference-compatible perf line (render_window.cpp:84-88)."""
        s = self.s
        t_start = time.time()
        t_last_report = t_start
        t_last_dump = t_start
        frame_ms = []
        prev = None
        while True:
            t0 = time.time()
            self.step()
            # Depth-2 pipeline: block on the PREVIOUS frame while this
            # one is in flight, so host work overlaps device work instead
            # of serializing every frame.
            if prev is not None:
                jax.block_until_ready(prev)
            prev = self.accum
            frame_ms.append((time.time() - t0) * 1000.0)

            elapsed = time.time() - t_start
            samples = self.frames * s.spp
            if not quiet and time.time() - t_last_report > 10.0:
                fps = self.frames / elapsed
                logger.info("%d samples, %.2f fps, %.2f ms/frame",
                            samples, fps, np.mean(frame_ms[-20:]))
                t_last_report = time.time()
            if s.intermediate_path and time.time() - t_last_dump >= s.intermediate_time:
                self.save(f"{s.intermediate_path}_{int(elapsed)}s.png")
                t_last_dump = time.time()
            if samples >= s.max_samples or elapsed >= s.max_time_sec:
                break

        jax.block_until_ready(self.accum)  # drain the in-flight frame
        elapsed = time.time() - t_start
        samples = self.frames * s.spp
        fps = self.frames / max(elapsed, 1e-9)
        ms = 1000.0 * elapsed / max(self.frames, 1)
        # Keep the exact sentence shape the reference harness parses
        # (run_bench.py:207; render_window.cpp:84-88).
        print(f"Done after {elapsed} seconds, {samples} samples @ {fps} "
              f"frames per second, {ms} ms per frame")
        return self.image()

    def image(self) -> np.ndarray:
        """Current tone-mapped [0,1] HxWx3 image."""
        weight = 1.0 / max(self.frames * self.s.spp, 1)
        img = tonemap(self.accum, weight, self.s.gamma)
        return np.asarray(img).reshape(self.s.height, self.s.width, 3)

    def raw(self) -> np.ndarray:
        return np.asarray(self.accum).reshape(self.s.height, self.s.width, 3)

    def save(self, path: str):
        # Tone mapping already applied by image(); store linearly.
        store_png(path, self.image(), weight=1.0, gamma=1.0)
        logger.info("wrote %s", path)


def camera_for_scene(meta, settings: RenderSettings) -> Camera:
    return make_camera(
        meta.cam_pos, meta.cam_dir, meta.cam_up,
        settings.width, settings.height, settings.fov,
    )
