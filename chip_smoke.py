#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU, through its own entry
points, at real sizes.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # the sharded path over 4 cards only

Phases (one process; any failed check ends the run with a non-zero exit):

1. device: JAX's default device must be a GPU.
2. traversal at 2^18 rays: the Triton kernel against the plain
   while-loop route on cornell, the 48k-triangle big scene and the
   still-life proxy's geometry (camera rays and one-bounce rays), and
   both against the brute-force intersector on every 64th ray.
3. PT end to end through `make_frame_fn`: the still-life proxy at
   1920x1080 (max_path_len 8) and the big scene at 1024^2.
4. VCM, BPT and PPM at 1024^2 on the cornell box with its mirror box and
   glass sphere, and VCM and PPM on the masked still-life proxy, each mean
   against PT's on the same scene.
5. the same PT and VCM frames at 256^2 on the GPU and on the CPU (plain
   traversal route there), compared as images.

The card's name and power limit go on the line before the last.  The
last line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# Traversal agreement.  prim_id may differ on edge and tie hits (a ray
# through a shared edge, two coplanar triangles), which float order in
# the two walks resolves differently; where the ids agree, t must agree
# to float rounding of the same Moller-Trumbore arithmetic.
MIN_ID_AGREE = 0.999
T_RTOL = 1e-4
# Transport: PT, BPT and VCM estimate the same integral; PPM is biased
# by its radius.  Means over 1024^2 pixels and a few frames.
MEAN_RTOL = {"bpt": 0.05, "vcm": 0.05, "ppm": 0.15}
# GPU vs CPU, same seed: only float order and hit ties differ, and a
# float32 product may run in TF32 on this card unless a precision is
# set.  A tie or rounding difference flips a path's later decisions
# (Russian roulette, the next hit), so a few pixels differ by the noise
# of one path sample; the rest agree to rounding.
MIN_CPU_PSNR = {"pt": 30.0, "vcm": 30.0}
FOUR_CARD_SIZE = 1024


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed_frames(frame_fn, frames):
    """Compile + first frame, then `frames` warm frames; returns
    (accumulated film, compile seconds, warm ms/frame list)."""
    t0 = time.perf_counter()
    acc = jax.block_until_ready(frame_fn(jnp.uint32(0)))
    compile_s = time.perf_counter() - t0
    ms = []
    for i in range(1, frames + 1):
        t = time.perf_counter()
        acc = acc + jax.block_until_ready(frame_fn(jnp.uint32(i)))
        ms.append((time.perf_counter() - t) * 1e3)
    return np.asarray(acc), compile_s, ms


def card():
    if not shutil.which("nvidia-smi"):
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"JAX found no GPU (default device platform {dev.platform!r})")
    print(f"[device] {dev.device_kind} x{len(jax.devices())}; {card()}",
          flush=True)


def _rays(scene, meta, res):
    from imbatracer_tpu.frontend.renderer import (RenderSettings,
                                                  camera_for_scene)
    from imbatracer_tpu.render import traverse as tr
    from imbatracer_tpu.render.integrators.pt import camera_rays
    from imbatracer_tpu.render.intersect import BIG

    cam = camera_for_scene(meta, RenderSettings(width=res, height=res))
    org, d, _, _ = camera_rays(cam, res, res, 1, jnp.uint32(0))
    n = org.shape[0]
    h = jax.jit(tr._walk_closest)(scene.bvh, org, d, 0.0, BIG, None)
    # One-bounce rays: from each camera hit, a random direction.
    k = jax.random.normal(jax.random.PRNGKey(7), d.shape)
    k = k / jnp.linalg.norm(k, axis=1, keepdims=True)
    ok = h.prim_id >= 0
    org2 = jnp.where(ok[:, None], org + h.t[:, None] * d, org)
    tmin2 = jnp.where(ok, 1e-3 * h.t, 0.0)
    big = jnp.full((n,), BIG)
    return [("camera", org, d, jnp.zeros(n), big, h),
            ("bounce", org2, k, tmin2, big, None)]


def _agree(name, a, b):
    """Fraction of equal prim ids and the largest relative t gap where
    they agree and hit."""
    same = a.prim_id == b.prim_id
    frac = float(jnp.mean(same))
    both = same & (a.prim_id >= 0)
    rel = float(jnp.max(jnp.where(
        both, jnp.abs(a.t - b.t) / jnp.maximum(jnp.abs(b.t), 1e-6), 0.0)))
    if frac < MIN_ID_AGREE or rel > T_RTOL:
        fail(f"{name}: prim_id agree {frac:.6f} (min {MIN_ID_AGREE}), "
             f"t rel {rel:.2e} (max {T_RTOL})")
    return frac, rel


def phase_traversal():
    from imbatracer_tpu.render import traverse as tr
    from imbatracer_tpu.render.intersect import brute_force_closest_hit
    from imbatracer_tpu.scene import procedural as proc

    kern_c = jax.jit(lambda *a: tr._kernel_closest(*a, None))
    plain_c = jax.jit(lambda *a: tr._walk_closest(*a, None))
    kern_a = jax.jit(lambda *a: tr._kernel_any(*a, None))
    plain_a = jax.jit(lambda *a: tr._walk_any(*a, None))

    def ms(f):
        jax.block_until_ready(f())
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            jax.block_until_ready(f())
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts))

    scenes = [("cornell", proc.make_cornell_scene),
              ("big4000", lambda: proc.make_big_scene(4000)),
              ("still_life", proc.make_still_life_like)]
    for name, make in scenes:
        scene, meta = make()
        bvh = scene.bvh
        for rname, org, d, tmin, tmax, _ in _rays(scene, meta, 512):
            args = (bvh, org, d, tmin, tmax)
            hk, hp = kern_c(*args), plain_c(*args)
            frac, rel = _agree(f"{name}/{rname} kernel vs plain", hk, hp)
            # Both against brute force on every 64th ray (4096 rays
            # spread over the whole image).
            sub = slice(None, None, 64)
            bt, bid, bu, bv = brute_force_closest_hit(
                org[sub], d[sub], bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
                tmin=tmin[sub][:, None])
            bid = jnp.where(bid >= 0, bvh.tri_id[jnp.maximum(bid, 0)], -1)
            ref = tr.Hit(t=bt, prim_id=bid, u=bu, v=bv)
            sub_hits = float(jnp.mean(bid >= 0))
            for label, h in (("kernel", hk), ("plain", hp)):
                _agree(f"{name}/{rname} {label} vs brute force",
                       tr.Hit(*(x[sub] for x in h)), ref)
            # Occlusion up to half way to the nearest hit (or 10 units).
            tocc = jnp.where(hp.prim_id >= 0, 0.5 * (hp.t + tmin), 10.0)
            oargs = (bvh, org, d, tmin, tocc)
            occ_k, occ_p = kern_a(*oargs), plain_a(*oargs)
            occ_agree = float(jnp.mean(occ_k == occ_p))
            if occ_agree < MIN_ID_AGREE:
                fail(f"{name}/{rname} any_hit agree {occ_agree:.6f}")
            # Full-length occlusion must match "closest hit exists".
            full = kern_a(*args)
            full_agree = float(jnp.mean(full == (hp.prim_id >= 0)))
            if full_agree < MIN_ID_AGREE:
                fail(f"{name}/{rname} any_hit vs closest {full_agree:.6f}")
            print(f"[traversal] {name} ({meta.num_tris} tris) {rname} "
                  f"2^18 rays: closest kernel {ms(lambda: kern_c(*args)):.3f}"
                  f" ms, plain {ms(lambda: plain_c(*args)):.3f} ms; any "
                  f"kernel {ms(lambda: kern_a(*oargs)):.3f} ms, plain "
                  f"{ms(lambda: plain_a(*oargs)):.3f} ms; prim agree "
                  f"{frac:.6f}, t rel {rel:.1e}, occ agree {occ_agree:.6f}; "
                  f"brute force ok on 4096 rays (every 64th, hit fraction "
                  f"{sub_hits:.4f})", flush=True)


def _render(scene, meta, algo, size, frames, **kw):
    from imbatracer_tpu.frontend.engine import make_frame_fn
    from imbatracer_tpu.frontend.renderer import RenderSettings

    w, h = size if isinstance(size, tuple) else (size, size)
    settings = RenderSettings(width=w, height=h, algorithm=algo, **kw)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    acc, compile_s, ms = timed_frames(frame_fn, frames)
    if acc.shape != (w * h, 3) or not np.isfinite(acc).all():
        fail(f"{algo} {w}x{h}: film shape {acc.shape}, finite "
             f"{bool(np.isfinite(acc).all())}")
    return acc / ((frames + 1) * settings.spp), compile_s, ms


def _tonemapped(film, w, h, gamma=0.5):
    return np.clip(np.clip(film, 0.0, None) ** gamma, 0.0, 1.0).reshape(
        h, w, 3)


def phase_pt():
    from imbatracer_tpu.scene import procedural as proc
    from imbatracer_tpu.utils.metrics import load_reference_png, psnr

    name = card()
    scene, meta = proc.make_still_life_like()
    img, cs, ms = _render(scene, meta, "pt", (1920, 1080), 4,
                          max_path_len=8)
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens", "still_life_1080p_len8.png")
    db = psnr(_tonemapped(img, 1920, 1080), load_reference_png(golden))
    print(f"[pt] still_life ({meta.num_tris} tris, masks) 1920x1080 len 8: "
          f"compile+first {cs:.1f} s, ms/frame {min(ms):.2f} (median "
          f"{np.median(ms):.2f}) on {name}; finite; PSNR vs golden "
          f"{db:.2f} dB after 5 frames (information)", flush=True)
    scene, meta = proc.make_big_scene(4000)
    img, cs, ms = _render(scene, meta, "pt", 1024, 4)
    print(f"[pt] big4000 ({meta.num_tris} tris) 1024^2 len 10: compile+"
          f"first {cs:.1f} s, ms/frame {min(ms):.2f} (median "
          f"{np.median(ms):.2f}) on {name}; finite; mean "
          f"{img.mean():.5f}", flush=True)


def phase_vcm_family():
    from imbatracer_tpu.scene import procedural as proc

    name = card()
    cases = [
        ("cornell mirror+glass",
         lambda: proc.make_cornell_scene(mirror_box=True, glass_sphere=True),
         ("pt", "vcm", "bpt", "ppm"), 3),
        # Alpha masks: every traversal takes the plain while-loop route.
        ("still_life (masks)", proc.make_still_life_like,
         ("pt", "vcm", "ppm"), 2),
    ]
    for label, make, algos, frames in cases:
        scene, meta = make()
        means = {}
        for algo in algos:
            img, cs, ms = _render(scene, meta, algo, 1024, frames)
            means[algo] = float(img.mean())
            line = (f"[{algo}] {label} ({meta.num_tris} tris) 1024^2: "
                    f"compile+first {cs:.1f} s, ms/frame {min(ms):.2f} on "
                    f"{name}; finite; mean {means[algo]:.5f}")
            if algo != "pt":
                rel = abs(means[algo] - means["pt"]) / means["pt"]
                if rel > MEAN_RTOL[algo]:
                    fail(f"{label} {algo} mean {means[algo]:.5f} vs pt "
                         f"{means['pt']:.5f}: rel {rel:.3f} > "
                         f"{MEAN_RTOL[algo]}")
                line += f", vs pt rel {rel:.4f} (max {MEAN_RTOL[algo]})"
            print(line, flush=True)


def phase_cpu_same_seed():
    from imbatracer_tpu.frontend.engine import make_frame_fn
    from imbatracer_tpu.frontend.renderer import RenderSettings
    from imbatracer_tpu.scene import procedural as proc
    from imbatracer_tpu.utils.metrics import psnr

    size = 256
    scene, meta = proc.make_cornell_scene(mirror_box=True, glass_sphere=True)
    cpu = jax.devices("cpu")[0]
    for algo in ("pt", "vcm"):
        settings = RenderSettings(width=size, height=size, algorithm=algo)
        films = []
        for dev in (jax.devices()[0], cpu):
            with jax.default_device(dev):
                s = jax.device_put(scene, dev)
                frame_fn, _ = make_frame_fn(s, meta, settings)
                film = frame_fn(jnp.uint32(3))
                if next(iter(film.devices())) != dev:
                    fail(f"{algo} frame ran on {film.devices()}, not {dev}")
                films.append(np.asarray(film))
        a, b = (_tonemapped(f, size, size) for f in films)
        db = psnr(a, b)
        if not np.isfinite(films[1]).all() or db < MIN_CPU_PSNR[algo]:
            fail(f"{algo} GPU vs CPU PSNR {db:.2f} dB < "
                 f"{MIN_CPU_PSNR[algo]}")
        print(f"[cpu] {algo} 256^2 same seed, GPU vs CPU: PSNR {db:.2f} dB "
              f"(min {MIN_CPU_PSNR[algo]}); identical pixels "
              f"{float(np.mean(np.all(a == b, axis=-1))):.4f}", flush=True)


def phase_four_cards():
    """PT and VCM at 1024^2 through `make_frame_fn` with four cards
    visible, so the engine shards every frame over them, against the same
    frames on one card through the unsharded renderers with the engine's
    resolved settings; and the sharded compaction branch, forced on,
    against the same one-card film.  The four partial films are summed in
    another order than one card's bands, so the films agree to float
    tolerance, not bitwise."""
    from imbatracer_tpu.frontend.engine import make_frame_fn, vcm_frame_params
    from imbatracer_tpu.frontend.renderer import RenderSettings
    from imbatracer_tpu.parallel import shard
    from imbatracer_tpu.render.integrators.pt import render_pt_frame
    from imbatracer_tpu.render.integrators.vcm import render_vcm_frame
    from imbatracer_tpu.scene import procedural as proc

    devs = jax.devices()
    if len(devs) != 4:
        fail(f"--four-cards needs 4 GPUs, JAX found {len(devs)}")
    size = FOUR_CARD_SIZE
    scene, meta = proc.make_cornell_scene(mirror_box=True, glass_sphere=True)
    has_bump = getattr(meta, "has_bump", False)
    frame = jnp.uint32(1)

    def close(name, one, four):
        one, four = np.asarray(one), np.asarray(four)
        if not (np.isfinite(one).all() and np.isfinite(four).all()):
            fail(f"{name}: non-finite film")
        rel = np.abs(four - one).sum() / max(np.abs(one).sum(), 1e-9)
        if rel > 1e-3:
            fail(f"{name}: 4-card vs 1-card relative L1 {rel:.2e} > 1e-3")
        return rel

    def timed(f):
        jax.block_until_ready(f())
        t = time.perf_counter()
        out = jax.block_until_ready(f())
        return out, (time.perf_counter() - t) * 1e3

    pt_set = RenderSettings(width=size, height=size, algorithm="pt")
    vcm_set = RenderSettings(width=size, height=size, algorithm="vcm")
    pt_fn, cam = make_frame_fn(scene, meta, pt_set)
    vcm_fn, _ = make_frame_fn(scene, meta, vcm_set)
    base_radius, lpc, mat_kinds = vcm_frame_params(scene, meta, vcm_set,
                                                   cam, len(devs))
    pt4, pt4_ms = timed(lambda: pt_fn(frame))
    vcm4, vcm4_ms = timed(lambda: vcm_fn(frame))
    with jax.default_device(devs[0]):
        pt1, pt1_ms = timed(lambda: render_pt_frame(
            scene, cam, frame, size, size, spp=pt_set.spp,
            max_len=pt_set.max_path_len, has_masks=meta.has_masks,
            has_bump=has_bump))
        vcm1, vcm1_ms = timed(lambda: render_vcm_frame(
            scene, cam, frame, base_radius, algo="vcm", width=size,
            height=size, spp=vcm_set.spp, max_len=vcm_set.max_path_len,
            light_path_count=lpc, num_connections=vcm_set.num_connections,
            num_knn=vcm_set.num_knn, has_masks=meta.has_masks,
            has_bump=has_bump, mat_kinds=mat_kinds))
    print(f"[4 cards] pt {size}^2 via make_frame_fn: 1 card {pt1_ms:.2f} ms,"
          f" 4 cards {pt4_ms:.2f} ms; rel L1 {close('pt', pt1, pt4):.2e} on "
          f"{card()}", flush=True)
    print(f"[4 cards] vcm {size}^2 via make_frame_fn ({lpc} light paths, "
          f"base radius {float(base_radius):.6f}, material kinds "
          f"{mat_kinds}): 1 card {vcm1_ms:.2f} ms, 4 cards {vcm4_ms:.2f} ms; "
          f"rel L1 {close('vcm', vcm1, vcm4):.2e}", flush=True)
    # Sharded compaction branch, forced on with small bands so every
    # shard has several local bands; both are read at call time.
    old = shard.BAND_RAYS
    os.environ["IMBA_PT_COMPACT"] = "1"
    shard.BAND_RAYS = 1 << 16
    try:
        cpt4, cms = timed(lambda: pt_fn(frame))
    finally:
        shard.BAND_RAYS = old
        del os.environ["IMBA_PT_COMPACT"]
    print(f"[4 cards] pt compacted {size}^2 via make_frame_fn: {cms:.2f} ms;"
          f" rel L1 vs 1 card {close('pt compacted', pt1, cpt4):.2e}",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its "
                         "1-card comparison")
    args = ap.parse_args()

    from imbatracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_traversal()
        phase_pt()
        phase_vcm_family()
        phase_cpu_same_seed()
    dev = jax.devices()[0]
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
