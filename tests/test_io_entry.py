"""Entry points and the packages they need: the zlib PNG codec and the
TGA reader, the compile-cache helper, `chip_smoke.py` refusing to run
without a GPU, and a CLI render with every package but jax and numpy
unimportable."""

import os
import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest

from imbatracer_tpu.io import image as im

REPO = Path(__file__).resolve().parents[1]
GOLDENS = sorted((REPO / "goldens").glob("*.png"))


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (16, 9, 4)])
def test_png_round_trip(shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    data = im.encode_png(img)
    assert data.startswith(b"\x89PNG\r\n\x1a\n")
    np.testing.assert_array_equal(im.decode_png(data), img)


def test_store_png_then_load_png(tmp_path):
    img = np.random.RandomState(0).rand(12, 20, 3).astype(np.float32)
    path = str(tmp_path / "x.png")
    im.store_png(path, img, gamma=1.0)
    back = im.load_png(path)
    assert back.shape == (12, 20, 4)
    np.testing.assert_allclose(back[..., :3], img, atol=0.5 / 255 + 1e-6)
    assert np.all(back[..., 3] == 1.0)


def _png_with_filters(img, filters):
    """Encode (H, W, 3) uint8 with the given per-row filter types."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        ft, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def test_png_decodes_every_filter_type():
    img = np.random.RandomState(5).randint(0, 256, (11, 7, 3), np.uint8)
    data = _png_with_filters(img, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(im.decode_png(data), img)


@pytest.mark.parametrize("path", GOLDENS, ids=[p.stem for p in GOLDENS])
def test_golden_decodes(path):
    assert len(GOLDENS) == 5
    img = im.decode_png(path.read_bytes())
    h, w = (1080, 1920) if "1080p" in path.stem else (512, 512)
    assert img.shape == (h, w, 3) and img.dtype == np.uint8
    assert 5 < img.mean() < 250 and img.std() > 5
    np.testing.assert_array_equal(im.decode_png(im.encode_png(img)), img)


def _tga(img, rle, top_left):
    h, w, c = img.shape
    pix = img[..., [2, 1, 0, 3][:c]]  # BGR(A)
    if not top_left:
        pix = pix[::-1]
    flat = pix.reshape(-1, c)
    if rle:  # run-length form, one raw packet per pixel
        body = b""
        for p in flat:
            body += bytes([0]) + p.tobytes()
    else:
        body = flat.tobytes()
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0,
                       0, 0, w, h, 8 * c, 0x20 if top_left else 0)
    return head + body


@pytest.mark.parametrize("rle,top_left,c", [(False, True, 3),
                                            (True, False, 4)])
def test_tga_decode(rle, top_left, c):
    img = np.random.RandomState(c).randint(0, 256, (5, 6, c), np.uint8)
    np.testing.assert_array_equal(im.decode_tga(_tga(img, rle, top_left)),
                                  img)


def test_jpeg_texture_names_the_missing_package(tmp_path):
    p = tmp_path / "t.jpg"
    p.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="Pillow"):
        im.load_image(str(p))


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    from imbatracer_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_in_the_checkout(monkeypatch):
    from imbatracer_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(cache.compile_cache_dir())
    assert path == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _run(code, cwd=REPO, env=None):
    e = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    e.pop("XLA_FLAGS", None)
    e.update(env or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=600)


def test_chip_smoke_fails_without_a_gpu():
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


BLOCK = """
import sys
import jax
import jax.numpy
import numpy

# From here on, any top-level package that is neither in the standard
# library nor already loaded by jax and numpy is unimportable: the
# renderer may depend on nothing else.
ALLOWED = (set(sys.stdlib_module_names) | {m.split(".")[0] for m in sys.modules}
           | {"imbatracer_tpu"})


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] not in ALLOWED:
            raise ImportError(f"{name} is not allowed here")


sys.meta_path.insert(0, Blocker())
"""

SCENE = """
pos 0 1 3
dir 0 0 -1
up 0 1 0
mesh box.obj
"""

OBJ = """
mtllib box.mtl
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v -0.3 1.9 -0.3
v 0.3 1.9 -0.3
v 0.3 1.9 0.3
v -0.3 1.9 0.3
usemtl white
f 1 4 3 2
usemtl light
f 5 6 7 8
"""

MTL = """
newmtl white
Kd 0.7 0.7 0.7
newmtl light
Kd 0 0 0
Ke 10 10 10
"""


def test_cli_renders_png_with_only_jax_and_numpy(tmp_path):
    (tmp_path / "s.scene").write_text(SCENE)
    (tmp_path / "box.obj").write_text(OBJ)
    (tmp_path / "box.mtl").write_text(MTL)
    out = tmp_path / "out.png"
    code = BLOCK + textwrap.dedent(f"""
        import imbatracer_tpu
        from imbatracer_tpu.frontend.cli import main
        raise SystemExit(main([{str(tmp_path / 's.scene')!r},
                               {str(out)!r}, "-w", "64", "-h2", "64",
                               "-s", "2", "-q"]))
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr[-2000:]
    img = im.decode_png(out.read_bytes())
    assert img.shape == (64, 64, 3) and img.max() > 0
    assert "Traceback" not in r.stderr


def test_package_imports_only_stdlib_jax_and_numpy():
    """Static check of every import statement in the package."""
    import ast

    allowed = set(sys.stdlib_module_names) | {"jax", "numpy"}
    bad = []
    for path in (REPO / "imbatracer_tpu").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] not in allowed]
    assert not bad, bad
