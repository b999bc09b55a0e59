"""The in-repo PNG codec and Pillow-exact image operations
(fea_tpu/utils/png.py) against Pillow itself on the repo's own images."""

import glob
import io
import os

import numpy as np
import pytest

from fea_tpu.utils import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP_PNGS = sorted(glob.glob(os.path.join(ROOT, "docs", "app_eval", "*", "*.png")))


@pytest.mark.parametrize("shape", [(37, 53), (20, 30, 3), (5, 7, 4), (9, 4, 2)])
def test_png_round_trip(tmp_path, shape):
    """L, RGB, RGBA and LA images survive write -> read bit for bit."""
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_writes_what_pillow_reads():
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(1).integers(0, 256, (31, 17, 3), dtype=np.uint8)
    got = np.asarray(Image.open(io.BytesIO(png.encode_png(img))))
    np.testing.assert_array_equal(got, img)


def test_decode_matches_pillow_on_repo_pngs():
    """Pillow-written files (rows filtered Sub/Up/Paeth) decode to
    Pillow's pixels; so do their grayscale and ROTATE_270 forms."""
    Image = pytest.importorskip("PIL.Image")
    assert APP_PNGS
    for path in APP_PNGS:
        ours = png.read_png(path)
        ref = Image.open(path)
        np.testing.assert_array_equal(ours, np.asarray(ref), err_msg=path)
        np.testing.assert_array_equal(
            png.to_gray(ours), np.asarray(ref.convert("L")), err_msg=path
        )
        np.testing.assert_array_equal(
            png.rotate_270(ours),
            np.asarray(ref.transpose(Image.Transpose.ROTATE_270)),
            err_msg=path,
        )


def test_gray_matches_pillow_on_rgb():
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(2).integers(0, 256, (40, 24, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        png.to_gray(img), np.asarray(Image.fromarray(img).convert("L"))
    )


@pytest.mark.parametrize("size", [256, 64])
def test_resize_matches_pillow_bilinear(size):
    """512 -> 256 and 512 -> 64 (the filter's support widens when
    downscaling): every pixel equals Pillow's BILINEAR."""
    Image = pytest.importorskip("PIL.Image")
    paths = [p for p in APP_PNGS if Image.open(p).size == (512, 512)]
    assert paths
    for path in paths:
        ref = Image.open(path).resize((size, size), Image.Resampling.BILINEAR)
        got = png.resize(png.read_png(path), (size, size), "bilinear")
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=path)


def test_resize_matches_pillow_bicubic_rgb():
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(3).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    for size in ((20, 30), (64, 80)):
        ref = Image.fromarray(img).resize(size, Image.Resampling.BICUBIC)
        np.testing.assert_array_equal(
            png.resize(img, size, "bicubic"), np.asarray(ref)
        )
