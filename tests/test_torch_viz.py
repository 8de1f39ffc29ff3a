"""tpu_pillars_torch's BEV visualisation (``utils/viz.py``) on the CPU: the
six cases of tests/test_viz.py on the port, each image also equal bit for
bit to the JAX package's ``utils.viz`` on the same inputs."""

import struct
import zlib

import numpy as np
import pytest

from tpu_pillars_torch.config import tiny_config
from tpu_pillars_torch.geometry.boxes import Box3D
from tpu_pillars_torch.utils.viz import (
    CLASS_COLORS,
    bev_image,
    draw_boxes_bev,
    render_scene,
    save_png,
)

EXTENT = (-10.0, 10.0, -10.0, 10.0)


def _jviz():
    from tpu_pillars.utils import viz

    return viz


def test_bev_image_accumulates_points():
    pts = np.asarray([[0.0, 0.0, 0.0, 0.5]] * 50
                     + [[5.0, -5.0, 0.0, 0.5]], np.float32)
    img = bev_image(pts, extent=EXTENT, size=(201, 201))
    assert img.shape == (201, 201, 3) and img.dtype == np.uint8
    # world (0,0) -> col 100, row 100; 50 stacked points must outshine 1
    assert img[100, 100].sum() > img[150, 150].sum() > 0
    assert img[0, 0].sum() == 0
    far = np.asarray([[99.0, 99.0]])
    assert bev_image(far, extent=EXTENT, size=(64, 64)).sum() == 0
    np.testing.assert_array_equal(
        img, _jviz().bev_image(pts, extent=EXTENT, size=(201, 201)))
    cfg = tiny_config()
    rng = np.random.default_rng(3)
    cloud = rng.uniform(-25, 25, size=(4000, 4)).astype(np.float32)
    np.testing.assert_array_equal(bev_image(cloud, config=cfg),
                                  _jviz().bev_image(cloud, config=cfg))


def test_draw_boxes_marks_corners_with_class_color():
    img = np.zeros((201, 201, 3), np.uint8)
    # axis-aligned box at origin: w=2 (y extent), l=4 (x extent), yaw=0
    boxes = np.asarray([[0.0, 0.0, 0.0, 2.0, 4.0, 1.0, 0.0]])
    draw_boxes_bev(img, boxes, extent=EXTENT, class_ids=[7])
    color = np.asarray(CLASS_COLORS[7], np.uint8)
    # front-left corner: world (2, 1) -> col 120, row 90 (0.1 m/px, +y up)
    assert (img[90, 120] == color).all()
    assert (img[110, 80] == color).all()   # rear-right corner world (-2, -1)
    # heading tick runs center -> mid-front edge (world (0,0) -> (2,0))
    assert (img[100, 110] == color).all()
    assert img[50, 50].sum() == 0
    want = _jviz().draw_boxes_bev(np.zeros((201, 201, 3), np.uint8), boxes,
                                  extent=EXTENT, class_ids=[7])
    np.testing.assert_array_equal(img, want)


def test_box3d_labels_resolve_class_colors():
    from tpu_pillars.config import tiny_config as jax_tiny_config
    from tpu_pillars.geometry.boxes import Box3D as JaxBox3D

    cfg = tiny_config()
    img = np.zeros((101, 101, 3), np.uint8)
    b = Box3D(center=(0, 0, 0), wlh=(2, 4, 1), yaw=0.0,
              label=cfg.class_names[-1])
    draw_boxes_bev(img, [b], config=cfg, extent=EXTENT)
    want = np.asarray(CLASS_COLORS[(len(cfg.class_names) - 1)
                                   % len(CLASS_COLORS)], np.uint8)
    assert (img == want).all(-1).any()
    jb = JaxBox3D(center=(0, 0, 0), wlh=(2, 4, 1), yaw=0.0,
                  label=cfg.class_names[-1])
    jimg = _jviz().draw_boxes_bev(np.zeros((101, 101, 3), np.uint8), [jb],
                                  config=jax_tiny_config(), extent=EXTENT)
    np.testing.assert_array_equal(img, jimg)


def test_render_scene_draws_gt_and_preds():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-9, 9, size=(500, 4)).astype(np.float32)
    gt = np.asarray([[3.0, 3.0, 0.0, 2.0, 4.0, 1.5, 0.3]])
    pred = np.asarray([[-4.0, -4.0, 0.0, 1.0, 2.0, 1.0, 1.2]])
    kw = dict(pred_boxes=pred, gt_boxes=gt, extent=EXTENT,
              pred_class_ids=[2], size=(256, 256))
    img = render_scene(pts, **kw)
    assert (img == np.asarray((0, 255, 0), np.uint8)).all(-1).any()   # GT
    assert (img == np.asarray(CLASS_COLORS[2], np.uint8)).all(-1).any()
    assert img.shape == (256, 256, 3)
    np.testing.assert_array_equal(img, _jviz().render_scene(pts, **kw))
    thick = render_scene(pts, thickness=3, **kw)
    np.testing.assert_array_equal(
        thick, _jviz().render_scene(pts, thickness=3, **kw))


def test_save_png_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        crc = struct.unpack(">I", data[pos + 8 + ln:pos + 12 + ln])[0]
        assert crc == zlib.crc32(tag + payload) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + payload
        pos += 12 + ln
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, ctype) == (53, 37, 8, 2)
    raw = zlib.decompress(chunks[b"IDAT"])
    rows = [raw[r * (1 + w * 3):(r + 1) * (1 + w * 3)] for r in range(h)]
    assert all(r[0] == 0 for r in rows)
    got = np.frombuffer(b"".join(r[1:] for r in rows),
                        np.uint8).reshape(h, w, 3)
    np.testing.assert_array_equal(got, img)
    # the file's bytes equal the JAX writer's
    jpath = str(tmp_path / "j.png")
    _jviz().save_png(jpath, img)
    with open(jpath, "rb") as f:
        assert f.read() == data


def test_save_png_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError):
        save_png(str(tmp_path / "bad.png"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        save_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 3), np.float32))
