"""Progressive-accumulation state machine tests (render.h:219-387 analog)."""

import os

import numpy as np
import pytest

import pathtracer_tpu as pt
from pathtracer_tpu.realtime import RealtimeSession, render_realtime


def _session(**kw):
    cam, scene = pt.corner_scene(res=(16, 16))
    return RealtimeSession(cam, scene, depth=3, frame_samples=4, **kw)


def test_accumulation_is_running_mean():
    s = _session()
    f1 = s.step()
    assert s.frame == 1
    f2 = s.step()
    assert s.frame == 2
    # accumulating frames reduces variance; image stays in range
    assert f1.shape == (16, 16, 3)
    assert np.all(f2 >= 0) and np.isfinite(f2).all()


def test_camera_move_resets_accumulation():
    s = _session()
    s.step()
    s.step()
    assert s.frame == 2
    s.key("w")
    assert s.frame == 0
    assert np.all(s._accum == 0)
    np.testing.assert_allclose(
        np.asarray(s.camera.pos),
        np.asarray(pt.move(s.initial_camera, pt.FORWARD, 1.0).pos),
        atol=1e-6)


def test_reset_key_restores_camera():
    s = _session()
    for k in ("w", "a", "up", "left", "space"):
        s.key(k)
    s.key("r")
    np.testing.assert_allclose(np.asarray(s.camera.pos),
                               np.asarray(s.initial_camera.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(s.camera.forward),
                               np.asarray(s.initial_camera.forward),
                               atol=1e-6)


def test_screenshot(tmp_path):
    s = _session(screenshot_dir=str(tmp_path))
    s.step()
    s.key("p")
    path = os.path.join(str(tmp_path), "1.png")
    assert os.path.exists(path)
    from pathtracer_tpu.image import read_png
    assert read_png(path).shape == (16, 16, 3)


def test_headless_driver_with_key_script(tmp_path):
    cam, scene = pt.corner_scene(res=(16, 16))
    sess = render_realtime(cam, scene, depth=2, frame_samples=2,
                           screenshot_dir=str(tmp_path), frames=4,
                           keys=",w,,p")
    # 'w' at loop-iter 1 reset accumulation; 3 steps ran since ('p' at
    # iter 3 only screenshots, no reset)
    assert sess.frame == 3
    assert "pos:" in sess.title


def test_non_accumulate_mode():
    s = _session(accumulate=False)
    f1 = s.step()
    f2 = s.step()
    np.testing.assert_allclose(f1, f2)  # same seed, fresh film each frame


def test_realtime_auto_picks_beam_for_big_scenes(monkeypatch):
    """Interactive sessions resolve 'auto' through the platform policy
    (policy.py): on a GPU, small scenes take the megakernel and OBJ-scale
    scenes the GPU's BVH traversal (the large-scene kernel this test once
    covered is gone); on the CPU, brute and bvh.  Explicit backends pass
    through."""
    import dataclasses

    from pathtracer_tpu import meshes, policy

    cam, sb = meshes.sphere_in_box(16, 32)  # 1036 tris > BRUTE_MAX
    scene = sb.build()
    cam = dataclasses.replace(cam, res=(32, 32))
    cam2, small = pt.cornell_box(res=(32, 32))

    assert RealtimeSession(cam, scene).backend == "bvh"
    assert RealtimeSession(cam2, small).backend == "brute"
    assert RealtimeSession(cam, scene, backend="bvh-gather").backend == \
        "bvh-gather"
    monkeypatch.setattr(policy, "platform", lambda: "gpu")
    assert RealtimeSession(cam, scene).backend == policy.GPU_LARGE_SCENE
    assert RealtimeSession(cam2, small).backend == "pallas"
    monkeypatch.setattr(policy, "platform", lambda: "rocm")
    with pytest.raises(ValueError, match="no backend policy"):
        RealtimeSession(cam2, small)


def test_ansi_frame_renders_halfblocks():
    import importlib

    rt = importlib.import_module("pathtracer_tpu.realtime")
    img = np.zeros((4, 4, 3), np.float32)
    img[0, 0] = (1.0, 0.0, 0.0)
    s = rt.ansi_frame(img)
    lines = s.split("\n")
    assert len(lines) == 2            # 4 rows -> 2 half-block lines
    assert s.count("▀") == 8          # 4 cols x 2 lines
    assert "\x1b[38;2;255;0;0m" in lines[0]   # the red pixel, upper half
    assert lines[0].endswith("\x1b[0m")
    # downsampling cap
    big = np.zeros((8, 256, 3), np.float32)
    s2 = rt.ansi_frame(big, max_cols=64)
    assert s2.split("\n")[0].count("▀") == 64


def test_run_interactive_requires_tty(monkeypatch):
    import importlib
    import io
    import sys

    import pytest

    rt = importlib.import_module("pathtracer_tpu.realtime")
    cam, scene = pt.corner_scene(res=(8, 8))
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    with pytest.raises(ValueError, match="tty"):
        rt.run_interactive(cam, scene, max_frames=1)
