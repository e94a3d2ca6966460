"""Progressive-accumulation realtime renderer (headless state machine).

The reference's realtime viewer (render.h:219-387) is an SFML window whose
interesting core is a state machine: a frame counter + accumulation texture
that blends each new frame-sample batch as ``mix(prev, cur, 1/(frame+1))``
(shader.h:299-304) and RESETS whenever the camera moves.  The SFML window
itself is out of scope (SURVEY.md section 2); this module reproduces the
state machine headlessly and scriptably, with the exact keyboard-control
semantics (WASD/arrows/space/z/r, render.h:268-359) exposed as methods, and
screenshots on demand ('p').

The blend ``mix(prev, cur, 1/(frame+1))`` over per-frame averages is the
running mean of all samples so far, so ``film`` always equals the
equal-weight average of every sample since the last camera move — verified
in tests against a single batch render.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import policy
from . import rng as prng
from .camera import (BACKWARD, DOWN, FORWARD, LEFT, RIGHT, UP, Camera,
                     move, rotate)
from .image import Film
from .linalg import DEG2RAD
from .render import render_film
from .scene import Scene


class RealtimeSession:
    """Progressive renderer with interactive camera (render.h:219-387).

    step() renders ``frame_samples`` fresh samples and folds them into the
    accumulation film; any camera mutation resets accumulation (frame=0),
    matching the reference's camera_changed handling (render.h:364-369).
    """

    ROTATE_ANGLE = 5 * DEG2RAD  # render.h:264
    MOVE_SPEED = 1.0            # render.h:265

    def __init__(self, camera: Camera, scene: Scene, depth: int = 5,
                 frame_samples: int = 15, *, seed: int = prng.SEED,
                 screenshot_dir: str = ".", accumulate: bool = True,
                 backend: str = "auto"):
        self.initial_camera = camera
        self.camera = camera
        self.scene = scene
        self.depth = depth
        self.frame_samples = frame_samples
        self.seed = seed
        self.screenshot_dir = screenshot_dir
        self.accumulate = accumulate
        # resolved once, from the platform and scene size (policy.py)
        self.backend = policy.resolve(backend, scene)
        self.frame = 0
        w, h = camera.res
        self._accum = np.zeros((h, w, 3), np.float32)

    # -- state machine ----------------------------------------------------

    def _reset(self):
        self.frame = 0
        self._accum[:] = 0.0

    def step(self) -> np.ndarray:
        """Render one frame batch; returns the current tone-mapped film
        (gamma 2.2, like the in-shader correction, shader.h:297)."""
        cur = render_film(
            self.camera, self.scene, self.frame_samples, self.depth,
            seed=self.seed + self.frame if self.accumulate else self.seed,
            backend=self.backend, verbose=False,
        ).data
        cur = np.asarray(cur)
        if not self.accumulate:
            self._reset()
        # mix(prev, cur, 1/(frame+1)) — running mean over frames
        t = 1.0 / (self.frame + 1)
        self._accum = self._accum * (1.0 - t) + cur * t
        self.frame += 1
        return self.display()

    def display(self) -> np.ndarray:
        """Current gamma-corrected film (H, W, 3) float in [0, 1]."""
        return np.power(np.clip(self._accum, 0.0, None), 1.0 / 2.2)

    # -- controls (render.h:276-338) --------------------------------------

    def _camera_changed(self):
        self._reset()

    def key(self, k: str) -> None:
        """Apply one key press with the reference's bindings."""
        k = k.lower()
        cam = self.camera
        if k == "left":
            cam = rotate(cam, LEFT, self.ROTATE_ANGLE)
        elif k == "right":
            cam = rotate(cam, RIGHT, self.ROTATE_ANGLE)
        elif k == "up":
            cam = rotate(cam, UP, self.ROTATE_ANGLE)
        elif k == "down":
            cam = rotate(cam, DOWN, self.ROTATE_ANGLE)
        elif k == "w":
            cam = move(cam, FORWARD, self.MOVE_SPEED)
        elif k == "s":
            cam = move(cam, BACKWARD, self.MOVE_SPEED)
        elif k == "a":
            cam = move(cam, LEFT, self.MOVE_SPEED)
        elif k == "d":
            cam = move(cam, RIGHT, self.MOVE_SPEED)
        elif k == "space":
            cam = move(cam, UP, self.MOVE_SPEED)
        elif k == "z":
            cam = move(cam, DOWN, self.MOVE_SPEED)
        elif k == "r":
            cam = self.initial_camera
        elif k == "p":
            self.screenshot()
            return
        else:
            return
        self.camera = cam
        self._camera_changed()

    def screenshot(self, filename: Optional[str] = None) -> str:
        """Save the current display to ``<dir>/<frame>.png``
        (render.h:339-351)."""
        if filename is None:
            os.makedirs(self.screenshot_dir, exist_ok=True)
            filename = os.path.join(self.screenshot_dir,
                                    f"{self.frame}.png")
        w, h = self.camera.res
        film = Film((w, h), data=self.display())
        film.save_png(filename)
        return filename

    @property
    def title(self) -> str:
        """Window-title string (render.h:378-381)."""
        p = np.asarray(self.camera.pos)
        f = np.asarray(self.camera.forward)
        return (f"pos: {p[0]:.6f}, {p[1]:.6f}, {p[2]:.6f} | "
                f"forward: {f[0]:.6f}, {f[1]:.6f}, {f[2]:.6f}")


def render_realtime(camera: Camera, scene: Scene, depth: int,
                    frame_samples: int, screenshot_dir: str,
                    *, frames: int = 30, keys: str = "",
                    backend: str = "auto", seed: int = prng.SEED,
                    accumulate: bool = True) -> RealtimeSession:
    """Headless driver: run ``frames`` steps, feeding ``keys`` one per frame
    (empty string entries = no key).  Returns the session for inspection.
    Scriptable analog of the reference's interactive loop."""
    sess = RealtimeSession(camera, scene, depth, frame_samples, seed=seed,
                           screenshot_dir=screenshot_dir,
                           accumulate=accumulate, backend=backend)
    key_list = keys.split(",") if keys else []
    for i in range(frames):
        if i < len(key_list) and key_list[i]:
            sess.key(key_list[i])
        sess.step()
    return sess


# ---------------------------------------------------------------------------
# Interactive terminal viewer
# ---------------------------------------------------------------------------

def ansi_frame(img: np.ndarray, max_cols: int = 128) -> str:
    """Render an (H, W, 3) float image in [0,1] as 24-bit ANSI half-block
    text (2 pixels per character row: upper via foreground '▀', lower via
    background).  The headless 'window': works over any terminal,
    including SSH — the reference's SFML window (render.h:219-387) has no
    display to attach to on a remote accelerator host."""
    h, w = img.shape[:2]
    step = max(1, (w + max_cols - 1) // max_cols)
    small = img[:: step, :: step]
    if small.shape[0] % 2:
        small = small[:-1]
    u8 = np.clip(small * 255.0, 0, 255).astype(np.uint8)
    top = u8[0::2]
    bot = u8[1::2]
    lines = []
    for tr, br in zip(top, bot):
        parts = []
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            parts.append(f"\x1b[38;2;{r1};{g1};{b1}m"
                         f"\x1b[48;2;{r2};{g2};{b2}m▀")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def run_interactive(camera: Camera, scene: Scene, depth: int = 5,
                    frame_samples: int = 4, *, backend: str = "auto",
                    seed: int = prng.SEED, screenshot_dir: str = ".",
                    max_frames: Optional[int] = None,
                    out=None) -> RealtimeSession:
    """Interactive terminal session: renders progressively and reads the
    reference's key bindings (render.h:276-338: wasd/arrows/space/z move,
    ijkl rotate stands in for the arrow-rotate pairs, r reset,
    p screenshot, q/ESC quit) from the raw terminal.  Requires a tty;
    falls back to a ValueError otherwise (use render_realtime for
    scripted/headless runs)."""
    import select
    import sys

    out = out or sys.stdout
    if not sys.stdin.isatty():
        raise ValueError("run_interactive needs a tty; use render_realtime "
                         "for headless driving")
    import termios
    import tty

    sess = RealtimeSession(camera, scene, depth, frame_samples, seed=seed,
                           screenshot_dir=screenshot_dir, backend=backend)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    frames = 0
    try:
        tty.setcbreak(fd)
        out.write("\x1b[2J")  # clear
        while max_frames is None or frames < max_frames:
            img = sess.step()
            frames += 1
            out.write("\x1b[H" + ansi_frame(img[::-1])
                      + f"\n\x1b[0m{sess.title}  frame {sess.frame}  "
                      f"[wasd/space/z move, ijkl rotate, r reset, "
                      f"p shot, q quit]\n")
            out.flush()
            while select.select([sys.stdin], [], [], 0)[0]:
                k = sys.stdin.read(1)
                if k == "\x1b":
                    # Drain the escape sequence: arrow keys arrive as
                    # ESC [ A..D — map them to the rotate bindings instead
                    # of quitting on the ESC prefix; a bare ESC quits.
                    seq = ""
                    while (len(seq) < 2
                           and select.select([sys.stdin], [], [], 0.01)[0]):
                        seq += sys.stdin.read(1)
                    arrow = {"[A": "up", "[B": "down",
                             "[C": "right", "[D": "left"}.get(seq)
                    if arrow is None:
                        return sess
                    sess.key(arrow)
                    continue
                if k == "q":
                    return sess
                sess.key({"i": "up", "k": "down", "j": "left",
                          "l": "right", " ": "space"}.get(k, k))
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return sess
