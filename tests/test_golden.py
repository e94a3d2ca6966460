"""Golden-image regression: renders must stay radiometrically and
structurally anchored to the reference's checked-in PNGs
(examples/cornell_box.png etc.).  A full-resolution matched-spp PSNR run
needs an accelerator; here a low-res statistical anchor keeps CI fast."""

import os

import numpy as np
import pytest

import pathtracer_tpu as pt

GOLDEN = "/root/reference/examples/cornell_box.png"


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="no reference golden")
def test_cornell_matches_golden_statistics():
    res = 64
    cam, scene = pt.cornell_box(res=(res, res))
    film = pt.render_film(cam, scene, samples=128, depth=5, seed=11)
    # film rows are bottom-up (image.h convention); PNGs are top-down
    ours_lin = np.asarray(film.data)[::-1]

    ref = pt.read_png(GOLDEN).astype(np.float32) / 255.0
    k = 1024 // res
    # linearize BEFORE downsampling (gamma is concave; the other order is
    # Jensen-biased dark)
    ref_lin = (ref ** 2.2).reshape(res, k, res, k, 3).mean((1, 3))
    ref_small = ref.reshape(res, k, res, k, 3).mean((1, 3))

    # Linear radiance agreement (unbiased estimator => tight)
    assert abs(ours_lin.mean() - ref_lin.mean()) / ref_lin.mean() < 0.05

    # Structural agreement in gamma space after clamping.  At this config
    # (64^2, 128 spp, 16x-downsampled golden) the comparison measures
    # 22.3-22.5 dB across seeds — our own Monte-Carlo noise floor.  Assert
    # the measured floor minus ~2 dB so a structural break (wrong wall,
    # shifted light, radiometric skew) fails even when a pure noise
    # regression would not.
    ours_g = np.clip(ours_lin, 0, 1) ** (1 / 2.2)
    p = pt.psnr(ours_g, ref_small)
    assert p > 20.0, f"PSNR vs golden dropped to {p:.2f} dB"

    # The brightest region (the light) is in the same place
    oy, ox = np.unravel_index(np.argmax(ours_g.sum(-1)), (res, res))
    ry, rx = np.unravel_index(np.argmax(ref_small.sum(-1)), (res, res))
    assert abs(int(oy) - int(ry)) <= 2 and abs(int(ox) - int(rx)) <= 2


TRUTH = os.path.join(os.path.dirname(__file__), "goldens",
                     "cornell64_truth.npz")
SNAP = os.path.join(os.path.dirname(__file__), "goldens",
                    "cornell64_cpu256_seed11.npz")


def _gamma(x):
    return np.clip(x, 0, 1) ** (1 / 2.2)


def test_cornell_matches_converged_self_golden():
    """A committed CONVERGED truth (65,536 spp, seed-averaged; 32k-vs-32k
    self-consistency 45.1 dB) plus a pinned-seed CPU snapshot, so CI
    catches regressions the noisy reference-golden anchor cannot:

      * PSNR vs the pinned 256-spp snapshot (same seed/backend) must stay
        near-exact — ANY change to sampling, intersection, or shading
        beyond float reassociation fails here;
      * PSNR and linear mean vs the converged truth bound total error —
        thresholds are calibrated 2 dB / 2x below the measured 256-spp
        Monte-Carlo floor (26.0 dB / 2.9 %)."""
    res = 64
    truth = np.load(TRUTH)["linear"]
    snap = np.load(SNAP)["linear"]
    cam, scene = pt.cornell_box(res=(res, res))
    film = pt.render_film(cam, scene, samples=256, depth=5, seed=11,
                          backend="brute")
    a = np.asarray(film.data)

    p_snap = pt.psnr(_gamma(a), _gamma(snap))
    assert p_snap > 50.0, f"pinned-seed drift: {p_snap:.2f} dB"

    p_truth = pt.psnr(_gamma(a), _gamma(truth))
    assert p_truth > 24.0, f"PSNR vs converged truth: {p_truth:.2f} dB"
    rel = abs(a.mean() - truth.mean()) / truth.mean()
    assert rel < 0.06, f"linear mean off truth by {rel:.3f}"
