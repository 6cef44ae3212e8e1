"""The benchmark's arithmetic: percentiles, rates, the exact ray
count past 2^24, and the roofline tallies pinned to chip_smoke.py's."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from portbench import harness, stats

sys.path.insert(0, harness.ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy(q):
    x = np.random.default_rng(3).lognormal(size=401)
    assert stats.percentile(x, q) == pytest.approx(np.percentile(x, q),
                                                   rel=1e-12)


def test_rate():
    assert stats.rate(3_000_000, 2.0) == 1.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_ray_count_exact_past_2_24():
    """A frame's total is summed exactly in int64 from each call's
    counts, past where a float32 sum stops holding every integer."""
    w, h = 1920, 1088
    rec = harness.Recorder(torch.device("cpu"), w, h, np.array([5]),
                           np.array([5]))
    px = torch.arange(w * h, dtype=torch.int32) % w
    py = torch.arange(w * h, dtype=torch.int32) // w
    total = 0
    for k in range(9):
        rc = ((torch.arange(w * h) * (k + 7)) % 6).to(torch.int32)
        rec.add(px, py, rc, torch.zeros((w * h, 3)), k, 1)
        total += int(rc.to(torch.int64).sum())
    assert total > 2 ** 24
    frame_total, calls = rec.take_frame()
    assert int(frame_total) == total and calls == []


def test_tallies_pinned_to_chip_smoke():
    for name in ("OPS_WATERTIGHT", "OPS_SPHERE", "OPS_CAMERA", "OPS_CAM_TEST",
                 "OPS_CAM_SPHERE", "OPS_CAM_HIT", "OPS_CAM_WAVE_TRI", "OPS_CAM_WAVE_SPHERE"):
        assert getattr(stats, name) == getattr(chip_smoke, name), name
    assert stats.PEAK_BYTES == chip_smoke.PEAK_BYTES
    for n, t, s, hits in ((1_048_576, 36, 1, 900_000), (7, 3, 0, 2)):
        assert stats.raygen_ops(n, t, s, hits) == chip_smoke.raygen_ops(
            n, t, s, hits)


def test_wave_ops_and_bound():
    """One launch of n camera rays with no bounce rays is the raygen
    tally with no winners; bounce rays add a full test each."""
    n, t, s = 4096, 36, 1
    assert stats.wave_ops(n, n, 1, t, s) == stats.raygen_ops(n, t, s, 0)
    extra = stats.wave_ops(n, n + 10, 1, t, s) - stats.wave_ops(n, n, 1, t, s)
    assert extra == 10 * (t * stats.OPS_WATERTIGHT + s * stats.OPS_SPHERE)
    assert stats.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert stats.bound_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_frame_seeds_and_samples_come_from_the_seed():
    big = 2 ** 31 + 977
    assert harness.frame_seed(big, 3) == harness.frame_seed(big, 3)
    assert harness.frame_seed(big, 3) != harness.frame_seed(big, 4)
    assert 0 <= harness.frame_seed(big, -1) < 2 ** 32
    a = harness.sample_pixels(big, (1920, 1080), 16, 2048)
    b = harness.sample_pixels(big, (1920, 1080), 16, 2048)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    x, y = a
    assert len(set(zip(x.tolist(), y.tolist()))) == 2048
    assert not ((x < 16) & (y < 16)).any()
    assert (x < 1920).all() and (y < 1080).all()
