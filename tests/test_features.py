"""Visual-frontend tests against the analytic simulator's rendered images:
detection localization, pyramidal KLT subpixel accuracy, and the full
tracker loop (the reference validates its flow against OpenCV + disparity
GT, 06-.../optical_flow.cpp and feature_tracker.cpp)."""
import numpy as np
import jax.numpy as jnp
import pytest

from vio_tpu import sim
from vio_tpu.camera import PinholeCamera
from vio_tpu.features import detect, klt, tracker


@pytest.fixture(scope="module")
def sim_data():
    return sim.generate(noise=False)


@pytest.fixture(scope="module")
def imgs(sim_data):
    return [sim.render_image(sim_data, k) for k in range(3)]


def _gt_uv(sim_data, k):
    sel = sim_data.obs_valid[k]
    return sim_data.obs_uv[k][sel], np.where(sel)[0]


def test_detect_finds_landmark_blobs(sim_data, imgs):
    uv_gt, _ = _gt_uv(sim_data, 0)
    xy, score, valid = detect.detect(jnp.asarray(imgs[0], jnp.float32),
                                     None, max_corners=150, min_dist=10)
    xy = np.asarray(xy)[np.asarray(valid)]
    # every detection should be within 1.5 px of some GT blob center
    d = np.linalg.norm(xy[:, None, :] - uv_gt[None, :, :], axis=-1).min(1)
    assert np.median(d) < 1.0, np.median(d)
    # and a good fraction of GT blobs should be found
    d_gt = np.linalg.norm(uv_gt[:, None, :] - xy[None, :, :], axis=-1).min(1)
    assert (d_gt < 2.0).mean() > 0.6


def test_klt_tracks_subpixel(sim_data, imgs):
    uv0, lids = _gt_uv(sim_data, 0)
    # track only blobs also visible in frame 1
    keep = sim_data.obs_valid[1][lids]
    uv0 = uv0[keep]
    lids = lids[keep]
    uv1_gt = sim_data.obs_uv[1][lids]
    flow = np.linalg.norm(uv1_gt - uv0, axis=1)
    p1, ok, res = klt.track(jnp.asarray(imgs[0], jnp.float32),
                            jnp.asarray(imgs[1], jnp.float32),
                            jnp.asarray(uv0), jnp.ones(len(uv0), bool))
    p1 = np.asarray(p1)
    ok = np.asarray(ok)
    assert ok.mean() > 0.7, ok.mean()
    err = np.linalg.norm(p1[ok] - uv1_gt[ok], axis=1)
    assert np.median(err) < 0.5, (np.median(err), np.max(flow))


def test_tracker_loop(sim_data, imgs):
    cam = PinholeCamera(fx=460.0, fy=460.0, cx=255.0, cy=255.0,
                        width=640, height=640)
    tr = tracker.FeatureTracker(cam, max_cnt=100, min_dist=10)
    out0 = tr.read_image(imgs[0], sim_data.cam_t[0])
    assert out0 == {}                       # first frame: nothing re-observed
    out1 = tr.read_image(imgs[1], sim_data.cam_t[1])
    assert len(out1) > 30
    out2 = tr.read_image(imgs[2], sim_data.cam_t[2])
    assert len(out2) > 30
    # ids persist across frames
    assert len(set(out1) & set(out2)) > 20
    # bearings must match the GT projections of SOME landmark to ~1px
    uv_gt, lids = _gt_uv(sim_data, 2)
    xy_gt = sim_data.obs_xy[2][lids]
    for fid, (bear, uv, vel) in list(out2.items())[:20]:
        d = np.linalg.norm(xy_gt - bear[:2], axis=1).min()
        assert d < 5.0 / 460.0, d


def _noise_scene(seed=0):
    """Smoothed noise on 0-255 at 640², 150 feature positions, and the
    image shifted by (dy, dx) = (2, 3) px (the bench.py KLT shape)."""
    rng = np.random.default_rng(seed)
    img0 = rng.standard_normal((640, 640)).astype(np.float32)
    for _ in range(2):
        img0 = (np.roll(img0, 1, 0) + np.roll(img0, -1, 0) +
                np.roll(img0, 1, 1) + np.roll(img0, -1, 1) + img0) / 5.0
    img0 = (img0 - img0.min()) / (img0.max() - img0.min()) * 255.0
    pts = rng.uniform(40, 600, (150, 2)).astype(np.float32)
    return img0, np.roll(img0, (2, 3), axis=(0, 1)), pts


def _bilinear_ref(img, xy):
    """float64 bilinear sample with pyramid.bilinear_sample's edge clamp."""
    H, W = img.shape
    x = np.clip(xy[..., 0], 0.0, W - 1.001)
    y = np.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1]) +
            fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


@pytest.mark.parametrize("half", [klt.HALF, klt.REFINE_HALF])
def test_patch_sampling_matches_bilinear_reference(half):
    from vio_tpu.features import pyramid

    img0, _, pts = _noise_scene()
    # one feature pinned at the border exercises the edge clamp
    pts[0] = [0.25, 639.5]
    gx, gy = pyramid.central_gradients(jnp.asarray(img0))
    imgs = jnp.stack([jnp.asarray(img0), gx, gy])
    got = np.asarray(pyramid.patch_sample_multi(imgs, jnp.asarray(pts), half),
                     np.float64)
    P = 2 * half + 1
    assert got.shape == (3, 150, P * P)
    g = np.arange(-half, half + 1, dtype=np.float32)
    dx, dy = np.meshgrid(g, g)
    grid = np.stack([dx, dy], -1).reshape(-1, 2)
    # sample positions as the device forms them: centre + offset in float32
    xy = (pts[:, None, :] + grid[None]).astype(np.float64)
    for c in range(3):
        ref = _bilinear_ref(np.asarray(imgs[c], np.float64), xy)
        np.testing.assert_allclose(got[c], ref, atol=1e-3)


def test_track_fb_recovers_known_shift():
    img0, img1, pts = _noise_scene()
    p1, ok, res = klt.track_fb(jnp.asarray(img0), jnp.asarray(img1),
                               jnp.asarray(pts), jnp.ones(150, bool))
    ok = np.asarray(ok)
    assert ok.mean() > 0.9, ok.mean()
    d = np.abs(np.asarray(p1) - (pts + [3.0, 2.0]))[ok]
    assert (d.max(axis=1) < 0.05).mean() >= 0.95
