"""Per-feature track store across the sliding window.

Re-derivation in JAX of the reference's FeatureManager
(reference: vins-mono/src/feature_manager.cpp:45-388 — keyframe decision
by mean compensated parallax, multi-view SVD triangulation, depth pack /
unpack, and track surgery on window slide).  This is deliberately a
host-side structure: it is tiny (≤ a few hundred tracks × 11 frames) and
changes shape every frame; the estimator packs it into the static
``(F, W+1)`` device grid consumed by the jitted solver
(vio_tpu/solver/window.py) once per solve.
"""
from __future__ import annotations

import numpy as np

INIT_DEPTH = 5.0   # reference: parameters.cpp INIT_DEPTH


class Feature:
    __slots__ = ("feature_id", "start_frame", "pts", "vels", "depth",
                 "solve_flag")

    def __init__(self, feature_id: int, start_frame: int):
        self.feature_id = feature_id
        self.start_frame = start_frame
        self.pts = []        # list of (3,) normalized bearing per frame
        self.vels = []       # list of (2,) normalized-plane velocity
        self.depth = -1.0    # estimated depth in the start frame (camera)
        self.solve_flag = 0  # 0 untouched, 1 solved ok, 2 solved negative

    @property
    def end_frame(self) -> int:
        return self.start_frame + len(self.pts) - 1

    @property
    def used_num(self) -> int:
        return len(self.pts)


class FeatureManager:
    """The window's feature table (feature_manager.h FeaturePerId list)."""

    def __init__(self, window_size: int = 10, min_parallax: float = 10.0 / 460.0):
        self.window_size = window_size
        self.min_parallax = min_parallax
        self.features: dict[int, Feature] = {}
        self.last_track_num = 0

    def clear(self):
        self.features.clear()
        self.last_track_num = 0

    # -- frame ingestion + keyframe decision (feature_manager.cpp:45-118) --

    def add_feature_check_parallax(self, frame_count: int, feats: dict) -> bool:
        """feats: {feature_id: (xyz bearing (3,), uv (2,), vel (2,))}.
        Returns True → marginalize OLD (new frame IS a keyframe)."""
        parallax_sum = 0.0
        parallax_num = 0
        self.last_track_num = 0
        for fid, (xyz, _uv, vel) in feats.items():
            ft = self.features.get(fid)
            if ft is None:
                ft = Feature(fid, frame_count)
                self.features[fid] = ft
            else:
                self.last_track_num += 1
            ft.pts.append(np.asarray(xyz, dtype=np.float64))
            ft.vels.append(np.asarray(vel, dtype=np.float64))

        if frame_count < 2 or self.last_track_num < 20:
            return True

        for ft in self.features.values():
            if ft.start_frame <= frame_count - 2 and ft.end_frame >= frame_count - 1:
                parallax_sum += self._compensated_parallax2(ft, frame_count)
                parallax_num += 1

        if parallax_num == 0:
            return True
        return parallax_sum / parallax_num >= self.min_parallax

    def _compensated_parallax2(self, ft: Feature, frame_count: int) -> float:
        """Parallax of ft between frames (frame_count-2, frame_count-1) on
        the normalized plane (feature_manager.cpp:356-388; the rotation
        compensation reduces to identity as in the reference)."""
        p_i = ft.pts[frame_count - 2 - ft.start_frame]
        p_j = ft.pts[frame_count - 1 - ft.start_frame]
        du = p_i[0] / p_i[2] - p_j[0] / p_j[2]
        dv = p_i[1] / p_i[2] - p_j[1] / p_j[2]
        return float(np.sqrt(du * du + dv * dv))

    # -- correspondence extraction (feature_manager.cpp:120-140) --

    def get_corresponding(self, frame_l: int, frame_r: int):
        """Normalized xy pairs of features observed in both frames."""
        a, b = [], []
        for ft in self.features.values():
            if ft.start_frame <= frame_l and ft.end_frame >= frame_r:
                pa = ft.pts[frame_l - ft.start_frame]
                pb = ft.pts[frame_r - ft.start_frame]
                a.append(pa[:2] / pa[2])
                b.append(pb[:2] / pb[2])
        return np.asarray(a).reshape(-1, 2), np.asarray(b).reshape(-1, 2)

    # -- depth vector pack/unpack (feature_manager.cpp:142-200) --

    def candidates(self):
        """Features that participate in the solve (used_num>=2 and start
        early enough), in stable id order — the reference's getFeatureCount
        filter (feature_manager.cpp:33-43)."""
        return [ft for ft in self.features.values()
                if ft.used_num >= 2 and ft.start_frame < self.window_size - 2]

    def get_inv_depths(self) -> np.ndarray:
        return np.array([1.0 / ft.depth for ft in self.candidates()])

    def set_inv_depths(self, inv_depths: np.ndarray):
        for ft, invd in zip(self.candidates(), inv_depths):
            ft.depth = 1.0 / invd if invd != 0 else INIT_DEPTH
            ft.solve_flag = 2 if ft.depth < 0 else 1

    def remove_failures(self):
        """Drop features whose solved depth went negative
        (estimator.cpp removeFailures → feature_manager.cpp:164)."""
        for fid in [f.feature_id for f in self.features.values()
                    if f.solve_flag == 2]:
            del self.features[fid]

    def clear_depth(self):
        for ft in self.features.values():
            ft.depth = -1.0

    # -- multi-view triangulation (feature_manager.cpp:202-275) --

    def triangulate(self, Ps, Rs, tic, ric):
        """Fill depth for candidates with depth<0.  Ps/Rs: body states in
        world; camera pose of frame k: R_wc = Rs[k]·ric, t_wc = Ps[k]+Rs[k]·tic.
        DLT in the start frame's camera coordinates.

        Vectorized over ALL pending features at once (one batched 4×4
        eigh instead of a per-feature 2L×4 SVD — the null vector of A is
        the min-eigenvector of AᵀA): the per-feature Python loop here was
        the reference's own hot spot (feature_manager.cpp:202-243) and a
        measurable share of the per-frame host time."""
        pend = [ft for ft in self.candidates() if ft.depth <= 0]
        if not pend:
            return
        W1 = len(Ps)
        # camera poses per frame (shared across features)
        Rc = np.asarray(Rs) @ ric                      # (W1, 3, 3)
        tc = np.asarray(Ps) + np.asarray(Rs) @ np.asarray(tic)  # (W1, 3)

        # flat observation list
        fi, oi, oj, xy = [], [], [], []
        for n, ft in enumerate(pend):
            i = ft.start_frame
            for k, p in enumerate(ft.pts):
                j = i + k
                if j >= W1:
                    break
                fi.append(n)
                oi.append(i)
                oj.append(j)
                xy.append(p[:2] / p[2])
        fi = np.asarray(fi)
        oi = np.asarray(oi)
        oj = np.asarray(oj)
        xy = np.asarray(xy)                            # (N, 2)

        Rj = Rc[oj]                                    # (N, 3, 3)
        # x_j = R X + t with X in cam-i coords: R = Rjᵀ Ri, t = Rjᵀ (ti - tj)
        R = np.einsum("nba,nbc->nac", Rj, Rc[oi])      # (N, 3, 3)
        t = np.einsum("nba,nb->na", Rj, tc[oi] - tc[oj])
        P = np.concatenate([R, t[:, :, None]], axis=2)  # (N, 3, 4)
        r0 = xy[:, 0:1] * P[:, 2] - P[:, 0]            # (N, 4)
        r1 = xy[:, 1:2] * P[:, 2] - P[:, 1]
        rows = np.stack([r0, r1], axis=1)              # (N, 2, 4)

        AtA = np.zeros((len(pend), 4, 4))
        np.add.at(AtA, fi, np.einsum("nra,nrb->nab", rows, rows))
        _, V = np.linalg.eigh(AtA)                     # ascending eigenvalues
        X = V[:, :, 0]                                 # (Fp, 4) null vectors
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = X[:, 2] / X[:, 3]
        depth = np.where(np.isfinite(depth) & (depth >= 0.1),
                         depth, INIT_DEPTH)
        for n, ft in enumerate(pend):
            ft.depth = float(depth[n])

    # -- window-slide surgery (feature_manager.cpp:276-355) --

    def remove_back(self):
        """Drop frame 0 without depth transfer (pre-init slide)."""
        for fid in list(self.features):
            ft = self.features[fid]
            if ft.start_frame != 0:
                ft.start_frame -= 1
            else:
                ft.pts.pop(0)
                ft.vels.pop(0)
                if not ft.pts:
                    del self.features[fid]

    def remove_back_shift_depth(self, marg_R, marg_P, new_R, new_P):
        """Drop frame 0 re-anchoring depth into the new frame 0
        (feature_manager.cpp:276-314).  marg_*/new_* are CAMERA poses
        (R_wc, t_wc) of the evicted and the new first frame."""
        for fid in list(self.features):
            ft = self.features[fid]
            if ft.start_frame != 0:
                ft.start_frame -= 1
                continue
            uv = ft.pts[0]
            ft.pts.pop(0)
            ft.vels.pop(0)
            if len(ft.pts) < 2:
                del self.features[fid]
                continue
            if ft.depth > 0:
                # bearings are stored (x, y, 1), so depth scales directly
                pts_i = uv * ft.depth
                w_pts = marg_R @ pts_i + marg_P
                pts_j = new_R.T @ (w_pts - new_P)
                ft.depth = pts_j[2] if pts_j[2] > 0 else INIT_DEPTH

    def remove_front(self, frame_count: int):
        """Drop the second-newest frame's observations (MARGIN_NEW slide,
        feature_manager.cpp:334-355)."""
        for fid in list(self.features):
            ft = self.features[fid]
            if ft.start_frame == frame_count:
                ft.start_frame -= 1
                continue
            if ft.end_frame < frame_count - 1:
                continue
            j = frame_count - 1 - ft.start_frame
            ft.pts.pop(j)
            ft.vels.pop(j)
            if not ft.pts:
                del self.features[fid]
