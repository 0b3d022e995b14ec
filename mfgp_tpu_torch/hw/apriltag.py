"""AprilTag localization (SURVEY C24) — detector-independent core.

The reference fuses per-tag camera poses into an 8-state
(x, y, z, yaw + rates) KF with distance/skew/pose-error-scaled measurement
noise, a sliding outlier window, depth and GPS measurements
(reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
58-275; SE(3)/tag-map utilities in
reference/PhysicalExperimentCode/aprilTagLocations.py:22-122).

Here the *math* is rebuilt as pure functions over arrays: the camera
detector (dt_apriltags, hardware-facing) stays out of scope; anything that
yields (tag_id, R, t, pose_err) tuples plugs in. Batched detections fuse in
one call.

Counterpart of ``mfgp_tpu/hw/apriltag.py``: the geometry is numpy, the
filter's predict and update are the port's ``estimation.kalman`` steps on
the fusion's ``device`` (the card unless asked otherwise), in float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mfgp_tpu_torch.estimation.kalman import kf_predict, kf_update
from mfgp_tpu_torch.hw.controllers import angle_wrap
from mfgp_tpu_torch.utils.device import CUDA, resolve

# ---------------------------------------------------------------------------
# SE(3) utilities (zyx Euler convention, degrees in artifacts)
# ---------------------------------------------------------------------------


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rot_y(b):
    c, s = np.cos(b), np.sin(b)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rot_z(g):
    c, s = np.cos(g), np.sin(g)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def zyx_rotm(roll, pitch, yaw):
    """R = Rz(yaw) Ry(pitch) Rx(roll)
    (reference/aprilTagLocations.py:31-36)."""
    return rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)


def rotm_to_euler(R) -> Tuple[float, float, float]:
    """Inverse of zyx_rotm, radians (reference/aprilTagLocations.py:13-20)."""
    sy = np.hypot(R[2, 1], R[2, 2])
    return (float(np.arctan2(R[2, 1], R[2, 2])),
            float(np.arctan2(-R[2, 0], sy)),
            float(np.arctan2(R[1, 0], R[0, 0])))


def rp_to_tf(R, p) -> np.ndarray:
    """(R, p) -> 4x4 transform (reference/aprilTagLocations.py:37-43)."""
    tf = np.eye(4)
    tf[:3, :3] = R
    tf[:3, 3] = np.asarray(p).reshape(-1)
    return tf


def vec_to_tf(vec) -> np.ndarray:
    """[x, y, z, roll_deg, pitch_deg, yaw_deg] -> transform
    (reference/aprilTagLocations.py:55-61)."""
    v = np.asarray(vec, float)
    tf = np.eye(4)
    tf[:3, :3] = zyx_rotm(*np.deg2rad(v[3:6]))
    tf[:3, 3] = v[:3]
    return tf


def tf_to_vec(tf) -> np.ndarray:
    """transform -> [x, y, z, roll_deg, pitch_deg, yaw_deg]."""
    eul = np.rad2deg(rotm_to_euler(tf[:3, :3]))
    return np.concatenate([tf[:3, 3], eul])


def load_tag_map(csv_path) -> Dict[int, np.ndarray]:
    """Tag-id -> world transform from a tank-locations CSV whose rows are
    ``id, x, y, z, roll, pitch, yaw`` (degrees)
    (reference/aprilTagLocations.py tag map from
    calibrationData/AprilTagTankLocations.csv)."""
    rows = np.loadtxt(csv_path, delimiter=",", skiprows=1, ndmin=2)
    return {int(r[0]): vec_to_tf(r[1:7]) for r in rows}


# ---------------------------------------------------------------------------
# Fusion filter
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AprilFusionConfig:
    """8-state filter constants; names mirror the ``atl.*`` config
    (reference/aprilTagLocations.py / exploreExpSettings)."""

    p0_diag: Tuple[float, ...] = (1, 1, 1, 1, 1, 1, 1, 1)
    q_diag: Tuple[float, ...] = (.01, .01, .01, .01, .05, .05, .05, .05)
    r_depth: float = 1e-4
    r_yaw: float = 1e-2
    r_tag_xyz: float = 0.05  # base per-tag position noise
    r_tag_yaw: float = 0.1
    gps_xy_noise: float = 0.5
    gps_yaw_noise: float = 0.2
    pose_err_scale: float = 1e5  # pe scaling (driver ``peScale``, :147)
    window_len: int = 10
    window_time: float = 2.0  # seconds
    window_reject_dist: float = 1.0  # meters from window mean
    boundaries_xy: Optional[Tuple[float, float, float, float]] = None

    def A(self, dt):
        A = np.eye(8)
        for i in range(4):
            A[i, 4 + i] = dt
        return A


@dataclass
class TagDetection:
    """One detector hit: pose of the tag in the camera frame + quality."""

    tag_id: int
    R: np.ndarray  # (3,3)
    t: np.ndarray  # (3,) or (3,1)
    pose_err: float = 0.0


@dataclass
class AprilFusion:
    """Sliding-window-gated 8-state fusion of tags + depth (+ GPS).

    State layout [x, y, z, yaw, vx, vy, vz, vyaw]; per-tag measurement
    noise scales with tag distance and pose error, matching the driver's
    noise model (reference/GraceExplorationExperiments_MFEGP.py:205-213);
    a short time window of recent positions rejects outlier fixes
    (:170-189).
    """

    tag_map: Dict[int, np.ndarray]
    imu_in_camera_frame: np.ndarray = field(
        default_factory=lambda: np.eye(4))
    cfg: AprilFusionConfig = field(default_factory=AprilFusionConfig)
    device: torch.device | str = CUDA

    def __post_init__(self):
        self.device = resolve(self.device)
        self.x = np.zeros((8, 1))
        self.P = np.diag(self.cfg.p0_diag).astype(float)
        self._window: list = []  # (t, x, y)

    # -- geometry -----------------------------------------------------------
    def tag_to_world_pose(self, det: TagDetection) -> Optional[np.ndarray]:
        """IMU pose in world frame implied by one detection, or None for
        unmapped tags."""
        if det.tag_id not in self.tag_map:
            return None
        tag_in_cam = rp_to_tf(det.R, det.t)
        cam_in_tag = np.linalg.inv(tag_in_cam)
        cam_in_world = self.tag_map[det.tag_id] @ cam_in_tag
        return cam_in_world @ self.imu_in_camera_frame

    def _window_reject(self, t_now, x, y, trust_gps: bool) -> bool:
        w = [(tw, xw, yw) for tw, xw, yw in self._window
             if tw > t_now - self.cfg.window_time]
        self._window = w
        if trust_gps or len(w) < 3:
            return False
        mx = np.mean([p[1] for p in w])
        my = np.mean([p[2] for p in w])
        return np.hypot(x - mx, y - my) > self.cfg.window_reject_dist

    def _on_device(self, *arrays):
        """numpy arrays as float64 tensors on the fusion's device (None
        stays None)."""
        return [None if a is None else torch.as_tensor(
            np.asarray(a, float), dtype=torch.float64, device=self.device)
            for a in arrays]

    # -- fusion -------------------------------------------------------------
    def step(self, t_now: float, dt: float, depth: float, yaw: float,
             detections: Sequence[TagDetection] = (),
             gps: Optional[Tuple[float, float, float]] = None):
        """Predict + fuse one camera frame. Returns (state, cov_diag)."""
        cfg = self.cfg
        x, P = kf_predict(*self._on_device(self.x, None, cfg.A(dt), None,
                                           self.P, np.diag(cfg.q_diag) * dt))
        self.x, self.P = x.cpu().numpy(), P.cpu().numpy()

        rows, meas, noise = [], [], []

        def add(h_row, z, r):
            rows.append(h_row)
            meas.append(z)
            noise.append(r)

        def unwrap(z_yaw):
            """Re-reference a wrapped yaw measurement to the current state
            so innovations never jump by ~2*pi (the reference wraps the
            state every cycle, driver :226-230)."""
            return self.x[3, 0] + angle_wrap(z_yaw - self.x[3, 0], np.pi)

        h_depth = np.zeros(8)
        h_depth[2] = 1.0
        add(h_depth, depth, cfg.r_depth)
        if detections:
            h_yaw = np.zeros(8)
            h_yaw[3] = 1.0
            add(h_yaw, unwrap(yaw), cfg.r_yaw)
        if gps is not None:
            gx, gy, gyaw = gps
            for i, (z, r) in enumerate(
                    [(gx, cfg.gps_xy_noise), (gy, cfg.gps_xy_noise)]):
                h = np.zeros(8)
                h[i] = 1.0
                add(h, z, r)
            h = np.zeros(8)
            h[3] = 1.0
            # unwrap GPS yaw near the current estimate (driver :139)
            add(h, unwrap(gyaw), cfg.gps_yaw_noise)

        accepted = 0
        for det in detections:
            pose = self.tag_to_world_pose(det)
            if pose is None:
                continue
            px, py, pz = pose[:3, 3]
            proll, ppitch, pyaw = rotm_to_euler(pose[:3, :3])
            if cfg.boundaries_xy is not None:
                xmax, xmin, ymax, ymin = cfg.boundaries_xy
                if not (xmin <= px <= xmax and ymin <= py <= ymax):
                    continue
            if self._window_reject(t_now, px, py, trust_gps=gps is not None):
                continue
            # reference noise model (driver :205-213): ADDITIVE scaling
            # 1 + distance + skew + pose_err*peScale, with the pose-error
            # term divided by 100 on the yaw row
            dist = float(np.linalg.norm(np.asarray(det.t).reshape(-1)))
            skew = 3.0 * float(np.hypot(proll, ppitch)) / 2.22
            pe = max(det.pose_err, 0.0)
            scale_xyz = 1.0 + dist + skew + cfg.pose_err_scale * pe
            scale_yaw = 1.0 + dist + skew + cfg.pose_err_scale * pe / 100.0
            for i, z in [(0, px), (1, py), (2, pz)]:
                h = np.zeros(8)
                h[i] = 1.0
                add(h, z, cfg.r_tag_xyz * scale_xyz)
            h = np.zeros(8)
            h[3] = 1.0
            add(h, unwrap(pyaw), cfg.r_tag_yaw * scale_yaw)
            self._window.append((t_now, px, py))
            accepted += 1

        H = np.stack(rows)
        z = np.asarray(meas, float)[:, None]
        R = np.diag(noise)
        x, P = kf_update(*self._on_device(self.x, self.P, z, H, R))
        self.x, self.P = x.cpu().numpy(), P.cpu().numpy()
        # wrap the state yaw every cycle (driver :226-230) so it can never
        # random-walk away from the wrapped measurement domain
        self.x[3, 0] = angle_wrap(self.x[3, 0], np.pi)
        return self.x.copy(), np.diag(self.P).copy()
