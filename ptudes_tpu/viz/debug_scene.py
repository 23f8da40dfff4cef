"""EKF debug scene export — the replacement for the reference's
3D debug viewer ``ekf_viz`` (``src/ptudes/ins/viz_utils.py:317-626``).

The reference renders, per EKF update knot: the scan frame, the
downsampled source, the NN correspondence pairs, the local map, the pose
axes, and a covariance visualization built by sampling 2000 points from
the position marginal and 100 axes from the attitude marginal
(``:506-523``), navigable by keyboard. OpenGL is out of scope, so this
module exports the same per-update scene as PLY clouds + a JSON index
keyed by update knot — loadable in CloudCompare/MeshLab/Open3D or any
notebook, with all the same content.

Scene layout (one set per exported knot k):

    scene.json                     index: knots, files, config
    knot_XXXX.json                 poses (pred/icp/ekf), sigma, iters, corr
    knot_XXXX_source.ply           deskewed source at the registered pose
    knot_XXXX_target.ply           matched NN map points (correspondences)
    knot_XXXX_cov_pos.ply          2000 samples ~ N(pos, P_pos)
    knot_XXXX_cov_att.ply          100 rotated axis triads from P_att
    knot_XXXX_map.ply              local map snapshot
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..geom import se3
from ..models import esekf, lio
from ..ops import icp
from ..ops.projection import scan_to_points
from .cloud import map_to_points, save_ply

POS, PHI = 0, 6  # error-state block offsets (esekf.POS / esekf.PHI)


def _pose_list(p) -> list:
    return np.asarray(p, np.float64).reshape(4, 4).tolist()


def sample_covariance(
    pos: np.ndarray, cov: np.ndarray, quat_mat: np.ndarray,
    n_pos: int = 2000, n_att: int = 100, axis_len: float = 0.5,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Covariance visualization clouds, reference ``:506-523`` semantics:
    ``n_pos`` samples from the position marginal and ``n_att`` rotated axis
    triads (3 points each, xyz-colored by the caller) from the attitude
    marginal applied to the current rotation."""
    rng = np.random.default_rng(seed)
    p_pos = cov[POS:POS + 3, POS:POS + 3]
    p_att = cov[PHI:PHI + 3, PHI:PHI + 3]
    # guard f32 asymmetry / tiny negatives
    p_pos = 0.5 * (p_pos + p_pos.T) + 1e-12 * np.eye(3)
    p_att = 0.5 * (p_att + p_att.T) + 1e-12 * np.eye(3)
    pos_cloud = rng.multivariate_normal(pos, p_pos, size=n_pos).astype(
        np.float32)

    rvecs = rng.multivariate_normal(np.zeros(3), p_att, size=n_att)
    from scipy.spatial.transform import Rotation as R
    rots = R.from_rotvec(rvecs).as_matrix() @ quat_mat[None]
    axes = (rots * axis_len).transpose(0, 2, 1) + pos[None, None, :]
    return pos_cloud, axes.reshape(-1, 3).astype(np.float32)


def export_debug_scenes(
    out_dir: str,
    cfg,
    lut,
    batches: lio.ScanBatch,
    *,
    stride: int = 1,
    map_stride: int = 10,
    n_pos_samples: int = 2000,
    n_att_samples: int = 100,
    init_state: lio.LioState | None = None,
) -> dict:
    """Run the fused pipeline scan by scan and export per-update scenes.

    A debugging tool (the reference's viewer is interactive): the host
    drives ``scan_step`` one scan at a time so the intermediate state
    (full covariance, local map, correspondences at the refined pose) is
    observable between steps.
    """
    import jax
    import jax.numpy as jnp

    os.makedirs(out_dir, exist_ok=True)
    step = jax.jit(lio.make_scan_step(lut, cfg))
    state = lio.init_state(cfg) if init_state is None else init_state
    kcfg, cap = cfg.kiss, cfg.cap
    vs = kcfg.resolved_voxel_size

    n = batches.range_m.shape[0]
    knots = []
    for i in range(n):
        batch = jax.tree.map(lambda x: x[i], batches)
        pred_pose = esekf.pose_mat(
            esekf.process_imu_batch(state.ekf, batch.imu, batch.imu_valid,
                                    cfg=cfg.ekf))
        prev_state = state
        state, out = step(state, batch)

        if i % stride:
            continue

        icp_pose = np.asarray(out.kiss_pose, np.float64)
        ekf_pose = np.asarray(out.ekf_pose, np.float64)

        # recompute the final correspondences at the refined pose against
        # the pre-update map (what the last GN iteration saw)
        pts, mask, ts01 = scan_to_points(lut, batch.range_m)
        from ..ops import deskew as deskew_ops
        from ..ops import voxel
        if kcfg.deskew:
            twist = se3.log_pose(
                se3.inv(esekf.pose_mat(prev_state.ekf)) @ jnp.asarray(
                    pred_pose, jnp.float32))
            pts = deskew_ops.deskew_by_twist(pts, ts01 - 0.5, twist)
        mask = voxel.range_clip_mask(pts, mask, kcfg.min_range,
                                     kcfg.max_range)
        keep_f = voxel.first_in_voxel_mask(pts, mask, vs * 0.5,
                                           cap.dedup_table)
        frame_ds, frame_mask = voxel.compact(pts, keep_f, cap.max_frame)
        keep_s = voxel.first_in_voxel_mask(frame_ds, frame_mask, vs * 1.5,
                                           cap.dedup_table)
        source, source_mask = voxel.compact(frame_ds, keep_s, cap.max_source)
        src_w = se3.transform(jnp.asarray(icp_pose, jnp.float32), source)
        cand = icp.gather_candidates(
            prev_state.kiss.local_map, src_w, voxel_size=vs,
            max_probes=cap.max_probes, neighborhood=kcfg.nn_neighborhood,
            n_voxels=kcfg.nn_voxels, fit_planes=False)
        d2 = jnp.sum((cand.pts - src_w[:, None, :]) ** 2, axis=-1)
        d2 = d2 + jnp.where(cand.valid, 0.0, jnp.inf)
        kbest = jnp.argmin(d2, axis=-1)
        nn = jnp.take_along_axis(cand.pts, kbest[:, None, None], 1)[:, 0]
        d2min = jnp.take_along_axis(d2, kbest[:, None], 1)[:, 0]
        sigma = float(out.aux.sigma)
        corr = np.asarray(source_mask & jnp.isfinite(d2min)
                          & (d2min <= (3.0 * sigma) ** 2))

        src_np = np.asarray(src_w)[corr]
        nn_np = np.asarray(nn)[corr]
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_source.ply"), src_np)
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_target.ply"), nn_np)

        cov = np.asarray(state.ekf.cov, np.float64)
        from ..geom import so3
        rmat = np.asarray(so3.quat_to_mat(state.ekf.quat), np.float64)
        pos_cloud, att_axes = sample_covariance(
            ekf_pose[:3, 3], cov, rmat, n_pos=n_pos_samples,
            n_att=n_att_samples, seed=i)
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_cov_pos.ply"),
                 pos_cloud)
        save_ply(os.path.join(out_dir, f"knot_{i:04d}_cov_att.ply"),
                 att_axes)

        if i % map_stride == 0:
            save_ply(os.path.join(out_dir, f"knot_{i:04d}_map.ply"),
                     map_to_points(state.kiss.local_map,
                                   cfg.kiss.resolved_voxel_size))

        meta = {
            "knot": i,
            "pred_pose": _pose_list(pred_pose),
            "icp_pose": _pose_list(icp_pose),
            "ekf_pose": _pose_list(ekf_pose),
            "sigma": sigma,
            "iterations": int(out.aux.iterations),
            "num_corr": int(np.sum(corr)),
            "cov_diag": np.asarray(out.ekf_cov_diag, np.float64).tolist(),
            "scan_valid": bool(out.scan_valid),
        }
        with open(os.path.join(out_dir, f"knot_{i:04d}.json"), "w") as f:
            json.dump(meta, f, indent=1)
        knots.append(i)

    index = {
        "knots": knots,
        "stride": stride,
        "map_stride": map_stride,
        "n_pos_samples": n_pos_samples,
        "n_att_samples": n_att_samples,
        "files": {
            "poses": "knot_XXXX.json",
            "source": "knot_XXXX_source.ply",
            "target": "knot_XXXX_target.ply",
            "cov_pos": "knot_XXXX_cov_pos.ply",
            "cov_att": "knot_XXXX_cov_att.ply",
            "map": f"knot_XXXX_map.ply (every {map_stride})",
        },
    }
    with open(os.path.join(out_dir, "scene.json"), "w") as f:
        json.dump(index, f, indent=1)
    return index
