"""Typed configuration for ptudes-tpu.

The reference scatters tuning across click options, hard-coded constants and
kiss-icp's ``load_config`` (reference ``src/ptudes/kiss.py:40-43``,
``src/ptudes/ins/es_ekf.py:101-119``). Here everything is explicit, frozen
dataclasses: hashable, so they can be closed over by ``jax.jit`` as static
configuration, with static capacities that fix all device array shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KissConfig:
    """KISS-ICP odometry parameters.

    Defaults follow kiss-icp's ``load_config(None, deskew=True, max_range=R)``
    as invoked by the reference wrapper (``src/ptudes/kiss.py:40-43``):
    ``voxel_size`` defaults to ``max_range / 100``; the flagship CLI overrides
    min/max range to 1/70 m (``src/ptudes/cli/ekf_bench.py:356-363``).
    """
    max_range: float = 100.0
    min_range: float = 5.0
    deskew: bool = True
    voxel_size: float | None = None  # None -> max_range / 100
    max_points_per_voxel: int = 20
    # adaptive threshold (kiss-icp AdaptiveThreshold defaults)
    initial_threshold: float = 2.0
    min_motion_th: float = 0.1
    # registration: kiss-icp runs <=500 GN iterations with 1e-4 early stop;
    # here a capped loop with a convergence mask (SURVEY.md section 7)
    max_iterations: int = 50
    convergence_criterion: float = 1e-4
    # registration loss: "plane" (point-to-plane with per-voxel normal fits,
    # an improvement over the reference — stable on flat, ring-sampled
    # ground) or
    # "point" (kiss-icp parity point-to-point)
    loss: str = "plane"
    plane_min_quality: float = 0.2
    # patch radius (meters) for the per-point cross-voxel plane fit in
    # cached mode; None -> 1.5 * voxel_size
    plane_fit_radius: float | None = None
    approx_nn: bool = True
    # NN candidate strategy: "cached" gathers the top-``nn_voxels`` candidate
    # voxels (with plane fits) ONCE per scan and iterates densely (one
    # gather + K dense iterations); "every" re-queries
    # the hash map per iteration (kiss-icp behavior, gather-bound)
    nn_mode: str = "cached"
    nn_voxels: int = 4
    # cached mode: re-gather candidates when the pose drifts more than
    # this fraction of a voxel from the gather pose. 0 disables the
    # refresh entirely (no cond in the loop): with EKF-predicted guesses
    # the per-registration drift is millimeters, far inside the gathered
    # 7-neighborhood's +-1 voxel coverage
    nn_refresh_drift: float = 0.5
    # motion-prior regularization toward the initial guess (0 = kiss parity);
    # bounds sampling-noise random walk of the GN on self-similar geometry
    prior_rot_weight: float = 0.01
    prior_trans_weight: float = 0.01
    # NN search neighborhood: 27 (full cube, kiss parity), 7 (center +
    # faces; ~4x fewer gather rows, negligible quality impact for ICP),
    # or 4 (octant-directed: center + the 3 face neighbors on the
    # query's sub-voxel side: 4 meta rows/point instead of 7 at
    # near-identical recall)
    nn_neighborhood: int = 27
    # GN loop form for cached mode with frozen candidates: "auto" lets
    # ops.backend choose from the platform, "xla" forces the while_loop
    # around gn_from_candidates, "triton" the one-launch kernel
    # (ops.pallas_icp)
    gn_backend: str = "auto"
    # GN steps per while_loop body of the XLA loop: result-identical for
    # any factor (steps are convergence-masked); max_iterations gives a
    # fixed-count loop with no data-dependent predicate
    gn_unroll: int = 1

    @property
    def resolved_voxel_size(self) -> float:
        return self.max_range / 100.0 if self.voxel_size is None else self.voxel_size


@dataclass(frozen=True)
class Capacity:
    """Static shapes for the device pipeline.

    All dynamic-size structures of the reference (per-scan point counts,
    voxel map growth) become fixed-capacity arrays + validity masks so that
    XLA sees static shapes (SURVEY.md section 7, 'Hard parts').
    """
    max_points: int = 131072      # raw points per scan (H*W; 128x1024)
    max_frame: int = 32768        # downsampled frame (map insert) capacity
    max_source: int = 8192        # ICP source capacity
    map_capacity: int = 1 << 19   # voxel hash slots (power of two)
    max_probes: int = 2           # open-addressing probe length (keep load factor low)
    dedup_table: int = 1 << 20    # scratch table for voxel downsample
    # capacity of the compacted genuinely-new-points buffer in the
    # occupancy-deduped map insert; steady-state scene turnover per scan
    # (overflow is retried next scan, so only map build-up speed varies)
    max_new_per_scan: int = 8192


@dataclass(frozen=True)
class EkfConfig:
    """ES-EKF tuning, numerically identical to the reference constants
    (``src/ptudes/ins/es_ekf.py:101-119``, meas defaults ``:289-292``)."""
    init_pos_std: float = 10.0
    init_vel_std: float = 5.0
    init_att_rpy_deg: float = 10.0
    init_bg_std: float = 1.5
    init_ba_std: float = 0.5
    init_grav_std: float = 2.5
    acc_bias_std: float = 0.049
    gyr_bias_std: float = 0.38
    acc_vrw: float = 0.0043
    gyr_arw: float = 0.000466
    meas_pos_std: float = 0.02
    meas_att_std: float = 0.01
    # improvement over the reference: Joseph-form covariance update +
    # symmetrization for f32 stability (reference runs f64 numpy)
    joseph_form: bool = True
    # predict-block structure for esekf.process_imu_batch: "auto" lets
    # ops.backend choose from the platform; "assoc" runs the K per-scan
    # covariance updates as a log-depth associative scan of
    # transition-matrix products + ONE compound P update (f32
    # reassociation differences only, ~1e-3 absolute on cov entries of
    # magnitude ~100); "unroll" is the step-by-step chain, bit-matching K
    # sequential process_imu calls; "triton" is the one-launch kernel
    # (ops.pallas_ekf.predict_block). log=True always uses the unrolled
    # chain for the per-step history.
    predict_batch: str = "auto"


@dataclass(frozen=True)
class PipelineConfig:
    """Fused LIO pipeline (scan_step under lax.scan)."""
    kiss: KissConfig = dataclasses.field(default_factory=KissConfig)
    cap: Capacity = dataclasses.field(default_factory=Capacity)
    ekf: EkfConfig = dataclasses.field(default_factory=EkfConfig)
    max_imu_per_scan: int = 16     # reference interleaves ~10 IMU per scan
    guess: str = "kiss"            # 'kiss' | 'ekf' | 'gt' (ekf_bench.py:533-548)
    # deskew motion source: "ekf" integrates the sweep's own IMU block
    # (exact during accelerations; needs the fused pipeline), "kiss" is the
    # reference's const-velocity-from-previous-poses model
    deskew_mode: str = "ekf"
    # keep the first valid return of each group of N adjacent columns per
    # beam row before projection (ops.projection.scan_to_points): adjacent
    # columns are a few cm apart — far below the 0.5*voxel downsample —
    # so N=2 halves every full-width stage's cost for free; 1 disables
    col_decimation: int = 1
    # number of leading scans run with the full-overflow map insert
    # (whole frame lands in the map at once, as one wide chunk); -1 = all
    # scans (exact map semantics). The steady tail inserts at most
    # cap.max_new_per_scan new points per scan — decimated EVENLY over
    # the new set (ops.hashmap.insert_deduped), the rest retrying next
    # scan — which skips the overflow loop's carry boundary at
    # map-content parity (the earlier first-N truncation starved sweep
    # tails and cost ATE 0.0205 -> 0.0251; even decimation measures at
    # full-overflow parity on the bench scene)
    bootstrap_scans: int = 1
    # steady-tail insert mode (ops.hashmap.insert_deduped ``overflow``):
    # "cond" = exact chunked insert behind one lax.cond — scans whose new
    # points fit the budget pay only the untaken-branch boundary; False =
    # budget-capped even decimation with next-scan retry (fastest, map
    # may lag the frontier on high-turnover scenes)
    steady_insert_mode: bool | str = "cond"
    # lax.scan unroll factor for the steady tail: the scan's while-loop
    # boundary copies carry components XLA cannot alias in place
    # (dominated by the map table); unrolling pays that boundary once per ``scan_unroll`` scans. Results
    # are identical for any factor; compile time grows with the factor.
    scan_unroll: int = 1
    # localization-only mode (beyond the reference): register every scan
    # against a FIXED prior map — no inserts, no eviction; the carried
    # map is bit-identical in and out. Pair with a checkpointed map
    # (utils.checkpoint / CLI --resume-state --frozen-map) to relocalize
    # a new recording inside a previously built map.
    map_frozen: bool = False
