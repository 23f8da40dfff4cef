"""Whole-loop fused ICP kernel (ops.pallas_icp, Triton route) parity vs
the XLA loop, plus the wrapper's padding and the XLA loop's unroll rule.

The kernel runs in the Pallas interpreter here; the compiled kernel is
compared with the XLA loop on the card by chip_smoke.py."""
import numpy as np
import jax.numpy as jnp
import pytest

from ptudes_tpu.geom import se3, so3
from ptudes_tpu.ops import hashmap, icp, pallas_icp, voxel

KERNEL = jnp.asarray(0.1667, jnp.float32)
MAX_D = jnp.asarray(0.5, jnp.float32)


def _setup(seed=5, n=2048):
    rng = np.random.default_rng(seed)
    m = hashmap.create(1 << 14, 8)
    # structured world (planes) so the plane branch actually engages
    half = 20000
    floor = np.stack([rng.uniform(-15, 15, half),
                      rng.uniform(-15, 15, half),
                      rng.uniform(-0.02, 0.02, half)], -1)
    wall = np.stack([rng.uniform(-15, 15, half),
                     np.full(half, 8.0) + rng.uniform(-0.02, 0.02, half),
                     rng.uniform(0, 4, half)], -1)
    pts = np.vstack([floor, wall]).astype(np.float32)
    keep = voxel.first_in_voxel_mask(
        jnp.asarray(pts), jnp.ones(len(pts), bool), 0.15, 1 << 17)
    m = hashmap.insert_deduped(m, jnp.asarray(pts), keep, voxel_size=0.3,
                               max_probes=2, new_capacity=8192)
    idx = rng.choice(len(pts), n, replace=False)
    src = pts[idx] + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    mask = jnp.asarray(rng.uniform(size=n) < 0.95)
    tw = np.array([0.004, -0.003, 0.006, 0.05, -0.04, 0.03], np.float32)
    guess = np.asarray(se3.exp_twist(jnp.asarray(tw)), np.float32)
    return m, jnp.asarray(src.astype(np.float32)), mask, jnp.asarray(guess)


def _run(backend, m, src, mask, guess, loss, priors=(0.01, 0.01),
         n_voxels=4, gn_unroll=1):
    kw = dict(plane_min_quality=0.2, max_iterations=30,
              prior_rot_weight=priors[0], prior_trans_weight=priors[1])
    if backend == "triton":
        cand = icp.gather_candidates(
            m, se3.transform(guess, src), voxel_size=0.3, max_probes=2,
            neighborhood=7, n_voxels=n_voxels,
            fit_planes=(loss == "plane"), plane_radius=0.6)
        pose, n_corr, iters, dev_t, dev_r = pallas_icp.icp_loop(
            src, mask, cand, guess, KERNEL, MAX_D * MAX_D, 1e-5,
            loss=loss, interpret=True, **kw)
        return icp.IcpResult(pose=pose, num_corr=n_corr, iterations=iters,
                             dev_t=dev_t, dev_r=dev_r)
    return icp.register_frame_cached(
        src, mask, m, guess, MAX_D, KERNEL,
        voxel_size=0.3, max_probes=2, convergence=1e-5, loss=loss,
        neighborhood=7, n_voxels=n_voxels, plane_radius=0.6,
        gn_backend="xla", refresh_drift=0.0, gn_unroll=gn_unroll, **kw)


def _assert_close(r_ref, r_k, what):
    d = np.asarray(se3.log_pose(se3.inv(r_ref.pose) @ r_k.pose))
    assert np.linalg.norm(d) < 5e-4, (what, d)
    # same correspondence regime and a similar iteration count
    assert abs(int(r_ref.num_corr) - int(r_k.num_corr)) <= \
        max(3, int(0.01 * int(r_ref.num_corr))), what
    assert abs(int(r_ref.iterations) - int(r_k.iterations)) <= 2, what


def test_fused_loop_matches_xla_loop():
    m, src, mask, guess = _setup()
    for loss in ["plane", "point"]:
        for priors in [(0.01, 0.01), (0.0, 0.0)]:
            r_ref = _run("xla", m, src, mask, guess, loss, priors)
            r_k = _run("triton", m, src, mask, guess, loss, priors)
            _assert_close(r_ref, r_k, (loss, priors))
            # the epilogue's model deviation is the XLA chain's
            dev = se3.inv(guess) @ r_k.pose
            np.testing.assert_allclose(
                float(r_k.dev_t), float(jnp.linalg.norm(se3.trans(dev))),
                atol=1e-5)
            np.testing.assert_allclose(
                float(r_k.dev_r),
                float(jnp.linalg.norm(so3.log_rotmat(se3.rot(dev)))),
                atol=2e-5)


def test_fused_loop_converges_to_truth():
    m, src, mask, guess = _setup()
    res = _run("triton", m, src, mask, guess, "plane")
    # src points were drawn from the map (plus 1 cm noise): the solution
    # is identity
    d = np.asarray(se3.log_pose(res.pose))
    assert np.linalg.norm(d) < 0.02
    assert int(res.iterations) < 30


def test_fused_loop_empty_map_returns_guess():
    m, src, mask, guess = _setup()
    empty = hashmap.create(1 << 14, 8)
    res = _run("triton", empty, src, mask, guess, "plane", priors=(0.0, 0.0))
    # Tikhonov-floored solve on zero correspondences -> dx = 0 -> the
    # initial guess comes back after one masked iteration (kiss parity:
    # first frame registers at the guess)
    np.testing.assert_allclose(np.asarray(res.pose), np.asarray(guess),
                               atol=1e-6)
    assert int(res.num_corr) == 0


def test_fused_loop_pads_points_and_candidates():
    """A source count that is not a whole number of chunks and a
    candidate width that is not a power of two (3 voxels x 8 points) are
    padded by the wrapper without changing the solve."""
    m, src, mask, guess = _setup(seed=11, n=1000)
    r_ref = _run("xla", m, src, mask, guess, "plane", n_voxels=3)
    r_k = _run("triton", m, src, mask, guess, "plane", n_voxels=3)
    _assert_close(r_ref, r_k, "padded")


def test_kernel_inputs_padding_shapes():
    m, src, mask, guess = _setup(seed=3, n=1000)
    cand = icp.gather_candidates(
        m, se3.transform(guess, src), voxel_size=0.3, max_probes=2,
        neighborhood=7, n_voxels=3, fit_planes=True, plane_radius=0.6)
    chunk = pallas_icp.chunk_rows(cand.valid.shape[1])
    assert chunk == 64
    rows, cx, cy, cz, inf = pallas_icp.kernel_inputs(
        src, mask, cand, "plane", chunk)
    assert rows.shape == (16, 1024) and cx.shape == (1024, 32)
    # padded points are masked out, padded candidates are invalid
    assert not np.asarray(rows[10, 1000:]).any()
    assert (np.asarray(inf[:, 24:]) >= 1e29).all()
    assert (np.asarray(inf[1000:]) >= 1e29).all()
    np.testing.assert_array_equal(np.asarray(rows[:3, :1000]).T,
                                  np.asarray(src))


@pytest.mark.parametrize("loss", ["plane", "point"])
def test_xla_loop_unroll_is_result_identical(loss):
    """gn_unroll only changes how often the while predicate is checked:
    every step is convergence- and cap-masked, so 1, 4 and the
    fixed-count loop (max_iterations) give identical results."""
    m, src, mask, guess = _setup(seed=8)
    runs = [_run("xla", m, src, mask, guess, loss, gn_unroll=u)
            for u in (1, 4, 30)]
    for r in runs[1:]:
        np.testing.assert_array_equal(np.asarray(r.pose),
                                      np.asarray(runs[0].pose))
        assert int(r.iterations) == int(runs[0].iterations)
        assert int(r.num_corr) == int(runs[0].num_corr)


def test_fused_loop_under_vmap():
    """The bag-replay and replica drivers vmap the scan step: the kernel
    batches to one program per element with per-element results."""
    import jax
    m, src, mask, guess = _setup(seed=13, n=512)
    tw = jnp.asarray([0.0, 0.002, -0.004, 0.03, 0.0, -0.02], jnp.float32)
    guesses = jnp.stack([guess, se3.exp_twist(tw) @ guess])

    def one(g):
        return _run("triton", m, src, mask, g, "plane").pose

    batched = jax.vmap(one)(guesses)
    for b in range(2):
        np.testing.assert_allclose(np.asarray(batched[b]),
                                   np.asarray(one(guesses[b])), atol=1e-6)
