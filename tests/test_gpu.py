"""Compiled kernels on the card against their plain XLA forms.

Marked ``gpu``: they skip without a card (the interpret-mode parity tests
in test_pallas_icp.py / test_esekf.py cover the kernels' arithmetic on
the CPU) and run on the card through ``python chip_smoke.py``."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ptudes_tpu.config import EkfConfig
from ptudes_tpu.geom import se3
from ptudes_tpu.models import esekf, sim
from ptudes_tpu.ops import backend, icp

from test_pallas_icp import _setup

pytestmark = pytest.mark.gpu


def test_backend_picks_kernels_on_the_card(gpu):
    assert backend.choose("gn_loop") == "triton"
    assert backend.choose("ekf_predict") == "triton"


def test_compiled_gn_loop_matches_xla(gpu):
    m, src, mask, guess = _setup(n=1024)
    kw = dict(voxel_size=0.3, max_probes=2, max_iterations=30,
              convergence=1e-5, loss="plane", prior_rot_weight=0.01,
              prior_trans_weight=0.01, neighborhood=7, n_voxels=4,
              plane_radius=0.6, refresh_drift=0.0)
    args = (src, mask, m, guess, jnp.float32(0.5), jnp.float32(0.1667))
    r_x = icp.register_frame_cached(*args, gn_backend="xla", **kw)
    r_k = icp.register_frame_cached(*args, gn_backend="triton", **kw)
    d = np.asarray(se3.log_pose(se3.inv(r_x.pose) @ r_k.pose))
    assert np.linalg.norm(d) < 5e-4
    assert abs(int(r_x.iterations) - int(r_k.iterations)) <= 2


def test_compiled_ekf_predict_matches_xla(gpu):
    _, noisy = sim.sim_imu_arrays(7, 16)
    valid = jnp.arange(16) < 13
    s0 = esekf.init_state(EkfConfig())
    forms = {}
    for form in ("unroll", "triton"):
        cfg = EkfConfig(predict_batch=form)
        s, tw = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg,
                                        want_twist=True)
        forms[form] = jax.tree.map(np.asarray, (s, tw))
    (su, twu), (sk, twk) = forms["unroll"], forms["triton"]
    np.testing.assert_allclose(sk.pos, su.pos, atol=1e-5)
    np.testing.assert_allclose(sk.cov, su.cov, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(twk, twu, atol=2e-5)

