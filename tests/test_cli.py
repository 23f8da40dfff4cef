"""CLI smoke tests: every `ptudes-tpu` command end-to-end on a tiny
real-format fixture (LEGACY pcap + metadata JSON + NC ground-truth csv).

The CLI (ptudes_tpu/cli/main.py) mirrors the reference's command surface
(`ptudes stat|viz|flyby|ekf-bench {sim,nc,ouster,sweep,cmp}`, reference
src/ptudes/cli/run.py); these tests pin the user-facing contract — exit
codes, artifact files, the argument defaults, and the right-sizing
capacity flags — through the in-process ``main(argv)`` with small
capacities so CPU runtime stays bounded.
"""
import contextlib
import inspect
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from ptudes_tpu.cli import main as cli

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

N_SCANS, H, W = 8, 16, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_fixture import generate
    d = tmp_path_factory.mktemp("clifix")
    pcap, meta, gt = generate(str(d), n_scans=N_SCANS, h=H, w=W, seed=7)
    return d, pcap, meta, gt


SMALL_CAPS = ["--map-capacity", str(1 << 14), "--max-source", "2048",
              "--max-frame", "4096", "--voxel-size", "0.4",
              "--kiss-max-range", "60"]


def _invoke(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def _run(args):
    rc, out = _invoke(args)
    assert rc == 0, out
    return out


def test_stat(fixture_dir):
    d, pcap, meta, gt = fixture_dir
    out = _run(["stat", pcap, "-m", meta])
    assert "scans: 8" in out and "grav vector est" in out.lower()


def test_stat_scan_window(fixture_dir):
    """--start-scan/--end-scan windowing (reference
    src/ptudes/cli/stat.py:29-30): stats run over the selected scans
    and their interleaved IMU samples only."""
    d, pcap, meta, gt = fixture_dir
    out = _run(["stat", pcap, "-m", meta,
                "--start-scan", "2", "--end-scan", "5"])
    assert "scans: 4" in out
    # out-of-range window fails loudly, not silently empty
    rc, out = _invoke(["stat", pcap, "-m", meta, "--start-scan", "99"])
    assert rc != 0 and "selects no scans" in out


@pytest.mark.slow
def test_ekf_bench_ouster_flagship(fixture_dir):
    d, pcap, meta, gt = fixture_dir
    poses = str(d / "out_poses.txt")
    out = _run(["ekf-bench", "ouster", pcap, "-m", meta,
                "--use-imu-prediction", "-g", gt,
                "--save-kitti-poses", poses] + SMALL_CAPS)
    assert os.path.isfile(poses)
    k = np.loadtxt(poses)
    assert k.shape == (N_SCANS, 12) and np.isfinite(k).all()
    assert "ATE" in out


@pytest.mark.slow
def test_ekf_bench_ouster_online(fixture_dir):
    d, pcap, meta, gt = fixture_dir
    out = _run(["ekf-bench", "ouster", pcap, "-m", meta,
                "--use-imu-prediction", "--online"] + SMALL_CAPS)
    assert "latency" in out and "p99" in out


def test_ekf_bench_cmp(fixture_dir):
    d, pcap, meta, gt = fixture_dir
    nc_poses = str(d / "out_nc.csv")
    _run(["ekf-bench", "ouster", pcap, "-m", meta, "--use-imu-prediction",
          "--save-nc-gt-poses", nc_poses] + SMALL_CAPS)
    out = _run(["ekf-bench", "cmp", nc_poses, gt])
    assert "ATE" in out


def test_flyby_and_player(fixture_dir):
    d, pcap, meta, gt = fixture_dir
    poses = str(d / "out_poses.txt")
    if not os.path.isfile(poses):
        _run(["ekf-bench", "ouster", pcap, "-m", meta,
              "--use-imu-prediction", "--save-kitti-poses", poses]
             + SMALL_CAPS)
    ply = str(d / "fly_map.ply")
    cam = str(d / "cam.json")
    out = _run(["flyby", pcap, "-m", meta, "--kitti-poses", poses,
                "-o", ply, "--camera-json", cam])
    assert os.path.isfile(ply) and os.path.isfile(cam)
    assert "flyby duration" in out


def test_viz_frames(fixture_dir):
    d, pcap, meta, gt = fixture_dir
    frames = d / "frames"
    _run(["viz", pcap, "-m", meta, "--out-dir", str(frames),
          "--stride", "4"])
    assert any(f.suffix == ".png" for f in frames.iterdir())


def test_ekf_bench_sim():
    out = _run(["ekf-bench", "sim", "--duration", "2.0", "--corr-t", "0.5"])
    assert "ATE" in out


def test_frozen_map_requires_resume_state(tmp_path):
    """--frozen-map without a prior map checkpoint is rejected upfront."""
    rc, out = _invoke(["ekf-bench", "ouster", __file__, "--frozen-map"])
    assert rc != 0
    assert "resume-state" in out


# the defaults of the click CLI this one replaced, per command
_CLICK_DEFAULTS = {
    ("stat",): dict(meta=None, duration=0.0, beams=32, kiss_run=False,
                    start_scan=0, end_scan=None),
    ("ekf-bench", "sim"): dict(duration=2.0, freq=100.0, corr_t=0.1,
                               acc_noise_std=0.4, gyr_noise_std=0.4,
                               seed=42, plot=None),
    ("ekf-bench", "nc"): dict(duration=0.0, start_ts=0.0,
                              imu_topic="/os_node/imu_packets", plot=None,
                              xy_plot=False),
    ("ekf-bench", "ouster"): dict(
        meta=None, start_scan=0, end_scan=None, use_imu_prediction=False,
        use_gt_guess=False, gt_file=None, kiss_min_range=1.0,
        kiss_max_range=70.0, beams=0, loss="plane", save_kitti_poses=None,
        save_nc_gt_poses=None, save_map_ply=None, save_debug_scene=None,
        debug_scene_stride=5, save_state=None, resume_state=None,
        frozen_map=False, online=False, rate=0.0, voxel_size=None,
        map_capacity=None, max_source=None, max_frame=None, plot=None),
    ("ekf-bench", "sweep"): dict(
        meta=None, start_scan=0, end_scan=None, gt_file=None,
        kiss_min_range=1.0, kiss_max_range=70.0, loss="plane", beams=None,
        bacc_z=None, replicas=None),
    ("ekf-bench", "cmp"): dict(gt_file_cmp=[], plot=None,
                               use_gt_frame=False, xy_plot=False),
    ("flyby",): dict(meta=None, kitti_poses=None, nc_gt_poses=None,
                     start_scan=0, end_scan=None, out_ply="flyby_map.ply",
                     camera_json=None, map_points=1_500_000),
    ("viz",): dict(meta=None, scan_idx=0, out_png=None, out_dir=None,
                   stride=1, field_name="range", serve=False,
                   stream_dir=None, port=8126, rate=1.0, max_scans=None),
}


@pytest.mark.parametrize("command", sorted(_CLICK_DEFAULTS),
                         ids=lambda c: " ".join(c))
def test_command_parses_with_click_defaults(command):
    """Every command parses its minimal argv; the defaults are the old
    click CLI's and the parsed names are exactly the handler's
    parameters (main dispatches them as keywords)."""
    positional = {("ekf-bench", "sim"): [],
                  ("ekf-bench", "nc"): [__file__, "-g", __file__]}
    argv = list(command) + positional.get(command, [__file__])
    args = vars(cli.build_parser().parse_args(argv))
    func = args.pop("func")
    args.pop("command")
    args.pop("ekf_command", None)
    assert set(args) == set(inspect.signature(func).parameters)
    for k, v in _CLICK_DEFAULTS[command].items():
        assert args[k] == v, (k, args[k], v)


def test_missing_path_is_rejected():
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(["stat", "/nonexistent/x.pcap"])
    assert e.value.code == 2


def test_main_path_imports_without_optional_packages():
    """The CLI, the batch and live pipelines and chip_smoke.py import
    with click, tqdm and matplotlib absent (the card's machine is only
    sure to have numpy, scipy, optax, chex, einops, pytest, hypothesis
    beside JAX)."""
    code = (
        "import sys\n"
        "for m in ('click', 'tqdm', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import ptudes_tpu.cli.main, ptudes_tpu.models.lio\n"
        "import ptudes_tpu.models.online\n"
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('cs', "
        f"{os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('IMPORTS_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0 and "IMPORTS_OK" in r.stdout, r.stderr
