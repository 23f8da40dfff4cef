"""Raw-stream WebGL player contract tests (headless).

Validates the export half of the live viewer (``ptudes-tpu viz --serve``
/ ``tools/view_stream.py``) — the reference plays streams live through
SimpleViz (``src/ptudes/cli/viz.py:49-62``); here the player re-projects
frames on the GPU from exported (range, direction, offset) textures, so
the binding contract is: blob sizes/dtypes match stream.json, and the
destaggered export still reproduces the exact projection point set
(the same per-row roll is applied to ranges AND the LUT).
"""
import json
import os

import numpy as np
import jax.numpy as jnp


from ptudes_tpu.io.sources import ScanSequence
from ptudes_tpu.ops import projection
from ptudes_tpu.viz.stream_player import RANGE_UNIT_M, export_stream

from test_io import make_info


def _make_scans(info, n=3, with_fields=True, seed=0):
    rng = np.random.default_rng(seed)
    h, w = info.h, info.w
    range_mm = rng.integers(0, 50000, (n, h, w)).astype(np.uint32)
    range_mm[:, :, :3] = 0  # some no-return pixels
    fields = None
    if with_fields:
        fields = {
            "reflectivity": rng.integers(0, 255, (n, h, w)).astype(np.uint16),
            "signal": rng.integers(0, 4000, (n, h, w)).astype(np.uint16),
        }
    ts = 1.5 + np.arange(n) * 0.1
    return ScanSequence(
        range_mm=range_mm,
        col_ts=np.zeros((n, w), np.uint64),
        valid_cols=np.ones((n, w), bool),
        ts=ts,
        fields=fields,
    )


def test_export_contract(tmp_path):
    import dataclasses
    info = dataclasses.replace(
        make_info(),
        pixel_shift_by_row=list(np.arange(32) % 7))
    scans = _make_scans(info)
    d = str(tmp_path)
    out = export_stream(d, info, scans)
    assert os.path.basename(out) == "viewer_stream.html"
    html = open(out).read()
    for s in ("stream.json", "ranges.bin", "dirs.bin", "offs.bin",
              "webgl2", "texelFetch", "gl_VertexID"):
        assert s in html

    meta = json.load(open(os.path.join(d, "stream.json")))
    h, w, n = meta["h"], meta["w"], meta["n"]
    assert (h, w, n) == (info.h, info.w, len(scans))
    assert meta["range_unit_m"] == RANGE_UNIT_M
    assert meta["fields"] == ["reflectivity", "signal"]
    assert len(meta["scan_ts"]) == n and meta["scan_ts"][0] == 0.0

    rng = np.fromfile(os.path.join(d, "ranges.bin"), np.uint16)
    assert rng.size == n * h * w
    for f in meta["fields"]:
        fb = np.fromfile(os.path.join(d, f"f_{f}.bin"), np.uint16)
        assert fb.size == n * h * w
        assert meta["field_max"][f] >= fb.max()
    dirs = np.fromfile(os.path.join(d, "dirs.bin"), "<f4")
    offs = np.fromfile(os.path.join(d, "offs.bin"), "<f4")
    assert dirs.size == h * w * 4 and offs.size == h * w * 4  # RGBA pad


def test_destaggered_projection_matches(tmp_path):
    """dir*r + off over the DESTAGGERED export must reproduce the exact
    point set of the staggered-range projection: the roll permutes
    (range, dir, off) triplets together, never mixes them."""
    import dataclasses
    info = make_info()
    info = dataclasses.replace(
        info, pixel_shift_by_row=list((np.arange(info.h) * 3) % info.w))
    scans = _make_scans(info, n=1, with_fields=False)
    d = str(tmp_path)
    export_stream(d, info, scans)

    h, w = info.h, info.w
    rng = np.fromfile(os.path.join(d, "ranges.bin"),
                      np.uint16).reshape(h, w).astype(np.float64)
    dirs = np.fromfile(os.path.join(d, "dirs.bin"),
                       "<f4").reshape(h, w, 4)[..., :3]
    offs = np.fromfile(os.path.join(d, "offs.bin"),
                       "<f4").reshape(h, w, 4)[..., :3]
    pts_gpu = dirs * (rng * RANGE_UNIT_M)[..., None] + offs

    lut = projection.make_xyz_lut(
        w, h, info.beam_altitude_angles, info.beam_azimuth_angles,
        info.lidar_origin_to_beam_origin_mm,
        info.lidar_to_sensor_transform)
    # quantize to the u16 export grid EXACTLY as the export does (odd-mm
    # values are .5 ties whose rounding direction must match)
    range_q = np.clip(np.round(
        scans.range_mm[0].astype(np.float64) * (0.001 / RANGE_UNIT_M)),
        0, 65535) * RANGE_UNIT_M
    pts_ref = np.asarray(projection.project(
        lut, jnp.asarray(range_q, jnp.float32)))

    # per-row: the export is a roll of the reference row
    shifts = np.asarray(info.pixel_shift_by_row)
    for r in range(h):
        rolled = np.roll(pts_ref[r], shifts[r] % w, axis=0)
        np.testing.assert_allclose(pts_gpu[r], rolled, atol=1e-4)


def test_cli_stream_export(tmp_path):
    """`ptudes-tpu viz --stream-dir` exports the player from a pcap."""
    import sys

    from ptudes_tpu.cli.main import main
    from ptudes_tpu.io import pcap as pcap_io

    from test_io import synth_frames

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    from make_fixture import info_to_json

    info = make_info()
    payloads, _ = synth_frames(info, n_frames=2)
    path = str(tmp_path / "s.pcap")
    pcap_io.write_pcap_udp(path, payloads)
    mpath = str(tmp_path / "s.json")
    with open(mpath, "w") as f:
        f.write(info_to_json(info))
    d = str(tmp_path / "stream")
    assert main(["viz", path, "-m", mpath, "--stream-dir", d,
                 "--rate", "0"]) == 0
    assert os.path.isfile(os.path.join(d, "viewer_stream.html"))
    assert os.path.isfile(os.path.join(d, "ranges.bin"))
    # -r seeds the player's initial rate (0 = start paused, the
    # reference's ptudes viz -r convention, src/ptudes/cli/viz.py:24-29)
    meta = json.load(open(os.path.join(d, "stream.json")))
    assert meta["rate"] == 0.0

    # --max-scans bounds the export for huge recordings
    d2 = str(tmp_path / "stream2")
    assert main(["viz", path, "-m", mpath, "--stream-dir", d2,
                 "--max-scans", "1"]) == 0
    meta2 = json.load(open(os.path.join(d2, "stream.json")))
    assert meta2["n"] == 1 and len(meta2["scan_ts"]) == 1


def test_export_short_shift_list(tmp_path):
    """SensorInfo built directly (empty pixel_shift_by_row, the
    dataclass default) must export with zero shifts, not crash."""
    import dataclasses
    info = dataclasses.replace(make_info(), pixel_shift_by_row=[])
    scans = _make_scans(info, n=1, with_fields=False)
    out = export_stream(str(tmp_path), info, scans)
    assert os.path.isfile(out)
