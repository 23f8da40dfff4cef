"""Data sources: pcap / ROS bag -> dense scan + IMU arrays.

Re-design of the reference's streaming layer
(``OusterRawBagSource``/``IMUBagSource`` in ``src/ptudes/bag.py`` and
``OusterLidarData.withScanIdx`` in ``src/ptudes/data.py:31-77``): instead
of yielding one packet/scan at a time through pybind11 objects, a whole
recording is decoded into dense numpy arrays once (vectorized) and the
device pipeline consumes contiguous slices — the host->device feed
pattern that keeps the accelerator busy (SURVEY.md section 7, 'Hard
parts').

Scan assembly (the C++ ``ScanBatcher`` equivalent) is a scatter by
(frame index, measurement id); partial last frames are kept, matching the
reference's yield-partial behavior (``src/ptudes/data.py:53-56``).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import GRAV
from . import packets as pkt
from . import pcap as pcap_io
from . import rosbag as bag_io
from . import rosbag2 as bag2_io
from .metadata import SensorInfo


@dataclass
class ScanSequence:
    """Dense stack of assembled lidar scans (staggered column order)."""
    range_mm: np.ndarray    # [N, H, W] uint32 (0 = no return)
    col_ts: np.ndarray      # [N, W] uint64 ns (sensor clock; 0 = missing)
    valid_cols: np.ndarray  # [N, W] bool
    ts: np.ndarray          # [N] f64 s — last valid column ts (reference
    #                         uses last_valid_column_ts, kiss.py:65)
    # extra channels ([N, H, W] each: reflectivity/signal/nearir, plus
    # range2/reflectivity2/signal2 on dual-return profiles), retained only
    # when requested — the odometry path needs range alone (reference gets
    # every field from ouster-sdk's LidarScan, ``src/ptudes/data.py:44-62``)
    fields: dict[str, np.ndarray] | None = None

    def __len__(self) -> int:
        return self.range_mm.shape[0]

    def window(self, start_scan: int = 0, end_scan: int | None = None):
        """start/end-scan windowing (reference ``withScanIdx`` args,
        ``src/ptudes/data.py:31-36``; end inclusive)."""
        sl = slice(start_scan, None if end_scan is None else end_scan + 1)
        fields = (None if self.fields is None
                  else {k: v[sl] for k, v in self.fields.items()})
        return ScanSequence(self.range_mm[sl], self.col_ts[sl],
                            self.valid_cols[sl], self.ts[sl], fields)


@dataclass
class ImuSequence:
    """IMU samples in SI units (reference ``IMU.from_packet`` conversions:
    g -> m/s^2 via GRAV, deg/s -> rad/s; ``src/ptudes/ins/data.py:24-26``)."""
    lacc: np.ndarray  # [M, 3] m/s^2
    avel: np.ndarray  # [M, 3] rad/s
    ts: np.ndarray    # [M] f64 s

    def __len__(self) -> int:
        return self.lacc.shape[0]

    def rotated(self, rot: np.ndarray) -> "ImuSequence":
        """Apply an intrinsic rotation (reference ``_intr_rot``,
        ``src/ptudes/ins/data.py:27-29``)."""
        return ImuSequence(self.lacc @ rot.T, self.avel @ rot.T, self.ts)


def imu_from_raw(sys_ts_ns, accel_g, avel_deg) -> ImuSequence:
    return ImuSequence(
        lacc=np.asarray(accel_g, np.float64) * GRAV,
        avel=np.asarray(avel_deg, np.float64) * (np.pi / 180.0),
        ts=np.asarray(sys_ts_ns, np.float64) * 1e-9,
    )


def assemble_scans(info: SensorInfo, cols: pkt.ParsedColumns,
                   keep_fields: bool = False) -> ScanSequence:
    """Group parsed columns into dense [H, W] frames keyed by frame_id
    VALUE (not consecutive change): late / reordered packets land in the
    frame their frame_id names, so one packet straddling a frame boundary
    no longer splits a frame into fragments — the C++ ``ScanBatcher``
    behavior the reference relies on (``src/ptudes/data.py:44-62``).
    The 16-bit frame counter is unwrapped first (a drop of more than half
    the counter range relative to the previous packet is a wrap, a jump UP
    by more than half is a stray pre-wrap packet), so value-keying also
    survives 65535 -> 0 rollovers mid-recording.

    ``keep_fields=True`` also assembles the non-range channels
    (reflectivity/signal/nearir + second returns on dual profiles) for
    viewers — the reference exposes these via ouster-sdk ``LidarScan``
    fields (``src/ptudes/data.py:44-62``)."""
    w, h = info.w, info.h
    n_cols = cols.measurement_id.shape[0]
    if n_cols == 0:
        return ScanSequence(
            np.zeros((0, h, w), np.uint32), np.zeros((0, w), np.uint64),
            np.zeros((0, w), bool), np.zeros((0,), np.float64),
            {} if keep_fields else None)

    fid = cols.frame_id.astype(np.int64)
    half = 1 << 15
    d = np.diff(fid)
    # epoch goes up on a wrap (big drop), down for a stray packet from
    # before the wrap (big jump up); cancels back out on the next packet
    epoch = np.concatenate(
        [[0], np.cumsum((d < -half).astype(np.int64)
                        - (d > half).astype(np.int64))])
    unwrapped = fid + (epoch << 16)
    # mid-recording counter RESETS (sensor restart / concatenated
    # segments): a drop beyond the reorder window that is not a 16-bit
    # wrap must start a new segment, not merge temporally distant frames
    # that happen to share ids. Only a drop to a NEAR-ZERO raw counter is
    # a genuine restart (the sensor counts from 0 again) — that renumbers
    # the tail past the running max. A pathologically late packet whose
    # raw id is NOT near zero is dropped instead: renumbering on it would
    # fabricate a phantom segment boundary and shift all later frame
    # grouping. Restarts/strays are rare, so the loop runs ~once each.
    reorder_w = 4
    keep = np.ones(n_cols, bool)
    while True:
        run_max = np.maximum.accumulate(unwrapped)
        bad = np.nonzero(unwrapped < run_max - reorder_w)[0]
        if bad.size == 0:
            break
        r = bad[0]
        if fid[r] <= 2 * reorder_w:
            unwrapped[r:] += run_max[r - 1] + 1 - unwrapped[r]
        else:
            keep[r] = False
            unwrapped[r] = run_max[r]  # clamp so it stops triggering
    uniq, scan_idx = np.unique(unwrapped, return_inverse=True)
    n_scans = len(uniq)

    mid = np.clip(cols.measurement_id.astype(np.int64), 0, w - 1)
    ok = cols.status & keep

    range_mm = np.zeros((n_scans, h, w), np.uint32)
    col_ts = np.zeros((n_scans, w), np.uint64)
    valid = np.zeros((n_scans, w), bool)

    si, mi = scan_idx[ok], mid[ok]
    range_mm[si, :, mi] = cols.range_mm[ok]
    col_ts[si, mi] = cols.timestamp[ok]
    valid[si, mi] = True

    fields = None
    if keep_fields:
        fields = {}
        named = {"reflectivity": cols.reflectivity, "signal": cols.signal,
                 "nearir": cols.nir, "range2": cols.range2_mm,
                 "reflectivity2": cols.reflectivity2,
                 "signal2": cols.signal2}
        for name, ch in named.items():
            if ch is None:
                continue
            img = np.zeros((n_scans, h, w), ch.dtype)
            img[si, :, mi] = ch[ok]
            fields[name] = img

    # scan timestamp = last valid column ts (ns -> s)
    last_ts = np.where(valid, col_ts, 0).max(axis=1).astype(np.float64) * 1e-9
    return ScanSequence(range_mm, col_ts, valid, last_ts, fields)


def read_ouster_pcap(
    pcap_path: str, info: SensorInfo, keep_fields: bool = False
) -> tuple[ScanSequence, ImuSequence]:
    """Decode an Ouster pcap: split UDP payloads by size into lidar/IMU."""
    lsize = pkt.lidar_packet_size(info)
    streams = dict(pcap_io.read_pcap_udp(pcap_path))

    imu = ImuSequence(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    if pkt.IMU_PACKET_SIZE in streams:
        raw = pkt.parse_imu_packets(streams[pkt.IMU_PACKET_SIZE].payloads)
        imu = imu_from_raw(raw["sys_ts"], raw["accel_g"], raw["avel_deg"])

    if lsize not in streams:
        sizes = sorted(streams, key=lambda s: -streams[s].payloads.shape[0])
        raise ValueError(
            f"no UDP stream of lidar packet size {lsize} in {pcap_path}; "
            f"found sizes {sizes[:5]} — wrong metadata/profile?")
    cols = pkt.parse_lidar_packets(info, streams[lsize].payloads)
    return assemble_scans(info, cols, keep_fields), imu


def _bag_reader(bag_paths):
    """ROS1 / ROS2 dispatch (the reference gets this from rosbags.AnyReader,
    ``src/ptudes/bag.py:41``)."""
    first = bag_paths[0] if isinstance(bag_paths, list) else bag_paths
    if bag2_io.is_rosbag2(first):
        return bag2_io.Rosbag2Reader(bag_paths), True
    return bag_io.RosbagReader(bag_paths), False


def read_ouster_bag(
    bag_paths: str | list[str],
    info: SensorInfo,
    lidar_topic: str = "",
    imu_topic: str = "",
    keep_fields: bool = False,
) -> tuple[ScanSequence, ImuSequence]:
    """Ouster raw-packet bag source (reference ``OusterRawBagSource``,
    ``src/ptudes/bag.py:21-96``): reads ``*lidar_packets``/``*imu_packets``
    topics (autodiscovered by suffix when not given) from ROS1 or ROS2
    bags; checks the PacketMsg type MD5 (ROS1)."""
    reader, is_ros2 = _bag_reader(bag_paths)
    conns = reader.scan_connections()
    if not lidar_topic and not imu_topic:
        sel = [c.topic for c in conns
               if c.topic.endswith("lidar_packets")
               or c.topic.endswith("imu_packets")]
    else:
        sel = [t for t in (lidar_topic, imu_topic) if t]

    lidar_payloads, imu_payloads = [], []
    for msg in reader.messages(topics=sel):
        if msg.md5sum and msg.md5sum != bag_io.OUSTER_PACKETMSG_MD5:
            continue
        buf = (bag2_io.cdr_parse_packetmsg(msg.raw) if is_ros2
               else bag_io.parse_packetmsg(msg.raw))
        if msg.topic.endswith("lidar_packets"):
            lidar_payloads.append(np.frombuffer(buf, np.uint8))
        elif msg.topic.endswith("imu_packets"):
            imu_payloads.append(np.frombuffer(buf, np.uint8))

    imu = ImuSequence(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    if imu_payloads:
        raw = pkt.parse_imu_packets(np.stack(imu_payloads))
        imu = imu_from_raw(raw["sys_ts"], raw["accel_g"], raw["avel_deg"])

    if lidar_payloads:
        cols = pkt.parse_lidar_packets(info, np.stack(lidar_payloads))
        scans = assemble_scans(info, cols, keep_fields)
    else:
        scans = ScanSequence(
            np.zeros((0, info.h, info.w), np.uint32),
            np.zeros((0, info.w), np.uint64),
            np.zeros((0, info.w), bool), np.zeros(0))
    return scans, imu


def read_imu_bag(
    bag_paths: str | list[str], imu_topic: str | None = None
) -> ImuSequence:
    """IMU-only bag source (reference ``IMUBagSource``,
    ``src/ptudes/bag.py:99-160``): accepts ``sensor_msgs/msg/Imu`` or Ouster
    ``imu_packets`` topics from ROS1 or ROS2 bags; picks the first IMU-ish
    topic if unspecified."""
    reader, is_ros2 = _bag_reader(bag_paths)
    conns = reader.scan_connections()
    imu_conns = [
        c for c in conns
        if c.msgtype == "sensor_msgs/msg/Imu"
        or (c.msgtype in (("ouster_ros/msg/PacketMsg",)
                          + bag2_io.OUSTER_PACKETMSG_TYPES)
            and c.topic.endswith("imu_packets"))
    ]
    assert imu_conns, (
        "Expect a topic with msgtype sensor_msgs/msg/Imu or Ouster "
        "imu_packets but found none")
    if imu_topic is not None:
        sel = [c.topic for c in imu_conns if c.topic == imu_topic]
        assert sel, f"no IMU-ish topic named {imu_topic!r}"
    else:
        sel = [imu_conns[0].topic]

    ts_list, lacc_list, avel_list = [], [], []
    for msg in reader.messages(topics=sel):
        if msg.msgtype == "sensor_msgs/msg/Imu":
            t, la, av = (bag2_io.cdr_parse_imu_msg(msg.raw) if is_ros2
                         else bag_io.parse_imu_msg(msg.raw))
            ts_list.append(t)
            lacc_list.append(la)
            avel_list.append(av)
        elif msg.topic.endswith("imu_packets"):
            buf = (bag2_io.cdr_parse_packetmsg(msg.raw) if is_ros2
                   else bag_io.parse_packetmsg(msg.raw))
            raw = pkt.parse_imu_packets(np.frombuffer(buf, np.uint8)[None])
            ts_list.append(float(raw["sys_ts"][0]) * 1e-9)
            lacc_list.append(tuple(raw["accel_g"][0] * GRAV))
            avel_list.append(tuple(raw["avel_deg"][0] * np.pi / 180.0))
    # sensor_msgs/Imu values are already SI; the PacketMsg path converted
    # above (matching reference src/ptudes/bag.py:143-160)
    return ImuSequence(
        lacc=np.asarray(lacc_list, np.float64).reshape(-1, 3),
        avel=np.asarray(avel_list, np.float64).reshape(-1, 3),
        ts=np.asarray(ts_list, np.float64),
    )


def read_packet_source(
    file_path: str, info: SensorInfo, keep_fields: bool = False
) -> tuple[ScanSequence, ImuSequence]:
    """pcap / bag / directory-of-bags dispatch (reference
    ``read_packet_source``, ``src/ptudes/utils.py:171-187``)."""
    p = Path(file_path)
    if p.is_file() and p.suffix == ".pcap":
        return read_ouster_pcap(file_path, info, keep_fields)
    if p.is_file() and p.suffix in (".bag", ".db3"):
        return read_ouster_bag(file_path, info, keep_fields=keep_fields)
    if p.is_dir():
        if bag2_io.is_rosbag2(str(p)):
            return read_ouster_bag(str(p), info, keep_fields=keep_fields)
        bags = sorted(str(b) for b in p.glob("*.bag"))
        return read_ouster_bag(bags, info, keep_fields=keep_fields)
    raise ValueError(f"unsupported source {file_path}")
