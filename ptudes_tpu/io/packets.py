"""Ouster UDP packet parsing — numpy-vectorized host-side decoders.

Host-side replacement for ouster-sdk's C++ ``PacketFormat``/``ScanBatcher``
(reference call sites ``src/ptudes/data.py:44-62``): instead of per-packet
C++ calls through pybind11, whole packet *batches* are decoded with
vectorized numpy views and assembled into dense [H, W] field arrays, which
is both simpler and faster to feed to the device. A C++ fast path
(ptudes_tpu.native) accelerates the pcap->payload split; the decoding
below is already vectorized.

Supported lidar profiles:
  * LEGACY                         (FW < 2.2; Newer College 2020/2021 bags)
  * RNG19_RFL8_SIG16_NIR16         (single-return eUDP; OS-0-128 v3 pcap)
  * RNG15_RFL8_NIR8                (low-bandwidth eUDP)
  * RNG19_RFL8_SIG16_NIR16_DUAL    (dual-return eUDP, 16 B/px)
  * FUSA_RNG15_RFL8_NIR8_DUAL      (FUSA dual-return, 8 B/px)
IMU packets are the fixed 48-byte layout (all FWs).

Byte layouts follow the public Ouster firmware user manual; see the
structured dtypes below for the exact offsets. Dual-return profiles
decode both returns; the odometry pipeline consumes the FIRST (strongest)
return, matching what the reference inherits from ouster-sdk's default
RANGE field (``src/ptudes/data.py:44-62``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .metadata import (PROFILE_DUAL, PROFILE_FUSA, PROFILE_LEGACY,
                       PROFILE_RNG15, PROFILE_RNG19, SensorInfo)

IMU_PACKET_SIZE = 48

# --- IMU packet: 3 x u64 timestamps + 3 x f32 accel (g) + 3 x f32 gyro (deg/s)
_IMU_DTYPE = np.dtype([
    ("sys_ts", "<u8"),
    ("accel_ts", "<u8"),
    ("gyro_ts", "<u8"),
    ("la", "<f4", 3),
    ("av", "<f4", 3),
])


def parse_imu_packets(payloads: np.ndarray) -> dict[str, np.ndarray]:
    """[N, 48] uint8 -> dict of arrays. Units converted downstream
    (``Imu`` uses SI: reference ``src/ptudes/ins/data.py:24-26``)."""
    from .. import native
    out = native.parse_imu(payloads)
    if out is not None:
        return out
    rec = payloads.reshape(-1).view(_IMU_DTYPE).reshape(payloads.shape[0])
    return {
        "sys_ts": rec["sys_ts"].copy(),
        "accel_ts": rec["accel_ts"].copy(),
        "gyro_ts": rec["gyro_ts"].copy(),
        "accel_g": rec["la"].copy(),
        "avel_deg": rec["av"].copy(),
    }


def legacy_packet_size(h: int, columns_per_packet: int = 16) -> int:
    return columns_per_packet * (16 + h * 12 + 4)


def eudp_packet_size(h: int, columns_per_packet: int = 16,
                     pixel_bytes: int = 12) -> int:
    # 32 B packet header + columns * (12 B column header + pixels) + 32 B footer
    return 32 + columns_per_packet * (12 + h * pixel_bytes) + 32


def rng15_packet_size(h: int, columns_per_packet: int = 16) -> int:
    return eudp_packet_size(h, columns_per_packet, pixel_bytes=4)


_PROFILE_PIXEL_BYTES = {
    PROFILE_RNG19: 12,
    PROFILE_RNG15: 4,
    PROFILE_DUAL: 16,
    PROFILE_FUSA: 8,
}


def lidar_packet_size(info: SensorInfo) -> int:
    if info.udp_profile_lidar == PROFILE_LEGACY:
        return legacy_packet_size(info.h, info.columns_per_packet)
    if info.udp_profile_lidar in _PROFILE_PIXEL_BYTES:
        return eudp_packet_size(
            info.h, info.columns_per_packet,
            pixel_bytes=_PROFILE_PIXEL_BYTES[info.udp_profile_lidar])
    raise ValueError(f"unsupported profile {info.udp_profile_lidar}")


@dataclass
class ParsedColumns:
    """Per-column decode result of a batch of lidar packets, flattened over
    (packet, column)."""
    timestamp: np.ndarray    # [C] u64 nanoseconds
    measurement_id: np.ndarray  # [C] u16
    frame_id: np.ndarray     # [C] u16/u32
    status: np.ndarray       # [C] bool (column valid)
    range_mm: np.ndarray     # [C, H] u32 (millimeters; RNG15 pre-scaled x8)
    reflectivity: np.ndarray  # [C, H] u16/u8
    signal: np.ndarray       # [C, H] u16 (zeros if profile lacks it)
    nir: np.ndarray          # [C, H] u16
    # second return (dual-return profiles only; None otherwise)
    range2_mm: np.ndarray | None = None      # [C, H] u32
    reflectivity2: np.ndarray | None = None  # [C, H] u16
    signal2: np.ndarray | None = None        # [C, H] u16


def parse_lidar_packets(info: SensorInfo, payloads: np.ndarray) -> ParsedColumns:
    """[N, packet_size] uint8 -> ParsedColumns (native fast path when the
    C++ runtime built; numpy-vectorized otherwise)."""
    prof = info.udp_profile_lidar
    h, cpp = info.h, info.columns_per_packet
    n = payloads.shape[0]

    from .. import native
    nat = native.parse_lidar(prof, payloads, h, cpp) if n else None
    if nat is not None:
        return ParsedColumns(
            timestamp=nat["timestamp"],
            measurement_id=nat["measurement_id"],
            frame_id=nat["frame_id"],
            status=nat["status"].astype(bool),
            range_mm=nat["range_mm"],
            reflectivity=nat["reflectivity"],
            signal=nat["signal"],
            nir=nat["nir"],
            range2_mm=nat.get("range2_mm"),
            reflectivity2=nat.get("reflectivity2"),
            signal2=nat.get("signal2"),
        )

    if prof == PROFILE_LEGACY:
        block = 16 + h * 12 + 4
        cols = payloads.reshape(n * cpp, block)
        hdr = cols[:, :16]
        timestamp = hdr.copy().view("<u8")[:, 0]
        measurement_id = hdr[:, 8:10].copy().view("<u2")[:, 0]
        frame_id = hdr[:, 10:12].copy().view("<u2")[:, 0]
        px = cols[:, 16:16 + h * 12].reshape(n * cpp, h, 12)
        rng = px[:, :, 0:4].copy().view("<u4")[:, :, 0] & 0x000FFFFF
        refl = px[:, :, 4:6].copy().view("<u2")[:, :, 0]
        signal = px[:, :, 6:8].copy().view("<u2")[:, :, 0]
        nir = px[:, :, 8:10].copy().view("<u2")[:, :, 0]
        status_raw = cols[:, -4:].copy().view("<u4")[:, 0]
        status = status_raw == 0xFFFFFFFF
        return ParsedColumns(timestamp, measurement_id, frame_id, status,
                             rng.astype(np.uint32), refl, signal, nir)

    if prof in _PROFILE_PIXEL_BYTES:
        pixel_bytes = _PROFILE_PIXEL_BYTES[prof]
        col_bytes = 12 + h * pixel_bytes
        body = payloads[:, 32:32 + cpp * col_bytes]
        cols = body.reshape(n * cpp, col_bytes)
        timestamp = cols[:, 0:8].copy().view("<u8")[:, 0]
        measurement_id = cols[:, 8:10].copy().view("<u2")[:, 0]
        status = (cols[:, 10:12].copy().view("<u2")[:, 0] & 0x1) == 1
        # frame id lives in the 32 B packet header (u16 at offset 2)
        frame_id = np.repeat(payloads[:, 2:4].copy().view("<u2")[:, 0], cpp)
        px = cols[:, 12:].reshape(n * cpp, h, pixel_bytes)
        if prof == PROFILE_RNG19:
            rng = px[:, :, 0:4].copy().view("<u4")[:, :, 0] & 0x0007FFFF
            refl = px[:, :, 4:5][:, :, 0].astype(np.uint16)
            signal = px[:, :, 6:8].copy().view("<u2")[:, :, 0]
            nir = px[:, :, 8:10].copy().view("<u2")[:, :, 0]
        elif prof == PROFILE_RNG15:  # u16 range (x8 mm) + u8 refl + u8 nir
            raw = px[:, :, 0:2].copy().view("<u2")[:, :, 0]
            rng = raw.astype(np.uint32) * 8  # pre-scale to mm
            refl = px[:, :, 2:3][:, :, 0].astype(np.uint16)
            signal = np.zeros_like(refl, dtype=np.uint16)
            nir = px[:, :, 3:4][:, :, 0].astype(np.uint16)
        elif prof == PROFILE_DUAL:
            # 16 B/px: [u32 range1(19b) | refl1 @3] [u32 range2(19b) |
            # refl2 @7] [u16 signal1 @8] [u16 signal2 @10] [u16 nir @12]
            rng = px[:, :, 0:4].copy().view("<u4")[:, :, 0] & 0x0007FFFF
            refl = px[:, :, 3:4][:, :, 0].astype(np.uint16)
            rng2 = px[:, :, 4:8].copy().view("<u4")[:, :, 0] & 0x0007FFFF
            refl2 = px[:, :, 7:8][:, :, 0].astype(np.uint16)
            signal = px[:, :, 8:10].copy().view("<u2")[:, :, 0]
            signal2 = px[:, :, 10:12].copy().view("<u2")[:, :, 0]
            nir = px[:, :, 12:14].copy().view("<u2")[:, :, 0]
            return ParsedColumns(
                timestamp, measurement_id, frame_id, status,
                rng.astype(np.uint32), refl, signal, nir,
                range2_mm=rng2.astype(np.uint32), reflectivity2=refl2,
                signal2=signal2)
        else:  # PROFILE_FUSA: 8 B/px, two returns, 15-bit x8mm ranges
            raw1 = px[:, :, 0:2].copy().view("<u2")[:, :, 0] & 0x7FFF
            rng = raw1.astype(np.uint32) * 8
            refl = px[:, :, 2:3][:, :, 0].astype(np.uint16)
            nir = px[:, :, 3:4][:, :, 0].astype(np.uint16)
            raw2 = px[:, :, 4:6].copy().view("<u2")[:, :, 0] & 0x7FFF
            rng2 = raw2.astype(np.uint32) * 8
            refl2 = px[:, :, 6:7][:, :, 0].astype(np.uint16)
            signal = np.zeros_like(refl, dtype=np.uint16)
            return ParsedColumns(
                timestamp, measurement_id, frame_id, status,
                rng, refl, signal, nir,
                range2_mm=rng2, reflectivity2=refl2,
                signal2=np.zeros_like(refl2))
        return ParsedColumns(timestamp, measurement_id, frame_id, status,
                             rng.astype(np.uint32), refl, signal, nir)

    raise ValueError(f"unsupported profile {prof}")


def make_legacy_packet(
    info: SensorInfo,
    timestamps: np.ndarray,     # [cpp] u64
    measurement_ids: np.ndarray,  # [cpp]
    frame_id: int,
    range_mm: np.ndarray,       # [cpp, H]
    reflectivity: np.ndarray | None = None,
    signal: np.ndarray | None = None,
    nir: np.ndarray | None = None,
    valid: np.ndarray | None = None,  # [cpp] bool
) -> bytes:
    """Synthesize a LEGACY lidar packet (test fixtures / sim pcap export)."""
    h, cpp = info.h, info.columns_per_packet
    block = 16 + h * 12 + 4
    out = np.zeros((cpp, block), np.uint8)
    out[:, 0:8] = np.asarray(timestamps, "<u8").view(np.uint8).reshape(cpp, 8)
    out[:, 8:10] = np.asarray(measurement_ids, "<u2").view(np.uint8).reshape(cpp, 2)
    out[:, 10:12] = np.full(cpp, frame_id, "<u2").view(np.uint8).reshape(cpp, 2)
    px = np.zeros((cpp, h, 12), np.uint8)
    px[:, :, 0:4] = (np.asarray(range_mm, "<u4") & 0xFFFFF).view(np.uint8).reshape(cpp, h, 4)
    if reflectivity is not None:
        px[:, :, 4:6] = np.asarray(reflectivity, "<u2").view(np.uint8).reshape(cpp, h, 2)
    if signal is not None:
        px[:, :, 6:8] = np.asarray(signal, "<u2").view(np.uint8).reshape(cpp, h, 2)
    if nir is not None:
        px[:, :, 8:10] = np.asarray(nir, "<u2").view(np.uint8).reshape(cpp, h, 2)
    out[:, 16:16 + h * 12] = px.reshape(cpp, h * 12)
    v = np.ones(cpp, bool) if valid is None else np.asarray(valid, bool)
    out[:, -4:] = np.where(v, np.uint32(0xFFFFFFFF), np.uint32(0)).astype(
        "<u4").view(np.uint8).reshape(cpp, 4)
    return out.tobytes()


def make_eudp_packet(
    info: SensorInfo,
    timestamps: np.ndarray,       # [cpp] u64
    measurement_ids: np.ndarray,  # [cpp]
    frame_id: int,
    range_mm: np.ndarray,         # [cpp, H] first return
    reflectivity: np.ndarray | None = None,
    signal: np.ndarray | None = None,
    nir: np.ndarray | None = None,
    range2_mm: np.ndarray | None = None,   # dual profiles only
    reflectivity2: np.ndarray | None = None,
    signal2: np.ndarray | None = None,
    valid: np.ndarray | None = None,       # [cpp] bool
) -> bytes:
    """Synthesize an eUDP lidar packet for RNG19 / RNG15 / DUAL / FUSA
    (test fixtures / sim pcap export) — inverse of the decoders above."""
    prof = info.udp_profile_lidar
    h, cpp = info.h, info.columns_per_packet
    pixel_bytes = _PROFILE_PIXEL_BYTES[prof]
    col_bytes = 12 + h * pixel_bytes
    out = np.zeros((eudp_packet_size(h, cpp, pixel_bytes),), np.uint8)
    out[2:4] = np.asarray([frame_id], "<u2").view(np.uint8)

    def u8(a, dtype):
        return np.asarray(a, dtype).view(np.uint8)

    z16 = np.zeros((cpp, h), np.uint16)
    refl = z16 if reflectivity is None else np.asarray(reflectivity)
    sig = z16 if signal is None else np.asarray(signal)
    nr = z16 if nir is None else np.asarray(nir)
    rng2 = np.zeros((cpp, h), np.uint32) if range2_mm is None \
        else np.asarray(range2_mm)
    refl2 = z16 if reflectivity2 is None else np.asarray(reflectivity2)
    sig2 = z16 if signal2 is None else np.asarray(signal2)
    v = np.ones(cpp, bool) if valid is None else np.asarray(valid, bool)

    cols = out[32:32 + cpp * col_bytes].reshape(cpp, col_bytes)
    cols[:, 0:8] = u8(timestamps, "<u8").reshape(cpp, 8)
    cols[:, 8:10] = u8(measurement_ids, "<u2").reshape(cpp, 2)
    cols[:, 10:12] = u8(v.astype("<u2"), "<u2").reshape(cpp, 2)
    px = cols[:, 12:].reshape(cpp, h, pixel_bytes)
    if prof == PROFILE_RNG19:
        px[:, :, 0:4] = u8(np.asarray(range_mm, "<u4") & 0x7FFFF,
                           "<u4").reshape(cpp, h, 4)
        px[:, :, 4] = refl.astype(np.uint8)
        px[:, :, 6:8] = u8(sig, "<u2").reshape(cpp, h, 2)
        px[:, :, 8:10] = u8(nr, "<u2").reshape(cpp, h, 2)
    elif prof == PROFILE_RNG15:
        px[:, :, 0:2] = u8((np.asarray(range_mm) // 8).astype("<u2"),
                           "<u2").reshape(cpp, h, 2)
        px[:, :, 2] = refl.astype(np.uint8)
        px[:, :, 3] = nr.astype(np.uint8)
    elif prof == PROFILE_DUAL:
        w1 = (np.asarray(range_mm, "<u4") & 0x7FFFF) \
            | (refl.astype("<u4") << 24)
        w2 = (np.asarray(rng2, "<u4") & 0x7FFFF) \
            | (refl2.astype("<u4") << 24)
        px[:, :, 0:4] = u8(w1, "<u4").reshape(cpp, h, 4)
        px[:, :, 4:8] = u8(w2, "<u4").reshape(cpp, h, 4)
        px[:, :, 8:10] = u8(sig, "<u2").reshape(cpp, h, 2)
        px[:, :, 10:12] = u8(sig2, "<u2").reshape(cpp, h, 2)
        px[:, :, 12:14] = u8(nr, "<u2").reshape(cpp, h, 2)
    elif prof == PROFILE_FUSA:
        px[:, :, 0:2] = u8((np.asarray(range_mm) // 8).astype("<u2")
                           & 0x7FFF, "<u2").reshape(cpp, h, 2)
        px[:, :, 2] = refl.astype(np.uint8)
        px[:, :, 3] = nr.astype(np.uint8)
        px[:, :, 4:6] = u8((np.asarray(rng2) // 8).astype("<u2")
                           & 0x7FFF, "<u2").reshape(cpp, h, 2)
        px[:, :, 6] = refl2.astype(np.uint8)
    else:
        raise ValueError(f"unsupported eUDP profile {prof}")
    return out.tobytes()


def make_imu_packet(
    sys_ts_ns: int, accel_g: np.ndarray, avel_deg: np.ndarray
) -> bytes:
    rec = np.zeros(1, _IMU_DTYPE)
    rec["sys_ts"] = sys_ts_ns
    rec["accel_ts"] = sys_ts_ns
    rec["gyro_ts"] = sys_ts_ns
    rec["la"] = np.asarray(accel_g, np.float32)
    rec["av"] = np.asarray(avel_deg, np.float32)
    return rec.tobytes()
