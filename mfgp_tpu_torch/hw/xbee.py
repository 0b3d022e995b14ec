"""XBee operator-link message grammar (SURVEY C23/§5).

The reference's drivers listen on an XBee radio for operator commands and
camera-rig GPS fixes with a comma grammar ``OBTTC,<CMD>,...``
(reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
278-308: BEGIN / STOP / SNAP / CAMWPT / CameraGPS,time,reliable,x,y,yaw)
and send free-text status strings back. This module is the transport-free
codec for that grammar: the closed-loop simulator and any radio backend
share it.

Counterpart of ``mfgp_tpu/hw/xbee.py``, copied as it is (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

PREFIX = "OBTTC"


class Command(Enum):
    BEGIN = "BEGIN"
    STOP = "STOP"
    SNAP = "SNAP"
    CAMWPT = "CAMWPT"
    CAMERA_GPS = "CameraGPS"
    UNKNOWN = "?"


@dataclass(frozen=True)
class GPSFix:
    """CameraGPS payload: time, reliable flag, x, y, yaw
    (reference driver :300-305)."""

    t: float
    reliable: bool
    x: float
    y: float
    yaw: float


@dataclass(frozen=True)
class Message:
    command: Command
    gps: Optional[GPSFix] = None
    raw: str = ""


def parse(msg: str) -> Message:
    """Decode one radio message. Tolerant like the reference listener:
    substring command matching, malformed GPS payloads degrade to a plain
    CameraGPS message with ``gps=None``."""
    parts = msg.strip().split(",")
    if len(parts) < 2:
        return Message(Command.UNKNOWN, raw=msg)
    tag = parts[1]
    for cmd in Command:
        if cmd is Command.UNKNOWN:
            continue
        if cmd.value in tag:
            if cmd is Command.CAMERA_GPS:
                try:
                    fix = GPSFix(t=float(parts[2]), reliable=parts[3] == "True",
                                 x=float(parts[4]), y=float(parts[5]),
                                 yaw=float(parts[6]))
                except (IndexError, ValueError):
                    fix = None
                return Message(cmd, gps=fix, raw=msg)
            return Message(cmd, raw=msg)
    return Message(Command.UNKNOWN, raw=msg)


def encode(cmd: Command, *payload) -> str:
    return ",".join([PREFIX, cmd.value, *map(str, payload)])


def encode_gps(fix: GPSFix) -> str:
    return encode(Command.CAMERA_GPS, fix.t, fix.reliable, fix.x, fix.y,
                  fix.yaw)
