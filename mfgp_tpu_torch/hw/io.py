"""Robot I/O abstraction (SURVEY C23 — deliberately thin, SURVEY §7).

The reference talks to device daemons over Unix-domain sockets with a text
protocol — ``R,<sensor>,\\n`` reads, ``S,<actuator>,<vals>,\\n`` writes
(reference/PhysicalExperimentCode/controllerHelper.py:9-182,348-355). Here
that surface is one ``RobotIO`` protocol with two backends:

* :class:`SocketRobotIO` — speaks the same wire protocol, so the framework
  remains pluggable onto the physical robot's daemons unchanged;
* :class:`SimulatedRobotIO` — a kinematic glider stand-in used by tests and
  the closed-loop simulator (the reference's equivalent was the
  ``nocontrol`` flag that stubbed actuation,
  reference/PhysicalExperimentCode/exploreExpSettings.py:72).

Actuator mappings (``rp1``/``m0`` physical units -> actuator percent,
reference/controllerHelper.py:118-130) live here as pure functions.

Counterpart of ``mfgp_tpu/hw/io.py``, copied as it is (numpy only).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Protocol, Tuple

import numpy as np

from mfgp_tpu_torch.hw.controllers import saturate

FRESH_WATER = 0
SALT_WATER = 1


def rp1_to_act_pos(rp1, par):
    """Moving-mass position -> actuator percent
    (reference/controllerHelper.py:123-126)."""
    offset, scale = par[0], par[1]
    return saturate(rp1 / scale + offset, 0.0, 0.95) * 100.0


def m0_to_act_pos(m0, par):
    """Ballast mass -> pump percent (reference/controllerHelper.py:128-130)."""
    offset2, scale2 = par[2], par[3]
    return saturate(m0 / scale2 + offset2, 0.0, 1.0) * 100.0


class RobotIO(Protocol):
    """The sensor/actuator surface the drivers used over sockets."""

    def read_depth(self, mode: int = FRESH_WATER) -> float: ...

    def read_euler(self, units: str = "rad") -> Tuple[float, float, float]: ...

    def read_imu(self) -> Tuple[float, ...]: ...

    def read_rgb(self) -> Tuple[float, float, float]: ...

    def read_batt_volt(self) -> float: ...

    def set_actuators(self, angle: float = -360, mass_pos: float = -1,
                      pump_pos: float = -1) -> None: ...

    def set_servo(self, angle: float) -> None: ...


class SocketRobotIO:
    """Unix-domain-socket backend speaking the reference wire protocol.

    Each daemon (I2C / IMU / ARDU / LED / XBEE) is one abstract-namespace
    socket (reference/controllerHelper.py:348-355 prepends NUL)."""

    def __init__(self, i2c_addr="./I2C_NODE", imu_addr="./IMU",
                 rgb_addr="./ARDU_NODE"):
        self.i2c = self._connect(i2c_addr)
        self.imu = self._connect(imu_addr)
        self.rgb = self._connect(rgb_addr)

    @staticmethod
    def _connect(server_address):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect("\0" + server_address)
        return sock

    def _ask(self, sock, msg: str) -> str:
        sock.send(msg.encode("utf-8"))
        return sock.recv(1024).decode("utf-8")

    def read_depth(self, mode: int = FRESH_WATER) -> float:
        cmd = {None: "R,depth,\n", FRESH_WATER: "R,depthFresh,\n",
               SALT_WATER: "R,depthOcean,\n"}[mode]
        ans = self._ask(self.i2c, cmd)
        return -10.0 if ans == "not available" else float(ans)

    def read_euler(self, units: str = "rad"):
        cmd = "R,rpy_rad,\n" if units == "rad" else "R,rpy,\n"
        vals = self._ask(self.imu, cmd).split(",")
        return tuple(float(v) for v in vals[:3])

    def read_imu(self):
        vals = self._ask(self.imu, "R,imuComp,\n").split(",")
        return tuple(float(v) for v in vals[:9])

    def read_rgb(self):
        vals = self._ask(self.rgb, "R,rgb,\n").split(",")
        return tuple(float(v) for v in vals[:3])

    def read_batt_volt(self) -> float:
        return float(self._ask(self.i2c, "R,battVolt\n"))

    def set_actuators(self, angle: float = -360, mass_pos: float = -1,
                      pump_pos: float = -1):
        if angle == -360 and mass_pos == -1 and pump_pos == -1:
            return
        self.i2c.send(
            f"S,inputsPos,{mass_pos},{pump_pos},{int(round(angle))},\n"
            .encode("utf-8"))

    def set_servo(self, angle: float):
        self.i2c.send(f"S,servo,{int(angle)},\n".encode("utf-8"))


@dataclass
class SimulatedRobotIO:
    """Kinematic glider stand-in: depth/attitude follow commanded actuators
    with first-order lags; RGB reads sample a field callback at the current
    position. Enough surface for driver logic without hardware."""

    depth: float = 0.0
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    batt: float = 12.6
    servo: float = 0.0
    mass_pos: float = 50.0
    pump_pos: float = 50.0

    def __post_init__(self):
        self._field = None

    def attach_field(self, fn):
        self._field = fn

    def read_depth(self, mode: int = FRESH_WATER) -> float:
        return self.depth

    def read_euler(self, units: str = "rad"):
        if units == "rad":
            return (self.roll, self.pitch, self.yaw)
        return tuple(np.rad2deg([self.roll, self.pitch, self.yaw]))

    def read_imu(self):
        return (self.roll, self.pitch, self.yaw, 0.0, 0.0, 0.0,
                0.0, 0.0, 0.0)

    def read_rgb(self):
        if self._field is None:
            return (0.0, 0.0, 0.0)
        v = float(self._field(*self.position))
        return (v, v, v)

    def read_batt_volt(self) -> float:
        return self.batt

    def set_actuators(self, angle: float = -360, mass_pos: float = -1,
                      pump_pos: float = -1):
        if mass_pos != -1:
            self.mass_pos = mass_pos
        if pump_pos != -1:
            self.pump_pos = pump_pos
        if angle != -360:
            self.servo = angle
        # crude kinematics: pump above/below neutral drives depth rate
        self.depth = max(0.0, self.depth + 0.001 * (self.pump_pos - 50.0))

    def set_servo(self, angle: float):
        self.servo = angle
