"""Robot runtime layer: controllers, I/O backends, AprilTag localization
(counterpart of ``mfgp_tpu/hw``).

Host-side by design — this is the reference's Raspberry-Pi-facing surface
(SURVEY C23-C25); the card's work lives in ops/models/planning, and here
only the runtime's observer step and the tag filter's Kalman steps run on
a device.
"""

from mfgp_tpu_torch.hw.controllers import (KPID, PID, angle_wrap, saturate,
                                           simple_lpf, tail_wave,
                                           yaw_correction)
from mfgp_tpu_torch.hw.io import (RobotIO, SimulatedRobotIO, SocketRobotIO,
                                  m0_to_act_pos, rp1_to_act_pos)
from mfgp_tpu_torch.hw.apriltag import (AprilFusion, AprilFusionConfig,
                                        TagDetection, load_tag_map, rp_to_tf,
                                        tf_to_vec, vec_to_tf, zyx_rotm)
from mfgp_tpu_torch.hw.geo import convert_gps_format, gps_bearing_distance
from mfgp_tpu_torch.hw.plant import GliderPlant, PlantParams, TailWave
from mfgp_tpu_torch.hw.runtime import (FlightLog, ObserverStep, RobotRuntime,
                                       RuntimeConfig, flight_plan,
                                       mass_spd_control, pump_spd_control2,
                                       traj_point)
from mfgp_tpu_torch.hw.trajectories import (TRAJECTORIES,
                                            reference_trajectory,
                                            scale_to_workspace)
from mfgp_tpu_torch.hw import xbee  # noqa: F401
