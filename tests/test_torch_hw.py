"""Parity of the port's robot layer (``mfgp_tpu_torch.hw``: controllers,
geo, trajectories, xbee, ``SimulatedRobotIO``, the glider plant, the
AprilTag fusion) and of ``mfgp_tpu_torch.sim.dynamics`` with ``mfgp_tpu``
on the CPU, in float64: the same inputs through both packages, equal (the
NumPy copies) or within 1e-10 (the fusion's Kalman steps and the torch
dynamics)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfgp_tpu import hw as jhw
from mfgp_tpu.hw import apriltag as japr
from mfgp_tpu.hw import plant as jplant
from mfgp_tpu.hw import trajectories as jtraj
from mfgp_tpu.hw import xbee as jxb
from mfgp_tpu.planning import primitives as jpr
from mfgp_tpu.sim import dynamics as jdyn
from mfgp_tpu_torch import hw as thw
from mfgp_tpu_torch.hw import apriltag as tapr
from mfgp_tpu_torch.hw import plant as tplant
from mfgp_tpu_torch.hw import trajectories as ttraj
from mfgp_tpu_torch.hw import xbee as txb
from mfgp_tpu_torch.planning import primitives as tpr
from mfgp_tpu_torch.sim import dynamics as tdyn

TOL = 1e-10


def test_controller_functions_equal():
    rng = np.random.default_rng(0)
    x = rng.uniform(-300, 300, 50)
    assert np.array_equal(thw.saturate(x, -10, 20), jhw.saturate(x, -10, 20))
    assert np.array_equal(thw.angle_wrap(x, 180), jhw.angle_wrap(x, 180))
    for a, b in rng.uniform(-4, 4, (10, 2)):
        assert thw.yaw_correction(a, b, np.pi) == jhw.yaw_correction(
            a, b, np.pi)
    assert thw.simple_lpf(3.0, 1.0, 0.2) == jhw.simple_lpf(3.0, 1.0, 0.2)
    t = np.linspace(0, 6, 301)
    for wave in ("square", "sin"):
        assert np.array_equal(thw.tail_wave(t, 5, 20, 0.7, wave),
                              jhw.tail_wave(t, 5, 20, 0.7, wave))


def test_pid_and_kpid_equal():
    """The stateful PID and KPID over the same error sequence."""
    errs = np.sin(np.linspace(0, 8, 120))
    tp, jp = thw.PID(2.0, 0.5, 0.1, clip=(-5, 5)), jhw.PID(2.0, 0.5, 0.1,
                                                         clip=(-5, 5))
    tk, jk = thw.KPID(1.0, 0.2, 0.3), jhw.KPID(1.0, 0.2, 0.3)
    for e in errs:
        assert tp.run(e, 0.05) == jp.run(e, 0.05)
        assert tk.run(e, 0.05) == jk.run(e, 0.05)
    assert np.array_equal(tk.state.x, jk.state.x)


def test_actuator_maps_and_geo_equal():
    par = (0.1, 2.0, 0.2, 3.0)
    for v in (-100.0, 0.0, 3.3, 47.0, 100.0):
        assert thw.rp1_to_act_pos(v, par) == jhw.rp1_to_act_pos(v, par)
        assert thw.m0_to_act_pos(v, par) == jhw.m0_to_act_pos(v, par)
    for args in ((0.0, 0.0, 1.0, 0.0), (44.1, -72.3, 44.2, -72.1),
                 (-33.9, 151.2, -34.0, 151.0)):
        assert thw.gps_bearing_distance(*args) == \
            jhw.gps_bearing_distance(*args)
    assert thw.convert_gps_format(4412.5, -7218.3) == \
        jhw.convert_gps_format(4412.5, -7218.3)


def test_trajectories_equal():
    t = np.linspace(0, 540, 200)
    assert sorted(ttraj.TRAJECTORIES) == sorted(jtraj.TRAJECTORIES)
    for name in jtraj.TRAJECTORIES:
        a = ttraj.reference_trajectory(name, t)
        b = jtraj.reference_trajectory(name, t)
        assert np.array_equal(a, b)
        assert np.array_equal(
            ttraj.scale_to_workspace(a, [[0, 10], [0, 20]], 10.0),
            jtraj.scale_to_workspace(b, [[0, 10], [0, 20]], 10.0))
    with pytest.raises(KeyError):
        ttraj.reference_trajectory("nope", t)


def test_xbee_codec_equal():
    fix_t = txb.GPSFix(12.5, True, 1.25, -3.5, 0.7)
    fix_j = jxb.GPSFix(12.5, True, 1.25, -3.5, 0.7)
    msgs = ["OBTTC,BEGIN", "OBTTC,STOP,now", "OBTTC,SNAP",
            "OBTTC,CAMWPT,1,2", txb.encode_gps(fix_t),
            "OBTTC,CameraGPS,1,True,x", "garbage", "OBTTC,WHAT"]
    assert txb.encode_gps(fix_t) == jxb.encode_gps(fix_j)
    for m in msgs:
        a, b = txb.parse(m), jxb.parse(m)
        assert a.command.value == b.command.value and a.raw == b.raw
        assert (a.gps is None) == (b.gps is None)
        if a.gps is not None:
            assert dataclasses.astuple(a.gps) == dataclasses.astuple(b.gps)


def test_simulated_robot_io_equal():
    """The same command sequence through both ``SimulatedRobotIO``s."""
    ios = [thw.SimulatedRobotIO(), jhw.SimulatedRobotIO()]
    for io in ios:
        io.attach_field(lambda x, y, z: x + 2 * y + 3 * z)
        io.position[:] = (1.0, 2.0, 0.5)
    rng = np.random.default_rng(4)
    for _ in range(25):
        kw = dict(angle=float(rng.uniform(-30, 30)),
                  mass_pos=float(rng.uniform(0, 100)),
                  pump_pos=float(rng.uniform(0, 100)))
        reads = []
        for io in ios:
            io.set_actuators(**kw)
            io.set_servo(kw["angle"] / 2)
            reads.append((io.read_depth(), io.read_euler(),
                          io.read_euler("deg"), io.read_imu(),
                          io.read_rgb(), io.read_batt_volt(), io.servo))
        assert reads[0] == reads[1]


def test_glider_plant_steps_equal():
    """``GliderPlant`` from ``PlantParams.from_agent`` stepped 600 times
    under a command schedule (mass, pump, tail gait, bias), every sensor
    read equal."""
    agents = (tpr.AgentConfig.sim_defaults(), jpr.AgentConfig.sim_defaults())
    assert dataclasses.asdict(agents[0]) == dataclasses.asdict(agents[1])
    params = (tplant.PlantParams.from_agent(agents[0]),
              jplant.PlantParams.from_agent(agents[1]))
    assert dataclasses.asdict(params[0]) == dataclasses.asdict(params[1])
    plants = [tplant.GliderPlant(params[0], x=1.0, y=2.0),
              jplant.GliderPlant(params[1], x=1.0, y=2.0)]
    for p in plants:
        p.attach_field(lambda x, y, z: np.exp(-0.1 * (x * x + y + z)))
    rng = np.random.default_rng(7)
    for k in range(600):
        if k % 50 == 0:
            cmd = rng.uniform([0, 0, -40, 0, 0.2], [100, 100, 40, 30, 2.0])
        reads = []
        for p in plants:
            p.set_mass_pos(cmd[0])
            p.set_pump_pos(cmd[1])
            p.tail.bias, p.tail.amp, p.tail.freq = cmd[2], cmd[3], cmd[4]
            if k % 97 == 0:
                p.set_actuators(angle=cmd[2] / 2, mass_pos=cmd[0] / 2)
            p.step(0.05)
            reads.append((p.read_depth(), p.read_euler(), p.read_gyro(),
                          p.read_imu(), p.read_inputs(), p.read_rgb(),
                          tuple(p.position), tuple(p.velocity)))
        assert reads[0] == reads[1]


def tag_scene():
    """The inputs of the JAX package's own fusion tests: a tag seen from a
    fixed pose (convergence), then a teleported fix (outlier rejection),
    then wrapped compass readings near +-pi with a GPS fix."""
    tag_world = japr.vec_to_tf([5.0, 3.0, 0.0, 0.0, 0.0, 0.0])
    true_pos = np.array([4.0, 2.5, 1.2])
    good = np.linalg.inv(japr.rp_to_tf(np.eye(3), true_pos)) @ tag_world
    far = np.linalg.inv(japr.rp_to_tf(np.eye(3), true_pos + [10.0, 0, 0])) \
        @ tag_world
    frames = []
    for i in range(50):
        frames.append((0.1 * i, [(7, good, 0.0)], 0.0, None))
    frames.append((5.0, [(7, far, 0.01)], 0.0, None))
    for i in range(30):
        yaw = np.pi - 0.05 if i % 2 == 0 else -np.pi + 0.05
        gps = (4.1, 2.4, yaw) if i % 5 == 0 else None
        frames.append((5.1 + 0.1 * i, [(7, good, 0.002), (9, good, 0.0)],
                       yaw, gps))
    return tag_world, true_pos, frames


def test_april_fusion_sequence():
    """``AprilFusion.step`` over the scene: state and covariance diagonal
    within 1e-10 of the JAX package's after every frame; on the CPU
    when asked, on the card by default (raising without one)."""
    tag_world, true_pos, frames = tag_scene()
    cfg_t = tapr.AprilFusionConfig(window_time=100.0)
    cfg_j = japr.AprilFusionConfig(window_time=100.0)
    ft = tapr.AprilFusion({7: tag_world}, cfg=cfg_t, device="cpu")
    fj = japr.AprilFusion({7: tag_world}, cfg=cfg_j)
    for t, dets, yaw, gps in frames:
        xt, vt = ft.step(t, 0.1, true_pos[2], yaw,
                         [tapr.TagDetection(i, tf[:3, :3], tf[:3, 3], pe)
                          for i, tf, pe in dets], gps)
        xj, vj = fj.step(t, 0.1, true_pos[2], yaw,
                         [japr.TagDetection(i, tf[:3, :3], tf[:3, 3], pe)
                          for i, tf, pe in dets], gps)
        np.testing.assert_allclose(xt, xj, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(vt, vj, rtol=TOL, atol=TOL)
    assert abs(abs(xt[3, 0]) - np.pi) < 0.3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapr.AprilFusion({7: tag_world})


def test_apriltag_geometry_equal():
    rng = np.random.default_rng(2)
    for vec in rng.uniform(-30, 30, (5, 6)):
        np.testing.assert_allclose(tapr.vec_to_tf(vec), japr.vec_to_tf(vec),
                                   rtol=0, atol=0)
        tf = japr.vec_to_tf(vec)
        assert np.array_equal(tapr.tf_to_vec(tf), japr.tf_to_vec(tf))
        assert tapr.rotm_to_euler(tf[:3, :3]) == japr.rotm_to_euler(
            tf[:3, :3])
        assert np.array_equal(tapr.zyx_rotm(*vec[3:]), japr.zyx_rotm(
            *vec[3:]))


def test_tag_map_file(tmp_path):
    p = tmp_path / "tags.csv"
    p.write_text("id,x,y,z,roll,pitch,yaw\n3,1,2,0,0,0,90\n8,0,-1,1,10,5,0\n")
    a, b = tapr.load_tag_map(str(p)), japr.load_tag_map(str(p))
    assert sorted(a) == sorted(b) == [3, 8]
    for k in a:
        assert np.array_equal(a[k], b[k])


def test_dynamics_rk4():
    """``rk4_step`` with the three toy models, 10 steps each, within 1e-10
    of the JAX functions (the tensors are float64 on the CPU)."""
    f64 = dict(dtype=torch.float64)
    cases = [(tdyn.single_integrator_3d, jdyn.single_integrator_3d,
              np.zeros(3), np.array([1.0, 0.0, 0.5])),
             (tdyn.unicycle_3d, jdyn.unicycle_3d, np.array([0.0, 1.0, 0.0,
                                                            0.3]),
              np.array([0.4, -0.1, 0.7])),
             (tdyn.glider_simple, jdyn.glider_simple,
              np.array([0.0, 10.0, 1.0, 0.0]), np.array([2.0, 0.3]))]
    for ft, fj, x0, u in cases:
        xt, xj = torch.tensor(x0, **f64), jnp.asarray(x0)
        ut = torch.tensor(u, **f64)
        for _ in range(10):
            xt = tdyn.rk4_step(ft, xt, ut, 0.1)
            xj = jdyn.rk4_step(fj, xj, jnp.asarray(u), 0.1)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=TOL,
                                   atol=TOL)
    assert float(tdyn.rk4_step(tdyn.glider_simple,
                               torch.tensor([0.0, 10.0, 1.0, 0.0], **f64),
                               torch.zeros(2, **f64), 0.1)[3]) < 0
