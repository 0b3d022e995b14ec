"""The port's native CSV binding (``mfgp_tpu_torch.native``) against NumPy
and the JAX package's, and its profiling helpers
(``mfgp_tpu_torch.utils.profiling``) on the CPU."""

import json
import os
import time

import numpy as np
import pytest

from mfgp_tpu import native as jnative
from mfgp_tpu_torch import native
from mfgp_tpu_torch.utils.profiling import PhaseTimer, device_trace


@pytest.fixture(scope="module")
def built():
    if not native.build():
        pytest.skip("g++ unavailable")
    return True


def test_build_stays_out_of_native_dir(built):
    """The port's library is built into its own git-ignored directory,
    keyed by the source's hash, not into native/ (the JAX package's)."""
    path = native.lib_path()
    assert path.is_file() and native.available()
    assert path.parent.parent == native.BUILD_ROOT
    assert path.parent.parent.name == ".kernel_build"


def test_load_matches_numpy_and_jax(built, tmp_path):
    d = np.random.default_rng(0).normal(size=(500, 7))
    p = tmp_path / "d.csv"
    np.savetxt(p, d, delimiter=",", header="a,b,c,d,e,f,g", comments="")
    a = np.loadtxt(p, delimiter=",", skiprows=1, ndmin=2)
    np.testing.assert_array_equal(native.load_csv(str(p)), a)
    np.testing.assert_array_equal(native.load_csv(str(p)),
                                  jnative.load_csv(str(p)))


def test_write_round_trip(built, tmp_path):
    d = np.random.default_rng(1).normal(size=(50, 4))
    p = tmp_path / "w.csv"
    native.write_csv(str(p), d, header="a,b,c,d")
    assert open(p).readline().strip() == "a,b,c,d"
    np.testing.assert_array_equal(native.load_csv(str(p)), d)  # %.17g


def test_io_layer_uses_native(built, tmp_path, monkeypatch):
    from mfgp_tpu_torch.data.io import Table, load_table

    calls = []
    load = native.load_csv
    monkeypatch.setattr(native, "load_csv",
                        lambda *a, **k: calls.append(a) or load(*a, **k))
    t = Table(["t", "x"], np.random.default_rng(2).normal(size=(20, 2)))
    t.save(str(tmp_path / "t.csv"))
    back = load_table(str(tmp_path / "t.csv"))
    np.testing.assert_allclose(back.data, t.data)
    assert back.headers == t.headers and len(calls) == 1


def test_numpy_fallback_when_unbuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "none")
    assert not native.available()
    d = np.arange(12.0).reshape(4, 3)
    native.write_csv(str(tmp_path / "f.csv"), d, header="a,b,c")
    np.testing.assert_array_equal(native.load_csv(str(tmp_path / "f.csv")),
                                  d)


def test_phase_timer(tmp_path):
    t = PhaseTimer()
    with t.span("a"):
        time.sleep(0.01)
    with t.span("a"):
        pass
    s = t.snapshot()["spans"]
    assert s["a"]["calls"] == 2 and s["a"]["host_s"] >= 0.01
    assert s["a"]["device_s"] is None and len(t.records()) == 2
    t.dump_json(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["spans"]["a"]["calls"] == 2


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 100


def test_device_trace_runs_the_block_when_the_profiler_is_busy(tmp_path):
    """A second scope inside a running one cannot start its profiler: it
    warns and the block still runs."""
    ran = []
    with device_trace(str(tmp_path / "outer")):
        with pytest.warns(UserWarning, match="did not start"):
            with device_trace(str(tmp_path / "inner")):
                ran.append(1)
    assert ran == [1] and not (tmp_path / "inner").exists()
