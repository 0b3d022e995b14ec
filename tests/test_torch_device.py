"""Where the port's model classes put their data.

``MFGP``, ``MFGP.from_fidelity_lists`` (with ``stack_fidelity_lists``) and
``GP`` keep a tensor on its own device and put any other input (numpy
arrays, lists) on ``device``, which is the card unless the caller asks for
the CPU. Where torch has no CUDA device, a model built from numpy with no
``device`` raises rather than running on the CPU; with ``device="cpu"`` it
computes exactly what a model built from CPU tensors computes.
"""

import numpy as np
import pytest
import torch

from mfgp_tpu_torch.models import gp as tg
from mfgp_tpu_torch.models import mfgp as tm


def _problem(seed=0, N=24, F=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 5, (N, 3))
    fid = rng.integers(0, F, N)
    y = np.sin(X).sum(1) + 0.1 * rng.normal(size=N)
    return X, fid, y


def _build(ctor, to=lambda a: a, **kw):
    """One model of each constructor from the same numpy problem, its
    arrays passed through ``to``."""
    X, fid, y = _problem()
    if ctor == "MFGP":
        return tm.MFGP(to(X), to(fid), to(y), jitter=1e-6, **kw)
    if ctor == "GP":
        return tg.GP(to(X), to(y), jitter=1e-6, **kw)
    lists = [(to(X[fid == f]), to(y[fid == f])) for f in range(3)]
    return tm.MFGP.from_fidelity_lists([a for a, _ in lists],
                                       [b for _, b in lists], jitter=1e-6,
                                       **kw)


CTORS = ["MFGP", "GP", "from_fidelity_lists"]


@pytest.mark.parametrize("ctor", CTORS)
def test_numpy_built_model_goes_to_the_card(ctor):
    """No ``device``: the card where there is one, else an error, never a
    quiet CPU model."""
    if torch.cuda.is_available():
        m = _build(ctor)
        assert m.X.is_cuda and m.y.is_cuda and m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _build(ctor)


@pytest.mark.parametrize("ctor", CTORS)
def test_cpu_device_matches_tensor_built_model(ctor):
    """``device="cpu"`` on numpy gives the NLML and posterior of the model
    built from CPU tensors, bit for bit; later numpy data follows the
    model's device."""
    m = _build(ctor, device="cpu")
    ref = _build(ctor, to=torch.as_tensor)
    assert m.X.device.type == "cpu" and m.device == torch.device("cpu")
    assert m.log_likelihood() == ref.log_likelihood()
    Xq = np.random.default_rng(1).uniform(0, 5, (7, 3))
    for a, b in zip(m.predict(Xq), ref.predict(torch.as_tensor(Xq))):
        assert torch.equal(a, b)
    X, fid, y = _problem(seed=2)
    if ctor == "GP":
        m.set_XY(X, y)
    else:
        m.set_data(X, fid, y)
    assert m.X.device.type == "cpu" and m.y.device.type == "cpu"


def test_stack_fidelity_lists_devices():
    """Tensors keep their device; other inputs go to ``device``."""
    X, _, y = _problem()
    Xs, ys = [X[:10], X[10:]], [y[:10], y[10:]]
    Xc, fc, yc = tm.stack_fidelity_lists(Xs, ys, device="cpu")
    assert Xc.device.type == fc.device.type == yc.device.type == "cpu"
    assert torch.equal(Xc, torch.as_tensor(X))
    Xt, _ = tm.stack_fidelity_lists([torch.as_tensor(x) for x in Xs],
                                    device="cuda")
    assert Xt.device.type == "cpu"
