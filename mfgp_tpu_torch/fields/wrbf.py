"""Synthetic scalar fields: weighted radial point sources (counterpart of
``mfgp_tpu/fields/wrbf.py``).

The reference's WRBF field (reference/exploreSimSettings.py:74-86), the
random-field generator of the data pipeline (reference/measFieldData.py:
30-32) and the reader/writer of the ``FieldSettings<seed>.txt`` artifact
(reference/exploreSimSettings.py:40-72,103-107). A field is a tuple of
tensors on one device, the card unless the caller asks for the CPU; one
evaluation is a single (M, S) broadcast.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

from mfgp_tpu_torch.utils.device import CUDA, resolve


class WRBFField(NamedTuple):
    """``f(x) = sum_i L * exp(-(s * |(x - p_i) o w|)^2)``.

    p: (S, 3) source locations; L: amplitude; s: sharpness; w: (3,) axis
    weights (reference/exploreSimSettings.py:74-79)."""

    p: torch.Tensor
    L: torch.Tensor
    s: torch.Tensor
    w: torch.Tensor
    offset: float = 0.0

    def __call__(self, x) -> torch.Tensor:
        """Evaluate at (M, 3) points -> (M,), on the field's device and in
        its dtype. Accepts (3,) for one point."""
        x = torch.atleast_2d(torch.as_tensor(x, dtype=self.p.dtype,
                                             device=self.p.device))
        d = self.s * torch.linalg.vector_norm(
            (x[:, None, :] - self.p[None, :, :]) * self.w, dim=2)
        return torch.sum(self.L * torch.exp(-(d ** 2)), dim=1) + self.offset

    def column(self, x) -> torch.Tensor:
        """(M, 1)-shaped output, the reference's ``vectorWRBFField`` shape
        (reference/exploreSimSettings.py:82-86)."""
        return self(x)[:, None]

    def numpy(self, x) -> np.ndarray:
        """``self(x)`` as a host numpy array."""
        return self(x).detach().cpu().numpy()

    def point_fn(self):
        """Host-side ``f(x, y, z) -> float`` closure in plain numpy, for
        per-tick sensor reads where a device round trip per sample would be
        pure latency."""
        p = self.p.detach().cpu().numpy()
        L, s = float(self.L), float(self.s)
        w = self.w.detach().cpu().numpy()
        off = float(self.offset)

        def f(x, y, z):
            d = s * np.linalg.norm((np.array([x, y, z]) - p) * w, axis=1)
            return float(np.sum(L * np.exp(-(d ** 2))) + off)

        return f


def wrbf_from_numpy(p, L, s, w, offset: float = 0.0, device=CUDA,
                    dtype=torch.float64) -> WRBFField:
    """A field from numpy values (``np.asarray`` of each field of the JAX
    package's ``WRBFField``)."""
    z = dict(dtype=dtype, device=resolve(device))
    return WRBFField(*(torch.tensor(np.asarray(a), **z)
                       for a in (p, L, s, w)), offset=float(offset))


def default_sim_field(WS, max_depth, dtype=torch.float64,
                      device=CUDA) -> WRBFField:
    """The fixed 5-source sim field (reference/exploreSimSettings.py:100-101)."""
    xm, ym = WS[0][1], WS[1][1]
    p = [[0.7 * xm, 0.7 * ym, 0.5 * max_depth],
         [0.3 * xm, 0.2 * ym, max_depth],
         [0.1 * xm, 0.9 * ym, max_depth],
         [0.6 * xm, 0.1 * ym, 0.3 * max_depth],
         [0.1 * xm, 0.1 * ym, max_depth]]
    return wrbf_from_numpy(p, 10.0, 0.5, 0.5 * np.array([3.0, 2.0, 1.0]),
                           device=device, dtype=dtype)


def random_field(rng: np.random.Generator, WS, max_depth,
                 device=CUDA) -> WRBFField:
    """Random 5-source field with the reference pipeline's distributions
    (reference/measFieldData.py:30-31): uniform source placement (source 1
    pinned to the bottom, source 3 at 0.3*maxDepth), L ~ U(0,10),
    s ~ U(0,0.5), w ~ 0.5*U(0,5)^3.

    The draws come from the host numpy generator, in the JAX package's
    order, so one ``np.random.Generator`` state gives both packages the
    same field."""
    xm, ym = WS[0][1], WS[1][1]
    zs = [rng.random() * max_depth, max_depth, rng.random() * max_depth,
          0.3 * max_depth, rng.random() * max_depth]
    p = np.array([[rng.random() * xm, rng.random() * ym, z] for z in zs])
    L = 10 * rng.random()
    s = 0.5 * rng.random()
    w = 0.5 * np.array([5 * rng.random(), 5 * rng.random(), 5 * rng.random()])
    return wrbf_from_numpy(p, L, s, w, device=device)


def write_field_settings(path, field: WRBFField, WS=None, max_depth=None,
                         meas_noise=None):
    """Write a ``FieldSettings`` artifact in the reference's exact text
    format so its parsers/plotters can read it
    (reference/measFieldData.py:35-42)."""
    L = float(field.L)
    s = float(field.s)
    w = field.w.detach().cpu().numpy()
    p = field.p.detach().cpu().numpy()
    with open(path, "w") as f:
        f.write("Type: WRBFField\n")
        if WS is not None:
            f.write("WS: " + str(np.asarray(WS)) + "\n")
        if max_depth is not None:
            f.write("maxDepth: " + str(max_depth) + "\n")
        f.write("L,s,w: " + str((L, s, w)) + "\n")
        f.write("sources:\n" + str(p) + "\n")
        if meas_noise is not None:
            f.write("measNois:" + str(meas_noise) + "\n")


def parse_field_settings(path, device=CUDA) -> WRBFField:
    """Read a ``FieldSettings`` artifact (the port's, the JAX package's or
    the reference's).

    Same grammar as reference/exploreSimSettings.py:40-72: an ``L,s,w:``
    tuple line (parsed without ``eval``) and a ``sources:`` block of
    bracketed rows terminated by the next ``key:`` line."""
    with open(path) as f:
        lines = f.read().splitlines()
    lsw_line = next(l for l in lines if l.startswith("L,s,w:"))
    body = lsw_line.split(":", 1)[1].strip()
    nums = [float(v) for v in re.findall(r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", body)]
    L, s, w = nums[0], nums[1], np.array(nums[2:5])

    src_rows = []
    grab = False
    for line in lines:
        if line.strip().startswith("sources:"):
            grab = True
            tail = line.split(":", 1)[1].strip()
            if tail:
                src_rows.append(tail.replace("[", "").replace("]", ""))
            continue
        if grab:
            if re.match(r"^\w+:", line):
                break
            src_rows.append(line.replace("[", "").replace("]", ""))
    p = np.loadtxt("\n".join(r for r in src_rows if r.strip()).splitlines())
    return wrbf_from_numpy(np.atleast_2d(p), L, s, w, device=device)
