"""The pooled survey of a tiled configuration: N points as a grid of tiles,
each the frozen ``build_problem`` survey of N / tiles points (its own box,
its own field of four sources, its own fidelities) with a seed drawn from
the run's seed, shifted by whole tile widths. The pooled data keeps the
survey's density, so K's conditioning is that of one tile's. Nothing here
imports the program under test."""

from __future__ import annotations

import numpy as np

from benchmark.common import gen
from benchmark.common.problem import build_problem

_TILE = 6  # stream tag of the tiles' seeds (``common/gen`` uses 1-5)


def tile_seed(seed: int, t: int) -> int:
    """The ``build_problem`` seed of tile ``t`` of a run."""
    return int(gen.rng(seed, _TILE, t).integers(0, 2 ** 31 - 1))


def build_tiles(config: dict, seed: int):
    """(X float32 (N, D), fid int64 (N,), y float32 (N,)) of the
    configuration's ``tiles`` = [nx, ny] grid of ``build_problem``
    surveys, tile (i, j) shifted by (i, j) times ``tile_shift`` in x and
    y, in row-major tile order."""
    nx, ny = config["tiles"]
    n_tile = config["N"] // (nx * ny)
    if n_tile * nx * ny != config["N"]:
        raise ValueError(f"N={config['N']} is not {nx} x {ny} tiles")
    shift = np.asarray(config["tile_shift"], np.float32)
    Xs, fids, ys = [], [], []
    for t, (i, j) in enumerate((i, j) for i in range(nx) for j in range(ny)):
        X, fid, y, _, _ = build_problem(n_tile, 1, config["D"],
                                        seed=tile_seed(seed, t))
        X[:, 0] += i * shift[0]
        X[:, 1] += j * shift[1]
        Xs.append(X)
        fids.append(fid.astype(np.int64))
        ys.append(y)
    return np.concatenate(Xs), np.concatenate(fids), np.concatenate(ys)
