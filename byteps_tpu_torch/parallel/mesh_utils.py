"""Mesh factorization and the training meshes over the host's process
group (the port of ``byteps_tpu/parallel/mesh_utils.py``).

``factorize_mesh`` is the reference's function.  ``make_training_mesh``
and ``make_hybrid_mesh`` lay the ranks of the host's group (the global
mesh ``init()`` brings up, or ``base``) out over named axes: rank r sits
where the reference puts device r, so the same axis sizes give the same
rank-to-coordinate map in both packages.  Each returns a
``comm.mesh.Mesh`` with one subgroup per axis line; every process of the
group calls it, in one order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from byteps_tpu_torch.comm.mesh import AXES, Mesh, layout, require_mesh


def factorize_mesh(n_devices: int, want: Sequence[str] = ("dp",)) -> Dict[str, int]:
    """Split ``n_devices`` into axis sizes, giving each axis of ``want``
    (priority order) a small prime factor in turn before growing any axis
    further; a large prime goes to the last axis.  Default: pure dp."""
    sizes = {ax: 1 for ax in want}
    remaining = n_devices
    while remaining > 1:
        progressed = False
        for ax in want:
            for p in (2, 3, 5, 7):
                if remaining % p == 0:
                    sizes[ax] *= p
                    remaining //= p
                    progressed = True
                    break
            if remaining == 1:
                break
        if not progressed:
            sizes[want[-1]] *= remaining
            remaining = 1
    return sizes


def _base(base: Optional[Mesh]) -> Mesh:
    return base if base is not None else require_mesh()


def make_training_mesh(
    n_devices: Optional[int] = None,
    axis_sizes: Optional[Dict[str, int]] = None,
    base: Optional[Mesh] = None,
    axis_order: Sequence[str] = AXES,
) -> Mesh:
    """The host's group as a 4-D training mesh (dp, pp, sp, tp): the ranks
    reshaped row-major to the axis sizes in ``axis_order`` (default
    ``factorize_mesh(n)``, pure dp).  ``n_devices`` must be the group's
    size."""
    base = _base(base)
    n = n_devices or base.size
    if n != base.size:
        raise ValueError(f"a training mesh of {n} ranks over a group of {base.size}")
    if axis_sizes is None:
        axis_sizes = factorize_mesh(n)
    shape = [axis_sizes.get(ax, 1) for ax in axis_order]
    if int(np.prod(shape)) != n:
        raise ValueError(f"axis sizes {axis_sizes} != {n} devices")
    return layout(base, np.arange(n).reshape(shape), axis_order)


def make_hybrid_mesh(
    ici: Dict[str, int],
    dcn: Dict[str, int],
    axis_order: Optional[Sequence[str]] = None,
    base: Optional[Mesh] = None,
) -> Mesh:
    """A two-level mesh: axis ``a`` has ``ici[a] * dcn[a]`` ranks, its
    ``dcn`` factor outer.  The ranks fall into granules of ``prod(ici)``
    consecutive ranks (a host's GPUs when one group spans hosts), laid out
    granule-major as ``jax.experimental.mesh_utils.create_hybrid_device_mesh``
    lays out processes' devices: granule g holds the ici block at the
    dcn coordinates g unravels to."""
    base = _base(base)
    if axis_order is None:
        seen = dict.fromkeys(AXES)
        for ax in list(ici) + list(dcn):
            seen.setdefault(ax)
        axis_order = [ax for ax in seen if ax in ici or ax in dcn]
    ici_shape = [ici.get(ax, 1) for ax in axis_order]
    dcn_shape = [dcn.get(ax, 1) for ax in axis_order]
    total = math.prod(ici_shape) * math.prod(dcn_shape)
    if total != base.size:
        raise ValueError(f"hybrid mesh ici={ici} × dcn={dcn} wants {total} devices, "
                         f"have {base.size}")
    # (dcn..., ici...) blocks, then each axis's dcn factor outside its ici one
    blocks = np.arange(total).reshape(dcn_shape + ici_shape)
    k = len(axis_order)
    inter = [i for pair in zip(range(k), range(k, 2 * k)) for i in pair]
    ranks = blocks.transpose(inter).reshape([d * i for d, i in zip(dcn_shape, ici_shape)])
    return layout(base, ranks, axis_order)
