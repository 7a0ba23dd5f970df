"""Device-mesh construction (component C20, SURVEY.md).

The reference (fedef17/SpectRobot) has NO distributed backend — a Python
``multiprocessing`` pool at most (SURVEY.md C19/C20).  The
equivalent here is the JAX runtime over the device interconnect: a named mesh with three axes,

    ray  — data parallelism over tangent heights / pixels  (C21)
    nu   — spectral-domain decomposition of the fine grid  (C22, the
           "tensor/sequence parallel" analog of BASELINE.json:5)
    line — line-list sharding, psum-reduced partial opacities (C23, the
           "expert parallel" analog)

Pipeline parallelism (C24) is an explicit non-goal: the stack has no deep
sequential structure — stages fuse instead.

Multi-host: initialise with ``jax.distributed.initialize()`` before building
the mesh; axis order below puts ``nu`` innermost so its halo/psum traffic
rides the fast in-host links (NVLink) while ``ray`` (pure DP, no communication inside a
step) spans the network across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("ray", "line", "nu")


def make_mesh(
    shape: Optional[Tuple[int, int, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build the (ray, line, nu) mesh.

    ``shape`` defaults to putting every device on the ``nu`` axis (the axis
    that always helps: the fine grid is the biggest dimension).  Total size
    must equal the device count.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (1, 1, n)
    assert int(np.prod(shape)) == n, (shape, n)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, AXES)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialise the multi-host JAX runtime (DCN tier, SURVEY.md section 6).

    Call ONCE per process before any mesh construction; with no arguments
    the cluster environment variables drive discovery (on a GPU host
    without a cluster manager pass coordinator_address, num_processes and
    process_id).  After this,
    ``jax.devices()`` spans the whole slice and :func:`make_mesh` shapes can
    use every chip — no other code changes (the collectives in
    parallel/sharded.py, halo.py and retrieval.py are axis-name based).
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
