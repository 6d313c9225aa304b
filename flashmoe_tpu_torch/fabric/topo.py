"""Mocked fabric topologies: ``FLASHMOE_MOCK_FABRIC`` world blocking.

Counterpart of ``flashmoe_tpu/fabric/topo.py``, with its errors word for
word.  The serving twin of ``FLASHMOE_MOCK_SLICES``
(:func:`flashmoe_tpu_torch.parallel.topology._mock_slices`): partition
the world into ``k`` equal contiguous replica blocks so multi-replica
fabric drills run without real multi-host serving.  A malformed mock
(non-integer, non-positive, or a count that does not divide a
multi-rank world) is a ``ValueError`` naming the world size and the
accepted format.  On a one-rank world any replica count co-locates on
that rank: replicas are full engines sharing the same parameter
tensors, not device partitions.

The world is the port's count of ranks (:func:`world_ranks`), where JAX
counts ``jax.devices()``: the bootstrapped runtime's ranks when
:func:`flashmoe_tpu_torch.runtime.bootstrap.initialize` has run (virtual
ranks of one card, priced on the ``"local"`` row), else the nodes of the
``torch.distributed`` world (one rank outside one).
"""

from __future__ import annotations

import os

#: the env var: a single positive replica count dividing the world size.
ENV_MOCK_FABRIC = "FLASHMOE_MOCK_FABRIC"


def world_ranks() -> tuple[list, str | None]:
    """(each rank's slice entry, the spec row its adjacency prices on):
    the live runtime's virtual ranks of one device on the ``"local"``
    row, or its process world's nodes; without a runtime, the
    ``torch.distributed`` world's nodes on this process's row."""
    from flashmoe_tpu_torch.parallel.topology import world_nodes
    from flashmoe_tpu_torch.runtime import bootstrap

    rt = bootstrap._runtime
    if rt is not None and rt.num_processes == 1:
        return [0] * int(rt.mesh.size), "local"
    return world_nodes(), None


def _mock_fabric(n: int) -> int | None:
    """Parse ``FLASHMOE_MOCK_FABRIC`` against a world of ``n`` ranks.

    Returns the replica count, or ``None`` when the mock is unset (or
    asks for a single replica: no blocking)."""
    raw = os.environ.get(ENV_MOCK_FABRIC)
    if raw is None or raw.strip() == "":
        return None
    try:
        replicas = int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_MOCK_FABRIC}={raw!r} is not an integer; the mock "
            f"format is a single positive replica count dividing the "
            f"world size ({n} devices), e.g. {ENV_MOCK_FABRIC}=2")
    if replicas < 1:
        raise ValueError(
            f"{ENV_MOCK_FABRIC}={replicas} must be >= 1 (a positive "
            f"replica count dividing the world size, {n} devices)")
    if replicas > 1 and n > 1 and n % replicas:
        raise ValueError(
            f"{ENV_MOCK_FABRIC}={replicas} does not divide the world "
            f"size ({n} devices); pick a divisor of {n} so every mocked "
            f"replica holds the same contiguous device block")
    return replicas if replicas > 1 else None


def fabric_world(n_devices: int | None = None) -> tuple[int, int]:
    """(replicas, ranks_per_replica) for the current (or given) world:
    the ``FLASHMOE_MOCK_FABRIC`` blocking when set, else one replica
    owning every rank."""
    if n_devices is None:
        n_devices = len(world_ranks()[0])
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"fabric world needs >= 1 device, got {n}")
    replicas = _mock_fabric(n) or 1
    return replicas, max(1, n // replicas)
