"""Disaggregated serving fabric.

Counterpart of ``flashmoe_tpu/fabric/``.  The single-engine serving stack
(:mod:`flashmoe_tpu_torch.serving`) decodes on one pool and computes
prefill inline between decode steps.  This package is its production
composition: prefill and decode run on separate Decider-priced pools
(:mod:`flashmoe_tpu_torch.serving.pools`), finished prefill pages stream
to the decode side through a DCN-priced KV handoff codec
(:mod:`~flashmoe_tpu_torch.fabric.handoff`) over an optional failable,
CRC-checked wire (:mod:`~flashmoe_tpu_torch.fabric.transport`), a
join-shortest-queue router with session affinity spreads requests over N
engine replicas (:mod:`~flashmoe_tpu_torch.fabric.router`), crashed or
stalled replicas migrate their requests, and a replicated front door
(:mod:`~flashmoe_tpu_torch.fabric.frontdoor`) holds the request
namespace under a fenced lease store
(:mod:`~flashmoe_tpu_torch.fabric.leasestore`).  ``FLASHMOE_MOCK_FABRIC``
(:mod:`~flashmoe_tpu_torch.fabric.topo`) blocks the rank world into
replicas.

Every replica is a full :class:`~flashmoe_tpu_torch.serving.engine.
ServingEngine` on the same parameter tensors and the same device (the
card unless the parameters were made on the CPU), and the handoff codec
is exact when off: with the wire off, a fabric drill's token streams
equal the single-pool engine's on the same seeded trace.
"""

from flashmoe_tpu_torch.fabric.engine import ServingFabric
from flashmoe_tpu_torch.fabric.frontdoor import FrontDoor, FrontDoorCluster
from flashmoe_tpu_torch.fabric.handoff import (
    KVHandoff, decode_kv_run, encode_kv_run,
)
from flashmoe_tpu_torch.fabric.leasestore import (
    HeartbeatConfig, HeartbeatPublisher, HeartbeatWatchdog, LeaseStore,
    StaleLeaseError,
)
from flashmoe_tpu_torch.fabric.router import ReplicaRouter
from flashmoe_tpu_torch.fabric.topo import fabric_world
from flashmoe_tpu_torch.fabric.transport import (
    HandoffTransport, HandoffTransportError, WIRE_MODES,
    wire_overhead_ms,
)
from flashmoe_tpu_torch.fabric.vclock import VirtualClock

__all__ = [
    "FrontDoor",
    "FrontDoorCluster",
    "HandoffTransport",
    "HandoffTransportError",
    "HeartbeatConfig",
    "HeartbeatPublisher",
    "HeartbeatWatchdog",
    "KVHandoff",
    "LeaseStore",
    "ReplicaRouter",
    "ServingFabric",
    "StaleLeaseError",
    "VirtualClock",
    "WIRE_MODES",
    "decode_kv_run",
    "encode_kv_run",
    "fabric_world",
    "wire_overhead_ms",
]
