"""Static configuration of the PyTorch port.

Counterpart of ``flashmoe_tpu/config.py:69-560``.  That ``MoEConfig``
imports ``jax.numpy`` for its dtype fields, so the port keeps its own
frozen dataclass with torch dtypes.  It carries only the fields that the
ported slices read (one device, both MoE arms with their gather-fused
inference form, routing statistics, tier-0 degradation and hot-expert
replicas, the transformer, greedy generation and training) and validates
them with the same errors.  Expert parallelism (``ep``) carries its
transport knobs (``moe_backend``, ``a2a_chunks``, the wire dtypes and
``fused_schedule``) with JAX's defaults and checks; ``moe_backend``
'ragged' and 'auto' raise ``ValueError`` naming the ROADMAP item that
ports them.  Quantized expert storage (``expert_quant``, ``quant/``) is
checked as JAX checks it: an unknown store name, a training config and
``tp > 1`` are refused.  Knobs of later slices are absent:
``kv_wire_dtype``, ``serving_mode`` and ``profile_phases``; any other
parallel axis above 1 raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import dataclasses
import math

import torch


class Activation:
    """Activation selector, the same names as the JAX package."""

    RELU = "relu"
    GELU = "gelu"  # tanh approximation, as jax.nn.gelu's default
    SILU = "silu"


# parallel axes of the JAX config that the port does not run yet, with the
# ROADMAP queue-A item that ports them
_UNPORTED_AXES = {
    "dp": "A.8 (trainer and runtime)",
    "tp": "A.4 (tensor-parallel experts in _ep_moe_shard)",
    "sp": "A.7 (ring attention over the sp axis)",
    "pp": "A.7 (pipeline parallelism)",
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Frozen model/job configuration (field names as in the JAX package)."""

    # --- expert shape ---
    num_experts: int = 8
    expert_top_k: int = 2
    hidden_size: int = 1024
    intermediate_size: int = 4096
    gated_ffn: bool = False
    hidden_act: str = Activation.GELU
    num_shared_experts: int = 0

    # --- tokens and capacity ---
    sequence_len: int = 128
    mini_batch: int = 1
    capacity_factor: float = 1.25
    drop_tokens: bool = True
    is_training: bool = False

    # --- model shape ---
    num_layers: int = 2
    moe_frequency: int = 1
    vocab_size: int = 32000
    num_heads: int = 8
    num_kv_heads: int = 0  # 0 => num_heads (MHA); < num_heads => GQA
    head_dim: int = 0  # 0 => hidden_size // num_heads
    rope_theta: float = 10000.0

    # --- layer options (ops/stats.py, ops/health.py, ops/gate.py) ---
    collect_stats: bool = False
    degrade_unhealthy_experts: bool = False
    # (hot, slot) pairs: tokens routed to ``hot`` alternate with its
    # value-identical replica ``slot`` by token parity
    expert_replicas: tuple = ()
    # inference through the gather-fused FFN; None follows
    # FLASHMOE_GATHER_FUSED=1 (ops/moe.py)
    gather_fused: bool | None = None

    # --- losses ---
    aux_loss_coef: float = 0.01
    router_z_loss_coef: float = 0.0

    # --- numerics ---
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    # --- expert-parallel transport (parallel/ep.py, parallel/fused.py) ---
    # "collective" (the exchange as all-to-alls around B2) or "fused"
    # (the single B5 kernel); "ragged" and "auto" are refused until
    # their ROADMAP items port them
    moe_backend: str = "collective"
    # chunked exchange pipeline over the local-expert axis; None = serial
    a2a_chunks: int | None = None
    # wire dtypes of the dispatch leg, the return leg and the cross-slice
    # hop (ops/wire.py): None = raw, "bf16", "e4m3", "e5m2"
    wire_dtype: str | None = None
    wire_dtype_combine: str | None = None
    wire_dtype_dcn: str | None = None
    # processing order of the fused kernel: None = auto, or "stream",
    # "resident", "batched", "rowwin" (parallel/fused.py)
    fused_schedule: str | None = None

    # --- quantized expert storage (quant/) ---
    # None = off, or "int8" / "e4m3" (aliases in quant/core.py): expert
    # FFN weights stored as 1-byte payloads with f32 scales
    expert_quant: str | None = None

    # --- parallel axes (ep and 1 of each other are ported) ---
    dp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    def __post_init__(self):
        if self.num_experts < 1:
            raise ValueError("num_experts must be >= 1")
        if not (1 <= self.expert_top_k <= self.num_experts):
            raise ValueError("expert_top_k must be in [1, num_experts]")
        if self.hidden_size % 64:
            raise ValueError("hidden_size must be a multiple of 64")
        if self.intermediate_size % 64:
            raise ValueError("intermediate_size must be a multiple of 64")
        if self.num_experts > 1 and self.num_experts % self.ep:
            raise ValueError("num_experts must divide evenly over ep")
        if self.capacity_factor <= 0:
            raise ValueError("capacity_factor must be > 0")
        self._check_transport()
        if self.expert_quant is not None:
            self._check_quant()
        if self.hidden_act not in (Activation.RELU, Activation.GELU,
                                   Activation.SILU):
            raise ValueError(f"hidden_act {self.hidden_act!r} not in "
                             f"('relu', 'gelu', 'silu')")
        if self.expert_replicas:
            self._check_replicas()
        for axis, item in _UNPORTED_AXES.items():
            if getattr(self, axis) != 1:
                raise NotImplementedError(
                    f"{axis}={getattr(self, axis)}: the PyTorch port runs on "
                    f"one device; {axis} > 1 waits for ROADMAP {item}")

    def _check_transport(self) -> None:
        """The JAX package's checks of the expert-parallel knobs, with its
        errors; the backends the port does not run yet are refused."""
        if self.moe_backend not in ("collective", "fused", "ragged",
                                    "auto"):
            raise ValueError(
                f"moe_backend {self.moe_backend!r} not in "
                f"('collective', 'fused', 'ragged', 'auto')")
        if self.fused_schedule not in (None, "batched", "resident",
                                       "stream", "rowwin"):
            raise ValueError(
                f"fused_schedule {self.fused_schedule!r} not in "
                f"(None, 'batched', 'resident', 'stream', 'rowwin')")
        if self.moe_backend in ("fused", "ragged") and self.tp > 1:
            raise ValueError(
                f"moe_backend={self.moe_backend!r} does not compose with "
                f"tp>1; use moe_backend='collective'")
        if self.moe_backend == "ragged":
            raise ValueError(
                "moe_backend='ragged' is not ported yet: it waits for "
                "ROADMAP A.4's remainder (ragged_ep.py); use 'collective' "
                "or 'fused'")
        if self.moe_backend == "auto":
            raise ValueError(
                "moe_backend='auto' is not ported yet: it waits for "
                "ROADMAP A.10 (the planner); use 'collective' or 'fused'")
        from flashmoe_tpu_torch.ops import wire as _wire

        for knob in ("wire_dtype", "wire_dtype_combine", "wire_dtype_dcn"):
            val = getattr(self, knob)
            if val is None:
                continue
            wd = _wire.resolve(val)  # ValueError on unknown names
            if wd.itemsize > self.dtype.itemsize:
                raise ValueError(
                    f"{knob}={val!r} ({wd.itemsize} B) is wider than the "
                    f"compute dtype {self.dtype} ({self.dtype.itemsize} "
                    f"B); a wire must compress, not inflate")
        if self.a2a_chunks is not None:
            n = self.a2a_chunks
            if not isinstance(n, int) or n < 1:
                raise ValueError(
                    f"a2a_chunks={n!r} must be a positive int (or None "
                    f"for the serial schedule)")
            nlx = self.num_experts // max(self.ep, 1)
            if n > 1 and (nlx == 0 or nlx % n):
                raise ValueError(
                    f"a2a_chunks={n} must divide the local-expert axis "
                    f"(num_experts // ep = {nlx}); pick a divisor or "
                    f"leave a2a_chunks=None for the serial schedule")
        if ((self.wire_dtype or self.wire_dtype_combine
                or self.wire_dtype_dcn) and self.moe_backend == "fused"):
            raise ValueError(
                "wire-dtype compression rides the collective transport; "
                "moe_backend='fused' moves raw slabs in-kernel: use "
                "'collective'")

    def _check_quant(self) -> None:
        """The JAX package's checks of ``expert_quant``, with its errors."""
        from flashmoe_tpu_torch.quant import core as _qcore

        _qcore.resolve(self.expert_quant)  # ValueError on unknown names
        if self.is_training:
            raise ValueError(
                "expert_quant is post-training (inference-only): "
                "jnp.round has no useful gradient, so a quantized "
                "training step would silently learn nothing — "
                "train at full precision and quantize_state() the "
                "checkpoint")
        if self.tp > 1:
            raise ValueError(
                "expert_quant does not compose with tp>1 (the "
                "Megatron intermediate split would shard w_up's "
                "per-output-channel scales); use tp=1")

    def _check_replicas(self) -> None:
        """The JAX package's checks of the replica map, with its errors."""
        if not isinstance(self.expert_replicas, tuple):
            raise ValueError(
                f"expert_replicas must be a tuple of (hot, slot) "
                f"pairs, got {type(self.expert_replicas).__name__}")
        seen_slots: set = set()
        hots = set()
        for pair in self.expert_replicas:
            if (not isinstance(pair, tuple) or len(pair) != 2
                    or not all(isinstance(v, int) for v in pair)):
                raise ValueError(
                    f"expert_replicas entries must be (hot, slot) "
                    f"int pairs, got {pair!r}")
            hot, slot = pair
            if hot == slot:
                raise ValueError(
                    f"expert_replicas pair {pair} replicates an "
                    f"expert onto its own slot")
            for v in pair:
                if not 0 <= v < self.num_experts:
                    raise ValueError(
                        f"expert_replicas id {v} out of range "
                        f"[0, {self.num_experts})")
            if slot in seen_slots:
                raise ValueError(
                    f"expert_replicas slot {slot} used as a replica "
                    f"target twice")
            if hot in hots:
                raise ValueError(
                    f"expert_replicas replicates expert {hot} "
                    f"twice; the parity split supports exactly one "
                    f"replica per hot expert")
            seen_slots.add(slot)
            hots.add(hot)
        if hots & seen_slots:
            raise ValueError(
                f"expert_replicas chains a replica "
                f"({sorted(hots & seen_slots)} appear as both hot "
                f"expert and replica slot)")

    @property
    def tokens(self) -> int:
        """S = sequence_len * mini_batch."""
        return self.sequence_len * self.mini_batch

    def capacity_for(self, tokens: int) -> int:
        """Expert capacity: CF * K * ceil(tokens / E) when dropping (floor
        of 8), else every token."""
        if not self.drop_tokens:
            return tokens
        return max(8, int(math.ceil(
            self.capacity_factor * self.expert_top_k
            * math.ceil(tokens / self.num_experts))))

    @property
    def resolved_num_kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def moe_layer_indices(self) -> tuple[int, ...]:
        """Which transformer layers carry an MoE FFN (vs dense)."""
        if self.num_experts <= 1:
            return ()
        f = max(1, self.moe_frequency)
        return tuple(i for i in range(self.num_layers) if (i + 1) % f == 0)

    def replace(self, **kw) -> "MoEConfig":
        return dataclasses.replace(self, **kw)
