"""Static configuration of the PyTorch port.

Counterpart of ``flashmoe_tpu/config.py:69-560``.  That ``MoEConfig``
imports ``jax.numpy`` for its dtype fields, so the port keeps its own
frozen dataclass with torch dtypes.  It carries only the fields that the
ported slices read (one device, both MoE arms with their gather-fused
inference form, routing statistics, tier-0 degradation and hot-expert
replicas, the transformer, greedy generation and training) and validates
them with the same errors.  Expert parallelism (``ep``, and ``tp``, the
Megatron split of each expert) carries its transport knobs
(``moe_backend``, ``a2a_chunks``, the wire dtypes and
``fused_schedule``) with JAX's defaults and checks;
``moe_backend='auto'`` constructs, and the layers resolve it through the
planner (:mod:`flashmoe_tpu_torch.planner.select`).  Quantized expert storage (``expert_quant``, ``quant/``)
is checked as JAX checks it: an unknown store name, a training config
and ``tp > 1`` are refused.  The mesh axes ``dp``, ``pp``,
``ep``, ``tp`` and ``sp`` carry no check of their own beyond JAX's (the
mesh and the layers raise on a geometry they cannot run, as in JAX).
Every field of JAX's config is here, so that a config file and
``api.get_compiled_config`` read as JAX's; the serving fabric's knobs
(``kv_wire_dtype``, the KV handoff's wire, and ``serving_mode``, the
planner's pricing mode) are checked as JAX checks them.
``profile_phases`` fences the EP layers' phases for the phase
profiler (:mod:`flashmoe_tpu_torch.profiler.spans`) and changes no
output.
``global_batch`` and ``router_jitter`` are carried as JAX carries them:
no layer reads them.
"""

from __future__ import annotations

import dataclasses
import json
import math

import torch


class Activation:
    """Activation selector, the same names as the JAX package."""

    RELU = "relu"
    GELU = "gelu"  # tanh approximation, as jax.nn.gelu's default
    SILU = "silu"


# the reference's ``torch_dtype`` codes (0 f32, 1 tf32, 2 bf16, 3 fp16)
# and names, mapped as ``flashmoe_tpu/config.py:46-62`` maps them: tf32
# and fp16 run as bf16
_DTYPE_MAP = {
    0: torch.float32, 1: torch.bfloat16, 2: torch.bfloat16,
    3: torch.bfloat16, "float32": torch.float32, "f32": torch.float32,
    "tf32": torch.bfloat16, "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16, "float16": torch.bfloat16,
    "fp16": torch.bfloat16,
}
_DTYPE_FIELDS = ("dtype", "param_dtype", "accum_dtype")


def dtype_from_name(name) -> torch.dtype:
    """A ``torch_dtype`` code or dtype name (``"bf16"``, ``"float32"``)
    as the torch dtype JAX's ``_DTYPE_MAP`` gives it."""
    return name if isinstance(name, torch.dtype) else _DTYPE_MAP[name]


def dtype_name(dt: torch.dtype) -> str:
    """A torch dtype's numpy-style name (``"bfloat16"``), as JAX writes
    ``jnp.dtype(d).name``."""
    return str(dt).removeprefix("torch.")


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
    global_batch: int = 1
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
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    router_z_loss_coef: float = 0.0

    # --- numerics ---
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    # --- expert-parallel transport (parallel/ep.py, parallel/fused.py) ---
    # "collective" (the exchange as all-to-alls around B2), "fused" (the
    # single B5 kernel), "ragged" (the dropless exchange of exactly the
    # routed rows) or "auto" (the planner's pick, planner/select.py)
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

    # --- parallel axes (mesh axis sizes; 1 = off) ---
    dp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    # --- the serving fabric: the KV handoff's wire, the pricing mode ---
    kv_wire_dtype: str | None = None
    serving_mode: str | None = None
    profile_phases: bool = False

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
        if self.serving_mode not in (None, "prefill", "decode"):
            raise ValueError(
                f"serving_mode {self.serving_mode!r} not in "
                f"(None, 'prefill', 'decode')")

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
        if self.moe_backend == "ragged" and self.num_shared_experts:
            raise ValueError(
                "moe_backend='ragged' does not support shared experts; "
                "use 'collective' or 'fused'")
        from flashmoe_tpu_torch.ops import wire as _wire

        for knob in ("wire_dtype", "wire_dtype_combine", "wire_dtype_dcn",
                     "kv_wire_dtype"):
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
    def param_count(self) -> int:
        """The dense parameter count the planner sizes a gradient
        all-reduce by (``flashmoe_tpu/config.py:518``)."""
        h, i, v, n = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        return v * h + n * (4 * h * h + 2 * h * i) + h * v

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

    # ------------------------------------------------------------------
    # IO (``flashmoe_tpu/config.py:534-556``)
    # ------------------------------------------------------------------

    @classmethod
    def from_json(cls, path_or_dict) -> "MoEConfig":
        """Load a reference-style ``flashmoe_config.json`` (a path or a
        dict): an int ``hidden_act`` (0 relu, else gelu), an int
        ``torch_dtype`` code or a dtype name, 0/1 booleans; unknown keys
        are ignored, as in JAX.  Also reads :meth:`to_json`'s output: its
        ``dtype``, ``param_dtype`` and ``accum_dtype`` names (``dtype``
        before ``torch_dtype``), and ``expert_replicas`` as pairs.  (JAX's
        own ``from_json`` raises on a file its ``to_json`` wrote: the
        ``dtype`` key reaches the constructor twice.)"""
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                raw = json.load(f)
        else:
            raw = dict(path_or_dict)
        act = raw.pop("hidden_act", 1)
        if isinstance(act, int):
            act = Activation.RELU if act == 0 else Activation.GELU
        code = raw.pop("torch_dtype", 2)
        kwargs = {k: v for k, v in raw.items()
                  if k in {f.name for f in dataclasses.fields(cls)}}
        kwargs["dtype"] = kwargs.get("dtype", code)
        for k in _DTYPE_FIELDS:
            if k in kwargs:
                kwargs[k] = dtype_from_name(kwargs[k])
        for b in ("drop_tokens", "is_training"):
            if b in kwargs:
                kwargs[b] = bool(kwargs[b])
        if "expert_replicas" in kwargs:
            kwargs["expert_replicas"] = tuple(
                tuple(p) for p in kwargs["expert_replicas"])
        return cls(hidden_act=act, **kwargs)

    def to_json(self) -> str:
        """Every field as JSON, dtypes by name (``"bfloat16"``), as
        JAX's ``to_json``."""
        d = dataclasses.asdict(self)
        for k in _DTYPE_FIELDS:
            d[k] = dtype_name(d[k])
        return json.dumps(d, indent=2)

    def replace(self, **kw) -> "MoEConfig":
        return dataclasses.replace(self, **kw)


# The benchmark configurations of ``flashmoe_tpu/config.py:563-600``, at
# the same values: the planner's golden tables and CLI price them.
BENCH_CONFIGS = {
    "tiny": MoEConfig(num_experts=8, expert_top_k=2, hidden_size=1024,
                      intermediate_size=4096, sequence_len=128),
    "token_scaling": MoEConfig(num_experts=64, expert_top_k=2,
                               hidden_size=4096, intermediate_size=4096,
                               sequence_len=4096, capacity_factor=1.0),
    "reference": MoEConfig(num_experts=64, expert_top_k=2, hidden_size=2048,
                           intermediate_size=2048, sequence_len=8192,
                           capacity_factor=1.0),
    "mixtral": MoEConfig(num_experts=8, expert_top_k=2, hidden_size=4096,
                         intermediate_size=14336, sequence_len=4096,
                         gated_ffn=True, hidden_act=Activation.SILU, ep=8),
    "deepseek": MoEConfig(num_experts=64, expert_top_k=6, hidden_size=2048,
                          intermediate_size=1408, sequence_len=4096,
                          num_shared_experts=2, gated_ffn=True,
                          hidden_act=Activation.SILU, ep=8),
    "weak_scaling_256": MoEConfig(num_experts=256, expert_top_k=2,
                                  hidden_size=2048, intermediate_size=2048,
                                  sequence_len=8192, capacity_factor=1.0,
                                  ep=256),
}
