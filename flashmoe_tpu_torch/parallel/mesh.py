"""The port's device mesh: dp x pp x ep x tp x sp ranks.

Counterpart of ``flashmoe_tpu/parallel/mesh.py``.  The mesh has JAX's
five axes in JAX's order (:data:`AXES`, slowest first), and a rank's
number is its row-major index over them: on an ep x tp mesh (dp = pp =
sp = 1) rank ``r`` is ep rank ``r // tp`` and tp rank ``r % tp``.  The
layers (:mod:`flashmoe_tpu_torch.parallel.ep`,
:mod:`flashmoe_tpu_torch.parallel.ragged_ep`,
:mod:`flashmoe_tpu_torch.parallel.fused`) write their per-rank
arithmetic once, over the list of ranks this process holds, and meet the
other ranks only through this class's collectives, each by named axis:

* the ep all-to-all and all-gather run within each ep fibre (the ranks
  that share their dp, pp, tp and sp coordinates), the all-to-all in
  ``groups`` of ep ranks for the two-stage exchange;
* :meth:`Mesh.psum` / :meth:`Mesh.pmean` reduce over a tuple of axes,
  by default the mesh's token axes (JAX's ``reduce_axes`` /
  ``token_axes``);
* :meth:`Mesh.tp_psum` sums each tp fibre (the row-parallel down GEMM);
* :meth:`Mesh.ppermute` shifts a ring by one over sp or pp.

Tokens shard on axis 0 over the token axes jointly, in the order the
tuple gives them (:meth:`Mesh.over`; JAX's ``P(token_axes, None)``):
rank (d, e, s) of ``("dp", "ep", "sp")`` holds shard ``d * ep * sp + e
* sp + s``, and the ranks off the token axes hold replicas.  Expert
leaves shard over ep on axis 0; with a tp split each expert is also
Megatron-split as JAX's ``tp_specs`` (``flashmoe_tpu/parallel/ep.py:
493-499``).  The placement specs (:func:`moe_param_specs`,
:func:`transformer_param_specs`, :func:`token_spec`) are plain tuples of
axis names (or None) per dimension, equal to JAX's ``PartitionSpec``\\ s.

Two kinds of mesh:

* :func:`make_mesh` / :func:`local_mesh`: every rank in one process, on
  one device (or the CPU, as the tests run it).  An exchange is a
  transpose of the rank axes of the stacked per-rank tensors, a
  reduction a sum over the stack.
* :func:`process_mesh`: one ep rank per process over
  ``torch.distributed`` (``all_to_all_single``, ``all_gather`` and
  ``all_reduce``; gloo on the CPU).  Its other axes are 1: tp, dp, pp
  and sp across processes wait for the multi-GPU transport.
"""

from __future__ import annotations

import copy
import math

import torch

#: JAX's mesh axes, slowest first (``flashmoe_tpu/parallel/mesh.py:28``)
AXES = ("dp", "pp", "ep", "tp", "sp")

#: the expert leaves a tp split cuts, and the axis it cuts them on
TP_AXIS = {"w_up": -1, "w_gate": -1, "b_up": -1, "w_down": 1}

_TRANSPORT = ("waits for the ROADMAP item 'Blocked on hardware: the "
              "multi-GPU transport'")


def expert_sharded(name: str) -> bool:
    """Whether a MoE parameter leaf shards over ep (axis 0)."""
    return name != "gate_w" and not name.startswith("shared")


class Mesh:
    """``size`` = dp x pp x ep x tp x sp ranks (ep is what the other
    axes leave of ``size``); this process holds ``ranks`` of them."""

    def __init__(self, size: int, ranks: tuple[int, ...], group=None,
                 device=None, tp: int = 1, *, dp: int = 1, pp: int = 1,
                 sp: int = 1, token_axes: tuple[str, ...] = ("ep",)):
        if size < 1 or tp < 1 or size % tp:
            raise ValueError(f"a mesh of {size} ranks has no tp axis of "
                             f"{tp}")
        rest = dp * pp * tp * sp
        if min(dp, pp, sp) < 1 or size % rest:
            raise ValueError(f"a mesh of {size} ranks has no dp={dp} x "
                             f"pp={pp} x tp={tp} x sp={sp} axes")
        if group is not None and tp > 1:
            raise NotImplementedError(
                f"a process mesh with tp > 1 {_TRANSPORT}")
        if group is not None and max(dp, pp, sp) > 1:
            raise NotImplementedError(
                f"a process mesh holds one ep rank a process; dp, pp or "
                f"sp > 1 across processes {_TRANSPORT}")
        self.shape = {"dp": dp, "pp": pp, "ep": size // rest, "tp": tp,
                      "sp": sp}
        self.size = size
        self.dp, self.pp, self.ep, self.tp, self.sp = (
            self.shape[a] for a in AXES)
        self.ranks = ranks
        self.group = group
        self.device = device
        self.token_axes = _check_axes(token_axes)

    @property
    def is_local(self) -> bool:
        return self.group is None

    def __repr__(self) -> str:
        kind = "local" if self.is_local else "process"
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items()
                         if n > 1 or a == "ep")
        return f"Mesh({kind}, {axes}, ranks={self.ranks})"

    def over(self, token_axes: tuple[str, ...]) -> "Mesh":
        """This mesh with ``token_axes`` as the axes its tokens shard
        over and its reductions run over (JAX's ``token_axes``)."""
        m = copy.copy(self)
        m.token_axes = _check_axes(token_axes)
        return m

    # ---- coordinates -----------------------------------------------

    def coord(self, r: int, axis: str) -> int:
        """Rank ``r``'s coordinate on ``axis``."""
        inner = math.prod(self.shape[a] for a in AXES[AXES.index(axis)
                                                       + 1:])
        return r // inner % self.shape[axis]

    def index(self, r: int, axes: tuple[str, ...]) -> int:
        """Rank ``r``'s row-major index over ``axes``, in their order."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord(r, a)
        return i

    def fibres(self, axis: str) -> list[list[int]]:
        """The held ranks grouped by every coordinate but ``axis``'s,
        each group as positions in ``ranks`` ordered along ``axis``."""
        others = tuple(a for a in AXES if a != axis)
        groups: dict = {}
        for i, r in enumerate(self.ranks):
            groups.setdefault(self.index(r, others), []).append(i)
        return [sorted(g, key=lambda i: self.coord(self.ranks[i], axis))
                for _, g in sorted(groups.items())]

    def _leaders(self, axes: tuple[str, ...]) -> list[int]:
        """Positions of the held ranks at coordinate 0 on every axis but
        ``axes``, in rank order: one rank of each replica class."""
        return [i for i, r in enumerate(self.ranks)
                if all(self.coord(r, a) == 0 for a in AXES
                       if a not in axes)]

    def _size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.shape[a] for a in axes)

    # ---- placement -------------------------------------------------

    def split(self, x) -> list:
        """This process's token shards of ``x`` (axis 0), one per held
        rank: the global batch cut over the token axes (each shard
        repeated over the ranks off them) on a local mesh, ``[x]``
        (already the shard) on a process mesh."""
        if not self.is_local:
            return [x]
        if self.device is not None and x.device != self.device:
            raise ValueError(f"{self!r} holds its ranks on {self.device}, "
                             f"got tokens on {x.device}")
        n = self._size(self.token_axes)
        if x.shape[0] % n:
            over = " x ".join(f"{a}={self.shape[a]}"
                              for a in self.token_axes)
            raise ValueError(f"{x.shape[0]} tokens do not split over "
                             f"{over}")
        chunks = x.chunk(n)
        return [chunks[self.index(r, self.token_axes)] for r in self.ranks]

    def join(self, shards: list):
        """Inverse of :meth:`split` (the shards of the ranks at
        coordinate 0 off the token axes, in token order)."""
        if not self.is_local:
            return shards[0]
        lead = self._leaders(self.token_axes)
        lead.sort(key=lambda i: self.index(self.ranks[i], self.token_axes))
        return torch.cat([shards[i] for i in lead])

    def shard_params(self, params: dict) -> list[dict]:
        """Each held rank's view of a MoE parameter dict: expert leaves
        sliced to its ep rank's ``num_experts // ep`` experts (views, no
        copy), the others shared.  On a tp mesh the leaves of
        :data:`TP_AXIS` are cut further to the tp rank's 1/tp of each
        expert's intermediate dimension, as one contiguous copy each for
        the call (the kernels read their weights densely), shared by the
        ranks of the same (ep, tp) pair."""
        views: dict = {}
        out = []
        for r in self.ranks:
            key = (self.coord(r, "ep"), self.coord(r, "tp"))
            if key not in views:
                views[key] = self._shard(params, *key)
            out.append(views[key])
        return out

    def _shard(self, params: dict, e_rank: int, t_rank: int) -> dict:
        p = {}
        for k, v in params.items():
            if expert_sharded(k):
                if v.shape[0] % self.ep:
                    raise ValueError(f"{k}: {v.shape[0]} experts do "
                                     f"not split over ep={self.ep}")
                n = v.shape[0] // self.ep
                v = v[e_rank * n:(e_rank + 1) * n]
                if self.tp > 1 and k in TP_AXIS:
                    v = _tp_slice(k, v, t_rank, self.tp)
            p[k] = v
        return p

    # ---- collectives -----------------------------------------------

    def all_to_all(self, ts: list, axis: int = 0, groups=None) -> list:
        """``jax.lax.all_to_all(t, split_axis=concat_axis=axis,
        tiled=False, axis_index_groups=groups)`` over the ep axis, on the
        held ranks' tensors ``ts``: within each ep fibre and each group
        of its ep ranks (all by default), the rank at position p receives
        at index q of ``axis`` what the group's q-th rank held at index
        p."""
        groups = groups or [list(range(self.ep))]
        if self.is_local:
            out = [None] * len(ts)
            for fib in self.fibres("ep"):
                for g in groups:
                    g = [fib[q] for q in g]
                    stacked = torch.stack([ts[i] for i in g])  # [G(src), ..]
                    for p, i in enumerate(g):
                        out[i] = stacked.select(axis + 1, p).movedim(0, axis)
            return out
        return [self._all_to_all_process(ts[0], axis, groups)]

    def _all_to_all_process(self, t, axis, groups):
        import torch.distributed as dist

        me = self.ranks[0]
        g = next(g for g in groups if me in g)
        # exchanged as raw bytes: gloo has no fp8 types
        raw = t.contiguous().view(torch.uint8)
        chunks = [None] * self.size
        for q, r in enumerate(g):
            chunks[r] = raw.select(axis, q).contiguous()
        blk = chunks[me].numel()
        sizes = [blk if c is not None else 0 for c in chunks]
        send = torch.cat([c.reshape(-1) for c in chunks if c is not None])
        recv = torch.empty(blk * len(g), dtype=torch.uint8, device=t.device)
        dist.all_to_all_single(recv, send, output_split_sizes=sizes,
                               input_split_sizes=sizes, group=self.group)
        # the sources arrive in world-rank order; put them in group order
        got = recv.reshape(len(g), *chunks[me].shape).view(t.dtype)
        srt = sorted(g)
        return got[[srt.index(r) for r in g]].movedim(0, axis)

    def all_gather(self, ts: list) -> list:
        """``jax.lax.all_gather`` over the ep axis: every held rank gets
        its ep fibre's tensors stacked on a new axis 0."""
        if self.is_local:
            out = [None] * len(ts)
            for fib in self.fibres("ep"):
                stack = torch.stack([ts[i] for i in fib])
                for i in fib:
                    out[i] = stack
            return out
        import torch.distributed as dist

        got = [torch.empty_like(ts[0]) for _ in range(self.size)]
        dist.all_gather(got, ts[0].contiguous(), group=self.group)
        return [torch.stack(got)]

    def psum(self, ts: list, axes: tuple[str, ...] | None = None):
        """Sum over ``axes`` (by default the token axes) of the held
        ranks' tensors: one tensor, the same on every rank (the ranks off
        ``axes`` hold replicas, so those at coordinate 0 stand for
        them)."""
        axes = self.token_axes if axes is None else _check_axes(axes)
        if self.is_local:
            return torch.stack([ts[i] for i in self._leaders(axes)]).sum(0)
        import torch.distributed as dist

        out = ts[0].clone()
        dist.all_reduce(out, group=self.group)
        return out

    def pmean(self, ts: list, axes: tuple[str, ...] | None = None):
        """Mean over ``axes`` (by default the token axes)."""
        axes = self.token_axes if axes is None else _check_axes(axes)
        return self.psum(ts, axes) / self._size(axes)

    def tp_psum(self, ts: list) -> list:
        """Each held rank's tensor summed over its tp fibre (the row-
        parallel down GEMM's partial sums); the identity at tp 1."""
        if self.tp == 1:
            return list(ts)
        out = [None] * len(ts)
        for fib in self.fibres("tp"):
            s = torch.stack([ts[i] for i in fib]).sum(0)
            for i in fib:
                out[i] = s
        return out

    def ppermute(self, ts: list, axis: str, shift: int = 1) -> list:
        """The ring shift ``jax.lax.ppermute(t, axis, [(i, (i + shift) %
        n)])`` on one fibre of ``axis`` (sp or pp), held as the list of
        its n ranks' tensors: the rank at coordinate i receives what the
        rank at i - shift held."""
        if not self.is_local:
            raise NotImplementedError(f"a ring over {axis} across "
                                      f"processes {_TRANSPORT}")
        n = self.shape[axis]
        if len(ts) != n:
            raise ValueError(f"a ring over {axis}={n} takes {n} tensors, "
                             f"got {len(ts)}")
        return [ts[(i - shift) % n] for i in range(n)]


def _check_axes(axes) -> tuple[str, ...]:
    axes = tuple(axes)
    bad = [a for a in axes if a not in AXES]
    if bad or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} not distinct names of {AXES}")
    return axes


def _tp_slice(name: str, v, t_rank: int, tp: int):
    """Tp rank ``t_rank``'s contiguous slice of expert leaf ``name``."""
    ax = TP_AXIS[name] % v.dim()
    if v.shape[ax] % tp:
        raise ValueError(f"{name}: intermediate size {v.shape[ax]} does not "
                         f"split over tp={tp}")
    n = v.shape[ax] // tp
    return v.narrow(ax, t_rank * n, n).contiguous()


def _resolve_device(device):
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def local_mesh(ep: int, tp: int = 1, device=None) -> Mesh:
    """An ep x tp world of virtual ranks in this process (dp = pp = sp =
    1), all on ``device``: its layers refuse tokens elsewhere (None: the
    ranks live wherever the tokens do)."""
    return Mesh(ep * tp, tuple(range(ep * tp)),
                device=_resolve_device(device), tp=tp)


def make_mesh(cfg=None, *, dp=None, pp=None, ep=None, tp=None, sp=None,
              devices=None, device="cuda") -> Mesh:
    """``flashmoe_tpu/parallel/mesh.py:31``'s ``make_mesh`` over virtual
    ranks of one device: sizes default to the config's parallel fields
    (1 without one); ``devices`` is the number of ranks (an int, or a
    sequence whose length counts), by default the product of the sizes.
    Any remaining factor of it folds into dp unless dp is given, as in
    JAX, with JAX's error otherwise.  All ranks live on ``device``."""
    n = (len(devices) if devices is not None and not isinstance(devices, int)
         else devices)
    sizes = {a: (v if v is not None else (getattr(cfg, a) if cfg else 1))
             for a, v in zip(AXES, (dp, pp, ep, tp, sp))}
    used = math.prod(sizes.values())
    if n is None:
        n = used
    if dp is None and n % used == 0:
        # dp not pinned by the caller: fold the leftover rank factor in
        sizes["dp"] *= n // used
    elif n != used:
        raise ValueError(
            f"{n} devices don't match mesh {sizes}; pass devices= to "
            f"restrict, or leave dp unset to absorb the remainder"
        )
    return Mesh(n, tuple(range(n)), device=_resolve_device(device),
                tp=sizes["tp"], dp=sizes["dp"], pp=sizes["pp"],
                sp=sizes["sp"])


def process_mesh(group=None) -> Mesh:
    """One ep rank per process: this process's rank in ``group`` (the
    default group when None) of an initialised ``torch.distributed``.
    Its other axes are 1 (:class:`Mesh` refuses them across
    processes)."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    return Mesh(size, (dist.get_rank(group),), group=group if group
                is not None else dist.group.WORLD)


# ----------------------------------------------------------------------
# placement specs: tuples of axis names (or None) per dimension
# ----------------------------------------------------------------------

def moe_param_specs(cfg) -> dict:
    """``moe_param_specs`` (``mesh.py:58``): experts over ep, each
    expert's intermediate dimension over tp (column-parallel up,
    row-parallel down)."""
    ep_ax = "ep" if cfg.ep > 1 else None
    tp_ax = "tp" if cfg.tp > 1 else None
    specs = {
        "gate_w": (None, None),
        "w_up": (ep_ax, None, tp_ax),
        "b_up": (ep_ax, tp_ax),
        "w_down": (ep_ax, tp_ax, None),
        "b_down": (ep_ax, None),
    }
    if cfg.gated_ffn:
        specs["w_gate"] = (ep_ax, None, tp_ax)
    if cfg.num_shared_experts:
        specs["shared_w_up"] = (None, tp_ax)
        specs["shared_w_down"] = (tp_ax, None)
        if cfg.gated_ffn:
            specs["shared_w_gate"] = (None, tp_ax)
    return specs


def token_spec() -> tuple:
    """Activations (``mesh.py:86``): tokens over (dp, ep, sp) jointly,
    hidden replicated."""
    return (("dp", "ep", "sp"), None)


def transformer_param_specs(cfg) -> dict:
    """``transformer_param_specs`` (``mesh.py:106``): attention
    projections Megatron-split over tp, the lm head column-parallel over
    the vocab, MoE experts over ep."""
    tp_ax = "tp" if cfg.tp > 1 else None
    layer = {
        "attn_norm": (None,),
        "ffn_norm": (None,),
        "wq": (None, tp_ax),
        "wk": (None, tp_ax),
        "wv": (None, tp_ax),
        "wo": (tp_ax, None),
        "moe": moe_param_specs(cfg),
    }
    dense_moe = moe_param_specs(
        cfg.replace(num_experts=1, expert_top_k=1, num_shared_experts=0,
                    ep=1))
    moe_set = set(cfg.moe_layer_indices)
    return {
        "embed": (None, None),
        "final_norm": (None,),
        "lm_head": (None, tp_ax),
        "layers": [{**layer, "moe": layer["moe"] if li in moe_set
                    else dense_moe} for li in range(cfg.num_layers)],
    }


def place(v, spec: tuple, mesh: Mesh, r: int):
    """Rank ``r``'s block of ``v`` under ``spec``: each dimension named
    by axes cut over them jointly (row-major in the spec's order), as
    ``jax.device_put(v, NamedSharding(mesh, spec))`` leaves it on that
    rank's device (a view)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        ax = (ax,) if isinstance(ax, str) else tuple(ax)
        n = math.prod(mesh.shape[a] for a in ax)
        if v.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(v.shape)} does "
                             f"not split over {ax}")
        blk = v.shape[dim] // n
        v = v.narrow(dim, mesh.index(r, ax) * blk, blk)
    return v


def shard_params(params: dict, cfg, mesh: Mesh) -> list[dict]:
    """``shard_params`` (``mesh.py:97``) on a local mesh: each held
    rank's blocks of a MoE parameter dict under
    :func:`moe_param_specs`, in rank order."""
    specs = moe_param_specs(cfg)
    return [{k: place(v, specs[k], mesh, r) for k, v in params.items()}
            for r in mesh.ranks]
