"""The expert-parallel mesh of the port: ep x tp ranks.

Counterpart of ``flashmoe_tpu/parallel/mesh.py`` for the ``ep`` and
``tp`` axes.  The layers (:mod:`flashmoe_tpu_torch.parallel.ep`,
:mod:`flashmoe_tpu_torch.parallel.ragged_ep`,
:mod:`flashmoe_tpu_torch.parallel.fused`) write their per-rank
arithmetic once, over the list of ranks this process holds, and meet the
other ranks only through this class's exchanges and reductions.  Two
kinds:

* :func:`local_mesh`: every rank in one process (on one device, or on the
  CPU as the tests run it).  An exchange is a transpose of the rank axes
  of the stacked per-rank tensors, a reduction a sum over the stack.
* :func:`process_mesh`: one rank per process over ``torch.distributed``
  (``all_to_all_single``, ``all_gather`` and ``all_reduce``; gloo on the
  CPU).  It holds no tp axis: tp across processes waits for the
  multi-GPU transport.

Rank ``r`` of a local mesh is ep rank ``r // tp`` and tp rank ``r % tp``
(JAX's mesh axes put tp inside ep).  Expert leaves shard over ep on axis
0; with a tp split each expert is also Megatron-split as JAX's
``tp_specs`` (``flashmoe_tpu/parallel/ep.py:493-499``): ``w_up``,
``w_gate`` and ``b_up`` on their last axis, ``w_down`` on axis 1,
``b_down`` replicated.  ``gate_w`` and the ``shared*`` leaves are
replicated (``flashmoe_tpu/parallel/fused.py:2223-2224``,
``flashmoe_tpu/parallel/mesh.py:61-104``).  Tokens shard on axis 0 over
ep in rank order and are replicated across tp (JAX's
``token_axes=("ep",)``): a local mesh splits the global batch; a process
mesh takes each process's own shard and returns its own shard.  The
reductions of the layers' losses, counts and stats run over ep
(:meth:`Mesh.psum`, :meth:`Mesh.pmean`), the FFN's partial sums over tp
(:meth:`Mesh.tp_psum`).
"""

from __future__ import annotations

import torch

#: the expert leaves a tp split cuts, and the axis it cuts them on
TP_AXIS = {"w_up": -1, "w_gate": -1, "b_up": -1, "w_down": 1}


def expert_sharded(name: str) -> bool:
    """Whether a MoE parameter leaf shards over ep (axis 0)."""
    return name != "gate_w" and not name.startswith("shared")


class Mesh:
    """``size`` = ep x tp ranks; this process holds ``ranks`` of them."""

    def __init__(self, size: int, ranks: tuple[int, ...], group=None,
                 device=None, tp: int = 1):
        if size < 1 or tp < 1 or size % tp:
            raise ValueError(f"a mesh of {size} ranks has no tp axis of "
                             f"{tp}")
        if group is not None and tp > 1:
            raise NotImplementedError(
                "a process mesh with tp > 1 waits for the ROADMAP item "
                "'Blocked on hardware: the multi-GPU transport'")
        self.size = size
        self.tp = tp
        self.ep = size // tp
        self.ranks = ranks
        self.group = group
        self.device = device

    @property
    def is_local(self) -> bool:
        return self.group is None

    def __repr__(self) -> str:
        kind = "local" if self.is_local else "process"
        tp = f", tp={self.tp}" if self.tp > 1 else ""
        return f"Mesh({kind}, ep={self.ep}{tp}, ranks={self.ranks})"

    # ---- placement -------------------------------------------------

    def split(self, x) -> list:
        """This process's token shards of ``x`` (axis 0), one per held
        rank: the global batch cut ep ways (each shard repeated over its
        tp ranks) on a local mesh, ``[x]`` (already the shard) on a
        process mesh."""
        if not self.is_local:
            return [x]
        if self.device is not None and x.device != self.device:
            raise ValueError(f"{self!r} holds its ranks on {self.device}, "
                             f"got tokens on {x.device}")
        if x.shape[0] % self.ep:
            raise ValueError(f"{x.shape[0]} tokens do not split over "
                             f"ep={self.ep}")
        return [c for c in x.chunk(self.ep) for _ in range(self.tp)]

    def join(self, shards: list):
        """Inverse of :meth:`split` (tp rank 0's shard of each ep rank)."""
        return torch.cat(shards[::self.tp]) if self.is_local else shards[0]

    def shard_params(self, params: dict) -> list[dict]:
        """Each held rank's view of a MoE parameter dict: expert leaves
        sliced to its ``num_experts // ep`` experts (views, no copy), the
        others shared.  On a tp mesh the leaves of :data:`TP_AXIS` are
        cut further to the rank's 1/tp of each expert's intermediate
        dimension, as one contiguous copy each for the call (the kernels
        read their weights densely)."""
        out = []
        for r in self.ranks:
            e_rank, t_rank = divmod(r, self.tp)
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
            out.append(p)
        return out

    # ---- collectives -----------------------------------------------

    def all_to_all(self, ts: list, axis: int = 0, groups=None) -> list:
        """``jax.lax.all_to_all(t, split_axis=concat_axis=axis,
        tiled=False, axis_index_groups=groups)`` over the ep axis, on the
        held ranks' tensors ``ts``: within each group of ep ranks (all by
        default) and each tp rank, the rank at position p receives at
        index q of ``axis`` what the group's q-th rank held at index p."""
        groups = groups or [list(range(self.ep))]
        if self.is_local:
            out = [None] * self.size
            for t in range(self.tp):
                for g in groups:
                    g = [q * self.tp + t for q in g]
                    stacked = torch.stack([ts[r] for r in g])  # [G(src), ..]
                    for p, r in enumerate(g):
                        out[r] = stacked.select(axis + 1, p).movedim(0, axis)
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
        the ep ranks' tensors stacked on a new axis 0 (its own tp
        rank's)."""
        if self.is_local:
            stacks = [torch.stack(ts[t::self.tp]) for t in range(self.tp)]
            return [stacks[r % self.tp] for r in range(self.size)]
        import torch.distributed as dist

        got = [torch.empty_like(ts[0]) for _ in range(self.size)]
        dist.all_gather(got, ts[0].contiguous(), group=self.group)
        return [torch.stack(got)]

    def psum(self, ts: list):
        """Sum over the ep ranks of the held ranks' tensors (one tensor,
        the same on every rank; tp ranks hold replicas, so tp rank 0's
        stand for them)."""
        if self.is_local:
            return torch.stack(list(ts[::self.tp])).sum(0)
        import torch.distributed as dist

        out = ts[0].clone()
        dist.all_reduce(out, group=self.group)
        return out

    def pmean(self, ts: list):
        """Mean over the ep ranks."""
        return self.psum(ts) / self.ep

    def tp_psum(self, ts: list) -> list:
        """Each held rank's tensor summed over its tp group (the row-
        parallel down GEMM's partial sums); the identity at tp 1."""
        if self.tp == 1:
            return list(ts)
        out = []
        for e in range(self.ep):
            s = torch.stack(ts[e * self.tp:(e + 1) * self.tp]).sum(0)
            out += [s] * self.tp
        return out


def _tp_slice(name: str, v, t_rank: int, tp: int):
    """Tp rank ``t_rank``'s contiguous slice of expert leaf ``name``."""
    ax = TP_AXIS[name] % v.dim()
    if v.shape[ax] % tp:
        raise ValueError(f"{name}: intermediate size {v.shape[ax]} does not "
                         f"split over tp={tp}")
    n = v.shape[ax] // tp
    return v.narrow(ax, t_rank * n, n).contiguous()


def local_mesh(ep: int, tp: int = 1, device=None) -> Mesh:
    """An ep x tp world of virtual ranks in this process, all on
    ``device``: its layers refuse tokens elsewhere (None: the ranks live
    wherever the tokens do)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(ep * tp, tuple(range(ep * tp)), device=device, tp=tp)


def process_mesh(group=None) -> Mesh:
    """One ep rank per process: this process's rank in ``group`` (the
    default group when None) of an initialised ``torch.distributed``.
    It has no tp axis (:class:`Mesh` refuses one)."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    return Mesh(size, (dist.get_rank(group),), group=group if group
                is not None else dist.group.WORLD)
