"""The expert-parallel mesh of the port: D ranks over the ``ep`` axis.

Counterpart of ``flashmoe_tpu/parallel/mesh.py`` for the ``ep`` axis.
The layers (:mod:`flashmoe_tpu_torch.parallel.ep`,
:mod:`flashmoe_tpu_torch.parallel.fused`) write their per-rank
arithmetic once, over the list of ranks this process holds, and meet the
other ranks only through this class's exchange and reductions.  Two
kinds:

* :func:`local_mesh`: every rank in one process (on one device, or on the
  CPU as the tests run it).  An exchange is a transpose of the rank axes
  of the stacked per-rank tensors, a reduction a sum over the stack.
* :func:`process_mesh`: one rank per process over ``torch.distributed``
  (``all_to_all_single`` and ``all_reduce``; gloo on the CPU).

Expert leaves shard on axis 0; ``gate_w`` and the ``shared*`` leaves are
replicated (``flashmoe_tpu/parallel/fused.py:2223-2224``,
``flashmoe_tpu/parallel/mesh.py:61-104``).  Tokens shard on axis 0 in rank
order: a local mesh splits the global batch; a process mesh takes each
process's own shard and returns its own shard.
"""

from __future__ import annotations

import torch


def expert_sharded(name: str) -> bool:
    """Whether a MoE parameter leaf shards over ep (axis 0)."""
    return name != "gate_w" and not name.startswith("shared")


class Mesh:
    """``size`` ep ranks; this process holds ``ranks`` of them."""

    def __init__(self, size: int, ranks: tuple[int, ...], group=None,
                 device=None):
        if size < 1:
            raise ValueError(f"ep mesh size must be >= 1, got {size}")
        self.size = size
        self.ranks = ranks
        self.group = group
        self.device = device

    @property
    def is_local(self) -> bool:
        return self.group is None

    def __repr__(self) -> str:
        kind = "local" if self.is_local else "process"
        return f"Mesh({kind}, ep={self.size}, ranks={self.ranks})"

    # ---- placement -------------------------------------------------

    def split(self, x) -> list:
        """This process's token shards of ``x`` (axis 0): the global batch
        cut D ways on a local mesh, ``[x]`` (already the shard) on a
        process mesh."""
        if not self.is_local:
            return [x]
        if self.device is not None and x.device != self.device:
            raise ValueError(f"{self!r} holds its ranks on {self.device}, "
                             f"got tokens on {x.device}")
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} tokens do not split over "
                             f"ep={self.size}")
        return list(x.chunk(self.size))

    def join(self, shards: list):
        """Inverse of :meth:`split`."""
        return torch.cat(shards) if self.is_local else shards[0]

    def shard_params(self, params: dict) -> list[dict]:
        """Each held rank's view of a MoE parameter dict: expert leaves
        sliced to its ``num_experts // ep`` experts (views, no copy),
        the others shared."""
        out = []
        for r in self.ranks:
            p = {}
            for k, v in params.items():
                if expert_sharded(k):
                    if v.shape[0] % self.size:
                        raise ValueError(f"{k}: {v.shape[0]} experts do "
                                         f"not split over ep={self.size}")
                    n = v.shape[0] // self.size
                    v = v[r * n:(r + 1) * n]
                p[k] = v
            out.append(p)
        return out

    # ---- collectives -----------------------------------------------

    def all_to_all(self, ts: list, axis: int = 0, groups=None) -> list:
        """``jax.lax.all_to_all(t, split_axis=concat_axis=axis,
        tiled=False, axis_index_groups=groups)`` over the held ranks'
        tensors ``ts``: within each group (all ranks by default), the rank
        at position p receives at index q of ``axis`` what the group's
        q-th rank held at index p."""
        groups = groups or [list(range(self.size))]
        if self.is_local:
            out = [None] * self.size
            for g in groups:
                stacked = torch.stack([ts[r] for r in g])  # [G(src), ...]
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

    def psum(self, ts: list):
        """Sum over every rank of the held ranks' tensors (one tensor,
        the same on every rank)."""
        if self.is_local:
            return torch.stack(list(ts)).sum(0)
        import torch.distributed as dist

        out = ts[0].clone()
        dist.all_reduce(out, group=self.group)
        return out

    def pmean(self, ts: list):
        """Mean over every rank."""
        return self.psum(ts) / self.size


def local_mesh(ep: int, device=None) -> Mesh:
    """An ep world of ``ep`` virtual ranks in this process, all on
    ``device``: its layers refuse tokens elsewhere (None: the ranks live
    wherever the tokens do)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(ep, tuple(range(ep)), device=device)


def process_mesh(group=None) -> Mesh:
    """One ep rank per process: this process's rank in ``group`` (the
    default group when None) of an initialised ``torch.distributed``."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    return Mesh(size, (dist.get_rank(group),), group=group if group
                is not None else dist.group.WORLD)
