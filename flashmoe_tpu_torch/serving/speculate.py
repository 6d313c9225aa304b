"""Speculative multi-token decoding: the n-gram drafter.

Counterpart of ``flashmoe_tpu/serving/speculate.py`` (pure Python; the
port keeps its own copy).  A drafter proposes up to ``k`` continuation
tokens per active slot, the engine scores all ``k+1`` positions in one
paged forward (:func:`flashmoe_tpu_torch.serving.engine.
_paged_verify_step`), and a draft is accepted iff it equals the token
the engine's own sampler draws at that position.  The sampler keys each
draw on (request seed, token index), so only canonical tokens are ever
emitted: the stream equals non-speculative decode's for every
temperature / top-k / top-p arm, and drafting quality moves throughput
only.

The drafter is n-gram prompt lookup: each slot keeps a suffix-match
table over its own history (prompt + emitted), rebuilt from that
history, which is exactly what an evicted request's resumed prompt
carries, so speculation survives eviction with no extra state.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs, carried on ``ServeConfig.speculate`` (None =
    off: the plain one-token decode step).  Frozen and hashable, as
    ``ServeConfig`` is.

    ``draft_tokens``: drafts proposed per slot per step; the verify
    forward scores ``draft_tokens + 1`` positions.  ``ngram``: suffix
    length the prompt-lookup matches on.  ``source``: drafting backend
    — ``"ngram"`` today; the seam a draft model plugs into later.
    """

    draft_tokens: int = 3
    ngram: int = 2
    source: str = "ngram"

    def __post_init__(self):
        if self.draft_tokens < 1:
            raise ValueError(
                f"draft_tokens must be >= 1, got {self.draft_tokens}")
        if self.ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {self.ngram}")
        if self.source != "ngram":
            raise ValueError(
                f"unknown draft source {self.source!r} (only 'ngram' "
                f"prompt-lookup drafting exists today)")


class DraftState:
    """One slot's suffix-match table: host state alongside the block
    table.  ``index[suffix] -> continuation position`` of the LATEST
    occurrence, with the previous occurrence kept so the current
    suffix's own registration never proposes past the end of history.

    Deterministic by construction (pure function of the token history),
    and rebuilt from ``prompt + emitted`` on adoption — the same
    resumed-prompt invariant the eviction path already guarantees.
    """

    def __init__(self, spec: SpecConfig, tokens=()):
        self.spec = spec
        self.tokens: list[int] = []
        self._index: dict[tuple, int] = {}
        self._prev: dict[tuple, int] = {}
        self.extend(tokens)

    def extend(self, toks) -> None:
        for t in toks:
            self.tokens.append(int(t))
            n = self.spec.ngram
            pos = len(self.tokens)
            if pos >= n:
                key = tuple(self.tokens[pos - n:pos])
                old = self._index.get(key)
                if old is not None:
                    self._prev[key] = old
                self._index[key] = pos

    def sync(self, tokens) -> None:
        """Catch the table up to ``tokens`` (= prompt + emitted).  The
        history only ever grows by appends, so this is O(new)."""
        if len(tokens) < len(self.tokens):
            raise ValueError(
                "draft history shrank: the table must be rebuilt, not "
                "synced, after a prompt rewrite")
        self.extend(tokens[len(self.tokens):])

    def draft(self, k: int) -> list:
        """Up to ``k`` proposed continuation tokens: the tokens that
        followed the most recent PRIOR occurrence of the current
        ``ngram``-token suffix.  Empty when history is too short or the
        suffix never occurred before."""
        n = self.spec.ngram
        if len(self.tokens) < n or k < 1:
            return []
        key = tuple(self.tokens[-n:])
        cont = self._index.get(key)
        if cont == len(self.tokens):
            # the latest occurrence is the current suffix itself; use
            # the one before it (if any)
            cont = self._prev.get(key)
        if cont is None:
            return []
        return list(self.tokens[cont:cont + k])


def spec_stats_fields(drafted: int, accepted: int, steps: int) -> dict:
    """Normalized acceptance stats for flight records / summaries:
    ``accept_rate`` = accepted drafts / drafted, ``spec_tokens_per_step``
    = mean emitted per speculative step (the canonical token plus the
    accepted drafts)."""
    return {
        "spec_drafted": int(drafted),
        "spec_accepted": int(accepted),
        "accept_rate": (round(accepted / drafted, 6) if drafted else None),
        "spec_tokens_per_step": (round(1.0 + accepted / steps, 6)
                                 if steps else None),
    }
