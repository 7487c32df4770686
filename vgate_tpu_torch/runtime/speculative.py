"""Speculative decoding: prompt-lookup and draft-model drafting, and the
acceptance count of a verify round (the reference's
vgate_tpu/runtime/speculative.py).

Drafts come from the sequence's own history (``NgramIndex``, no extra
weights) or from a small draft model (``DraftModelDrafter``); one
``spec_verify_forward`` pass (models/decoder.py) scores every draft at
once over the paged KV pools, through the multi-token kernel (K3) on the
card.  Rejected drafts need no KV rollback: their KV sits at positions
past the sequence's length, which every later attention masks out and
the next round overwrites.

Greedy rows accept a draft iff it is the verify pass's argmax, so the
output is the verify pass's own greedy trajectory (the verify pass and
the single-step decode are different programs, so an ulp-level logit
tie can in principle break differently between them).  Sampled rows
accept by rejection sampling (ops/sampling.py ``verify_and_sample``), so
every emitted token is p-distributed; a seeded request repeats from run
to run, but its trajectory differs from the non-speculative engine's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from vgate_tpu_torch.logging_config import get_logger

logger = get_logger(__name__)


class NgramIndex:
    """Incremental prompt-lookup index for one sequence: every
    ``ngram``-window of the history mapped to its most recent start,
    extended by only the windows added since the last call (a draft
    costs O(new tokens); preemption folds outputs into the prompt, but
    the concatenated token content, and so ``n_indexed``, stays valid)."""

    def __init__(self, ngram: int = 2) -> None:
        self.ngram = max(1, ngram)
        self.pos: dict = {}
        self.n_indexed = 0  # windows with start < n_indexed are indexed

    def draft(self, ids: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` tokens that followed the most recent earlier
        occurrence of the final ``ngram`` tokens; [] when the history is
        too short or the n-gram never recurred (the round is then a plain
        decode step)."""
        g = self.ngram
        n = len(ids)
        # index every complete window that ends before the final key
        # window; later occurrences overwrite earlier ones
        while self.n_indexed <= n - g - 1:
            i = self.n_indexed
            self.pos[tuple(ids[i : i + g])] = i
            self.n_indexed += 1
        if k <= 0 or n < g + 1:
            return []
        start = self.pos.get(tuple(ids[-g:]))
        if start is None:
            return []
        return list(ids[start + g : start + g + k])


def ngram_draft(ids: Sequence[int], k: int, ngram: int = 2) -> List[int]:
    """One-shot prompt lookup (the engine uses :class:`NgramIndex`)."""
    return NgramIndex(ngram).draft(ids, k)


def count_accepted(
    model_toks: torch.Tensor,  # [B, S] the model's token at each position
    tokens: torch.Tensor,  # [B, S] input: [current, draft_1, ...]
    input_lens: torch.Tensor,  # [B] 1 + number of real drafts per row
) -> torch.Tensor:
    """Leading-match acceptance count per row ([B] int32, on the
    tokens' device): draft ``tokens[:, j]`` (j >= 1) is accepted iff it
    equals ``model_toks[:, j-1]`` and every earlier draft was; rows with
    no draft return 0."""
    S = tokens.shape[1]
    idx = torch.arange(1, S, device=tokens.device)
    ok = (model_toks[:, :-1] == tokens[:, 1:]) & (
        idx[None, :] < input_lens[:, None]
    )
    # the cumulative product turns the run into 1, ..., 1, 0, 0: its sum
    # is the accepted prefix's length
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32
    )


class DraftModelDrafter:
    """Greedy draft-model drafting: a second, small model proposes up to
    ``k_max`` tokens a round from the last ``window`` tokens of the
    sequence (the reference's ``DraftModelDrafter``).

    Its draft scan is ``k_max`` prompt passes (models/decoder.py
    ``prefill_forward``, so K2 on the card) over the fixed window, each
    appending its argmax, which stays on the device; once the window is
    full it shifts left.  The window's fill level is known on the host,
    so the shifts need no readback: a draft call reads back once, its
    ``k_max`` tokens.  The KV pool is a scratch (pages of 8) that every
    pass overwrites: the drafter keeps no cache.  RoPE positions are
    window-relative, which is fine for a drafter (the target's verify
    pass uses absolute positions).

    Correctness does not depend on the drafter (the verify round accepts
    exactly the distribution-correct prefix of any proposal); a weak or
    mismatched drafter only lowers acceptance.  Drafted ids outside the
    target's vocabulary end the proposal.  The engine's drafter seam is
    per sequence, so a round with B sequences runs B draft scans."""

    def __init__(
        self,
        model_id: str,
        k_max: int,
        dtype: torch.dtype = torch.bfloat16,
        window: int = 128,
        checkpoint_path: Optional[str] = None,
        target_vocab: Optional[int] = None,
        device: torch.device | str = "cpu",
        target_has_checkpoint: bool = False,
    ) -> None:
        from vgate_tpu_torch.models.specs import spec_for_model_id
        from vgate_tpu_torch.runtime.weights import load_or_init_params
        from vgate_tpu_torch.utils.math import round_up

        if checkpoint_path is None and target_has_checkpoint:
            # a randomly initialized drafter next to real target weights
            # is rejected at nearly every position: speculation becomes a
            # pure slowdown
            logger.warning(
                "draft model %r has NO checkpoint "
                "(model.draft_checkpoint_path is unset) while the "
                "target model loads real weights: the randomly "
                "initialized drafter will be rejected at ~every "
                "position (~0%% acceptance) and speculative decoding "
                "becomes a pure slowdown — set "
                "model.draft_checkpoint_path or clear "
                "model.draft_model_id",
                model_id,
            )
        self.spec = spec_for_model_id(model_id)
        self.k_max = max(1, int(k_max))
        ps = 8  # the scratch pool's page size
        self.window = round_up(max(ps, int(window)), ps)
        self.target_vocab = int(target_vocab or self.spec.vocab_size)
        self.device = torch.device(device)
        self.params = load_or_init_params(
            self.spec, checkpoint_path, self.device, dtype
        )
        n_pages = 1 + self.window // ps
        kv_shape = (
            self.spec.num_layers, self.spec.num_kv_heads, n_pages, ps,
            self.spec.head_dim,
        )
        self._k_scratch = torch.zeros(kv_shape, dtype=dtype,
                                      device=self.device)
        self._v_scratch = torch.zeros_like(self._k_scratch)
        self._page_tables = torch.arange(
            1, 1 + self.window // ps, dtype=torch.int32, device=self.device
        )[None, :]
        self.total_draft_calls = 0

    def _upload(self, values: List[int]) -> torch.Tensor:
        t = torch.tensor(values, dtype=torch.int32)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _draft_scan(self, ids: List[int]) -> torch.Tensor:
        """``k_max`` greedy steps over the window holding ``ids`` (at most
        ``window`` of them); returns the [k_max] int32 tokens on the
        device."""
        from vgate_tpu_torch.models.decoder import prefill_forward

        W = self.window
        n0 = len(ids)
        # every step's fill level, known up front
        fills = [min(n0 + i, W) for i in range(self.k_max)]
        up = self._upload(ids + [0] * (W - n0) + fills)
        win, lens = up[:W], up[W:]
        toks = []
        for i in range(self.k_max):
            logits = prefill_forward(
                self.params, self.spec, win[None], lens[i : i + 1],
                self._k_scratch, self._v_scratch, self._page_tables,
            )
            t = torch.argmax(logits[0]).to(torch.int32)
            toks.append(t)
            if fills[i] >= W:  # full: shift left, append
                win = torch.cat([win[1:], t[None]])
            else:
                win = win.clone()
                win[fills[i]] = t
        return torch.stack(toks)

    def draft_for(self, seq, k: int) -> List[int]:
        """The engine's drafter seam (``Callable[[Sequence, int],
        List[int]]``): up to ``k`` (at most ``k_max``) proposed tokens."""
        k = min(int(k), self.k_max)
        if k <= 0:
            return []
        ids = list((seq.prompt_ids + seq.output_ids)[-self.window:])
        toks = self._draft_scan(ids).cpu().tolist()
        self.total_draft_calls += 1
        out: List[int] = []
        for t in toks[:k]:
            if not 0 <= int(t) < self.target_vocab:
                break  # drafter/target vocab mismatch: stop proposing
            out.append(int(t))
        return out
