"""Pipeline parallelism: the layer stack split over ``pp`` stages.

The reference (vgate_tpu/parallel/pipeline.py) runs a GPipe relay inside
one ``shard_map`` manual over its pp mesh axis, tp and ep automatic
inside a stage.  The port's stages are processes (parallel/mesh.py: at
tp = ep = 1 rank s is stage s), each holding its ``L/pp`` layers and
their pools (parallel/sharding.py ``local_spec``), and the relay is
point-to-point sends over the mesh's device group.  A stage that is
itself an ``ep x tp`` group runs its layers' tp and ep collectives on
its own groups; the hiddens, which its tp group holds replicated, travel
from each rank to the rank of the next stage at the same ep and tp
index (``stage_rank``), and stage 0's tp group gathers the logits:

* the batch splits into ``M`` microbatches (the reference's rule: ``M =
  pp`` when it divides ``B``, else 1), so on separate cards stage s works
  on microbatch m while stage s+1 works on m-1;
* stage 0 embeds the tokens; for each microbatch every stage takes the
  activations (stage 0 its embedding, the others from the previous
  stage: ``[mb, D]`` for a decode step, ``[mb, S, D]`` for a prompt
  pass), runs its layers (models/decoder.py ``decode_layers`` /
  ``prefill_layers``: K1 and K2 once a layer a microbatch) and sends
  them on;
* the last stage keeps each microbatch's hiddens (of a prompt, only each
  row's last real token) and sends the whole ``[B, D]`` back to stage 0
  over the ring's wrap-around link; stage 0 alone computes the logits,
  and it alone samples (runtime/engine_core.py).

Every stage posts its sends and receives in one fixed order: stage 0
sends each microbatch and then receives the hiddens, a middle stage
receives, computes and sends each microbatch in turn, and the last
stage receives and computes each and sends the hiddens once at the end.
No stage waits on a send to a peer that is itself waiting on a send, so
the order cannot deadlock even where a send waits for its receive
(NCCL), and the same order runs inside a captured decode graph.

Deliberate differences from the reference, each held by
tests/test_torch_pp.py: the logits are computed on stage 0 only (the
reference psum-broadcasts the hiddens and every stage computes them);
stages past 0 hold no embedding or head; bubble steps are not run at
all (the reference runs them into trash page 0, which here stays
zeros).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vgate_tpu_torch.models.decoder import (
    Params,
    _embed,
    _logits,
    decode_attn_inputs,
    decode_layers,
    prefill_layers,
)
from vgate_tpu_torch.models.specs import ModelSpec


def microbatches(B: int, pp: int) -> int:
    """The reference's ``_microbatches``: ``pp`` when it divides ``B``."""
    return pp if B % pp == 0 else 1


def _relay(
    params: Params,
    spec: ModelSpec,
    B: int,
    act_shape: tuple,
    device: torch.device,
    embed: Callable[[], torch.Tensor],
    run: Callable[[torch.Tensor, slice], torch.Tensor],
    last: Callable[[torch.Tensor, slice], torch.Tensor],
) -> Optional[torch.Tensor]:
    """This stage's part of one relay over ``B`` rows: ``embed()`` gives
    stage 0's ``[B, *act_shape]`` activations, ``run(h, rows)`` this
    stage's layers on a microbatch's, and ``last(h, rows)`` the ``[mb,
    D]`` hiddens the last stage keeps of its output.  Returns the ``[B,
    D]`` hiddens on stage 0, None on the others."""
    mesh = spec.pipeline
    stage, pp = mesh.pp_rank, mesh.pp
    M = microbatches(B, pp)
    mb = B // M
    # the activations travel in the model dtype (the norms' own)
    dtype = params["layers"]["input_norm"].dtype
    first, final = stage == 0, stage == pp - 1
    x = embed() if first else None
    hidden = (torch.empty((B, spec.hidden_size), dtype=dtype, device=device)
              if first or final else None)
    for m in range(M):
        rows = slice(m * mb, (m + 1) * mb)
        if first:
            h = x[rows]
        else:
            h = mesh.recv_prev(torch.empty((mb, *act_shape), dtype=dtype,
                                           device=device))
        h = run(h, rows)
        if final:
            hidden[rows] = last(h, rows)
        else:
            mesh.send_next(h.contiguous())
    if final:
        mesh.send_first(hidden)
        return None
    return mesh.recv_last(hidden) if first else None


def pp_prefill_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B, S]
    seq_lens: torch.Tensor,  # [B]
    k_pages,  # this stage's [L/pp, KV, P, ps, hd], updated in place
    v_pages,
    page_tables: torch.Tensor,  # [B, S // ps]
) -> Optional[torch.Tensor]:
    """The prompt pass through the relay; the contract of models/
    decoder.py ``prefill_forward`` on stage 0 (the last real token's fp32
    logits), None on the other stages, which write their layers' KV."""
    B, S = tokens.shape

    def run(h, rows):
        return prefill_layers(params, spec, h, seq_lens[rows], k_pages,
                              v_pages, page_tables[rows])

    def last(h, rows):
        lens = seq_lens[rows].long()
        idx = torch.clamp(lens - 1, 0, S - 1)
        return h[torch.arange(h.shape[0], device=h.device), idx]

    hidden = _relay(params, spec, B, (S, spec.hidden_size), tokens.device,
                    lambda: _embed(params, spec, tokens), run, last)
    return None if hidden is None else _logits(params, spec, hidden)


def pp_decode_forward(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,  # [B] (read on stage 0 only)
    positions: torch.Tensor,  # [B]
    k_pages,  # this stage's [L/pp, KV, P, ps, hd], updated in place
    v_pages,
    page_tables: torch.Tensor,  # [B, pages_per_seq]
    active: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """One decode step through the relay; the contract of models/
    decoder.py ``decode_forward`` on stage 0 (fp32 logits [B, V]), None
    on the other stages, which write their layers' KV.  Every stage
    derives the step's KV targets from its own copy of the positions,
    tables and active mask (inactive slots write trash page 0)."""
    B = positions.shape[0]
    seq_lens, page_ids, page_off = decode_attn_inputs(
        positions, page_tables, active, k_pages.shape[3]
    )

    def run(h, rows):
        return decode_layers(params, spec, h, positions[rows], k_pages,
                             v_pages, page_tables[rows],
                             (seq_lens[rows], page_ids[rows],
                              page_off[rows]))

    hidden = _relay(params, spec, B, (spec.hidden_size,), positions.device,
                    lambda: _embed(params, spec, tokens), run,
                    lambda h, rows: h)
    return None if hidden is None else _logits(params, spec, hidden)
