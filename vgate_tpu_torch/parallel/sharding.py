"""The Megatron sharding rules over the serving mesh's ``tp`` axis.

The reference (vgate_tpu/parallel/sharding.py ``param_pspecs``) states
them as PartitionSpecs and lets GSPMD place the tree.  The port's rank
keeps its own slice of each leaf (:func:`shard_params`):

* q, k and v are column-parallel by whole heads (rank r holds query
  heads ``r*H/tp ..`` and kv heads ``r*KV/tp ..``, so a query head's kv
  head stays on its rank and G = H/KV is unchanged), their biases with
  their columns; gate and up are column-parallel over F;
* o and down are row-parallel (the all-reduces after them are in
  models/decoder.py);
* embed and lm_head are sharded over the vocab when tp divides V, and
  replicated otherwise, as the reference does;
* norms are replicated;
* the KV pool holds this rank's kv heads, ``[L, KV/tp, P, ps, hd]``
  (``kv_pspec``'s tp axis), through :func:`local_spec`.

The reference tests divisibility on the flattened ``KV * hd`` (its
``_spec``), so at tp 4 a 2-kv-head model splits inside a head and serves
through its jnp twins (``tp_divisible`` false).  The port shards whole
heads only: an H, KV or F that tp does not divide raises
:class:`NotPortedError` (kv-head replication is queue 1, item 10a's
rest).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vgate_tpu_torch.config import NotPortedError
from vgate_tpu_torch.models.specs import ModelSpec

# (axis a rank slices, that axis's full size): rank r keeps the r-th of tp
# equal parts, whole heads where the axis is ``heads * head_dim``
Rule = Tuple[int, int]


def check_tp(spec: ModelSpec, tp: int) -> None:
    """Refuse a tp the port cannot shard by whole heads and channels."""
    if tp <= 1:
        return
    for what, n in (("num_heads", spec.num_heads),
                    ("num_kv_heads", spec.num_kv_heads),
                    ("intermediate_size", spec.intermediate_size)):
        if n % tp:
            raise NotPortedError(
                f"{spec.name}: {what}={n} is not divisible by device.tp="
                f"{tp}; the port shards whole heads and FFN channels only "
                "(kv-head replication is not ported yet, ROADMAP queue 1, "
                "item 10a (rest))"
            )


def _not_ported(what: str, item: str) -> NotPortedError:
    return NotPortedError(
        f"{what} under device.tp>1 is not ported yet (ROADMAP queue 1, "
        f"item {item})"
    )


def check_tp_config(config, spec: ModelSpec, tp: int) -> None:
    """What a model-parallel mesh of ``tp`` refuses, at config load and
    again at the engine: the reference's plain-mesh errors for int8 KV
    pools and the host swap tier (vgate_tpu/runtime/engine_core.py),
    then the port's own, each citing its ROADMAP item."""
    check_tp(spec, tp)
    bad = {"tp": tp}
    if config.kv_cache.dtype == "int8":
        raise ValueError(
            f"kv_cache.dtype=int8 requires a plain mesh, got "
            f"{bad}: the quantized pool is a (data, scale) pair "
            "the sp/pp relays and tp shard_map kernels do not "
            "thread — dp composes (each replica owns its pool)"
        )
    if int(config.kv_cache.host_swap_bytes) > 0:
        raise ValueError(
            f"kv_cache.host_swap_bytes requires a plain mesh, "
            f"got {bad}: the swap gather/scatter indexes "
            "pages globally across an unsharded pool — dp "
            "composes (each replica owns its pool + host tier)"
        )
    if spec.is_moe:
        raise _not_ported("MoE", "10c")
    if config.model.quantization:
        raise _not_ported(
            f"model.quantization={config.model.quantization}", "10c"
        )
    if config.device.speculative_k > 0:
        raise _not_ported("speculative decoding", "10d")
    if config.pod.workers > 0:
        raise _not_ported("pod.workers>0", "10a (rest)")


def vocab_parallel(spec: ModelSpec, tp: int) -> bool:
    """embed and lm_head are sharded over the vocab (else replicated)."""
    return tp > 1 and spec.vocab_size % tp == 0


def leaf_rules(spec: ModelSpec, tp: int) -> Dict[Tuple[str, ...], Rule]:
    """``{path: (axis, size of the whole axis)}`` of every sharded leaf
    of the port's tree (``models/decoder.py`` ``init_params``); the rest
    is replicated."""
    Q, KVD, F = spec.q_dim, spec.kv_dim, spec.intermediate_size
    rules: Dict[Tuple[str, ...], Rule] = {
        ("layers", "q", "w"): (2, Q),
        ("layers", "k", "w"): (2, KVD),
        ("layers", "v", "w"): (2, KVD),
        ("layers", "o", "w"): (1, Q),
        ("layers", "gate", "w"): (2, F),
        ("layers", "up", "w"): (2, F),
        ("layers", "down", "w"): (1, F),
    }
    if spec.qkv_bias:
        rules[("layers", "q", "b")] = (1, Q)
        rules[("layers", "k", "b")] = (1, KVD)
        rules[("layers", "v", "b")] = (1, KVD)
    if vocab_parallel(spec, tp):
        rules[("embed",)] = (0, spec.vocab_size)
        if not spec.tie_embeddings:
            rules[("lm_head",)] = (1, spec.vocab_size)
    return rules


def shard_leaf(path: Tuple[str, ...], leaf: torch.Tensor, spec: ModelSpec,
               tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of one leaf (a contiguous copy, so the full
    leaf can be freed), or the leaf itself where it is replicated."""
    rule = leaf_rules(spec, tp).get(tuple(path)) if tp > 1 else None
    if rule is None:
        return leaf
    axis, size = rule
    if leaf.shape[axis] != size:
        raise ValueError(
            f"leaf {'/'.join(path)} has {leaf.shape[axis]} along axis "
            f"{axis}, not {size}: is it sharded already?"
        )
    part = size // tp
    return leaf.narrow(axis, rank * part, part).contiguous()


def shard_params(params: Dict[str, Any], spec: ModelSpec, mesh
                 ) -> Dict[str, Any]:
    """``mesh.rank``'s shard of a full tree (``param_pspecs``' rules over
    ``mesh.tp``), a leaf at a time: each full leaf is dropped from
    ``params`` as soon as its slice exists, so the two never both sit
    whole in memory."""
    check_tp(spec, mesh.tp)
    if mesh.tp == 1:
        return params

    def walk(node: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
        out = {}
        for key in list(node):
            value = node.pop(key)
            if isinstance(value, dict):
                out[key] = walk(value, path + (key,))
            else:
                out[key] = shard_leaf(path + (key,), value, spec, mesh.tp,
                                      mesh.rank)
        return out

    return walk(params, ())


def leaf_keeper(spec: ModelSpec, tp: int, rank: int
                ) -> Optional[Callable[[Tuple[str, ...], torch.Tensor],
                                       torch.Tensor]]:
    """The hook ``init_params`` calls on each leaf as it is drawn (None
    at tp 1): the rank keeps its slice, and the full draw is freed."""
    if tp <= 1:
        return None
    check_tp(spec, tp)
    return lambda path, leaf: shard_leaf(path, leaf, spec, tp, rank)


def local_spec(spec: ModelSpec, tp: int, mesh=None) -> ModelSpec:
    """The spec a rank's forwards and pools run on: H/tp query heads,
    KV/tp kv heads and F/tp FFN channels (``_project_qkv``'s reshape then
    needs no other change), the vocab whole (the logits are gathered),
    and the mesh whose device group the forwards' collectives use."""
    check_tp(spec, tp)
    if tp <= 1:
        return spec
    return dataclasses.replace(
        spec,
        num_heads=spec.num_heads // tp,
        num_kv_heads=spec.num_kv_heads // tp,
        intermediate_size=spec.intermediate_size // tp,
        mesh=mesh,
    )
