"""The sharding rules over the serving mesh's ``tp`` and ``ep`` axes.

The reference (vgate_tpu/parallel/sharding.py ``param_pspecs``) states
them as PartitionSpecs and lets GSPMD place the tree.  The port's rank
keeps its own slice of each leaf (:func:`shard_params`):

* q, k and v are column-parallel by whole heads (rank r holds query
  heads ``r*H/tp ..`` and kv heads ``r*KV/tp ..``, so a query head's kv
  head stays on its rank and G = H/KV is unchanged), their biases with
  their columns; gate and up are column-parallel over F;
* o and down are row-parallel (the all-reduces after them are in
  models/decoder.py);
* MoE experts: the router ``[L, D, E]`` is replicated; gate and up
  ``[L, E, D, F]`` shard E over ep and F over tp, down ``[L, E, F, D]``
  E over ep and F over tp.  Attention, embed and lm_head follow the tp
  rules only and are replicated over ep;
* embed and lm_head are sharded over the vocab when tp divides V, and
  replicated otherwise, as the reference does;
* norms are replicated;
* the KV pool holds this rank's kv heads, ``[L, KV/tp, P, ps, hd]``
  (``kv_pspec``'s tp axis; it has no ep axis, so every ep rank holds the
  pool of its tp heads and runs attention redundantly), through
  :func:`local_spec`.

Quantized leaves (``QTensor``, ``PackedQTensor``) shard their values and
scales together: a column-parallel or expert slice takes the scale's
matching entries, a row-parallel one keeps the whole ``[.., out]`` scale,
and a row-parallel packed int4 leaf is repacked
(ops/quant.py ``shard_int4_rows``).  A tree is quantized whole before it
is sharded, as the reference places its tree and then quantizes it, so
every scale comes from the whole input axis.

The reference tests divisibility on the flattened ``KV * hd`` (its
``_spec``), so at tp 4 a 2-kv-head model splits inside a head and serves
through its jnp twins (``tp_divisible`` false).  The port shards whole
heads only: an H, KV or F that tp does not divide, or an E that ep does
not divide, raises :class:`NotPortedError` (kv-head replication is
queue 1, item 10a's rest).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from vgate_tpu_torch.config import NotPortedError
from vgate_tpu_torch.models.specs import ModelSpec
from vgate_tpu_torch.ops.quant import (
    BITS,
    EXPERT_PROJECTIONS,
    PackedQTensor,
    is_quantized_weight,
    quantize_leaf,
    shard_int4_rows,
)
from vgate_tpu_torch.parallel.mesh import AXIS_EP, AXIS_TP

# (axis a rank slices, that axis's full size, the mesh axis it shards
# over): rank r keeps the r-th of the axis's equal parts, whole heads
# where the axis is ``heads * head_dim``
Rule = Tuple[int, int, str]


def check_mesh(spec: ModelSpec, tp: int, ep: int = 1) -> None:
    """Refuse a tp the port cannot shard by whole heads and channels, and
    an ep that does not divide the experts."""
    if tp > 1:
        for what, n in (("num_heads", spec.num_heads),
                        ("num_kv_heads", spec.num_kv_heads),
                        ("intermediate_size", spec.intermediate_size)):
            if n % tp:
                raise NotPortedError(
                    f"{spec.name}: {what}={n} is not divisible by device.tp="
                    f"{tp}; the port shards whole heads and FFN channels "
                    "only (kv-head replication is not ported yet, ROADMAP "
                    "queue 1, item 10a (rest))"
                )
    if ep > 1 and spec.is_moe and spec.num_experts % ep:
        raise NotPortedError(
            f"{spec.name}: num_experts={spec.num_experts} is not divisible "
            f"by device.ep={ep}; each ep rank holds E/ep whole experts"
        )


def _not_ported(what: str, item: str) -> NotPortedError:
    return NotPortedError(
        f"{what} under a model-parallel mesh (device.tp or device.ep > 1) "
        f"is not ported yet (ROADMAP queue 1, item {item})"
    )


def check_mesh_config(config, spec: ModelSpec, tp: int, ep: int = 1) -> None:
    """What a model-parallel mesh of ``ep x tp`` refuses, at config load
    and again at the engine: the reference's plain-mesh errors for int8
    KV pools and the host swap tier (vgate_tpu/runtime/engine_core.py),
    then the port's own, each citing its ROADMAP item."""
    check_mesh(spec, tp, ep)
    bad = {k: v for k, v in (("tp", tp), ("ep", ep)) if v > 1}
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
    if config.device.speculative_k > 0:
        raise _not_ported("speculative decoding", "10d")
    if config.pod.workers > 0:
        raise _not_ported("pod.workers>0", "10a (rest)")


def vocab_parallel(spec: ModelSpec, tp: int) -> bool:
    """embed and lm_head are sharded over the vocab (else replicated)."""
    return tp > 1 and spec.vocab_size % tp == 0


def leaf_rules(spec: ModelSpec, tp: int, ep: int = 1
               ) -> Dict[Tuple[str, ...], List[Rule]]:
    """``{path: [(axis, size of the whole axis, mesh axis), ..]}`` of
    every sharded leaf of the port's tree (``models/decoder.py``
    ``init_params``), axes counted on the stacked ``[L, ...]`` leaf; the
    rest is replicated."""
    Q, KVD, F = spec.q_dim, spec.kv_dim, spec.intermediate_size
    rules: Dict[Tuple[str, ...], List[Rule]] = {}
    if tp > 1:
        rules.update({
            ("layers", "q", "w"): [(2, Q, AXIS_TP)],
            ("layers", "k", "w"): [(2, KVD, AXIS_TP)],
            ("layers", "v", "w"): [(2, KVD, AXIS_TP)],
            ("layers", "o", "w"): [(1, Q, AXIS_TP)],
        })
        if spec.is_moe:
            # [L, E, D, F] and [L, E, F, D]
            rules[("layers", "gate", "w")] = [(3, F, AXIS_TP)]
            rules[("layers", "up", "w")] = [(3, F, AXIS_TP)]
            rules[("layers", "down", "w")] = [(2, F, AXIS_TP)]
        else:
            rules[("layers", "gate", "w")] = [(2, F, AXIS_TP)]
            rules[("layers", "up", "w")] = [(2, F, AXIS_TP)]
            rules[("layers", "down", "w")] = [(1, F, AXIS_TP)]
        if spec.qkv_bias:
            rules[("layers", "q", "b")] = [(1, Q, AXIS_TP)]
            rules[("layers", "k", "b")] = [(1, KVD, AXIS_TP)]
            rules[("layers", "v", "b")] = [(1, KVD, AXIS_TP)]
        if vocab_parallel(spec, tp):
            rules[("embed",)] = [(0, spec.vocab_size, AXIS_TP)]
            if not spec.tie_embeddings:
                rules[("lm_head",)] = [(1, spec.vocab_size, AXIS_TP)]
    if ep > 1 and spec.is_moe:
        for name in EXPERT_PROJECTIONS:
            rules.setdefault(("layers", name, "w"), []).insert(
                0, (1, spec.num_experts, AXIS_EP))
    return rules


def _narrow(leaf, axis: int, size: int, parts: int, index: int):
    """Part ``index`` of ``parts`` of ``leaf`` along ``axis`` (a view):
    a plain tensor, or a quantized weight's values with the scale's
    matching entries.  ``axis`` is counted on the values (logical rows
    for a packed int4 leaf, whose row-parallel part is repacked)."""
    vals = leaf[0] if is_quantized_weight(leaf) else leaf
    packed = isinstance(leaf, PackedQTensor)
    rows_axis = axis == vals.ndim - 2
    have = vals.shape[axis] * (2 if packed and rows_axis else 1)
    if have != size:
        raise ValueError(
            f"a leaf has {have} along axis {axis}, not {size}: is it "
            "sharded already?"
        )
    part = size // parts
    if not is_quantized_weight(leaf):
        return leaf.narrow(axis, index * part, part)
    if rows_axis:
        # row-parallel: the whole [.., out] scale stays
        q = (shard_int4_rows(vals, index, parts) if packed
             else vals.narrow(axis, index * part, part))
        return type(leaf)(q, leaf.scale)
    # an output or expert axis: the scale's axis is the same counted from
    # the end ([.., out]) or from the start ([L, E, out])
    s_axis = leaf.scale.ndim - 1 if axis == vals.ndim - 1 else axis
    return type(leaf)(vals.narrow(axis, index * part, part),
                      leaf.scale.narrow(s_axis, index * part, part))


def _contiguous(leaf):
    if is_quantized_weight(leaf):
        return type(leaf)(*(p.contiguous() for p in leaf))
    return leaf.contiguous()


def shard_leaf(path: Tuple[str, ...], leaf, spec: ModelSpec, mesh,
               lead: int = 1):
    """``mesh``'s rank's slice of one leaf (a contiguous copy, so the
    full leaf can be freed), or the leaf itself where it is replicated.
    ``lead`` 0 takes one layer's slice of a stacked leaf (no ``L``
    axis)."""
    rules = leaf_rules(spec, mesh.tp, mesh.ep).get(tuple(path))
    if not rules:
        return leaf
    for axis, size, name in rules:
        parts, index = ((mesh.tp, mesh.tp_rank) if name == AXIS_TP
                        else (mesh.ep, mesh.ep_rank))
        leaf = _narrow(leaf, axis - 1 + lead, size, parts, index)
    return _contiguous(leaf)


def shard_params(params: Dict[str, Any], spec: ModelSpec, mesh
                 ) -> Dict[str, Any]:
    """``mesh.rank``'s shard of a full tree (``param_pspecs``' rules over
    ``mesh.tp`` and ``mesh.ep``), a leaf at a time: each full leaf is
    dropped from ``params`` as soon as its slice exists, so the two never
    both sit whole in memory.  Quantize a tree whole before it is
    sharded (the engine does), so its scales are the whole axis's."""
    check_mesh(spec, mesh.tp, mesh.ep)
    if mesh.num_devices == 1:
        return params

    def walk(node: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
        out = {}
        for key in list(node):
            value = node.pop(key)
            if isinstance(value, dict):
                out[key] = walk(value, path + (key,))
            else:
                out[key] = shard_leaf(path + (key,), value, spec, mesh)
        return out

    return walk(params, ())


def leaf_keeper(spec: ModelSpec, mesh=None,
                quantization: Optional[str] = None) -> Callable[..., Any]:
    """The hook ``init_params`` and the checkpoint loader call on each
    leaf as it is drawn or read, ``keep(path, leaf, lead=1)`` (``lead`` 0:
    one layer of a stacked leaf), whose result they keep.  With
    ``quantization`` the full leaf is quantized (ops/quant.py
    ``quantize_leaf``: the reference's global scales); then, on a mesh
    of more than one rank, the rank keeps its slice and the full draw is
    freed."""
    bits = BITS[quantization] if quantization else None
    sharded = mesh is not None and mesh.num_devices > 1
    if sharded:
        check_mesh(spec, mesh.tp, mesh.ep)

    def keep(path, leaf, lead: int = 1):
        if bits is not None:
            leaf = quantize_leaf(path, leaf, spec, bits, lead)
        if sharded:
            leaf = shard_leaf(tuple(path), leaf, spec, mesh, lead)
        return leaf

    return keep


def local_spec(spec: ModelSpec, tp: int, mesh=None) -> ModelSpec:
    """The spec a rank's forwards and pools run on: H/tp query heads,
    KV/tp kv heads and F/tp FFN channels (``_project_qkv``'s reshape then
    needs no other change), the vocab whole (the logits are gathered),
    under ep the rank's experts (``expert_range``; routing still runs
    over all E), and the mesh whose device groups the forwards'
    collectives use."""
    ep = mesh.ep if mesh is not None else 1
    check_mesh(spec, tp, ep)
    if tp <= 1 and ep <= 1:
        return spec
    out = dataclasses.replace(spec, mesh=mesh)
    if tp > 1:
        out = dataclasses.replace(
            out,
            num_heads=spec.num_heads // tp,
            num_kv_heads=spec.num_kv_heads // tp,
            intermediate_size=spec.intermediate_size // tp,
        )
    if ep > 1 and spec.is_moe:
        n = spec.num_experts // ep
        out = dataclasses.replace(out, expert_range=(mesh.ep_rank * n, n))
    return out
