"""The sharding rules over the serving mesh's ``tp``, ``ep``, ``pp`` and
``sp`` axes.

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

Under pipeline parallelism (``pp`` > 1) the stacked layer axis L of
every ``layers`` leaf shards over pp, as ``param_pspecs`` puts it: stage
s keeps layers ``[s*L/pp, (s+1)*L/pp)``, a quantized leaf its layers'
values and scales (a per-output-channel scale depends on its layer
alone), and its pool holds those layers (:func:`local_spec`).  Only
stage 0 keeps ``embed``, ``final_norm`` and ``lm_head``: it alone embeds
the tokens and computes the logits (parallel/pipeline.py), where the
reference replicates them and every stage computes the logits.

Under sequence parallelism (``sp`` > 1) no leaf shards over sp, as
``param_pspecs`` has no sp axis: an sp rank keeps what its tp and ep
indices give it, and its pool holds its shard of the pages (runtime/
engine_core.py ``kv_layout``, parallel/sp_decode.py).

A stage or an sp rank that is itself an ep x tp group composes the two
steps (:func:`shard_leaf`): first the stage's layers (and, past stage 0,
none of ``STAGE0_LEAVES``), then the tp and ep rules above, so stage 0's
embedding and head are vocab-parallel over stage 0's tp group.

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


# the leaves only pipeline stage 0 keeps
STAGE0_LEAVES = ("embed", "final_norm", "lm_head")


def check_mesh(spec: ModelSpec, tp: int, ep: int = 1, pp: int = 1) -> None:
    """Refuse a tp the port cannot shard by whole heads and channels, an
    ep that does not divide the experts, and a pp that does not divide
    the layers (the reference's error)."""
    if pp > 1 and spec.num_layers % pp:
        raise ValueError(
            f"{spec.num_layers} layers not divisible by pp={pp}"
        )
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
        f"{what} under a model-parallel mesh (device.tp, device.ep, "
        f"device.pp or device.sp > 1) is not ported yet (ROADMAP queue 1, "
        f"item {item})"
    )


def check_mesh_config(config, spec: ModelSpec, tp: int, ep: int = 1,
                      pp: int = 1, sp: int = 1) -> None:
    """What a model-parallel mesh of ``pp x ep x sp x tp`` refuses, at
    config load and again at the engine: the reference's errors
    (vgate_tpu/runtime/engine_core.py) for int8 KV pools and the host
    swap tier on any model-parallel mesh, under sp for prefill buckets sp
    does not divide, and under pp for chunked prefill, layers pp does not
    divide and speculation; then the port's own, each citing its ROADMAP
    item.  pp and sp compose with tp and ep (a stage, or an sp rank, that
    is itself an ep x tp group); sp x pp is refused at config load."""
    check_mesh(spec, tp, ep)
    bad = {k: v for k, v in (("tp", tp), ("pp", pp), ("sp", sp), ("ep", ep))
           if v > 1}
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
    if pp > 1:
        if config.device.prefill_chunk > 0:
            raise ValueError(
                "prefill_chunk (chunked prefill) requires pp == 1 — the "
                "relay prompt pass reshapes the program incompatibly "
                "(sp is fine: chunks ride the sp-capable suffix program)"
            )
        check_mesh(spec, tp, ep, pp)
        if config.device.speculative_k > 0:
            raise ValueError(
                "speculative decoding cannot combine with pp>1: a "
                "verify round would relay candidates through every "
                "stage and roll back rejected KV writes per stage, "
                "serializing the pipeline — a permanent design "
                "exclusion (docs/composition.md). Speculation composes "
                "with sp, its long-context home turf; pp's throughput "
                "workloads are served by continuous batching."
            )
    if sp > 1:
        # the scheduler's ladder (runtime/scheduler.py), as the reference
        # checks it
        d, ps = config.device, config.device.kv_page_size
        top = -(-config.model.max_model_len // ps) * ps
        if d.prefill_chunk > 0:
            top = min(top, -(-d.prefill_chunk // ps) * ps)
        ladder = sorted({min(-(-b // ps) * ps, top)
                         for b in d.prefill_buckets if b > 0} | {top})
        odd = [b for b in ladder if b % sp]
        if odd:
            raise ValueError(
                f"prefill buckets {odd} not divisible by sp={sp}; "
                "ring-attention prefill shards the sequence axis evenly"
            )
    if config.device.speculative_k > 0:
        raise _not_ported("speculative decoding", "10d (rest)")
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


def stage_layers(spec: ModelSpec, mesh=None) -> range:
    """The global layers of ``mesh``'s pipeline stage (every layer
    without a mesh or at pp 1)."""
    L = spec.num_layers
    if mesh is None or mesh.pp <= 1:
        return range(L)
    check_mesh(spec, mesh.tp, mesh.ep, mesh.pp)
    n = L // mesh.pp
    return range(mesh.pp_rank * n, (mesh.pp_rank + 1) * n)


def shard_leaf(path: Tuple[str, ...], leaf, spec: ModelSpec, mesh,
               lead: int = 1):
    """``mesh``'s rank's slice of one leaf (a contiguous copy, so the
    full leaf can be freed), or the leaf itself where it is replicated.
    ``lead`` 0 takes one layer's slice of a stacked leaf (no ``L``
    axis).  Under pp a stacked leaf first keeps the stage's layers (a
    single layer is kept or dropped by its caller, ``stack_layers``),
    and a stage other than 0 drops ``STAGE0_LEAVES`` (None); then the tp
    and ep rules cut the rank's part."""
    path = tuple(path)
    sliced = False
    if mesh.pp > 1:
        if path[0] in STAGE0_LEAVES:
            if mesh.pp_rank != 0:
                return None
        elif lead == 1:
            leaf = _narrow(leaf, 0, spec.num_layers, mesh.pp, mesh.pp_rank)
            sliced = True
    for axis, size, name in leaf_rules(spec, mesh.tp, mesh.ep).get(path, ()):
        parts, index = ((mesh.tp, mesh.tp_rank) if name == AXIS_TP
                        else (mesh.ep, mesh.ep_rank))
        leaf = _narrow(leaf, axis - 1 + lead, size, parts, index)
        sliced = True
    return _contiguous(leaf) if sliced else leaf


def shard_params(params: Dict[str, Any], spec: ModelSpec, mesh
                 ) -> Dict[str, Any]:
    """``mesh.rank``'s shard of a full tree (``param_pspecs``' rules over
    ``mesh.tp``, ``mesh.ep`` and ``mesh.pp``), a leaf at a time: each
    full leaf is dropped from ``params`` as soon as its slice exists, so
    the two never both sit whole in memory.  Quantize a tree whole before
    it is sharded (the engine does), so its scales are the whole
    axis's."""
    check_mesh(spec, mesh.tp, mesh.ep, mesh.pp)
    if mesh.num_devices == 1:
        return params

    def walk(node: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
        out = {}
        for key in list(node):
            value = node.pop(key)
            if isinstance(value, dict):
                out[key] = walk(value, path + (key,))
            else:
                value = shard_leaf(path + (key,), value, spec, mesh)
                if value is not None:
                    out[key] = value
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
    freed (None: a leaf the rank does not hold, ``shard_leaf``)."""
    bits = BITS[quantization] if quantization else None
    sharded = mesh is not None and mesh.num_devices > 1
    if sharded:
        check_mesh(spec, mesh.tp, mesh.ep, mesh.pp)

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
    collectives use.  Under sp, besides, the mesh as ``seq_parallel``
    (every layer, the rank's rows and pages); under pp the stage's
    ``L/pp`` layers from global layer ``first_layer`` (whose windows
    ``layer_windows`` gives) and the mesh the relay sends over as
    ``pipeline``.  ``mesh`` is set only where tp or ep > 1: with both at
    1 no tp or expert collective is issued."""
    ep = mesh.ep if mesh is not None else 1
    check_mesh(spec, tp, ep)
    out = spec
    if mesh is not None and mesh.sp > 1:
        out = dataclasses.replace(out, seq_parallel=mesh)
    if mesh is not None and mesh.pp > 1:
        layers = stage_layers(spec, mesh)
        out = dataclasses.replace(
            out, num_layers=len(layers), first_layer=layers.start,
            pipeline=mesh)
    if tp <= 1 and ep <= 1:
        return out
    out = dataclasses.replace(out, mesh=mesh)
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
