"""Attention under tensor parallelism.

The reference (vgate_tpu/parallel/tp_attention.py) wraps each Pallas
kernel in a ``shard_map``: under GSPMD a ``pallas_call`` has no
partitioning rule, so without the wrapper XLA would gather the whole KV
pool to every chip.  Inside the map each shard runs the kernel on its
``H/tp`` query heads and ``KV/tp`` kv heads, with no collective.

The port needs no such wrapper.  Each rank is its own process
(parallel/mesh.py): its q/k/v projections produce only its own heads
(parallel/sharding.py), its pools hold only its kv heads, and the
forwards call K1, K2, K3 and K6 on those local tensors as they would on
one device.  G = H/KV is the same on every rank, so each kernel's GQA
grouping and its planners (K1's page split, K3's tiles) see a smaller
model, not a different one.  Attention is embarrassingly parallel over
heads; the collectives sit after the o and down products
(models/decoder.py).
"""

from __future__ import annotations


def tp_divisible(mesh, num_heads: int, num_kv_heads: int) -> bool:
    """True when the kernels can run per shard under this mesh's tp (the
    reference's test).  The port refuses the other case at load
    (parallel/sharding.py ``check_mesh``)."""
    tp = int(mesh.shape.get("tp", 1))
    return tp > 1 and num_heads % tp == 0 and num_kv_heads % tp == 0
