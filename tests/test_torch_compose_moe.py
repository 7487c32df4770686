"""pp x ep and sp x ep on ``tiny-moe`` in the port (item 10d (rest),
part 2) vs the JAX package, on the CPU.  The checks are tests/
test_torch_compose.py's and tests/test_torch_compose_sp.py's, in a file
of their own so that no one file runs long on its worker.  Held here, in
f32: tiny-moe with int8 weights at pp2 x ep2 (each stage's ep ranks hold
2 of the 4 experts of its layer) and tiny-moe at sp2 x ep2 (ring passes
and prefix hits, each sp rank's experts split over its ep ranks) greedy
token-identical to the JAX engine at the same mesh, every rank in step.
"""

from test_torch_compose import check_pp_engine
from test_torch_compose import models  # noqa: F401  (the fixture)
from test_torch_compose_sp import check_sp_engine
from test_torch_sp import reference_shard_map  # noqa: F401  (the fixture)


def test_pp2xep2_int8_engine_token_identical_to_jax(models):
    check_pp_engine(models, "tiny-moe", "pp2xep2", quantization="int8")


def test_sp2xep2_engine_token_identical_to_jax(models):
    check_sp_engine(models, "tiny-moe", "sp2xep2")
