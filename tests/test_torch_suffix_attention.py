"""The port's suffix prompt pass vs the JAX package, on the CPU.

* The plain ``paged_suffix_attention`` (the semantic spec of the CUDA
  kernel K3) against the jnp ``paged_suffix_attention`` and against the
  TPU kernel ``paged_multitok_attention_pallas`` run with
  ``interpret=True``: ragged cases with an unaligned ``positions0``,
  ``input_lens < S``, hd 64/128/256, a window, softcap + scale and page
  sizes 16 and 32; real rows only, fp32 atol = rtol = 2e-5.
* ``copy_page_prefix`` against the JAX one, exactly.
* ``prefill_suffix_forward`` (page-aligned and copy-on-write) against
  the JAX one on tiny-dense: logits and written pools, fp32
  atol = rtol = 1e-5.
* ``_logits`` in bf16 against a float64 product: the lm_head returns
  the fp32 accumulation, as the reference's does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgate_tpu.models import decoder as jdec
from vgate_tpu.models.specs import TINY_DENSE as J_TINY
from vgate_tpu.ops import attention as jatt
from vgate_tpu.ops.kv_quant import copy_page_prefix as j_copy_page_prefix
from vgate_tpu.ops.pallas.paged_attention import (
    paged_multitok_attention_pallas,
)
from vgate_tpu_torch.models import decoder as tdec
from vgate_tpu_torch.models.specs import TINY_DENSE
from vgate_tpu_torch.ops import attention as tatt
from vgate_tpu_torch.ops.kernels import paged_multitok
from vgate_tpu_torch.ops.kv_quant import copy_page_prefix
from vgate_tpu_torch.runtime.weights import params_from_jax

ATOL = 2e-5
FWD_TOL = 1e-5

# (hd, H, KV, ps, S, positions0, input_lens, kwargs): the ragged cases
# chip_smoke.py holds the CUDA kernel to, at CPU-test widths
CASES = [
    (64, 8, 2, 16, 32, [0, 37, 5], [32, 20, 1], {}),
    (128, 8, 4, 32, 64, [64, 100, 0], [64, 40, 3], {"window": 48}),
    (256, 4, 2, 16, 32, [16, 3, 50], [30, 32, 7],
     {"softcap": 30.0, "scale": 0.1}),
    (128, 12, 2, 32, 64, [31, 0, 96], [64, 64, 33], {}),
]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def suffix_case(hd, H, KV, ps, S, pos0, lens, seed):
    """q, pools and a page table wide enough for every row's context
    (distinct pages per row, page 0 never used)."""
    rng = np.random.default_rng(seed)
    B = len(pos0)
    ctx_pages = -(-(max(pos0) + S) // ps)
    P = 1 + B * ctx_pages
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(KV, P, ps, hd)).astype(np.float32)
    v = rng.normal(size=(KV, P, ps, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P))[: B * ctx_pages]
    pt = pt.reshape(B, ctx_pages).astype(np.int32)
    return q, k, v, pt, np.asarray(pos0, np.int32), np.asarray(lens, np.int32)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_suffix_attention_matches_twin_and_kernel(case):
    hd, H, KV, ps, S, pos0, lens, kw = CASES[case]
    q, k, v, pt, p0, il = suffix_case(hd, H, KV, ps, S, pos0, lens, case)
    window = kw.get("window", 0)
    jkw = {key: val for key, val in kw.items() if key != "window"}
    jwin = jnp.asarray(window, jnp.int32) if window else None
    twin = jatt.paged_suffix_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(p0), jnp.asarray(p0 + il), window=jwin, **jkw,
    )
    kern = paged_multitok_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(p0), jnp.asarray(il), window=jwin, interpret=True,
        **jkw,
    )
    plain = tatt.paged_suffix_attention(
        _t(q), _t(k), _t(v), _t(pt), _t(p0), _t(p0 + il),
        window=window or None, **jkw,
    )
    before = paged_multitok.paged_multitok_attention.launches
    wrapped = paged_multitok.paged_multitok_attention(
        _t(q), _t(k), _t(v), _t(pt), _t(p0), _t(il), **kw
    )
    assert paged_multitok.paged_multitok_attention.launches == before
    real = np.arange(S)[None, :] < il[:, None]  # rows past input_lens: any
    for expect in (twin, kern):
        np.testing.assert_allclose(
            plain.numpy()[real], np.asarray(expect)[real], atol=ATOL,
            rtol=ATOL,
        )
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


def test_copy_page_prefix_matches_jax_exactly():
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(2, 2, 6, 4, 16)).astype(np.float32)
    for src, dst, upto in ((3, 5, 2), (1, 2, 4), (4, 1, 1)):
        keep = jnp.arange(4) < upto
        expect = j_copy_page_prefix(jnp.asarray(pool), src, dst, keep)
        got = torch.from_numpy(pool.copy())
        copy_page_prefix(got, src, dst, upto)
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
        pool = np.asarray(expect)


# ------------------------------------------------------- suffix forward

PS = 4


def _params():
    params = jdec.init_params(J_TINY, jax.random.PRNGKey(0), jnp.float32)
    return params, params_from_jax(
        jax.tree.map(np.asarray, params), TINY_DENSE
    )


def _pools(P, seed):
    rng = np.random.default_rng(seed)
    shape = (TINY_DENSE.num_layers, TINY_DENSE.num_kv_heads, P, PS,
             TINY_DENSE.head_dim)
    # nonzero content: a write that lands in the wrong slot shows
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _both_prefill(jparams, tparams, tokens, pages, jk, jv, tk, tv):
    """One prompt pass of ``tokens`` into ``pages`` in both packages."""
    S = len(pages) * PS
    tok = np.zeros((1, S), np.int32)
    tok[0, : len(tokens)] = tokens
    sl = np.array([len(tokens)], np.int32)
    pt = np.array([pages], np.int32)
    _, jk, jv = jdec.prefill_forward(
        jparams, J_TINY, jnp.asarray(tok), jnp.asarray(sl), jk, jv,
        jnp.asarray(pt),
    )
    tdec.prefill_forward(tparams, TINY_DENSE, _t(tok), _t(sl), tk, tv, _t(pt))
    return jk, jv


def _both_suffix(jparams, tparams, rows, S, n_suffix_pages, ctx_pages,
                 jk, jv, tk, tv, unaligned):
    """One suffix pass over ``rows`` = [(tokens, prefix_len, own pages,
    context pages)] in both packages; a None row is batch padding."""
    B = len(rows)
    tok = np.zeros((B, S), np.int32)
    prefix = np.zeros((B,), np.int32)
    lens = np.ones((B,), np.int32)
    spt = np.zeros((B, n_suffix_pages), np.int32)
    cpt = np.zeros((B, ctx_pages), np.int32)
    for b, row in enumerate(rows):
        if row is None:
            continue
        toks, plen, own, ctx = row
        tok[b, : len(toks)] = toks
        prefix[b], lens[b] = plen, len(toks)
        spt[b, : len(own)] = own
        cpt[b, : len(ctx)] = ctx
    j_logits, jk, jv = jdec.prefill_suffix_forward(
        jparams, J_TINY, jnp.asarray(tok), jnp.asarray(prefix),
        jnp.asarray(lens), jk, jv, jnp.asarray(spt), jnp.asarray(cpt),
        unaligned=unaligned,
    )
    t_logits = tdec.prefill_suffix_forward(
        tparams, TINY_DENSE, _t(tok), _t(prefix), _t(lens), tk, tv,
        _t(spt), _t(cpt), unaligned=unaligned,
    )
    return j_logits, t_logits, jk, jv


def _close_fwd(got, expect, mask=None):
    got, expect = np.asarray(got), np.asarray(expect)
    if mask is not None:
        got, expect = got[mask], expect[mask]
    np.testing.assert_allclose(got, expect, atol=FWD_TOL, rtol=FWD_TOL)


def test_prefill_suffix_forward_aligned_matches_jax():
    """A 12-token cached prefix (3 pages) + a 10-token suffix, batched
    with a padding row (prefix 0, one token, all-zero tables)."""
    jparams, tparams = _params()
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, TINY_DENSE.vocab_size, size=22).tolist()
    k0, v0 = _pools(16, 6)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = _t(k0.copy()), _t(v0.copy())
    pages = [3, 7, 1, 9, 12, 5]  # 22 tokens -> 6 pages
    jk, jv = _both_prefill(jparams, tparams, prompt[:12], pages[:3],
                           jk, jv, tk, tv)
    j_logits, t_logits, jk, jv = _both_suffix(
        jparams, tparams, [(prompt[12:], 12, pages[3:], pages), None],
        S=16, n_suffix_pages=4, ctx_pages=8, jk=jk, jv=jv, tk=tk, tv=tv,
        unaligned=False,
    )
    _close_fwd(t_logits[:1], j_logits[:1])
    # page 0 absorbs the padding row's writes: compare the real pages
    _close_fwd(tk[:, :, 1:], jk[:, :, 1:])
    _close_fwd(tv[:, :, 1:], jv[:, :, 1:])


def test_prefill_suffix_forward_cow_matches_jax():
    """Copy-on-write: sequence A's prompt fills pages [2, 4, 6]; B shares
    its first 10 tokens (two full pages + 2 tokens of page 6), copies
    that head into its own page 8 and prefills from position 10 with
    the per-token scatter."""
    jparams, tparams = _params()
    rng = np.random.default_rng(7)
    a = rng.integers(3, TINY_DENSE.vocab_size, size=12).tolist()
    b = a[:10] + rng.integers(3, TINY_DENSE.vocab_size, size=9).tolist()
    k0, v0 = _pools(16, 8)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = _t(k0.copy()), _t(v0.copy())
    jk, jv = _both_prefill(jparams, tparams, a, [2, 4, 6], jk, jv, tk, tv)
    keep = jnp.arange(PS) < 2
    jk = j_copy_page_prefix(jk, 6, 8, keep)
    jv = j_copy_page_prefix(jv, 6, 8, keep)
    copy_page_prefix(tk, 6, 8, 2)
    copy_page_prefix(tv, 6, 8, 2)
    own = [8, 10, 11]  # 19 tokens -> pages [2, 4, 8, 10, 11]
    shared = tk[:, :, 6].clone()
    j_logits, t_logits, jk, jv = _both_suffix(
        jparams, tparams, [(b[10:], 10, own, [2, 4] + own)],
        S=12, n_suffix_pages=4, ctx_pages=8, jk=jk, jv=jv, tk=tk, tv=tv,
        unaligned=True,
    )
    _close_fwd(t_logits, j_logits)
    _close_fwd(tk[:, :, 1:], jk[:, :, 1:])
    _close_fwd(tv[:, :, 1:], jv[:, :, 1:])
    # the shared source page was never written
    assert torch.equal(tk[:, :, 6], shared)


# ------------------------------------------------------------ bf16 logits

def test_bf16_logits_are_the_fp32_accumulation():
    """Rows of +-1 pass rms_norm exactly in bf16, so both packages' lm_head
    sees the same bf16 operands; each must match the float64 product to
    fp32 accuracy.  A product rounded to bf16 (about 4e-3 of the largest
    logit) fails the 1e-4 bound by far; fp32 accumulation errs ~1e-6."""
    rng = np.random.default_rng(11)
    D, V = 256, 4096
    x = rng.choice([-1.0, 1.0], size=(8, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.5).astype(np.float32)
    x_b = torch.from_numpy(x).bfloat16()
    w_b = torch.from_numpy(w).bfloat16()
    expect = x_b.double() @ w_b.double()
    scale = float(expect.abs().max())
    spec = dataclasses.replace(TINY_DENSE, hidden_size=D, vocab_size=V)
    got = tdec._logits(
        {"final_norm": torch.ones(D, dtype=torch.bfloat16), "lm_head": w_b},
        spec, x_b,
    )
    jspec = dataclasses.replace(J_TINY, hidden_size=D, vocab_size=V)
    j_got = jdec._logits(
        {"final_norm": jnp.ones((D,), jnp.bfloat16),
         "lm_head": jnp.asarray(w_b.float().numpy(), jnp.bfloat16)},
        jspec, jnp.asarray(x_b.float().numpy(), jnp.bfloat16),
    )
    assert got.dtype == torch.float32
    for logits in (got.double(), _t(np.array(j_got)).double()):
        assert float((logits - expect).abs().max()) / scale < 1e-4
