"""The port's kernel ops on the CPU (their plain versions) against the JAX
package's Pallas kernels in interpret mode and its pure-jnp oracles.

Inputs are made once with numpy from a seed and handed to both packages;
bf16 inputs are rounded from the same f32 values on both sides.
Tolerances are those of tests/test_kernels.py: 2e-5 in f32, 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels import LAUNCHES, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# --- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 4, 4, 128, 32),     # MHA
    (2, 4, 2, 128, 32),     # GQA 2:1
    (1, 8, 1, 256, 16),     # MQA
])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, H, KV, S, D, window, dtype):
    rng = np.random.default_rng(S + H + window)
    jq, tq = _pair(rng, (B, S, H, D), dtype)        # model layout
    jk, tk = _pair(rng, (B, S, KV, D), dtype)
    jv, tv = _pair(rng, (B, S, KV, D), dtype)
    n0 = LAUNCHES["flash_attention"]
    got = ops.flash_attention(tq, tk, tv, window=window, block_q=64,
                              block_k=64)
    assert LAUNCHES["flash_attention"] == n0      # CPU: no kernel launch
    assert got.shape == (B, S, H, D) and got.dtype == TDT[dtype]
    hm = lambda x: jnp.moveaxis(x, 2, 1)            # noqa: E731
    oracle = jref.flash_attention_ref(hm(jq), hm(jk), hm(jv), causal=True,
                                      window=window)
    _close(got, jnp.moveaxis(oracle, 1, 2), dtype)
    if (B, H, KV) == (2, 4, 2):
        # the Pallas kernel itself (interpret mode) on the GQA shape only:
        # each interpret-mode compile costs about a second here
        pallas = flash_attention_fwd(hm(jq), hm(jk), hm(jv), causal=True,
                                     window=window, block_q=64, block_k=64,
                                     interpret=True)
        _close(got, jnp.moveaxis(pallas, 1, 2), dtype)
    _close(ref.flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), window=window),
           oracle, dtype)


# --- flash decode ------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 17, 255])
@pytest.mark.parametrize("KV", [1, 2, 4])
def test_flash_decode_matches_pallas(pos, KV):
    B, H, S, D = 2, 4, 256, 32
    rng = np.random.default_rng(pos * 7 + KV)
    jq, tq = _pair(rng, (B, H, D), "float32")
    jk, tk = _pair(rng, (B, S, KV, D), "float32")
    jv, tv = _pair(rng, (B, S, KV, D), "float32")
    got, lse = ops.flash_decode(tq, tk, tv, pos, return_lse=True)
    want, jlse = jops.flash_decode(jq, jk, jv, jnp.int32(pos), block_k=64,
                                   return_lse=True)
    _close(got, want, "float32")
    _close(lse, jlse, "float32")
    _close(got, jref.flash_decode_ref(jq, jk, jv, pos), "float32")


@pytest.mark.parametrize("pos", [5, 200])
def test_flash_decode_bf16_matches_oracle(pos):
    B, H, KV, S, D = 2, 8, 2, 256, 32
    rng = np.random.default_rng(pos)
    jq, tq = _pair(rng, (B, H, D), "bfloat16")
    jk, tk = _pair(rng, (B, S, KV, D), "bfloat16")
    jv, tv = _pair(rng, (B, S, KV, D), "bfloat16")
    got = ops.flash_decode(tq, tk, tv, pos)
    assert got.dtype == torch.bfloat16
    _close(got, jref.flash_decode_ref(jq, jk, jv, pos), "bfloat16")


def test_flash_decode_lse_combine():
    """Two sequence shards combined through their LSEs equal the unsharded
    result: the contract a sequence-sharded decode relies on."""
    B, H, S, D = 1, 2, 128, 16
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (B, H, D), "float32")
    jk, tk = _pair(rng, (B, S, 1, D), "float32")
    jv, tv = _pair(rng, (B, S, 1, D), "float32")
    pos, half = 127, S // 2
    o1, l1 = ops.flash_decode(tq, tk[:, :half], tv[:, :half], pos,
                              return_lse=True)
    o2, l2 = ops.flash_decode(tq, tk[:, half:], tv[:, half:], pos - half,
                              return_lse=True)
    w1 = torch.exp(l1 - torch.logaddexp(l1, l2))[..., None]
    combined = o1 * w1 + o2 * (1 - w1)
    _close(combined, jref.flash_decode_ref(jq, jk, jv, pos), "float32")
    # each shard's LSE is the reference kernel's
    _, jl1 = jops.flash_decode(jq, jk[:, :half], jv[:, :half],
                               jnp.int32(pos), block_k=32, return_lse=True)
    _close(l1, jl1, "float32")


def test_ops_reject_other_devices():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_decode(q[:, 0], q, q, 1)
