"""``repro_torch.models.ssm`` against ``repro.models.ssm``, function for
function, in float32 and bfloat16, on the same numpy inputs and the
reference's weights carried across (each leaf in its reference dtype:
``a_log`` / ``dt_bias`` / ``d_skip`` stay f32 in a bf16 block).

The causal conv, op by op in the input dtype, matches bit for bit in
both dtypes; so does the ``init_*`` tree's layout. The f32 gates, states
and outputs match within 1e-5 (relative, 1e-6 absolute on the states):
the f32 log-sigmoid and the matmuls' summation order differ in the last
bits. In bf16 every op rounds to bf16, so the outputs are held at a few
bf16 ulps (atol = rtol = 2^-6) and the f32 states at 2^-8. Last, the
port's parallel forms equal its own steps, as the reference's
``tests/test_models.py`` checks of the reference, and the chunked SSD
does not depend on the chunk size (the chunk halves until it divides
n)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from tests._torch_port import n, t

DTYPES = ["float32", "bfloat16"]
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -6)
STATE_TOL = {"float32": dict(atol=1e-6, rtol=1e-5),
             "bfloat16": dict(atol=2.0 ** -8, rtol=2.0 ** -8)}
B, SEQ, D, H = 2, 24, 32, 2
N_STATE, HD = 8, 16


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _to_torch(tree):
    """A reference pytree → tensors of the same dtypes."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return t(a.astype(np.float32), torch.bfloat16)
    return t(a)


def _x(dtype, shape=(B, SEQ, D), seed=1, scale=0.5):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x = (x * scale).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            t(x, getattr(torch, dtype)))


def _close(out, ref, tol):
    np.testing.assert_allclose(n(out.float()), np.asarray(ref, np.float32),
                               **tol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_trees_have_the_reference_layout(dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = [
        (jssm.init_mlstm(key, D, H, jdt),
         ssm.init_mlstm(gen, "cpu", D, H, tdt)),
        (jssm.init_slstm(key, D, H, jdt),
         ssm.init_slstm(gen, "cpu", D, H, tdt)),
        (jssm.init_mamba2(key, D, N_STATE, HD, dtype=jdt),
         ssm.init_mamba2(gen, "cpu", D, N_STATE, HD, dtype=tdt)),
    ]
    for ref, out in pairs:
        assert _shapes(_to_torch(ref)) == _shapes(out)
    mamba = pairs[2][1]
    for k in ("a_log", "dt_bias", "d_skip"):
        assert mamba[k].dtype == torch.float32
        np.testing.assert_array_equal(n(mamba[k]), np.asarray(pairs[2][0][k]))
    for ref, out in pairs[:2]:
        key_b = "b_if" if "b_if" in ref else "bias"
        np.testing.assert_array_equal(n(out[key_b].float()),
                                      np.asarray(ref[key_b], np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_is_bit_exact(dtype):
    """Bit for bit against the reference run op by op, in both dtypes,
    and against its jitted run in bf16, where XLA keeps every rounding
    (in f32 its jitted run contracts products and sums into fused
    multiply-adds: held at one f32 ulp there)."""
    jx, x = _x(dtype, (B, SEQ, 48), scale=2.0)
    jw, w = _x(dtype, (4, 48), seed=2, scale=0.3)
    jst, st = _x(dtype, (B, 3, 48), seed=3)
    for state in (None, st):
        jstate = None if state is None else jst
        out, out_state = ssm._causal_conv(x, w, state)
        assert out.dtype == x.dtype
        for fn in (jssm._causal_conv, jax.jit(jssm._causal_conv)):
            ref, ref_state = fn(jx, jw, jstate)
            if dtype == "float32" and fn is not jssm._causal_conv:
                _close(out, ref, dict(atol=1e-6, rtol=2.0 ** -23))
            else:
                np.testing.assert_array_equal(n(out.float()),
                                              np.asarray(ref, np.float32))
            np.testing.assert_array_equal(n(out_state.float()),
                                          np.asarray(ref_state, np.float32))


def test_logsigmoid_and_softplus_within_f32_ulps():
    x = np.random.default_rng(0).standard_normal(100_000).astype(
        np.float32) * 8
    for jf, tf in ((jssm._logsigmoid, ssm._logsigmoid),
                   (jax.nn.softplus, ssm._softplus)):
        ref = np.asarray(jax.jit(jf)(jnp.asarray(x)))
        out = n(tf(t(x)))
        np.testing.assert_allclose(out, ref, rtol=2e-7, atol=1e-7)
    big = np.array([25.0, 60.0, -60.0], np.float32)    # no cut-off at 20
    np.testing.assert_array_equal(
        n(ssm._softplus(t(big))), np.asarray(jax.nn.softplus(big)))


def _params(kind, dtype):
    jdt = jnp.dtype(dtype)
    key = jax.random.PRNGKey(0)
    if kind == "mlstm":
        jp = jssm.init_mlstm(key, D, H, jdt)
    elif kind == "slstm":
        jp = jssm.init_slstm(key, D, H, jdt)
    else:
        jp = jssm.init_mamba2(key, D, N_STATE, HD, dtype=jdt)
    return jp, _to_torch(jp)


SEQ_FNS = {
    "mlstm": (lambda p, x: jssm.mlstm_seq(p, x, H),
              lambda p, x: ssm.mlstm_seq(p, x, H)),
    "slstm": (lambda p, x: jssm._slstm_seq_local(p, x, H),
              lambda p, x: ssm.slstm_seq(p, x, H)),
    "mamba2": (lambda p, x: jssm.mamba2_seq(p, x, N_STATE, HD, chunk=8),
               lambda p, x: ssm.mamba2_seq(p, x, N_STATE, HD, chunk=8)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", SEQ_FNS)
def test_seq_forms_match_the_reference(kind, dtype):
    jp, p = _params(kind, dtype)
    jx, x = _x(dtype)
    jf, tf = SEQ_FNS[kind]
    ref = jax.jit(jf)(jp, jx)
    out = tf(p, x)
    assert out.dtype == x.dtype and out.shape == tuple(ref.shape)
    _close(out, ref, _tol(dtype))


def _init_states(kind, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if kind == "mlstm":
        return (jssm.mlstm_init_state(B, D, H, jdt),
                ssm.mlstm_init_state(B, D, H, tdt))
    if kind == "slstm":
        return jssm.slstm_init_state(B, D), ssm.slstm_init_state(B, D)
    return (jssm.mamba2_init_state(B, D, N_STATE, HD, dtype=jdt),
            ssm.mamba2_init_state(B, D, N_STATE, HD, dtype=tdt))


STEP_FNS = {
    "mlstm": (lambda p, x, s: jssm.mlstm_step(p, x, s, H),
              lambda p, x, s: ssm.mlstm_step(p, x, s, H)),
    "slstm": (lambda p, x, s: jssm.slstm_step(p, x, s, H),
              lambda p, x, s: ssm.slstm_step(p, x, s, H)),
    "mamba2": (lambda p, x, s: jssm.mamba2_step(p, x, s, N_STATE, HD),
               lambda p, x, s: ssm.mamba2_step(p, x, s, N_STATE, HD)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", STEP_FNS)
def test_steps_and_states_match_the_reference(kind, dtype):
    """Eight steps from the initial state: each step's output and the
    state after it, each leaf in its reference dtype (the conv state in
    the model dtype, the rest f32)."""
    jp, p = _params(kind, dtype)
    jx, x = _x(dtype, (B, 8, D), seed=4)
    jst, st = _init_states(kind, dtype)
    assert _shapes(_to_torch(jst)) == _shapes(st)
    jf, tf = STEP_FNS[kind]
    jstep = jax.jit(jf)
    for i in range(8):
        ref, jst = jstep(jp, jx[:, i:i + 1], jst)
        out, st = tf(p, x[:, i:i + 1], st)
        _close(out, ref, _tol(dtype))
        for k in st:
            assert st[k].dtype == _to_torch(jst)[k].dtype, k
            _close(st[k], jst[k], STATE_TOL[dtype])
        # carry the reference's state, so the drift of one step is held
        st = _to_torch(jst)


@pytest.mark.parametrize("kind", SEQ_FNS)
def test_parallel_forms_equal_the_steps(kind):
    """The port's full-sequence forms against its own steps, in f32, at
    the reference test's tolerance."""
    _, p = _params(kind, "float32")
    _, x = _x("float32", (B, 32, D))
    par = SEQ_FNS[kind][1](p, x)
    _, st = _init_states(kind, "float32")
    ys = []
    for i in range(32):
        y, st = STEP_FNS[kind][1](p, x[:, i:i + 1], st)
        ys.append(y)
    np.testing.assert_allclose(n(torch.cat(ys, 1)), n(par), atol=1e-4)


def test_mamba2_chunk_halves_until_it_divides_n():
    """n 24 with chunk 16 runs chunks of 8, as the reference does; every
    chunk size gives the same output."""
    jp, p = _params("mamba2", "float32")
    jx, x = _x("float32", (1, 24, D))
    ref = jssm.mamba2_seq(jp, jx, N_STATE, HD, chunk=16)
    outs = [ssm.mamba2_seq(p, x, N_STATE, HD, chunk=c) for c in (16, 8, 3,
                                                                  24, 128)]
    _close(outs[0], ref, F32_TOL)
    for out in outs[1:]:
        np.testing.assert_allclose(n(out), n(outs[0]), atol=1e-5)
