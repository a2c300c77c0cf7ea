"""The port's decoder building blocks (llm_tpu_torch.ops.layers) against the
JAX package's, on the same numpy inputs.

Tolerance: rtol = atol = 1e-6. Both sides compute in f32 with the same
formula; only the order of the mean reductions and the libm versions of
exp/tanh/sin/cos differ, which moves results by a few ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu.ops import layers as jl
from llm_tpu_torch.ops import layers as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


def test_rms_norm():
    x, w = _x((3, 5, 64)), _x((64,), 1)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    assert tl.RMS_EPS == jl.RMS_EPS == 5e-6


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm(with_bias):
    x, w, b = _x((4, 48), scale=3.0), _x((48,), 1), _x((48,), 2)
    tb = torch.from_numpy(b) if with_bias else None
    jb = jnp.asarray(b) if with_bias else None
    _close(tl.layer_norm(torch.from_numpy(x), torch.from_numpy(w), tb),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(w), jb))
    assert tl.LN_EPS == jl.LN_EPS == 1e-5


@pytest.mark.parametrize("fn", ["gelu", "silu"])
def test_activations(fn):
    x = _x((7, 33), scale=4.0)
    _close(getattr(tl, fn)(torch.from_numpy(x)),
           getattr(jl, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("n_rot", [16, 10])
@pytest.mark.parametrize("base,scale", [(10000.0, 1.0), (500000.0, 0.25)])
def test_rope(mode, n_rot, base, scale):
    x = _x((2, 5, 3, 16))  # [B, T, H, D]
    pos = np.array([[0, 1, 2, 3, 4], [17, 18, 19, 20, 1500]], np.int32)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), n_rot, mode,
                  base, scale)
    ref = jl.rope(jnp.asarray(x), jnp.asarray(pos), n_rot, mode, base, scale)
    # angles reach 1500 rad, where one f32 ulp of the angle is ~1e-4 and
    # sin/cos of it differ between libms by that much
    _close(got, ref, rtol=1e-4, atol=2e-4)
    if n_rot < 16:  # dims past n_rot pass through untouched
        np.testing.assert_array_equal(got.numpy()[..., n_rot:],
                                      x[..., n_rot:])


@pytest.mark.parametrize("n_head", [8, 12, 32])
def test_alibi_slopes(n_head):
    _close(tl.alibi_slopes(n_head, 8.0), jl.alibi_slopes(n_head, 8.0))


def test_rope_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tl.rope(torch.zeros(1, 1, 4), torch.zeros(1, dtype=torch.int32), 4, 1)
