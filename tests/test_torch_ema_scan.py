"""The sequential EMA with an explicit carry, ``ops.scan.ema_scan``.

On the CPU the wrapper runs its plain version (``ema_scan_plain``: a
multiply, then an add, two torch ops a lane), the twin of the CUDA
kernel ``csrc/ema_scan.cu``, which ``chip_smoke.py`` holds against it
bitwise on the card.  Here:

* bitwise against a numpy loop that rounds the same way (float32 and
  float64, NaN, signed zeros and infinities in ``x``);
* split invariance, bitwise: a run over A then over B from A's ``y_end``
  equals one run over A + B, at random splits;
* against the reference ``tempo_tpu.ops.rolling.ema_scan``.  XLA:CPU
  contracts the reference's ``d * y + i`` into one fused multiply-add
  (its bits are those of an FMA loop), so the two differ by at most half
  an ulp of ``d * y`` a step, and each step's difference decays by
  ``1 - a``: the stated bound is ``(1 / a)`` ulps of the row's largest
  ``|y|``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tempo_tpu.ops import rolling as ref_rolling
from tempo_tpu_torch.ops import cuda_lib, rolling, scan


def _inputs(rng, shape, dtype=np.float32, special=False):
    x = (rng.standard_normal(shape) * 50).astype(dtype)
    valid = rng.random(shape) > 0.25
    if special:
        flat = x.reshape(-1)
        picks = rng.choice(flat.size, size=min(12, flat.size), replace=False)
        flat[picks[:4]] = -0.0
        flat[picks[4:6]] = np.inf
        flat[picks[6:8]] = -np.inf
        flat[picks[8:]] = np.nan
    y0 = (rng.standard_normal(shape[:-1]) * 5).astype(dtype)
    return x, valid, y0


def _numpy_scan(x, valid, alpha, y0):
    dt = x.dtype.type
    a = dt(alpha)
    d = np.where(valid, dt(1) - a, dt(1)).astype(x.dtype)
    i = np.where(valid, a * x, dt(0)).astype(x.dtype)
    y = np.zeros(x.shape[:-1], x.dtype) if y0 is None else y0.copy()
    ys = np.empty_like(x)
    with np.errstate(invalid="ignore", over="ignore"):
        for j in range(x.shape[-1]):
            y = d[..., j] * y
            y = y + i[..., j]
            ys[..., j] = y
    return ys, y


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(3, 40), (2, 5, 33), (1, 1), (4, 0)])
@pytest.mark.parametrize("with_y0", [False, True])
def test_plain_version_rounds_as_the_loop(dtype, shape, with_y0):
    rng = np.random.default_rng(sum(shape) + 7 * with_y0)
    x, valid, y0 = _inputs(rng, shape, dtype, special=np.prod(shape) > 20)
    y0 = y0 if with_y0 else None
    cuda_lib.reset_launches()
    ys, y_end = rolling.ema_scan(torch.from_numpy(x), torch.from_numpy(valid),
                                 0.2, None if y0 is None
                                 else torch.from_numpy(y0))
    assert cuda_lib.launches["ema_scan"] == 0      # the CPU runs no kernel
    want_ys, want_end = _numpy_scan(x, valid, 0.2, y0)
    _bits_equal(ys.numpy(), want_ys)
    _bits_equal(y_end.numpy(), want_end)


@pytest.mark.parametrize("seed", range(6))
def test_split_invariance_is_bitwise(seed):
    rng = np.random.default_rng(seed)
    K, L = 3, int(rng.integers(20, 90))
    x, valid, y0 = _inputs(rng, (2, K, L), special=True)
    alpha = float(rng.choice([0.2, 0.01, 0.9, 1.0]))
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    whole, whole_end = scan.ema_scan(xt, vt, alpha, torch.from_numpy(y0))
    cuts = np.sort(rng.choice(np.arange(1, L), size=3, replace=False))
    y, parts = torch.from_numpy(y0), []
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, L]):
        ys, y = scan.ema_scan(xt[..., lo:hi], vt[..., lo:hi], alpha, y)
        parts.append(ys)
    _bits_equal(torch.cat(parts, -1).numpy(), whole.numpy())
    _bits_equal(y.numpy(), whole_end.numpy())


@pytest.mark.parametrize("alpha", [0.2, 0.01, 0.9])
@pytest.mark.parametrize("shape", [(3, 7, 120), (4, 500)])
def test_against_the_reference(alpha, shape):
    rng = np.random.default_rng(len(shape))
    x, valid, y0 = _inputs(rng, shape)
    want, want_end = ref_rolling.ema_scan(
        jnp.asarray(x), jnp.asarray(valid), np.float32(alpha),
        y0=jnp.asarray(y0))
    got, got_end = scan.ema_scan(torch.from_numpy(x), torch.from_numpy(valid),
                                 np.float32(alpha), torch.from_numpy(y0))
    want = np.asarray(want)
    bound = np.spacing(np.abs(want).max(-1, keepdims=True)) / alpha
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert (np.abs(got_end.numpy() - np.asarray(want_end))
            <= bound[..., 0]).all()


def test_zero_carry_is_the_scans_start():
    rng = np.random.default_rng(1)
    x, valid, _ = _inputs(rng, (2, 30))
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    a, a_end = scan.ema_scan(xt, vt, 0.3)
    b, b_end = scan.ema_scan(xt, vt, 0.3, torch.zeros(2))
    _bits_equal(a.numpy(), b.numpy())
    _bits_equal(a_end.numpy(), b_end.numpy())


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8)
    valid = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        scan.ema_scan_cuda(x, valid, 0.2)
    with pytest.raises(TypeError, match="float32 or float64"):
        scan.ema_scan_cuda(x.half(), valid, 0.2)
    with pytest.raises(TypeError, match="valid"):
        scan.ema_scan_cuda(x, valid[:, :4], 0.2)
    with pytest.raises(TypeError, match="y0"):
        scan.ema_scan(x, valid, 0.2, torch.zeros(3))
