"""The sequential-EMA kernel's launch plan and its tiled walk.

``ops.scan.ema_scan_plan`` picks the kernel's block (``csrc/ema_scan.cu``:
a scan warp, a thread a row, and three helper warps streaming tiles
through a ring of bulk copies) from ``(R, L, itemsize)`` alone, so a CUDA
graph captures one launch.  Here, on the CPU:

* the plan at every caller's shape (serving's pushes, the cohort step,
  the standing planes' and batch twins' shapes, phase B's shapes) and at
  the edges: shared memory within the 227 KB a block may take (and
  within a quarter SM where a row has two tiles), the grid within its
  limits and covering every row once, rows spread over the SMs, the ring
  no deeper than a row's tiles, and refusals past int32;
* the layout (``ops.scan.ema_scan_layout``, the kernel's ``scan_layout``):
  every plane on a 16-byte boundary and large enough for the 16-byte
  span ``ring::stage`` copies from any start, the scan planes' rows an
  odd number of 16-byte words apart (the transposed walk's 128-bit reads
  hit distinct banks);
* ``ema_scan_plain`` against the reference ``tempo_tpu.ops.rolling.
  ema_scan`` at the serving and cohort shapes (small K), within the
  bound ``tests/test_torch_ema_scan.py`` states: ``1 / alpha`` ulps of
  the row's largest ``|y|`` (XLA:CPU contracts ``d * y + i`` into an
  FMA).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tempo_tpu.ops import rolling as ref_rolling
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.ops.stream import SMEM_LIMIT

#: (R, L): phase B's [2, 1024, 4096], M.b's push [2, 1024, 64], [1, 16,
#: 64], the cohort step [10240, 8], one row of 2^20, HHAR histories, the
#: split pieces at 1366 and 2730, phase B's odd shapes, config 20's
#: standing step, and the edges
SHAPES = [(2048, 4096), (2048, 64), (16, 64), (10240, 8), (1, 1 << 20),
          (1024, 12760), (2048, 1366), (2048, 2730), (2100, 333),
          (4100, 5), (1536, 8), (384, 128), (1, 1), (1, 63), (1, 64),
          (1, 65), (7, 1), (133, 2049), (4224, 64), (4225, 64),
          (20000, 100), (100000, 4096),
          (2**31 - 1, 1), (1, 2**31 - 1)]


def _span(addr, nbytes):
    """Bytes ``ring::stage`` copies (16-byte aligned span covering the
    item; no allocation end nearby)."""
    return ((addr + nbytes + 15) & ~15) - (addr & ~15)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plan_fits_the_card_and_covers_every_row(shape, itemsize):
    R, L = shape
    p = scan.ema_scan_plan(R, L, itemsize)
    assert 1 <= p["rows"] <= 32
    # rows spread over four blocks on each of the card's 132 SMs, 32 at
    # most a block, four blocks an SM resident where a row has two tiles
    assert p["rows"] == min(32, -(-R // 528))
    if p["tiles"] > 1:
        assert p["depth"] >= 2
        # 32 rows of 64 lanes at depth 2 take 16 bytes past a quarter SM
        assert p["smem"] <= scan.EMA_SCAN_SMEM == 57_344 or (
            p["rows"] == 32 and p["tile"] == 64 and p["depth"] == 2)
    assert p["blocks"] * p["rows"] >= R > (p["blocks"] - 1) * p["rows"]
    assert p["blocks"] < 2**31
    assert 1 <= p["tile"] <= L and p["tile"] >= min(L, 64)
    assert p["tiles"] == -(-L // p["tile"])
    assert 1 <= p["depth"] <= min(4, p["tiles"])
    assert p["form"] == ("rows" if p["tile"] == L else "tiles")
    assert p["smem"] <= SMEM_LIMIT == 232_448
    lay = scan.ema_scan_layout(p["rows"], p["tile"], p["depth"], L, itemsize)
    assert lay["total"] == p["smem"]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", SHAPES[:-2], ids=lambda s: f"{s[0]}x{s[1]}")
def test_layout_spans_and_strides(shape, itemsize):
    R, L = shape
    p = scan.ema_scan_plan(R, L, itemsize)
    rows, tile = p["rows"], p["tile"]
    lay = scan.ema_scan_layout(rows, tile, p["depth"], L, itemsize)
    for k in ("px", "pv", "raw_v", "slot", "slots", "planes", "plane"):
        assert lay[k] % 16 == 0, k
    assert lay["slots"] >= 8 * p["depth"]
    # rows an odd number of 16-byte words apart, room for whole packs
    words = lay["stride"] * itemsize / 16
    assert words == int(words) and int(words) % 2 == 1
    assert lay["stride"] >= -(-tile * itemsize // 16) * 16 // itemsize
    assert lay["plane"] == rows * lay["stride"] * itemsize
    whole = p["form"] == "rows"
    n = rows * L if whole else tile
    # any start of an item (x on its element size, valid on any byte)
    for off in range(16):
        if off % itemsize == 0:
            assert _span(off, n * itemsize) <= lay["px"]
        assert _span(off, n) <= lay["pv"]
    assert lay["raw_v"] >= (1 if whole else rows) * lay["px"]
    assert lay["slot"] == lay["raw_v"] + (1 if whole else rows) * lay["pv"]
    assert lay["total"] == (lay["planes"]
                            + (2 if whole else 4) * lay["plane"])


@pytest.mark.parametrize("R, L, itemsize, match", [
    (0, 8, 4, "int32"), (8, 0, 4, "int32"), (2**31, 8, 4, "int32"),
    (8, 2**31, 4, "int32"), (8, 8, 2, "float32 or float64")])
def test_plan_refuses_what_the_kernel_does_not_take(R, L, itemsize, match):
    with pytest.raises((ValueError, TypeError), match=match):
        scan.ema_scan_plan(R, L, itemsize)


def test_plan_reads_the_cards_sms():
    assert scan.ema_scan_plan(2048, 4096, 4, sms=16)["rows"] == 32
    assert scan.ema_scan_plan(2048, 4096, 4, sms=64)["rows"] == 8
    p = scan.ema_scan_plan(2048, 4096, 4)
    assert (p["rows"], p["tile"], p["depth"]) == (4, 512, 2)
    # float64 halves the tile to keep four blocks an SM
    p = scan.ema_scan_plan(2048, 4096, 8)
    assert (p["rows"], p["tile"], p["depth"]) == (4, 256, 2)
    assert scan.ema_scan_plan(1, 1 << 20, 4)["depth"] == 2


@pytest.mark.parametrize("alpha", [0.2, 1.0])
@pytest.mark.parametrize("shape", [(1, 16, 64), (2, 16, 64), (4, 3, 2, 8),
                                   (64, 8)],
                         ids=["serving", "push", "cohort", "cohort_flat"])
def test_plain_against_the_reference_at_serving_shapes(shape, alpha):
    rng = np.random.default_rng(len(shape) + int(alpha * 10))
    x = (rng.standard_normal(shape) * 50).astype(np.float32)
    valid = rng.random(shape) > 0.25
    y0 = (rng.standard_normal(shape[:-1]) * 5).astype(np.float32)
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
