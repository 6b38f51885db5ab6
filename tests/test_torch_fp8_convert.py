"""The port's weight-widening probe (K15) against ``exp_fp8_convert.py``.

``exp_fp8_convert._kernel`` is wrapped here in a ``pl.pallas_call`` with
the script's own specs (x in VMEM, the chunk stream in HBM, three VMEM
slots and DMA semaphores) and run in Pallas interpret mode on the CPU at a
tiny ``[n, 16, 128]`` (the script's module constant ``C``, the width of its
accumulator, set to 128 for the call); the port's plain version takes the
same numpy-seeded inputs. Every widened weight is exact in bf16 and both sum
in fp32: atol = rtol = 1e-5. The widenings are checked over all 256 bytes
against the script's ``_convert``, fp8-bits' misreading of subnormals (which
the probe's data avoids) included.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import exp_fp8_convert  # noqa: E402

from mlio_tpu_torch.utils import dma_bench as db  # noqa: E402
from mlio_tpu_torch.utils import fp8_convert as fc  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
R, C = 16, 128


def _jax_kernel(x, w, how, monkeypatch):
    monkeypatch.setattr(exp_fp8_convert, "C", C)
    n = w.shape[0]
    return pl.pallas_call(
        functools.partial(exp_fp8_convert._kernel, n=n, how=how),
        in_specs=[pl.BlockSpec((8, R), lambda: (0, 0)), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((8, C), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, C), jnp.float32),
        scratch_shapes=[pltpu.VMEM((3, R, C), w.dtype), pltpu.SemaphoreType.DMA((3,))],
        interpret=True,
    )(x, w)


def _inputs(variant, n, seed):
    """Seeded x [8, R] bf16 and w [n, R, C] (the port's draw: int8 over
    [-127, 127], e4m3 over zero and the normals) for both packages."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((8, R), generator=gen).to(torch.bfloat16)
    w = fc.draw_weights(variant, n, R, C, gen)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    raw = w.view(torch.uint8).numpy() if variant != "int8" else w.numpy()
    jw = jnp.asarray(raw.view(ml_dtypes.float8_e4m3fn) if variant != "int8" else raw)
    return x, w, jx, jw


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("variant", fc.VARIANTS)
def test_plain_matches_jax_kernel(variant, n, monkeypatch):
    x, w, jx, jw = _inputs(variant, n, 7 * n)
    want = np.asarray(_jax_kernel(jx, jw, variant, monkeypatch))
    before = fc.widen_matmul.launches
    got = fc.widen_matmul(x, w, variant)
    assert fc.widen_matmul.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("variant", ["fp8", "fp8-f32", "fp8-bits"])
def test_widen_plain_matches_convert_on_every_byte(variant):
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(fc.FP8)
    jw = jnp.asarray(every.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
    want = np.asarray(exp_fp8_convert._convert(jw, variant).astype(jnp.float32))
    got = fc.widen_plain(every, variant).float().numpy()
    np.testing.assert_array_equal(got, want)
    subnormal = ((np.arange(256) & 0x78) == 0) & ((np.arange(256) & 7) != 0)
    true = every.float().numpy()
    assert (got[subnormal] != true[subnormal]).all() == (variant == "fp8-bits")


def test_draw_weights_avoid_nan_and_subnormals():
    w = fc.draw_weights("fp8", 2, 64, 64, torch.Generator().manual_seed(0))
    raw = w.view(torch.uint8).int()
    exp, low7 = (raw >> 3) & 0xF, raw & 0x7F
    assert not ((exp == 0) & (low7 != 0)).any() and not (low7 == 0x7F).any()
    assert torch.isfinite(w.float()).all() and (low7 == 0).any()
    assert len(torch.unique(raw)) > 200
    q = fc.draw_weights("int8", 2, 64, 64, torch.Generator().manual_seed(0))
    assert q.min() >= -127 and q.max() <= 127 and q.dtype == torch.int8


def test_wrapper_refuses_bad_inputs_and_bound():
    x = torch.zeros((8, R), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be torch.int8"):
        fc.widen_matmul(x, torch.zeros((1, R, C), dtype=fc.FP8), "int8")
    with pytest.raises(ValueError, match="unknown variant"):
        fc.widen_matmul(x, torch.zeros((1, R, C), dtype=torch.int8), "int4")
    with pytest.raises(ValueError, match=r"x must be \[8, R\]"):
        fc.widen_matmul(x[:4], torch.zeros((1, R, C), dtype=torch.int8), "int8")
    nbytes = fc.N_CHUNKS * fc.R * fc.C
    ms, by = db.bound_ms(nbytes, 2 * nbytes * 8, 3240e9, fc.FP32_FLOPS)
    assert by == "bytes" and abs(ms - nbytes / 3240e9 * 1e3) < 1e-12
    ms, by = db.bound_ms(nbytes, 2 * nbytes * 8, 1e15, fc.FP32_FLOPS)
    assert by == "operations" and abs(ms - 2 * nbytes * 8 / fc.FP32_FLOPS * 1e3) < 1e-12
