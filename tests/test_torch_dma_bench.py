"""The port's bandwidth probe streams (K14) against ``dma_bench.py``'s
kernels.

``dma_bench._auto_kernel`` and ``_manual_kernel`` are wrapped here in a
``pl.pallas_call`` with the harness's own specs (an SMEM scalar, the chunk
stream, depth-N VMEM slots and DMA semaphores for the manual one) and run in
Pallas interpret mode on the CPU at a tiny ``[n, 16, 128]``; the port's
plain versions take the same numpy inputs. Both sum in fp32: atol = rtol =
1e-5. The wrappers on CPU tensors run the plain versions and launch nothing.
The streams' checksum (the port's own, with no JAX counterpart) is held
against its definition in numpy.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import dma_bench  # noqa: E402

from mlio_tpu_torch.utils import dma_bench as db  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
R, C = 16, 128


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, R, C)).astype(np.float32)
    w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    return w, np.float32(rng.standard_normal())


def _jax_auto(w, x):
    n = w.shape[0]
    return pl.pallas_call(
        dma_bench._auto_kernel,
        grid=(n,),
        in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
                  pl.BlockSpec((1, R, C), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True,
    )(jnp.full((1, 1), x, jnp.float32), jnp.asarray(w, jnp.bfloat16))


def _jax_manual(w, x, depth, streams):
    n = w.shape[0]
    return pl.pallas_call(
        functools.partial(dma_bench._manual_kernel, n=n, depth=depth, streams=streams),
        in_specs=[pl.BlockSpec((1, 1), lambda: (0, 0), memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((8, 128), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((streams, depth, R, C), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((streams, depth))],
        interpret=True,
    )(jnp.full((1, 1), x, jnp.float32), jnp.asarray(w, jnp.bfloat16))


def _checksum(w):
    """sum_j word_j * (j + 1) mod 2^32 over w's 32-bit words, in numpy."""
    words = w.contiguous().view(torch.int32).numpy().reshape(-1).astype(np.uint32)
    return int((words.astype(np.uint64) * np.arange(1, words.size + 1, dtype=np.uint64)).sum()
               & 0xFFFFFFFF)


@pytest.mark.parametrize("n", [1, 5])
def test_auto_stream_matches_jax_kernel(n):
    w, x = _inputs(n, n)
    want = np.asarray(_jax_auto(w, x))
    tw, tx = torch.from_numpy(w).to(torch.bfloat16), torch.tensor([x])
    before = db.auto_stream.launches
    got, checksum = db.auto_stream(tw, tx)
    assert db.auto_stream.launches == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert int(checksum) & 0xFFFFFFFF == _checksum(tw)
    np.testing.assert_allclose(db.auto_stream_plain(tw, tx).numpy(), want, **TOL)


@pytest.mark.parametrize("n,depth,streams", [(4, 2, 1), (7, 3, 1), (6, 2, 2)])
def test_manual_stream_matches_jax_kernel(n, depth, streams):
    w, x = _inputs(n, 10 + n)
    want = np.asarray(_jax_manual(w, x, depth, streams))
    tw, tx = torch.from_numpy(w).to(torch.bfloat16), torch.tensor([x])
    before = db.manual_stream.launches
    got, checksum = db.manual_stream(tw, tx, depth=depth, streams=streams)
    assert db.manual_stream.launches == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert int(checksum) & 0xFFFFFFFF == _checksum(tw)


def test_chunk_geometry_matches_harness():
    """A chunk of ``chunk_mb`` MB is [512, C] bf16 with dma_bench.py's C."""
    for mb in (1, 4, 16):
        assert db.ROWS * db.chunk_cols(mb) * 2 == mb << 20
        assert db.chunk_cols(mb) == mb << 20 >> 10


@pytest.mark.parametrize("n", [1, 3])
def test_checksum_sees_skipped_and_repeated_slices(n):
    """The plain checksum matches its numpy definition and changes when a
    slice of the stream is dropped or read twice in another's place."""
    w = torch.from_numpy(_inputs(n, 20 + n)[0]).to(torch.bfloat16)
    assert db.checksum_plain(w) == _checksum(w)
    flat = w.reshape(-1)
    repeated = flat.clone()
    repeated[64:128] = flat[:64]
    skipped = flat.clone()
    skipped[64:128] = 0
    for bad in (repeated, skipped):
        assert db.checksum_plain(bad) != db.checksum_plain(w)
