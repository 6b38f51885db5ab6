"""The port's training step against the JAX package's, on the CPU in fp32.

The JAX step is ``__graft_entry__.py``'s: ``jax.value_and_grad`` of the
next-token loss (fp32 log-softmax, mean over ``ids[:, 1:]``) over the
cache-free ``forward``, then SGD with lr 1e-3. Weights come from the JAX
package's ``init_params`` through ``from_jax_params``, ids from numpy; with
``Impl(attention="flash")`` the JAX attention runs ``flash_attention_diff``
(K1 forward, K13 backward) in Pallas interpret mode and the port's the
plain versions of K1 and K13. The loss, every gradient leaf and the loss
after one step agree within atol = rtol = 1e-4 (fp32 summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import Impl as JaxImpl
from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.models.transformer import rope_cos_sin as jax_rope_cos_sin
from mlio_tpu.models.transformer import run_layer_stack as jax_run_layer_stack
from mlio_tpu_torch.models import Impl, forward, from_jax_params, get_spec, rope_cos_sin
from mlio_tpu_torch.models import run_layer_stack
from mlio_tpu_torch.runtime import next_token_loss, sgd_step, trainable

TOL = dict(atol=1e-4, rtol=1e-4)
MODELS = ["gpt2-tiny", "llama-tiny"]
IMPLS = {"flash": dict(attention="flash"), "dense": dict()}
LR = 1e-3


def _both(name):
    jspec = JAX_PRESETS[name]
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, get_spec(name), params


def _ids(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _jax_loss(jspec, impl):
    def loss_fn(params, ids):
        logits, _ = jax_forward(params, jspec, ids[:, :-1], impl=impl)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, ids[:, 1:, None], -1))
    return loss_fn


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        elif val is not None:
            yield prefix + (key,), val


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax(name, impl):
    jspec, jparams, spec, params = _both(name)
    ids = _ids(spec.vocab_size, (2, 97))
    loss_fn = _jax_loss(jspec, JaxImpl(**IMPLS[impl]))
    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams, jnp.asarray(ids))

    leaves = trainable(params)
    tids = torch.from_numpy(ids).long()
    loss = next_token_loss(params, spec, tids, impl=Impl(**IMPLS[impl]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    checked = 0
    for path, leaf in _leaves(params):
        want = np.asarray(_at(jgrads, path))
        np.testing.assert_allclose(leaf.grad.numpy(), want, err_msg=str(path), **TOL)
        checked += 1
    assert checked == len(leaves)

    # one SGD step, then the loss again
    sgd_step(leaves, LR)
    assert all(p.grad is None for p in leaves)
    jnew = jax.tree_util.tree_map(lambda p, g: p - LR * g, jparams, jgrads)
    with torch.no_grad():
        loss2 = next_token_loss(params, spec, tids, impl=Impl(**IMPLS[impl]))
    np.testing.assert_allclose(loss2.item(), float(loss_fn(jnew, jnp.asarray(ids))), **TOL)
    for path, leaf in _leaves(params):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(_at(jnew, path)),
                                   err_msg=str(path), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_forward_positions_and_hidden_match_jax(name):
    jspec, jparams, spec, params = _both(name)
    ids = _ids(spec.vocab_size, (2, 24), seed=1)
    pos = np.random.default_rng(2).integers(0, 100, size=(2, 24)).astype(np.int32)
    for return_hidden in (False, True):
        want, _ = jax_forward(jparams, jspec, jnp.asarray(ids), impl=JaxImpl(attention="flash"),
                              positions=jnp.asarray(pos), return_hidden=return_hidden)
        got, cache = forward(params, spec, torch.from_numpy(ids).long(),
                             impl=Impl(attention="flash"), positions=torch.from_numpy(pos).long(),
                             return_hidden=return_hidden)
        assert cache is None
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_run_layer_stack_matches_jax(name):
    jspec, jparams, spec, params = _both(name)
    x = np.random.default_rng(3).standard_normal((2, 20, spec.hidden_size)).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)[None].repeat(2, 0)
    jcos = jsin = cos = sin = None
    if spec.positional != "learned":
        jcos, jsin = jax_rope_cos_sin(jnp.asarray(pos), spec.rope_dim, spec.rope_theta)
        cos, sin = rope_cos_sin(torch.from_numpy(pos), spec.rope_dim, spec.rope_theta)
    for impl in IMPLS.values():
        want = jax_run_layer_stack(jnp.asarray(x), jparams["blocks"], jspec, JaxImpl(**impl),
                                   jcos, jsin)
        got = run_layer_stack(torch.from_numpy(x), params["blocks"], spec, Impl(**impl), cos,
                              sin)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
