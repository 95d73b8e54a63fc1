"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package (``repro``) and the PyTorch port (``repro_torch``); nothing here
needs a GPU: every port object is built with ``device="cpu"``.
"""
import contextlib
import dataclasses

import numpy as np
import torch


def to_jax(x, dtype=None):
    import jax.numpy as jnp
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(dtype)


def to_torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def as_np(x):
    """jax or torch array -> float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def jax_tree_to_numpy(tree):
    """The framework -> numpy step of the conversion (bf16 widens exactly
    to float32)."""
    import jax
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def reduced_pair(name, **kw):
    """The same reduced architecture from both packages' registries."""
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config as torch_get
    return jax_get(name).reduced(**kw), torch_get(name).reduced(**kw)


def model_pair(name, seed=0, q_chunk=8, kv_chunk=8, seq_chunk=8, **kw):
    """(jax model, jax params, torch model) with identical weights: drawn by
    the reference's init, carried over as numpy, loaded by the converter.
    ``seq_chunk`` is the recurrences' chunk: a forward's length must be a
    multiple of it."""
    import jax
    from repro.models.api import RunConfig as JRun, build_model as jbuild
    from repro_torch import convert
    from repro_torch.models.api import RunConfig as TRun, build_model

    cj, ct = reduced_pair(name, **kw)
    mj = jbuild(cj, JRun(q_chunk=q_chunk, kv_chunk=kv_chunk,
                         seq_chunk=seq_chunk))
    pj = mj.init_params(jax.random.PRNGKey(seed))
    mt = build_model(ct, TRun(q_chunk=q_chunk, kv_chunk=kv_chunk,
                              seq_chunk=seq_chunk), device="cpu")
    convert.load_params(mt, jax_tree_to_numpy(pj))
    return mj, pj, mt


@contextlib.contextmanager
def attn_impl(model, impl):
    """The model with ``RunConfig.attn_impl = impl`` inside the block."""
    old = model.run
    model.run = dataclasses.replace(old, attn_impl=impl)
    try:
        yield model
    finally:
        model.run = old


@contextlib.contextmanager
def training(model):
    """The model as the trainer runs it inside the block: the plain
    attention and recurrence forms, gradients on for every parameter."""
    with attn_impl(model, "plain"):
        model.requires_grad_(True)
        try:
            yield model
        finally:
            model.requires_grad_(False)


def grads_of(model, batch):
    """(loss, {name: grad}) of ``model.loss_fn`` under ``training``."""
    with training(model):
        params = dict(model.named_parameters())
        loss = model.loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def assert_grads_close(got, want, rtol=1e-3, atol=1e-4):
    """Every gradient leaf within ``atol``/``rtol`` of the reference's.
    ``atol`` counts in units of the leaf's largest gradient where that
    exceeds 1: the embedding and position tables collect gradients of
    order 10 (a norm right after a lookup at scale 0.02 multiplies its
    input's gradient by ~1/std), and fp32 round-off in them grows with
    that scale, while a row's small entries keep it."""
    assert set(got) == set(want)
    for k, g in got.items():
        ref = np.asarray(want[k], np.float32)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(as_np(g), ref, rtol=rtol,
                                   atol=atol * scale, err_msg=k)


@contextlib.contextmanager
def torch_threads(n):
    """PyTorch's intra-op threads set to ``n`` inside the block. The
    parity tests' tensors are small and the suite runs in several
    processes at once: one thread each keeps them from contending for
    the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
