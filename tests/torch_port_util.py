"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package (``repro``) and the PyTorch port (``repro_torch``); nothing here
needs a GPU: every port object is built with ``device="cpu"``.
"""
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


def model_pair(name, seed=0, q_chunk=8, kv_chunk=8, **kw):
    """(jax model, jax params, torch model) with identical weights: drawn by
    the reference's init, carried over as numpy, loaded by the converter."""
    import jax
    from repro.models.api import RunConfig as JRun, build_model as jbuild
    from repro_torch import convert
    from repro_torch.models.api import RunConfig as TRun, build_model

    cj, ct = reduced_pair(name, **kw)
    mj = jbuild(cj, JRun(q_chunk=q_chunk, kv_chunk=kv_chunk))
    pj = mj.init_params(jax.random.PRNGKey(seed))
    mt = build_model(ct, TRun(q_chunk=q_chunk, kv_chunk=kv_chunk),
                     device="cpu")
    convert.load_params(mt, jax_tree_to_numpy(pj))
    return mj, pj, mt
