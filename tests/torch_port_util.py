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


# the ops behind ``.item()``, ``.tolist()`` and ``bool()`` of a tensor: under
# inference mode they reach a dispatch mode as ``item`` and ``is_nonzero``,
# outside it as ``_local_scalar_dense``. On the card each is a host
# synchronisation, which a CUDA graph cannot hold
HOST_READS = (torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.item.default,
              torch.ops.aten.is_nonzero.default)


def no_host_reads():
    """A dispatch mode that fails on any op of ``HOST_READS``: around the
    body of a step that a CUDA graph is to capture."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in HOST_READS:
                raise AssertionError("the step read a tensor on the host")
            return func(*args, **(kwargs or {}))

    return NoHostReads()


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


# -- meshes: ranks on a gloo group of CPU processes, the reference on fake
#    devices in a subprocess ------------------------------------------------

SRC = __import__("os").path.join(__import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))),
    "src")


def spawn_gloo(job, world, tmp_path, *args, timeout=300):
    """``job(rank, world, *args)`` on ``world`` CPU processes joined in one
    gloo group (``repro_torch.launch.mesh.run_ranks``)."""
    import uuid
    from repro_torch.launch.mesh import run_ranks
    run_ranks(job, world, args, timeout=timeout,
              rendezvous=str(tmp_path / f"rendezvous-{uuid.uuid4().hex}"))


def start_jax_mesh(fn_name, n_devices, *args):
    """Start ``torch_port_util.<fn_name>(*args)`` in a subprocess whose JAX
    sees ``n_devices`` fake CPU devices (as tests/test_moe.py's mesh tests
    do); returns the ``Popen``. Arguments are strings."""
    import os
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, tests]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    code = (f"import torch_port_util as u; u.{fn_name}"
            f"(*{list(args)!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def fake_mesh(shape, coord, names=("data", "model")):
    """A ``sharding.Mesh`` with a shape and this rank's coordinate but no
    process group: enough to build a model's shards (on the meta device)
    and to read ``size``/``index``."""
    from repro_torch.models.sharding import Mesh
    mesh = Mesh.__new__(Mesh)
    mesh.axis_names, mesh.axis_sizes = tuple(names), tuple(shape)
    mesh.coord = dict(zip(names, coord))
    mesh.device_type = "cpu"
    return mesh


def local_rows(a, mesh, spec):
    """The rank's part of a numpy/torch array laid out by ``spec``."""
    from repro_torch.models import sharding as S
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return S.local_shard(t, spec, mesh).contiguous()


# the mesh parity cases (tests/test_torch_mesh.py) ---------------------------

MESH_DENSE = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
                  vocab=256)
MESH_B, MESH_S = 4, 16               # batch, prefill length
MESH_SMAX, MESH_START, MESH_STEPS = 16, 6, 4   # decode crosses position 8
MESH_T = 32                           # MoE tokens
MESH_SLOT_LENS = [7, 9, 8, 11]        # per-slot lengths of one more step
# 12 query heads on 3 KV heads (a group of 4) over 2 model ranks: 6 heads a
# rank, which split a group, so each reads its KV head by index
MESH_UNEVEN = dict(n_layers=2, d_model=96, n_heads=12, n_kv_heads=3,
                   d_ff=128, vocab=256)


def _fan_in_weights(cfg, rng, prefix, out):
    """Every parameter of ``cfg``'s DecoderLM drawn at its per-layer
    fan-in (well-conditioned attention), norms near 1."""
    from repro_torch.models.api import RunConfig, build_model
    for k, (shape, _) in build_model(cfg, RunConfig(), device="meta") \
            .param_shapes().items():
        if k.endswith(("ln1", "ln2", "norm")):
            out[prefix + k] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan = shape[-2] if len(shape) == 3 else (
                1 / 0.02 ** 2 if k == "embed" else shape[0])
            out[prefix + k] = rng.standard_normal(shape) / np.sqrt(fan)


def mesh_inputs(path):
    """Weights and inputs of the mesh parity cases, drawn with numpy, saved
    as one .npz that both sides read. Dense weights at their per-layer
    fan-in (well-conditioned attention), MoE as tests/test_torch_moe.py."""
    from repro_torch.configs import get_config
    rng = np.random.default_rng(17)
    cfg = get_config("qwen3-32b").reduced(**MESH_DENSE)
    out = {}
    _fan_in_weights(cfg, rng, "w.", out)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    out["tokens"] = rng.integers(0, cfg.vocab, (MESH_B, MESH_S))
    cache = np.zeros((2, cfg.n_layers, MESH_B, MESH_SMAX, hkv, hd))
    cache[:, :, :, :MESH_START] = rng.standard_normal(
        (2, cfg.n_layers, MESH_B, MESH_START, hkv, hd))
    out["cache"] = cache
    out["dec_tokens"] = rng.integers(0, cfg.vocab, (MESH_B, MESH_STEPS))
    acfg = get_config("arctic-480b").reduced()
    e, d = acfg.moe, acfg.d_model
    for k, (shape, sc) in {
            "router": ((d, e.n_experts), 0.5),
            "e_gate": ((e.n_experts, d, e.d_ff_expert), 0.1),
            "e_up": ((e.n_experts, d, e.d_ff_expert), 0.1),
            "e_down": ((e.n_experts, e.d_ff_expert, d), 0.1),
            "r_gate": ((d, e.dense_residual_ff), 0.1),
            "r_up": ((d, e.dense_residual_ff), 0.1),
            "r_down": ((e.dense_residual_ff, d), 0.1)}.items():
        out["moe." + k] = rng.standard_normal(shape) * sc
    out["moe_x"] = rng.standard_normal((2, MESH_T // 2, d))
    _fan_in_weights(get_config("qwen3-32b").reduced(**MESH_UNEVEN), rng,
                    "u.", out)
    np.savez(path, **{k: np.asarray(v, np.float32 if v.dtype.kind == "f"
                                     else np.int32) for k, v in out.items()})


def _jax_tree(z, prefix):
    import jax.numpy as jnp
    tree = {}
    for k in z.files:
        if not k.startswith(prefix):
            continue
        node = tree
        *parents, leaf = k[len(prefix):].split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(z[k])
    return tree


def jax_mesh_main(inputs, out):
    """The reference's side of the mesh cases, on 4 fake devices."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch.steps import _shard
    from repro.models.api import RunConfig, build_model
    from repro.models.moe import moe_ffn
    from repro.models.sharding import compat_make_mesh, use_mesh
    z = np.load(inputs)
    cfg = get_config("qwen3-32b").reduced(**MESH_DENSE)
    params = _jax_tree(z, "w.")
    res = {}
    # tensor-parallel forward on (1, 4)
    mesh = compat_make_mesh((1, 4), ("data", "model"))
    with use_mesh(mesh):
        m = build_model(cfg, RunConfig(q_chunk=8, kv_chunk=8,
                                       data_axes=("data",)))
        shape = ShapeSpec("p", MESH_S, MESH_B, "prefill")
        f = jax.jit(m.forward, in_shardings=(
            _shard(mesh, m.param_pspecs()), _shard(mesh, m.input_pspecs(
                shape))))
        res["tp_logits"] = f(params, {"tokens": jnp.asarray(z["tokens"])})
    # sequence-sharded decode on (2, 2)
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    with use_mesh(mesh):
        m = build_model(cfg, RunConfig(q_chunk=8, kv_chunk=8,
                                       data_axes=("data",),
                                       sharded_decode=True))
        shape = ShapeSpec("d", MESH_SMAX, MESH_B, "decode")
        step = jax.jit(m.decode_step, in_shardings=(
            _shard(mesh, m.param_pspecs()), _shard(mesh, m.cache_pspecs(
                shape)), _shard(mesh, m.input_pspecs(shape))))
        cache = {"k": jnp.asarray(z["cache"][0]),
                 "v": jnp.asarray(z["cache"][1])}
        for t in range(MESH_STEPS):
            batch = {"tokens": jnp.asarray(z["dec_tokens"][:, t:t + 1]),
                     "cache_len": jnp.asarray(MESH_START + t, jnp.int32)}
            logits, cache = step(params, cache, batch)
            res[f"dec_logits_{t}"] = logits
        res["dec_k"], res["dec_v"] = cache["k"], cache["v"]
        # per-slot lengths: the scatter branch, on the same sharded cache
        res["slot_logits"], cache = step(params, cache, {
            "tokens": jnp.asarray(z["dec_tokens"][:, :1]),
            "cache_len": jnp.asarray(MESH_SLOT_LENS, jnp.int32)})
        res["slot_k"] = cache["k"]
        # uneven head groups: forward, then sharded decode from empty
        ucfg = get_config("qwen3-32b").reduced(**MESH_UNEVEN)
        um = build_model(ucfg, RunConfig(q_chunk=8, kv_chunk=8,
                                         data_axes=("data",),
                                         sharded_decode=True))
        uparams = _jax_tree(z, "u.")
        pshape = ShapeSpec("p", MESH_S, MESH_B, "prefill")
        res["uneven_logits"] = jax.jit(um.forward, in_shardings=(
            _shard(mesh, um.param_pspecs()), _shard(mesh, um.input_pspecs(
                pshape))))(uparams, {"tokens": jnp.asarray(z["tokens"])})
        ustep = jax.jit(um.decode_step, in_shardings=(
            _shard(mesh, um.param_pspecs()), _shard(mesh, um.cache_pspecs(
                shape)), _shard(mesh, um.input_pspecs(shape))))
        ucache = {k: np.zeros(v.shape, np.float32)     # uncommitted
                  for k, v in um.init_cache(shape).items()}
        for t in range(MESH_STEPS):
            logits, ucache = ustep(uparams, ucache, {
                "tokens": jnp.asarray(z["tokens"][:, t:t + 1]),
                "cache_len": jnp.asarray(t, jnp.int32)})
            res[f"uneven_dec_{t}"] = logits
    # expert-parallel MoE on (1, 4) with drops, and FSDP experts on (2, 2)
    acfg = get_config("arctic-480b").reduced()
    w = _jax_tree(z, "moe.")
    x = jnp.asarray(z["moe_x"])
    for name, shape, run in (
            ("ep", (1, 4), RunConfig(data_axes=("data",),
                                     moe_capacity_factor=1.25)),
            ("fsdp", (2, 2), RunConfig(data_axes=("data",),
                                       fsdp_experts=True,
                                       moe_capacity_factor=8.0))):
        mesh = compat_make_mesh(shape, ("data", "model"))
        with use_mesh(mesh):
            res["moe_" + name] = jax.jit(
                lambda w, x, run=run: moe_ffn(acfg, run, w, x))(w, x)
    np.savez(out, **{k: np.asarray(v, np.float32) for k, v in res.items()})
    print("jax mesh ok")


def port_mesh_job(rank, world, inputs, out):
    """The port's side of the mesh cases, one rank of 4 gloo CPU ranks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import moe as TM
    from repro_torch.models import sharding as S
    from repro_torch.models.api import RunConfig, build_model
    from repro_torch.models.sharding import P
    z = np.load(inputs)
    cfg = get_config("qwen3-32b").reduced(**MESH_DENSE)
    full = {k[2:]: torch.from_numpy(z[k]) for k in z.files
            if k.startswith("w.")}
    res = {}

    def model(mesh, **run):
        with S.use_mesh(mesh):
            m = build_model(cfg, RunConfig(q_chunk=8, kv_chunk=8,
                                           data_axes=("data",), **run),
                            device="cpu")
        m.load_state_dict(S.shard_state_dict(full, m.param_pspecs(), mesh))
        return m

    with torch.no_grad():
        # tensor-parallel forward on (1, 4)
        mesh = S.make_mesh((1, 4), ("data", "model"), "cpu")
        m = model(mesh)
        res["tp_logits"] = m.forward({"tokens": torch.from_numpy(
            z["tokens"])})
        # the init on the mesh keeps the single-device draw's slices, at
        # both scales and with the head groups split unevenly
        same = []
        for c, fan in ((cfg, False), (cfg, True),
                       (get_config("qwen3-32b").reduced(**MESH_UNEVEN),
                        True)):
            one = build_model(c, RunConfig(), device="cpu").init_params(
                torch.Generator().manual_seed(3), layer_fan_in=fan)
            with S.use_mesh(mesh):
                sh = build_model(c, RunConfig(), device="cpu").init_params(
                    torch.Generator().manual_seed(3), layer_fan_in=fan)
            specs = sh.param_pspecs()
            same += [torch.equal(v, S.local_shard(one.state_dict()[k],
                                                  specs[k], mesh))
                     for k, v in sh.state_dict().items()]
        res["init_equal"] = torch.tensor(float(all(same)))
        # decode on (2, 2): sharded, gathered, per-slot lengths
        mesh = S.make_mesh((2, 2), ("data", "model"), "cpu")
        shape = ShapeSpec("d", MESH_SMAX, MESH_B, "decode")
        bspec = P(("data",), None)
        toks = local_rows(z["dec_tokens"], mesh, bspec)
        for name, sharded in (("dec", True), ("gath", False)):
            m = model(mesh, sharded_decode=sharded)
            spec = m.cache_pspecs(shape)["k"]
            cache = {kv: local_rows(z["cache"][i], mesh, spec)
                     for i, kv in enumerate("kv")}
            for t in range(MESH_STEPS):
                logits, cache = m.decode_step(cache, {
                    "tokens": toks[:, t:t + 1],
                    "cache_len": torch.tensor(MESH_START + t)})
                res[f"{name}_logits_{t}"] = logits
            res[f"{name}_k"], res[f"{name}_v"] = cache["k"], cache["v"]
        lens = torch.tensor(MESH_SLOT_LENS)
        res["slot_logits"], cache = m.decode_step(cache, {
            "tokens": toks[:, :1],
            "cache_len": local_rows(lens, mesh, P(("data",)))})
        res["slot_k"] = cache["k"]
        # uneven head groups (MESH_UNEVEN) on (2, 2)
        ucfg = get_config("qwen3-32b").reduced(**MESH_UNEVEN)
        ufull = {k[2:]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("u.")}
        with S.use_mesh(mesh):
            um = build_model(ucfg, RunConfig(q_chunk=8, kv_chunk=8,
                                             data_axes=("data",),
                                             sharded_decode=True),
                             device="cpu")
        um.load_state_dict(S.shard_state_dict(ufull, um.param_pspecs(),
                                              mesh))
        utoks = local_rows(z["tokens"], mesh, bspec)
        res["uneven_logits"] = um.forward({"tokens": utoks})
        ucache = um.init_cache(shape)
        for t in range(MESH_STEPS):
            res[f"uneven_dec_{t}"], ucache = um.decode_step(ucache, {
                "tokens": utoks[:, t:t + 1], "cache_len": torch.tensor(t)})
        # expert-parallel MoE (drops) on (1, 4); FSDP experts on (2, 2)
        acfg = get_config("arctic-480b").reduced()
        w = {k[4:]: torch.from_numpy(z[k]) for k in z.files
             if k.startswith("moe.")}
        x = torch.from_numpy(z["moe_x"])
        TM.EXPERT_GATHER_BYTES = 1       # one expert per gather
        for name, shape_, run in (
                ("ep", (1, 4), RunConfig(data_axes=("data",),
                                         moe_capacity_factor=1.25)),
                ("fsdp", (2, 2), RunConfig(data_axes=("data",),
                                           fsdp_experts=True,
                                           moe_capacity_factor=8.0))):
            mesh = S.make_mesh(shape_, ("data", "model"), "cpu")
            specs = TM.moe_param_pspecs(acfg, "model", ("data",)
                                        if run.fsdp_experts else None)
            wl = {k: local_rows(v, mesh, P(*specs[k][1:]))
                  for k, v in w.items()}
            bspec = P(("data",), None, None)
            res["moe_" + name] = TM.moe_ffn(acfg, run, wl,
                                            local_rows(x, mesh, bspec), mesh)
    np.savez(f"{out}.{rank}.npz",
             **{k: v.float().numpy() for k, v in res.items()})


def port_sharding_job(rank, world, out):
    """Shards and collectives on 4 gloo CPU ranks (tests/
    test_torch_sharding.py): results to ``out.<rank>.json``."""
    import json
    from repro_torch.launch import mesh as LM
    from repro_torch.models import sharding as S
    from repro_torch.models.sharding import P
    res = {}
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 1, 2), ("pod", "data", "model"))):
        mesh = S.make_mesh(shape, names, "cpu")
        key = "x".join(map(str, shape))
        with S.use_mesh(mesh):
            res[key + ".sizes"] = S.mesh_axis_sizes()
            res[key + ".filter"] = [list(map(repr, S.filter_spec(s))) for s in (
                P(("pod", "data"), None, "model"), P("model", None),
                P(None, ("data", "model")))]
            res[key + ".coord"] = mesh.coord
            for spec in (P(("pod", "data"), None, "model"), P(None, "model"),
                         P(None, None, ("data", "model")), P()):
                loc = S.local_shard(full, spec)
                back = S.gather(loc, spec)
                res[f"{key}.{spec!r}"] = [list(loc.shape), loc.sum().item(),
                                          bool(torch.equal(back, full))]
            x = torch.full((3,), float(rank + 1))
            res[key + ".psum_model"] = S.psum(x, "model").tolist()
            res[key + ".psum_all"] = S.psum(
                x.to(torch.bfloat16), ("pod", "data", "model")).float().tolist()
            res[key + ".pmax_data"] = S.pmax(x, ("pod", "data")).tolist()
            res[key + ".gather_model"] = S.all_gather(
                x[None].to(torch.bfloat16), "model", 0).float().tolist()
            res[key + ".constrain"] = S.constrain(x, P(None)) is x
            try:
                S.local_shard(torch.zeros(6, 2), P("model", None), name="leaf")
                S.local_shard(torch.zeros(6, 2),
                              P(("pod", "data", "model"), None), name="w_odd")
            except ValueError as e:
                res[key + ".indivisible"] = str(e)
    m = LM.make_local_mesh(n_model=2, device_type="cpu")
    res["local_mesh"] = [LM.mesh_axis_names(m), list(m.axis_sizes)]
    for fn in (lambda: LM.make_production_mesh(device_type="cpu"),
               lambda: S.make_mesh((3,), ("data",), "cpu")):
        try:
            fn()
        except ValueError as e:
            res.setdefault("refused", []).append(str(e))
    with open(f"{out}.{rank}.json", "w") as fh:
        json.dump(res, fh)


# ZeRO-1 and elastic restore (tests/test_torch_zero1.py) ----------------------

ZERO1_TREE = {"w": (96, 16), "e": (128, 8), "b": (16,), "s": (3, 5)}
ZERO1_SPECS = {"w": (None, "model"), "e": ("model", None), "b": (None,),
               "s": (None, None)}
ZERO1_CFG = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)


def zero1_tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in ZERO1_TREE.items()}


def port_zero1_job(rank, world, out, phase):
    """Phase "steps" on (4, 1) and (2, 2): ZeRO-1 AdamW steps and the clip's
    norm with model-sharded leaves; a data-parallel Trainer with and
    without ZeRO-1, saving a checkpoint at step 2. Phase "resume" on
    (2, 1): that checkpoint restored, then steps 3 and 4."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer, run_config
    from repro_torch.models import sharding as S
    from repro_torch.models.sharding import P
    from repro_torch.train import optimizer as O
    torch.set_num_threads(1)     # one thread: bit-reproducible products
    res = {}
    cfg = get_config("smollm-360m").reduced(**ZERO1_CFG)
    kw = dict(seq=16, batch=8, lr=3e-3, seed=0, device="cpu")
    if phase == "steps":
        p0, grads = zero1_tree(1), [zero1_tree(2 + i) for i in range(2)]
        for shape in ((4, 1), (2, 2)):
            mesh = S.make_mesh(shape, ("data", "model"), "cpu")
            key = "x".join(map(str, shape))
            pspecs = {k: P(*v) for k, v in ZERO1_SPECS.items()}
            mu = O.adamw_pspecs(pspecs, {k: torch.empty(s) for k, s in
                                         ZERO1_TREE.items()},
                                use_zero1=True, dax=("data",)).mu
            params = {k: S.local_shard(torch.from_numpy(v), pspecs[k],
                                       mesh).clone() for k, v in p0.items()}
            state = O.adamw_init(params, pspecs, mu, mesh)
            for i, g in enumerate(grads):
                gl = {k: S.local_shard(torch.from_numpy(v), pspecs[k], mesh)
                      for k, v in g.items()}
                _, state, gnorm = O.adamw_update(
                    gl, state, params, lr=1e-2, grad_clip=5.0,
                    param_pspecs=pspecs, mu_pspecs=mu, mesh=mesh)
                res[f"{key}.gnorm{i}"] = gnorm
            for k in params:
                res[f"{key}.p.{k}"] = S.gather(params[k], pspecs[k], mesh)
                res[f"{key}.mu.{k}"] = S.gather(state.mu[k], mu[k], mesh)
                res[f"{key}.mu_local.{k}"] = torch.tensor(
                    state.mu[k].numel(), dtype=torch.float32)
        mesh = S.make_mesh((4, 1), ("data", "model"), "cpu")
        trs = {z: Trainer(cfg, run_config(zero1=z), mesh=mesh, **kw)
               for z in (True, False)}
        for i in range(4):
            for z, tr in trs.items():
                res[f"loss{int(z)}.{i}"] = tr.step(i)["loss"]
            if i == 1:
                trs[True].save(f"{out}.ck", 2)
                for k, v in trs[True].params.items():
                    res[f"p2.{k}"] = v.clone()
        for z, tr in trs.items():
            for k, v in tr.params.items():
                res[f"p4_{int(z)}.{k}"] = v
            res[f"moment_bytes{int(z)}"] = torch.tensor(
                float(tr.moment_bytes()))
    else:
        mesh = S.make_mesh((2, 1), ("data", "model"), "cpu")
        tr = Trainer(cfg, run_config(zero1=True), mesh=mesh, **kw)
        res["restored_at"] = torch.tensor(float(tr.restore(f"{out}.ck")))
        for k, v in tr.params.items():
            res[f"p2.{k}"] = v.clone()
        for k in tr.opt.mu:
            res[f"mu.{k}"] = S.gather(tr.opt.mu[k], tr.pspecs.mu[k], mesh)
        for i in (2, 3):
            res[f"loss.{i}"] = tr.step(i)["loss"]
        for k, v in tr.params.items():
            res[f"p4.{k}"] = v
    np.savez(f"{out}.{phase}.{rank}.npz",
             **{k: torch.as_tensor(v).detach().float().numpy()
                for k, v in res.items()})


# the other families on a mesh, and training on a model axis above one
# (tests/test_torch_mesh_train.py, tests/test_torch_mesh_families.py) --------

# reduced configs (ArchConfig.reduced(): 4 heads, vocabulary 512, zamba2's
# 8 SSD heads with a 296-column in_proj, 74 a rank): dense with qk_norm and
# one KV head read by every rank, dense with a tied head, MoE (EP), RWKV6,
# Zamba2, Whisper
MF_NAMES = ("qwen3-32b", "smollm-360m", "arctic-480b", "rwkv6-7b",
            "zamba2-2.7b", "whisper-small")
MF_B, MF_S = 2, 16                  # batch, length (seq_chunk 8)
MF_SMAX, MF_STEPS = 8, 4           # decode cache length, steps from 0
MF_LR = 3e-4


def mf_run(**kw):
    """Both packages' RunConfig fields of the mesh-family cases."""
    return dict(q_chunk=8, kv_chunk=8, seq_chunk=8, data_axes=("data",),
                **kw)


def mf_inputs(path):
    """Every family's reduced weights (the port's init, per-layer fan-in
    where the model has it; the router at scale 0.5, clear of top-k ties)
    and inputs, drawn from seeds, saved as one .npz both sides read."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import RunConfig, build_model
    out = {}
    for i, name in enumerate(MF_NAMES):
        cfg = get_config(name).reduced()
        m = build_model(cfg, RunConfig(), device="cpu")
        g = torch.Generator().manual_seed(100 + i)
        if cfg.family == "ssm":
            m.init_params(g)
        else:
            m.init_params(g, layer_fan_in=True)
        for k, v in m.state_dict().items():
            out[f"{name}|{k}"] = v.numpy() * (25.0 if k.endswith("router")
                                              else 1.0)
    rng = np.random.default_rng(7)
    out["tokens"] = rng.integers(0, 512, (MF_B, MF_S))
    out["labels"] = rng.integers(0, 512, (MF_B, MF_S))
    wcfg = get_config("whisper-small").reduced()
    out["frames"] = rng.standard_normal(
        (MF_B, wcfg.enc_dec.encoder_seq, wcfg.d_model))
    np.savez(path, **{k: np.asarray(v, np.float32 if v.dtype.kind == "f"
                                     else np.int32) for k, v in out.items()})


def mf_tree(z, name):
    """A family's weights from the .npz, as the reference's nested tree of
    numpy arrays."""
    from repro_torch.convert import unflatten_tree
    return unflatten_tree({k.split("|", 1)[1]: z[k] for k in z.files
                           if k.startswith(name + "|")})


def mf_batch(z, name, kind="train"):
    b = {"tokens": z["tokens"]}
    if kind == "train":
        b["labels"] = z["labels"]
    if name == "whisper-small":
        b["frames"] = z["frames"]
    return b


# (mesh shape, run overrides) of the AdamW steps, per family
MF_STEP_CASES = {
    "qwen3-32b": (((1, 4), {}), ((2, 2), {"use_zero1": True})),
    "arctic-480b": (((2, 2), {"use_zero1": True, "fsdp_experts": True}),),
    "rwkv6-7b": (((2, 2), {"use_zero1": True}),),
    "zamba2-2.7b": (((2, 2), {"use_zero1": True}),),
    "whisper-small": (((2, 2), {"use_zero1": True}),),
}


def jax_mesh_train_main(inputs, out):
    """The reference's side of tests/test_torch_mesh_train.py on 4 fake
    devices: loss and gradients on (1, 4) (``jax.value_and_grad`` of
    ``loss_fn``, jitted with the shardings of its specs) and one step of
    ``launch.steps.build_step(..., "train_4k", ...)`` per MF_STEP_CASES."""
    import jax
    import jax.numpy as jnp
    from repro.configs import SHAPES, get_config
    from repro.launch.steps import _shard, build_step
    from repro.models.api import RunConfig, build_model
    from repro.models.sharding import compat_make_mesh, use_mesh
    from repro.train.optimizer import adamw_init
    from repro_torch.convert import flatten_tree
    z = np.load(inputs)
    res = {}
    shape = SHAPES["train_4k"]
    for name in MF_NAMES:
        cfg = get_config(name).reduced()
        batch = {k: jnp.asarray(v) for k, v in mf_batch(z, name).items()}
        mesh = compat_make_mesh((1, 4), ("data", "model"))
        with use_mesh(mesh):
            m = build_model(cfg, RunConfig(**mf_run()))
            f = jax.jit(jax.value_and_grad(m.loss_fn), in_shardings=(
                _shard(mesh, m.param_pspecs()),
                _shard(mesh, m.input_pspecs(shape))))
            loss, grads = f(jax.tree.map(jnp.asarray, mf_tree(z, name)),
                            batch)
        res[f"{name}|loss"] = loss
        res.update({f"{name}|g|{k}": v
                    for k, v in flatten_tree(grads).items()})
        for mshape, over in MF_STEP_CASES.get(name, ()):
            key = f"{name}|{mshape[0]}x{mshape[1]}"
            mesh = compat_make_mesh(mshape, ("data", "model"))
            fn, _, _ = build_step(name, "train_4k", mesh,
                                  run_cfg=RunConfig(**mf_run(**over)),
                                  lr=MF_LR, cfg_override=cfg)
            params = jax.tree.map(jnp.asarray, mf_tree(z, name))
            opt, rng = adamw_init(params), jax.random.PRNGKey(0)
            # traced inside the mesh, as the gradients above: the MoE runs
            # its shard_map (expert-parallel routing and capacity)
            with use_mesh(mesh):
                params, _, metrics = fn(params, opt, batch, rng)
            res[f"{key}|loss"] = metrics["loss"]
            res[f"{key}|gnorm"] = metrics["grad_norm"]
            res.update({f"{key}|p|{k}": v
                        for k, v in flatten_tree(params).items()})
    np.savez(out, **{k: np.asarray(v, np.float32) for k, v in res.items()})
    print("jax mesh train ok")


def port_mesh_train_job(rank, world, inputs, out, ckpt):
    """The port's side of tests/test_torch_mesh_train.py, one rank of 4
    gloo CPU ranks: loss and gradients on (1, 4) through
    ``launch.steps.build_step``'s model (every rank saves them gathered),
    the AdamW steps of MF_STEP_CASES, and a checkpoint of the (1, 4) dense
    step for the one-device restore."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_step
    from repro_torch.models import sharding as S
    from repro_torch.models.api import RunConfig
    from repro_torch.train.checkpoint import named_shardings, save_checkpoint
    from repro_torch.train.train_step import loss_and_grads, optimizer_pspecs
    torch.set_num_threads(1)
    z = np.load(inputs)
    res = {}
    for name in MF_NAMES:
        cfg = get_config(name).reduced()
        batch = {k: torch.from_numpy(v)
                 for k, v in mf_batch(z, name).items()}
        cases = ((((1, 4), {}), False),) + tuple(
            (c, True) for c in MF_STEP_CASES.get(name, ()))
        for (mshape, over), step in cases:
            mesh = S.make_mesh(mshape, ("data", "model"), "cpu")
            key = f"{name}|{mshape[0]}x{mshape[1]}"
            fn, _, meta = build_step(
                name, "train_4k", mesh, lr=MF_LR, cfg_override=cfg,
                run_cfg=RunConfig(attn_impl="plain", **mf_run(**over)))
            model = meta["model"]
            convert.load_params(model, mf_tree(z, name))
            specs = model.param_pspecs()
            if not step:
                loss, grads = loss_and_grads(model, batch)
                res[f"{name}|loss"] = loss
                res.update({f"{name}|g|{k}": S.gather(g, specs[k], mesh)
                            for k, g in grads.items()})
                res.update({f"{name}|local|{k}": torch.tensor(
                    list(p.shape) == list(S.local_shape(
                        model.param_shapes()[k][0], specs[k], mesh)))
                    for k, p in model.named_parameters()})
                continue
            opt = meta["init_opt"]()
            opt, metrics = fn(opt, batch, torch.Generator().manual_seed(0))
            res[f"{key}|loss"] = metrics["loss"]
            res[f"{key}|gnorm"] = metrics["grad_norm"]
            res.update({f"{key}|p|{k}": S.gather(p.detach(), specs[k], mesh)
                        for k, p in model.named_parameters()})
            if name == "qwen3-32b" and mshape == (1, 4):
                save_checkpoint(ckpt, 1, {
                    "params": dict(model.named_parameters()), "opt": opt},
                    shardings=named_shardings({
                        "params": specs, "opt": optimizer_pspecs(model)},
                        mesh))
                res.update({f"ckpt|mu|{k}": S.gather(v, specs[k], mesh)
                            for k, v in opt.mu.items()})
    np.savez(f"{out}.{rank}.npz",
             **{k: torch.as_tensor(v).detach().float().numpy()
                for k, v in res.items()})


# forward and decode of the recurrent and audio families on (1, 4)
MF_DECODE = ("rwkv6-7b", "zamba2-2.7b", "whisper-small")
# (shape name, global batch) of each decode leg: zamba2's batch-1 cache
# holds the rank's heads (long_500k's layout), its batch-2 cache is
# replicated over the model axis
MF_DECODE_LEGS = {"rwkv6-7b": (("decode_32k", MF_B),),
                  "zamba2-2.7b": (("decode_32k", MF_B), ("long_500k", 1)),
                  "whisper-small": (("decode_32k", MF_B),)}


def jax_mesh_families_main(inputs, out):
    """The reference's side of tests/test_torch_mesh_families.py on 4 fake
    devices, (1, 4): ``forward`` logits jitted with its specs' shardings,
    then ``build_step``'s decode (Whisper's cross cache filled by
    ``prefill_cross`` first) for MF_STEPS steps from an empty cache."""
    import jax
    import jax.numpy as jnp
    from repro.configs import SHAPES, ShapeSpec, get_config
    from repro.launch.steps import _shard, build_step
    from repro.models.api import RunConfig, build_model
    from repro.models.sharding import compat_make_mesh, use_mesh
    z = np.load(inputs)
    res = {}
    mesh = compat_make_mesh((1, 4), ("data", "model"))
    run = RunConfig(**mf_run())
    for name in MF_DECODE:
        cfg = get_config(name).reduced()
        with use_mesh(mesh):
            m = build_model(cfg, run)
            shape = SHAPES["prefill_32k"]
            params = jax.tree.map(jnp.asarray, mf_tree(z, name))
            f = jax.jit(m.forward, in_shardings=(
                _shard(mesh, m.param_pspecs()),
                _shard(mesh, m.input_pspecs(shape))))
            res[f"{name}|fwd"] = f(params, {
                k: jnp.asarray(v) for k, v in
                mf_batch(z, name, "prefill").items()})
        for shape_name, b in MF_DECODE_LEGS[name]:
            fn, _, _ = build_step(name, shape_name, mesh, run_cfg=run,
                                  cfg_override=cfg)
            cache = m.init_cache(ShapeSpec("d", MF_SMAX, b, "decode"))
            params = jax.tree.map(jnp.asarray, mf_tree(z, name))
            with use_mesh(mesh):
                if name == "whisper-small":
                    cache = jax.jit(m.prefill_cross)(
                        params, jnp.asarray(z["frames"][:b]), cache)
                for t in range(MF_STEPS):
                    logits, cache = fn(params, cache, {
                        "tokens": jnp.asarray(z["tokens"][:b, t:t + 1]),
                        "cache_len": jnp.asarray(t, jnp.int32)})
                    res[f"{name}|b{b}|dec{t}"] = logits
            res.update({f"{name}|b{b}|cache|{k}": v
                        for k, v in cache.items()})
    np.savez(out, **{k: np.asarray(v, np.float32) for k, v in res.items()})
    print("jax mesh families ok")


def port_mesh_families_job(rank, world, inputs, out):
    """The port's side of tests/test_torch_mesh_families.py, one rank of 4
    gloo CPU ranks on (1, 4), through ``launch.steps.build_step``."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import sharding as S
    from repro_torch.models.api import RunConfig, build_model
    torch.set_num_threads(1)
    z = np.load(inputs)
    res = {}
    mesh = S.make_mesh((1, 4), ("data", "model"), "cpu")
    run = RunConfig(**mf_run())
    for name in MF_DECODE:
        cfg = get_config(name).reduced()
        for shape_name, b in (("prefill_32k", MF_B),) \
                + MF_DECODE_LEGS[name]:
            fn, _, meta = build_step(name, shape_name, mesh, run_cfg=run,
                                     cfg_override=cfg)
            model = meta["model"]
            convert.load_params(model, mf_tree(z, name))
            batch = {k: torch.from_numpy(v) for k, v in
                     mf_batch(z, name, "prefill").items()}
            with torch.no_grad():
                if shape_name == "prefill_32k":
                    res[f"{name}|fwd"] = model.forward(batch)
                    res[f"{name}|last"] = fn(batch)
                    continue
                cache = model.init_cache(ShapeSpec("d", MF_SMAX, b,
                                                   "decode"))
                if name == "whisper-small":
                    model.prefill_cross(batch["frames"][:b], cache)
                for t in range(MF_STEPS):
                    logits, cache = fn(cache, {
                        "tokens": batch["tokens"][:b, t:t + 1],
                        "cache_len": torch.tensor(t)})
                    res[f"{name}|b{b}|dec{t}"] = logits
            res.update({f"{name}|b{b}|cache|{k}": v
                        for k, v in cache.items()})
        # bf16: the same weights on the mesh and on one device (the port's)
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        with torch.no_grad():
            one = build_model(bf, run, device="cpu")
            with S.use_mesh(mesh):
                sharded = build_model(bf, run, device="cpu")
            for mdl in (one, sharded):
                convert.load_params(mdl, mf_tree(z, name))
            batch = {k: torch.from_numpy(v) for k, v in
                     mf_batch(z, name, "prefill").items()}
            res[f"{name}|bf16|one"] = one.forward(batch)
            res[f"{name}|bf16|mesh"] = sharded.forward(batch)
    np.savez(f"{out}.{rank}.npz",
             **{k: v.float().numpy() for k, v in res.items()})


# padded heads and vocabularies, the KV-head-sharded cache, Zamba2's
# batch-1 cache on data ranks (tests/test_torch_mesh_pad.py) ---------------

PAD_MESHES = ((1, 4), (2, 2))
# smollm cut to 3 heads (padded to 4 on 4 ranks, 2 + 2 on 2) and a
# vocabulary of 250 (padded to 252 on 4 ranks); qwen3 with 16 KV heads (the
# reference's KV-head-sharded layout)
PAD_CASES = {"pad": ("smollm-360m", dict(n_layers=2, d_model=48, n_heads=3,
                                         n_kv_heads=1, d_ff=64, vocab=250)),
             "kvs": ("qwen3-32b", dict(n_layers=2, d_model=64, n_heads=16,
                                       n_kv_heads=16, d_ff=128, vocab=256))}
PAD_B, PAD_S = 4, 16
PAD_SMAX, PAD_START, PAD_STEPS = 16, 6, 4
PAD_SLOT_LENS = [7, 9, 8, 11]
ZB1_SMAX, ZB1_STEPS = 8, 6     # (2, 2): 4 positions a data rank, crossed at 4
PAD_TRAIN_STEPS = 3


def pad_cfg(key, jax_side=False):
    if key == "zb1":
        name, kw = "zamba2-2.7b", dict(n_layers=4)
    else:
        name, kw = PAD_CASES[key]
    if jax_side:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return name, get_config(name).reduced(**kw)


def pad_run(**kw):
    return dict(q_chunk=8, kv_chunk=8, seq_chunk=8, data_axes=("data",),
                **kw)


def pad_inputs(path):
    """Weights (the port's init at per-layer fan-in), tokens, labels and
    seeded caches of the padded cases, saved as one .npz both sides read."""
    from repro_torch.models.api import RunConfig, build_model
    out = {}
    for i, key in enumerate(("pad", "kvs", "zb1")):
        _, cfg = pad_cfg(key)
        m = build_model(cfg, RunConfig(), device="cpu")
        m.init_params(torch.Generator().manual_seed(200 + i),
                      layer_fan_in=True)
        out.update({f"{key}|{k}": v.numpy() for k, v in m.state_dict().items()})
        if key != "zb1":
            cache = np.zeros((2, cfg.n_layers, PAD_B, PAD_SMAX,
                              cfg.n_kv_heads, cfg.resolved_head_dim))
            cache[:, :, :, :PAD_START] = np.random.default_rng(i).normal(
                size=cache[:, :, :, :PAD_START].shape)
            out[f"{key}|cache"] = cache
    rng = np.random.default_rng(9)
    out["tokens"] = rng.integers(0, 250, (PAD_B, PAD_S))
    out["labels"] = rng.integers(0, 250, (PAD_B, PAD_S))
    np.savez(path, **{k: np.asarray(v, np.float32 if v.dtype.kind == "f"
                                     else np.int32) for k, v in out.items()})


def pad_tree(z, key):
    from repro_torch.convert import unflatten_tree
    return unflatten_tree({k.split("|", 1)[1]: z[k] for k in z.files
                           if k.startswith(key + "|") and k != key + "|cache"})


def jax_mesh_pad_main(inputs, out):
    """The reference's side of tests/test_torch_mesh_pad.py on 4 fake
    devices: forward and decode of the padded and KV-head-sharded cases on
    (1, 4) and (2, 2), each parameter laid out by its spec (a leaf whose
    dimension the mesh does not divide, the vocabulary of 250 on 4,
    replicated: GSPMD pads what it partitions itself); Zamba2's batch-1
    decode on (2, 2) through its own ``build_step``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.configs import ShapeSpec
    from repro.launch.steps import _shard, build_step
    from repro.models.api import RunConfig, build_model
    from repro.models.sharding import compat_make_mesh, use_mesh
    z = np.load(inputs)
    res = {}
    tokens = z["tokens"]
    for mshape in PAD_MESHES:
        mesh = compat_make_mesh(mshape, ("data", "model"))
        tag = f"{mshape[0]}x{mshape[1]}"
        for key in ("pad", "kvs"):
            _, cfg = pad_cfg(key, jax_side=True)
            params = jax.tree.map(jnp.asarray, pad_tree(z, key))
            with use_mesh(mesh):
                m = build_model(cfg, RunConfig(**pad_run(sharded_decode=True)))
                shards = _shard(mesh, m.param_pspecs())

                def fit(sh, a):
                    ok = all(n % (mesh.shape[e] if isinstance(e, str) else 1)
                             == 0 for n, e in zip(a.shape, sh.spec))
                    return sh if ok else NamedSharding(mesh, PartitionSpec())
                shards = jax.tree.map(fit, shards, params)
                pshape = ShapeSpec("p", PAD_S, PAD_B, "prefill")
                res[f"{key}|{tag}|fwd"] = jax.jit(m.forward, in_shardings=(
                    shards, _shard(mesh, m.input_pspecs(pshape))))(
                    params, {"tokens": jnp.asarray(tokens)})
                dshape = ShapeSpec("d", PAD_SMAX, PAD_B, "decode")
                step = jax.jit(m.decode_step, in_shardings=(
                    shards, _shard(mesh, m.cache_pspecs(dshape)),
                    _shard(mesh, m.input_pspecs(dshape))))
                cache = {"k": jnp.asarray(z[f"{key}|cache"][0]),
                         "v": jnp.asarray(z[f"{key}|cache"][1])}
                for t in range(PAD_STEPS):
                    res[f"{key}|{tag}|dec{t}"], cache = step(params, cache, {
                        "tokens": jnp.asarray(tokens[:, t:t + 1]),
                        "cache_len": jnp.asarray(PAD_START + t, jnp.int32)})
                res[f"{key}|{tag}|slot"], _ = step(params, cache, {
                    "tokens": jnp.asarray(tokens[:, :1]),
                    "cache_len": jnp.asarray(PAD_SLOT_LENS, jnp.int32)})
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    _, cfg = pad_cfg("zb1", jax_side=True)
    run = RunConfig(**pad_run())
    fn, _, _ = build_step("zamba2-2.7b", "long_500k", mesh, run_cfg=run,
                          cfg_override=cfg)
    with use_mesh(mesh):
        m = build_model(cfg, run)
    cache = m.init_cache(ShapeSpec("d", ZB1_SMAX, 1, "decode"))
    params = jax.tree.map(jnp.asarray, pad_tree(z, "zb1"))
    with use_mesh(mesh):
        for t in range(ZB1_STEPS):
            res[f"zb1|dec{t}"], cache = fn(params, cache, {
                "tokens": jnp.asarray(tokens[:1, t:t + 1]),
                "cache_len": jnp.asarray(t, jnp.int32)})
    np.savez(out, **{k: np.asarray(v, np.float32) for k, v in res.items()})
    print("jax mesh pad ok")


def padding_of(t, full_shape, spec, mesh):
    """The entries of a rank's ``t`` that pad its slice of ``full_shape``
    (zero-size when nothing pads)."""
    from repro_torch.models import sharding as S
    real = torch.zeros(t.shape, dtype=torch.bool)
    real[tuple(slice(0, s.stop - s.start)
               for s in S.local_slices(full_shape, spec, mesh))] = True
    return t.detach()[~real]


def port_mesh_pad_job(rank, world, inputs, out, ckpt):
    """The port's side of tests/test_torch_mesh_pad.py, one rank of 4 gloo
    CPU ranks: the reference's cases on (1, 4) and (2, 2), the padded
    smollm's AdamW steps (ZeRO-1 on (2, 2)) and its checkpoint from (1, 4),
    restored onto (2, 2); rank 0 also runs every case on one device."""
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import sharding as S
    from repro_torch.models.api import RunConfig, build_model
    from repro_torch.train.checkpoint import (named_shardings,
                                              restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import make_train_step
    from repro_torch.models.sharding import P
    torch.set_num_threads(1)
    z = np.load(inputs)
    res = {}
    tokens = torch.from_numpy(z["tokens"])
    batch = {"tokens": tokens, "labels": torch.from_numpy(z["labels"])}

    def lm_cases(tag, mesh):
        for key in ("pad", "kvs"):
            _, cfg = pad_cfg(key)
            with S.use_mesh(mesh):
                m = build_model(cfg, RunConfig(**pad_run(
                    sharded_decode=True)), device="cpu")
            convert.load_params(m, pad_tree(z, key))
            rows = P(("data",), None) if mesh is not None else P()
            toks = tokens if mesh is None else S.local_shard(tokens, rows,
                                                             mesh)
            with torch.no_grad():
                res[f"{key}|{tag}|fwd"] = m.forward({"tokens": toks})
                dshape = ShapeSpec("d", PAD_SMAX, PAD_B, "decode")
                cache = {}
                for i, kv in enumerate("kv"):
                    full = torch.from_numpy(z[f"{key}|cache"][i])
                    cache[kv] = full.clone() if mesh is None else \
                        S.local_shard(full, m.cache_pspecs(dshape)[kv],
                                      mesh).contiguous()
                for t in range(PAD_STEPS):
                    res[f"{key}|{tag}|dec{t}"], cache = m.decode_step(cache, {
                        "tokens": toks[:, t:t + 1],
                        "cache_len": torch.tensor(PAD_START + t)})
                lens = torch.tensor(PAD_SLOT_LENS)
                res[f"{key}|{tag}|slot"], _ = m.decode_step(cache, {
                    "tokens": toks[:, :1], "cache_len": lens if mesh is None
                    else S.local_shard(lens, P(("data",)), mesh)})

    for mshape in PAD_MESHES:
        lm_cases(f"{mshape[0]}x{mshape[1]}",
                 S.make_mesh(mshape, ("data", "model"), "cpu"))
    if rank == 0:
        lm_cases("one", None)
    # Zamba2's batch-1 cache: sequence over data, heads over model
    mesh = S.make_mesh((2, 2), ("data", "model"), "cpu")
    _, zcfg = pad_cfg("zb1")
    run = RunConfig(**pad_run())
    for tag, zmesh in (("2x2", mesh), ("one", None)):
        if zmesh is None and rank:
            continue
        if zmesh is None:
            m = build_model(zcfg, run, device="cpu")
            fn = None
        else:
            fn, _, meta = build_step("zamba2-2.7b", "long_500k", zmesh,
                                     run_cfg=run, cfg_override=zcfg)
            m = meta["model"]
        convert.load_params(m, pad_tree(z, "zb1"))
        cache = m.init_cache(ShapeSpec("d", ZB1_SMAX, 1, "decode"))
        with torch.no_grad():
            for t in range(ZB1_STEPS):
                b = {"tokens": tokens[:1, t:t + 1],
                     "cache_len": torch.tensor(t)}
                res[f"zb1|{tag}|dec{t}"], cache = (
                    m.decode_step(cache, b) if fn is None else fn(cache, b))
        if zmesh is not None:
            res["zb1|k_local"] = torch.tensor(list(cache["k"].shape))
    # the padded smollm trains: the padding stays 0 (ZeRO-1 on (2, 2))
    _, pcfg = pad_cfg("pad")
    for mshape, over in (((1, 4), {}), ((2, 2), {"use_zero1": True})):
        mesh = S.make_mesh(mshape, ("data", "model"), "cpu")
        tag = f"{mshape[0]}x{mshape[1]}"
        fn, _, meta = build_step("smollm-360m", "train_4k", mesh, lr=MF_LR,
                                 cfg_override=pcfg, run_cfg=RunConfig(
                                     attn_impl="plain", **pad_run(**over)))
        model = meta["model"]
        convert.load_params(model, pad_tree(z, "pad"))
        specs, full = model.param_pspecs(), model.param_shapes()
        pads = [padding_of(p, full[k][0], specs[k], mesh)
                for k, p in model.named_parameters()]
        res[f"train|{tag}|padded"] = torch.tensor(
            float(sum(t.numel() for t in pads)))
        res[f"train|{tag}|zero_at_load"] = torch.tensor(
            float(all(bool((t == 0).all()) for t in pads)))
        if tag == "1x4":
            save_checkpoint(ckpt, 0, dict(model.named_parameters()),
                            shardings=named_shardings(specs, mesh))
        opt = meta["init_opt"]()
        for s in range(PAD_TRAIN_STEPS):
            opt, metrics = fn(opt, batch, None)
            res[f"train|{tag}|loss{s}"] = metrics["loss"]
        pads = [padding_of(p, full[k][0], specs[k], mesh)
                for k, p in model.named_parameters()]
        res[f"train|{tag}|zero_after"] = torch.tensor(
            float(all(bool((t == 0).all()) for t in pads)))
        res.update({f"train|{tag}|p|{k}": S.gather(p.detach(), specs[k], mesh)
                    for k, p in model.named_parameters()})
    if rank == 0:
        m = build_model(pcfg, RunConfig(attn_impl="plain", **pad_run()),
                        device="cpu")
        convert.load_params(m, pad_tree(z, "pad"))
        step = make_train_step(m, lr=MF_LR)
        opt = adamw_init(dict(m.named_parameters()))
        for s in range(PAD_TRAIN_STEPS):
            opt, metrics = step(opt, batch, None)
            res[f"train|one|loss{s}"] = metrics["loss"]
        res.update({f"train|one|p|{k}": p.detach()
                    for k, p in m.named_parameters()})
    # the (1, 4) checkpoint restored onto (2, 2): every rank's padded shard
    mesh = S.make_mesh((2, 2), ("data", "model"), "cpu")
    with S.use_mesh(mesh):
        m = build_model(pcfg, RunConfig(**pad_run()), device="cpu")
    specs = m.param_pspecs()
    got, _ = restore_checkpoint(ckpt, 0, dict(m.state_dict()),
                                shardings=named_shardings(specs, mesh))
    res["restore_2x2_equal"] = torch.tensor(float(all(
        torch.equal(got[k], S.local_shard(torch.from_numpy(
            z[f"pad|{k}"]), specs[k], mesh)) for k in got)))
    np.savez(f"{out}.{rank}.npz",
             **{k: torch.as_tensor(v).detach().float().numpy()
                for k, v in res.items()})
