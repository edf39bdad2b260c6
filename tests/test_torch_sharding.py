"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), and the sharded step against the
unsharded one.

* ``param_pspec`` equals the reference's for every leaf of every assigned
  architecture, on the (16, 16) and (2, 16, 16) meshes, and the
  reference's pinned cases hold on the port's leaves.
* On a 2 × 2 mesh of four ``gloo`` ranks (a child process per rank), one
  eval forward and one train step of a 2-layer float32 model through the
  sharded path equal the unsharded ``forward`` and step within rtol 1e-5:
  the oracle of the mesh paths.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import textwrap

import pytest

import jax
from jax.sharding import AbstractMesh as JaxAbstractMesh

from _torch_ref import ROOT
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import sharding, specs
from repro_torch.launch.mesh import MULTI, SINGLE, AbstractMesh
from repro_torch.models.model import stack_groups
from repro_torch.optim.optimizers import AdamWState, adamw_init
from repro_torch.tree import tree_flatten, tree_leaves


def _norm(spec):
    """A spec's entries as JAX's ``PartitionSpec`` keeps them: a group of
    one axis as that axis's name."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else tuple(e) if isinstance(e, list) else e for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    from repro.configs import get_config as ref_config
    from repro.launch import specs as jspecs
    cfg = ref_config(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jspecs.params_specs(cfg))
    return cfg, flat


@pytest.mark.parametrize("mesh_def", [SINGLE, MULTI], ids=["16x16",
                                                           "2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_pspec_matches_reference_for_every_leaf(arch, mesh_def):
    from repro.launch import sharding as jsh
    shape, names = mesh_def
    jmesh = JaxAbstractMesh(shape, names)
    mesh = AbstractMesh(shape, names)
    ref_cfg, ref_flat = _ref_leaves(arch)
    cfg = get_config(arch)
    params = specs.params_specs(cfg)
    flat = tree_flatten(params)
    groups = stack_groups(params, cfg)
    assert len(groups) == len(ref_flat)
    checked = 0
    for (path, leaf), group in zip(ref_flat, groups):
        want = _norm(jsh.param_pspec(jmesh, ref_cfg, path, leaf))
        want = want + (None,) * (len(leaf.shape) - len(want))
        if jsh._path_str(path).startswith("body/"):
            want = want[1:]                      # the stacked periods' axis
        for i in group if isinstance(group, list) else [group]:
            name, t = flat[i]
            assert _norm(sharding.param_pspec(mesh, cfg, name, t.shape)) \
                == want, (arch, name)
            checked += 1
    assert checked == len(flat)


def _specs_of(arch, pred, mesh):
    cfg = get_config(arch)
    return {name: sharding.param_pspec(mesh, cfg, name, t.shape)
            for name, t in tree_flatten(specs.params_specs(cfg))
            if pred(name)}


def test_param_pspec_expected_specs():
    """The reference's pinned rules (``tests/test_sharding_and_dryrun.py``)
    on the port's per-layer leaves."""
    mesh = AbstractMesh(*SINGLE)
    s = _specs_of("llama3-405b", lambda n: n in ("embed",
                                                 "blocks/0/attn/wq"), mesh)
    assert s["embed"] == ("model", ("data",))
    assert s["blocks/0/attn/wq"] == (("data",), "model", None)
    # GQA kv heads (8) don't divide model=16 -> no head TP on wk
    s = _specs_of("llama3-405b", lambda n: n == "blocks/0/attn/wk", mesh)
    assert s["blocks/0/attn/wk"] == (("data",), None, None)
    # kimi's experts are expert-parallel (block 0 is its dense prefix)
    s = _specs_of("kimi-k2-1t-a32b", lambda n: n == "blocks/1/moe/w_up",
                  mesh)
    assert s["blocks/1/moe/w_up"] == ("model", ("data",), None)
    # qwen2-moe: 60 experts don't divide 16 -> TP inside the expert
    s = _specs_of("qwen2-moe-a2.7b", lambda n: n == "blocks/0/moe/w_up",
                  mesh)
    assert s["blocks/0/moe/w_up"] == (None, ("data",), "model")
    # musicgen: 24 heads -> no head TP, MLP hidden TP survives
    s = _specs_of("musicgen-medium", lambda n: n in ("blocks/0/attn/wq",
                                                     "blocks/0/mlp/w_up"),
                  mesh)
    assert s["blocks/0/attn/wq"][1] is None
    assert s["blocks/0/mlp/w_up"][1] == "model"


def test_state_batch_and_cache_specs_follow_the_reference_rules():
    mesh = AbstractMesh(*MULTI)
    cfg = get_config("tinyllama-1.1b")
    params = specs.params_specs(cfg)
    assert sharding.batch_pspec(mesh, (256, 4096)) == (("pod", "data"),
                                                       None)
    assert sharding.batch_pspec(mesh, (1, 4096)) == (None, None)
    assert sharding.cache_pspec(mesh, "k", (128, 32768, 4, 64)) == (
        ("pod", "data"), "model", None, None)
    assert sharding.cache_pspec(mesh, "h", (128, 8192, 16)) == (
        ("pod", "data"), "model", None)
    assert sharding.constrain_pspec(mesh, (256, 4096, 2048),
                                    "residual") == (("pod", "data"),
                                                    "model", None)
    assert sharding.constrain_pspec(mesh, (8, 4096, 2048), "other") is None
    # AdamW's moments take their parameter's spec
    state = adamw_init(tree_leaves(params))
    assert isinstance(state, AdamWState) and len(state.m) == len(
        tree_leaves(params))


_GLOO = """
import os, sys, json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import sharding, steps
from repro_torch.models.model import init_params, stack_groups, forward
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.tree import tree_leaves

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + sys.argv[2],
                        rank=rank, world_size=4)
torch.manual_seed(0)
cfg = get_config("tinyllama-1.1b").reduced()
g = torch.Generator().manual_seed(0)
tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=g,
                       dtype=torch.int32)
batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

def fresh():
    # every leaf the init sets to 0 (the norms) gets normal x 0.1: AdamW's
    # first step g / (|g| + eps) leaves a zero leaf at the learning rate's
    # scale, where a near-zero gradient's rounding shows (as the train
    # step's own tests do)
    params = init_params(cfg, device="cpu")
    gz = torch.Generator().manual_seed(5)
    for p in tree_leaves(params):
        if not p.any():
            p.copy_(0.1 * torch.randn(p.shape, generator=gz))
    # a warm AdamW state (step 10, moments drawn): the first step's
    # g / (|g| + eps) is a sign, which a gradient near 0 flips with its
    # rounding; a warm step's update is smooth in the gradient
    init, _ = make_optimizer(cfg.optimizer, stack_groups(params, cfg))
    state = init(tree_leaves(params))
    for m, v in zip(state.m, state.v):
        m.copy_(1e-3 * torch.randn(m.shape, generator=gz))
        v.copy_(1e-6 + 1e-5 * torch.rand(v.shape, generator=gz))
    return params, state._replace(step=torch.tensor(10, dtype=torch.int32))

params, state = fresh()
want_logits = forward(params, batch, cfg)
want_params, _, want_m = steps.make_train_step(cfg, device="cpu")(
    params, state, batch)

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
params, state = fresh()
sp = sharding.distribute(params, sharding.params_shardings(mesh, cfg, params),
                         mesh)
st = sharding.distribute(state, sharding.opt_state_shardings(
    mesh, cfg, state, params), mesh)
sb = sharding.distribute(batch, sharding.batch_shardings(mesh, batch), mesh)
logits = steps.make_eval_step(cfg, mesh)(sp, sb).full_tensor()
new, _, m = steps.make_train_step(cfg, mesh)(sp, st, sb)

def worst(a, b):
    return float(((a - b).abs() / (b.abs() + 1e-30)).max())

err = {"logits": float(((logits - want_logits).abs()).max()
                       / want_logits.abs().max()),
       "loss": abs(float(m["loss"].full_tensor()) - float(want_m["loss"])),
       "params": max(float((a.full_tensor() - b).abs().max()
                           / (b.abs().max() + 1e-30))
                     for a, b in zip(tree_leaves(new),
                                     tree_leaves(want_params)))}
if rank == 0:
    print(json.dumps(err))
dist.destroy_process_group()
"""


def test_sharded_steps_match_unsharded_on_four_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_GLOO), str(r), store],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    import json
    err = json.loads(outs[0][0].strip().splitlines()[-1])
    assert err["logits"] < 1e-5, err
    assert err["loss"] < 1e-5, err
    assert err["params"] < 1e-5, err
