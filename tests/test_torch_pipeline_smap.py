"""The GPipe layer-split pipeline against the monolithic forward.

The counterpart of ``tests/test_pipeline_smap.py``, whose own run of the
reference fails under JAX 0.9 (it jits outside ``jax.set_mesh``), so the
oracle is ``forward``: the reference's and the port's.  Reduced TinyLlama
at 4 layers (``init_params(PRNGKey(0))`` carried over by
``params_from_jax``), tokens (8, 16) from ``np.random.RandomState(0)``,
S = 4 CPU "devices", M ∈ {4, 8}: within 2e-4 of both forwards, the
reference test's tolerance.  Reduced falcon-mamba at S = 2 within 2e-4
of the port's forward; qwen2-moe equals ``forward`` of each microbatch
alone (its capacity applies per microbatch); every ``ValueError`` of the
reference's asserts.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.serving.pipeline_smap import pipeline_shard_map

TOL = 2e-4


def _setup(arch, **reduce):
    jcfg = jget_config(arch).reduced(**reduce)
    cfg = get_config(arch).reduced(**reduce)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 16))
    return jcfg, cfg, jparams, params, tokens.astype(np.int32)


def _check(params, cfg, tokens, stages, *refs):
    batch = {"tokens": torch.from_numpy(tokens)}
    for m in (4, 8):
        got = pipeline_shard_map(params, batch, cfg, ["cpu"] * stages, m)
        assert got.shape == refs[0].shape and got.dtype == torch.float32
        for ref in refs:
            err = float(np.abs(got.numpy() - ref).max())
            assert err < TOL, (cfg.name, m, err)


def test_pipeline_matches_both_forwards():
    jcfg, cfg, jparams, params, tokens = _setup("tinyllama-1.1b",
                                                max_layers=4)
    want_j = np.asarray(jmodel.forward(jparams, {"tokens": tokens}, jcfg)[0])
    want = tmodel.forward(params, {"tokens": torch.from_numpy(tokens)},
                          cfg).numpy()
    assert np.abs(want - want_j).max() < TOL
    _check(params, cfg, tokens, 4, want, want_j)


def test_mamba_pipeline_matches_forward():
    """Reduced falcon-mamba at S = 2 against the port's ``forward``
    (``tests/test_torch_model.py`` holds that against the reference's)."""
    cfg = get_config("falcon-mamba-7b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 16))
    tokens = tokens.astype(np.int32)
    want = tmodel.forward(params, {"tokens": torch.from_numpy(tokens)},
                          cfg).numpy()
    _check(params, cfg, tokens, 2, want)


def test_moe_capacity_applies_per_microbatch():
    _, cfg, _, params, tokens = _setup("qwen2-moe-a2.7b")
    batch = {"tokens": torch.from_numpy(tokens)}
    got = pipeline_shard_map(params, batch, cfg, ["cpu", "cpu"], 4)
    each = torch.cat([tmodel.forward(params, {"tokens": t}, cfg)
                      for t in batch["tokens"].chunk(4)])
    assert float((got - each).abs().max()) < TOL


def test_one_stage_one_microbatch_is_forward():
    _, cfg, _, params, tokens = _setup("tinyllama-1.1b")
    batch = {"tokens": torch.from_numpy(tokens)}
    assert torch.equal(pipeline_shard_map(params, batch, cfg, ["cpu"], 1),
                       tmodel.forward(params, batch, cfg))


@pytest.mark.parametrize("arch,stages,m,change,match", [
    ("recurrentgemma-9b", 2, 2, None, "uniform layer pattern"),
    ("kimi-k2-1t-a32b", 1, 2, None, "uniform layer pattern"),
    ("tinyllama-1.1b", 3, 2, None, "3 stages do not divide the 4 layers"),
    ("tinyllama-1.1b", 2, 3, None, "3 microbatches do not divide"),
    ("tinyllama-1.1b", 2, 0, None, "0 microbatches"),
    ("musicgen-medium", 2, 2, None, "codebook tokens"),
    ("tinyllama-1.1b", 2, 2, "positions", "also holds .'positions'."),
    ("qwen2-vl-7b", 2, 2, "positions3", "also holds .'positions3'.")])
def test_what_the_reference_refuses_raises(arch, stages, m, change, match):
    cfg = get_config(arch).reduced(max_layers=4)
    b, s = 8, 6
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    batch = {"tokens": torch.zeros(shape, dtype=torch.int32)}
    if change == "positions":
        batch["positions"] = torch.zeros((b, s), dtype=torch.int32)
    elif change == "positions3":
        batch["positions3"] = torch.zeros((b, 3, s), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pipeline_shard_map(None, batch, cfg, ["cpu"] * stages, m)
