"""The port's dry-run (``repro_torch.launch.dryrun``) and its roofline
table (``repro_torch.launch.roofline``).

A subprocess runs the dry-run of a reduced config (TinyLlama-1.1B cut to
1 layer, full width, ``train_4k``) on the (16, 16) production mesh of a
fake 256-rank process group, and the reference test's assertions hold
with the H100's 80 GB: 256 cards, the peak under 80 GB, a positive
compute term and collective traffic, and a useful-FLOP ratio in (0.05,
1.5].  The roofline module tabulates that report.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from _torch_ref import ROOT
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline


def test_dryrun_subprocess_reduced_tinyllama(tmp_path):
    out = tmp_path / "tinyllama-1.1b_train_4k_single.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
         "--set", "num_layers=1", "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    d = json.loads(out.read_text())
    assert d["chips"] == 256
    assert d["memory"]["peak_gb"] < 80.0           # fits an H100's HBM
    assert d["roofline"]["compute_s"] > 0
    assert d["collective_bytes_per_device"] > 0
    assert 0.05 < d["useful_flops_ratio"] <= 1.5
    # the shards' FLOPs add up to the unsharded step's (the counter sees
    # the local operators under DTensor), to the I/O term and the
    # replicated work
    assert d["flops_per_device"] * d["chips"] >= 0.9 * d[
        "counted_flops_global"]
    rows = roofline.load_all(str(tmp_path))
    assert len(rows) == 1
    table = roofline.table(rows)
    assert "tinyllama-1.1b" in table and d["roofline"]["bottleneck"] in table
    md = roofline.markdown(rows)
    assert md.count("\n") == 2 and roofline.suggest(d) in md
    both = roofline.markdown_meshes(rows).splitlines()
    assert len(both) == 3 and both[2].startswith("| tinyllama-1.1b | ")
    assert " / —" in both[2] and d["roofline"]["bottleneck"] in both[2]


def test_overrides_reach_nested_configs():
    cfg = dryrun.apply_overrides(get_config("qwen2-moe-a2.7b"),
                                 ["moe.top_k=2", "attn_causal_skip=True",
                                  "num_layers=3"])
    assert cfg.moe.top_k == 2 and cfg.attn_causal_skip is True
    assert cfg.num_layers == 3
