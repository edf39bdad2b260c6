#!/usr/bin/env python3
"""Time variants of two CUDA kernels of the port side by side on one GPU.

    PYTHONPATH=src python3 tools/kernel_variants.py

Builds text variants of ``csrc/rglru_scan.cu`` (CTA size 32/64/128 ×
steps per register buffer 4/8/16) and of ``csrc/flash_attention.cu`` at
head dim 256 (threads per query row 2/4/8, and the row's threads on
neighbouring lanes instead of 8 lanes apart), each with the port's nvcc
flags, into ``kernels/_build/variants/``; checks each against the eager
twin and times it with CUDA events at recurrentgemma-9b's serving shapes
(rglru_scan: b=4, s=1024, w=4096, float32 and bfloat16; flash: b=4,
s=1024, 16 query heads over 1 kv head, window 2048, bfloat16).  The
committed sources are the variants named ``t32_u8`` and ``split4``.
Prints the card, one line per variant and round (two rounds, in turns),
and a JSON line of the medians.  Exits non-zero without a GPU or when a
variant disagrees with the twin.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _sub(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise AssertionError(f"variant edit not found: {old!r}")
        src = src.replace(old, new)
    return src


def variants(csrc):
    """{name: (source, kernel)} of every variant."""
    rg = (csrc / "rglru_scan.cu").read_text()
    fa = (csrc / "flash_attention.cu").read_text()
    out = {}
    for threads in (32, 64, 128):
        for u in (4, 8, 16):
            out[f"rglru_t{threads}_u{u}"] = (_sub(rg, [
                ("constexpr int THREADS = 32;",
                 f"constexpr int THREADS = {threads};"),
                ("constexpr int U = 8;", f"constexpr int U = {u};")]),
                "rglru")
    split = "static constexpr int SPLIT = HD > 128 ? 4 : 1;"
    for n in (2, 4, 8):
        out[f"flash_split{n}"] = (_sub(fa, [(split, split.replace(
            "? 4", f"? {n}"))]), "flash")
    out["flash_split4_adjacent"] = (_sub(fa, [
        ("  const int row = (tid >> 5) * WROWS + lane % WROWS;\n"
         "  const int part = lane / WROWS;",
         "  const int row = tid / SPLIT;\n"
         "  const int part = tid - row * SPLIT;"),
        ("__shfl_xor_sync(0xffffffffu, dot, off * WROWS)",
         "__shfl_xor_sync(0xffffffffu, dot, off)")]), "flash")
    return out


def build(names_sources, out_dir):
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in names_sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
    return libs


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import BUILD_DIR, CSRC
    from repro_torch.kernels.ref import attention_ref, rglru_scan_ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    table = variants(CSRC)
    libs = build({n: src for n, (src, _) in table.items()},
                 str(BUILD_DIR / "variants"))
    stream = torch.cuda.current_stream().cuda_stream
    times = {}

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (4, 1024, 4096)
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        a = (0.8 + 0.2 * torch.rand(shape, generator=gen, device="cuda")
             ).to(dtype)
        bx = (0.1 * torch.randn(shape, generator=gen, device="cuda")
              ).to(dtype)
        want = rglru_scan_ref(a, bx)
        h = torch.empty(shape, device="cuda")
        for rnd in range(2):
            for name in (n for n, (_, k) in table.items() if k == "rglru"):
                fn = libs[name].rglru_scan_launch
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
                    + [ctypes.c_void_p]

                def call():
                    rc = fn(a.data_ptr(), bx.data_ptr(), h.data_ptr(),
                            *shape, code, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                ms = cuda_ms(call, 50)
                if not torch.equal(h, want):
                    raise AssertionError(f"{name} {dtype}: differs from "
                                         f"the twin")
                key = f"{name} {str(dtype).split('.')[1]}"
                times.setdefault(key, []).append(ms)
                nbytes = 2 * a.numel() * a.element_size() + h.numel() * 4
                print(f"round {rnd} {key}: {ms:.5f} ms/call, "
                      f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, equal to "
                      f"the twin", flush=True)

    rng = np.random.RandomState(0)
    b, s, h_, kvh, hd, window = 4, 1024, 16, 1, 256, 2048
    q, k, v = (torch.from_numpy(rng.randn(b, s, n, hd).astype(np.float32))
               .to("cuda", torch.bfloat16) for n in (h_, kvh, kvh))
    want = attention_ref(q, k, v, window=window).float()
    o = torch.empty_like(q)
    for rnd in range(2):
        for name in (n for n, (_, kind) in table.items() if kind == "flash"):
            fn = libs[name].flash_attention_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
                + [ctypes.c_void_p]

            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), b, s, s, h_, kvh, hd, 1, window, 1,
                        stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            ms = cuda_ms(call, 5)
            err = float((o.float() - want).abs().max())
            if not err <= 2e-2:
                raise AssertionError(f"{name}: max abs err {err:.3e}")
            times.setdefault(name, []).append(ms)
            print(f"round {rnd} {name}: {ms:.4f} ms/call, max abs err "
                  f"{err:.3e}", flush=True)
    print(f"card: {card}")
    print(json.dumps({"median_ms": {n: float(np.median(t))
                                    for n, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
