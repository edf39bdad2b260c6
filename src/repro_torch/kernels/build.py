"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use, from the repository's sources only, into ``kernels/_build/`` (listed
in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so

The library name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded.  ``build_all`` starts one
nvcc per source, all at once, and waits for them together.  A source in
``PARTS`` (flash attention, the slowest to compile) is compiled as that
many objects in parallel, each with ``-DFLASH_PART=<i>`` selecting its
kernels, and the objects are linked into the one library.

``cache_stats()`` counts how this process got its libraries: a hit is a
request served by a library already loaded, a miss one that loaded it
(from ``_build/`` or after compiling it); ``keys`` gives each loaded
library's file and how many times this process compiled it.  Each nvcc
batch is a ``kernel_build`` span of the active ``repro_torch.obs``
ledger.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from repro_torch.obs import get_ledger

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: every kernel source of the port, built together by ``build_all``
SOURCES = ("edge_substep", "placement", "flash_attention", "moe_route",
           "selective_scan", "rglru_scan", "threefry")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: sources compiled as several objects in parallel: objects per source
#: (flash_attention.cu: the forward's kernels, then the backward's)
PARTS = {"flash_attention": 2}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on ``PATH``, else
    the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 1)}"
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile_cmds(name: str, tmp: Path):
    """The nvcc commands that build library ``name`` into ``tmp``: one,
    or with PARTS one per object (``-c``, run together), then the link
    command and its objects (None without PARTS)."""
    src = str(CSRC / f"{name}.cu")
    parts = PARTS.get(name, 1)
    if parts == 1:
        return [[nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), src]], None
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_suffix(f".part{i}.o") for i in range(parts)]
    cmds = [[nvcc_path(), *compile_flags, f"-DFLASH_PART={i}", "-c", "-o",
             str(obj), src] for i, obj in enumerate(objs)]
    link = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
    return cmds, (link, objs)


class KernelLibraries:
    """Loaded kernel libraries of this process, built on first request
    (once, also when several threads ask at once: the grid's thread
    chunks).  ``logs`` keeps each build's compiler output (``-Xptxas -v``:
    registers, shared memory, spills)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.logs: Dict[str, str] = {}
        self.hits = 0
        self.misses = 0
        self.builds: Dict[str, int] = {}
        self._entries = {}

    def build_all(self, names=SOURCES) -> Dict[str, str]:
        """Compile every missing library, one nvcc per source started
        together; returns the compiler output per source."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmds, link = _compile_cmds(name, tmp)
            procs[name] = ([subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for cmd in cmds], link, tmp, out)
        failed = []
        with get_ledger().span("kernel_build", sources=sorted(procs)):
            for name, (running, link, tmp, out) in procs.items():
                logs = [proc.communicate()[0] for proc in running]
                rc = max(proc.returncode for proc in running)
                if link is not None:
                    if rc == 0:
                        done = subprocess.run(link[0], capture_output=True,
                                              text=True)
                        logs.append(done.stdout + done.stderr)
                        rc = done.returncode
                    for obj in link[1]:
                        obj.unlink(missing_ok=True)
                log = "".join(logs)
                self.logs[name] = log
                if rc != 0:
                    failed.append(f"{name}: nvcc exited {rc}\n{log}")
                    continue
                os.replace(tmp, out)
                self.builds[out.name] = self.builds.get(out.name, 0) + 1
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return dict(self.logs)

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            return self._get(name)

    def _get(self, name: str) -> ctypes.CDLL:
        lib = self._libs.get(name)
        if lib is not None:
            self.hits += 1
            return lib
        self.misses += 1
        path = _lib_path(name)
        if not path.exists():
            self.build_all((name,))
        lib = ctypes.CDLL(str(path))
        self._libs[name] = lib
        self.builds.setdefault(path.name, 0)
        return lib

    def entry(self, name: str, symbol: str, pointers: int, ints: int):
        """The C entry point ``symbol`` of library ``name`` taking
        ``pointers`` pointers, then ``ints`` ints, then a stream, and
        returning an int (a CUDA error code), typed once per process."""
        key = (name, symbol)
        with self._lock:
            fn = self._entries.get(key)
            if fn is None:
                fn = getattr(self.get(name), symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * pointers \
                    + [ctypes.c_int] * ints + [ctypes.c_void_p]
                self._entries[key] = fn
        return fn

    def cache_stats(self) -> dict:
        """The library counters in ``RunLedger.add_cache_stats``'s form:
        hits, misses, evictions (none: a loaded library stays loaded),
        loaded libraries, and per loaded library file the number of times
        this process compiled it (0: loaded from an earlier build)."""
        return {"hits": self.hits, "misses": self.misses, "evictions": 0,
                "size": len(self._libs),
                "keys": {path: self.builds.get(path, 0) for path in
                         sorted(_lib_path(n).name for n in self._libs)}}


LIBRARIES = KernelLibraries()


def cache_stats() -> dict:
    """``LIBRARIES.cache_stats()``."""
    return LIBRARIES.cache_stats()
