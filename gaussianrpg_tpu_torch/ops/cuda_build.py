"""Build and load the port's CUDA kernels.

Each source under `gaussianrpg_tpu_torch/csrc/` has a plain C interface and
is compiled by `nvcc` into its own shared library for sm_90a, then loaded
with `ctypes`. Nothing is built when a module is imported: a wrapper asks
for its library at its first CUDA launch, and `build_all` compiles every
source at once (one `nvcc` process per source, all started together).
Libraries are named by a hash of their source and the shared headers
(`csrc/*.cuh`), so an edited kernel is rebuilt and an unchanged one is
reused. The build directory defaults to
`build/kernels` at the checkout root (`GRPG_TORCH_BUILD_DIR` overrides it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # ptxas register/smem report per kernel


def build_dir() -> Path:
    d = os.environ.get("GRPG_TORCH_BUILD_DIR")
    return Path(d) if d else CSRC.parent.parent / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    cands += [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += ["/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start compiling one source; returns (process, tmp path, target) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)   # atomic: a concurrent build never sees half


def build_all(names) -> None:
    """Compile the named sources in parallel (no-op for built ones)."""
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is not None:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs[name]


def with_others(name: str, against, tag: str) -> list:
    """The package's library for csrc/<name>.cu, then one library per
    NAME=PATH in `against` (another tree's source of the same kernel, for
    example the parent commit's unpacked from a `git archive`), compiled
    in parallel with the package's flags: a list of (name, library,
    nvcc's log), the package's named "package". The others are named by
    `tag`, NAME and their source's hash in the build directory."""
    lib = library(name)
    out = [("package", lib, build_logs.get(name, ""))]
    started = []
    for spec in against:
        other, _, path = spec.partition("=")
        src = Path(path)
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        so = build_dir() / f"{tag}_{other}_{digest}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)]
        started.append((other, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for other, so, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {other}:\n{log}")
        out.append((other, ctypes.CDLL(str(so)), log))
    return out


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused or
    a bad argument)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
