"""Build the port's CUDA C++ kernels with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so one ``nvcc`` call per source takes seconds. The shared library
is named by a hash of the source and the flags, so a changed source is
rebuilt and an unchanged one is reused. Nothing is built when this module
is imported: ``load(name)`` builds one source at its first use, and
``build_all(names)`` builds several at once, one ``nvcc`` process each.

Where the libraries go: run from a source checkout (``src/repro_torch``
under a directory that holds ``pyproject.toml``), into
``build/repro_torch/`` of that checkout. An installed package has no such
place, so there ``$REPRO_TORCH_BUILD_DIR`` must name a writable directory;
without it the build raises instead of writing beside ``site-packages``.
The variable, when set, wins in both layouts.

There is no fallback: if ``nvcc`` is missing or the compilation fails,
``KernelCompileError`` is raised and the caller's launch fails with it.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_SECONDS: dict[str, float] = {}


class KernelCompileError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def build_dir() -> pathlib.Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch`` of the source
    checkout this module runs from; raises where there is neither."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    # <root>/src/repro_torch/kernels/build.py in a checkout.
    here = pathlib.Path(__file__).resolve()
    root = here.parents[3]
    if here.parents[2].name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    raise KernelCompileError(
        f"{here.parents[1]} is not inside a source checkout: set "
        "REPRO_TORCH_BUILD_DIR to a writable directory for the built kernels"
    )


def source_path(name: str) -> pathlib.Path:
    path = CSRC_DIR / f"{name}.cu"
    if not path.is_file():
        raise KernelCompileError(f"no kernel source {path}")
    return path


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelCompileError(
        "nvcc not found (looked at PATH and /usr/local/cuda/bin): "
        "the port's kernels are compiled on the machine that holds the GPU"
    )


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256()
    digest.update(source_path(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(nvcc: str, name: str, out: pathlib.Path, verbose: bool):
    """One ``nvcc`` run into ``out``; returns (exit code, its output)."""
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(source_path(name))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
    else:
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return proc.returncode, proc.stdout + proc.stderr


def build_all(names, verbose: bool = False) -> dict[str, pathlib.Path]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet: one
    ``nvcc`` process per source, all started together; returns once every
    one has ended. ``verbose`` prints ``-Xptxas -v`` (registers, spills)."""
    outs = {name: library_path(name) for name in names}
    todo = [name for name, out in outs.items() if not out.is_file()]
    for name in outs:
        if name not in todo:
            _BUILD_SECONDS.setdefault(name, 0.0)
    if not todo:
        return outs
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        runs = {
            name: pool.submit(_compile, nvcc, name, outs[name], verbose)
            for name in todo
        }
    failed = []
    for name, run in runs.items():
        code, text = run.result()
        if code != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {code}):\n{text}")
        elif verbose:
            print(f"== {name}.cu\n{text}", end="")
    if failed:
        raise KernelCompileError("\n".join(failed))
    return outs


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_all([name], verbose)[name]


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def build_seconds() -> dict[str, float]:
    """Seconds each kernel's ``nvcc`` run took in this process (0 = reused)."""
    return dict(_BUILD_SECONDS)
