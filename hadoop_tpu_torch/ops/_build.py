"""Build and load the port's CUDA kernels.

Each source ``ops/csrc/<name>.cu`` has a plain C interface. It is
compiled on first use with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/hadoop_tpu_torch/`` at the root of the checkout, named by
a hash of its source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited kernel or header is never served from a stale
build, and loaded with ``ctypes``. The TMA descriptors' driver call is
looked up at run time (``cudaGetDriverEntryPoint``), so no ``-lcuda``.
Nothing here runs at import time.

Every C entry is listed in ``SIGNATURES`` and called through ``launch``,
which passes tensors as their device pointers and raises when the entry
returns an error.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hadoop_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}      # guarded-by: _lock
build_logs: Dict[str, str] = {}         # nvcc's output (ptxas registers, smem)

# Each C entry returning int, by its arguments in order: tensor pointers,
# ints (C ints, or the ctypes types given), floats, the stream.
# name: (library, pointer args, int args, float args, stream)
SIGNATURES = {
    "htpu_flash_fwd": ("flash_fwd", 5, 6, 1, True),
    "htpu_flash_fwd_partial": ("flash_fwd", 5, 7, 1, True),
    "htpu_flash_bwd_dq": ("flash_bwd", 8, 6, 1, True),
    "htpu_flash_bwd_dkv": ("flash_bwd", 8, 6, 1, True),
    "htpu_flash_fwd_smem": ("flash_fwd", 0, 2, 0, False),   # (D, dtype)
    "htpu_flash_bwd_smem": ("flash_bwd", 0, 2, 0, False),   # (D, dtype)
    "htpu_adamw": ("adamw", 5, 3, 9, True),
    "htpu_grad_sq_partial": ("adamw", 2, 3, 0, True),
    "htpu_grad_sq_finish": ("adamw", 2, 1, 0, True),
    "htpu_dequant_int8": ("dequant", 3,
                          (ctypes.c_longlong, ctypes.c_int, ctypes.c_int), 0,
                          True),
    "htpu_rms_norm_fwd": ("rmsnorm", 4, 3, 1, True),
    "htpu_rms_norm_bwd": ("rmsnorm", 6, 4, 0, True),
    "htpu_rms_norm_dw": ("rmsnorm", 2, 3, 0, True),
    "htpu_ec_gf256_apply": ("ec_gf256", 3,
                            (ctypes.c_longlong, ctypes.c_int, ctypes.c_int),
                            0, True),
}
ERR_NOT_BUILT = -1          # a dtype, head dim or size it was not built for
ERR_TENSOR_MAP = -2         # the driver refused a TMA descriptor
entries: Dict[str, Callable] = {}       # bound C entries, by name


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named by a hash of that source,
    every header of ``csrc/`` (any of them may be included) and the
    flags."""
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: List[str]) -> None:
    """Compile every named source that has no current build, one ``nvcc``
    per source, all started together. Raises if any of them fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def bind(fn, name: str):
    """Give the C entry ``fn`` the ctypes types of ``SIGNATURES[name]``:
    pointers and the stream as ``c_void_p`` (ctypes would cut them to 32
    bits otherwise), ints, floats, an int result."""
    _, n_ptr, ints, n_float, stream = SIGNATURES[name]
    if isinstance(ints, int):
        ints = (ctypes.c_int,) * ints
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + list(ints)
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def entry(name: str):
    """The C entry ``name``, its library built and loaded first if needed."""
    fn = entries.get(name)
    if fn is None:
        fn = entries[name] = bind(getattr(load(SIGNATURES[name][0]), name),
                                  name)
    return fn


def launch(name: str, *args) -> None:
    """Call the C entry ``name`` on the current stream of args[0]'s
    device: tensors go as their device pointers, the rest as they are.
    Raises on an error from the entry."""
    index = args[0].device.index
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    switch = torch.cuda.current_device() != index
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        err = entry(name)(*ptrs, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        if err == ERR_TENSOR_MAP:
            why = ("cuTensorMapEncodeTiled refused a TMA descriptor (a "
                   "base address not 16-byte aligned?)")
        elif err == ERR_NOT_BUILT:
            why = "a dtype, head dim or size the kernel was not built for"
        else:
            lib = load(SIGNATURES[name][0])
            lib.htpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.htpu_cuda_error_string.restype = ctypes.c_char_p
            why = lib.htpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed ({err}): {why}")
