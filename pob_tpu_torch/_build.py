"""Build and load the port's CUDA kernels, and count their launches.

Every kernel lives in ``pob_tpu_torch/csrc/`` as CUDA C++ with a plain C
interface. At first use, each ``.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``build/pob_tpu_torch/`` (next
to the package, at the repo root), keyed by a hash of all the sources, and
loaded with ``ctypes``. The files are compiled in parallel, one ``nvcc`` per
source. Nothing here runs at import time: the CPU tests import every module
and never reach a build.

``LAUNCHES`` holds one integer per kernel; each wrapper adds one where it
launches its kernel, and nowhere else."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "build", "pob_tpu_torch")
SOURCES = ("mont.cu", "ntt.cu", "msm_g1.cu", "msm_g2.cu", "fixed_base.cu", "bitsum_g1.cu",
           "bitsum_g2.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"mont": 0, "ntt": 0, "msm": 0, "fixed_base": 0, "fixed_base_table": 0, "chains": 0,
            "bitsum_g1": 0, "bitsum_g2": 0}

_libs: dict = {}
_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be cut to 32 bits), every count as c_longlong / c_int.
_ARGTYPES = {
    "mont.cu": {"pob_field_op": [_I, _I, _P, _P, _P, _L, _P]},
    "ntt.cu": {"pob_ntt_pass": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P]},
    **{src: {
        "pob_msm_hist": [_P, _I, _I, _I, _P, _P, _P],
        "pob_msm_layout": [_P, _I, _I, ctypes.POINTER(_I), _P, _P, _P],
        "pob_msm_scatter": [_P, _I, _I, _I, _P, _P, _P, _P],
        "pob_msm_bucket_sum": [_P, _P, _P, _P, _I, _I, _L, _P, _P],
        "pob_msm_reduce": [_P, _P, _I, _P, _P, _P, _P, _P],
        "pob_msm_fold": [_P, _I, _I, _I, _P, _P, _P, _P],
        "pob_msm_shifted_bases": [_P, _P, _P, _L, _I, _I, _I, _L, _L, _P, _P, _P],
        "pob_msm_max_levels": [],
    } for src in ("msm_g1.cu", "msm_g2.cu")},
    "fixed_base.cu": {
        "pob_fb_doublings": [_I, _P, _P, _P, _P, _P],
        "pob_fb_table": [_I, _P, _P, _P],
        "pob_fb_window": [_I, _P, _P, _L, _P, _P, _P, _P],
    },
    **{src: {
        "pob_bitsum_warps_per_sm": [],
        "pob_bitsum_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _P, _P],
        "pob_bitsum_reduce": [_P, _I, _I, _P, _P, _P, _P],
    } for src in ("bitsum_g1.cu", "bitsum_g2.cu")},
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit")


def _compile(src: str, out: str):
    tmp = out + f".{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    with open(out + ".ptxas.txt", "w") as f:
        f.write(res.stderr)
    os.replace(tmp, out)


def build_all() -> dict:
    """Compile (if not cached) and load every kernel library; returns the
    ctypes handles by source name."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        key = sources_hash()
        outdir = os.path.join(BUILD, key)
        os.makedirs(outdir, exist_ok=True)
        outs = {s: os.path.join(outdir, s.replace(".cu", ".so")) for s in SOURCES}
        todo = [s for s in SOURCES if not os.path.exists(outs[s])]
        if todo:
            with ThreadPoolExecutor(len(todo)) as ex:
                list(ex.map(lambda s: _compile(s, outs[s]), todo))
        for s in SOURCES:
            lib = ctypes.CDLL(outs[s])
            for fn, argtypes in _ARGTYPES[s].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[s] = lib
        return _libs


def lib(src: str):
    return build_all()[src]


def parse_ptxas(text: str) -> list:
    """`nvcc -Xptxas -v` output -> [(kernel, registers, spill store bytes,
    spill load bytes)], one entry per compiled entry function."""
    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return out


def _demangle(sym: str) -> str:
    """`_Z16bucket_sum_kernelI2FeE...` -> `bucket_sum_kernel<Fe>` (the
    kernel's name and, for a template on the coordinate type, Fe or Fq2,
    then its int arguments: `window_kernel<Fe,128,3>`)."""
    m = re.match(r"_Z(\d+)", sym)
    if not m:
        return sym
    n, rest = int(m.group(1)), sym[m.end():]
    name, rest = rest[:n], rest[n:]
    if rest.startswith("I"):
        targs = re.findall(r"\d(Fq2|Fe)E", rest[:24])
        ints = re.findall(r"Li(\d+)E", rest[:32])
        name += "<" + ",".join(targs[:1] + ints) + ">"
    return name


def ptxas_report() -> dict:
    """{source: parse_ptxas of its build log} for the current build."""
    build_all()
    outdir = os.path.join(BUILD, sources_hash())
    rep = {}
    for s in SOURCES:
        with open(os.path.join(outdir, s.replace(".cu", ".so")) + ".ptxas.txt") as f:
            rep[s] = parse_ptxas(f.read())
    return rep


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str):
    """Raise if the C launcher reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error code {rc}")


def check_cuda(*tensors, dtype=torch.int32):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("kernel input must be a CUDA tensor")
        if t.dtype != dtype:
            raise TypeError(f"kernel input must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel input must be 16-byte aligned")


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU; with
    no card and no explicit CPU request they raise rather than fall back."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain "
                           "PyTorch path")
    return device
