"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``hcpdiff_tpu_torch/csrc``
for ``sm_90a`` (one process per file, in parallel) and links them into one
shared library with a plain C interface under ``hcpdiff_tpu_torch/_build/``,
named after a hash of the sources, so an edited source builds anew. The
library is loaded with :mod:`ctypes`; every pointer and the stream are
passed as ``c_void_p``. Each C entry point returns ``cudaGetLastError()``
and :func:`check` raises if that is not 0.

Nothing here runs at import time: the CPU test suite imports every module
on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / '_build'
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = ARCH_FLAGS + ['-O3', '-std=c++17', '-Xcompiler', '-fPIC',
                           '-Xptxas=-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # `out_f32`: the epilogue's inputs (bias, res, row_bias) and the output
    # are fp32, not bf16; the matrix operands are bf16 either way.
    # mode, x, w, bias, res, out, workspace, M, N, K, bn, minb, splits, out_f32, stream
    'hcp_gemm': [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # mode, x, ln_g, ln_b, w0, w1, w2, bias, out0, out1, out2, nw, M, N, K, eps, out_f32,
    # stream
    'hcp_ln_gemm': [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    ctypes.c_float, _I, _P],
    # x, w, bias, row_bias, res, out, workspace, B, H, W, Cin, Cout, bn, splits, out_f32,
    # stream
    'hcp_conv3x3': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, lse (or null), B, H, Sq, Sk, D, strides[12], scale, causal, out_f32,
    # stream
    'hcp_flash_attention': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                            ctypes.c_float, _I, _I, _P],
    # q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, strides[15], scale, causal,
    # out_f32, stream
    'hcp_flash_bwd_dq': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                         ctypes.c_float, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, strides[18], scale, causal,
    # out_f32, stream
    'hcp_flash_bwd_dkv': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                          ctypes.c_float, _I, _I, _P],
    # x, scale, bias, y, partial, counters, B, S, C, G, nb, rows, chunk_rows, slots, rpp,
    # threads, smem, eps, silu, x_f32 (x and y fp32, not bf16), p_f32 (scale and bias
    # fp32), stream
    'hcp_group_norm': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(found):
        raise RuntimeError('nvcc not found: the Hopper kernels are built '
                           'with the CUDA toolkit at first use')
    return found


def _sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in ('.cu', '.cuh'):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into ``_build/libhcp_kernels_<hash>.so`` unless
    that file exists; returns its path. The compiler's output (ptxas
    register and spill counts included) goes to ``_build/build.log``."""
    lib_path = BUILD_DIR / f'libhcp_kernels_{_source_hash()}.so'
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        def compile_one(src: Path):
            obj = Path(tmp) / (src.stem + '.o')
            t = time.time()
            proc = subprocess.run([nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
                                  capture_output=True, text=True)
            return src, obj, proc, time.time() - t

        with ThreadPoolExecutor(max_workers=len(_sources())) as pool:
            results = list(pool.map(compile_one, _sources()))
        log = []
        for src, _, proc, seconds in results:
            log.append(f'== {src.name} (rc {proc.returncode}, {seconds:.1f} s)\n'
                       f'{proc.stdout}{proc.stderr}')
        failed = [src.name for src, _, proc, _ in results if proc.returncode != 0]
        if not failed:
            tmp_lib = Path(tmp) / lib_path.name
            proc = subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp_lib),
                                   *[str(obj) for _, obj, _, _ in results]],
                                  capture_output=True, text=True)
            log.append(f'== link (rc {proc.returncode})\n{proc.stdout}{proc.stderr}')
            if proc.returncode != 0:
                failed.append('link')
            else:
                os.replace(tmp_lib, lib_path)   # atomic: other processes see all or nothing
        log.append(f'== build seconds: {time.time() - t0:.1f}\n')
        (BUILD_DIR / 'build.log').write_text('\n'.join(log))
    if failed:
        raise RuntimeError(f'nvcc failed for {failed}; see {BUILD_DIR / "build.log"}')
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{kernel} kernel launch failed: CUDA error {rc}')


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, kernel: str, what: str) -> None:
    """Raise ValueError when a kernel's input contract does not hold."""
    if not cond:
        raise ValueError(f'{kernel} kernel: {what}')


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def require_cuda(kernel: str, *tensors) -> torch.dtype:
    """All given tensors (``None`` skipped) lie on one CUDA device and share
    one dtype, bf16 or fp32; returns it. An fp32 call rounds its matrix
    operands to bf16 and accumulates in fp32, the TPU's default precision
    for an fp32 product; what it reads around the product and writes stays
    fp32."""
    given = [t for t in tensors if t is not None]
    dev, dt = given[0].device, given[0].dtype
    for t in given:
        require(t.device.type == 'cuda' and t.device == dev, kernel,
                f'tensors must share one CUDA device, got {t.device} and {dev}')
        require(t.dtype == dt and dt in KERNEL_DTYPES, kernel,
                f'expects tensors of one dtype, bfloat16 or float32, got {t.dtype} and {dt}')
    return dt


def aligned16(t) -> bool:
    return t.data_ptr() % 16 == 0


def accum_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions and backwards compute in: fp32, or the
    input's own dtype where it is wider (float64 for gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)
