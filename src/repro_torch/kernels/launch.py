"""The ctypes launcher shared by the kernel wrappers (``ivf_scan.py``,
``pq_adc.py``, ``paged_attention.py``).

``check`` holds a wrapper's argument to the kernel's device, dtype, shape
and contiguity; ``count`` adds a launch to a wrapper's ``LAUNCHES`` under
a lock; ``run`` loads the source's library (``build.library``,
nvcc at first use) and sets up its entry point once, then calls it on the
current stream and raises if it returns a CUDA error.  Each entry point's C signature is listed in
``SIGNATURES``, the stream (its last argument) included: ctypes passes an
argument past the list as a C int, which leaves the upper half of a
pointer undefined.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build

# shared memory a block may use on Hopper (227 KB of the SM's 256 KB), and
# what an SM holds for all its blocks (228 KB, 1 KB of it reserved a block)
SMEM_LIMIT = 232_448
SM_SHARED = 233_472

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "coarse_topk_f32": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P],
    "ivf_block_scan_f32": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    "ivf_block_topk_f32": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I,
                           _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                           _P],
    "rerank_topk_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "rerank_topk_empty": [_I, _P],
    "ivf_block_topk_int8": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P,
                            _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P, _P, _P, _P],
    "ivf_pq_block_topk": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P],
    "pq_adc_f32": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "paged_decode_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, ctypes.c_float, _P,
                                   _P, _P],
}
for _name in ("ivf_block_scan", "ivf_block_topk", "rerank_topk",
              "paged_decode_attention"):
    SIGNATURES[f"{_name}_bf16"] = SIGNATURES[f"{_name}_f32"]
SIGNATURES["rerank_topk_i8"] = SIGNATURES["rerank_topk_f32"]


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's number of SMs, which the split planners read."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNT_LOCK = threading.Lock()


def count(launches: dict, key: str) -> None:
    """Add one launch to ``launches[key]``: under a lock, since two
    serving lanes launch at once and a bare ``+= 1`` can lose counts."""
    with _COUNT_LOCK:
        launches[key] += 1


_BOUND: dict = {}  # (source, symbol) -> (library, entry), set up once


def _entry(source: str, symbol: str):
    bound = _BOUND.get((source, symbol))
    if bound is None:
        with build.LOCK:  # load and signature setup once, by one thread
            bound = _BOUND.get((source, symbol))
            if bound is None:
                lib = build.library(source)
                fn = getattr(lib, symbol)
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                fn.restype = ctypes.c_int
                fn.argtypes = SIGNATURES[symbol]
                bound = _BOUND[(source, symbol)] = (lib, fn)
    return bound


def run(source: str, symbol: str, device: torch.device, *args) -> None:
    lib, fn = _entry(source, symbol)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")


def check(name: str, t: torch.Tensor, dtypes, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
