"""Benchmark ops (the compute under test).

Port of the JAX package's ``bench/ops.py`` (reference
tpus_benchmark_single-host_workload.py:125-175): the same compound op
structure (matmul -> transcendental mix -> matmul -> log/exp -> square) and
the same public layouts, so a call means the same in both packages.

- ``op_conv`` takes NHWC input and an HWIO kernel, as JAX's
  ``conv_general_dilated`` call does, and permutes inside to
  ``F.conv2d(padding="same")``. On the card it runs with cuDNN's TF32 off,
  so a float32 row computes in IEEE float32 (cuDNN's default is TF32).
- The FFT ops cast a bfloat16 input to float32 before ``torch.fft.fftn``,
  which takes no bfloat16; JAX computes that case in complex64 too and
  returns a float32 error.
- ``make_bandwidth_op``: ``stream`` (the sweep's op) and ``pallas_copy``,
  which launches kernel B10 (``ops/kernels/copy_cuda.py``) on the card. The
  mode keeps the JAX name so that a call means the same in both packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.copy_cuda import chunked_copy


def op_2d(a, b):
    """Compound 2D matmul chain (reference :125-131)."""
    c = torch.matmul(a, b)
    d = torch.tanh(c) + torch.sin(c / (torch.log(torch.abs(a[0, 0]) + 1) * 2 + 1))
    e = torch.matmul(a, d)
    f = torch.log1p(torch.abs(e)) + torch.exp(b * 0.001)
    return torch.square(f)


def op_3d(a, b):
    """Compound batched matmul chain (reference :133-139)."""
    c = torch.matmul(a, b)
    d = torch.tanh(c) + torch.sin(c / (torch.log(torch.abs(a[0, 0, 0]) + 1) * 2 + 1))
    e = torch.matmul(a, d)
    f = torch.log1p(torch.abs(e)) + torch.exp(b * 0.001)
    return torch.square(f)


def op_conv(x, kernel):
    """NHWC conv (HWIO kernel, SAME padding, stride 1) + tanh + sum of
    squares (reference :141-155)."""
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = kernel.permute(3, 2, 0, 1)
    if x.is_cuda:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            out = F.conv2d(x_nchw, w_oihw, padding="same")
    else:
        out = F.conv2d(x_nchw, w_oihw, padding="same")
    return torch.sum(torch.tanh(out) ** 2)


def _fft_error(a, precision):
    x = a.to(precision)
    if x.dtype == torch.bfloat16:
        x = x.float()
    f = torch.fft.fftn(x)
    rec = torch.fft.ifftn(f).real
    return torch.sum(torch.abs(rec - a) ** 2)


def op_fft_2d(a, precision):
    """FFT -> inverse -> reconstruction error (reference :165-169)."""
    return _fft_error(a, precision)


def op_fft_3d(a, precision):
    return _fft_error(a, precision)


def make_bandwidth_op(
    n_elems: int,
    dtype=torch.float32,
    mode: str = "stream",
    chunk: int = 512 * 1024,
    n_streams: int = 4,
):
    """Device-memory bandwidth op, counted as read + write of the full
    footprint (``bytes_per_call``).

    ``stream`` (default): ``n_streams`` independent elementwise passes
    ``x_i + 1`` over a tuple of buffers, one read and one write each; the op
    takes and returns a tuple, and each stream is its own loop carry.
    ``pallas_copy``: the chunked copy, kernel B10 on the card; ``n_elems``
    is truncated to whole chunks and the op copies the first ``n_elems``
    elements of its input.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    if mode == "stream":
        per_stream = max(1, n_elems // n_streams)

        def op(xs):
            return tuple(x + 1.0 for x in xs)

        op.n_elems = per_stream * n_streams
        op.n_streams = n_streams
        op.per_stream = per_stream
        op.bytes_per_call = 2 * op.n_elems * itemsize
        return op
    if mode != "pallas_copy":
        raise ValueError(f"unknown bandwidth mode {mode!r}: stream or pallas_copy")

    n_chunks = max(1, n_elems // chunk)
    n_elems = n_chunks * chunk  # truncate to whole chunks

    def op(x):
        if x.numel() < n_elems:
            raise ValueError(f"x: {x.numel()} elements, fewer than the op's {n_elems}")
        return chunked_copy(x[:n_elems])

    op.n_elems = n_elems
    op.bytes_per_call = 2 * n_elems * itemsize
    return op
