"""K3: VQ codebook nearest-neighbour lookup on Hopper (port of
xtts_tpu/ops/vq.py).

Reference semantics (ttts/vqvae/xtts_dvae.py:87-93): with codebook `embed`
of shape (dim, n_embed),

    dist = |x|^2 - 2 x @ embed + |embed|^2        # (N, n_embed)
    codes = argmin(dist, axis=1)                   # first index on ties

The |x|^2 term is constant per row, so the argmin only needs
|e_j|^2 - 2 x.e_j. `vq_nearest` launches the CUDA kernel of csrc/vq.cu for a
CUDA tensor (counting the launch in `vq_nearest.launches`) and runs the plain
twin `vq_nearest_plain` for a CPU tensor. The twin takes fp32 products
(no TF32); the kernel takes its products on the tensor cores in 3xTF32
(each operand split into two tf32 parts, three products summed in f32),
which keeps each product within ~2^-21 of |x||e| relative: the codes equal
the twin's except at near ties within an fp32 dot product's error bound
(tests/test_torch_port_kernels.py _vq_agree).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from xtts_tpu_torch.ops.build import (check, load_library, ptr,
                                      require_hopper, stream_of)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("vq")
    lib.xt_vq_ranges.argtypes = [_I]
    lib.xt_vq_ranges.restype = _I
    lib.xt_vq_nearest.argtypes = [_P] * 6 + [_I, _I, _I, _P]
    lib.xt_vq_nearest.restype = _I
    return lib


def vq_nearest_plain(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """(N, D) rows, (D, E) codebook -> (N,) int64 codes: the XLA formula of
    xtts_tpu/ops/vq.py (vq_nearest_xla) in fp32."""
    x = x.float()
    e = embed.float()
    dist = (e * e).sum(0)[None, :] - 2.0 * (x @ e)
    return torch.argmin(dist, dim=1)


def _vq_nearest_cuda(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    d2, e = embed.shape
    if (x.dtype != torch.float32 or embed.dtype != torch.float32
            or d != d2 or not x.is_contiguous()
            or not embed.is_contiguous() or embed.device != x.device):
        raise ValueError(f"vq_nearest takes contiguous float32 (N, D) rows "
                         f"and a (D, E) codebook on one card; got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(embed.shape)} "
                         f"{embed.dtype}")
    require_hopper(x)
    lib = _lib()
    esq = torch.empty((e,), dtype=torch.float32, device=x.device)
    ranges = lib.xt_vq_ranges(e)
    part_v = torch.empty((n, ranges), dtype=torch.float32, device=x.device)
    part_i = torch.empty((n, ranges), dtype=torch.int32, device=x.device)
    codes = torch.empty((n,), dtype=torch.int64, device=x.device)
    check(lib.xt_vq_nearest(ptr(x), ptr(embed), ptr(esq), ptr(part_v),
                            ptr(part_i), ptr(codes), n, d, e, stream_of(x)),
          "vq_nearest")
    vq_nearest.launches += 1
    return codes


def vq_nearest(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """x (..., D), embed (D, E) -> int64 codes of shape x.shape[:-1], the
    first index on ties. The kernel for a CUDA tensor, the plain twin for a
    CPU tensor."""
    lead = x.shape[:-1]
    flat = x.detach().reshape(-1, x.shape[-1])
    embed = embed.detach()
    if not flat.is_cuda:
        return vq_nearest_plain(flat, embed).reshape(lead)
    return _vq_nearest_cuda(flat.float().contiguous(),
                            embed.float().contiguous()).reshape(lead)


vq_nearest.launches = 0


def vq_soft_codes(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Full -dist "soft codes" including the |x|^2 term
    (ttts/vqvae/xtts_dvae.py:88-89 return_soft_codes path)."""
    x32 = x.float()
    e32 = embed.float()
    dist = ((x32 * x32).sum(-1, keepdim=True) - 2.0 * x32 @ e32
            + (e32 * e32).sum(0)[None, :])
    return -dist


KERNELS = (vq_nearest,)
