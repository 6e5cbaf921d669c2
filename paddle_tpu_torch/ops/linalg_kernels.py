"""Linear-algebra op kernels (``paddle_tpu/ops/linalg_kernels.py``), the ones ``tensor_kernels.py`` does not hold.

Plain torch (``torch.linalg``) over the JAX kernels' attribute names, each
with the JAX kernel's conventions: ``cholesky_solve(b, l)`` takes the
factor second, ``lu`` returns ``(p, l, u)`` with ``x = p @ l @ u``,
``eigvalsh`` reads the lower triangle whatever ``UPLO`` says (as
``jnp.linalg.eigvalsh`` does there), ``householder_product`` applies the
reflectors in the JAX kernel's order, and ``cov``/``corrcoef`` take
``rowvar``.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = []


@register_op("cholesky_solve")
def cholesky_solve(b, l, *, upper=False):
    return torch.cholesky_solve(b, l, upper=upper)


@register_op("lu", num_outputs=3)
def lu(x):
    p, l, u = torch.linalg.lu(x)
    return p, l, u


@register_op("eigvalsh")
def eigvalsh(x, *, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO="L")


@register_op("matrix_norm")
def matrix_norm(x, *, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis), keepdim=keepdim)


@register_op("cov")
def cov(x, *, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


@register_op("corrcoef")
def corrcoef(x, *, rowvar=True):
    return torch.corrcoef(x if rowvar else x.T)


@register_op("householder_product")
def householder_product(x, tau):
    """The JAX kernel's accumulation of the reflectors ``H_i = I - tau_i
    v_i v_i^T`` of a packed QR (``v_i`` is column ``i`` of ``x`` below the
    diagonal, 1 on it): each applied on the left in turn, ``H_{k-1} ...
    H_1 H_0``, and the first ``n`` columns kept. That is the transpose of
    LAPACK's ``orgqr`` product ``H_0 H_1 ... H_{k-1}`` (each ``H_i`` is
    symmetric); the port keeps the JAX package's order."""
    m, n = x.shape[-2], x.shape[-1]
    rows = torch.arange(m, device=x.device)
    q = torch.eye(m, dtype=x.dtype, device=x.device)
    for i in range(n):
        v = torch.where(rows < i, 0.0, x[..., :, i])
        v = torch.where(rows == i, 1.0, v)
        q = q - tau[i] * torch.outer(v, v @ q)
    return q[..., :, :n]


@register_op("multi_dot")
def multi_dot(*arrays):
    return torch.linalg.multi_dot(list(arrays))
