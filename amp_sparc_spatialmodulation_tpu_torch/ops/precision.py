"""Matrix-product precision of the decoders' products.

The port's own copy of the JAX package's ``ops/pallas/fused_bamp.py:60-93``
(``_split_bf16``, ``dot3``, ``make_dot``).  ``'highest'`` is the full FP32
product, the default everywhere.  ``'high'`` is the three-pass bf16 product
of ``lax.Precision.HIGH`` as the JAX kernels compute it in-kernel: both
operands split into bf16 hi + lo parts, and the three significant cross
products (hi·hi, hi·lo, lo·hi) summed in float32; the lo·lo term lies below
float32's resolution.  ``'default'`` is the one-pass bf16 product of
``lax.Precision.DEFAULT`` on the TPU (``make_dot(DEFAULT)``, ``_DOT1``
there): both operands rounded to bf16 (the hi part, round to nearest even)
and the product accumulated in float32.  A bf16 × bf16 product is exact in
float32, so the plain versions here compute in float32 what the TPU's
passes compute; the CUDA kernels run the same passes on the tensor cores.

XLA on the CPU computes a product at DEFAULT (and at HIGH) in full float32,
so the JAX package run unpatched on the CPU is no witness of either: the
port's tests patch JAX's in-kernel ``make_dot`` and its ``jnp.matmul`` to
the passes above (``tests/test_torch_default.py``,
``tests/test_torch_plain_high.py``).

``'auto'`` is a policy of the sweep engine (``models/montecarlo.py``), not a
precision of a product: it picks ``'high'`` for a point when the previous
point's mean T pinned at the iteration cap, and never ``'default'``.
"""
from __future__ import annotations

import os

import torch

HIGHEST = "highest"
HIGH = "high"
DEFAULT = "default"
AUTO = "auto"
# The precisions whose products run in bf16 passes on the tensor cores.
BF16 = (HIGH, DEFAULT)


def canonical(precision, allow_auto: bool = False) -> str:
    """``'highest'`` (also for ``None``), ``'high'``, ``'default'`` or,
    where ``allow_auto``, ``'auto'``; raises on anything else."""
    if precision is None:
        return HIGHEST
    p = str(precision).lower()
    if p in (HIGHEST, HIGH, DEFAULT) or (allow_auto and p == AUTO):
        return p
    allowed = "'highest', 'high', 'default'" + (" or 'auto'" if allow_auto
                                                else "")
    raise ValueError(f"unknown precision {precision!r}: use {allowed}")


# The names ``jax.lax.Precision(str)`` accepts, each with the precision it
# stands for (``_precision_strings`` in JAX's ``lax.py``): exact, lower case.
PRECISION_NAMES = {"highest": HIGHEST, "float32": HIGHEST, "high": HIGH,
                   "bfloat16_3x": HIGH, "tensorfloat32": HIGH,
                   "default": DEFAULT, "bfloat16": DEFAULT,
                   "fastest": DEFAULT}
# The JAX whole-decode kernel's knob for the precision of its xmap chain
# (``FusedBandedDecode.__init__``, `fused_bamp.py:990-991` there).
XMAP_PRECISION_VAR = "AMP_KERNEL_XMAP_PRECISION"


def xmap_precision():
    """The xmap chain's precision that ``AMP_KERNEL_XMAP_PRECISION`` asks
    the BAMP whole-decode kernel for: None where the variable is unset or
    empty, else ``'highest'``, ``'high'`` or ``'default'``.  It takes
    exactly the strings ``jax.lax.Precision`` takes (:data:`PRECISION_NAMES`)
    and raises ``ValueError`` on any other, ``'HIGHEST'`` included, as JAX's
    ``make_dot`` does when the kernel is traced."""
    value = os.environ.get(XMAP_PRECISION_VAR, "")
    if not value:
        return None
    if value not in PRECISION_NAMES:
        raise ValueError(
            f"{XMAP_PRECISION_VAR}={value!r} is not a valid precision: use "
            f"one of {', '.join(map(repr, PRECISION_NAMES))}")
    return PRECISION_NAMES[value]


def split_bf16(x: torch.Tensor):
    """``(hi, lo)`` bf16 parts of a float32 tensor, ``x ≈ hi + lo``; both
    rounded to nearest even, as ``x.astype(jnp.bfloat16)`` is."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def dot3(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``x @ a`` of two float32 matrices in three bf16 passes, grouped as
    JAX's ``dot3``: the main term plus the sum of the two corrections."""
    x_hi, x_lo = (t.float() for t in split_bf16(x))
    a_hi, a_lo = (t.float() for t in split_bf16(a))
    return x_hi @ a_hi + (x_hi @ a_lo + x_lo @ a_hi)


def rowsum3(x: torch.Tensor) -> torch.Tensor:
    """``dot3(x, ones((n, 1)))``, the row sums the JAX kernels write as a
    product with ones: the ones split to hi = 1, lo = 0, so the hi·lo term
    is exactly zero and this is ``sum(hi) + sum(lo)`` (shape (B, 1))."""
    hi, lo = split_bf16(x)
    return (hi.float().sum(dim=1, keepdim=True)
            + lo.float().sum(dim=1, keepdim=True))


def dot1(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``x @ a`` of two float32 matrices in one bf16 pass, JAX's
    ``make_dot(DEFAULT)`` on the TPU: both operands rounded to bf16 (the hi
    part of :func:`split_bf16`), the product summed in float32."""
    return x.to(torch.bfloat16).float() @ a.to(torch.bfloat16).float()


def rowsum1(x: torch.Tensor) -> torch.Tensor:
    """``dot1(x, ones((n, 1)))``, the row sums the JAX kernels write as a
    product with ones at DEFAULT: ``sum(hi)`` (shape (B, 1))."""
    return x.to(torch.bfloat16).float().sum(dim=1, keepdim=True)


# The real product and the row sum of each bf16 precision.
DOTS = {HIGH: (dot3, rowsum3), DEFAULT: (dot1, rowsum1)}


def matmul(x: torch.Tensor, a: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ a`` at ``precision``.  At ``'highest'`` exactly ``x @ a``; at
    ``'high'`` (``'default'``) a complex product is four real :func:`dot3`
    (:func:`dot1`) products, as XLA forms a complex product at HIGH
    (DEFAULT) outside the kernels."""
    if precision == HIGHEST:
        return x @ a
    if precision not in DOTS:
        raise ValueError(f"no product at precision {precision!r}")
    d = DOTS[precision][0]
    if not x.is_complex():
        return d(x, a)
    xr, xi, ar, ai = x.real, x.imag, a.real, a.imag
    return torch.complex(d(xr, ar) - d(xi, ai), d(xr, ai) + d(xi, ar))
