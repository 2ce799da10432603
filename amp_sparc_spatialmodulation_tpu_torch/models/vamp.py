"""SVD-form Vector AMP decoder — batched, per-trial early stopping,
resumable.

Port of the JAX package's ``models/vamp.py`` (reference ``vamp.py``, the
variant "adapted from prof. Kuehn"): the LMMSE stage in the singular-value
domain with ``scale = 1/(s^2 + sigma2/sigma2_tilde)`` (`vamp.py:66-73`),
the extrinsic subtraction with alpha clipped to ``[1e-5, 1-1e-5]``
(`vamp.py:51-54,75-82`), the segmented softmax denoiser WITHOUT the
``tau/2`` halving (`vamp.py:110`), the extrinsic update
``r_tilde = (xmmse - dxdr r)/(1 - dxdr)`` (`vamp.py:89-94`) and the
``allclose`` early stop on the posterior variance (`vamp.py:181-186`).  The
decision statistic is the pseudo-data ``r`` (`vamp.py:187`).

The per-trial scalars of the reference (``sigma2_tilde``, ``alpha``,
``dxdr``) are ``(B, 1)`` tensors, so the batch is the reference's serial
loop run side by side.  The SVD is computed once per channel realization,
outside the decode.  For a config the CUDA kernel covers, :func:`decode`
runs the whole decode through :func:`..ops.kernels.fused_vamp.whole_decode`
(the kernel on the card, its plain version on the CPU); everything else,
and ``use_pallas=False``, runs the plain PyTorch loop on either device
(:func:`kernel_route`).

``precision='high'`` is the JAX package's ``lax.Precision.HIGH``
(``ops/precision.py``): the projection ``y U^*`` as four real three-pass
bf16 products, and the decode through the kernel's HIGH form, whose plain
version is :func:`plain_loop_high`, the JAX kernel's iteration step by step
(Gauss combinations, ``dot3`` on each, ``rowsum3`` for the two row sums).
``precision='default'`` is the same with the one-pass product: the
projection in four real ``dot1`` products, the decode through the kernel's
DEFAULT form, whose plain version is :func:`plain_loop_default`
(``dot1`` and ``rowsum1``), the plain loop's products at DEFAULT.
The plain loop at HIGH (the random mode, the real-channel mode,
``use_pallas=False``) is JAX's XLA body at HIGH (`vamp.py:226-231` there),
its two products through ``ops/precision.py::matmul``: a different
function from :func:`plain_loop_high`.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops import denoise
from ..ops import precision as prec
from .bamp import DecodeResult, _allclose_rows, _freeze, check_use_pallas

_VR_MIN = 1e-5          # `vamp.py:51-52`
_VR_MAX = 1.0 - _VR_MIN
_VAR_MIN = 1e-9         # `vamp.py:53-54`
_VAR_MAX = 1e5

# Decodes that ran the plain PyTorch loop (any device).
plain_decodes = 0


class SVD(NamedTuple):
    """Economy SVD of the measurement matrix, ``A = U diag(s) Vh``."""

    U: torch.Tensor     # (n, p)
    s: torch.Tensor     # (p,) f32
    Vh: torch.Tensor    # (p, N)


def _materialized(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and with any lazy conjugation applied: PyTorch may
    return a factor as a conjugated view (``V.mH``), whose memory holds the
    conjugate of what it means, and the kernels read memory."""
    return t.resolve_conj().contiguous()


def svd(A: torch.Tensor, method: str = "auto") -> SVD:
    """Economy SVD (`vamp_model.py:58`), every factor contiguous and
    materialized.

    ``method='direct'`` is ``torch.linalg.svd``.  ``method='gram'`` takes
    the eigendecomposition of the small-side Gram matrix: for a wide
    ``(n, N)`` matrix ``A A^H = U diag(s^2) U^H`` and ``Vh = diag(1/s) U^H
    A``; for a tall one the same from ``A^H A``.  Singular values below
    about ``sqrt(eps) s_max`` come out as exact zeros there, which is
    harmless for VAMP (it uses ``s^2``) and fatal for vamp2, which divides
    by ``s``: vamp2 takes ``'direct'``.  ``'auto'`` picks ``'direct'``, as
    the JAX package does off the TPU (`vamp.py:70-71`).
    """
    if method == "auto":
        method = "direct"
    if method == "direct":
        U, s, Vh = torch.linalg.svd(A, full_matrices=False)
        return SVD(U=_materialized(U), s=s.to(torch.float32).contiguous(),
                   Vh=_materialized(Vh))
    if method != "gram":
        raise ValueError(f"unknown SVD method {method!r}")
    n, N = A.shape
    if n <= N:
        w, U = torch.linalg.eigh(A @ A.conj().T)          # ascending
        s = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
        U = U.flip(1)
        safe = torch.maximum(s, s[0] * 1e-7 + 1e-30)
        Vh = denoise.div_real(U.conj().T @ A, safe[:, None])
        return SVD(U=_materialized(U), s=s.to(torch.float32),
                   Vh=_materialized(Vh))
    w, V = torch.linalg.eigh(A.conj().T @ A)
    s = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
    V = V.flip(1)
    safe = torch.maximum(s, s[0] * 1e-7 + 1e-30)
    U = denoise.div_real(A @ V, safe[None, :])
    return SVD(U=_materialized(U), s=s.to(torch.float32),
               Vh=_materialized(V.conj().T))


class VAMPState(NamedTuple):
    r_tilde: torch.Tensor       # (B, N) complex
    sigma2_tilde: torch.Tensor  # (B, 1) f32
    r: torch.Tensor             # (B, N) complex — pseudo-data
    var: torch.Tensor           # (B, N) f32
    xmmse: torch.Tensor         # (B, N) complex
    active: torch.Tensor        # (B,) bool
    T: torch.Tensor             # (B,) int32
    t: int                      # global iteration counter

    @property
    def xmap(self) -> torch.Tensor:
        """The decision statistic: the pseudo-data ``r`` (`vamp.py:187`)."""
        return self.r


def make_denoiser(cfg: Config, device):
    """The segmented posterior without ``tau/2`` and with the decomposed
    variance; in random mode the Bernoulli mixture, whose variance
    completes the reference's broken random path (`vamp.py:121-139`)."""
    symbols = torch.as_tensor(cfg.symbols, device=device)
    if cfg.mode in ("segmented", "sparc"):
        return partial(denoise.segmented_posterior, symbols=symbols,
                       L=cfg.L, M=cfg.M, halve_tau=False,
                       variance="decomposed")
    return partial(denoise.bernoulli_mixture_posterior, symbols=symbols,
                   Ps=cfg.Ps, P0=cfg.P0)


def project(dec: SVD, y: torch.Tensor,
            precision: str = "highest") -> torch.Tensor:
    """``y_tilde = s (y U^*)``, the data in the singular-value domain
    (`vamp.py:22`), shape (B, p); the product at ``precision``."""
    return dec.s[None, :] * prec.matmul(y, dec.U.conj(), precision)


def gauss_taps(Vh: torch.Tensor):
    """The six float32 tap planes of the JAX kernels' Gauss complex
    product (``fused_vamp.py:310-321``), for a (p, N) factor or a (C, p, N)
    stack ``Vh = c + i d``: forward on ``Vh^T`` (N, p) ``c, d - c, c + d``;
    adjoint on ``Vh`` (p, N) ``c, -d - c, c - d``.  With these, ``x Vh^T``
    is ``k1 - k3 + i (k1 + k2)`` for ``k1 = (a + b) T0, k2 = a T1, k3 = b
    T2`` (``x = a + i b``), and ``w conj(Vh)`` the same on T3..T5."""
    Vh = Vh.resolve_conj()
    c, d = Vh.real.float(), Vh.imag.float()
    ct, dt = c.mT, d.mT
    return ct, dt - ct, ct + dt, c, -d - c, c - d


def initial_state(y: torch.Tensor, cfg: Config) -> VAMPState:
    """The decode's starting state (`vamp.py:25-30`)."""
    B, N = y.shape[0], cfg.N
    dev = y.device
    sp = cfg.sparsity
    s2t0 = sp ** 2 * (1 - sp) + (1 - sp) ** 2 * sp
    return VAMPState(
        r_tilde=torch.full((B, N), sp, dtype=y.dtype, device=dev),
        sigma2_tilde=torch.full((B, 1), s2t0, dtype=torch.float32,
                                device=dev),
        r=torch.zeros((B, N), dtype=y.dtype, device=dev),
        var=torch.ones((B, N), dtype=torch.float32, device=dev),
        xmmse=torch.zeros((B, N), dtype=y.dtype, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        T=torch.zeros((B,), dtype=torch.int32, device=dev),
        t=0)


def plain_loop(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
               s: VAMPState, sigma2: float, cap: int, cfg: Config,
               precision: str = "highest") -> VAMPState:
    """The plain PyTorch iteration loop from state ``s`` on one SVD factor
    ``Vh (p, N)`` with squared singular values ``s2 (p,)``: run until ``t``
    reaches ``cap`` or every trial converged (`vamp.py:220-261`), the two
    products at ``precision``."""
    global plain_decodes
    plain_decodes += 1
    noise_var = float(np.float32(sigma2))
    cap = int(cap)
    p, N = Vh.shape
    eta = p / N                                               # `vamp.py:28`
    s2 = s2.reshape(1, p)
    Vh_t, Vh_c = Vh.T, Vh.conj()        # r @ Vh_t == Vh r; w @ Vh_c == V w
    mm = partial(prec.matmul, precision=prec.canonical(precision))
    denoiser = make_denoiser(cfg, y_tilde.device)
    while s.t < cap and bool(s.active.any()):
        # LMMSE stage in the SV domain (`vamp.py:66-73`).
        var_ratio = noise_var / s.sigma2_tilde                   # (B, 1)
        q = mm(s.r_tilde, Vh_t)                                  # (B, p)
        scale = 1.0 / (s2 + var_ratio)                           # (B, p)
        x_sv = scale * (y_tilde + var_ratio * q)
        var_lmmse = scale.mean(dim=1, keepdim=True) * noise_var
        x_tilde = mm(x_sv - q, Vh_c) + s.r_tilde                 # (B, N)
        x_tilde_var = eta * var_lmmse + (1.0 - eta) * s.sigma2_tilde

        # Extrinsic subtraction (`vamp.py:75-82`).
        alpha = torch.clamp(x_tilde_var / s.sigma2_tilde, _VR_MIN, _VR_MAX)
        r = denoise.div_real(x_tilde - alpha * s.r_tilde, 1.0 - alpha)
        sig2_den = torch.clamp(alpha / (1.0 - alpha) * s.sigma2_tilde,
                               _VAR_MIN, _VAR_MAX)

        # Denoiser stage and extrinsic update (`vamp.py:84-94`).
        xmmse, var = denoiser(r, sig2_den)
        dxdr = torch.clamp(var.mean(dim=1, keepdim=True) / sig2_den,
                           _VR_MIN, _VR_MAX)
        norm = 1.0 / (1.0 - dxdr)
        r_tilde = (xmmse - dxdr * r) * norm
        sigma2_tilde = torch.clamp(sig2_den * dxdr * norm, _VAR_MIN,
                                   _VAR_MAX)

        converged = _allclose_rows(var, s.var)
        s = VAMPState(
            r_tilde=_freeze(s.active, r_tilde, s.r_tilde),
            sigma2_tilde=_freeze(s.active, sigma2_tilde, s.sigma2_tilde),
            r=_freeze(s.active, r, s.r),
            var=_freeze(s.active, var, s.var),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    return s


def plain_loop_high(Vh: torch.Tensor, s2: torch.Tensor, y_tilde: torch.Tensor,
                    s: VAMPState, sigma2: float, cap: int, cfg: Config,
                    precision: str = "high") -> VAMPState:
    """The plain loop at ``precision='high'``: the JAX kernel's iteration
    (``fused_vamp.py:124-200``) step by step, with the Gauss combinations
    of :func:`gauss_taps`, ``dot3`` on each real product and ``rowsum3``
    for the two row sums the kernel writes as products with ones
    (``var_lmmse``, ``dxdr``); the rest as :func:`plain_loop`.  At
    ``precision='default'`` the same with ``dot1`` and ``rowsum1``."""
    dot, rowsum = prec.DOTS[precision]
    global plain_decodes
    plain_decodes += 1
    noise_var = float(np.float32(sigma2))
    cap = int(cap)
    p, N = Vh.shape
    eta = p / N
    s2 = s2.reshape(1, p)
    T0, T1, T2, T3, T4, T5 = gauss_taps(Vh)
    y_re, y_im = y_tilde.real, y_tilde.imag
    denoiser = make_denoiser(cfg, y_tilde.device)
    while s.t < cap and bool(s.active.any()):
        var_ratio = noise_var / s.sigma2_tilde                   # (B, 1)
        a, b = s.r_tilde.real, s.r_tilde.imag
        k1, k2, k3 = dot(a + b, T0), dot(a, T1), dot(b, T2)
        q_re, q_im = k1 - k3, k1 + k2                            # (B, p)
        scale = 1.0 / (s2 + var_ratio)
        w_re = scale * (y_re + var_ratio * q_re) - q_re
        w_im = scale * (y_im + var_ratio * q_im) - q_im
        var_lmmse = rowsum(scale) / p * noise_var
        k1, k2, k3 = dot(w_re + w_im, T3), dot(w_re, T4), dot(w_im, T5)
        xt_re, xt_im = k1 - k3 + a, k1 + k2 + b                  # (B, N)
        x_tilde_var = eta * var_lmmse + (1.0 - eta) * s.sigma2_tilde

        alpha = torch.clamp(x_tilde_var / s.sigma2_tilde, _VR_MIN, _VR_MAX)
        r = torch.complex((xt_re - alpha * a) / (1.0 - alpha),
                          (xt_im - alpha * b) / (1.0 - alpha))
        sig2_den = torch.clamp(alpha / (1.0 - alpha) * s.sigma2_tilde,
                               _VAR_MIN, _VAR_MAX)

        xmmse, var = denoiser(r, sig2_den)
        dxdr = torch.clamp(rowsum(var) / N / sig2_den, _VR_MIN, _VR_MAX)
        norm = 1.0 / (1.0 - dxdr)
        r_tilde = (xmmse - dxdr * r) * norm
        sigma2_tilde = torch.clamp(sig2_den * dxdr * norm, _VAR_MIN,
                                   _VAR_MAX)

        converged = _allclose_rows(var, s.var)
        s = VAMPState(
            r_tilde=_freeze(s.active, r_tilde, s.r_tilde),
            sigma2_tilde=_freeze(s.active, sigma2_tilde, s.sigma2_tilde),
            r=_freeze(s.active, r, s.r),
            var=_freeze(s.active, var, s.var),
            xmmse=_freeze(s.active, xmmse, s.xmmse),
            active=s.active & ~converged,
            T=torch.where(s.active, torch.full_like(s.T, s.t + 1), s.T),
            t=s.t + 1)
    return s


def plain_loop_default(Vh, s2, y_tilde, s: VAMPState, sigma2: float,
                       cap: int, cfg: Config) -> VAMPState:
    """The plain version of K3's DEFAULT form: :func:`plain_loop_high` at
    ``'default'``."""
    return plain_loop_high(Vh, s2, y_tilde, s, sigma2, cap, cfg, "default")


def kernel_route(cfg: Config, covered: bool, use_pallas="auto") -> bool:
    """True when the VAMP or vamp2 decode runs its kernel: on a config the
    kernel covers (``covered``), unless ``use_pallas`` is False;
    ``use_pallas=True`` raises on a config it does not cover (JAX's honest
    knob, `vamp.py:173-180` there)."""
    check_use_pallas(use_pallas)
    if use_pallas is False:
        return False
    if use_pallas is True and not covered:
        raise ValueError(
            "use_pallas=True: the VAMP kernels cover complex "
            f"segmented/sparc alphabets, not mode={cfg.mode!r} "
            f"is_complex={cfg.is_complex}")
    return covered


def decode(dec: SVD, y: torch.Tensor, sigma2, cfg: Config, *,
           state0: VAMPState | None = None, iter_cap: int | None = None,
           return_state: bool = False, precision: str = "highest",
           use_pallas="auto"):
    """Run VAMP on a batch of trials sharing one channel SVD.

    Args:
        dec: the channel's :class:`SVD` on ``y``'s device.
        y: (B, n) received vectors; the decode runs on ``y``'s device.
        sigma2: scalar noise variance.
        cfg: system config.
        state0 / iter_cap / return_state: resumable decoding, as in
            :func:`.bamp.decode`.
        precision: 'highest' (default), 'high' or 'default' (module
            docstring).
        use_pallas: 'auto' (default), True or False (:func:`kernel_route`).

    A config the kernel covers (complex segmented/sparc alphabets) goes
    through the whole-decode CUDA kernel on a CUDA device and its plain
    version on the CPU; the random mode and the real-channel mode run the
    plain loop on either device, as the JAX package falls back to XLA.

    Returns:
        :class:`.bamp.DecodeResult` with ``xmap = r`` (and the final
        :class:`VAMPState` when ``return_state``).
    """
    from ..ops.kernels import fused_vamp

    precision = prec.canonical(precision)
    kernel = kernel_route(cfg, fused_vamp.covers(cfg), use_pallas)
    if state0 is None:
        state0 = initial_state(y, cfg)
    cap = cfg.N_Layers if iter_cap is None else int(iter_cap)
    y_tilde = project(dec, y, precision)
    s2 = dec.s ** 2
    if kernel:
        s = fused_vamp.whole_decode(dec.Vh, s2, y_tilde, state0, sigma2, cap,
                                    cfg, precision)
    else:
        s = plain_loop(dec.Vh, s2, y_tilde, state0, sigma2, cap, cfg,
                       precision)
    result = DecodeResult(xmap=s.r, xmmse=s.xmmse, var=s.var, T=s.T)
    if return_state:
        return result, s
    return result


def decode_batched(A_batch: torch.Tensor, y_batch: torch.Tensor, sigma2,
                   cfg: Config, precision: str = "highest") -> DecodeResult:
    """Decode ``C`` channel realizations' trial batches in one kernel
    launch (the realization-batched form of the kernel, `vamp.py:269-325`).

    ``A_batch`` is the (C, n, N) stack of measurement matrices, ``y_batch``
    the (C, B, n) received trials; every trial starts from the initial state
    and runs to ``cfg.N_Layers``.  Returns a :class:`.bamp.DecodeResult`
    whose fields have the leading axis ``C``.  Each realization's
    trajectories are those of a separate :func:`decode`: the kernel body is
    the same, only the factor each block reads differs.  ``precision`` as
    in :func:`decode`."""
    from ..ops.kernels import fused_vamp

    precision = prec.canonical(precision)
    if not fused_vamp.covers(cfg):
        raise ValueError("decode_batched needs a config the VAMP kernel "
                         "covers (complex segmented/sparc alphabets)")
    C, B, _ = y_batch.shape
    decs = [svd(A) for A in A_batch]
    Vh = torch.stack([d.Vh for d in decs])                  # (C, p, N)
    s2 = torch.stack([d.s for d in decs]) ** 2              # (C, p)
    y_tilde = torch.cat([project(d, y, precision)
                         for d, y in zip(decs, y_batch)])
    state0 = initial_state(y_batch.reshape(C * B, -1), cfg)
    s = fused_vamp.whole_decode(Vh, s2, y_tilde, state0, sigma2,
                                cfg.N_Layers, cfg, precision)
    unflat = lambda a: a.reshape((C, B) + tuple(a.shape[1:]))
    return DecodeResult(xmap=unflat(s.r), xmmse=unflat(s.xmmse),
                        var=unflat(s.var), T=unflat(s.T))
