"""The HIGH form of the BAMP decode (``precision='high'``) against the JAX
package on the CPU: the tap-form operator's products at HIGH, the folded
Gauss tap planes of the whole-decode kernel K1 and their split fragments,
the plain HIGH version of K1 (``bamp.plain_loop_high``) against JAX's
Pallas kernel at ``Precision.HIGH`` in interpret mode, split-and-resume,
the decoders' routes at HIGH and the sweep engine and CLI at 'high' and
'auto' for BAMP and SCAMP.

* ``BandedOperator``'s four maps at HIGH equal the same maps written with
  JAX's ``fused_bamp.dot3`` on the same tap stack within 1e-6 relative to
  the maps of the absolute values; at HIGHEST they are ``x @ taps``
  exactly.
* The plain HIGH decode against the JAX kernel on the geometries of
  ``tests/test_torch_fused_bamp.py``: per-trial T identical, the state
  within 1e-4 on the trials that converged and within 1e-3 on those that
  ran to the cap without converging (AMP that does not decode has no
  fixed point and amplifies the FP32 summation order of XLA's and
  PyTorch's products, as ``chip_smoke.py::compare(free_unconverged)``
  says; on these geometries the largest such error is 2.6e-4, 8PSK).
* The kernel's index maps: one iteration of the CUDA source's HIGH passes
  mirrored in NumPy (tap fragments, split operands, slots, fold, the
  zeroed pads) equals ``bamp.linear_step_high`` within 1e-5.

The CUDA kernel itself is held against the plain HIGH version on the card
by ``chip_smoke.py`` (``kernels_bamp_high``); the test here that needs the
card is marked ``cuda`` and skips without one.
"""
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amp_sparc_spatialmodulation_tpu.models import bamp as jbamp
from amp_sparc_spatialmodulation_tpu.ops.pallas import fused_bamp as jfb
from amp_sparc_spatialmodulation_tpu_torch import cli
from amp_sparc_spatialmodulation_tpu_torch.config import Config
from amp_sparc_spatialmodulation_tpu_torch.models import (bamp, montecarlo,
                                                          scamp)
from amp_sparc_spatialmodulation_tpu_torch.ops import operators
from amp_sparc_spatialmodulation_tpu_torch.ops import precision as prec
from amp_sparc_spatialmodulation_tpu_torch.ops.channel import band_indices
from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import (fused_bamp,
                                                               fused_scamp)
from amp_sparc_spatialmodulation_tpu_torch.utils import metrics
from amp_sparc_spatialmodulation_tpu_torch.utils.device import make_generator
from test_torch_fused_bamp import GEOMETRIES, shared_inputs

HIGH = jax.lax.Precision.HIGH
SMALL = dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented",
             profile="uniform", alphabet="OOK", trunc="tail", iterations=12)


def _jdot3(x, a):
    return np.asarray(jfb.dot3(jnp.asarray(x), jnp.asarray(a)), np.float64)


def _jmm(x, a):
    """A product at HIGH written with JAX's dot3: one for real operands,
    four for a complex one."""
    if not np.iscomplexobj(x) and not np.iscomplexobj(a):
        return _jdot3(x, a)
    x, a = x.astype(np.complex64), a.astype(np.complex64)
    return (_jdot3(x.real, a.real) - _jdot3(x.imag, a.imag)) + 1j * (
        _jdot3(x.real, a.imag) + _jdot3(x.imag, a.real))


def _maps(op, x, z, v, u, mm):
    """The four tap-stack maps of ``op`` (apply of ``x``, apply_adj of
    ``z``, apply_abs2 of ``v``, apply_abs2T of ``u``) on NumPy inputs with
    the product ``mm``, the gains after the products
    (``ops/operators.py``)."""
    B, Lin, Lout, Lh, Nt, Nr = (x.shape[0], op.Lin, op.Lout, op.Lh, op.Nt,
                                op.Nr)
    S, S2 = op.h_stack.numpy(), op.abs_h2_stack.numpy()
    g, g2 = op.gains.numpy(), op.gains2.numpy()

    def fwd(v, taps, gains):
        P = np.asarray(mm(v.reshape(B * Lin, Nt), taps)).reshape(
            B, Lin, Lh, Nr)
        y = np.zeros((B, Lout, Nr), P.dtype)
        for l in range(Lh):
            rows, cols = band_indices(Lin, Lout, l, op.trunc)
            y[:, rows] += gains[l, cols][None, :, None] * P[:, cols, l]
        return y.reshape(B, Lout * Nr)

    def bwd(w, taps, gains):
        wb = w.reshape(B, Lout, Nr)
        Z = np.zeros((B, Lin, Lh, Nr), w.dtype)
        for l in range(Lh):
            rows, cols = band_indices(Lin, Lout, l, op.trunc)
            Z[:, cols, l] = gains[l, cols][None, :, None] * wb[:, rows]
        return np.asarray(mm(Z.reshape(B * Lin, Lh * Nr),
                             np.conj(taps).T)).reshape(B, Lin * Nt)

    return (fwd(x, S, g), bwd(z, S, g), fwd(v, S2, g2).real,
            bwd(u, S2, g2).real)


@pytest.mark.parametrize("trunc", ["tail", "trunc", "cyclic"])
def test_operator_maps_high_match_dot3(trunc):
    cfg, op, *_ = shared_inputs(dict(alphabet="QPSK", trunc=trunc,
                                     iterations=8), 3, 1.5)
    rng = np.random.default_rng(7)
    B = 5
    x = (rng.standard_normal((B, cfg.N)) + 1j * rng.standard_normal(
        (B, cfg.N))).astype(np.complex64)
    z = (rng.standard_normal((B, cfg.n)) + 1j * rng.standard_normal(
        (B, cfg.n))).astype(np.complex64)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    v, u = tx.abs() ** 2, tz.abs() ** 2
    got = (op.apply(tx, "high"), op.apply_adj(tz, "high"),
           op.apply_abs2(v, "high"), op.apply_abs2T(u, "high"))
    # the same inputs to every form: a bf16 split is not continuous, so an
    # ulp of input may move a three-pass product by its whole error
    args = (x, z, v.numpy(), u.numpy())
    ref = _maps(op, *args, _jmm)
    scale = _maps(op, *(np.abs(a) for a in args),
                  lambda p, q: np.abs(p) @ np.abs(q))
    exact = _maps(op, *args, lambda p, q: p.astype(np.complex128) @ q)
    for g, r, s, e in zip(got, ref, scale, exact):
        g = g.numpy()
        assert float(np.max(np.abs(g - r) / np.abs(s))) < 1e-6
        # HIGH, not HIGHEST: the three-pass products differ from FP32's
        assert float(np.max(np.abs(g - e) / np.abs(s))) > 1e-7
    # HIGHEST is the tap-stack product as it was, bit for bit
    want = _maps(op, *args, lambda p, q: (torch.from_numpy(p)
                                          @ torch.from_numpy(q)).numpy())
    for g, w in zip((op.apply(tx), op.apply_adj(tz), op.apply_abs2(v),
                     op.apply_abs2T(u)), want):
        assert torch.equal(g, torch.from_numpy(w))


@pytest.mark.parametrize("name", ["ook_tail", "ook_trunc", "qpsk_tail"])
def test_gauss_taps_equal_jax_fold(name):
    """The port's Gauss tap planes are ``FusedBandedDecode._fold_taps``'s
    (folded gains: OOK and QPSK tail) or its unfolded planes with the
    combinations the kernel forms (trunc); |h|^2 comes from each
    framework's complex abs, which may differ in the last bit (two or
    three of |h|^2's, hence 5e-7 relative there)."""
    g = next(g for g in GEOMETRIES if g[0] == name)
    cfg, op, _, _, jcfg, jop, _ = shared_inputs(g[1], g[2], g[3])
    fused = jfb.FusedBandedDecode(jop, 16, interpret=True,
                                  symbols=jcfg.symbols, M=jcfg.M,
                                  precision=HIGH)
    t = bamp.gauss_taps(op)
    assert t.folded == fused.gains_folded == (cfg.trunc != "trunc")
    a = [np.asarray(x) for x in fused._tap_args]
    W = cfg.Lh * cfg.Nr
    if not t.folded:
        s_re, s_im, s_a2 = a[0], a[1], a[2]
        want = dict(s_re=s_re, dmc=s_im - s_re, cpd=s_re + s_im, s_a2=s_a2,
                    st_re=s_re.T, amc=-s_im.T - s_re.T, adm=s_re.T - s_im.T,
                    st_a2=s_a2.T)
    elif fused.real_x:
        wpad = -(-W // 128) * 128
        want = dict(s_re=a[0][:, :W], dmc=a[0][:, wpad:wpad + W], s_a2=a[2],
                    st_re=a[3], amc=a[4], st_a2=a[5], adm=a[7])
    else:
        want = dict(s_re=a[0], dmc=a[1], s_a2=a[2], st_re=a[3], amc=a[4],
                    st_a2=a[5], cpd=a[6], adm=a[7])
    for f, w in want.items():
        got = getattr(t, f).numpy()
        if f in ("s_a2", "st_a2"):
            np.testing.assert_allclose(got, w, rtol=5e-7, atol=0)
        else:
            np.testing.assert_array_equal(got, w, err_msg=f)


def _fragment_planes(buf: torch.Tensor, Mt: int, Kt: int):
    """The (2, Mt*16, Kt*16) hi and lo planes of an mma_tiles buffer, read
    through the kernel's fragment map: lane (g, t), register r, half h
    holds row g + 8 (r & 1), column 2t + 8 (r >> 1) + h."""
    f = buf.float().reshape(Mt, Kt, 32, 2, 8)
    out = torch.zeros(2, Mt * 16, Kt * 16)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r in range(4):
            for h in range(2):
                row, col = g + 8 * (r & 1), 2 * t + 8 * (r >> 1) + h
                out[:, row::16, col::16] = f[:, :, lane, :, 2 * r + h
                                             ].permute(2, 0, 1)
    return out


@pytest.mark.parametrize("name", ["qpsk_tail", "ook_m6", "ook_trunc"])
def test_kernel_taps_are_the_split_planes(name):
    """Each of the eight planes of ``high_taps`` is the bf16 split of its
    Gauss plane with the output along the rows, zero-padded to 16 x 16,
    read back through the kernel's fragment map; built once per
    operator."""
    g = next(g for g in GEOMETRIES if g[0] == name)
    cfg, op, *_ = shared_inputs(g[1], g[2], g[3])
    taps, folded = fused_bamp.high_taps(op)
    t = bamp.gauss_taps(op)
    assert folded == t.folded and taps.dtype == torch.bfloat16
    kx, kz = fused_bamp.padded16(cfg.Nt), fused_bamp.padded16(cfg.Lh * cfg.Nr)
    size = 2 * kx * kz
    assert taps.shape == (8 * size,)
    planes = (t.s_a2, t.s_re, t.dmc, t.cpd, t.st_a2, t.st_re, t.amc, t.adm)
    for q, p in enumerate(planes):
        A = p.T.contiguous()
        Mt, Kt = (kz // 16, kx // 16) if q < 4 else (kx // 16, kz // 16)
        back = _fragment_planes(taps[q * size:(q + 1) * size], Mt, Kt)
        hi, lo = prec.split_bf16(A)
        R, K = A.shape
        assert torch.equal(back[0, :R, :K], hi.float())
        assert torch.equal(back[1, :R, :K], lo.float())
        assert not bool(back[:, R:].any()) and not bool(back[:, :, K:].any())
    assert fused_bamp.high_taps(op)[0] is taps


def _mirror_iteration(op, cfg, s, y, sigma2):
    """One iteration of the CUDA source's HIGH passes (forward_high,
    fold_high with its zeroed slots, adjoint_high, the split writes of the
    denoiser and zero_x_pad), per trial, in NumPy: the tap fragments read
    through the fragment map, the split operands in one region with the
    kernel's row strides, column blocks past Lin read as row Lin - 1, each
    product hi hi + (hi lo + lo hi) in float64."""
    Lin, Lout, Lh, Nt, Nr = cfg.Lin, cfg.Lout, cfg.Lh, cfg.Nt, cfg.Nr
    W = Lh * Nr
    kx, kz = fused_bamp.padded16(Nt), fused_bamp.padded16(W)
    ldx, ldz = fused_bamp.split_ld(Nt), fused_bamp.split_ld(W)
    real_x = fused_bamp.real_x(cfg)
    nx = 2 if real_x else 4
    taps, folded = fused_bamp.high_taps(op)
    size = 2 * kx * kz
    A = [_fragment_planes(taps[q * size:(q + 1) * size],
                          *((kz // 16, kx // 16) if q < 4
                            else (kx // 16, kz // 16))).double().numpy()
         for q in range(8)]
    gains = op.gains.double().numpy()
    NT = -(-Lin // 8)

    def dst(c, l):
        return (c + l) % Lin if cfg.trunc == "cyclic" else (
            c + l if c + l < Lout else -1)

    def src(r, l):
        if cfg.trunc == "cyclic":
            return (r - l) % Lin
        return r - l if 0 <= r - l < Lin else -1

    def split(x):
        x = torch.tensor(np.float32(x))
        hi, lo = prec.split_bf16(x)
        return float(hi.float()), float(lo.float())

    B = y.shape[0]
    xmap = np.zeros((B, Lin * Nt), np.complex128)
    cov = np.zeros((B, Lin * Nt))
    zo = np.zeros((B, Lout * Nr), np.complex128)
    uo = np.zeros((B, Lout * Nr))
    for b in range(B):
        region = np.full(fused_bamp.high_split_elems(cfg), np.nan)

        def store(o, ld, off, x):
            region[2 * o * Lin * ld + off], \
                region[(2 * o + 1) * Lin * ld + off] = split(x)

        def x3(q, o, ld, K):
            cols = [min(n, Lin - 1) * ld for n in range(NT * 8)]
            h = np.stack([region[2 * o * Lin * ld + c:][:K] for c in cols], 1)
            lo = np.stack([region[(2 * o + 1) * Lin * ld + c:][:K]
                           for c in cols], 1)
            return A[q][0] @ h + (A[q][0] @ lo + A[q][1] @ h)

        xm, var = s.xmmse[b].numpy(), s.var[b].numpy()
        for j in range(Lin * Nt):
            off = (j // Nt) * ldx + j % Nt
            store(0, ldx, off, var[j])
            store(1, ldx, off, xm[j].real)
            if not real_x:
                store(2, ldx, off, np.float32(xm[j].real)
                      + np.float32(xm[j].imag))
                store(3, ldx, off, xm[j].imag)
        for c in range(Lin):
            for q in range(2 * nx):
                region[q * Lin * ldx + c * ldx + Nt:][:kx - Nt] = 0.0
        Pv, K1 = x3(0, 0, ldx, kx), x3(1, 1 if real_x else 2, ldx, kx)
        Pi = K1 + x3(2, 1, ldx, kx)
        Pr = K1 if real_x else K1 - x3(3, 3, ldx, kx)
        yb, z, u = y[b].numpy(), s.z[b].numpy(), s.u[b].numpy()
        for o in range(Lout * Nr):
            r, m = divmod(o, Nr)
            v = hr = hi = 0.0
            for l in range(Lh):
                c = src(r, l)
                if c < 0 or dst(c, l) < 0:
                    continue
                gn = 1.0 if folded else gains[l, c]
                j = l * Nr + m
                v += gn * gn * Pv[j, c]
                hr += gn * Pr[j, c]
                hi += gn * Pi[j, c]
            w = v / u[o]
            zr = hr - w * (yb[o].real - z[o].real)
            zi = hi - w * (yb[o].imag - z[o].imag)
            un = v + sigma2
            rr, ri = (yb[o].real - zr) / un, (yb[o].imag - zi) / un
            zo[b, o], uo[b, o] = zr + 1j * zi, un
            for l in range(Lh):
                c = src(r, l)
                if c < 0:
                    continue
                gn = 1.0 if folded else gains[l, c]
                off = c * ldz + l * Nr + m
                za, zb = gn * rr, gn * ri
                store(0, ldz, off, gn * gn / un)
                store(1, ldz, off, za + zb)
                store(2, ldz, off, za)
                store(3, ldz, off, zb)
        for c in range(Lin):
            for j in range(kz):
                if j >= W or dst(c, j // Nr) < 0:
                    for q in range(8):
                        region[q * Lin * ldz + c * ldz + j] = 0.0
        cs, k1 = x3(4, 0, ldz, kz), x3(5, 1, ldz, kz)
        k2, k3 = x3(6, 2, ldz, kz), x3(7, 3, ldz, kz)
        for j in range(Lin * Nt):
            c, k = divmod(j, Nt)
            cv = 1.0 / cs[k, c]
            im = cv * (k1[k, c] + k2[k, c])
            cov[b, j] = cv
            xmap[b, j] = (xm[j].real + cv * (k1[k, c] - k3[k, c])) + 1j * (
                im if real_x else xm[j].imag + im)
    return xmap, cov, zo, uo


@pytest.mark.parametrize("name", [g[0] for g in GEOMETRIES])
def test_kernel_maps_mirror_linear_step_high(name):
    g = next(g for g in GEOMETRIES if g[0] == name)
    cfg, op, y, s2, *_ = shared_inputs(g[1], g[2], g[3], batch=2)
    s2 = float(np.float32(s2))
    s = fused_bamp.decode_plain_high(
        op, bamp.initial_state(y, cfg.N, s2), y, s2, 2, cfg)
    want = bamp.linear_step_high(op, s.xmmse, s.var, s.z, s.u, y, s2,
                                 taps=bamp.gauss_taps(op),
                                 real_x=fused_bamp.real_x(cfg))
    got = _mirror_iteration(op, cfg, s, y, s2)
    for w, m in zip(want, got):
        w = w.numpy()
        assert float(np.abs(w - m).max() / np.abs(w).max()) < 1e-5


def _plain_high(op, y, s2, cfg, cap=None, state0=None):
    s0 = state0 if state0 is not None else bamp.initial_state(
        y, cfg.N, float(np.float32(s2)))
    return fused_bamp.decode_plain_high(
        op, s0, y, s2, cfg.N_Layers if cap is None else cap, cfg)


@pytest.mark.parametrize("name,kw,seed,snr_exp", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plain_high_matches_jax_kernel(name, kw, seed, snr_exp):
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(kw, seed, snr_exp)
    ref = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGH)
    before = bamp.plain_decodes
    st = _plain_high(op, y, s2, cfg)
    assert bamp.plain_decodes == before + 1
    np.testing.assert_array_equal(st.T.numpy(), np.asarray(ref.T))
    for f in ("xmap", "xmmse", "var"):
        d = np.abs(getattr(st, f).numpy() - np.asarray(getattr(ref, f)))
        row = d.reshape(d.shape[0], -1).max(axis=1)
        conv = ~st.active.numpy()
        assert float(row[conv].max(initial=0.0)) < 1e-4, f
        assert float(row.max()) < 1e-3, f
    # the HIGH form is the one that ran: it differs from HIGHEST
    hst = fused_bamp.decode_plain(op, bamp.initial_state(
        y, cfg.N, float(np.float32(s2))), y, s2, cfg.N_Layers, cfg)
    assert not torch.equal(hst.xmap, st.xmap)


def test_split_and_resume_high():
    """Split at 3 and resumed, the unsplit trajectory, through the wrapper
    and through ``bamp.decode``; and against the JAX kernel's resumed run
    at HIGH."""
    cfg, op, y, s2, jcfg, jop, jy = shared_inputs(GEOMETRIES[0][1], 0, 1.2)
    full = _plain_high(op, y, s2, cfg)
    part = _plain_high(op, y, s2, cfg, cap=3)
    assert part.t == 3
    resumed = _plain_high(op, y, s2, cfg, state0=part)
    for f in bamp.BAMPState._fields:
        a, b = getattr(full, f), getattr(resumed, f)
        assert (a == b) if f == "t" else torch.equal(a, b), f
    _, dfull = bamp.decode(op, y, s2, cfg, precision="high",
                           return_state=True)
    _, dpart = bamp.decode(op, y, s2, cfg, precision="high", iter_cap=3,
                           return_state=True)
    dres = bamp.decode(op, y, s2, cfg, precision="high", state0=dpart)
    assert torch.equal(dres.T, dfull.T) and torch.equal(dres.var, dfull.var)
    _, jst = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGH,
                          iter_cap=3, return_state=True)
    jres = jbamp.decode(jop, jy, s2, jcfg, use_pallas=True, precision=HIGH,
                        state0=jst)
    np.testing.assert_array_equal(resumed.T.numpy(), np.asarray(jres.T))
    assert float(np.abs(resumed.var.numpy() - np.asarray(jres.var)).max()) \
        < 1e-4


def test_wrapper_high_on_cpu_is_plain_high():
    """On CPU tensors the wrapper at 'high' is the plain HIGH loop and
    launches nothing; at 'default' it is the plain DEFAULT loop (one bf16
    pass) and launches nothing; unknown precisions raise."""
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[3][1], 0, 1.5)
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    before = (fused_bamp.launches, fused_bamp.launches_high)
    got = fused_bamp.whole_decode(op, s0, y, s2, cfg.N_Layers, cfg, "high")
    want = bamp.plain_loop_high(op, s0, y, s2, cfg.N_Layers, cfg)
    assert (fused_bamp.launches, fused_bamp.launches_high) == before
    for f in bamp.BAMPState._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a == b) if f == "t" else torch.equal(a, b), f
    before = (fused_bamp.launches, fused_bamp.launches_high,
              fused_bamp.launches_default)
    one = fused_bamp.whole_decode(op, s0, y, s2, cfg.N_Layers, cfg,
                                  "default")
    ref = bamp.plain_loop_high(op, s0, y, s2, cfg.N_Layers, cfg,
                               dot=prec.dot1)
    assert (fused_bamp.launches, fused_bamp.launches_high,
            fused_bamp.launches_default) == before
    for f in bamp.BAMPState._fields:
        a, b = getattr(one, f), getattr(ref, f)
        assert (a == b) if f == "t" else torch.equal(a, b), f
    assert not torch.equal(one.xmap, got.xmap)
    with pytest.raises(ValueError):
        fused_bamp.whole_decode(op, s0, y, s2, 4, cfg, "low")
    with pytest.raises(ValueError):
        bamp.decode(op, y, s2, cfg, precision="low")


def test_smem_and_fit_of_the_high_form():
    """The HIGH carve-out: the FP32 planes of the HIGHEST form, then one
    region for the split operands (the forward's and the adjoint's in
    turn); the flagships fit (two OOK blocks or one QPSK block per SM); a
    trial of more than 32 column blocks fits where its planes do."""
    from amp_sparc_spatialmodulation_tpu_torch.config import (
        flagship_bamp_ook, flagship_bamp_qpsk, massive_mimo)
    ook, qpsk = flagship_bamp_ook(), flagship_bamp_qpsk()
    assert fused_bamp.smem_bytes(ook, "high") == 68800 + 2 * max(
        2 * 2 * 20 * 136, 8 * 20 * 88) == 96960
    assert fused_bamp.smem_bytes(qpsk, "high") == 140800 + 2 * max(
        2 * 4 * 25 * 136, 8 * 25 * 200) == 220800
    assert fused_bamp.smem_bytes(qpsk) == 140800
    assert fused_bamp.fits(ook, "high") and fused_bamp.fits(qpsk, "high")
    assert 2 * fused_bamp.smem_bytes(ook, "high") <= fused_bamp.SMEM_LIMIT
    assert not fused_bamp.fits(massive_mimo(), "high")
    assert fused_bamp.fits(Config(**dict(SMALL, Lin=40)), "high")
    assert fused_bamp.fits(Config(**dict(SMALL, Lin=40)))
    assert not fused_bamp.fits(Config(**dict(SMALL, Lin=40, Nt=256)), "high")
    assert fused_bamp.smem_bytes(Config(**dict(SMALL, Lin=40, Nt=256)),
                                 "high") > fused_bamp.SMEM_LIMIT


def test_routes_at_high(monkeypatch):
    """K1 runs its HIGH form; K6 (``AMP_PALLAS_MODE=periter``) runs at
    HIGHEST, as JAX's has no precision; a dense operator runs the plain
    loop at HIGH (the JAX decoder's XLA body, not K1's HIGH form)."""
    cfg, op, y, s2, *_ = shared_inputs(GEOMETRIES[0][1], 0, 1.2)
    high = bamp.decode(op, y, s2, cfg, precision="high")
    want = _plain_high(op, y, s2, cfg)
    assert torch.equal(high.T, want.T) and torch.equal(high.xmap, want.xmap)
    monkeypatch.setenv("AMP_PALLAS_MODE", "periter")
    assert bamp.route(cfg, op, 16, "cpu") == "periter"
    periter = bamp.decode(op, y, s2, cfg, precision="high")
    highest = bamp.decode(op, y, s2, cfg)
    assert torch.equal(periter.xmap, highest.xmap)
    assert torch.equal(periter.T, highest.T)
    monkeypatch.delenv("AMP_PALLAS_MODE")
    dense = op.densify()
    got = bamp.decode(dense, y, s2, cfg, precision="high")
    s0 = bamp.initial_state(y, cfg.N, float(np.float32(s2)))
    plain = bamp.plain_loop(operators.as_operator(dense), s0, y, s2,
                            cfg.N_Layers, cfg, "high")
    assert torch.equal(got.T, plain.T) and torch.equal(got.xmap, plain.xmap)
    assert not torch.equal(got.xmap, bamp.decode(dense, y, s2, cfg).xmap)
    assert not torch.equal(got.xmap, want.xmap)


def _manual_sums(cfg, algo, res, snr, seed, precision, decode_precision):
    """One realization's metric sums composed by hand: generated at
    ``precision``, decoded at ``decode_precision``."""
    gen = make_generator(torch.device("cpu"), seed, 0, 0)
    r = montecarlo.generate_realization(gen, cfg, "sparc", "banded", res,
                                        snr, precision)
    out = montecarlo.decode(algo, r, r.y, cfg, precision=decode_precision)
    return metrics.finalize(metrics.evaluate_sums(
        out.xmap, out.xmmse, r.msg, out.T, cfg), cfg)


@pytest.mark.parametrize("algo", ["bamp", "scamp"])
def test_simulator_high_and_auto(tmp_path, algo):
    """'high' generates at HIGH and decodes through K1's HIGH form (BAMP)
    or K2 at HIGHEST (SCAMP, whose JAX kernel has no precision); 'auto'
    takes HIGH exactly after a cap-pinned point."""
    cfg = Config(**dict(SMALL, mode="sparc" if algo == "scamp"
                        else "segmented", iterations=8))
    kw = dict(algo=algo, device="cpu", progress=lambda s: None,
              out_root=str(tmp_path), seed=4)
    ebn0, res = 5.0, 64
    snr = 10 ** ((ebn0 + 10 * np.log10(cfg.code_rate)) / 10)
    high = montecarlo.Simulator(cfg, precision="high", **kw).run_point(
        ebn0, epochs=res, res=res)
    assert high == _manual_sums(cfg, algo, res, snr, 4, "high", "high")
    highest = montecarlo.Simulator(cfg, **kw).run_point(ebn0, epochs=res,
                                                        res=res)
    assert high != highest
    if algo == "scamp":
        # only the generation differs
        assert high == _manual_sums(cfg, algo, res, snr, 4, "high",
                                    "highest")
    auto = montecarlo.Simulator(cfg, precision="auto", **kw)
    assert auto.run_point(ebn0, epochs=res, res=res) == highest
    auto._last_meanT = float(cfg.N_Layers)
    assert auto.run_point(ebn0, epochs=res, res=res) == high


def test_cli_sweep_bamp_scamp_high(tmp_path, monkeypatch):
    for algo, mode in (("bamp", "segmented"), ("scamp", "sparc")):
        rc = cli.main(["sweep", "--algo", algo, "--mode", mode, "--Nt",
                       "16", "--Na", "4", "--Nr", "8", "--Lin", "8", "--Lh",
                       "3", "--iterations", "10", "--epochs", "32", "--res",
                       "32", "--start", "7", "--final", "7", "--precision",
                       "high", "--device", "cpu", "--out", str(tmp_path)])
        assert rc == 0
        cfg = Config(**dict(SMALL, mode=mode, iterations=10))
        with open(os.path.join(str(tmp_path), algo.upper(), cfg.name,
                               "7.0.json")) as f:
            point = json.load(f)
        assert point["EbN0dB"] == 7.0 and 1.0 <= point["T"] <= 10.0
    # the massive geometry (the frame-tiled route, K5's HIGH form): the
    # sweep is built at 'auto' (its sweep is not run at this width here)
    built = []
    monkeypatch.setattr(montecarlo.Simulator, "simulate",
                        lambda self, **kw: built.append(self) or {})
    assert cli.main(["sweep", "--algo", "bamp", "--Nt", "1344", "--Na",
                     "84", "--Nr", "73", "--Lin", "32", "--Lh", "6",
                     "--precision", "auto", "--device", "cpu", "--out",
                     str(tmp_path)]) == 0
    (sim,) = built
    assert sim._precision_auto and sim.cfg.Nt == 1344
    sim._last_meanT = float(sim.cfg.N_Layers)
    assert sim._effective_precision() == "high"


def test_high_decode_raises_on_scamp_plain_loop():
    """A dense operator takes SCAMP's plain loop, which at HIGH runs its
    products at HIGH (held to JAX's XLA decode at HIGH in
    tests/test_torch_plain_high.py) and differs from HIGHEST."""
    cfg = Config(**dict(SMALL, mode="sparc"))
    gen = make_generator(torch.device("cpu"), 1)
    r = montecarlo.generate_realization(gen, cfg, "sparc", "dense", 8, 10.0)
    before = scamp.plain_decodes
    got = scamp.decode(r.W, r.A, r.y, r.sigma2, cfg, precision="high")
    assert scamp.plain_decodes == before + 1
    s0 = scamp.initial_state(r.y, cfg)
    want = scamp.plain_loop(operators.as_operator(r.A), torch.as_tensor(
        r.W, dtype=torch.float32), s0, r.y, r.sigma2, cfg.N_Layers, cfg,
        precision="high")
    assert torch.equal(got.T, want.T) and torch.equal(got.xmap, want.xmap)
    highest = scamp.decode(r.W, r.A, r.y, r.sigma2, cfg)
    assert not torch.equal(got.xmap, highest.xmap)
    assert fused_scamp.covers(cfg) and fused_scamp.fits(cfg)
    assert isinstance(operators.as_operator(r.A), operators.DenseOperator)


@pytest.mark.cuda
def test_high_kernel_matches_plain_on_card():
    """K1's HIGH instance against its plain HIGH version on the card, at
    the small QPSK geometry (chip_smoke.py's HIGH rule, 256 trials)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke
    cfg = Config(**dict(SMALL, alphabet="QPSK", iterations=8))
    gen = make_generator(torch.device("cuda"), 3)
    r = montecarlo.generate_realization(gen, cfg, "sparc", "banded", 256,
                                        10 ** 1.5, "high")
    op = r.A
    s0 = bamp.initial_state(r.y, cfg.N, r.sigma2)
    before = fused_bamp.launches_high
    sk = fused_bamp.whole_decode(op, s0, r.y, r.sigma2, 8, cfg, "high")
    sp = fused_bamp.decode_plain_high(op, s0, r.y, r.sigma2, 8, cfg)
    assert fused_bamp.launches_high == before + 1
    rule = chip_smoke.BAMP_HIGH_SMALL_RULE
    chip_smoke.compare("test_bamp_high", sk, sp, 1e-4,
                       free_unconverged=True,
                       min_agree=rule["min_agree"],
                       max_dmean_T=rule["dmean_T_of_cap"] * 8)
