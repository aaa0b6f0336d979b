"""Spectral rendering support (port of ``luminary_tpu/ops/spectral.py``):
CIE sampling, RGB uplift, hero wavelengths, the sRGB resolve, Cauchy
dispersion and the 8-band sky spectra.

Hero wavelengths with C = 3 rotations ride the integrator's RGB channel
slots; each sample ends with one per-lane spectral → sRGB resolve. The CIE
curves are the Wyman et al. 2013 multi-lobe Gaussian fits, and wavelengths
are drawn by the luminance-favouring (x̄ + ȳ + z̄) CDF, inverted into a
256-entry table at import (numpy, the reference's code, so every table is
bit-equal). The uplift is a round-trip-corrected 3-bump partition of unity:
white uplifts to a flat 1 and resolves back to RGB (1, 1, 1).

Band-valued inputs are band-major here: ``sample_spectrum_bands`` takes
``[8, N]`` (or ``[8]``) where the reference takes ``[N, 8]``, because the
port's env rows arrive planar from kernel A.
"""

from __future__ import annotations

import numpy as np
import torch

from .vec import rdiv, sdiv

LAMBDA_MIN = 380.0
LAMBDA_MAX = 720.0
_C = 3  # hero rotations = the integrator's channel count

# the 8 sky bands' centre wavelengths (nm)
SKY_BANDS = np.linspace(400.0, 700.0, 8).astype(np.float32)


def _gauss(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_np(lam: np.ndarray):
    """CIE 1931 2° observer, Wyman et al. 2013 multi-lobe Gaussian fits."""
    lam = np.asarray(lam, np.float64)
    x = (_gauss(lam, 1.056, 599.8, 37.9, 31.0)
         + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
         + _gauss(lam, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss(lam, 0.821, 568.8, 46.9, 40.5)
         + _gauss(lam, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss(lam, 1.217, 437.0, 11.8, 36.0)
         + _gauss(lam, 0.681, 459.0, 26.0, 13.8))
    return x, y, z


def _gauss_t(x, alpha, mu, s1, s2):
    s = torch.where(x < mu, s1, s2)
    q = (x - mu) / s
    return alpha * torch.exp(-0.5 * (q * q))


def cie_xyz(lam: torch.Tensor):
    """cie_xyz_np on float32 lanes."""
    x = (_gauss_t(lam, 1.056, 599.8, 37.9, 31.0)
         + _gauss_t(lam, 0.362, 442.0, 16.0, 26.7)
         + _gauss_t(lam, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss_t(lam, 0.821, 568.8, 46.9, 40.5)
         + _gauss_t(lam, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss_t(lam, 1.217, 437.0, 11.8, 36.0)
         + _gauss_t(lam, 0.681, 459.0, 26.0, 13.8))
    return x, y, z


# ---- wavelength sampling: p(λ) ∝ x̄ + ȳ + z̄, an inverted CDF table ----
_N_CDF = 256
_lam_grid = np.linspace(LAMBDA_MIN, LAMBDA_MAX, _N_CDF)
_xg, _yg, _zg = cie_xyz_np(_lam_grid)
_wg = np.maximum(_xg + _yg + _zg, 1e-6)
_cdf = np.concatenate([[0.0], np.cumsum(_wg[:-1] + _wg[1:])])
_cdf /= _cdf[-1]
# inverse CDF: λ at 256 uniform u values
_INV_CDF = np.interp(np.linspace(0.0, 1.0, _N_CDF), _cdf, _lam_grid).astype(
    np.float32)
_trapz = getattr(np, "trapezoid", None) or np.trapz
_W_INT = float(_trapz(_wg, _lam_grid))  # pdf normalisation: ∫ w dλ
# equal-energy white correction: a flat spectrum must resolve to RGB 1
_XYZ_FLAT = np.asarray([
    _trapz(_xg, _lam_grid),
    _trapz(_yg, _lam_grid),
    _trapz(_zg, _lam_grid),
])
_XYZ2SRGB = np.asarray([
    [3.2406, -1.5372, -0.4986],
    [-0.9689, 1.8758, 0.0415],
    [0.0557, -0.2040, 1.0570],
])
_D65_XYZ = np.asarray([0.95047, 1.0, 1.08883])
_M_RESOLVE = (_XYZ2SRGB @ np.diag(_D65_XYZ / _XYZ_FLAT)).astype(np.float32)


def wavelength_pdf(lam: torch.Tensor) -> torch.Tensor:
    """p(λ) of the CIE-importance sampler (per nm)."""
    x, y, z = cie_xyz(lam)
    return sdiv(x + y + z, _W_INT)


def sample_hero_wavelengths(u: torch.Tensor):
    """u in [0, 1) [N] → three rotated wavelengths (hero first) and their
    pdfs. The rotations happen in CDF space, so every slot is identically
    CIE-distributed."""
    inv = torch.as_tensor(_INV_CDF, device=u.device)
    lams, pdfs = [], []
    for j in range(_C):
        uj = torch.remainder(u + j / _C, 1.0)
        f = uj * (_N_CDF - 1)
        i0 = torch.clamp(f.to(torch.int32), 0, _N_CDF - 2).long()
        w = f - i0.to(torch.float32)
        lam = inv[i0] * (1.0 - w) + inv[i0 + 1] * w
        lams.append(lam)
        pdfs.append(wavelength_pdf(lam))
    return tuple(lams), tuple(pdfs)


def _basis_np(lam):
    lam = np.asarray(lam, np.float64)
    wr = np.exp(-0.5 * ((lam - 612.0) / 58.0) ** 2) + 0.22 * (lam > 690.0)
    wg = np.exp(-0.5 * ((lam - 549.0) / 45.0) ** 2)
    wb = np.exp(-0.5 * ((lam - 465.0) / 42.0) ** 2) + 0.22 * (lam < 405.0)
    tot = np.maximum(wr + wg + wb, 1e-9)
    return wr / tot, wg / tot, wb / tot


def _roundtrip_matrix():
    """T[c, i] = RGB channel c resolved from the normalised basis i under
    CIE-importance integration, inverted so that uplift → resolve returns
    RGB colours instead of desaturating them."""
    br, bg, bb = _basis_np(_lam_grid)
    m = _M_RESOLVE
    xyz = np.stack([_xg, _yg, _zg])          # [3, L]
    resp = m @ xyz                           # [3 rgb, L]
    t = np.stack([
        [_trapz(resp[c] * basis, _lam_grid) for basis in (br, bg, bb)]
        for c in range(3)
    ])
    return np.linalg.inv(t)


_UPLIFT_CORR = _roundtrip_matrix().astype(np.float32)
# the float32 matrices as host floats (exact), for lane arithmetic
_CORR = [[float(v) for v in row] for row in _UPLIFT_CORR]
_RES = [[float(v) for v in row] for row in _M_RESOLVE]


def _bump(lam, mu, s):
    q = sdiv(lam - mu, s)
    return torch.exp(-0.5 * (q * q))


def uplift(r, g, b, lam: torch.Tensor) -> torch.Tensor:
    """RGB → spectral reflectance at λ: the round-trip-corrected 3-bump
    partition of unity (white → flat 1; negative lobes clamped)."""
    c = _CORR
    r2 = c[0][0] * r + c[0][1] * g + c[0][2] * b
    g2 = c[1][0] * r + c[1][1] * g + c[1][2] * b
    b2 = c[2][0] * r + c[2][1] * g + c[2][2] * b
    wr = _bump(lam, 612.0, 58.0) + 0.22 * (lam > 690.0).to(torch.float32)
    wg = _bump(lam, 549.0, 45.0)
    wb = _bump(lam, 465.0, 42.0) + 0.22 * (lam < 405.0).to(torch.float32)
    tot = torch.clamp(wr + wg + wb, min=1e-9)
    return torch.clamp((r2 * wr + g2 * wg + b2 * wb) / tot, min=0.0)


def resolve_to_rgb(l0, l1, l2, lam3, pdf3):
    """Per-lane spectral radiance (three hero slots) → linear sRGB:
    L_rgb = Σ_j M (x̄ ȳ z̄)(λ_j) L_j / (C p(λ_j)), M folding the XYZ → sRGB
    matrix and the equal-energy white normalisation."""
    m = _RES
    out_r = out_g = out_b = None
    for lj, lamj, pj in zip((l0, l1, l2), lam3, pdf3):
        x, y, z = cie_xyz(lamj)
        s = lj / (_C * torch.clamp(pj, min=1e-9))
        cr = (m[0][0] * x + m[0][1] * y + m[0][2] * z) * s
        cg = (m[1][0] * x + m[1][1] * y + m[1][2] * z) * s
        cb = (m[2][0] * x + m[2][1] * y + m[2][2] * z) * s
        if out_r is None:
            out_r, out_g, out_b = cr, cg, cb
        else:
            out_r, out_g, out_b = out_r + cr, out_g + cg, out_b + cb
    return out_r, out_g, out_b


_CAUCHY_DEN = 1.0 / 0.48613**2 - 1.0 / 0.65627**2
_INV_LD2 = 1.0 / 0.5876**2


def cauchy_ior(n_d, lam: torch.Tensor, abbe):
    """Dispersive IOR n(λ) from the d-line index and the Abbe number
    (abbe <= 0: no dispersion)."""
    q = lam * 1e-3
    lam_um2 = q * q
    b = torch.where(
        abbe > 0.0,
        sdiv((n_d - 1.0) / torch.clamp(abbe, min=1e-3), _CAUCHY_DEN),
        0.0)
    return n_d + b * (rdiv(1.0, lam_um2) - _INV_LD2)


_BAND_SPAN = float(SKY_BANDS[-1] - SKY_BANDS[0])


def sample_spectrum_bands(bands: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of an 8-band spectrum at λ. ``bands`` is
    band-major: ``[8, N]`` (one spectrum per lane) or ``[8]`` (one for
    all lanes)."""
    t = sdiv(lam - float(SKY_BANDS[0]), _BAND_SPAN) * 7.0
    t = torch.clamp(t, 0.0, 7.0 - 1e-4)
    i0 = t.to(torch.int32).long()
    w = t - i0.to(torch.float32)
    if bands.dim() == 1:
        b0, b1 = bands[i0], bands[i0 + 1]
    else:
        b0 = bands.gather(0, i0[None])[0]
        b1 = bands.gather(0, (i0 + 1)[None])[0]
    return b0 * (1.0 - w) + b1 * w


# ---- 8-band physical spectra for the sky bake ----
def rayleigh_beta_bands() -> np.ndarray:
    """β_rayleigh(λ) per band (km^-1), λ^-4 anchored to the RGB constant at
    440 nm."""
    return (33.1e-3 * (440.0 / SKY_BANDS) ** 4).astype(np.float32)


def ozone_beta_bands() -> np.ndarray:
    """Chappuis-band ozone absorption (km^-1), a Gaussian fit peaking near
    600 nm."""
    return (2.0e-3 * np.exp(-0.5 * ((SKY_BANDS - 594.0) / 55.0) ** 2)
            ).astype(np.float32)


def sun_irradiance_bands() -> np.ndarray:
    """Relative solar spectral irradiance per band: a 5778 K blackbody
    shape, normalised to a mean of 1."""
    lam_m = SKY_BANDS * 1e-9
    h, c, kb, t = 6.626e-34, 2.998e8, 1.381e-23, 5778.0
    planck = 1.0 / (lam_m**5 * (np.exp(h * c / (lam_m * kb * t)) - 1.0))
    return (planck / planck.mean()).astype(np.float32)
