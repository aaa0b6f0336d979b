"""The float32 ``sin`` and ``cos`` that the reference's compiled code takes.

XLA's CPU back end calls the C library for a float32 sine or cosine, and
on x86-64 Linux that is glibc's ``sinf`` / ``cosf`` (its FMA build). Those
are not correctly rounded: they differ from the correctly rounded value on
~1.3 % of arguments, and PyTorch's own float32 kernels differ from them on
~5 %. Where one ulp of a sine moves the result (a cloud-hash corner, a
sampled direction that a grazing bounce amplifies), the port takes this
copy of glibc's algorithm instead: the argument reduced by pi/2 (by a
multiply-subtract below 120, else by glibc's integer multiply against its
4/pi table), a polynomial in float64 with glibc's coefficients and its
fused multiply-adds, rounded once to float32. Every step is IEEE float64 or
integer arithmetic, so the card and the CPU give the same bits, and they
equal glibc's on every finite argument (``tests/test_torch_rounding.py``
holds them against the C library of the machine that runs the tests). On
the card one kernel does it (``csrc/libm_sincos.cu``, :func:`libm_sincos`),
with :func:`glibc_exact` as its plain version; on the CPU the float64
``sin`` decides all but the arguments near a rounding boundary
(:func:`_screened`).
"""

from __future__ import annotations


import torch

F64 = torch.float64

# glibc's __sincosf_table: cos and sin coefficients, the second row for the
# quadrants whose cosine is negated (c0, c1, s1, c2, s2, c3, s3, c4)
_TABLES = (
    ("0x1p0", "-0x1.ffffffd0c621cp-2", "-0x1.555545995a603p-3",
     "0x1.55553e1068f19p-5", "0x1.1107605230bc4p-7", "-0x1.6c087e89a359dp-10",
     "-0x1.994eb3774cf24p-13", "0x1.99343027bf8c3p-16"),
    ("-0x1p0", "0x1.ffffffd0c621cp-2", "-0x1.555545995a603p-3",
     "-0x1.55553e1068f19p-5", "0x1.1107605230bc4p-7", "0x1.6c087e89a359dp-10",
     "-0x1.994eb3774cf24p-13", "-0x1.99343027bf8c3p-16"),
)
_COEF = tuple(float.fromhex(v) for v in _TABLES[0])
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2 / pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")  # pi / 2
_PI63 = float.fromhex("0x1.921fb54442d18p-62")
_HPI_HI = float.fromhex("0x1.921fb544p+0")  # pi / 2 to 30 bits: n _HPI_HI is exact
_HPI_LO = _HPI - _HPI_HI
# 4 / pi in a sliding window of 32-bit words (glibc's __inv_pio4)
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
)


def _split(a):
    """Dekker's split of a float64 into two halves of 26 bits each."""
    big = a * 134217729.0
    ah = big - (big - a)
    return ah, a - ah


def _fma64(a, b, c):
    """The float64 ``a * b + c`` of a hardware fused multiply-add: the
    product split exactly (Dekker), the sums with their errors (TwoSum).
    ``b`` may be a Python float (a coefficient, split once here)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    v = s - p
    return s + (((p - (s - v)) + (c - v)) + e)


def _sin_poly(x, x2):
    """glibc's sinf_poly for the sine: fma(x^5, fma(x2, s3, s2),
    fma(x^3, s1, x)), x signed."""
    _, _, s1, _, s2, _, s3, _ = _COEF
    x3 = x * x2
    return _fma64(x3 * x2, _fma64(x2, s3, s2), _fma64(x3, s1, x))


def _cos_poly(x2):
    """glibc's sinf_poly for the cosine: fma(x^6, fma(x2, c4, c3),
    fma(x^4, c2, fma(x2, c1, c0)))."""
    c0, c1, _, c2, _, c3, _, c4 = _COEF
    x4 = x2 * x2
    return _fma64(x4 * x2, _fma64(x2, c4, c3), _fma64(x4, c2, _fma64(x2, c1, c0)))


_TABS: dict = {}


def _reduce_large(y: torch.Tensor):
    """glibc's reduce_large: y mod pi/2 from the bits of 4/pi → (x, n)."""
    xi = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    tab = _TABS.get(y.device)
    if tab is None:
        tab = _TABS[y.device] = torch.tensor(_INV_PIO4, dtype=torch.int64,
                                             device=y.device)
    k = (xi >> 26) & 15
    m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)
    res0 = (m * tab[k]) & 0xFFFFFFFF
    # 64-bit unsigned arithmetic in int64: the shifts and sums wrap alike
    res0 = ((m * tab[k + 8]) >> 32) | (res0 << 32)
    res0 = res0 + m * tab[k + 4]
    n = ((res0 + (1 << 61)) >> 62) & 3
    return (res0 - (n << 62)).to(F64) * _PI63, n


def _reduce(y: torch.Tensor, large: torch.Tensor):
    """glibc's argument reduction → (x in [-pi/4, pi/4] before its sign,
    the quadrant n that picks sine or cosine, the quadrant q that picks the
    sign and the table). ``large`` (|y| >= 120) takes glibc's integer
    reduction, the rest its multiply-subtract."""
    x = y.to(F64)
    # below 120: n = round(x 2 / pi) by glibc's scaled conversion, and
    # fma(-n, pi/2, x) with pi/2 split so that x - n _HPI_HI is exact and
    # the one rounding is the fused multiply-add's (below 0.75 glibc does
    # not reduce, which is the same as n = 0 here)
    r = torch.where(large, 0.0, x * _HPI_INV)
    n = ((r.to(torch.int32) + 0x800000) >> 24).to(torch.int64)
    nf = n.to(F64)
    xr = (x - nf * _HPI_HI) - nf * _HPI_LO
    if bool(large.any()):
        xl, nl = _reduce_large(y)
        xr = torch.where(large, xl, xr)
        # a large negative argument counts its sign in (glibc's n + sign)
        return xr, torch.where(large, nl, n), torch.where(
            large, nl + (y < 0).to(torch.int64), n)
    return xr, n, n


def _finish(y, e, want_cos):
    """glibc's special cases: the tiny argument and the non-finite ones."""
    tiny = torch.ones_like(y) if want_cos else y
    out = torch.where(torch.abs(y) < 2.0 ** -12, tiny, e)
    return torch.where(torch.isfinite(y), out, torch.full_like(y, float("nan")))


def glibc_exact(y: torch.Tensor, want_cos: bool) -> torch.Tensor:
    """glibc's sinf (or cosf) of every element of a flat float32 tensor,
    its fused multiply-adds computed exactly (:func:`_fma64`). The plain
    version of ``csrc/libm_sincos.cu``."""
    large = torch.abs(y) >= 120.0
    xr, n, q = _reduce(y, large)
    odd = ((n ^ int(want_cos)) & 1) == 1
    flip = ((q + 1) & 2) != 0  # quadrants 1 and 2: the argument negated
    neg = (q & 2) != 0  # the second table: the cosine negated
    x2 = xr * xr
    e = torch.empty_like(xr)
    i = torch.nonzero(~odd).flatten()
    e[i] = _sin_poly(torch.where(flip[i], -xr[i], xr[i]), x2[i])
    i = torch.nonzero(odd).flatten()
    c = _cos_poly(x2[i])
    e[i] = torch.where(neg[i], -c, c)
    return _finish(y, e.to(torch.float32), want_cos)


def _screened(y: torch.Tensor, want_cos: bool) -> torch.Tensor:
    """glibc's sinf (or cosf) on the CPU. glibc's float64 result lies within
    0.06 float32 ulps of the true value (its documented 0.56-ulp bound: at
    most 7.2e-9 relative; 4.0e-9 measured), so the float64 sine rounds to
    the same float32 except within that much of a rounding boundary: only
    arguments within 2^-27 (7.5e-9) of one, ~20 %, take
    :func:`glibc_exact`."""
    d = (torch.cos if want_cos else torch.sin)(y.to(F64))
    out = d.to(torch.float32)
    near = (((d * (1.0 + 2.0 ** -27)).to(torch.float32) != out)
            | ((d * (1.0 - 2.0 ** -27)).to(torch.float32) != out)
            | (torch.abs(y) < 2.0 ** -12) | ~torch.isfinite(y))
    ix = torch.nonzero(near).flatten()
    if ix.numel():
        out[ix] = glibc_exact(y[ix], want_cos)
    return out


def _sincos(y: torch.Tensor, want_cos: bool) -> torch.Tensor:
    shape, y = y.shape, y.reshape(-1)
    if y.device.type == "cuda":
        return glibc_exact(y, want_cos).view(shape)
    return _screened(y, want_cos).view(shape)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``sinf`` of a float32 tensor, bit for bit."""
    return _sincos(y, False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``cosf`` of a float32 tensor, bit for bit."""
    return _sincos(y, True)
