"""BLS12-381 curve groups G1 (over Fq) and G2 (over Fq2).

Jacobian-coordinate arithmetic plus the ZCash compressed serialization used
by the consensus spec (48-byte G1 / 96-byte G2 with compression, infinity
and sign flags in the top three bits).  From scratch; capability counterpart
of the reference's py_arkworks/milagro bindings (SURVEY.md §2.2).

Both groups share one generic Jacobian implementation; Fq is adapted to the
Fq2-style interface by the Fq1 wrapper.
"""
from __future__ import annotations

from .fields import Q, R, Fq2, fq_inv, fq_sqrt


class Fq1:
    """Adapter giving plain-int Fq elements the extension-field interface."""
    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % Q

    @staticmethod
    def zero():
        return Fq1(0)

    @staticmethod
    def one():
        return Fq1(1)

    def is_zero(self):
        return self.v == 0

    def __eq__(self, o):
        return isinstance(o, Fq1) and self.v == o.v

    def __hash__(self):
        return hash(self.v)

    def __add__(self, o):
        return Fq1(self.v + o.v)

    def __sub__(self, o):
        return Fq1(self.v - o.v)

    def __neg__(self):
        return Fq1(-self.v)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq1(self.v * o)
        return Fq1(self.v * o.v)

    __rmul__ = __mul__

    def square(self):
        return Fq1(self.v * self.v)

    def inv(self):
        return Fq1(fq_inv(self.v))

    def sqrt(self):
        s = fq_sqrt(self.v)
        return None if s is None else Fq1(s)

    def __repr__(self):
        return f"Fq1(0x{self.v:x})"


# curve constants:  E1: y^2 = x^3 + 4      over Fq
#                   E2: y^2 = x^3 + 4(u+1) over Fq2
B1 = Fq1(4)
B2 = Fq2(4, 4)

# generators (standard BLS12-381 generators)
G1_X = Fq1(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB)
G1_Y = Fq1(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)
G2_X = Fq2(0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
           0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
G2_Y = Fq2(0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
           0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)


class Point:
    """Jacobian point on y^2 = x^3 + b; infinity is Z == 0."""
    __slots__ = ("x", "y", "z", "b")

    def __init__(self, x, y, z, b):
        self.x = x
        self.y = y
        self.z = z
        self.b = b

    @staticmethod
    def infinity(b):
        f = type(b)
        return Point(f.one(), f.one(), f.zero(), b)

    def is_infinity(self) -> bool:
        return self.z.is_zero()

    def affine(self):
        """Return (x, y) field elements, or None for infinity."""
        if self.is_infinity():
            return None
        zinv = self.z.inv()
        zinv2 = zinv.square()
        return (self.x * zinv2, self.y * zinv2 * zinv)

    def on_curve(self) -> bool:
        if self.is_infinity():
            return True
        x, y = self.affine()
        return y.square() == x.square() * x + self.b

    def __eq__(self, o) -> bool:
        if not isinstance(o, Point):
            return NotImplemented
        if self.is_infinity() or o.is_infinity():
            return self.is_infinity() and o.is_infinity()
        # cross-multiplied comparison avoids inversions
        z1s, z2s = self.z.square(), o.z.square()
        if self.x * z2s != o.x * z1s:
            return False
        return self.y * z2s * o.z == o.y * z1s * self.z

    def double(self) -> "Point":
        if self.is_infinity() or self.y.is_zero():
            return Point.infinity(self.b)
        x, y, z = self.x, self.y, self.z
        a = x.square()
        bb = y.square()
        c = bb.square()
        d = (x + bb).square() - a - c
        d = d + d
        e = a + a + a
        f = e.square()
        x3 = f - d - d
        y3 = e * (d - x3) - (c + c + c + c + c + c + c + c)
        z3 = (y * z)
        z3 = z3 + z3
        return Point(x3, y3, z3, self.b)

    def __add__(self, o: "Point") -> "Point":
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        z1z1 = self.z.square()
        z2z2 = o.z.square()
        u1 = self.x * z2z2
        u2 = o.x * z1z1
        s1 = self.y * o.z * z2z2
        s2 = o.y * self.z * z1z1
        if u1 == u2:
            if s1 == s2:
                return self.double()
            return Point.infinity(self.b)
        h = u2 - u1
        rr = s2 - s1
        h2 = h.square()
        h3 = h * h2
        u1h2 = u1 * h2
        x3 = rr.square() - h3 - u1h2 - u1h2
        y3 = rr * (u1h2 - x3) - s1 * h3
        z3 = self.z * o.z * h
        return Point(x3, y3, z3, self.b)

    def __neg__(self) -> "Point":
        return Point(self.x, -self.y, self.z, self.b)

    def __sub__(self, o: "Point") -> "Point":
        return self + (-o)

    def __mul__(self, k: int) -> "Point":
        k = int(k)
        if k < 0:
            return (-self) * (-k)
        result = Point.infinity(self.b)
        addend = self
        while k:
            if k & 1:
                result = result + addend
            addend = addend.double()
            k >>= 1
        return result

    __rmul__ = __mul__

    def in_subgroup(self) -> bool:
        return (self * R).is_infinity()

    def __repr__(self):
        a = self.affine()
        return f"Point(infinity)" if a is None else f"Point({a[0]!r}, {a[1]!r})"


def msm(points: list, scalars: list) -> Point:
    """Pippenger multi-scalar multiplication.

    The pure-Python counterpart of the reference's arkworks
    `multiexp_unchecked` (SURVEY.md §2.2) and the algorithmic blueprint for
    the TPU bucket-accumulation kernel (ops/).  ~c-bit windows over 255-bit
    scalars with bucket accumulation per window.
    """
    if len(points) != len(scalars):
        raise ValueError("msm: length mismatch")
    pairs = [(p, int(s) % R) for p, s in zip(points, scalars)
             if int(s) % R != 0 and not p.is_infinity()]
    if not pairs:
        base = points[0].b if points else B1
        return Point.infinity(base)
    points = [p for p, _ in pairs]
    scalars = [s for _, s in pairs]
    n = len(points)
    c = 8 if n >= 128 else (4 if n >= 8 else 1)
    mask = (1 << c) - 1
    num_windows = (255 + c) // c
    window_sums = []
    for w in range(num_windows):
        shift = w * c
        buckets: list = [None] * mask
        for p, s in zip(points, scalars):
            idx = (s >> shift) & mask
            if idx:
                buckets[idx - 1] = p if buckets[idx - 1] is None \
                    else buckets[idx - 1] + p
        running = Point.infinity(points[0].b)
        acc = Point.infinity(points[0].b)
        for b in reversed(buckets):
            if b is not None:
                running = running + b
            acc = acc + running
        window_sums.append(acc)
    result = window_sums[-1]
    for ws in reversed(window_sums[:-1]):
        for _ in range(c):
            result = result.double()
        result = result + ws
    return result


def g1_generator() -> Point:
    return Point(G1_X, G1_Y, Fq1.one(), B1)


def g2_generator() -> Point:
    return Point(G2_X, G2_Y, Fq2.one(), B2)


def g1_infinity() -> Point:
    return Point.infinity(B1)


def g2_infinity() -> Point:
    return Point.infinity(B2)


# ---------------------------------------------------------------------------
# ZCash compressed serialization
# ---------------------------------------------------------------------------

_HALF_Q = (Q - 1) // 2


def _y_sign_fq(y: Fq1) -> bool:
    return y.v > _HALF_Q


def _y_sign_fq2(y: Fq2) -> bool:
    # lexicographic on (c1, c0), c1 most significant
    if y.c1 != 0:
        return y.c1 > _HALF_Q
    return y.c0 > _HALF_Q


def g1_to_bytes(p: Point) -> bytes:
    if p.is_infinity():
        return bytes([0xC0]) + b"\x00" * 47
    x, y = p.affine()
    out = bytearray(x.v.to_bytes(48, "big"))
    out[0] |= 0x80
    if _y_sign_fq(y):
        out[0] |= 0x20
    return bytes(out)


def g2_to_bytes(p: Point) -> bytes:
    if p.is_infinity():
        return bytes([0xC0]) + b"\x00" * 95
    x, y = p.affine()
    out = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    out[0] |= 0x80
    if _y_sign_fq2(y):
        out[0] |= 0x20
    return bytes(out)


class DecodeError(ValueError):
    pass


def _parse_flags(data: bytes, size: int):
    if len(data) != size:
        raise DecodeError(f"need {size} bytes, got {len(data)}")
    compression = bool(data[0] & 0x80)
    infinity = bool(data[0] & 0x40)
    sign = bool(data[0] & 0x20)
    if not compression:
        raise DecodeError("only compressed encodings are supported")
    return infinity, sign


def g1_from_bytes(data: bytes, subgroup_check: bool = True) -> Point:
    infinity, sign = _parse_flags(data, 48)
    body = bytes([data[0] & 0x1F]) + data[1:]
    if infinity:
        if any(body) or sign:
            raise DecodeError("malformed infinity encoding")
        return g1_infinity()
    x = int.from_bytes(body, "big")
    if x >= Q:
        raise DecodeError("x out of range")
    xf = Fq1(x)
    y2 = xf.square() * xf + B1
    y = y2.sqrt()
    if y is None:
        raise DecodeError("x not on curve")
    if _y_sign_fq(y) != sign:
        y = -y
    p = Point(xf, y, Fq1.one(), B1)
    if subgroup_check and not p.in_subgroup():
        raise DecodeError("point not in G1 subgroup")
    return p


def g2_from_bytes(data: bytes, subgroup_check: bool = True) -> Point:
    infinity, sign = _parse_flags(data, 96)
    body = bytes([data[0] & 0x1F]) + data[1:]
    if infinity:
        if any(body) or sign:
            raise DecodeError("malformed infinity encoding")
        return g2_infinity()
    c1 = int.from_bytes(body[:48], "big")
    c0 = int.from_bytes(body[48:], "big")
    if c0 >= Q or c1 >= Q:
        raise DecodeError("x out of range")
    xf = Fq2(c0, c1)
    y2 = xf.square() * xf + B2
    y = y2.sqrt()
    if y is None:
        raise DecodeError("x not on curve")
    if _y_sign_fq2(y) != sign:
        y = -y
    p = Point(xf, y, Fq2.one(), B2)
    if subgroup_check and not p.in_subgroup():
        raise DecodeError("point not in G2 subgroup")
    return p


def not_on_curve_x_g1() -> bytes:
    """48-byte compressed encoding whose x IS a canonical field element
    but x^3+4 is a quadratic non-residue — guaranteed to exercise the
    decompression (sqrt-failure) reject path rather than the subgroup
    check.  Deterministic: smallest such x.  Test-vector helper
    (reference bls/kzg generators use hand-picked equivalents)."""
    x = 2
    while fq_sqrt((x * x * x + 4) % Q) is not None:
        x += 1
    enc = bytearray(x.to_bytes(48, "big"))
    enc[0] |= 0x80
    return bytes(enc)


def not_on_curve_x_g2() -> bytes:
    """96-byte compressed G2 encoding with x=(c0, 0) chosen so
    x^3+4(1+u) has no Fq2 square root (same rationale as
    :func:`not_on_curve_x_g1`)."""
    c = 2
    while (Fq2(c, 0).square() * Fq2(c, 0) + B2).sqrt() is not None:
        c += 1
    enc = bytearray((0).to_bytes(48, "big") + c.to_bytes(48, "big"))
    enc[0] |= 0x80
    return bytes(enc)
