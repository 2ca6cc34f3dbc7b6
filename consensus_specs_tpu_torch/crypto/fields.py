"""BLS12-381 field tower: Fq -> Fq2 -> Fq6 -> Fq12.

From-scratch pure-Python arithmetic (the framework's correctness oracle for
the TPU limb kernels; capability counterpart of the reference's external
py_ecc dependency, see SURVEY.md §2.2).  Tower construction:

    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - XI),  XI = u + 1
    Fq12 = Fq6[w] / (w^2 - v)

Fq elements are plain ints (mod Q); extension elements are slotted classes.
"""
from __future__ import annotations

# field modulus
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# curve (subgroup) order
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter z (negative): q and r are polynomials in z
BLS_X = -0xD201000000010000


def fq_inv(a: int) -> int:
    return pow(a, Q - 2, Q)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (Q ≡ 3 mod 4), or None if a is not a QR."""
    a %= Q
    if a == 0:
        return 0
    s = pow(a, (Q + 1) // 4, Q)
    return s if s * s % Q == a else None


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o) -> "Fq2":
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        ac = a * c
        bd = b * d
        return Fq2(ac - bd, (a + b) * (c + d) - ac - bd)

    __rmul__ = __mul__

    def square(self) -> "Fq2":
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), 2 * a * b)

    def mul_by_xi(self) -> "Fq2":
        """Multiply by XI = u + 1:  (a + bu)(1 + u) = (a - b) + (a + b)u."""
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inv(self) -> "Fq2":
        n = fq_inv(self.c0 * self.c0 + self.c1 * self.c1)
        return Fq2(self.c0 * n, -self.c1 * n)

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> "Fq2 | None":
        """Square root via the complex method (u^2 = -1), or None."""
        a, b = self.c0, self.c1
        if b == 0:
            s = fq_sqrt(a)
            if s is not None:
                return Fq2(s, 0)
            s = fq_sqrt(-a % Q)
            assert s is not None
            return Fq2(0, s)
        # norm = a^2 + b^2 must be a QR in Fq
        n = fq_sqrt((a * a + b * b) % Q)
        if n is None:
            return None
        inv2 = fq_inv(2)
        t = (a + n) * inv2 % Q
        x = fq_sqrt(t)
        if x is None:
            t = (a - n) * inv2 % Q
            x = fq_sqrt(t)
            if x is None:
                return None
        y = b * inv2 * fq_inv(x) % Q
        cand = Fq2(x, y)
        return cand if cand.square() == self else None

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for GF(q^2): parity of c0, tie-broken by c1."""
        sign_0 = self.c0 % 2
        zero_0 = self.c0 == 0
        sign_1 = self.c1 % 2
        return sign_0 | (zero_0 & sign_1)

    def __repr__(self):
        return f"Fq2(0x{self.c0:x}, 0x{self.c1:x})"


XI = Fq2(1, 1)


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0 = c0
        self.c1 = c1
        self.c2 = c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o) -> bool:
        return (isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1
                and self.c2 == o.c2)

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        # Karatsuba-style recombination with v^3 = XI
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_by_fq2(self, s: Fq2) -> "Fq6":
        return Fq6(self.c0 * s, self.c1 * s, self.c2 * s)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_v(self) -> "Fq6":
        """Multiply by v: (c0, c1, c2) -> (XI*c2, c0, c1)."""
        return Fq6(self.c2.mul_by_xi(), self.c0, self.c1)

    def inv(self) -> "Fq6":
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_by_xi()
        t1 = c.square().mul_by_xi() - a * b
        t2 = b.square() - a * c
        d = (a * t0 + (c * t1 + b * t2).mul_by_xi()).inv()
        return Fq6(t0 * d, t1 * d, t2 * d)

    def __repr__(self):
        return f"Fq6({self.c0!r}, {self.c1!r}, {self.c2!r})"


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    @staticmethod
    def from_fq(x: int) -> "Fq12":
        return Fq12(Fq6(Fq2(x, 0), Fq2.zero(), Fq2.zero()), Fq6.zero())

    def is_one(self) -> bool:
        return self == Fq12.one()

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_v()) - t - t.mul_by_v()
        return Fq12(c0, t + t)

    def conjugate(self) -> "Fq12":
        """The q^6 Frobenius: negate the w coordinate."""
        return Fq12(self.c0, -self.c1)

    def inv(self) -> "Fq12":
        a, b = self.c0, self.c1
        d = (a.square() - b.square().mul_by_v()).inv()
        return Fq12(a * d, -(b * d))

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        result = Fq12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self, power: int = 1) -> "Fq12":
        """x -> x^(q^power) via conjugation + precomputed XI powers.

        Basis {1, v, v^2, w, vw, v^2 w} = w^{0,2,4,1,3,5}; phi(w^k a) =
        conj(a) * XI^(k(q-1)/6) * w^k.
        """
        f = self
        for _ in range(power % 12):
            a0, a1, a2 = f.c0.c0, f.c0.c1, f.c0.c2
            b0, b1, b2 = f.c1.c0, f.c1.c1, f.c1.c2
            f = Fq12(
                Fq6(a0.conjugate(),
                    a1.conjugate() * _FROB_GAMMA[2],
                    a2.conjugate() * _FROB_GAMMA[4]),
                Fq6(b0.conjugate() * _FROB_GAMMA[1],
                    b1.conjugate() * _FROB_GAMMA[3],
                    b2.conjugate() * _FROB_GAMMA[5]))
        return f

    def cyclotomic_square(self) -> "Fq12":
        """Granger-Scott squaring, valid for unitary elements (those in the
        image of the easy final-exponentiation part).  ~3x cheaper than a
        generic square: three Fq4 squarings."""
        z0, z4, z3 = self.c0.c0, self.c0.c1, self.c0.c2
        z2, z1, z5 = self.c1.c0, self.c1.c1, self.c1.c2

        t0, t1 = _fq4_square(z0, z1)
        z0 = t0 - z0
        z0 = z0 + z0 + t0
        z1 = t1 + z1
        z1 = z1 + z1 + t1

        t0, t1 = _fq4_square(z2, z3)
        t2, t3 = _fq4_square(z4, z5)
        z4 = t0 - z4
        z4 = z4 + z4 + t0
        z5 = t1 + z5
        z5 = z5 + z5 + t1

        t0 = t3.mul_by_xi()
        z2 = t0 + z2
        z2 = z2 + z2 + t0
        z3 = t2 - z3
        z3 = z3 + z3 + t2

        return Fq12(Fq6(z0, z4, z3), Fq6(z2, z1, z5))

    def __repr__(self):
        return f"Fq12({self.c0!r}, {self.c1!r})"


def _fq4_square(a: Fq2, b: Fq2) -> tuple[Fq2, Fq2]:
    """Square of a + b*t in Fq4 = Fq2[t]/(t^2 - XI)."""
    t0 = a.square()
    t1 = b.square()
    c0 = t1.mul_by_xi() + t0
    c1 = (a + b).square() - t0 - t1
    return c0, c1


# Frobenius coefficients XI^(k(q-1)/6) for the w^k basis scalings
assert (Q - 1) % 6 == 0
_FROB_GAMMA = [XI.pow(k * (Q - 1) // 6) for k in range(6)]
