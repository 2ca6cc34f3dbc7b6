"""SSZ type system: views + type descriptors.

A copy of consensus_specs_tpu/ssz/types.py: capability parity with the
consensus-specs SSZ layer (remerkleable re-exported via
tests/core/pyspec/eth2spec/utils/ssz/ssz_typing.py, and the rules in
ssz/simple-serialize.md), built from scratch with a different design: values
are thin mutable views over Python data, and merkleization is a flat chunk
sweep (ssz/merkle.py) whose large levels run on the CUDA SHA-256 kernel.  No
object-graph persistent trees.

Supported types: boolean, uint8/16/32/64/128/256, Bitvector[N], Bitlist[N],
ByteVector[N], ByteList[N], Vector[T, N], List[T, N], Container, Union[...].
"""
from __future__ import annotations

from .merkle import (
    merkleize_chunks, mix_in_length, mix_in_selector, ZERO_CHUNK,
)

BYTES_PER_CHUNK = 32

# Incremental-merkleization seam (ssz/incremental.py in the JAX package; not
# ported yet, so both stay None here).  While that mode
# is enabled it installs `_inc_root_hook` (view -> cached/swept root, or
# None to fall through to the legacy full computation) and `_inc_mut`
# (the mutation-hook table that keeps dirty-chunk tracking current).
# Both are None when disabled: the only overhead on the legacy path is
# one global check per call.
_inc_root_hook = None
_inc_mut = None


def _htr(view) -> bytes:
    """Composite hash_tree_root entry: incremental when tracked, legacy
    full chunk rebuild (`_htr_full`) otherwise."""
    hook = _inc_root_hook
    if hook is not None:
        root = hook(view)
        if root is not None:
            return root
    return view._htr_full()


class SSZType:
    """Base for all SSZ views.  Class-level descriptors double as types."""

    @classmethod
    def is_fixed_size(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def type_byte_length(cls) -> int:
        """Fixed serialized length (only valid if is_fixed_size())."""
        raise NotImplementedError

    @classmethod
    def default(cls):
        raise NotImplementedError

    @classmethod
    def coerce(cls, value):
        """Coerce a python value (or another view) into a view of this type."""
        if isinstance(value, cls):
            return value
        return cls(value)

    @classmethod
    def coerce_assign(cls, value):
        """Coerce for STORAGE inside another view.  Composite (mutable)
        views are copied so the stored value never aliases a caller-held
        view — the reference's remerkleable views are persistent, so
        assignment there is by value; sharing our mutable views would let
        a later mutation of one object silently rewrite another (e.g.
        storing state.current_justified_checkpoint into an
        AttestationData must snapshot it)."""
        v = cls.coerce(value)
        if v is value and isinstance(v, _MUTABLE_VIEW_BASES):
            return _structural_copy(v)
        return v

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls.deserialize(data)

    def encode_bytes(self) -> bytes:
        return self.serialize()

    def serialize(self) -> bytes:
        raise NotImplementedError

    @classmethod
    def deserialize(cls, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self) -> bytes:
        raise NotImplementedError

    def copy(self):
        return self.__class__.deserialize(self.serialize())

    def __eq__(self, other):
        if isinstance(other, SSZType):
            return self.serialize() == other.serialize() and \
                type(self).ssz_compatible(type(other))
        return NotImplemented

    def __hash__(self):
        return hash((self.__class__.__name__, self.serialize()))

    @classmethod
    def ssz_compatible(cls, other) -> bool:
        return cls is other or cls.__name__ == other.__name__


# ---------------------------------------------------------------------------
# basic types
# ---------------------------------------------------------------------------

class uint(int, SSZType):
    BYTE_LEN = 0

    def __new__(cls, value=0):
        value = int(value)
        if not 0 <= value < (1 << (8 * cls.BYTE_LEN)):
            raise ValueError(
                f"{cls.__name__} out of range: {value}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def type_byte_length(cls):
        return cls.BYTE_LEN

    @classmethod
    def default(cls):
        return cls(0)

    def serialize(self) -> bytes:
        return int(self).to_bytes(self.BYTE_LEN, "little")

    @classmethod
    def deserialize(cls, data: bytes):
        if len(data) != cls.BYTE_LEN:
            raise ValueError(f"{cls.__name__}: bad length {len(data)}")
        return cls(int.from_bytes(data, "little"))

    def hash_tree_root(self) -> bytes:
        return int(self).to_bytes(self.BYTE_LEN, "little").ljust(32, b"\x00")

    def copy(self):
        return self

    # checked arithmetic: stays in-type, raises on over/underflow — this is
    # how invalid state transitions surface as exceptions, matching the
    # reference semantics (remerkleable uints; see SURVEY.md §7 hard part 2).
    def _wrap(self, value):
        return type(self)(value)

    def __add__(self, o): return self._wrap(int(self) + int(o))
    def __radd__(self, o): return self._wrap(int(o) + int(self))
    def __sub__(self, o): return self._wrap(int(self) - int(o))
    def __rsub__(self, o): return self._wrap(int(o) - int(self))
    def __mul__(self, o): return self._wrap(int(self) * int(o))
    def __rmul__(self, o): return self._wrap(int(o) * int(self))
    def __floordiv__(self, o): return self._wrap(int(self) // int(o))

    def __truediv__(self, o):
        raise TypeError("use // for integer division on SSZ uints")

    def __mod__(self, o): return self._wrap(int(self) % int(o))
    def __pow__(self, o, m=None): return self._wrap(pow(int(self), int(o), m))
    def __and__(self, o): return self._wrap(int(self) & int(o))
    def __or__(self, o): return self._wrap(int(self) | int(o))
    def __xor__(self, o): return self._wrap(int(self) ^ int(o))
    def __lshift__(self, o): return self._wrap(int(self) << int(o))
    def __rshift__(self, o): return self._wrap(int(self) >> int(o))

    def __eq__(self, other):
        return int(self) == other if isinstance(other, int) else NotImplemented

    def __hash__(self):
        return int.__hash__(self)

    def __repr__(self):
        return f"{type(self).__name__}({int(self)})"


class uint8(uint):
    BYTE_LEN = 1


class uint16(uint):
    BYTE_LEN = 2


class uint32(uint):
    BYTE_LEN = 4


class uint64(uint):
    BYTE_LEN = 8


class uint128(uint):
    BYTE_LEN = 16


class uint256(uint):
    BYTE_LEN = 32


class boolean(int, SSZType):
    def __new__(cls, value=0):
        value = int(value)
        if value not in (0, 1):
            raise ValueError("boolean must be 0 or 1")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def type_byte_length(cls):
        return 1

    @classmethod
    def default(cls):
        return cls(0)

    def serialize(self):
        return bytes([int(self)])

    @classmethod
    def deserialize(cls, data):
        if data == b"\x00":
            return cls(0)
        if data == b"\x01":
            return cls(1)
        raise ValueError("invalid boolean encoding")

    def hash_tree_root(self):
        return bytes([int(self)]).ljust(32, b"\x00")

    def copy(self):
        return self

    def __repr__(self):
        return f"boolean({int(self)})"


def is_basic_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, (uint, boolean))


# ---------------------------------------------------------------------------
# parameterized-type machinery:  Vector[uint64, 8] etc.
# ---------------------------------------------------------------------------

class ParamMeta(type):
    _cache: dict = {}

    def __getitem__(cls, params):
        if not isinstance(params, tuple):
            params = (params,)
        key = (cls, params)
        cached = ParamMeta._cache.get(key)
        if cached is None:
            cached = cls._parametrize(params)
            ParamMeta._cache[key] = cached
        return cached


# ---------------------------------------------------------------------------
# byte types
# ---------------------------------------------------------------------------

class ByteVector(bytes, SSZType, metaclass=ParamMeta):
    LENGTH = 0

    @classmethod
    def _parametrize(cls, params):
        (n,) = params
        return type(f"ByteVector[{n}]", (ByteVector,), {"LENGTH": int(n)})

    def __new__(cls, value=None):
        if cls.LENGTH == 0 and cls is ByteVector:
            raise TypeError("use ByteVector[N]")
        if value is None:
            value = b"\x00" * cls.LENGTH
        if isinstance(value, str):
            value = bytes.fromhex(value.removeprefix("0x"))
        value = bytes(value)
        if len(value) != cls.LENGTH:
            raise ValueError(f"{cls.__name__}: need {cls.LENGTH} bytes, got {len(value)}")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def type_byte_length(cls):
        return cls.LENGTH

    @classmethod
    def default(cls):
        return cls(b"\x00" * cls.LENGTH)

    def serialize(self):
        return bytes(self)

    @classmethod
    def deserialize(cls, data):
        return cls(data)

    def hash_tree_root(self):
        chunks = _bytes_to_chunks(bytes(self))
        return merkleize_chunks(chunks)

    def copy(self):
        return self

    @classmethod
    def ssz_compatible(cls, other):
        return issubclass(other, ByteVector) and other.LENGTH == cls.LENGTH

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


class ByteList(bytes, SSZType, metaclass=ParamMeta):
    LIMIT = 0

    @classmethod
    def _parametrize(cls, params):
        (n,) = params
        return type(f"ByteList[{n}]", (ByteList,), {"LIMIT": int(n)})

    def __new__(cls, value=b""):
        if isinstance(value, str):
            value = bytes.fromhex(value.removeprefix("0x"))
        value = bytes(value)
        if len(value) > cls.LIMIT:
            raise ValueError(f"{cls.__name__}: {len(value)} bytes exceeds limit")
        return super().__new__(cls, value)

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        return cls(b"")

    def serialize(self):
        return bytes(self)

    @classmethod
    def deserialize(cls, data):
        return cls(data)

    def hash_tree_root(self):
        chunks = _bytes_to_chunks(bytes(self))
        limit = (self.LIMIT + 31) // 32
        return mix_in_length(merkleize_chunks(chunks, limit=limit), len(self))

    def copy(self):
        return self

    @classmethod
    def ssz_compatible(cls, other):
        return issubclass(other, ByteList) and other.LIMIT == cls.LIMIT

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


def _bytes_to_chunks(data: bytes) -> list[bytes]:
    if len(data) == 0:
        return []
    padded_len = (len(data) + 31) // 32 * 32
    data = data.ljust(padded_len, b"\x00")
    return [data[i:i + 32] for i in range(0, len(data), 32)]


# ---------------------------------------------------------------------------
# bit types
# ---------------------------------------------------------------------------

class Bits(SSZType):
    """Shared machinery for Bitvector/Bitlist; stores a python list of bools."""

    def __init__(self, bits=()):
        if isinstance(bits, (bytes, bytearray)):
            raise TypeError("construct bit types from an iterable of bools")
        self._bits = [bool(b) for b in bits]

    def __len__(self):
        return len(self._bits)

    def __iter__(self):
        return iter(self._bits)

    def __getitem__(self, i):
        return self._bits[i]

    def __setitem__(self, i, v):
        self._bits[i] = bool(v)
        if _inc_mut is not None:
            _inc_mut.on_bits_set(self, i)

    def copy(self):
        return _structural_copy(self)

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            return (len(self._bits) == len(other)
                    and all(bool(a) == bool(b)
                            for a, b in zip(self._bits, other)))
        return SSZType.__eq__(self, other)

    def __hash__(self):
        return SSZType.__hash__(self)

    def _pack_bits(self) -> bytes:
        out = bytearray((len(self._bits) + 7) // 8)
        for i, b in enumerate(self._bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def __repr__(self):
        return f"{type(self).__name__}({self._bits})"


class Bitvector(Bits, metaclass=ParamMeta):
    LENGTH = 0

    @classmethod
    def _parametrize(cls, params):
        (n,) = params
        if n <= 0:
            raise TypeError("Bitvector length must be > 0")
        return type(f"Bitvector[{n}]", (Bitvector,), {"LENGTH": int(n)})

    def __init__(self, bits=None):
        if bits is None:
            bits = [False] * self.LENGTH
        super().__init__(bits)
        if len(self._bits) != self.LENGTH:
            raise ValueError(f"{type(self).__name__}: need {self.LENGTH} bits")

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def type_byte_length(cls):
        return (cls.LENGTH + 7) // 8

    @classmethod
    def default(cls):
        return cls()

    def serialize(self):
        return self._pack_bits()

    @classmethod
    def deserialize(cls, data):
        if len(data) != (cls.LENGTH + 7) // 8:
            raise ValueError("bad bitvector length")
        # check zero padding in the last byte
        if cls.LENGTH % 8 != 0 and data[-1] >> (cls.LENGTH % 8):
            raise ValueError("non-zero padding bits")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(cls.LENGTH)]
        return cls(bits)

    def hash_tree_root(self):
        return _htr(self)

    def _htr_full(self):
        chunks = _bytes_to_chunks(self._pack_bits())
        limit = (self.LENGTH + 255) // 256
        return merkleize_chunks(chunks, limit=limit)

    @classmethod
    def ssz_compatible(cls, other):
        return issubclass(other, Bitvector) and other.LENGTH == cls.LENGTH


class Bitlist(Bits, metaclass=ParamMeta):
    LIMIT = 0

    @classmethod
    def _parametrize(cls, params):
        (n,) = params
        return type(f"Bitlist[{n}]", (Bitlist,), {"LIMIT": int(n)})

    def __init__(self, bits=()):
        super().__init__(bits)
        if len(self._bits) > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: exceeds limit {self.LIMIT}")

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        return cls()

    def append(self, v):
        if len(self._bits) >= self.LIMIT:
            raise ValueError("bitlist full")
        self._bits.append(bool(v))
        if _inc_mut is not None:
            _inc_mut.on_bits_append(self)

    def serialize(self):
        # delimiter bit marks the length
        out = bytearray(self._pack_bits())
        n = len(self._bits)
        if n % 8 == 0:
            out.append(1)
        else:
            out[-1] |= 1 << (n % 8)
        return bytes(out)

    @classmethod
    def deserialize(cls, data):
        if len(data) == 0:
            raise ValueError("empty bitlist encoding")
        last = data[-1]
        if last == 0:
            raise ValueError("missing delimiter bit")
        delim = last.bit_length() - 1
        n = (len(data) - 1) * 8 + delim
        if n > cls.LIMIT:
            raise ValueError("bitlist exceeds limit")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(n)]
        return cls(bits)

    def hash_tree_root(self):
        return _htr(self)

    def _htr_full(self):
        chunks = _bytes_to_chunks(self._pack_bits())
        limit = (self.LIMIT + 255) // 256
        return mix_in_length(merkleize_chunks(chunks, limit=limit), len(self._bits))

    @classmethod
    def ssz_compatible(cls, other):
        return issubclass(other, Bitlist) and other.LIMIT == cls.LIMIT


# ---------------------------------------------------------------------------
# composite sequences
# ---------------------------------------------------------------------------

def _pack_basics(values, elem_type) -> list[bytes]:
    data = b"".join(elem_type.coerce(v).serialize() for v in values)
    return _bytes_to_chunks(data)


class _Sequence(SSZType):
    ELEM_TYPE: type = None

    def __init__(self, elems=()):
        t = self.ELEM_TYPE
        self._elems = [t.coerce_assign(e) for e in elems]

    @classmethod
    def _from_elems(cls, elems: list):
        """Internal no-coerce constructor for deserialize paths (elements
        are freshly built and correctly typed — re-coercing would copy
        every composite element a second time)."""
        obj = cls.__new__(cls)
        obj._elems = elems
        return obj

    def __len__(self):
        return len(self._elems)

    def __iter__(self):
        return iter(self._elems)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._elems[i]
        return self._elems[i]

    def __setitem__(self, i, v):
        # slice assignment is unsupported either way: coerce_assign
        # raises on a non-element value before the store happens
        coerced = self.ELEM_TYPE.coerce_assign(v)
        if _inc_mut is None:
            self._elems[i] = coerced
        else:
            old = self._elems[i]
            self._elems[i] = coerced
            _inc_mut.on_seq_set(self, i, old, coerced)

    def index(self, v):
        return self._elems.index(self.ELEM_TYPE.coerce(v))

    def count(self, v):
        try:
            return self._elems.count(self.ELEM_TYPE.coerce(v))
        except (ValueError, TypeError):
            return 0  # un-coercible values occur 0 times (list.count parity)

    def __contains__(self, v):
        try:
            return self.ELEM_TYPE.coerce(v) in self._elems
        except (ValueError, TypeError):
            return False

    def _serialize_elems(self):
        t = self.ELEM_TYPE
        if t.is_fixed_size():
            return b"".join(e.serialize() for e in self._elems)
        parts = [e.serialize() for e in self._elems]
        offset = 4 * len(parts)
        head = b""
        for p in parts:
            head += offset.to_bytes(4, "little")
            offset += len(p)
        return head + b"".join(parts)

    @classmethod
    def _deserialize_elems(cls, data: bytes) -> list:
        t = cls.ELEM_TYPE
        if t.is_fixed_size():
            n = t.type_byte_length()
            if len(data) % n != 0:
                raise ValueError("bad sequence encoding")
            return [t.deserialize(data[i:i + n]) for i in range(0, len(data), n)]
        if len(data) == 0:
            return []
        first_off = int.from_bytes(data[0:4], "little")
        if first_off == 0 or first_off % 4 != 0 or first_off > len(data):
            raise ValueError("bad first offset")
        count = first_off // 4
        offsets = [int.from_bytes(data[4 * i:4 * i + 4], "little")
                   for i in range(count)] + [len(data)]
        elems = []
        for i in range(count):
            if offsets[i + 1] < offsets[i]:
                raise ValueError("offsets not monotonic")
            elems.append(t.deserialize(data[offsets[i]:offsets[i + 1]]))
        return elems

    def _elem_chunks(self) -> list[bytes]:
        if is_basic_type(self.ELEM_TYPE):
            return _pack_basics(self._elems, self.ELEM_TYPE)
        return [e.hash_tree_root() for e in self._elems]

    def copy(self):
        return _structural_copy(self)

    def __eq__(self, other):
        # spec code compares views against plain python sequences
        # (e.g. `indices == sorted(set(indices))`) — remerkleable supports
        # this, so we must too
        if isinstance(other, (list, tuple)):
            return (len(self._elems) == len(other)
                    and all(a == b for a, b in zip(self._elems, other)))
        return SSZType.__eq__(self, other)

    def __hash__(self):
        return SSZType.__hash__(self)

    def __repr__(self):
        return f"{type(self).__name__}({self._elems!r})"


class Vector(_Sequence, metaclass=ParamMeta):
    LENGTH = 0

    @classmethod
    def _parametrize(cls, params):
        t, n = params
        if int(n) <= 0:
            raise TypeError("Vector length must be > 0")
        return type(f"Vector[{t.__name__},{n}]", (Vector,),
                    {"ELEM_TYPE": t, "LENGTH": int(n)})

    def __init__(self, elems=None):
        if elems is None:
            elems = [self.ELEM_TYPE.default() for _ in range(self.LENGTH)]
        super().__init__(elems)
        if len(self._elems) != self.LENGTH:
            raise ValueError(
                f"{type(self).__name__}: need {self.LENGTH} elements, "
                f"got {len(self._elems)}")

    @classmethod
    def is_fixed_size(cls):
        return cls.ELEM_TYPE.is_fixed_size()

    @classmethod
    def type_byte_length(cls):
        return cls.ELEM_TYPE.type_byte_length() * cls.LENGTH

    @classmethod
    def default(cls):
        return cls()

    def serialize(self):
        return self._serialize_elems()

    @classmethod
    def deserialize(cls, data):
        elems = cls._deserialize_elems(data)
        if len(elems) != cls.LENGTH:
            raise ValueError(
                f"{cls.__name__}: need {cls.LENGTH} elements, "
                f"got {len(elems)}")
        return cls._from_elems(elems)

    def hash_tree_root(self):
        return _htr(self)

    def _htr_full(self):
        if is_basic_type(self.ELEM_TYPE):
            return merkleize_chunks(self._elem_chunks())
        return merkleize_chunks(self._elem_chunks(), limit=self.LENGTH)

    @classmethod
    def ssz_compatible(cls, other):
        return (issubclass(other, Vector) and other.LENGTH == cls.LENGTH
                and cls.ELEM_TYPE.ssz_compatible(other.ELEM_TYPE))


class List(_Sequence, metaclass=ParamMeta):
    LIMIT = 0

    @classmethod
    def _parametrize(cls, params):
        t, n = params
        return type(f"List[{t.__name__},{n}]", (List,),
                    {"ELEM_TYPE": t, "LIMIT": int(n)})

    def __init__(self, elems=()):
        super().__init__(elems)
        if len(self._elems) > self.LIMIT:
            raise ValueError(f"{type(self).__name__}: exceeds limit {self.LIMIT}")

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        return cls()

    def append(self, v):
        if len(self._elems) >= self.LIMIT:
            raise ValueError("list full")
        self._elems.append(self.ELEM_TYPE.coerce_assign(v))
        if _inc_mut is not None:
            _inc_mut.on_seq_append(self)

    def pop(self, i=-1):
        if _inc_mut is None:
            return self._elems.pop(i)
        old_len = len(self._elems)
        v = self._elems.pop(i)
        _inc_mut.on_seq_pop(self, v, i if i >= 0 else i + old_len, old_len)
        return v

    def serialize(self):
        return self._serialize_elems()

    @classmethod
    def deserialize(cls, data):
        elems = cls._deserialize_elems(data)
        if len(elems) > cls.LIMIT:
            raise ValueError(
                f"{cls.__name__}: exceeds limit {cls.LIMIT}")
        return cls._from_elems(elems)

    def hash_tree_root(self):
        return _htr(self)

    def _htr_full(self):
        if is_basic_type(self.ELEM_TYPE):
            elem_len = self.ELEM_TYPE.type_byte_length()
            limit = (self.LIMIT * elem_len + 31) // 32
        else:
            limit = self.LIMIT
        root = merkleize_chunks(self._elem_chunks(), limit=limit)
        return mix_in_length(root, len(self._elems))

    @classmethod
    def ssz_compatible(cls, other):
        return (issubclass(other, List) and other.LIMIT == cls.LIMIT
                and cls.ELEM_TYPE.ssz_compatible(other.ELEM_TYPE))


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------

class Container(SSZType):
    """SSZ container; fields declared via class annotations, in order.

    class Checkpoint(Container):
        epoch: uint64
        root: Bytes32
    """
    _field_names: tuple = ()
    _field_types: tuple = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # collect fields across the MRO (base-class fields first, subclass
        # fields appended; re-annotating an inherited name overrides in place)
        fields: dict = {}
        for klass in reversed(cls.__mro__):
            anns = klass.__dict__.get("__annotations__", {})
            for k, v in anns.items():
                if not k.startswith("_"):
                    if isinstance(v, str):
                        raise TypeError(
                            f"{cls.__name__}.{k}: field annotation is a "
                            "string — remove `from __future__ import "
                            "annotations` from the defining module")
                    fields[k] = v
        if fields:
            cls._field_names = tuple(fields)
            cls._field_types = tuple(fields.values())

    @classmethod
    def fields(cls) -> dict:
        return dict(zip(cls._field_names, cls._field_types))

    @classmethod
    def coerce(cls, value):
        if isinstance(value, cls):
            return value
        if isinstance(value, Container):
            # same-shaped container from another spec instance (each fork x
            # preset builds its own classes): rebuild structurally
            if not cls.ssz_compatible(type(value)):
                raise TypeError(
                    f"cannot coerce {type(value).__name__} to "
                    f"{cls.__name__}: incompatible SSZ structure")
            return cls.deserialize(value.serialize())
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(
            f"cannot coerce {type(value).__name__} to {cls.__name__}")

    def __init__(self, **kwargs):
        values = {}
        for name, t in zip(self._field_names, self._field_types):
            if name in kwargs:
                values[name] = t.coerce_assign(kwargs.pop(name))
            else:
                values[name] = t.default()
        if kwargs:
            raise TypeError(f"unknown fields {list(kwargs)} for {type(self).__name__}")
        object.__setattr__(self, "_values", values)

    def __getattr__(self, name):
        # only called when normal lookup fails
        values = self.__dict__.get("_values")
        if values is not None and name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._field_names:
            idx = self._field_names.index(name)
            coerced = self._field_types[idx].coerce_assign(value)
            if _inc_mut is None:
                self._values[name] = coerced
            else:
                old = self._values[name]
                self._values[name] = coerced
                _inc_mut.on_container_set(self, idx, old, coerced)
        else:
            object.__setattr__(self, name, value)

    @classmethod
    def is_fixed_size(cls):
        return all(t.is_fixed_size() for t in cls._field_types)

    @classmethod
    def type_byte_length(cls):
        return sum(t.type_byte_length() for t in cls._field_types)

    @classmethod
    def default(cls):
        return cls()

    def serialize(self) -> bytes:
        fixed_parts = []
        variable_parts = []
        for name, t in zip(self._field_names, self._field_types):
            v = self._values[name]
            if t.is_fixed_size():
                fixed_parts.append(v.serialize())
                variable_parts.append(b"")
            else:
                fixed_parts.append(None)  # placeholder for 4-byte offset
                variable_parts.append(v.serialize())
        fixed_len = sum(4 if p is None else len(p) for p in fixed_parts)
        offset = fixed_len
        out = b""
        for p, vp in zip(fixed_parts, variable_parts):
            if p is None:
                out += offset.to_bytes(4, "little")
                offset += len(vp)
            else:
                out += p
        return out + b"".join(variable_parts)

    @classmethod
    def deserialize(cls, data: bytes):
        values = {}
        # first pass: fixed fields + collect offsets
        pos = 0
        offsets = []
        var_fields = []
        for name, t in zip(cls._field_names, cls._field_types):
            if t.is_fixed_size():
                n = t.type_byte_length()
                if pos + n > len(data):
                    raise ValueError("container encoding too short")
                values[name] = t.deserialize(data[pos:pos + n])
                pos += n
            else:
                if pos + 4 > len(data):
                    raise ValueError("container encoding too short")
                offsets.append(int.from_bytes(data[pos:pos + 4], "little"))
                var_fields.append((name, t))
                pos += 4
        if var_fields:
            if offsets[0] != pos:
                raise ValueError("bad first offset in container")
            bounds = offsets + [len(data)]
            for (name, t), start, end in zip(var_fields, bounds, bounds[1:]):
                if end < start or end > len(data):
                    raise ValueError("bad offsets in container")
                values[name] = t.deserialize(data[start:end])
        elif pos != len(data):
            raise ValueError("trailing bytes in container encoding")
        obj = cls.__new__(cls)
        object.__setattr__(obj, "_values", values)
        return obj

    def copy(self):
        return _structural_copy(self)

    def hash_tree_root(self) -> bytes:
        if not self._field_names:
            return merkleize_chunks([ZERO_CHUNK])
        return _htr(self)

    def _htr_full(self) -> bytes:
        chunks = [self._values[n].hash_tree_root() for n in self._field_names]
        return merkleize_chunks(chunks)

    @classmethod
    def ssz_compatible(cls, other):
        return (issubclass(other, Container)
                and cls._field_names == other._field_names
                and all(a.ssz_compatible(b) for a, b in
                        zip(cls._field_types, other._field_types)))

    def __repr__(self):
        inner = ", ".join(f"{n}={self._values[n]!r}" for n in self._field_names)
        return f"{type(self).__name__}({inner})"


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

class Union(SSZType, metaclass=ParamMeta):
    OPTIONS: tuple = ()

    @classmethod
    def _parametrize(cls, params):
        names = ",".join("None" if t is None else t.__name__ for t in params)
        if params[0] is None and len(params) == 1:
            raise TypeError("Union[None] is invalid")
        if any(t is None for t in params[1:]):
            raise TypeError("only the first union option may be None")
        return type(f"Union[{names}]", (Union,), {"OPTIONS": tuple(params)})

    def __init__(self, selector: int, value=None):
        if not 0 <= selector < len(self.OPTIONS):
            raise ValueError("bad union selector")
        t = self.OPTIONS[selector]
        if t is None:
            if value is not None:
                raise ValueError("None option takes no value")
        else:
            value = t.coerce(value if value is not None else t.default())
        self.selector = selector
        self.value = value

    def __setattr__(self, name, value):
        old = self.__dict__.get("value") if name == "value" else None
        object.__setattr__(self, name, value)
        if _inc_mut is not None and name in ("selector", "value"):
            _inc_mut.on_union_set(self, old)

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def default(cls):
        t = cls.OPTIONS[0]
        return cls(0, None if t is None else t.default())

    def serialize(self):
        body = b"" if self.value is None else self.value.serialize()
        return bytes([self.selector]) + body

    @classmethod
    def deserialize(cls, data):
        if len(data) == 0:
            raise ValueError("empty union encoding")
        sel = data[0]
        if sel >= len(cls.OPTIONS):
            raise ValueError("bad union selector")
        t = cls.OPTIONS[sel]
        if t is None:
            if len(data) != 1:
                raise ValueError("None union option with body")
            return cls(sel, None)
        return cls(sel, t.deserialize(data[1:]))

    def copy(self):
        return _structural_copy(self)

    def hash_tree_root(self):
        return _htr(self)

    def _htr_full(self):
        root = ZERO_CHUNK if self.value is None else self.value.hash_tree_root()
        return mix_in_selector(root, self.selector)

    @classmethod
    def ssz_compatible(cls, other):
        return issubclass(other, Union) and cls.OPTIONS == other.OPTIONS

    def __repr__(self):
        return f"{type(self).__name__}(selector={self.selector}, value={self.value!r})"


# common aliases used throughout the specs
Bytes1 = ByteVector[1]
Bytes4 = ByteVector[4]
Bytes8 = ByteVector[8]
Bytes20 = ByteVector[20]
Bytes31 = ByteVector[31]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]
bit = boolean
byte = uint8
null = None

# mutable composite views: stored-by-copy on assignment (see
# SSZType.coerce_assign).  uintN / boolean / ByteVector / ByteList are
# immutable Python objects and safe to share.
_MUTABLE_VIEW_BASES = (_Sequence, Container, Bits, Union)


def _structural_copy(v):
    """Deep copy of a composite view WITHOUT the serialize round-trip of
    SSZType.copy(): rebuild the object graph, sharing immutable leaves
    (uints/bytes) and recursing only through mutable views.  This is the
    hot path of coerce_assign — every composite assignment/append pays
    it.

    When the source carries an incremental-merkleization cache, the copy
    shares it copy-on-write (ssz/incremental.on_copy): the level arrays
    are shared until either side's next sweep needs to write, so a
    transactional state copy costs no re-hashing."""
    if isinstance(v, _Sequence):
        t = v.ELEM_TYPE
        if is_basic_type(t) or not issubclass(t, _MUTABLE_VIEW_BASES):
            obj = type(v)._from_elems(list(v._elems))
        else:
            obj = type(v)._from_elems(
                [_structural_copy(e) for e in v._elems])
    elif isinstance(v, Container):
        values = {}
        for name in v._field_names:
            f = v._values[name]
            values[name] = (_structural_copy(f)
                            if isinstance(f, _MUTABLE_VIEW_BASES) else f)
        obj = type(v).__new__(type(v))
        object.__setattr__(obj, "_values", values)
    elif isinstance(v, Bits):
        obj = type(v).__new__(type(v))
        obj._bits = list(v._bits)
    elif isinstance(v, Union):
        val = v.value
        if isinstance(val, _MUTABLE_VIEW_BASES):
            val = _structural_copy(val)
        obj = type(v).__new__(type(v))
        obj.selector = v.selector
        obj.value = val
    else:
        raise TypeError(f"not a composite view: {type(v).__name__}")
    if _inc_mut is not None:
        _inc_mut.on_copy(v, obj)
    return obj
