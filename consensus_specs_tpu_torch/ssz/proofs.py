"""Generalized indices and single-leaf merkle proofs over SSZ views.

A copy of consensus_specs_tpu/ssz/proofs.py (pure Python).  Capability
counterpart of the consensus-specs ssz/merkle-proofs.md:58-249 and
remerkleable's proof machinery: compute a generalized index from a type +
path, and produce the sibling branch for any generalized index of a view.
Used by blob-sidecar inclusion proofs (deneb) and the light-client sync
protocol (altair).
"""
from __future__ import annotations

from .merkle import (ZERO_HASHES, chunk_depth, hash_pair, merkleize_chunks,
                     next_power_of_two)
from .types import (
    Bits, Bitlist, ByteList, ByteVector, Container, List, SSZType, Union,
    Vector, _Sequence, is_basic_type,
)


def concat_generalized_indices(*indices: int) -> int:
    out = 1
    for index in indices:
        anchor = 1 << (index.bit_length() - 1)  # power-of-two floor
        out = out * anchor + (index - anchor)
    return out


def get_generalized_index_length(index: int) -> int:
    return index.bit_length() - 1


def get_subtree_index(generalized_index: int) -> int:
    return generalized_index % (
        1 << get_generalized_index_length(generalized_index))


def generalized_index_sibling(index: int) -> int:
    return index ^ 1

def generalized_index_parent(index: int) -> int:
    return index // 2

def generalized_index_child(index: int, right_side: bool) -> int:
    return index * 2 + int(right_side)


def _chunk_count(typ) -> int:
    """Number of bottom-layer chunks of the type's merkleization."""
    if is_basic_type(typ):
        return 1
    if issubclass(typ, ByteVector):
        return (typ.LENGTH + 31) // 32
    if issubclass(typ, ByteList):
        return (typ.LIMIT + 31) // 32
    if issubclass(typ, Bitlist):
        return (typ.LIMIT + 255) // 256
    if issubclass(typ, Bits):  # Bitvector
        return (typ.LENGTH + 255) // 256
    if issubclass(typ, Vector):
        if is_basic_type(typ.ELEM_TYPE):
            return (typ.LENGTH * typ.ELEM_TYPE.type_byte_length() + 31) // 32
        return typ.LENGTH
    if issubclass(typ, List):
        if is_basic_type(typ.ELEM_TYPE):
            return (typ.LIMIT * typ.ELEM_TYPE.type_byte_length() + 31) // 32
        return typ.LIMIT
    if issubclass(typ, Container):
        return len(typ._field_names)
    raise TypeError(f"no chunk count for {typ}")


def _has_length_mixin(typ) -> bool:
    return issubclass(typ, (List, ByteList, Bitlist))


def get_generalized_index(typ, *path) -> int:
    """Generalized index of the node at `path` starting from `typ`'s root.

    Path elements: field names (containers), integer indices (vectors /
    lists; descends into the data subtree under the length mix-in), or the
    special "__len__" for a list's length node.
    """
    gindex = 1
    for step_num, step in enumerate(path):
        is_last = step_num == len(path) - 1
        if _has_length_mixin(typ):
            if step == "__len__":
                if not is_last:
                    raise TypeError("cannot descend below a length mix-in")
                return concat_generalized_indices(gindex, 3)
            gindex = concat_generalized_indices(gindex, 2)
        elif step == "__len__":
            raise TypeError(f"{typ} has no length mix-in")
        chunk_count = _chunk_count(typ)
        depth = chunk_depth(chunk_count)
        if issubclass(typ, Container):
            if step not in typ._field_names:
                raise KeyError(f"{typ.__name__} has no field {step!r}")
            pos = typ._field_names.index(step)
            gindex = concat_generalized_indices(gindex, (1 << depth) + pos)
            typ = typ._field_types[pos]
        elif issubclass(typ, (Vector, List)):
            elem = typ.ELEM_TYPE
            if is_basic_type(elem):
                per_chunk = 32 // elem.type_byte_length()
                chunk = int(step) // per_chunk
                if chunk >= chunk_count:
                    raise IndexError("element index out of type bounds")
                if not is_last:
                    raise TypeError(
                        "cannot descend into a basic element")
                return concat_generalized_indices(
                    gindex, (1 << depth) + chunk)
            if int(step) >= chunk_count:
                raise IndexError("element index out of type bounds")
            gindex = concat_generalized_indices(
                gindex, (1 << depth) + int(step))
            typ = elem
        elif issubclass(typ, (ByteVector, ByteList, Bits)):
            # bytes pack 32 per chunk; bit sequences pack 256 per chunk
            per_chunk = 256 if issubclass(typ, Bits) else 32
            chunk = int(step) // per_chunk
            if chunk >= chunk_count:
                raise IndexError("index out of type bounds")
            if not is_last:
                raise TypeError("cannot descend below a leaf chunk")
            return concat_generalized_indices(
                gindex, (1 << depth) + chunk)
        else:
            raise TypeError(f"cannot descend into {typ}")
    return gindex


# ---------------------------------------------------------------------------
# node resolution over a live view
# ---------------------------------------------------------------------------

def _chunk_subtree_node(chunks: list[bytes], depth: int, gindex: int) -> bytes:
    """Root of the node `gindex` within a zero-padded chunk subtree of the
    given depth (gindex local: 1 = subtree root)."""
    path_len = get_generalized_index_length(gindex)
    if path_len > depth:
        raise ValueError("gindex below chunk level")
    # position of the node's subtree among 2**path_len slices
    pos = get_subtree_index(gindex)
    sub_depth = depth - path_len
    size = 1 << sub_depth
    start = pos * size
    sub = chunks[start:start + size]
    if not sub:
        return ZERO_HASHES[sub_depth]
    # merkleize the slice at fixed depth via the pluggable level hasher
    return merkleize_chunks(sub, limit=size)


def _node_of(view, gindex: int) -> bytes:
    """Root of the subtree at `gindex` of `view`'s merkle tree."""
    if gindex == 1:
        return bytes(view.hash_tree_root())
    typ = type(view)

    if _has_length_mixin(typ):
        # root = hash(data_root, length): gindex 2 -> data, 3 -> length
        if gindex == 3:
            if isinstance(view, Bits):
                return len(view._bits).to_bytes(32, "little")
            return len(view).to_bytes(32, "little")
        path_len = get_generalized_index_length(gindex)
        first_bit = (gindex >> (path_len - 1)) & 1
        if first_bit:
            raise ValueError("cannot descend below a length mix-in")
        return _data_node(view, _strip_top(gindex, 1))
    return _data_node(view, gindex)


def _strip_top(gindex: int, levels: int) -> int:
    """Drop the top `levels` path bits of a generalized index."""
    length = get_generalized_index_length(gindex)
    if length < levels:
        raise ValueError("gindex too short")
    rest_len = length - levels
    return (1 << rest_len) | (gindex & ((1 << rest_len) - 1))


def _data_node(view, gindex: int) -> bytes:
    """Node within the data subtree (no length mix-in at this level)."""
    typ = type(view)
    if gindex == 1:
        if _has_length_mixin(typ):
            # data root of a list-like view
            chunks = _data_chunks(view)
            return _chunk_subtree_node(chunks, chunk_depth(_chunk_count(typ)), 1)
        return bytes(view.hash_tree_root())

    depth = chunk_depth(_chunk_count(typ))
    path_len = get_generalized_index_length(gindex)

    if path_len <= depth:
        chunks = _data_chunks(view)
        return _chunk_subtree_node(chunks, depth, gindex)

    # crosses below chunk level: descend into a composite child
    top = _top_bits(gindex, depth)
    rest = _strip_top(gindex, depth)
    child = _child_view(view, top)
    if child is None:
        # padding position: the chunk is a zero chunk; there is no tree
        # below it to descend into
        if rest == 1:
            return ZERO_HASHES[0]
        raise ValueError("gindex descends below a zero-padding chunk")
    return _node_of(child, rest)


def _top_bits(gindex: int, levels: int) -> int:
    """First `levels` path bits of the gindex as a chunk position."""
    length = get_generalized_index_length(gindex)
    return (gindex >> (length - levels)) - (1 << levels)


def _data_chunks(view) -> list[bytes]:
    """Bottom-layer chunks of the view's (data) merkleization."""
    typ = type(view)
    if isinstance(view, Container):
        return [bytes(view._values[n].hash_tree_root())
                for n in typ._field_names]
    if isinstance(view, (ByteVector, ByteList)):
        from .types import _bytes_to_chunks
        return _bytes_to_chunks(bytes(view))
    if isinstance(view, Bits):
        from .types import _bytes_to_chunks
        return _bytes_to_chunks(view._pack_bits())
    if isinstance(view, _Sequence):
        return view._elem_chunks()
    raise TypeError(f"no chunks for {typ}")


def _child_view(view, position: int):
    """Composite child at chunk `position`, or None if out of range."""
    if isinstance(view, Container):
        if position >= len(type(view)._field_names):
            return None
        return view._values[type(view)._field_names[position]]
    if isinstance(view, _Sequence) and not is_basic_type(view.ELEM_TYPE):
        if position >= len(view._elems):
            return None
        return view._elems[position]
    return None


def compute_merkle_proof(view, generalized_index: int) -> list[bytes]:
    """Sibling branch for `generalized_index`, ordered leaf-sibling first —
    directly consumable by is_valid_merkle_branch(leaf, branch, depth,
    get_subtree_index(gindex), root)."""
    branch = []
    g = generalized_index
    while g > 1:
        branch.append(_node_of(view, generalized_index_sibling(g)))
        g = generalized_index_parent(g)
    return branch
