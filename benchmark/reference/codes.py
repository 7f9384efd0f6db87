"""The 6-bit capture code algebra, restated for the reference.

Low 3 bits: the fields that carry the equality condition (subject 1,
predicate 2, object 4); high 3 bits: the projected field.  Every function is
integer arithmetic with operators only, so it works elementwise on Python
ints, numpy arrays and torch tensors alike.
"""

SUBJECT, PREDICATE, OBJECT = 1, 2, 4
FIELD_BITS = (SUBJECT, PREDICATE, OBJECT)
TYPE_MASK = 7
_CHAR = {SUBJECT: "s", PREDICATE: "p", OBJECT: "o"}


def create(primary_bits, projection_bit):
    return (primary_bits & TYPE_MASK) | ((projection_bit & TYPE_MASK) << 3)


def primary(code):
    return code & TYPE_MASK


def lowest_bit(x):
    return x & (-x)


def popcount3(x):
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1)


def is_unary(code):
    return popcount3(code & TYPE_MASK) == 1


def is_subcode(candidate, super_code):
    return (candidate & super_code) == candidate


def first_subcapture(code):
    """The unary code keeping the lowest condition field (same projection)."""
    return (code & ~TYPE_MASK) | lowest_bit(code & TYPE_MASK)


def second_subcapture(code):
    """The unary code keeping the second condition field."""
    first = lowest_bit(code & TYPE_MASK)
    return (code & ~TYPE_MASK) | lowest_bit((code & TYPE_MASK) & ~first)


def pretty(code: int, v1: str, v2: str | None) -> str:
    """``o[s=x]`` / ``o[s=x,p=y]``: the reference printer's capture form."""
    proj = _CHAR[(code >> 3) & TYPE_MASK]
    prim = code & TYPE_MASK
    first = prim & -prim
    second = (prim & ~first) & -(prim & ~first)
    if second == 0:
        return f"{proj}[{_CHAR[first]}={v1}]"
    return f"{proj}[{_CHAR[first]}={v1},{_CHAR[second]}={v2}]"
