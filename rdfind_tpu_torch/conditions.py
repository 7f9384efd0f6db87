"""The 6-bit capture/condition code algebra.

A *capture* is a projection of one RDF triple field under an equality condition on one
or two of the other fields, e.g. ``o[p=birthPlace]`` ("all objects of triples whose
predicate is birthPlace").  Capture codes pack this shape into 6 bits:

  * low 3 bits ("primary conditions"): which fields carry the equality condition
    (subject=1, predicate=2, object=4);
  * high 3 bits ("secondary conditions"): which field is projected.

Every function is branch-free integer arithmetic written with operators only, so it
works elementwise on Python ints, numpy arrays and torch integer tensors alike.  The
same rules are restated in C in ``csrc/fused_cind.cu`` (the verdict epilogue).
"""

SUBJECT = 1
PREDICATE = 2
OBJECT = 4
NUM_TYPE_BITS = 3
TYPE_MASK = 7

_CODE_TO_CHAR = {SUBJECT: "s", PREDICATE: "p", OBJECT: "o"}

# Field index (0=s, 1=p, 2=o) for each single-bit code.
FIELD_INDEX = {SUBJECT: 0, PREDICATE: 1, OBJECT: 2}


def primary(code):
    """The condition-field bits of a code."""
    return code & TYPE_MASK


def secondary(code):
    """The projection-field bits of a code."""
    return (code >> NUM_TYPE_BITS) & TYPE_MASK


def lowest_bit(x):
    """Lowest set bit of x (0 if x == 0)."""
    return x & (-x)


def popcount3(x):
    """Number of set bits among the low 3 bits."""
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1)


def decode(code):
    """Split a code's primary bits into (first, second, free) single-bit codes."""
    first = lowest_bit(code & TYPE_MASK)
    second = lowest_bit((code & TYPE_MASK) & ~first)
    free = ~first & ~second & TYPE_MASK
    return first, second, free


def create(first_primary, second_primary=0, secondary_condition=0):
    return ((first_primary | second_primary) & TYPE_MASK) | (
        (secondary_condition & TYPE_MASK) << NUM_TYPE_BITS
    )


def is_subcode(candidate, super_code):
    return (candidate & super_code) == candidate


def is_binary(code):
    """True when the code has exactly 2 condition fields."""
    return popcount3(code & TYPE_MASK) == 2


def is_unary(code):
    """True when the code has exactly 1 condition field."""
    return popcount3(code & TYPE_MASK) == 1


def remove_primary(capture_code):
    return capture_code & ~TYPE_MASK


def first_subcapture(capture_code):
    """Unary capture code keeping only the lowest condition field (same projection)."""
    return remove_primary(capture_code) | lowest_bit(capture_code & TYPE_MASK)


def second_subcapture(capture_code):
    """Unary capture code keeping only the second condition field (same projection)."""
    first = lowest_bit(capture_code & TYPE_MASK)
    return remove_primary(capture_code) | lowest_bit((capture_code & TYPE_MASK) & ~first)


def pretty(capture_code, value1, value2=None):
    """Human-readable capture, e.g. ``o[s=x,p=y]`` (the reference's printer)."""
    proj = _CODE_TO_CHAR.get(secondary(capture_code), "")
    first, second, _ = decode(primary(capture_code))
    if second == 0:
        return f"{proj}[{_CODE_TO_CHAR[first]}={value1}]"
    return f"{proj}[{_CODE_TO_CHAR[first]}={value1},{_CODE_TO_CHAR[second]}={value2}]"
