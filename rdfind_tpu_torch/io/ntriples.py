"""N-Triples / N-Quads line parsing.

Replaces the reference's rdf-converter NTriplesParser/NQuadsParser dependency
(RDFind.scala:219-237): each line yields 3 raw term tokens (subject, predicate,
object); N-Quads' 4th term (graph) is parsed and dropped, like the reference which
only keeps fields 0..2.  Tokens keep their surface syntax (<iri>, _:blank,
"literal"^^<type>, "literal"@lang) — CIND discovery only needs consistent equality,
and keeping tokens verbatim is lossless.

A tab-separated mode mirrors the reference's --tabs flag (NTriplesParser('\\t')).
"""

from __future__ import annotations


class ParseError(ValueError):
    pass


def _scan_term(line: str, i: int, n: int) -> tuple[str, int]:
    """Scan one term starting at non-space position i; returns (token, next_index)."""
    c = line[i]
    if c == "<":  # IRI
        j = line.find(">", i + 1)
        if j < 0:
            raise ParseError(f"unterminated IRI: {line!r}")
        return line[i:j + 1], j + 1
    if c == '"':  # literal with escapes, optional @lang / ^^<dtype>
        j = i + 1
        while j < n:
            if line[j] == "\\":
                j += 2
                continue
            if line[j] == '"':
                break
            j += 1
        if j >= n:
            raise ParseError(f"unterminated literal: {line!r}")
        j += 1  # past closing quote
        if j < n and line[j] == "@":  # language tag
            while j < n and line[j] not in " \t":
                j += 1
        elif line.startswith("^^", j):
            j += 2
            if j < n and line[j] == "<":
                k = line.find(">", j + 1)
                if k < 0:
                    raise ParseError(f"unterminated datatype IRI: {line!r}")
                j = k + 1
        return line[i:j], j
    # blank node or other token: read to whitespace
    j = i
    while j < n and line[j] not in " \t":
        j += 1
    return line[i:j], j


def parse_line(line: str, expect_quad: bool = False) -> tuple[str, str, str] | None:
    """Parse one N-Triples (or N-Quads) line into (s, p, o); None for blank lines."""
    n = len(line)
    i = 0
    terms = []
    while i < n and len(terms) < (4 if expect_quad else 3):
        while i < n and line[i] in " \t":
            i += 1
        if i >= n or line[i] == ".":
            break
        tok, i = _scan_term(line, i, n)
        terms.append(tok)
    if not terms:
        return None
    if len(terms) < 3:
        raise ParseError(f"expected 3 terms, got {len(terms)}: {line!r}")
    return terms[0], terms[1], terms[2]


def parse_tab_line(line: str) -> tuple[str, str, str] | None:
    """Tab-separated triple line (--tabs mode)."""
    if not line.strip():
        return None
    parts = line.rstrip("\r\n").split("\t")
    if len(parts) < 3:
        raise ParseError(f"expected 3 tab-separated fields: {line!r}")
    return parts[0], parts[1], parts[2]
