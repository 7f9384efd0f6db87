"""RDF prefix handling + URL shortening + asciification.

Replaces ParseRdfPrefixes (operators/ParseRdfPrefixes.scala:12-28), ShortenUrls
(operators/ShortenUrls.scala:16-59, longest-prefix match via a squashed StringTrie)
and AsciifyTriples (operators/AsciifyTriples.scala:10-46).
"""

from __future__ import annotations

import unicodedata

from ..utils.trie import StringTrie


def parse_prefix_line(line: str) -> tuple[str, str] | None:
    """'@prefix ex: <http://example.org/> .' -> ('ex:', 'http://example.org/')."""
    line = line.strip()
    if not line.lower().startswith("@prefix"):
        return None
    rest = line[len("@prefix"):].strip()
    try:
        name, url_part = rest.split(None, 1)
    except ValueError:
        return None
    url_part = url_part.strip()
    if url_part.endswith("."):
        url_part = url_part[:-1].strip()
    if url_part.startswith("<") and url_part.endswith(">"):
        url_part = url_part[1:-1]
    return name, url_part


def build_prefix_trie(prefix_pairs) -> StringTrie:
    """Trie mapping URL -> short prefix name, squashed for fast longest-prefix hits."""
    trie = StringTrie()
    for name, url in prefix_pairs:
        trie[url] = name
    trie.squash()
    return trie


def shorten_term(term: str, trie: StringTrie, prefix_urls: dict[str, str]) -> str:
    """Replace the longest matching URL prefix inside an <IRI> term with its name."""
    if not (term.startswith("<") and term.endswith(">")):
        return term
    url = term[1:-1]
    name = trie.longest_prefix_value(url)
    if name is None:
        return term
    return name + url[len(prefix_urls[name]):]


def asciify(value: str) -> str:
    """Fold non-ASCII characters to 7-bit (AsciifyTriples semantics: best-effort
    transliteration, unmappable characters replaced)."""
    if value.isascii():
        return value
    decomposed = unicodedata.normalize("NFKD", value)
    stripped = "".join(ch for ch in decomposed if not unicodedata.combining(ch))
    return stripped.encode("ascii", "replace").decode("ascii")
