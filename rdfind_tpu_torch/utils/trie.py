"""Path-squashed string trie for longest-prefix matching.

Semantics follow the reference's StringTrie (util/StringTrie.scala:8-118, tested by
StringTrie$Test.scala): insert key/value pairs, optionally squash chains, and look up
the value of the longest key that prefixes a query string.
"""

from __future__ import annotations


class _Node:
    __slots__ = ("edge", "children", "value", "has_value")

    def __init__(self, edge: str = ""):
        self.edge = edge  # squashed edge label leading INTO this node
        self.children: dict[str, _Node] = {}
        self.value = None
        self.has_value = False


class StringTrie:
    """Trie over strings; `longest_prefix_value(q)` finds the value of the longest
    inserted key that is a prefix of q (None if no key matches)."""

    def __init__(self):
        self._root = _Node()

    def __setitem__(self, key: str, value) -> None:
        node = self._root
        for ch in key:
            node = node.children.setdefault(ch, _Node(ch))
        node.value = value
        node.has_value = True

    def squash(self) -> None:
        """Collapse single-child, valueless chains (the reference's squash());
        lookups work identically before and after."""

        def squash_node(node: _Node) -> None:
            for key, child in list(node.children.items()):
                while len(child.children) == 1 and not child.has_value:
                    (only,) = child.children.values()
                    only.edge = child.edge + only.edge
                    child = only
                node.children[key] = child
                squash_node(child)

        squash_node(self._root)

    def longest_prefix_value(self, query: str):
        node = self._root
        best = self._root.value if self._root.has_value else None
        i = 0
        n = len(query)
        while i < n:
            child = node.children.get(query[i])
            if child is None:
                break
            edge = child.edge
            if len(edge) > 1:
                if not query.startswith(edge, i):
                    break
                i += len(edge)
            else:
                i += 1
            node = child
            if node.has_value:
                best = node.value
        return best
