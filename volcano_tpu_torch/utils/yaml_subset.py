"""A reader of the block-style YAML subset the port reads: the scheduler
conf, Job manifests (``vcctl job run -f``) and ``--cluster-state`` corpora.

The machine with the card has no PyYAML, so the port carries its own
reader instead of ``yaml.safe_load``: nested mappings and ``- ``
sequences (a sequence may sit at its key's indentation), plain and quoted
scalars, ``#`` comments, the empty flow collections ``[]`` and ``{}``,
and ``---`` between documents. Anything else (a non-empty flow
collection, anchors, tags, block scalars) raises ValueError. For the
documents it accepts, ``parse_yaml`` returns what ``yaml.safe_load`` does
and ``parse_yaml_all`` what ``list(yaml.safe_load_all(...))`` does.
"""

from __future__ import annotations

import json
import re
from typing import List

_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")
_EMPTY_FLOW = {"[": "]", "{": "}"}


def _strip_comment(text: str) -> str:
    """``text`` without a trailing `` #`` comment outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str):
    """A YAML scalar as PyYAML's safe loader types it: quoted strings,
    booleans (true/yes/on, false/no/off), null, ints, floats, the empty
    flow collections, else str."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if text[:1] in _EMPTY_FLOW and text[1:].strip() == _EMPTY_FLOW[text[0]]:
        return [] if text[0] == "[" else {}
    if text[:1] in ("{", "[", "&", "*", "!", "|", ">"):
        raise ValueError(f"unsupported YAML construct: {text!r}")
    low = text.lower()
    if low in _BOOLS:
        return _BOOLS[low]
    if low in ("", "~", "null"):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _key_value(text: str):
    """Split ``key: value`` at the first colon outside quotes that ends
    the line or is followed by a space; None when there is none."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return _scalar(text[:i]), text[i + 1:].strip()
    return None


def _document(lines):
    """One document's value from its ``[indent, text]`` lines."""

    def block(i, indent):
        if lines[i][1] == "-" or lines[i][1].startswith("- "):
            return seq(i, indent)
        if _key_value(lines[i][1]) is None:
            if i + 1 < len(lines) and lines[i + 1][0] > indent:
                raise ValueError(f"unsupported YAML line: {lines[i][1]!r}")
            return _scalar(lines[i][1]), i + 1
        return mapping(i, indent)

    def child(i, indent, parent_is_key):
        # the value block after a "key:" or a bare "-" at line i - 1
        if i < len(lines) and lines[i][0] > indent:
            return block(i, lines[i][0])
        if (parent_is_key and i < len(lines) and lines[i][0] == indent
                and (lines[i][1] == "-" or lines[i][1].startswith("- "))):
            return seq(i, indent)
        return None, i

    def seq(i, indent):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].lstrip(" ")
            if not rest:
                value, i = child(i + 1, indent, False)
            elif _key_value(rest) is not None:
                # a compact mapping: its first key sits after the dash
                lines[i] = [indent + len(lines[i][1]) - len(rest), rest]
                value, i = mapping(i, lines[i][0])
            else:
                value, i = _scalar(rest), i + 1
            out.append(value)
        return out, i

    def mapping(i, indent):
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            kv = _key_value(lines[i][1])
            if kv is None:
                raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
            key, rest = kv
            if rest:
                out[key], i = _scalar(rest), i + 1
            else:
                out[key], i = child(i + 1, indent, True)
        return out, i

    if not lines:
        return None
    value, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected YAML indentation at {lines[i][1]!r}")
    return value


def parse_yaml_all(text: str) -> List:
    """Every document of a ``---``-separated stream, as
    ``list(yaml.safe_load_all(text))`` gives them: content before the
    first ``---`` is a document only when it has any, and each ``---``
    opens one (None when it stays empty)."""
    docs, lines, explicit = [], [], False
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        body = _strip_comment(raw)
        if body == "---":
            if lines or explicit:
                docs.append(lines)
            lines, explicit = [], True
        elif body.startswith("---") or body.startswith("..."):
            raise ValueError(f"unsupported YAML document marker: {body!r}")
        elif body.strip():
            lines.append([len(body) - len(body.lstrip(" ")), body.strip()])
    if lines or explicit:
        docs.append(lines)
    return [_document(d) for d in docs]


def parse_yaml(text: str):
    """A single-document stream's value (None when it is empty), as
    ``yaml.safe_load`` gives it; ValueError on more than one document."""
    docs = parse_yaml_all(text)
    if len(docs) > 1:
        raise ValueError(f"expected one YAML document, found {len(docs)}")
    return docs[0] if docs else None
