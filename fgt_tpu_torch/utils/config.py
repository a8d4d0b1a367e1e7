"""A reader for the top-level scalar keys of a YAML config, without PyYAML.

The reference ships its LAFC and FGT checkpoints with the training config
they came from (``config.yaml``): a flat block of model hyperparameters
beside nested ``datasets:`` / ``train:`` blocks that no model builder
reads. The GPU machine has no PyYAML, so :func:`read_flat_yaml` reads the
part the builders need, with PyYAML's ``safe_load`` meaning for it:

* ``key: value`` lines at column 0, the value an int, a float (with a
  dot, as YAML 1.1 resolves it), ``true``/``false`` (and YAML 1.1's
  ``yes``/``no``/``on``/``off``), ``~``/``null`` (or nothing, where no
  indented block follows), a quoted or bare string, or a flow list such
  as ``[240, 432]``;
* comment lines, ``#`` comments after a value, and the document marker
  ``---`` are skipped;
* a key opening a nested block (nothing after the colon) or a flow map
  (``{...}``) is skipped with its indented lines.

Anything else at the top level raises ``ValueError``, rather than being
read differently from PyYAML.
"""

from __future__ import annotations

import json
import re

_KEY = re.compile(r"^([A-Za-z_][\w\-.]*)\s*:(?:\s+(.*))?$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_OCTAL_OR_BINARY = re.compile(r"^[-+]?0(?:b[01_]+|[0-7_]+)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_NULL = {"~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_UNREAD = tuple("&*!|>@`%")   # anchors, aliases, tags, block scalars, ...


def _strip_comment(text: str) -> str:
    """``text`` without a `` #`` comment outside quotes."""
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


def _scalar(text: str, line: str):
    text = text.strip()
    if text.startswith(_UNREAD) or text.startswith(("{", "[")):
        raise ValueError(f"read_flat_yaml: cannot read {line!r}")
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    if text[:1] in "'\"":
        raise ValueError(f"read_flat_yaml: cannot read {line!r}")
    if text in _NULL or text == "":
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        return int(text.replace("_", ""), 16)
    if _OCTAL_OR_BINARY.match(text):
        raise ValueError(f"read_flat_yaml: cannot read {line!r}")
    if _FLOAT.match(text) and text.strip("+-.") != "":
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _flow_list(text: str, line: str) -> list:
    inner = text[1:-1].strip()
    if "[" in inner or "{" in inner:
        raise ValueError(f"read_flat_yaml: cannot read {line!r}")
    return [] if not inner else [_scalar(v, line) for v in inner.split(",")]


def read_flat_yaml(path: str) -> dict:
    """The top-level scalar and flow-list keys of the YAML file at
    ``path`` (see the module doc)."""
    with open(path) as f:
        lines = f.read().splitlines()
    out: dict = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        body = line.strip()
        if not body or body.startswith("#") or line[0] in " \t":
            continue                       # blank, comment, nested line
        if body == "---":
            continue
        if body == "...":
            break
        m = _KEY.match(_strip_comment(line))
        if m is None:
            raise ValueError(f"read_flat_yaml: cannot read {line!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if not value:
            nxt = next((ln for ln in lines[i:] if ln.strip()
                        and not ln.strip().startswith("#")), "")
            if nxt[:1] not in (" ", "\t", "-"):
                out[key] = None            # an empty value is null
            continue                       # else a nested block
        if value.startswith("{"):
            continue                       # a flow map
        if value.startswith("["):
            while not value.endswith("]") and i < len(lines):
                value += " " + _strip_comment(lines[i]).strip()
                i += 1
            if not value.endswith("]"):
                raise ValueError(f"read_flat_yaml: unclosed list {line!r}")
            out[key] = _flow_list(value, line)
        else:
            out[key] = _scalar(value, line)
    return out
