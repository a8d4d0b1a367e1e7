"""YAML configs without PyYAML, and the training CLI's config helpers.

The GPU machine has no PyYAML. Two readers give PyYAML's ``safe_load``
meaning to the subset this repository's files use, which covers every
config the JAX package writes (``yaml.safe_dump`` writes lists as block
sequences):

* :func:`read_yaml` reads a whole config: block mappings nested by
  indentation (spaces), flow maps ``{a: 1, b: x}`` and flow lists
  ``[240, 432]`` (nested, and spanning lines), block sequences (a key
  followed by ``- item`` lines, at its own indentation or deeper) whose
  items are scalars, flow lists or block sequences themselves
  (``- - 1``), and the scalars below. Anything else (mappings inside a
  sequence, anchors, tags, block scalars, tabs, multi-document files)
  raises ``ValueError``;
* :func:`read_flat_yaml` reads only the top-level scalar, flow-list and
  block-sequence keys of a file and skips nested blocks and flow maps:
  the reference ships its checkpoints with the training config they
  came from (``config.yaml``), whose nested ``datasets:`` / ``train:``
  blocks no model constructor reads. Its top-level flow lists hold
  scalars only.

Scalars: an int, a float (with a dot, as YAML 1.1 resolves it),
``true``/``false`` (and YAML 1.1's ``yes``/``no``/``on``/``off``),
``~``/``null`` (or nothing), a quoted or bare string. Comment lines,
``#`` comments after a value, and the document marker ``---`` are
skipped.

:func:`apply_yaml_over_args` is the inference CLI's ``--opt``;
:func:`merge_args_yaml`, :func:`prefix_paths` and
:func:`derive_model_tuples` are the training CLI's, as in
``fgt_tpu/utils/config.py`` (reference FGT/parse.py:6-76).
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional

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
            rest = [(n, _strip_comment(ln)) for n, ln in
                    enumerate(lines[i:], i) if _strip_comment(ln).strip()]
            nxt = rest[0][1] if rest else ""
            if _is_item(nxt.strip()):
                body = []
                for n, ln in rest:          # the sequence's lines
                    if ln[0] not in " \t-":
                        break
                    body.append(ln)
                    i = n + 1
                items, end = _read_sequence(body, 0, "read_flat_yaml")
                if end != len(body):
                    raise ValueError(f"read_flat_yaml: cannot read "
                                     f"{body[end]!r}")
                out[key] = items
            elif nxt[:1] not in (" ", "\t"):
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


def apply_yaml_over_args(args, opt_path: str | None):
    """The inference CLI's ``--opt`` (reference
    tool/video_inpainting.py:427-429; ``fgt_tpu/utils/config.py``): the
    YAML file's top-level keys win over the parsed flags, but only keys
    the namespace already has. Returns ``args``, changed in place."""
    if not opt_path:
        return args
    for k, v in read_flat_yaml(opt_path).items():
        if hasattr(args, k):
            setattr(args, k, v)
    return args


# ---------------- the whole-file reader ----------------

def _fail(line: str, why: str = "cannot read"):
    raise ValueError(f"read_yaml: {why} {line!r}")


def _closed(text: str) -> bool:
    """Whether the brackets of a flow collection balance (outside
    quotes)."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth == 0


class _Flow:
    """Recursive descent over one flow collection's text."""

    def __init__(self, text: str, line: str):
        self.text, self.line, self.i = text, line, 0

    def _skip(self):
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def _plain(self) -> str:
        start, quote = self.i, None
        while self.i < len(self.text):
            ch = self.text[self.i]
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"" and self.i == start:
                quote = ch
            elif ch in ",]}" or (ch == ":" and self.text[self.i + 1:self.i + 2]
                                  in (" ", "")):
                break
            self.i += 1
        return self.text[start:self.i].strip()

    def value(self):
        self._skip()
        ch = self.text[self.i:self.i + 1]
        if ch == "{":
            return self._collection("}", True)
        if ch == "[":
            return self._collection("]", False)
        return _scalar(self._plain(), self.line)

    def _collection(self, close: str, mapping: bool):
        self.i += 1
        out = {} if mapping else []
        while True:
            self._skip()
            if self.text[self.i:self.i + 1] == close:
                self.i += 1
                return out
            if mapping:
                key = _scalar(self._plain(), self.line)
                if self.text[self.i:self.i + 1] != ":":
                    _fail(self.line)
                self.i += 1
                out[key] = self.value()
            else:
                out.append(self.value())
            self._skip()
            ch = self.text[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != close:
                _fail(self.line)

    def parse(self):
        out = self.value()
        self._skip()
        if self.i != len(self.text):
            _fail(self.line)
        return out


def _indent(line: str) -> int:
    body = line.lstrip(" ")
    if body.startswith("\t"):
        _fail(line, "tab indentation in")
    return len(line) - len(body)


def _is_item(body: str) -> bool:
    """Whether a stripped line is a block-sequence item."""
    return body == "-" or body.startswith("- ")


def _read_sequence(lines: list, pos: int, who: str):
    """The block sequence whose first item is ``lines[pos]`` (lines
    stripped of comments, none blank): (its items, the index of the
    first line after it). An item is a scalar, a flow list (which may
    span lines) or a nested sequence (``- - 1``, its later items at the
    inner dash's column); a mapping, an empty item or anything
    ``_scalar`` refuses raises."""
    def fail(line, why="cannot read"):
        raise ValueError(f"{who}: {why} {line!r}")

    indent = _indent(lines[pos])
    out = []
    while pos < len(lines):
        line = lines[pos]
        body = line.strip()
        if _indent(line) != indent or not _is_item(body):
            if _indent(line) > indent:
                fail(line, "unexpected indentation at")
            break
        rest = body[1:].lstrip(" ")
        if not rest:
            fail(line, "an empty or nested block item at")
        if _is_item(rest):                 # "- - x": a nested sequence
            lines = list(lines)
            lines[pos] = " " * (len(line) - len(rest)) + rest
            item, pos = _read_sequence(lines, pos, who)
            out.append(item)
            continue
        pos += 1
        if rest[0] == "[":
            while not _closed(rest) and pos < len(lines):
                rest += " " + lines[pos].strip()
                pos += 1
            if not _closed(rest):
                fail(line, "unclosed flow collection at")
            out.append(_Flow(rest, line).parse())
        elif rest[0] == "{" or _KEY.match(rest):
            fail(line, "a mapping inside a sequence at")
        else:
            out.append(_scalar(rest, line))
    return out, pos


def read_yaml(path: str) -> dict:
    """The YAML file at ``path`` as ``yaml.safe_load`` reads it, for the
    subset in the module doc; an empty file reads as ``{}``."""
    with open(path) as f:
        raw = f.read().splitlines()
    lines = []
    for n, line in enumerate(raw):
        body = _strip_comment(line)
        if not body.strip():
            continue
        if body.strip() == "---":
            if lines:
                _fail(line, "a second document at")
            continue
        if body.strip() == "...":
            break
        lines.append(body)
    pos = 0

    def block(indent: int) -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(lines):
            line = lines[pos]
            ind = _indent(line)
            if ind < indent:
                break
            if ind > indent:
                _fail(line, "unexpected indentation at")
            body = line.strip()
            if _is_item(body):
                _fail(line, "a sequence item where a key belongs at")
            m = _KEY.match(body)
            if m is None:
                _fail(line)
            key, value = m.group(1), (m.group(2) or "").strip()
            pos += 1
            if not value:
                nxt = lines[pos] if pos < len(lines) else ""
                if nxt and _is_item(nxt.strip()) and _indent(nxt) >= indent:
                    out[key], pos = _read_sequence(lines, pos, "read_yaml")
                else:
                    out[key] = block(_indent(nxt)) if nxt and \
                        _indent(nxt) > indent else None
            elif value[0] in "[{":
                while not _closed(value) and pos < len(lines):
                    value += " " + lines[pos].strip()
                    pos += 1
                if not _closed(value):
                    _fail(line, "unclosed flow collection at")
                out[key] = _Flow(value, line).parse()
            else:
                out[key] = _scalar(value, line)
        return out

    out = block(_indent(lines[0]) if lines else 0)
    if pos != len(lines):
        _fail(lines[pos], "unexpected indentation at")
    return out


# ---------------- the training CLI's helpers ----------------

def merge_args_yaml(args: argparse.Namespace,
                    opt_path: Optional[str]) -> dict:
    """``{**vars(args), **yaml}`` — YAML wins (reference FGT/parse.py:28)."""
    cfg = dict(vars(args))
    if opt_path:
        cfg.update(read_yaml(opt_path))
    return cfg


def prefix_paths(data_info: dict, datadir: str) -> dict:
    """Prefix a root dir onto relative paths (reference parse.py:6-17)."""
    out = {}
    for k, v in data_info.items():
        if isinstance(v, dict):
            out[k] = prefix_paths(v, datadir)
        elif isinstance(v, str) and ("path" in k or "root" in k) \
                and not os.path.isabs(v):
            out[k] = os.path.join(datadir, v)
        else:
            out[k] = v
    return out


def derive_model_tuples(cfg: dict) -> dict:
    """Assemble the derived tuple params (reference FGT/train.py:63-66)."""
    cfg = dict(cfg)
    if "res_h" in cfg and "res_w" in cfg:
        cfg.setdefault("input_resolution", (cfg["res_h"], cfg["res_w"]))
    if "kernel_size_h" in cfg:
        cfg.setdefault("kernel_size", (cfg["kernel_size_h"],
                                       cfg["kernel_size_w"]))
    if "stride_h" in cfg:
        cfg.setdefault("stride", (cfg["stride_h"], cfg["stride_w"]))
    if "pad_h" in cfg:
        cfg.setdefault("padding", (cfg["pad_h"], cfg["pad_w"]))
    return cfg


def _dump_scalar(v) -> str:
    if v is None:
        return "~"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return {"nan": ".nan", "inf": ".inf", "-inf": "-.inf"}[repr(v)]
        mant, _, exp = repr(v).partition("e")
        if "." not in mant:
            mant += ".0"
        return f"{mant}e{exp if exp[0] in '+-' else '+' + exp}" if exp \
            else mant
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {_dump_scalar(x)}"
                               for k, x in v.items()) + "}"
    raise TypeError(f"dump_yaml: cannot write {type(v).__name__}")


def dump_yaml(data: dict, indent: int = 0) -> str:
    """YAML text of ``data`` that :func:`read_yaml` (and PyYAML) read
    back as ``data``: nested dicts as blocks, lists as flow lists,
    strings double-quoted (lists come back as lists)."""
    out = []
    for k, v in data.items():
        pad = " " * indent
        if isinstance(v, dict) and v:
            out.append(f"{pad}{k}:\n{dump_yaml(v, indent + 2)}")
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}\n")
    return "".join(out)
