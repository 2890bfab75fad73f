"""Metafile IO for the OpenCV FileStorage YAML that the reference's metafiles use
(port of m3t_tpu/utils/yaml_io.py without OpenCV or PyYAML).

The reader takes what ``cv::FileStorage`` writes and the reference's metafiles hold: a
``%YAML:1.0`` (or ``%YAML 1.2``) header and ``---``, block maps and sequences nested by
indentation, flow sequences and maps (``[a, b]``, ``{a: 1}``) over one or more lines,
plain, single- and double-quoted scalars, ``#`` comments, and ``!!opencv-matrix`` maps
with ``rows``, ``cols``, ``dt`` and ``data``.  Scalars become int, float or str as
FileStorage types them (``true`` and ``false`` are 1 and 0, ``null`` is no value); a
matrix becomes a numpy array of its ``dt``.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np


class MetafileError(RuntimeError):
    pass


_INT = re.compile(r"[-+]?[0-9]+")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?")
_HEX = re.compile(r"[-+]?0[xX][0-9a-fA-F]+")
_WORDS = {"true": 1, "false": 0, "null": None}  # as FileStorage reads them
_SPECIAL = {".inf": np.inf, "+.inf": np.inf, "-.inf": -np.inf, ".nan": np.nan}
_DEPTHS = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16, "i": np.int32,
           "f": np.float32, "d": np.float64, "h": np.float16}
_MATRIX_TAG = "!!opencv-matrix"


def _scalar(text: str) -> Any:
    if text[:1] in "\"'":
        quote = text[0]
        if len(text) < 2 or text[-1] != quote:
            raise MetafileError(f"unterminated string {text}")
        body = text[1:-1]
        if quote == "'":
            return body.replace("''", "'")
        return re.sub(r"\\(.)", lambda m: {"n": "\n", "t": "\t"}.get(m[1], m[1]), body)
    if _INT.fullmatch(text):
        return int(text)
    if _HEX.fullmatch(text):
        return int(text, 16)
    if text in _WORDS:
        return _WORDS[text]
    if _FLOAT.fullmatch(text):
        return float(text)
    if text.lower() in _SPECIAL:
        return float(_SPECIAL[text.lower()])
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str) -> tuple[str, str] | None:
    """(key, rest) of 'key: rest' or 'key:' outside quotes, else None."""
    match = re.match(r"""("[^"]*"|'[^']*'|[^\s"'#\[\]{},][^:]*?)\s*:(\s+|$)""", text)
    if match is None:
        return None
    return str(_scalar(match[1])), text[match.end():].strip()


def _flow(text: str, pos: int = 0) -> tuple[Any, int]:
    """A flow collection or scalar starting at text[pos]; returns (value, end)."""
    while text[pos] == " ":
        pos += 1
    opener = text[pos]
    if opener in "[{":
        closer = "]" if opener == "[" else "}"
        items: Any = [] if opener == "[" else {}
        pos += 1
        while True:
            while pos < len(text) and text[pos] in " ,":
                pos += 1
            if pos >= len(text):
                raise MetafileError(f"unterminated flow collection {text}")
            if text[pos] == closer:
                return _finish(items), pos + 1
            if opener == "{":
                split = _split_key(text[pos:])
                if split is None:
                    raise MetafileError(f"bad flow map entry in {text}")
                key, _ = split
                pos = text.index(":", pos) + 1
                items[key], pos = _flow(text, pos)
            else:
                value, pos = _flow(text, pos)
                items.append(value)
    if opener in "\"'":
        end = text.index(opener, pos + 1) + 1
        return _scalar(text[pos:end]), end
    end = pos
    while end < len(text) and text[end] not in ",]}":
        end += 1
    return _scalar(text[pos:end].strip()), end


def _finish(value: Any) -> Any:
    """A map that is an opencv matrix becomes its numpy array."""
    if isinstance(value, dict) and {"rows", "cols", "dt", "data"} <= set(value):
        dt = str(value["dt"])
        channels = int(dt[:-1]) if len(dt) > 1 else 1
        if dt[-1] not in _DEPTHS:
            raise MetafileError(f"unsupported matrix type {dt}")
        data = np.asarray(value["data"], np.float64).astype(_DEPTHS[dt[-1]])
        shape = (int(value["rows"]), int(value["cols"])) + ((channels,) if channels > 1
                                                            else ())
        return data.reshape(shape)
    return value


class _Lines:
    def __init__(self, text: str):
        self.items = []  # (indent, content)
        for raw in text.splitlines():
            line = _strip_comment(raw).rstrip()
            content = line.lstrip(" ")
            if not content or content.startswith("%") or content in ("---", "..."):
                continue
            indent = len(line) - len(content)
            rest = content[1:].lstrip(" ")
            if content.startswith("- ") and rest[0] not in "[{\"'" and _split_key(rest):
                # '- key: value' opens a map whose keys line up under 'key'.
                self.items.append((indent, "-"))
                indent += len(content) - len(rest)
                content = rest
            self.items.append((indent, content))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else None

    def value(self, rest: str, indent: int) -> Any:
        """The value after 'key:' or '- ': inline, a flow collection that may run over
        the next lines, or a block nested deeper than indent."""
        if rest.startswith(_MATRIX_TAG):
            rest = rest[len(_MATRIX_TAG):].strip()
        if not rest:
            nxt = self.peek()
            if nxt is None or nxt[0] < indent or (nxt[0] == indent
                                                  and not nxt[1].startswith("- ")):
                return None
            return self.block(nxt[0])
        if rest[0] in "[{":
            while _depth(rest) > 0:
                if self.peek() is None:
                    raise MetafileError(f"unterminated flow collection {rest}")
                rest += " " + self.items[self.pos][1]
                self.pos += 1
            value, end = _flow(rest)
            if rest[end:].strip():
                raise MetafileError(f"trailing text after {rest[:end]}")
            return value
        return _scalar(rest)

    def block(self, indent: int) -> Any:
        first = self.peek()
        if first[1] == "-" or first[1].startswith("- "):
            items = []
            while (line := self.peek()) and line[0] == indent and (
                    line[1] == "-" or line[1].startswith("- ")):
                self.pos += 1
                items.append(self.value(line[1][1:].strip(), indent + 1))
            return items
        mapping: dict[str, Any] = {}
        while (line := self.peek()) and line[0] == indent:
            split = _split_key(line[1])
            if split is None:
                raise MetafileError(f"expected 'key: value', got {line[1]!r}")
            self.pos += 1
            key, rest = split
            mapping[key] = self.value(rest, indent)
        return _finish(mapping)


def _depth(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def open_yaml_file_storage(path: str) -> dict[str, Any]:
    """The top-level map of a FileStorage YAML file."""
    path = str(path)
    if not os.path.exists(path) or os.path.splitext(path)[1] != ".yaml":
        raise MetafileError(f"Could not find yaml file {path}")
    with open(path, encoding="utf-8") as f:
        lines = _Lines(f.read())
    if lines.peek() is None:
        return {}
    top = lines.block(lines.peek()[0])
    if lines.peek() is not None or not isinstance(top, dict):
        raise MetafileError(f"Could not open yaml file {path}")
    return top


def read_optional(fs: dict, name: str, default: Any = None) -> Any:
    value = fs.get(name)
    return default if value is None else value


def read_required(fs: dict, name: str) -> Any:
    value = fs.get(name)
    if value is None:
        raise MetafileError(f"Required parameter {name} missing in metafile")
    return value


def read_pose(fs: dict, name: str, default: np.ndarray | None = None) -> np.ndarray:
    """Read a 4x4 pose matrix (reference: ReadValueFromYaml(Transform3fA), common.cpp:216)."""
    value = fs.get(name)
    if value is None:
        return np.eye(4, dtype=np.float32) if default is None else np.asarray(default,
                                                                              np.float32)
    mat = np.asarray(value, np.float32)
    if mat.size != 16:
        raise MetafileError(f"Pose {name} must be a 4x4 matrix")
    return mat.reshape(4, 4)


def read_intrinsics(fs: dict, name: str = "intrinsics"):
    """Read an intrinsics map node (reference: ReadValueFromYaml(Intrinsics), common.cpp:201)."""
    from m3t_tpu_torch.common import Intrinsics

    node = fs.get(name)
    if not node:
        return None
    return Intrinsics(
        fu=float(node["f_u"]), fv=float(node["f_v"]), ppu=float(node["pp_x"]),
        ppv=float(node["pp_y"]), width=int(node["width"]), height=int(node["height"]))


def resolve_path(value: str, metafile_path: str, name: str | None = None, ext: str = "") -> str:
    """Apply the INFER_FROM_NAME convention and relative-path resolution.

    Reference: m3t/src/body.cpp:176-180 and equivalents in every LoadMetaData.
    """
    directory = os.path.dirname(os.path.abspath(str(metafile_path)))
    if value == "INFER_FROM_NAME":
        return os.path.join(directory, f"{name}{ext}")
    if not os.path.isabs(value):
        return os.path.join(directory, value)
    return value
