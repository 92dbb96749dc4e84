"""Two-tier config system: YAML compose + CLI overrides.  Port of
``opadpo_tpu/pipeline/config.py``.

- ``load_config("configs/llava_dpo.yaml")`` reads a file and resolves its
  ``defaults:`` list (relative names or ``{group: name}`` entries, later
  entries win, ``_self_`` marks the file's own position);
- ``apply_overrides`` sets dotted paths from ``key.path=value`` strings,
  each value read as a YAML scalar;
- ``save_config`` writes the composed config to ``OUTPUT_DIR/config.yaml``.

YAML is read and written by this module's own subset of the language, on
every machine (the GPU machine has no PyYAML): block mappings and
sequences, ``- key: value`` items, flow ``[...]`` / ``{...}`` collections
of scalars, comments, single- and double-quoted strings, and plain scalars
resolved as YAML 1.1 / PyYAML's ``safe_load`` resolves them (null, bools
such as ``yes`` / ``off``, ints, floats with a dot such as ``1.0e-6``;
``1e-6`` stays a string there too).  Block literals (``|``, ``>``),
anchors and tags raise ``ValueError``.
"""

from __future__ import annotations

import copy
import math
import os
import re
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# The YAML subset
# ---------------------------------------------------------------------------

_BOOLS = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
          "NO": False, "true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False, "on": True,
          "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULLS = {"", "~", "null", "Null", "NULL"}
_INT_RE = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)"
                     r"|0x[0-9a-fA-F_]+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _resolve(text: str) -> Any:
    """A plain scalar as PyYAML's resolver reads it."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT_RE.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
        if v.endswith("inf"):
            return -math.inf if v[0] == "-" else math.inf
        if v.endswith("nan"):
            return math.nan
        return float(v)
    if text[:1] in "&*!|>%@`":
        raise ValueError(f"YAML feature not supported: {text!r}")
    return text


def _split_top(text: str, sep: str) -> List[str]:
    """``text`` split at ``sep`` outside quotes and brackets."""
    parts, depth, quote, cur = [], 0, None, []
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
        elif ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def _key_split(text: str) -> Optional[tuple]:
    """(key, rest) of ``key: rest`` / ``key:``, outside quotes, or None."""
    quote, depth = None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif (ch == ":" and depth == 0
              and (i + 1 == len(text) or text[i + 1] == " ")):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _double_quoted(body: str) -> str:
    escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/",
               "0": "\0", "r": "\r"}
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            nxt = body[i + 1]
            if nxt not in escapes:
                raise ValueError(f"YAML escape \\{nxt} not supported")
            out.append(escapes[nxt])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _scalar(text: str) -> Any:
    """A flow value: a quoted string, a flow collection or a plain
    scalar."""
    t = text.strip()
    if t[:1] == '"':
        if len(t) < 2 or t[-1] != '"':
            raise ValueError(f"unterminated string {t!r}")
        return _double_quoted(t[1:-1])
    if t[:1] == "'":
        if len(t) < 2 or t[-1] != "'":
            raise ValueError(f"unterminated string {t!r}")
        return t[1:-1].replace("''", "'")
    if t[:1] == "[":
        if t[-1] != "]":
            raise ValueError(f"unterminated flow sequence {t!r}")
        inner = t[1:-1].strip()
        return [_scalar(p) for p in _split_top(inner, ",")] if inner else []
    if t[:1] == "{":
        if t[-1] != "}":
            raise ValueError(f"unterminated flow mapping {t!r}")
        inner = t[1:-1].strip()
        out = {}
        for part in (_split_top(inner, ",") if inner else []):
            kv = _key_split(part.strip())
            if kv is None:
                out[_scalar(part)] = None
            else:
                out[_scalar(kv[0])] = _scalar(kv[1]) if kv[1] else None
        return out
    return _resolve(t)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :-[{,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _lines(text: str) -> List[list]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        out.append([len(line) - len(line.lstrip(" ")), line.strip()])
    return out


def _block(lines: List[list], i: int):
    """The node whose lines start at ``lines[i]`` (at that line's
    indentation) -> (node, index of the first line after it)."""
    ind, text = lines[i]
    if text == "-" or text.startswith("- "):
        seq = []
        while i < len(lines) and lines[i][0] == ind and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:]
            if not rest.strip():
                if i + 1 < len(lines) and lines[i + 1][0] > ind:
                    node, i = _block(lines, i + 1)
                else:
                    node, i = None, i + 1
            else:
                # "- key: v" opens a mapping at the item's column
                col = ind + 1 + len(rest) - len(rest.lstrip(" "))
                lines[i] = [col, rest.strip()]
                node, i = _block(lines, i)
            seq.append(node)
        return seq, i
    if _key_split(text) is None:
        if i + 1 < len(lines) and lines[i + 1][0] >= ind:
            raise ValueError(f"multi-line plain scalar not supported: "
                             f"{text!r}")
        return _scalar(text), i + 1
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == ind:
        kv = _key_split(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = _scalar(kv[0]), kv[1]
        i += 1
        if rest:
            if rest[:1] in "|>":
                raise ValueError(f"block literal not supported: {rest!r}")
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > ind or (
                lines[i][0] == ind and (lines[i][1] == "-"
                                        or lines[i][1].startswith("- ")))):
            out[key], i = _block(lines, i)
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > ind:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def parse_yaml(text: str) -> Any:
    """A YAML document of the supported subset -> Python objects (what
    ``yaml.safe_load`` gives for it; None for an empty document)."""
    lines = _lines(text)
    if not lines:
        return None
    node, i = _block(lines, 0)
    if i != len(lines):
        raise ValueError(f"unexpected line {lines[i][1]!r}")
    return node


def _format_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r.split("e")[0]:
            mant, exp = r.split("e")
            r = f"{mant}.0e{exp if exp[0] in '+-' else '+' + exp}"
        return r
    s = str(v)
    plain = (s and s == s.strip() and s[0] not in _INDICATORS
             and ": " not in s and " #" not in s and "\n" not in s
             and not s.endswith(":") and isinstance(_resolve_safe(s), str))
    if plain:
        return s
    if "\n" in s or "\\" in s:
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace(
            "\n", "\\n").replace("\t", "\\t") + '"'
    return "'" + s.replace("'", "''") + "'"


def _resolve_safe(s: str) -> Any:
    try:
        return _resolve(s)
    except ValueError:
        return None


def _emit(node: Any, indent: int) -> List[str]:
    pad = " " * indent
    out = []
    if isinstance(node, dict):
        for k, v in node.items():
            key = _format_scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                out += _emit(v, indent + 2)
            elif isinstance(v, list) and v:
                out.append(f"{pad}{key}:")
                out += _emit(v, indent + 2)
            elif isinstance(v, (dict, list)):
                empty = "{}" if isinstance(v, dict) else "[]"
                out.append(f"{pad}{key}: {empty}")
            else:
                out.append(f"{pad}{key}: {_format_scalar(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}-")
                out += _emit(v, indent + 2)
            elif isinstance(v, (dict, list)):
                out.append(f"{pad}- {'{}' if isinstance(v, dict) else '[]'}")
            else:
                out.append(f"{pad}- {_format_scalar(v)}")
    return out


def dump_yaml(node: Any) -> str:
    """Nested dicts / lists of scalars -> block YAML that ``parse_yaml``
    (and ``yaml.safe_load``) read back as the same objects."""
    if isinstance(node, (dict, list)) and node:
        return "\n".join(_emit(node, 0)) + "\n"
    if isinstance(node, (dict, list)):
        return ("{}" if isinstance(node, dict) else "[]") + "\n"
    return _format_scalar(node) + "\n"


# ---------------------------------------------------------------------------
# Config composition
# ---------------------------------------------------------------------------

class Config(dict):
    """dict with attribute access + dotted-path get/set."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) \
            else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Dict = self
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_yaml(path: str) -> Dict:
    with open(path) as f:
        return parse_yaml(f.read()) or {}


def load_config(path: str) -> Config:
    """Load a YAML file, resolving its ``defaults:`` list (Hydra-lite)."""
    raw = _load_yaml(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    defaults: List = raw.pop("defaults", [])
    merged: Dict = {}
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, raw)
            self_seen = True
            continue
        if isinstance(entry, dict):
            # config-group entry like {checkpoints: llava-7b-v1.5}
            (group, name), = entry.items()
            group = str(group).replace("override ", "")
            sub = os.path.join(base_dir, group, f"{name}.yaml")
        else:
            sub = os.path.join(base_dir, f"{entry}.yaml")
        merged = _deep_merge(merged, dict(load_config(sub)))
    if not self_seen:
        merged = _deep_merge(merged, raw)
    return Config(merged)


def _parse_value(text: str) -> Any:
    try:
        return parse_yaml(text)
    except ValueError:
        return text


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``key.path=value`` strings (reference override_config role)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split("=", 1)
        cfg.set_path(key.strip().lstrip("-"), _parse_value(value))
    return cfg


def save_config(cfg: Config, output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        f.write(dump_yaml(_plain(cfg)))


def _plain(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return node


def env_or(cfg_value: Optional[str], env_key: str,
           default: Optional[str] = None) -> Optional[str]:
    """Env vars carry paths/secrets in the reference (DATA_DIR, IMAGE_DIR,
    OUTPUT_DIR, API_KEY{i})."""
    return cfg_value or os.environ.get(env_key, default)
