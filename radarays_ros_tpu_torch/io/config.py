"""YAML configuration IO: scene/material configs + tuned parameter presets
(counterpart of radarays_ros_tpu/io/config.py).

Reads and writes the reference's three on-disk formats:

  1. structured scene config (config/oru4_test.yaml, mulran_kaist02.yaml):
     a `materials:` list of {velocity, ambient, diffuse, specular} dicts,
     `material_id_air` and the `object_materials` object->material map;
  2. parallel-array scene config (config/oru3.yaml, oru4.yaml): separate
     `velocities:` / `ambient:` / `diffuse:` / `specular:` arrays (and the
     velocity-table-only config/radar.yaml);
  3. dynamic_reconfigure preset dumps (cfg/*_dyncfg*.yaml): `rosparam dump`
     output whose `!!python/object/new:dynamic_reconfigure.encoding.Config`
     tags carry the flat parameter dict under `dictitems`.

The port runs where PyYAML may be absent, so this module carries its own
reader and writer for the subset those formats use, with PyYAML's (YAML
1.1) scalar rules: block mappings and sequences (a sequence may sit at its
key's indentation, as PyYAML writes it), flow lists `[...]`, the empty flow
mapping `{}`, plain and quoted scalars (int, float, bool, null, string),
anchors and aliases, and the `!!python/object/new:` / `!!python/object:`
tags, flattened to their `dictitems` mapping as the reference's
`_config_tag` does. Anything else raises `YamlSubsetError` naming the file
and line; nothing is guessed. Files written here load to equal values
under the reference's PyYAML loader, and the other way round
(tests/test_torch_io.py).
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np

from radarays_ros_tpu_torch.sim.config import (Materials, RadarModelConfig,
                                               RadarParams)


class YamlSubsetError(ValueError):
    """A YAML construct outside the subset this module reads or writes."""


# ---------------------------------------------------------------- scalars
# PyYAML's implicit resolvers (resolver.py, YAML 1.1)

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                          |\.[0-9_]+(?:[eE][-+][0-9]+)?
                          |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                          |[-+]?\.(?:inf|Inf|INF)
                          |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                        |[-+]?0[0-7_]+
                        |[-+]?(?:0|[1-9][0-9_]*)
                        |[-+]?0x[0-9a-fA-F_]+
                        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP_RE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _sexagesimal(sign: int, text: str, conv):
    value = 0
    for part in text.split(":"):
        value = value * 60 + conv(part)
    return sign * value


def _resolve_plain(text: str, where: str):
    """A plain scalar -> Python value under PyYAML's implicit rules."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        if t[0] in "+-":
            t = t[1:]
        if t == "0":
            return 0
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t[0] == "0":
            return sign * int(t, 8)
        if ":" in t:
            return _sexagesimal(sign, t, int)
        return sign * int(t)
    if _FLOAT_RE.match(text):
        t = text.replace("_", "").lower()
        sign = -1.0 if t[0] == "-" else 1.0
        if t[0] in "+-":
            t = t[1:]
        if t == ".inf":
            return sign * math.inf
        if t == ".nan":
            return math.nan
        if ":" in t:
            return _sexagesimal(sign, t, float)
        return sign * float(t)
    if text == "<<" or text == "=" or _TIMESTAMP_RE.match(text):
        raise YamlSubsetError(f"{where}: unsupported scalar {text!r} "
                              "(merge keys, value keys and timestamps)")
    if text[0] in "!&*|>%@`{}[],?\"'":
        raise YamlSubsetError(f"{where}: unsupported syntax in {text!r}")
    return text


_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _quoted(text: str, where: str) -> str:
    """The value of a one-line quoted scalar that spans all of `text`."""
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise YamlSubsetError(f"{where}: unterminated or multi-line quoted "
                              f"scalar {text!r}")
    body = text[1:-1]
    if q == "'":
        if "'" in body.replace("''", ""):
            raise YamlSubsetError(f"{where}: stray quote in {text!r}")
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == '"':
            raise YamlSubsetError(f"{where}: stray quote in {text!r}")
        if c != "\\":
            out.append(c)
            i += 1
            continue
        nxt = body[i + 1:i + 2]
        if nxt in _DQ_ESCAPES:
            out.append(_DQ_ESCAPES[nxt])
            i += 2
        elif nxt in ("x", "u", "U"):
            n = {"x": 2, "u": 4, "U": 8}[nxt]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise YamlSubsetError(f"{where}: unsupported escape in {text!r}")
    return "".join(out)


def _scalar(text: str, where: str):
    if text[:1] in ("'", '"'):
        return _quoted(text, where)
    return _resolve_plain(text, where)


# ---------------------------------------------------------------- reader

def _strip_comment(line: str) -> str:
    """`line` without a trailing comment (a # at the start or after
    whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1            # '' is a quote inside the scalar
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1                # an escaped character
            elif c == '"':
                quote = None
        elif c in ("'", '"') and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a `key: rest` mapping entry, else None."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"') and i == 0:
            quote = c
        elif c == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


def _split_flow(body: str, where: str) -> List[str]:
    parts, depth, quote, start = [], 0, None, 0
    for i, c in enumerate(body):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        elif c in "{}":
            raise YamlSubsetError(f"{where}: flow mappings inside flow lists "
                                  "are not supported")
        elif c == "," and depth == 0:
            parts.append(body[start:i].strip())
            start = i + 1
    last = body[start:].strip()
    if last or parts:
        parts.append(last)
    if parts and parts[-1] == "":
        parts.pop()               # a trailing comma
    if any(p == "" for p in parts):
        raise YamlSubsetError(f"{where}: empty entry in a flow list")
    return parts


def _flow_value(text: str, where: str):
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: multi-line flow lists are not "
                                  "supported")
        return [_flow_value(p, where) for p in _split_flow(text[1:-1], where)]
    if text.startswith("{"):
        if text.replace(" ", "") == "{}":
            return {}
        raise YamlSubsetError(f"{where}: non-empty flow mappings are not "
                              "supported")
    return _scalar(text, where)


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines = []       # [indent, content, line number]
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YamlSubsetError(f"{name}:{no}: tab indentation")
            line = _strip_comment(raw).rstrip()
            body = line.lstrip(" ")
            if not body:
                continue
            if body in ("---", "...") or body.startswith("--- ") \
                    or body.startswith("%"):
                if body.startswith("%") or len(self.lines) or body != "---":
                    raise YamlSubsetError(
                        f"{name}:{no}: directives and multiple documents "
                        "are not supported")
                continue
            self.lines.append([len(line) - len(body), body, no])
        self.anchors = {}

    def where(self, i: int) -> str:
        return f"{self.name}:{self.lines[i][2] if i < len(self.lines) else 'end'}"

    def document(self):
        if not self.lines:
            return None
        value, i = self.node(0, self.lines[0][0])
        if i != len(self.lines):
            raise YamlSubsetError(f"{self.where(i)}: unexpected content "
                                  "(wrong indentation?)")
        return value

    def node(self, i: int, indent: int):
        """The block node starting at line i (at indentation `indent`)."""
        ind, text, _ = self.lines[i]
        if text == "-" or text.startswith("- "):
            return self.sequence(i, ind)
        if _split_key(text) is not None and text[0] not in "!&*[{":
            return self.mapping(i, ind)
        return self.inline(text, i + 1, indent - 1, self.where(i))

    def mapping(self, i: int, ind: int):
        out = {}
        while i < len(self.lines) and self.lines[i][0] == ind \
                and not (self.lines[i][1] == "-"
                         or self.lines[i][1].startswith("- ")):
            text = self.lines[i][1]
            where = self.where(i)
            kv = _split_key(text)
            if kv is None or text.startswith("? "):
                raise YamlSubsetError(f"{where}: expected `key: value`, got "
                                      f"{text!r}")
            key = _scalar(kv[0], where)
            out[key], i = self.inline(kv[1], i + 1, ind, where,
                                      same_indent_seq=True)
        if i < len(self.lines) and self.lines[i][0] > ind:
            raise YamlSubsetError(f"{self.where(i)}: unexpected indentation")
        return out, i

    def sequence(self, i: int, ind: int):
        out = []
        while i < len(self.lines) and self.lines[i][0] == ind and (
                self.lines[i][1] == "-" or self.lines[i][1].startswith("- ")):
            text = self.lines[i][1]
            item = text[1:].lstrip(" ")
            if item and (item == "-" or item.startswith("- ")
                         or (_split_key(item) is not None
                             and item[0] not in "!&*[{")):
                # a compact nested block: re-read this line at its column
                self.lines[i] = [ind + len(text) - len(item), item,
                                 self.lines[i][2]]
                value, i = self.node(i, self.lines[i][0])
            else:
                value, i = self.inline(item, i + 1, ind, self.where(i))
            out.append(value)
        if i < len(self.lines) and self.lines[i][0] > ind:
            raise YamlSubsetError(f"{self.where(i)}: unexpected indentation")
        return out, i

    def inline(self, text: str, i: int, parent: int, where: str,
               same_indent_seq: bool = False):
        """The value written after `key:` or `- ` (text), whose nested
        block (if any) starts at line i, deeper than `parent`."""
        anchor = tag = None
        while text[:1] in ("&", "!"):
            head, _, text = text.partition(" ")
            text = text.strip()
            if head[0] == "&":
                anchor = head[1:]
            else:
                tag = head
        if text.startswith("*"):
            if anchor or tag:
                raise YamlSubsetError(f"{where}: properties on an alias")
            if text[1:] not in self.anchors:
                raise YamlSubsetError(f"{where}: unknown alias {text!r}")
            return self.anchors[text[1:]], i
        if text:
            if text[:1] in ("|", ">"):
                raise YamlSubsetError(f"{where}: block scalars are not "
                                      "supported")
            value = _flow_value(text, where)
            if i < len(self.lines) and self.lines[i][0] > parent \
                    and parent >= 0:
                raise YamlSubsetError(f"{self.where(i)}: multi-line plain "
                                      "scalars are not supported")
        elif i < len(self.lines) and (
                self.lines[i][0] > parent
                or (same_indent_seq and self.lines[i][0] == parent
                    and (self.lines[i][1] == "-"
                         or self.lines[i][1].startswith("- ")))):
            value, i = self.node(i, self.lines[i][0])
        else:
            value = None
        if tag is not None:
            value = self._apply_tag(tag, value, where)
        if anchor is not None:
            self.anchors[anchor] = value
        return value, i

    def _apply_tag(self, tag: str, value, where: str):
        if tag.startswith("!!python/object/new:") \
                or tag.startswith("!!python/object:"):
            if not isinstance(value, dict):
                raise YamlSubsetError(f"{where}: {tag} on a non-mapping")
            return value.get("dictitems", value)
        if tag in ("!!str", "!!int", "!!float", "!!bool", "!!null") \
                and not isinstance(value, (dict, list)):
            raise YamlSubsetError(f"{where}: explicit scalar tags are not "
                                  "supported")
        raise YamlSubsetError(f"{where}: unsupported tag {tag}")


def parse_yaml(text: str, name: str = "<string>") -> Any:
    """Parse YAML text of the supported subset (module doc)."""
    return _Reader(text, name).document()


def load_yaml(path) -> Any:
    return parse_yaml(Path(path).read_text(), str(path))


# ---------------------------------------------------------------- writer

# characters that may not start a plain scalar (an empty string is quoted)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`") | {""}


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        # PyYAML's represent_float (float() drops a numpy subclass, whose
        # repr is not a YAML scalar)
        v = float(v)
        if v != v:
            return ".nan"
        if v == math.inf:
            return ".inf"
        if v == -math.inf:
            return "-.inf"
        s = repr(v).lower()
        if "." not in s and "e" in s:
            s = s.replace("e", ".0e", 1)
        return s
    if isinstance(v, str):
        if any(not c.isprintable() for c in v):
            # double-quoted with escapes, as PyYAML writes control chars
            esc = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\t": "\\t",
                   "\r": "\\r", "\0": "\\0"}
            return '"' + "".join(
                esc.get(c, c if c.isprintable() else f"\\x{ord(c):02X}"
                        if ord(c) < 256 else f"\\u{ord(c):04X}")
                for c in v) + '"'
        plain = (v == v.strip() and v[:1] not in _INDICATORS
                 and ": " not in v and " #" not in v and not v.endswith(":"))
        if plain:
            try:
                plain = _resolve_plain(v, "") == v
            except YamlSubsetError:
                plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise YamlSubsetError(f"cannot write a value of type {type(v).__name__}"
                          " (convert to int/float/bool/str first)")


def _dump(obj, indent: int, sort_keys: bool) -> List[str]:
    pad = " " * indent
    lines = []
    if isinstance(obj, dict):
        items = sorted(obj.items()) if sort_keys else obj.items()
        for k, v in items:
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{key}:")
                lines += _dump(v, indent + 2, sort_keys)
            elif isinstance(v, list) and v:
                lines.append(f"{pad}{key}:")
                lines += _dump(v, indent, sort_keys)   # PyYAML's indentless
            else:
                lines.append(f"{pad}{key}: {_inline(v)}")
    elif isinstance(obj, list):
        for v in obj:
            if (isinstance(v, (dict, list))) and v:
                sub = _dump(v, indent + 2, sort_keys)
                lines.append(f"{pad}- {sub[0].lstrip(' ')}")
                lines += sub[1:]
            else:
                lines.append(f"{pad}- {_inline(v)}")
    else:
        lines.append(pad + _dump_scalar(obj))
    return lines


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _dump_scalar(v)


def dump_yaml(obj, sort_keys: bool = True) -> str:
    """Block-style YAML text of nested dicts/lists of scalars, laid out as
    PyYAML's safe_dump lays them out."""
    if isinstance(obj, (dict, list)) and not obj:
        return _inline(obj) + "\n"
    return "\n".join(_dump(obj, 0, sort_keys)) + "\n"


# ---------------------------------------------------------------- formats

class SceneConfig:
    """Parsed scene/material config (formats 1 and 2)."""

    def __init__(self, materials: Materials, object_materials: np.ndarray,
                 material_id_air: int, raw: dict):
        self.materials = materials
        self.object_materials = object_materials
        self.material_id_air = material_id_air
        self.raw = raw

    def radar_params(self, beam_width_deg: float = 8.0) -> RadarParams:
        return RadarParams.make(self.materials, self.object_materials,
                                beam_width_deg=beam_width_deg)


def load_scene_config(path) -> SceneConfig:
    """Load a scene/material YAML in either reference format."""
    raw = load_yaml(path)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: expected a mapping at top level")

    if "materials" in raw:
        materials = Materials.from_list(raw["materials"])
    elif "velocities" in raw:
        vel = [float(v) for v in raw["velocities"]]
        n = len(vel)

        def arr(key, default):
            vals = raw.get(key)
            if vals is None:
                return [default] * n
            return [float(v) for v in vals] + [default] * (n - len(vals))

        materials = Materials.from_list([
            dict(velocity=vel[i], ambient=arr("ambient", 0.0)[i],
                 diffuse=arr("diffuse", 0.0)[i],
                 specular=arr("specular", 0.0)[i])
            for i in range(n)
        ])
    else:
        raise ValueError(f"{path}: no 'materials' or 'velocities' key "
                         "(unknown scene format)")

    object_materials = np.asarray(raw.get("object_materials", [0]), np.int32)
    material_id_air = int(raw.get("material_id_air", 0))
    return SceneConfig(materials, object_materials, material_id_air, raw)


def flatten_dyncfg(raw: Any) -> dict:
    """Flatten a dynamic_reconfigure dump to its top-level parameter dict."""
    if not isinstance(raw, dict):
        raise ValueError("preset YAML did not parse to a mapping")
    return {k: v for k, v in raw.items()
            if k not in ("groups", "state", "id", "name", "parameters",
                         "parent", "type")
            and not isinstance(v, (dict, list))}


def load_preset(path) -> Tuple[RadarModelConfig, Optional[float], dict]:
    """Load a tuned dyncfg preset (format 3) -> (cfg, beam_width_deg or
    None, flat parameter dict). The beam width is dynamic (RadarParams),
    so it is returned apart, in degrees as stored (cfg/RadarModel.cfg:14).
    A reference engine name maps to the port's (sim/config.py:port_engine).
    """
    flat = flatten_dyncfg(load_yaml(path))
    cfg = RadarModelConfig.from_dict(flat)
    bw = flat.get("beam_width")
    return cfg, (float(bw) if bw is not None else None), flat


def save_preset(path, cfg: RadarModelConfig,
                beam_width_deg: Optional[float] = None):
    """Write a flat (untagged) preset YAML; load_preset round-trips it."""
    d = dataclasses.asdict(cfg)
    if beam_width_deg is not None:
        d["beam_width"] = float(beam_width_deg)
    Path(path).write_text(dump_yaml(d, sort_keys=True))


def velocity_table(path) -> np.ndarray:
    """Load a bare velocity table (config/radar.yaml format)."""
    raw = load_yaml(path)
    return np.asarray(raw["velocities"], np.float32)


def save_scene_config(path, materials: Materials, object_materials,
                      material_id_air: int = 0):
    """Write a structured scene config (format 1)."""
    entries = [
        dict(velocity=float(materials.velocity[i]),
             ambient=float(materials.ambient[i]),
             diffuse=float(materials.diffuse[i]),
             specular=float(materials.specular[i]))
        for i in range(materials.n)
    ]
    om = object_materials
    om = om.detach().cpu().numpy() if hasattr(om, "detach") else np.asarray(om)
    Path(path).write_text(dump_yaml(
        dict(materials=entries, material_id_air=int(material_id_air),
             object_materials=[int(x) for x in om]), sort_keys=False))
