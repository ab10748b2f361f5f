"""Lua parameter-file loader — config parity with the reference's Lua tier.

A copy of the JAX package's ``utils/lua_config.py``, which the port may not
import; it reads into the port's own ``utils/config.py``.

The reference configures the SLAM system with Cartographer-style Lua files
(reference: open3d_slam_io/lua_parameter_dictionary/src/lua_parameter_dictionary.cc,
open3d_slam_lua_io/src/LuaLoader.cpp:76-413): a defaults schema built from
named blocks (ros/open3d_slam_ros/param/default/parameter_structure_definitions.lua:1-169),
`include`-based file resolution with search directories
(configuration_file_resolver.cc), deepcopy-based inheritance
(default_parameters.lua), and per-robot override files that mutate
`params.<path> = value` and `return params`.

This module evaluates that Lua *subset* directly — no Lua runtime needed —
and maps the resulting table onto the typed ``SlamParameters`` tree
(utils/config.py), so reference users' tuning files load unchanged:

    params, warnings = load_lua_parameters("param_robosense_rs16.lua",
                                           search_dirs=[param_dir])

Supported Lua constructs (everything the reference's param files use):
  - ``include "relative/path.lua"`` resolved against the including file's
    directory plus caller-supplied search dirs (≙ ConfigurationFileResolver)
  - ``function name(...) ... end`` definitions are skipped; ``deepcopy`` is
    provided as a builtin (≙ parameter_structure_definitions.lua:1-22)
  - table constructors ``{ key = expr, ... }`` with nesting/trailing commas
  - dotted-path assignment/lookup, ``--`` comments, numbers (incl. unary
    minus), strings, booleans, ``return expr``

Key-consumption verification (≙ LuaLoader.cpp:96-130): keys that do not map
onto the parameter tree are collected as warnings; ``strict=True`` raises.
"""
from __future__ import annotations

import copy as _copy
import os
import re
from typing import List, Optional, Sequence, Tuple

from . import config as _config

_TOKEN_RE = re.compile(r"""
    (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<number>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>==|~=|<=|>=|\.\.|[{}()\[\]=,;.<>+\-*/#])
  | (?P<ws>\s+)
""", re.VERBOSE)

_BLOCK_OPENERS = {"function", "if", "do"}  # 'for'/'while' are closed via their 'do'


def _strip_comments(text: str) -> str:
    """Remove ``--`` line comments (the param files use no long strings)."""
    out = []
    for line in text.splitlines():
        in_str: Optional[str] = None
        i = 0
        while i < len(line):
            c = line[i]
            if in_str:
                if c == "\\":
                    i += 2
                    continue
                if c == in_str:
                    in_str = None
            elif c in "\"'":
                in_str = c
            elif c == "-" and line[i:i + 2] == "--":
                line = line[:i]
                break
            i += 1
        out.append(line)
    return "\n".join(out)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SyntaxError(f"lua: cannot tokenize at ...{text[pos:pos + 30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    return tokens


class _LuaEvaluator:
    """Evaluates a token stream of the supported Lua subset into dicts."""

    def __init__(self, env: dict, search_dirs: Sequence[str]):
        self.env = env
        self.search_dirs = list(search_dirs)
        self.returned = None

    # -- file driving --------------------------------------------------------
    def run_file(self, path: str) -> None:
        with open(path) as f:
            text = f.read()
        toks = _tokenize(_strip_comments(text))
        self._run(toks, os.path.dirname(os.path.abspath(path)))

    def _resolve(self, name: str, cur_dir: str) -> str:
        for d in [cur_dir] + self.search_dirs:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"lua include '{name}' not found in {[cur_dir] + self.search_dirs}")

    # -- statements ----------------------------------------------------------
    def _run(self, toks: List[Tuple[str, str]], cur_dir: str) -> None:
        i = 0
        while i < len(toks):
            kind, val = toks[i]
            if kind == "name" and val == "include":
                kind2, fname = toks[i + 1]
                if kind2 != "string":
                    raise SyntaxError("lua: include expects a string literal")
                sub = self._resolve(_unquote(fname), cur_dir)
                self.run_file(sub)
                i += 2
            elif kind == "name" and val == "function":
                i = self._skip_block(toks, i)
            elif kind == "name" and val == "return":
                value, i = self._expr(toks, i + 1)
                self.returned = value
            elif kind == "name" and val == "local":
                i += 1  # treat 'local x = ...' as a plain assignment
            elif kind == "name":
                path, i = self._lvalue_path(toks, i)
                if i < len(toks) and toks[i] == ("punct", "="):
                    value, i = self._expr(toks, i + 1)
                    self._assign(path, value)
                else:
                    raise SyntaxError(f"lua: unsupported statement at '{val}'")
            elif kind == "punct" and val == ";":
                i += 1
            else:
                raise SyntaxError(f"lua: unexpected token {val!r}")

    def _skip_block(self, toks, i) -> int:
        """Skip a function/if/do ... end block, handling nesting."""
        depth = 0
        while i < len(toks):
            kind, val = toks[i]
            if kind == "name" and val in _BLOCK_OPENERS:
                depth += 1
            elif kind == "name" and val == "end":
                depth -= 1
                if depth == 0:
                    return i + 1
            i += 1
        raise SyntaxError("lua: unterminated block")

    def _lvalue_path(self, toks, i) -> Tuple[List[str], int]:
        path = [toks[i][1]]
        i += 1
        while i + 1 < len(toks) and toks[i] == ("punct", ".") and toks[i + 1][0] == "name":
            path.append(toks[i + 1][1])
            i += 2
        return path, i

    def _assign(self, path: List[str], value) -> None:
        tbl = self.env
        for key in path[:-1]:
            nxt = tbl.get(key)
            if not isinstance(nxt, dict):
                nxt = {}
                tbl[key] = nxt
            tbl = nxt
        tbl[path[-1]] = value

    # -- expressions ----------------------------------------------------------
    def _expr(self, toks, i):
        kind, val = toks[i]
        if kind == "punct" and val == "-":
            value, i = self._expr(toks, i + 1)
            return -value, i
        if kind == "string":
            return _unquote(val), i + 1
        if kind == "number":
            text = val
            if "." in text or "e" in text or "E" in text:
                return float(text), i + 1
            return int(text), i + 1
        if kind == "name" and val in ("true", "false"):
            return val == "true", i + 1
        if kind == "name" and val == "nil":
            return None, i + 1
        if kind == "punct" and val == "{":
            return self._table(toks, i + 1)
        if kind == "name":
            # deepcopy(expr) — the only call the param files make at top level.
            if val == "deepcopy" and i + 1 < len(toks) and toks[i + 1] == ("punct", "("):
                inner, j = self._expr(toks, i + 2)
                if toks[j] != ("punct", ")"):
                    raise SyntaxError("lua: expected ')' after deepcopy(...)")
                return _copy.deepcopy(inner), j + 1
            path, j = self._lvalue_path(toks, i)
            cur = self.env
            for key in path:
                if not isinstance(cur, dict) or key not in cur:
                    raise NameError(f"lua: undefined variable '{'.'.join(path)}'")
                cur = cur[key]
            return cur, j
        raise SyntaxError(f"lua: unsupported expression at {val!r}")

    def _table(self, toks, i):
        table: dict = {}
        while True:
            kind, val = toks[i]
            if kind == "punct" and val == "}":
                return table, i + 1
            if kind == "name" and i + 1 < len(toks) and toks[i + 1] == ("punct", "="):
                value, i = self._expr(toks, i + 2)
                table[val] = value
            else:
                raise SyntaxError(f"lua: unsupported table field at {val!r}")
            if toks[i][0] == "punct" and toks[i][1] in ",;":
                i += 1


def _unquote(s: str) -> str:
    body = s[1:-1]
    return body.replace('\\"', '"').replace("\\'", "'").replace("\\\\", "\\")


def evaluate_lua_file(path: str, search_dirs: Sequence[str] = ()) -> dict:
    """Evaluate a Lua parameter file; returns its ``return`` value (or the
    global table if the file returns nothing)."""
    ev = _LuaEvaluator({}, search_dirs)
    ev.run_file(path)
    return ev.returned if ev.returned is not None else ev.env


# ---------------------------------------------------------------------------
# Lua table layout -> SlamParameters layout (≙ LuaLoader.cpp:201-413, which
# maps the Lua schema onto the SlamParameters struct tree).
# ---------------------------------------------------------------------------

def _pop(d: dict, key, default=None):
    return d.pop(key) if key in d else default


def lua_table_to_overrides(tbl: dict, warnings: List[str]) -> dict:
    """Remap the reference's Lua parameter layout onto SlamParameters
    overrides.  Mutates a deep copy; unmapped keys produce warnings
    (≙ the reference's key use-count verification, LuaLoader.cpp:96-130)."""
    tbl = _copy.deepcopy(tbl)
    out: dict = {}

    # odometry ---------------------------------------------------------------
    odo = _pop(tbl, "odometry")
    if odo is not None:
        icp = odo.get("scan_matching", {}).get("icp")
        if isinstance(icp, dict):
            icp.pop("reference_cloud_seting_period", None)  # unused for scan2scan
        out["odometry"] = odo
    # mapper-side blocks -----------------------------------------------------
    mapper: dict = {}
    sub = _pop(tbl, "submap")
    if sub is not None:
        mapper["submaps"] = sub
    mb = _pop(tbl, "map_builder")
    if mb is not None:
        mapper["map_builder"] = mb
    dmb = _pop(tbl, "dense_map_builder")
    if dmb is not None:
        mapper["dense_map_builder"] = dmb
    ml = _pop(tbl, "mapper_localizer")
    if ml is not None:
        s2m = ml.get("scan_to_map_registration")
        if isinstance(s2m, dict):
            icp = s2m.get("icp")
            if isinstance(icp, dict) and "reference_cloud_seting_period" in icp:
                # The reference (with its typo) nests the reference-cloud
                # re-init period under icp; our tree holds it at the
                # scan-to-map level (Mapper.cpp:349-380).
                s2m["reference_cloud_setting_period"] = icp.pop(
                    "reference_cloud_seting_period")
        # is_carving_enabled lives on mapper_localizer in the Lua schema and
        # is consumed by the map builder in the reference; keep it in place —
        # MapperLocalizerParameters carries the same flag.
        mapper["mapper_localizer"] = ml
    go = _pop(tbl, "global_optimization")
    if go is not None:
        mapper["global_optimization"] = go
    mi = _pop(tbl, "map_initializer")
    if mi is not None:
        mapper["map_initializer"] = mi
    pr = _pop(tbl, "place_recognition")
    if pr is not None:
        mapper["place_recognition"] = pr
    if mapper:
        out["mapper"] = mapper
    # direct blocks ------------------------------------------------------------
    for key in ("saving", "visualization", "motion_compensation"):
        val = _pop(tbl, key)
        if val is not None:
            out[key] = val
    # leftovers → warnings (≙ LuaLoader key-consumption check)
    for key in sorted(tbl):
        warnings.append(f"unused lua parameter key '{key}'")
    return out


def load_lua_parameters(path: str, search_dirs: Sequence[str] = (),
                        strict: bool = False):
    """Load a reference-style Lua parameter file into ``SlamParameters``.

    ≙ io_lua::loadParameters (parameter_loaders.cpp:23-30).  Returns
    ``(params, warnings)``; with ``strict=True`` any unconsumed key raises.
    """
    tbl = evaluate_lua_file(path, search_dirs)
    if not isinstance(tbl, dict):
        raise TypeError(f"lua parameter file {path} did not return a table")
    warnings: List[str] = []
    overrides = lua_table_to_overrides(tbl, warnings)
    try:
        params = _config.load_parameters(overrides)
    except KeyError as e:
        raise KeyError(f"while loading {path}: {e}") from e
    if strict and warnings:
        raise KeyError(f"unconsumed lua parameter keys in {path}: {warnings}")
    return params, warnings
