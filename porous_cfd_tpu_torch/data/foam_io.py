"""Minimal OpenFOAM ASCII file IO (reader + writer), dependency-free: the
port's own copy of ``porous_cfd_tpu/data/foam_io.py`` (numpy only).

The reference reads OpenFOAM cases through ``foamlib`` (dataset/data_parser.py:10)
plus a regex workaround for surfaceFieldValue dumps (data_parser.py:15-34). That
dependency is replaced here with a small purpose-built parser covering exactly
the constructs the framework touches:

  * dictionary files (fvOptions, transportProperties, controlDict, ...)
  * volScalar/VectorField files: ``internalField uniform/nonuniform List<..>``
    and per-patch ``boundaryField`` entries
  * standalone list files (``faceCentres`` written by the surfaceFieldValue
    function object with ``surfaceFormat foam``)
  * the header-less postProcessing field dumps (count / '(' / values / ')'),
    including the compact uniform ``N{value}`` form

All readers return numpy arrays; all writers produce files the readers (and the
reference's foamlib-based parsers) accept.
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)
_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _strip_comments(text: str) -> str:
    return _COMMENT_RE.sub("", text)


def _tokenize(text: str) -> list[str]:
    # split on whitespace but keep structural tokens
    text = re.sub(r"([{}();])", r" \1 ", text)
    return text.split()


def _parse_value(tokens: list[str], i: int):
    """Parse one value starting at tokens[i]; returns (value, next_i).
    Handles scalars, words, parenthesized lists (-> numpy array when numeric,
    else python list) and nested dicts."""
    t = tokens[i]
    if t == "(":
        items, i = [], i + 1
        while tokens[i] != ")":
            v, i = _parse_value(tokens, i)
            items.append(v)
        if items and all(isinstance(v, float) for v in items):
            return np.asarray(items), i + 1
        return items, i + 1
    if t == "{":
        d, i = _parse_dict_body(tokens, i + 1)
        return d, i
    if _NUM_RE.match(t):
        return float(t), i + 1
    return t, i + 1


def _parse_dict_body(tokens: list[str], i: int):
    """Parse dict entries until '}' or end; returns (dict, next_i)."""
    out: dict = {}
    while i < len(tokens) and tokens[i] != "}":
        key = tokens[i]
        i += 1
        if i < len(tokens) and tokens[i] == "{":
            sub, i = _parse_dict_body(tokens, i + 1)
            out[key] = sub
            continue
        # collect values until ';'
        vals = []
        while i < len(tokens) and tokens[i] != ";":
            v, i = _parse_value(tokens, i)
            vals.append(v)
        i += 1  # skip ';'
        if len(vals) == 1:
            out[key] = vals[0]
        elif len(vals) == 0:
            out[key] = None
        else:
            # e.g. dimensioned scalar: 'nu [0 2 ...] 1.48e-3' -> keep last value
            # but preserve full list for callers that need it
            out[key] = vals
    return out, i + 1


def read_dict(path: str | Path) -> dict:
    """Parse an OpenFOAM dictionary file into nested python dicts. The
    ``FoamFile`` header block is parsed like any entry (available under the
    'FoamFile' key). ``#include``/macros are ignored."""
    text = _strip_comments(Path(path).read_text())
    text = re.sub(r"#\w+[^\n]*", "", text)  # drop directives
    # dimensions like [0 2 -1 0 0 0 0]: bracketed lists -> parenthesized
    text = text.replace("[", " ( ").replace("]", " ) ")
    tokens = _tokenize(text)
    d, _ = _parse_dict_body(tokens, 0)
    return d


def dimensioned_value(entry) -> float:
    """Extract the scalar from a possibly-dimensioned entry
    (e.g. ``nu [0 2 -1 0 0 0 0] 1489.4e-6;`` parses to [dims_array, value])."""
    if isinstance(entry, list):
        return float(entry[-1])
    return float(entry)


# ---------------------------------------------------------------------------
# numeric list blocks
# ---------------------------------------------------------------------------

_FLOAT = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"


def _parse_numeric_block(body: str) -> np.ndarray:
    """Parse ``( v v v ... )`` or ``( (x y z) (x y z) ... )`` into an array.
    Uses the native single-pass parser (runtime/foamio.cpp) when built, else
    numpy fromstring over a de-parenthesized copy."""
    from porous_cfd_tpu_torch.data import native
    vals = native.parse_floats(body) if native.available() else None
    if vals is None:
        vals = np.fromstring(body.replace("(", " ").replace(")", " "), sep=" ")
    if "(" in body.strip()[1:-1]:
        rows = body.count("(") - 1
        return vals.reshape(rows, -1)
    return vals


def _extract_list(text: str, keyword_pos: int) -> np.ndarray:
    """From a position in text, find the next balanced (...) block: the
    first character at which the running parenthesis depth, counted from
    the block's "(", returns to 0 (one numpy pass over one byte a character,
    not a Python loop over the characters)."""
    start = text.index("(", keyword_pos)
    # latin-1 with "replace" keeps one byte per character, so byte and
    # character positions agree (OpenFOAM's files are ASCII)
    chars = np.frombuffer(text[start:].encode("latin-1", "replace"), dtype=np.uint8)
    depth = (chars == ord("(")).astype(np.int32)
    depth -= chars == ord(")")
    np.cumsum(depth, out=depth)
    end = int(np.argmax(depth == 0))
    if depth[end] != 0:
        raise ValueError(f"unbalanced ( ... ) list at character {start}")
    return _parse_numeric_block(text[start:start + end + 1])


def read_field_file(path: str | Path) -> dict:
    """Read a vol*Field file: returns {'internal': ndarray (N,d)|(N,)|scalar|
    vector, 'uniform': bool, 'boundary': {patch: {'type':..., 'value': ...}}}."""
    text = _strip_comments(Path(path).read_text())
    m = re.search(r"internalField\s+(uniform|nonuniform)", text)
    if m is None:
        raise ValueError(f"no internalField in {path}")
    out: dict = {"boundary": {}}
    if m.group(1) == "uniform":
        rest = text[m.end():]
        vm = re.match(r"\s*\(([^)]*)\)\s*;", rest)
        if vm:
            out["internal"] = np.fromstring(vm.group(1), sep=" ")
        else:
            out["internal"] = float(re.match(rf"\s*({_FLOAT})\s*;", rest).group(1))
        out["uniform"] = True
    else:
        out["internal"] = _extract_list(text, m.end())
        out["uniform"] = False

    bm = re.search(r"boundaryField\s*\{", text)
    if bm:
        # parse the boundaryField sub-dict with the token parser
        tokens = _tokenize(text[bm.end():])
        body, _ = _parse_dict_body(tokens, 0)
        out["boundary"] = body
    return out


def write_field_file(path: str | Path, field_class: str, obj: str,
                     internal: np.ndarray, boundary: dict | None = None,
                     dimensions: str = "[0 0 0 0 0 0 0]") -> None:
    """Write a vol*Field in the ASCII layout the reference tooling accepts."""
    internal = np.asarray(internal)
    vec = internal.ndim == 2
    lines = [
        "FoamFile",
        "{",
        "    version     2.0;",
        "    format      ascii;",
        f"    class       {field_class};",
        f"    object      {obj};",
        "}",
        "",
        f"dimensions      {dimensions};",
        "",
        f"internalField   nonuniform List<{'vector' if vec else 'scalar'}>",
        str(len(internal)),
        "(",
    ]
    if vec:
        lines += ["(" + " ".join(repr(float(v)) for v in row) + ")"
                  for row in internal]
    else:
        lines += [repr(float(v)) for v in internal]
    lines += [")", ";", "", "boundaryField", "{"]
    for patch, spec in (boundary or {}).items():
        lines.append(f"    {patch}")
        lines.append("    {")
        lines.append(f"        type            {spec.get('type', 'calculated')};")
        val = spec.get("value")
        if val is not None:
            val = np.asarray(val)
            kind = "vector" if val.ndim == 2 else "scalar"
            lines.append(f"        value           nonuniform List<{kind}>")
            lines.append(str(len(val)))
            lines.append("(")
            if val.ndim == 2:
                lines += ["(" + " ".join(repr(float(v)) for v in row) + ")"
                          for row in val]
            else:
                lines += [repr(float(v)) for v in val]
            lines += [")", ";"]
        lines.append("    }")
    lines += ["}", ""]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines))


def read_list_file(path: str | Path) -> np.ndarray:
    """Read a standalone FoamFile-headed list (e.g. ``faceCentres``)."""
    text = _strip_comments(Path(path).read_text())
    # skip the FoamFile header block, then the first balanced list is the data
    hm = re.search(r"FoamFile\s*\{[^}]*\}", text)
    pos = hm.end() if hm else 0
    return _extract_list(text, pos)


def write_list_file(path: str | Path, obj: str, values: np.ndarray) -> None:
    values = np.asarray(values)
    vec = values.ndim == 2
    lines = [
        "FoamFile",
        "{",
        "    version     2.0;",
        "    format      ascii;",
        f"    class       {'vectorField' if vec else 'scalarField'};",
        f"    object      {obj};",
        "}",
        "",
        str(len(values)),
        "(",
    ]
    if vec:
        lines += ["(" + " ".join(repr(float(v)) for v in row) + ")"
                  for row in values]
    else:
        lines += [repr(float(v)) for v in values]
    lines += [")", ""]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines))


def read_postprocess_field(path: str | Path) -> np.ndarray:
    """Read a header-less surfaceFieldValue dump (data_parser.py:15-34
    semantics): compact uniform ``N{value}`` / ``N{(x y z)}`` on the first
    line, else a count / '(' / values / ')' block."""
    lines = Path(path).read_text().splitlines()
    first = lines[0].strip() if lines else ""
    m = re.match(r"(\d+)\{(.+)\}", first)
    if m is not None:
        n = int(m.group(1))
        content = m.group(2)
        if content.startswith("("):
            v = np.fromstring(content.strip("()"), sep=" ")
            return np.tile(v, (n, 1))
        return np.full((n,), float(content))
    # locate the '(' line; values run until the matching ')' line
    start = next(i for i, l in enumerate(lines) if l.strip() == "(")
    end = next(i for i in range(len(lines) - 1, start, -1)
               if lines[i].strip() == ")")
    rows = [l.strip() for l in lines[start + 1:end] if l.strip()]
    if rows and rows[0].startswith("("):
        return np.asarray([np.fromstring(r.strip("()"), sep=" ") for r in rows])
    return np.asarray([float(r) for r in rows])


def write_postprocess_field(path: str | Path, values: np.ndarray) -> None:
    """Write a surfaceFieldValue-style dump readable by both this module and
    the reference's regex parser (values start on line 3: blank line, count,
    '(', values..., ')')."""
    values = np.asarray(values)
    lines = ["", str(len(values)), "("]
    if values.ndim == 2:
        lines += ["(" + " ".join(repr(float(v)) for v in row) + ")"
                  for row in values]
    else:
        lines += [repr(float(v)) for v in values]
    lines.append(")")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# case structure helpers
# ---------------------------------------------------------------------------

def time_dirs(case_dir: str | Path) -> list[str]:
    """Numeric time directories sorted by time value."""
    out = []
    for d in os.listdir(case_dir):
        if not (Path(case_dir) / d).is_dir():
            continue
        try:
            out.append((float(d), d))
        except ValueError:
            continue
    return [name for _, name in sorted(out)]


def latest_time(case_dir: str | Path) -> str:
    dirs = time_dirs(case_dir)
    if not dirs:
        raise FileNotFoundError(f"no time directories in {case_dir}")
    return dirs[-1]
