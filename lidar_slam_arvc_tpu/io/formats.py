"""CSV tables and parameter YAML files without pandas or PyYAML.

A table is an ordered ``dict`` of column name -> 1-D numpy array, read
and written with the byte layout pandas gives these files
(``DataFrame.to_csv`` / ``read_csv``), so datasets and outputs interoperate
with the reference's pandas code.  The YAML reader and writer cover the
subset the dataset parameter files use: nested block mappings, block and
flow sequences, and plain or quoted scalars resolved as PyYAML's
``safe_load`` resolves them; the writer lays files out as ``safe_dump``
does.
"""

from __future__ import annotations

import csv
import re

import numpy as np

# ------------------------------------------------------------------- CSV


def _parse_column(cells: list[str]) -> np.ndarray:
    """Column dtype as pandas infers it: int64, float64 (empty = NaN),
    bool, or str."""
    if cells and all(c in ("True", "False") for c in cells):
        return np.array([c == "True" for c in cells])
    try:
        return np.array([int(c) for c in cells], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(c) if c.strip() else np.nan for c in cells],
                        dtype=np.float64)
    except ValueError:
        return np.array(cells, dtype=str)


def read_csv(path: str) -> dict[str, np.ndarray]:
    """Columns of a CSV with one header row; an empty header cell (the
    index pandas writes) is named ``Unnamed: <position>`` as pandas names
    it.  Raises FileNotFoundError like ``pandas.read_csv``."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    return {(name or f"Unnamed: {j}"): _parse_column([r[j] for r in body])
            for j, name in enumerate(header)}


def _format_cell(value) -> str:
    if isinstance(value, (float, np.floating)):
        return "" if np.isnan(value) else str(value)
    return str(value)


def write_csv(path: str, table: dict, index: bool = True) -> None:
    """Write ``table`` as ``pandas.DataFrame(table).to_csv(path,
    index=index)`` writes it, byte for byte."""
    names = list(table)
    cols = [np.asarray(table[k]) for k in names]
    n = len(cols[0]) if cols else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + names)
        for i in range(n):
            w.writerow(([str(i)] if index else [])
                       + [_format_cell(c[i]) for c in cols])


def n_rows(table) -> int:
    """Row count of a table (``len`` of a dict counts its columns)."""
    for name in table:
        return len(table[name])
    return 0


def take_rows(table, rows) -> dict[str, np.ndarray]:
    """The given rows (indices or a boolean mask) of every column."""
    return {k: np.asarray(v)[rows] for k, v in table.items()}


def columns(table, names) -> np.ndarray:
    """(N, len(names)) float64 stack of the named columns of any
    column-indexable table (a dict of arrays or a pandas DataFrame)."""
    return np.stack([np.asarray(table[c], dtype=np.float64) for c in names],
                    axis=1)


# ------------------------------------------------------------------ YAML

_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9_]+(?:[eE][-+][0-9]+)?
                        |[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}


def _scalar(text: str):
    """A plain or quoted YAML scalar, resolved like ``yaml.safe_load``."""
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return text[1:-1].encode().decode("unicode_escape")
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text.lower() in _BOOL and text in (text.lower(), text.title(),
                                          text.upper()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(text.replace("_", ""))
    return text


def _split_flow(text: str) -> list[str]:
    """Top-level comma-separated items of a flow sequence body."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur.strip())
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur.strip())
    return items


def _value(text: str):
    if text.startswith("[") and text.endswith("]"):
        return [_value(t) for t in _split_flow(text[1:-1])]
    if text == "{}":
        return {}
    return _scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _logical_lines(text: str) -> list[list]:
    """[indent, content] per line; flow sequences spanning several lines
    are joined into one."""
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if out and out[-1][1].count("[") > out[-1][1].count("]"):
            out[-1][1] += " " + line.strip()
            continue
        out.append([len(line) - len(line.lstrip(" ")), line.strip()])
    return out


def _parse_block(lines, i: int, indent: int):
    """(value, next line) of the block starting at line ``i``."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        seq = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].lstrip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    item, i = _parse_block(lines, i + 1, lines[i + 1][0])
                else:
                    item, i = None, i + 1
            elif rest.startswith("- ") or rest == "-" or _is_key(rest):
                # an inline nested block: re-read it as its own line
                lines[i] = [indent + len(lines[i][1]) - len(rest), rest]
                item, i = _parse_block(lines, i, lines[i][0])
            else:
                item, i = _value(rest), i + 1
            seq.append(item)
        return seq, i
    mapping = {}
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _split_key(lines[i][1])
        i += 1
        if rest:
            mapping[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            mapping[key], i = _parse_block(lines, i, lines[i][0])
        else:
            mapping[key] = None
    return mapping, i


def _is_key(text: str) -> bool:
    return not text.startswith(("'", '"', "[")) and (
        ": " in text or text.endswith(":"))


def _split_key(text: str):
    if not _is_key(text):
        raise ValueError(f"unsupported YAML line: {text!r}")
    key, _, rest = text.partition(":")
    return _scalar(key.strip()), rest.strip()


def load_yaml(path: str):
    """Parse a parameter YAML file (the subset described above)."""
    with open(path) as f:
        lines = _logical_lines(f.read())
    if not lines:
        return None
    value, end = _parse_block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"{path}: unsupported YAML structure at line "
                         f"{lines[end][1]!r}")
    return value


def _dump_scalar(v) -> str:
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text else text
    text = str(v)
    plain = (text and text == text.strip() and _scalar(text) == text
             and text[0] not in "#,[]{}&*!|>'\"%@`"
             and text[:2] not in ("- ", "? ", ": ") and text not in "-?:"
             and ": " not in text and " #" not in text
             and not text.endswith(":") and "\n" not in text)
    return text if plain else "'" + text.replace("'", "''") + "'"


def _dump_lines(value, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key in sorted(value):
            v = value[key]
            if isinstance(v, dict) and v:
                out.append(f"{pad}{_dump_scalar(key)}:")
                _dump_lines(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and len(v):
                out.append(f"{pad}{_dump_scalar(key)}:")
                _dump_lines(list(v), indent, out)
            else:
                out.append(f"{pad}{_dump_scalar(key)}: {_dump_flat(v)}")
    else:
        for v in value:
            if isinstance(v, (dict, list, tuple)) and len(v):
                sub: list[str] = []
                _dump_lines(list(v) if not isinstance(v, dict) else v,
                            indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_dump_flat(v)}")


def _dump_flat(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def dump_yaml(value: dict, path: str) -> None:
    """Write a mapping as ``yaml.safe_dump(value, f)`` lays it out."""
    out: list[str] = []
    _dump_lines(value, 0, out)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
