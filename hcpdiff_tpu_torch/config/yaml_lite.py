"""A small YAML reader and writer for the configs under ``cfgs/``.

The port depends on no YAML package (a GPU host need not have PyYAML), so
it reads its configs itself. This module takes the subset of YAML that
``cfgs/infer`` and ``cfgs/train`` are written in:

- block mappings and sequences (a sequence may sit at its key's indent),
  including sequences of mappings (``- _target_: ...``);
- flow lists ``[a, b]`` and flow mappings ``{path: '...', alpha: 0.8}``,
  which may run over several lines;
- single- and double-quoted strings on one line;
- literal block scalars (``|``, ``|-``, ``|+``: the workflow configs'
  programs and notes);
- plain scalars resolved as PyYAML's SafeLoader resolves them (null,
  booleans including yes/no/on/off, ints including 0x/0b/octal and
  sexagesimal), with YAML 1.2's floats (``1e-3``, ``.5``), as the JAX
  package's loader reads them;
- comments, and ``${...}`` strings, which are left for ``interp``.

It raises ``YAMLError``, naming the file and line, on what it does not
take: folded block scalars (``>``) and indentation indicators (``|2``),
anchors and aliases, tags, merge keys,
complex keys, timestamps, multi-line plain or quoted scalars, and more
than one document.

``dumps`` writes block style that ``loads`` (and PyYAML) read back to the
same tree: mappings, lists, strings, numbers, booleans and null.
"""
from __future__ import annotations

import math
import numbers
import re
from typing import Any, List, Optional, Tuple

__all__ = ['YAMLError', 'loads', 'load', 'dumps', 'dump', 'resolve_plain']


class YAMLError(ValueError):
    def __init__(self, msg: str, name: str = '<string>', lineno: Optional[int] = None):
        where = name if lineno is None else f'{name}:{lineno}'
        super().__init__(f'{where}: {msg}')


# ---------------------------------------------------------------- scalars

_NULL = {'', '~', 'null', 'Null', 'NULL'}
_TRUE = {'yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON'}
_FALSE = {'no', 'No', 'NO', 'false', 'False', 'FALSE', 'off', 'Off', 'OFF'}
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
# PyYAML's YAML 1.1 floats and the JAX loader's YAML 1.2 additions
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$''', re.X)
_TIMESTAMP = re.compile(r'^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?')


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text.startswith('-') else 1
    value = 0
    for part in text.lstrip('+-').split(':'):
        value = value * 60 + cast(part)
    return sign * value


def _to_int(text: str) -> int:
    t = text.replace('_', '')
    sign = -1 if t.startswith('-') else 1
    body = t.lstrip('+-')
    if ':' in body:
        return _sexagesimal(t, int)
    if body.startswith('0b'):
        return sign * int(body[2:], 2)
    if body.startswith('0x'):
        return sign * int(body[2:], 16)
    if len(body) > 1 and body.startswith('0'):
        return sign * int(body, 8)
    return sign * int(body)


def _to_float(text: str) -> float:
    t = text.replace('_', '').lower()
    if t.endswith('.inf'):
        return -math.inf if t.startswith('-') else math.inf
    if t == '.nan':
        return math.nan
    if ':' in t:
        return float(_sexagesimal(t, float))
    return float(t)


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f'timestamps are not supported, quote the value: {text!r}')
    return text


_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t', 'n': '\n', 'v': '\v',
            'f': '\f', 'r': '\r', 'e': '\x1b', ' ': ' ', '"': '"', '/': '/', '\\': '\\',
            'N': '\x85', '_': '\xa0', 'L': ' ', 'P': ' '}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}


# ----------------------------------------------------------------- reader

class _Line:
    __slots__ = ('indent', 'text', 'lineno')

    def __init__(self, indent: int, text: str, lineno: int):
        self.indent, self.text, self.lineno = indent, text, lineno


class _Parser:
    """Block structure by indentation, one line at a time; flow collections
    and quoted scalars by a cursor that may cross lines (flow only)."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.raw = text.splitlines()
        self.lines: List[_Line] = []
        seen_content = False
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(' ')
            if body.startswith('\t'):
                raise YAMLError('tabs in indentation are not supported', name, n)
            stripped = body.strip()
            if not stripped or stripped.startswith('#'):
                continue
            if stripped.startswith('%'):
                raise YAMLError('directives are not supported', name, n)
            if re.match(r'^(---|\.\.\.)(\s|$)', body) and raw.startswith(('---', '...')):
                if body.startswith('---') and not seen_content and not body[3:].strip():
                    continue
                raise YAMLError('only one document a file is supported', name, n)
            seen_content = True
            self.lines.append(_Line(len(raw) - len(body), body.rstrip(), n))

    def error(self, msg: str, line: Optional[_Line]) -> YAMLError:
        return YAMLError(msg, self.name, None if line is None else line.lineno)

    # ---- document and blocks ----
    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0].indent)
        if i < len(self.lines):
            raise self.error('unexpected content after the document', self.lines[i])
        return value

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == '-' or text.startswith('- ')

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if self._is_item(line.text):
            return self.sequence(i, indent)
        if self.key_of(line) is not None:
            return self.mapping(i, indent)
        value, i = self.inline(i, 0)
        return value, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines):
            line = self.lines[i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error('bad indentation in a sequence', line)
            if not self._is_item(line.text):
                break
            rest = line.text[1:]
            content = rest.lstrip(' ')
            if not content:
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    value, i = self.block(i, self.lines[i].indent)
                else:
                    value = None
            else:
                # the item's content starts a block of its own at its column
                col = indent + 1 + len(rest) - len(content)
                self.lines[i] = _Line(col, content, line.lineno)
                value, i = self.block(i, col)
            out.append(value)
        return out, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines):
            line = self.lines[i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error('bad indentation in a mapping', line)
            if self._is_item(line.text):
                raise self.error('a sequence item where a mapping key was expected', line)
            kv = self.key_of(line)
            if kv is None:
                raise self.error('expected a "key: value" line', line)
            key, pos = kv
            if key == '<<':
                raise self.error('merge keys (<<) are not supported', line)
            if line.text[pos:].strip() and not line.text[pos:].lstrip().startswith('#'):
                value, i = self.inline(i, pos)
            else:
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    value, i = self.block(i, self.lines[i].indent)
                elif (i < len(self.lines) and self.lines[i].indent == indent
                      and self._is_item(self.lines[i].text)):
                    value, i = self.sequence(i, indent)
                else:
                    value = None
            out[key] = value
        return out, i

    def key_of(self, line: _Line) -> Optional[Tuple[Any, int]]:
        """(key, position after 'key:') when the line is a mapping entry."""
        text = line.text
        if text.startswith('?'):
            raise self.error('complex keys (?) are not supported', line)
        if text[0] in '\'"':
            try:
                key, pos = self.quoted(text, 0, line)
            except YAMLError:
                return None
            rest = text[pos:]
            stripped = rest.lstrip(' ')
            if stripped.startswith(':') and (len(stripped) == 1 or stripped[1] == ' '):
                return key, pos + len(rest) - len(stripped) + 1
            return None
        if text[0] in '[{':
            return None
        for j, ch in enumerate(text):
            if ch == '#' and j > 0 and text[j - 1] == ' ':
                return None
            if ch == ':' and (j + 1 == len(text) or text[j + 1] == ' '):
                key_text = text[:j].rstrip()
                self.check_plain(key_text, line)
                try:
                    key = resolve_plain(key_text)
                except ValueError as e:
                    raise self.error(str(e), line) from None
                return key, j + 1
        return None

    def check_plain(self, text: str, line: _Line) -> None:
        if not text:
            return
        first = text[0]
        if first in '&*':
            raise self.error('anchors and aliases are not supported', line)
        if first == '!':
            raise self.error('tags are not supported', line)
        if first in '|>':
            raise self.error('block scalars other than literal ones (|, |-, |+) are not '
                             'supported', line)
        if first in '@`%':
            raise self.error(f'a plain scalar cannot start with {first!r}', line)
        if first == '-' and (len(text) == 1 or text[1] == ' '):
            raise self.error('a sequence item is not allowed here', line)

    # ---- values on a line ----
    def inline(self, i: int, pos: int) -> Tuple[Any, int]:
        """The value that starts at lines[i].text[pos:]; returns it and the
        index of the next line."""
        line = self.lines[i]
        text = line.text
        while pos < len(text) and text[pos] == ' ':
            pos += 1
        ch = text[pos] if pos < len(text) else ''
        if ch in '[{':
            cur = _Cursor(self, i, pos)
            value = cur.flow()
            cur.end_of_value()
            return value, cur.i + 1
        if ch in '\'"':
            value, end = self.quoted(text, pos, line)
            self.rest_is_comment(text, end, line)
            i += 1
        else:
            end = len(text)
            for j in range(pos, len(text)):
                if text[j] == '#' and (j == pos or text[j - 1] == ' '):
                    end = j
                    break
            plain = text[pos:end].rstrip()
            if plain in ('|', '|-', '|+'):
                return self.literal(i, plain[1:])
            self.check_plain(plain, line)
            try:
                value = resolve_plain(plain)
            except ValueError as e:
                raise self.error(str(e), line) from None
            i += 1
        if i < len(self.lines) and self.lines[i].indent > line.indent:
            raise self.error('multi-line scalars are not supported', self.lines[i])
        return value, i

    def literal(self, i: int, chomp: str) -> Tuple[str, int]:
        """The literal block scalar whose header ends lines[i]: the raw lines
        below it indented more than that line, less the first one's
        indentation, under the header's chomping ('' clip, '-' strip, '+'
        keep); returns it and the index of the next line."""
        line = self.lines[i]
        head = self.raw[line.lineno - 1]
        parent = len(head) - len(head.lstrip(' '))
        j, indent, body = line.lineno, None, []
        while j < len(self.raw):
            r = self.raw[j]
            if r.strip():
                ind = len(r) - len(r.lstrip(' '))
                if ind <= parent or (indent is not None and ind < indent):
                    break
                indent = ind if indent is None else indent
                body.append(r[indent:])
            else:
                body.append('')
            j += 1
        n = len(body)
        while body and not body[-1]:
            body.pop()
        text = '\n'.join(body)
        if chomp == '+':
            text += '\n' * (n - len(body) + 1)
        elif chomp == '' and body:
            text += '\n'
        i += 1
        while i < len(self.lines) and self.lines[i].lineno <= j:
            i += 1
        return text, i

    def rest_is_comment(self, text: str, end: int, line: _Line) -> None:
        rest = text[end:]
        stripped = rest.lstrip(' ')
        if stripped and not (stripped.startswith('#') and len(rest) > len(stripped)):
            raise self.error(f'unexpected text after a value: {stripped!r}', line)

    def quoted(self, text: str, pos: int, line: _Line) -> Tuple[str, int]:
        """A quoted scalar starting at text[pos]; returns it and the index
        after its closing quote."""
        q = text[pos]
        out = []
        j = pos + 1
        while j < len(text):
            ch = text[j]
            if q == "'":
                if ch == "'":
                    if j + 1 < len(text) and text[j + 1] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return ''.join(out), j + 1
                out.append(ch)
                j += 1
                continue
            if ch == '"':
                return ''.join(out), j + 1
            if ch == '\\':
                if j + 1 >= len(text):
                    break
                e = text[j + 1]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = text[j + 2:j + 2 + n]
                    if len(digits) != n or not re.fullmatch('[0-9a-fA-F]+', digits):
                        raise self.error(f'bad escape \\{e}{digits}', line)
                    out.append(chr(int(digits, 16)))
                    j += 2 + n
                    continue
                raise self.error(f'unknown escape \\{e}', line)
            out.append(ch)
            j += 1
        raise self.error('quoted scalars must close on their line', line)


class _Cursor:
    """A position in the lines, for flow collections (which may cross
    lines); comments run to the end of a line."""

    def __init__(self, parser: _Parser, i: int, pos: int):
        self.p, self.i, self.pos = parser, i, pos

    @property
    def line(self) -> _Line:
        return self.p.lines[self.i]

    def skip_space(self) -> None:
        while True:
            text = self.line.text
            while self.pos < len(text) and text[self.pos] == ' ':
                self.pos += 1
            if self.pos < len(text) and text[self.pos] == '#' and (
                    self.pos == 0 or text[self.pos - 1] == ' '):
                self.pos = len(text)
            if self.pos < len(text):
                return
            if self.i + 1 >= len(self.p.lines):
                raise self.p.error('a flow collection is not closed', self.line)
            self.i += 1
            self.pos = 0

    def peek(self) -> str:
        self.skip_space()
        return self.line.text[self.pos]

    def end_of_value(self) -> None:
        self.p.rest_is_comment(self.line.text, self.pos, self.line)

    def flow(self) -> Any:
        ch = self.peek()
        if ch == '[':
            return self.collection(']')
        if ch == '{':
            return self.collection('}')
        if ch in '\'"':
            value, self.pos = self.p.quoted(self.line.text, self.pos, self.line)
            return value
        return self.plain()

    def plain(self) -> Any:
        text = self.line.text
        start = j = self.pos
        while j < len(text):
            ch = text[j]
            if ch in ',[]{}':
                break
            if ch == ':' and (j + 1 == len(text) or text[j + 1] in ' ,[]{}'):
                break
            if ch == '#' and j > 0 and text[j - 1] == ' ':
                break
            j += 1
        word = text[start:j].rstrip()
        self.pos = start + len(word)
        self.p.check_plain(word, self.line)
        try:
            return resolve_plain(word)
        except ValueError as e:
            raise self.p.error(str(e), self.line) from None

    def collection(self, close: str) -> Any:
        self.pos += 1
        is_map = close == '}'
        out: Any = {} if is_map else []
        while True:
            if self.peek() == close:
                self.pos += 1
                return out
            if self.peek() in ',]}':
                raise self.p.error(f'unexpected {self.peek()!r} in a flow collection', self.line)
            if self.peek() == '?':
                raise self.p.error('complex keys (?) are not supported', self.line)
            item = self.flow()
            ch = self.peek()
            if ch == ':':
                if not is_map:
                    raise self.p.error('mappings inside flow lists are not supported',
                                       self.line)
                self.pos += 1
                value = None if self.peek() in ',}' else self.flow()
                out[item] = value
            elif is_map:
                out[item] = None
            else:
                out.append(item)
            ch = self.peek()
            if ch == ',':
                self.pos += 1
            elif ch != close:
                raise self.p.error(f'expected "," or {close!r} in a flow collection', self.line)


def loads(text: str, name: str = '<string>') -> Any:
    """Parse one YAML document; ``name`` is used in error messages."""
    return _Parser(text, name).document()


def load(path) -> Any:
    with open(path, 'r', encoding='utf-8') as f:
        return loads(f.read(), str(path))


# ----------------------------------------------------------------- writer

_PLAIN_SAFE = re.compile(r'^[A-Za-z0-9_./+(][A-Za-z0-9_./+\-() =~^@]*$')


def _scalar(value: Any) -> str:
    if value is None:
        return 'null'
    if value is True:
        return 'true'
    if value is False:
        return 'false'
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, numbers.Real):
        value = float(value)
        if math.isnan(value):
            return '.nan'
        if math.isinf(value):
            return '.inf' if value > 0 else '-.inf'
        text = repr(float(value))
        if 'e' in text and '.' not in text.split('e')[0]:
            mant, exp = text.split('e')
            text = f'{mant}.0e{exp}'
        return text
    if isinstance(value, str):
        return _string(value)
    raise TypeError(f'cannot write a {type(value).__name__} as YAML: {value!r}')


def _string(s: str) -> str:
    if (_PLAIN_SAFE.match(s) and not s.endswith(' ')
            and ': ' not in s and ' #' not in s and _plain_is_string(s)):
        return s
    if s.isprintable():
        return "'" + s.replace("'", "''") + "'"
    out = []
    for ch in s:
        if ch in '"\\':
            out.append('\\' + ch)
        elif ch == '\n':
            out.append('\\n')
        elif ch == '\t':
            out.append('\\t')
        elif not ch.isprintable():
            out.append(f'\\u{ord(ch):04x}' if ord(ch) < 0x10000 else f'\\U{ord(ch):08x}')
        else:
            out.append(ch)
    return '"' + ''.join(out) + '"'


def _plain_is_string(s: str) -> bool:
    try:
        return resolve_plain(s) == s and isinstance(resolve_plain(s), str)
    except ValueError:
        return False


def _lines(value: Any, indent: int) -> List[str]:
    pad = ' ' * indent
    if isinstance(value, dict):
        if not value:
            return [pad + '{}']
        out = []
        for k, v in value.items():
            key = _scalar(k)
            if isinstance(v, (dict, list, tuple)) and v:
                out.append(f'{pad}{key}:')
                out += _lines(v, indent + 2)
            else:
                out.append(f'{pad}{key}: {_inline(v)}')
        return out
    if isinstance(value, (list, tuple)):
        if not value:
            return [pad + '[]']
        out = []
        for v in value:
            if isinstance(v, (dict, list, tuple)) and v:
                sub = _lines(v, indent + 2)
                out.append(f'{pad}- {sub[0][indent + 2:]}')
                out += sub[1:]
            else:
                out.append(f'{pad}- {_inline(v)}')
        return out
    return [pad + _scalar(value)]


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return '{}'
    if isinstance(value, (list, tuple)):
        return '[]'
    return _scalar(value)


def dumps(value: Any) -> str:
    """Block-style YAML for a tree of dicts, lists, str, int, float, bool
    and None; keys keep their order."""
    return '\n'.join(_lines(value, 0)) + '\n'


def dump(value: Any, path) -> None:
    with open(path, 'w', encoding='utf-8') as f:
        f.write(dumps(value))
