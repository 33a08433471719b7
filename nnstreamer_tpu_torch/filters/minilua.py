"""A small tree-walking Lua interpreter for the lua tensor_filter (a copy
of the JAX package's ``filters/minilua.py``, which imports nothing of it).

The reference's lua backend embeds liblua
(ext/nnstreamer/tensor_filter/tensor_filter_lua.cc); where neither liblua
nor the `lupa` binding is installed, the framework carries its own
interpreter for the Lua subset that filter scripts use:

  - values: nil, booleans, numbers (Lua 5.3-style int/float split:
    `/` and `^` produce floats, `//` floors), strings, tables, functions;
  - statements: assignment (incl. multi-target and nested index targets),
    `local`, `if/elseif/else`, `while`, `repeat/until`, numeric `for`,
    generic `for ... in`, `do` blocks, function definitions (global,
    local, dotted), `return`, `break`;
  - expressions: full operator set with Lua precedence (`or and < > <=
    >= ~= == .. + - * / // % unary-not/-/# ^`), table constructors,
    calls, method-free indexing chains;
  - stdlib subset: `print type tonumber tostring pairs ipairs`, `math.*`
    (floor ceil abs min max sqrt exp log pow fmod huge pi), `string.*`
    (format len sub rep byte char upper lower);
  - host bindings: Python callables registered as globals; host objects
    may expose ``lua_index(key)`` / ``lua_newindex(key, value)`` to act
    as userdata with metatable-style element access (how the filter's
    ``input_tensor(i)`` / ``output_tensor(i)`` accessors are surfaced,
    mirroring tensor_filter_lua.cc:256-296).

Out of scope (clear errors, not silent drift): metatables, coroutines,
goto, varargs, method (`:`) definitions/calls, io/os (deliberately — the
filter must not grant scripts ambient authority).
"""

from __future__ import annotations

import math as _pymath
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["LuaError", "LuaTable", "MiniLua"]


class LuaError(Exception):
    """Lexing, parsing, or runtime error from the embedded script."""


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

class LuaTable:
    """A Lua table: one hash, Lua 1-based array conventions for # and
    ipairs."""

    __slots__ = ("h",)

    def __init__(self, items: Optional[Dict[Any, Any]] = None):
        self.h: Dict[Any, Any] = dict(items or {})

    def get(self, k):
        if isinstance(k, float) and k.is_integer():
            k = int(k)
        return self.h.get(k)

    def set(self, k, v):
        if k is None:
            raise LuaError("table index is nil")
        if isinstance(k, float) and k.is_integer():
            k = int(k)
        if v is None:
            self.h.pop(k, None)
        else:
            self.h[k] = v

    def length(self) -> int:
        n = 0
        while (n + 1) in self.h:
            n += 1
        return n

    def __repr__(self):  # debugging aid only
        return f"LuaTable({self.h!r})"


class _LuaFunction:
    __slots__ = ("params", "body", "env", "name")

    def __init__(self, params, body, env, name="?"):
        self.params = params
        self.body = body
        self.env = env
        self.name = name


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for",
    "function", "if", "in", "local", "nil", "not", "or", "repeat",
    "return", "then", "true", "until", "while",
}

_SYMBOLS = [
    "...", "..", "==", "~=", "<=", ">=", "//",
    "+", "-", "*", "/", "%", "^", "#", "<", ">", "=", "(", ")", "{",
    "}", "[", "]", ";", ":", ",", ".",
]


class _Tok:
    __slots__ = ("kind", "val", "line")

    def __init__(self, kind, val, line):
        self.kind = kind   # 'name' | 'num' | 'str' | 'sym' | 'kw' | 'eof'
        self.val = val
        self.line = line

    def __repr__(self):
        return f"{self.kind}:{self.val!r}@{self.line}"


def _lex(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("--", i):
            if src.startswith("--[[", i):       # long comment
                j = src.find("]]", i + 4)
                if j < 0:
                    raise LuaError(f"unterminated long comment at line {line}")
                line += src.count("\n", i, j)
                i = j + 2
            else:
                j = src.find("\n", i)
                i = n if j < 0 else j
            continue
        if src.startswith("[[", i):             # long string
            j = src.find("]]", i + 2)
            if j < 0:
                raise LuaError(f"unterminated long string at line {line}")
            s = src[i + 2:j]
            line += s.count("\n")
            toks.append(_Tok("str", s, line))
            i = j + 2
            continue
        if c in "'\"":
            j = i + 1
            buf = []
            while j < n and src[j] != c:
                if src[j] == "\\":
                    if j + 1 >= n:
                        break
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r",
                                "\\": "\\", "'": "'", '"': '"',
                                "0": "\0"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise LuaError(f"unterminated string at line {line}")
            toks.append(_Tok("str", "".join(buf), line))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            isfloat = False
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and (src[j] in "0123456789abcdefABCDEF"):
                    j += 1
                toks.append(_Tok("num", int(src[i:j], 16), line))
                i = j
                continue
            while j < n and (src[j].isdigit() or src[j] in ".eE"
                             or (src[j] in "+-" and src[j - 1] in "eE")):
                if src[j] in ".eE":
                    isfloat = True
                j += 1
            text = src[i:j]
            try:
                toks.append(_Tok("num",
                                 float(text) if isfloat else int(text),
                                 line))
            except ValueError:
                raise LuaError(
                    f"malformed number {text!r} at line {line}") from None
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            w = src[i:j]
            toks.append(_Tok("kw" if w in _KEYWORDS else "name", w, line))
            i = j
            continue
        for s in _SYMBOLS:
            if src.startswith(s, i):
                toks.append(_Tok("sym", s, line))
                i += len(s)
                break
        else:
            raise LuaError(f"unexpected character {c!r} at line {line}")
    toks.append(_Tok("eof", None, line))
    return toks


# ---------------------------------------------------------------------------
# parser → AST (tuples: (kind, ...))
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers
    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, val=None) -> Optional[_Tok]:
        t = self.peek()
        if t.kind == kind and (val is None or t.val == val):
            return self.next()
        return None

    def expect(self, kind, val=None) -> _Tok:
        t = self.next()
        if t.kind != kind or (val is not None and t.val != val):
            raise LuaError(
                f"line {t.line}: expected {val or kind}, got {t.val!r}")
        return t

    # -- grammar
    def parse_chunk(self):
        body = self.block()
        self.expect("eof")
        return body

    def block(self):
        stmts = []
        while True:
            t = self.peek()
            if t.kind == "eof":
                break
            if t.kind == "kw" and t.val in ("end", "else", "elseif",
                                            "until"):
                break
            if t.kind == "sym" and t.val == ";":
                self.next()
                continue
            if t.kind == "kw" and t.val == "return":
                self.next()
                exprs = []
                nt = self.peek()
                if not (nt.kind == "eof"
                        or (nt.kind == "kw" and nt.val in
                            ("end", "else", "elseif", "until"))
                        or (nt.kind == "sym" and nt.val == ";")):
                    exprs = self.explist()
                self.accept("sym", ";")
                stmts.append(("return", exprs))
                break
            stmts.append(self.statement())
        return stmts

    def statement(self):
        t = self.peek()
        if t.kind == "kw":
            if t.val == "break":
                self.next()
                return ("break",)
            if t.val == "do":
                self.next()
                b = self.block()
                self.expect("kw", "end")
                return ("do", b)
            if t.val == "while":
                self.next()
                cond = self.expr()
                self.expect("kw", "do")
                b = self.block()
                self.expect("kw", "end")
                return ("while", cond, b)
            if t.val == "repeat":
                self.next()
                b = self.block()
                self.expect("kw", "until")
                cond = self.expr()
                return ("repeat", b, cond)
            if t.val == "if":
                self.next()
                return self.if_stmt()
            if t.val == "for":
                self.next()
                return self.for_stmt()
            if t.val == "function":
                self.next()
                return self.func_stmt()
            if t.val == "local":
                self.next()
                if self.accept("kw", "function"):
                    name = self.expect("name").val
                    params, body = self.funcbody()
                    return ("localfunc", name, params, body)
                names = [self.expect("name").val]
                while self.accept("sym", ","):
                    names.append(self.expect("name").val)
                exprs = []
                if self.accept("sym", "="):
                    exprs = self.explist()
                return ("local", names, exprs)
        # expression statement: call or assignment
        e = self.suffixed_expr()
        t = self.peek()
        if t.kind == "sym" and t.val in ("=", ","):
            targets = [e]
            while self.accept("sym", ","):
                targets.append(self.suffixed_expr())
            self.expect("sym", "=")
            exprs = self.explist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    raise LuaError(f"line {t.line}: cannot assign to this "
                                   "expression")
            return ("assign", targets, exprs)
        if e[0] != "call":
            raise LuaError(f"line {t.line}: syntax error (unexpected "
                           "expression statement)")
        return ("callstat", e)

    def if_stmt(self):
        cond = self.expr()
        self.expect("kw", "then")
        then = self.block()
        t = self.next()
        if t.kind == "kw" and t.val == "elseif":
            return ("if", cond, then, [self.if_stmt()])
        if t.kind == "kw" and t.val == "else":
            other = self.block()
            self.expect("kw", "end")
            return ("if", cond, then, other)
        if t.kind == "kw" and t.val == "end":
            return ("if", cond, then, [])
        raise LuaError(f"line {t.line}: expected end/else/elseif")

    def for_stmt(self):
        name = self.expect("name").val
        if self.accept("sym", "="):
            start = self.expr()
            self.expect("sym", ",")
            stop = self.expr()
            step = None
            if self.accept("sym", ","):
                step = self.expr()
            self.expect("kw", "do")
            b = self.block()
            self.expect("kw", "end")
            return ("fornum", name, start, stop, step, b)
        names = [name]
        while self.accept("sym", ","):
            names.append(self.expect("name").val)
        self.expect("kw", "in")
        exprs = self.explist()
        self.expect("kw", "do")
        b = self.block()
        self.expect("kw", "end")
        return ("forin", names, exprs, b)

    def func_stmt(self):
        # funcname: Name {'.' Name}; ':' methods unsupported (clear error)
        target: Any = ("name", self.expect("name").val)
        while self.accept("sym", "."):
            target = ("index", target, ("const", self.expect("name").val))
        if self.peek().kind == "sym" and self.peek().val == ":":
            raise LuaError(f"line {self.peek().line}: method definitions "
                           "(':') are not supported by the embedded "
                           "interpreter")
        params, body = self.funcbody()
        return ("assign", [target], [("function", params, body)])

    def funcbody(self):
        self.expect("sym", "(")
        params = []
        if not self.accept("sym", ")"):
            while True:
                t = self.next()
                if t.kind == "name":
                    params.append(t.val)
                elif t.kind == "sym" and t.val == "...":
                    raise LuaError(f"line {t.line}: varargs ('...') are "
                                   "not supported")
                else:
                    raise LuaError(f"line {t.line}: bad parameter")
                if not self.accept("sym", ","):
                    break
            self.expect("sym", ")")
        body = self.block()
        self.expect("kw", "end")
        return params, body

    def explist(self):
        out = [self.expr()]
        while self.accept("sym", ","):
            out.append(self.expr())
        return out

    # precedence climbing
    _BINPRI = {
        "or": (1, 1), "and": (2, 2),
        "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3),
        "~=": (3, 3), "==": (3, 3),
        "..": (9, 8),  # right assoc
        "+": (10, 10), "-": (10, 10),
        "*": (11, 11), "/": (11, 11), "//": (11, 11), "%": (11, 11),
        "^": (14, 13),  # right assoc
    }
    _UNARY_PRI = 12

    def expr(self, limit: int = 0):
        t = self.peek()
        if (t.kind == "kw" and t.val == "not") or (
                t.kind == "sym" and t.val in ("-", "#")):
            self.next()
            operand = self.expr(self._UNARY_PRI)
            e = ("unop", t.val, operand)
        else:
            e = self.simple_expr()
        while True:
            t = self.peek()
            op = None
            if t.kind == "sym" and t.val in self._BINPRI:
                op = t.val
            elif t.kind == "kw" and t.val in ("and", "or"):
                op = t.val
            if op is None:
                break
            left_pri, right_pri = self._BINPRI[op]
            if left_pri <= limit:
                break
            self.next()
            rhs = self.expr(right_pri)
            e = ("binop", op, e, rhs)
        return e

    def simple_expr(self):
        t = self.peek()
        if t.kind == "num" or t.kind == "str":
            self.next()
            return ("const", t.val)
        if t.kind == "kw":
            if t.val == "nil":
                self.next()
                return ("const", None)
            if t.val == "true":
                self.next()
                return ("const", True)
            if t.val == "false":
                self.next()
                return ("const", False)
            if t.val == "function":
                self.next()
                params, body = self.funcbody()
                return ("function", params, body)
        if t.kind == "sym" and t.val == "{":
            return self.table_constructor()
        return self.suffixed_expr()

    def suffixed_expr(self):
        t = self.next()
        if t.kind == "name":
            e: Any = ("name", t.val)
        elif t.kind == "sym" and t.val == "(":
            e = self.expr()
            self.expect("sym", ")")
        else:
            raise LuaError(f"line {t.line}: unexpected {t.val!r}")
        while True:
            t = self.peek()
            if t.kind == "sym" and t.val == ".":
                self.next()
                e = ("index", e, ("const", self.expect("name").val))
            elif t.kind == "sym" and t.val == "[":
                self.next()
                k = self.expr()
                self.expect("sym", "]")
                e = ("index", e, k)
            elif t.kind == "sym" and t.val == "(":
                self.next()
                args = []
                if not self.accept("sym", ")"):
                    args = self.explist()
                    self.expect("sym", ")")
                e = ("call", e, args)
            elif t.kind == "str":
                self.next()
                e = ("call", e, [("const", t.val)])
            elif t.kind == "sym" and t.val == "{":
                e = ("call", e, [self.table_constructor()])
            elif t.kind == "sym" and t.val == ":":
                raise LuaError(f"line {t.line}: method calls (':') are "
                               "not supported by the embedded interpreter")
            else:
                return e

    def table_constructor(self):
        self.expect("sym", "{")
        fields = []  # ("pos", expr) | ("key", key_expr, expr)
        while not self.accept("sym", "}"):
            t = self.peek()
            if t.kind == "sym" and t.val == "[":
                self.next()
                k = self.expr()
                self.expect("sym", "]")
                self.expect("sym", "=")
                fields.append(("key", k, self.expr()))
            elif (t.kind == "name"
                  and self.toks[self.i + 1].kind == "sym"
                  and self.toks[self.i + 1].val == "="):
                self.next()
                self.next()
                fields.append(("key", ("const", t.val), self.expr()))
            else:
                fields.append(("pos", self.expr()))
            if not (self.accept("sym", ",") or self.accept("sym", ";")):
                self.expect("sym", "}")
                break
        return ("table", fields)


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------

class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e
            e = e.parent
        return None


def _truthy(v) -> bool:
    return v is not None and v is not False


def _num(v, what="operand"):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        if isinstance(v, str):
            try:
                return float(v) if ("." in v or "e" in v) else int(v)
            except ValueError:
                pass
        raise LuaError(f"arithmetic on non-number {what} ({type(v).__name__})")
    return v


def _lua_sub(v, a, b=None):
    """Lua string.sub(s, i[, j]) index semantics: 1-based inclusive, and
    a negative index counts from the end (-1 = last char), so
    sub(s, 1, -2) keeps all but the LAST character."""
    s = str(v)
    n = len(s)
    i = int(a)
    j = n if b is None else int(b)
    if i < 0:
        i = max(n + i + 1, 1)
    elif i == 0:
        i = 1
    if j < 0:
        j = n + j + 1
    elif j > n:
        j = n
    if i > j:
        return ""
    return s[i - 1:j]


def _tostr(v) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 1e16:
            return f"{v:.1f}"
        return repr(v)
    if isinstance(v, LuaTable):
        return f"table: 0x{id(v):x}"
    if isinstance(v, (_LuaFunction,)) or callable(v):
        return f"function: 0x{id(v):x}"
    return str(v)


class MiniLua:
    """One interpreter instance = one global environment."""

    def __init__(self):
        self.globals = _Env()
        self._install_stdlib()

    # -- public API ------------------------------------------------------
    def execute(self, src: str) -> None:
        try:
            # a lexer-path ValueError (e.g. a bare '0x' hitting
            # int(..., 16)) must surface as a LuaError like every other
            # script fault, not leak raw to the caller — with a parse
            # label, not the runtime one
            ast = _Parser(_lex(src)).parse_chunk()
        except LuaError:
            raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001
            raise LuaError(f"parse error: {e}") from e
        try:
            self._exec_block(ast, _Env(self.globals))
        except _Return:
            pass
        except LuaError:
            raise
        except _Break as e:
            # the parser accepts 'break' anywhere; outside a loop it must
            # surface as a script error, not leak the control exception
            raise LuaError("break outside a loop") from e
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001
            # host/stdlib exceptions must surface as script errors, not
            # raw Python tracebacks through the pipeline (host bindings
            # can raise anything, e.g. AttributeError — catch broadly)
            raise LuaError(f"runtime error: {e}") from e

    def get_global(self, name: str):
        return self.globals.vars.get(name)

    def set_global(self, name: str, value) -> None:
        self.globals.vars[name] = value

    def call(self, fn, *args):
        try:
            return self._call(fn, list(args))
        except LuaError:
            raise
        except _Break as e:
            raise LuaError("break outside a loop") from e
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001
            raise LuaError(f"runtime error: {e}") from e

    # -- stdlib ----------------------------------------------------------
    def _install_stdlib(self):
        g = self.globals.vars

        def _print(*args):
            print("\t".join(_tostr(a) for a in args))

        def _type(v):
            if v is None:
                return "nil"
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, (int, float)):
                return "number"
            if isinstance(v, str):
                return "string"
            if isinstance(v, LuaTable):
                return "table"
            return "function"

        def _tonumber(v, base=None):
            try:
                if base is not None:
                    return int(str(v), int(base))
                return _num(v)
            except (LuaError, ValueError):
                return None

        def _ipairs(t: LuaTable):
            def it(tbl, i):
                i = int(i) + 1
                v = tbl.get(i)
                if v is None:
                    return None
                return (i, v)
            return (it, t, 0)

        def _pairs(t: LuaTable):
            keys = list(t.h.keys())

            def it(tbl, k):
                if not keys:
                    return None
                if k is None:
                    nk = keys[0]
                else:
                    try:
                        nk_i = keys.index(k) + 1
                    except ValueError:
                        return None
                    if nk_i >= len(keys):
                        return None
                    nk = keys[nk_i]
                return (nk, tbl.get(nk))
            return (it, t, None)

        g["print"] = _print
        g["type"] = _type
        g["tonumber"] = _tonumber
        g["tostring"] = _tostr
        g["ipairs"] = _ipairs
        g["pairs"] = _pairs

        m = LuaTable()
        m.h.update({
            "floor": lambda x: int(_pymath.floor(_num(x))),
            "ceil": lambda x: int(_pymath.ceil(_num(x))),
            "abs": lambda x: abs(_num(x)),
            "max": lambda *a: max(_num(x) for x in a),
            "min": lambda *a: min(_num(x) for x in a),
            "sqrt": lambda x: _pymath.sqrt(_num(x)),
            "exp": lambda x: _pymath.exp(_num(x)),
            "log": lambda x, b=None: (_pymath.log(_num(x)) if b is None
                                      else _pymath.log(_num(x), _num(b))),
            "pow": lambda x, y: float(_num(x)) ** _num(y),
            "fmod": lambda x, y: _pymath.fmod(_num(x), _num(y)),
            "huge": _pymath.inf,
            "pi": _pymath.pi,
        })
        g["math"] = m

        def _format(fmt, *args):
            # Lua %d wants integer coercion; Python's % mostly matches
            out, ai = [], 0
            i = 0
            while i < len(fmt):
                c = fmt[i]
                if c == "%" and i + 1 < len(fmt):
                    j = i + 1
                    while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                        j += 1
                    conv = fmt[j]
                    spec = fmt[i:j + 1]
                    if conv == "%":
                        out.append("%")
                    else:
                        a = args[ai]
                        ai += 1
                        if conv in "di":
                            a = int(_num(a))
                            spec = spec[:-1] + "d"
                        elif conv in "eEfgG":
                            a = float(_num(a))
                        elif conv == "s":
                            a = _tostr(a)
                        out.append(spec % a)
                    i = j + 1
                else:
                    out.append(c)
                    i += 1
            return "".join(out)

        s = LuaTable()
        s.h.update({
            "format": _format,
            "len": lambda v: len(str(v)),
            "sub": _lua_sub,
            "rep": lambda v, k: str(v) * int(k),
            "byte": lambda v, i=1: ord(str(v)[int(i) - 1]),
            "char": lambda *a: "".join(chr(int(x)) for x in a),
            "upper": lambda v: str(v).upper(),
            "lower": lambda v: str(v).lower(),
        })
        g["string"] = s

    # -- execution -------------------------------------------------------
    def _exec_block(self, stmts, env: _Env):
        for st in stmts:
            k = st[0]
            if k == "local":
                _, names, exprs = st
                vals = self._eval_list(exprs, env, len(names))
                for nm, v in zip(names, vals):
                    env.vars[nm] = v
            elif k == "assign":
                _, targets, exprs = st
                vals = self._eval_list(exprs, env, len(targets))
                for tgt, v in zip(targets, vals):
                    self._assign(tgt, v, env)
            elif k == "callstat":
                self._eval(st[1], env)
            elif k == "if":
                _, cond, then, other = st
                if _truthy(self._eval(cond, env)):
                    self._exec_block(then, _Env(env))
                else:
                    self._exec_block(other, _Env(env))
            elif k == "while":
                _, cond, body = st
                while _truthy(self._eval(cond, env)):
                    try:
                        self._exec_block(body, _Env(env))
                    except _Break:
                        break
            elif k == "repeat":
                _, body, cond = st
                while True:
                    scope = _Env(env)
                    try:
                        self._exec_block(body, scope)
                    except _Break:
                        break
                    if _truthy(self._eval(cond, scope)):
                        break
            elif k == "fornum":
                _, name, e0, e1, e2, body = st
                i = _num(self._eval(e0, env))
                stop = _num(self._eval(e1, env))
                step = _num(self._eval(e2, env)) if e2 is not None else 1
                if step == 0:
                    raise LuaError("'for' step is zero")
                while (i <= stop) if step > 0 else (i >= stop):
                    scope = _Env(env)
                    scope.vars[name] = i
                    try:
                        self._exec_block(body, scope)
                    except _Break:
                        break
                    i += step
            elif k == "forin":
                _, names, exprs, body = st
                vals = self._eval_list(exprs, env, 3)
                fn, state, ctrl = vals[0], vals[1], vals[2]
                while True:
                    res = self._call(fn, [state, ctrl])
                    if isinstance(res, tuple):
                        res_list = list(res)
                    elif res is None:
                        res_list = [None]
                    else:
                        res_list = [res]
                    if res_list[0] is None:
                        break
                    ctrl = res_list[0]
                    scope = _Env(env)
                    for idx, nm in enumerate(names):
                        scope.vars[nm] = (res_list[idx]
                                          if idx < len(res_list) else None)
                    try:
                        self._exec_block(body, scope)
                    except _Break:
                        break
            elif k == "do":
                self._exec_block(st[1], _Env(env))
            elif k == "localfunc":
                _, name, params, body = st
                env.vars[name] = None
                env.vars[name] = _LuaFunction(params, body, env, name)
            elif k == "break":
                raise _Break()
            elif k == "return":
                vals = self._eval_list(st[1], env, None)
                raise _Return(vals)
            else:  # pragma: no cover — parser emits only the above
                raise LuaError(f"unknown statement {k}")

    def _assign(self, target, value, env: _Env):
        if target[0] == "name":
            name = target[1]
            scope = env.lookup(name)
            (scope.vars if scope else self.globals.vars)[name] = value
        else:  # ("index", obj, key)
            obj = self._eval(target[1], env)
            key = self._eval(target[2], env)
            if isinstance(obj, LuaTable):
                obj.set(key, value)
            elif hasattr(obj, "lua_newindex"):
                obj.lua_newindex(key, value)
            else:
                raise LuaError(f"cannot index a {type(obj).__name__} value")

    def _eval_list(self, exprs, env, want: Optional[int]):
        vals: List[Any] = []
        for i, e in enumerate(exprs):
            v = self._eval(e, env, multi=(i == len(exprs) - 1))
            if i == len(exprs) - 1 and isinstance(v, tuple):
                vals.extend(v)
            else:
                vals.append(v[0] if isinstance(v, tuple) else v)
        if want is not None:
            while len(vals) < want:
                vals.append(None)
            vals = vals[:want]
        return vals

    def _eval(self, e, env: _Env, multi: bool = False):
        k = e[0]
        if k == "const":
            return e[1]
        if k == "name":
            scope = env.lookup(e[1])
            return scope.vars[e[1]] if scope else None
        if k == "index":
            obj = self._eval(e[1], env)
            key = self._eval(e[2], env)
            if isinstance(obj, LuaTable):
                return obj.get(key)
            if hasattr(obj, "lua_index"):
                return obj.lua_index(key)
            if isinstance(obj, str):
                raise LuaError("string methods are not supported; use the "
                               "string.* library functions")
            raise LuaError(f"cannot index a {type(obj).__name__} value"
                           + (f" (field {key!r})" if isinstance(key, str)
                              else ""))
        if k == "call":
            fn = self._eval(e[1], env)
            args = self._eval_list(e[2], env, None)
            res = self._call(fn, args)
            if multi:
                return res
            return res[0] if isinstance(res, tuple) else res
        if k == "function":
            return _LuaFunction(e[1], e[2], env)
        if k == "table":
            t = LuaTable()
            pos = 1
            for f in e[1]:
                if f[0] == "pos":
                    t.set(pos, self._eval(f[1], env))
                    pos += 1
                else:
                    t.set(self._eval(f[1], env), self._eval(f[2], env))
            return t
        if k == "unop":
            op = e[1]
            if op == "not":
                return not _truthy(self._eval(e[2], env))
            v = self._eval(e[2], env)
            if op == "-":
                return -_num(v)
            if op == "#":
                if isinstance(v, str):
                    return len(v)
                if isinstance(v, LuaTable):
                    return v.length()
                if hasattr(v, "lua_length"):
                    return v.lua_length()
                raise LuaError("attempt to get length of a "
                               f"{type(v).__name__} value")
        if k == "binop":
            op = e[1]
            if op == "and":
                lhs = self._eval(e[2], env)
                return self._eval(e[3], env) if _truthy(lhs) else lhs
            if op == "or":
                lhs = self._eval(e[2], env)
                return lhs if _truthy(lhs) else self._eval(e[3], env)
            a = self._eval(e[2], env)
            b = self._eval(e[3], env)
            if op == "..":
                return _tostr(a) + _tostr(b)
            if op == "==":
                return a == b
            if op == "~=":
                return a != b
            if op in ("<", ">", "<=", ">="):
                if isinstance(a, str) and isinstance(b, str):
                    pass
                else:
                    a, b = _num(a), _num(b)
                return {"<": a < b, ">": a > b,
                        "<=": a <= b, ">=": a >= b}[op]
            a, b = _num(a), _num(b)
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                # Lua float division: x/0 is ±inf, 0/0 is nan
                if b == 0:
                    if a == 0:
                        return _pymath.nan
                    return _pymath.inf if a > 0 else -_pymath.inf
                return a / b
            if op == "//":
                if b == 0:
                    if isinstance(a, int) and isinstance(b, int):
                        raise LuaError("attempt to perform 'n//0'")
                    return _pymath.inf if a > 0 else (
                        -_pymath.inf if a < 0 else _pymath.nan)
                return _pymath.floor(a / b)
            if op == "%":
                if b == 0:
                    if isinstance(a, int) and isinstance(b, int):
                        raise LuaError("attempt to perform 'n%%0'")
                    return _pymath.nan
                return a - _pymath.floor(a / b) * b
            if op == "^":
                return float(a) ** b
        raise LuaError(f"cannot evaluate {k}")  # pragma: no cover

    def _call(self, fn, args: List[Any]):
        if isinstance(fn, _LuaFunction):
            scope = _Env(fn.env)
            for i, p in enumerate(fn.params):
                scope.vars[p] = args[i] if i < len(args) else None
            try:
                self._exec_block(fn.body, scope)
            except _Return as r:
                if len(r.values) == 0:
                    return None
                if len(r.values) == 1:
                    return r.values[0]
                return tuple(r.values)
            return None
        if callable(fn):
            return fn(*args)
        raise LuaError(f"attempt to call a {type(fn).__name__} value")
