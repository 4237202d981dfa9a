"""samtools/htslib filter-expression evaluator over BamRecord.

The reference exposes htslib's `hts_filter` language on its extractor
(reference: src/lancet/hts/extractor.h:88, extractor.cpp:57-63; language
spec: samtools "FILTER EXPRESSIONS" man section). This is a native
re-implementation of the commonly used subset, compiled to a Python
predicate once and evaluated per record:

  identifiers  flag, flag.paired, flag.proper_pair, flag.unmap,
               flag.munmap, flag.reverse, flag.mreverse, flag.read1,
               flag.read2, flag.secondary, flag.qcfail, flag.dup,
               flag.supplementary, mapq, pos, mpos/pnext, tid/refid,
               mtid/mrefid, rlen, qlen, endpos, tlen/insert, qname, rname
  aux tags     [NM], [SA], ... (missing tag => null: comparisons false,
               `exists` semantics via bare [TAG])
  literals     integers (0x hex ok), floats, "strings"
  operators    ! && || == != < <= > >= =~ !~ + - * / %  and parentheses

Errors raise FilterExprError at parse time (reference behavior: invalid
expressions abort at startup, extractor.cpp:59-62).
"""

from __future__ import annotations

import re

__all__ = ["FilterExprError", "compile_filter"]


class FilterExprError(ValueError):
    pass


_TOKEN = re.compile(
    r"""\s*(?:
        (?P<num>0[xX][0-9a-fA-F]+|\d+\.\d*|\.\d+|\d+)
      | (?P<str>"[^"]*"|'[^']*')
      | (?P<tag>\[[A-Za-z][A-Za-z0-9]\])
      | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
      | (?P<op>&&|\|\||==|!=|<=|>=|=~|!~|[!<>+\-*/%()&|^~])
    )""",
    re.VERBOSE,
)

_FLAG_BITS = {
    "paired": 0x1, "proper_pair": 0x2, "unmap": 0x4, "munmap": 0x8,
    "reverse": 0x10, "mreverse": 0x20, "read1": 0x40, "read2": 0x80,
    "secondary": 0x100, "qcfail": 0x200, "dup": 0x400,
    "supplementary": 0x800,
}

# identifier -> record accessor. pos/mpos/endpos are 1-based in the
# expression language (matching samtools).
_FIELDS = {
    "flag": lambda r: r.flag,
    "mapq": lambda r: r.mapq,
    "pos": lambda r: r.pos0 + 1,
    "mpos": lambda r: r.next_pos0 + 1,
    "pnext": lambda r: r.next_pos0 + 1,
    "tid": lambda r: r.ref_id,
    "refid": lambda r: r.ref_id,
    "mtid": lambda r: r.next_ref_id,
    "mrefid": lambda r: r.next_ref_id,
    "rlen": lambda r: sum(l for op, l in r.cigar if op in (0, 2, 3, 7, 8)),
    "qlen": lambda r: len(r.seq),
    "endpos": lambda r: r.reference_end0(),
    "tlen": lambda r: r.tlen,
    "insert": lambda r: r.tlen,
    "qname": lambda r: r.qname,
}

_NULL = object()  # missing aux tag


def _tokenize(expr: str):
    out = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN.match(expr, pos)
        if m is None or m.end() == pos:
            rest = expr[pos:].strip()
            if not rest:
                break
            raise FilterExprError(f"bad token at: {rest[:20]!r}")
        pos = m.end()
        if m.group("num") is not None:
            text = m.group("num")
            val = int(text, 16) if text.lower().startswith("0x") else (
                float(text) if "." in text else int(text)
            )
            out.append(("num", val))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1]))
        elif m.group("tag") is not None:
            out.append(("tag", m.group("tag")[1:-1]))
        elif m.group("ident") is not None:
            out.append(("ident", m.group("ident")))
        else:
            out.append(("op", m.group("op")))
    out.append(("end", None))
    return out


class _Parser:
    """Pratt parser -> nested closures rec -> value."""

    _BINARY = {
        "||": 1, "&&": 2,
        "|": 3, "^": 4, "&": 5,
        "==": 6, "!=": 6, "=~": 6, "!~": 6,
        "<": 7, "<=": 7, ">": 7, ">=": 7,
        "+": 8, "-": 8,
        "*": 9, "/": 9, "%": 9,
    }

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def parse(self):
        fn = self.expr(0)
        if self.peek()[0] != "end":
            raise FilterExprError(f"trailing input: {self.peek()!r}")
        return fn

    def expr(self, min_bp):
        fn = self.atom()
        while True:
            kind, val = self.peek()
            if kind != "op" or val not in self._BINARY:
                break
            bp = self._BINARY[val]
            if bp < min_bp:
                break
            self.next()
            rhs = self.expr(bp + 1)
            fn = self._binop(val, fn, rhs)
        return fn

    def atom(self):
        kind, val = self.next()
        if kind == "num" or kind == "str":
            return lambda r, v=val: v
        if kind == "tag":
            tag = val
            return lambda r: r.tags.get(tag, _NULL)
        if kind == "ident":
            if val.startswith("flag."):
                bit = _FLAG_BITS.get(val[5:])
                if bit is None:
                    raise FilterExprError(f"unknown flag field: {val}")
                return lambda r, b=bit: 1 if (r.flag & b) else 0
            acc = _FIELDS.get(val)
            if acc is None:
                raise FilterExprError(f"unknown identifier: {val}")
            return acc
        if kind == "op" and val == "(":
            fn = self.expr(0)
            k, v = self.next()
            if (k, v) != ("op", ")"):
                raise FilterExprError("missing )")
            return fn
        if kind == "op" and val == "!":
            inner = self.atom()
            return lambda r: 0 if _truthy(inner(r)) else 1
        if kind == "op" and val == "-":
            inner = self.atom()
            return lambda r: -_num(inner(r))
        if kind == "op" and val == "~":
            inner = self.atom()
            return lambda r: ~int(_num(inner(r)))
        raise FilterExprError(f"unexpected token: {val!r}")

    @staticmethod
    def _binop(op, lhs, rhs):
        if op == "&&":
            return lambda r: 1 if (_truthy(lhs(r)) and _truthy(rhs(r))) else 0
        if op == "||":
            return lambda r: 1 if (_truthy(lhs(r)) or _truthy(rhs(r))) else 0
        if op in ("=~", "!~"):
            def regex(r):
                a, b = lhs(r), rhs(r)
                if a is _NULL or b is _NULL:
                    return 0
                hit = re.search(str(b), str(a)) is not None
                return 1 if (hit == (op == "=~")) else 0
            return regex

        import operator

        fns = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
               "<=": operator.le, ">": operator.gt, ">=": operator.ge,
               "+": operator.add, "-": operator.sub, "*": operator.mul,
               "/": operator.truediv, "%": operator.mod,
               "&": lambda a, b: int(a) & int(b),
               "|": lambda a, b: int(a) | int(b),
               "^": lambda a, b: int(a) ^ int(b)}
        f = fns[op]
        cmp = op in ("==", "!=", "<", "<=", ">", ">=")

        def apply(r):
            a, b = lhs(r), rhs(r)
            if a is _NULL or b is _NULL:
                return 0  # null comparisons/arithmetic are false/0
            if isinstance(a, str) != isinstance(b, str):
                if cmp:
                    return 1 if f(str(a), str(b)) else 0
                raise FilterExprError("type mismatch in arithmetic")
            res = f(a, b)
            return (1 if res else 0) if cmp else res

        return apply


def _truthy(v) -> bool:
    if v is _NULL:
        return False
    if isinstance(v, str):
        return bool(v)
    return v != 0


def _num(v):
    if v is _NULL:
        return 0
    return v


def compile_filter(expr: str):
    """Compile an expression to a predicate `rec -> bool`.

    Raises FilterExprError on invalid syntax (startup fail-fast, like the
    reference's SetFilterExpression)."""
    fn = _Parser(_tokenize(expr)).parse()

    def predicate(rec) -> bool:
        return _truthy(fn(rec))

    return predicate
