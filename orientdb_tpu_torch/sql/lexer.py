"""Port of `orientdb_tpu/sql/lexer.py`: a copy with its imports pointed at
this package, so the port parses exactly what the reference parses.

SQL lexer.

The reference's tokenizer is generated by JavaCC from OrientSql.jj ([E]
core/.../sql/parser/); here a compact hand-written scanner. Keywords are NOT
reserved at the lexer level (OrientDB lets most keywords appear as
identifiers/field names); the parser matches keyword spellings
case-insensitively where the grammar needs them.

Token kinds:
  NUMBER  int/float literal (value parsed)
  STRING  quoted '…' or "…" with backslash escapes
  IDENT   bare or `backtick` identifier; includes @attr names (@rid, @class)
  VAR     $context variable, without the $
  RID     #<cluster>:<pos>
  ARROW   ->
  OP      punctuation/operators: ( ) { } [ ] , : . - + * / % = == != <> < <= > >= ? |
  EOF
"""

from __future__ import annotations

from typing import List, NamedTuple


class LexError(Exception):
    pass


class Token(NamedTuple):
    kind: str
    text: str
    value: object
    pos: int

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.kind}({self.text!r})"


_PUNCT2 = ("->", "==", "!=", "<>", "<=", ">=", "||")
_PUNCT1 = "(){}[],:.+-*/%=<>?|"


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        # comments: /* block */ only — '--' would be ambiguous with MATCH's
        # anonymous both-direction arrow ({a}--{b}) and anonymous out arrow
        # ({a}-->{b})
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        start = i
        # RID literal: #int:int
        if c == "#":
            j = i + 1
            neg1 = j < n and text[j] == "-"
            if neg1:
                j += 1
            k = j
            while k < n and text[k].isdigit():
                k += 1
            if k > j and k < n and text[k] == ":":
                m = k + 1
                neg2 = m < n and text[m] == "-"
                if neg2:
                    m += 1
                p = m
                while p < n and text[p].isdigit():
                    p += 1
                if p > m:
                    cl = int(text[i + 1 : k])
                    po = int(text[k + 1 : p])
                    toks.append(Token("RID", text[i:p], (cl, po), start))
                    i = p
                    continue
            raise LexError(f"malformed RID at {i}: {text[i:i+12]!r}")
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            isfloat = False
            while j < n and text[j].isdigit():
                j += 1
            if j < n and text[j] == "." and j + 1 < n and text[j + 1].isdigit():
                isfloat = True
                j += 1
                while j < n and text[j].isdigit():
                    j += 1
            if j < n and text[j] in "eE":
                k = j + 1
                if k < n and text[k] in "+-":
                    k += 1
                if k < n and text[k].isdigit():
                    isfloat = True
                    j = k
                    while j < n and text[j].isdigit():
                        j += 1
            lit = text[i:j]
            toks.append(Token("NUMBER", lit, float(lit) if isfloat else int(lit), start))
            i = j
            continue
        # strings
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while j < n:
                ch = text[j]
                if ch == "\\" and j + 1 < n:
                    esc = text[j + 1]
                    buf.append(
                        {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", quote: quote}.get(
                            esc, esc
                        )
                    )
                    j += 2
                    continue
                if ch == quote:
                    break
                buf.append(ch)
                j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            toks.append(Token("STRING", text[i : j + 1], "".join(buf), start))
            i = j + 1
            continue
        # backtick identifiers
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                raise LexError(f"unterminated `identifier` at {i}")
            toks.append(Token("IDENT", text[i : j + 1], text[i + 1 : j], start))
            i = j + 1
            continue
        # $context vars
        if c == "$":
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            if j == i + 1:
                raise LexError(f"bare '$' at {i}")
            toks.append(Token("VAR", text[i:j], text[i + 1 : j], start))
            i = j
            continue
        # identifiers (including @attrs)
        if c.isalpha() or c == "_" or c == "@":
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            toks.append(Token("IDENT", word, word, start))
            i = j
            continue
        # two-char punctuation
        two = text[i : i + 2]
        if two in _PUNCT2:
            toks.append(Token("ARROW" if two == "->" else "OP", two, two, start))
            i += 2
            continue
        if c in _PUNCT1:
            toks.append(Token("OP", c, c, start))
            i += 1
            continue
        if c == "!":
            raise LexError(f"unexpected '!' at {i} (did you mean '!=' ?)")
        if c == ";":
            i += 1  # statement terminator: tolerated and ignored
            continue
        raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token("EOF", "", None, n))
    return toks
