"""Runtime expression engine: parse -> AST -> simplify -> differentiate -> torch.

The PyTorch counterpart of marlin_tpu/expression.py: the parser, simplifier
and symbolic derivative are the same code; the AST is evaluated eagerly on
torch tensors by `TorchOps` (reference: src/utils/MarlinExpressionParser.C,
include/utils/MarlinExpressionParser.h:383-427).

Grammar (mirrors reference include/utils/MarlinExpressionParser.h:383-427):

    EXPRESSION  <- (ASSIGNMENT ';')* LOGICAL
    ASSIGNMENT  <- IDENTIFIER ':=' LOGICAL
    LOGICAL     <- COMPARISON (('|' / '&') COMPARISON)*
    COMPARISON  <- ADDITIVE (COMP_OP ADDITIVE)?
    COMP_OP     <- '<=' / '>=' / '==' / '!=' / '<' / '>'
    ADDITIVE    <- MULTITIVE (('+' / '-') MULTITIVE)*
    MULTITIVE   <- UNARY (('*' / '/' / '%') UNARY)*
    UNARY       <- (('-' / '!') UNARY) / POWER
    POWER       <- PRIMARY ('^' POWER)?
    PRIMARY     <- FUNCTION / NUMBER / VARIABLE / '(' LOGICAL ')'

Symbolic differentiation follows the reference's rules
(src/utils/MarlinExpressionParser.C:613-766), including let-expression
chain-rule handling with `d<name>` bindings.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


class ExpressionError(Exception):
    """Raised on parse or evaluation errors."""


# ---------------------------------------------------------------------------
# AST nodes
# ---------------------------------------------------------------------------


class Expr:
    def simplify(self) -> "Expr":
        return self

    def differentiate(self, var: str) -> "Expr":
        raise NotImplementedError

    def substitute(self, var: str, replacement: "Expr") -> "Expr":
        return self

    def evaluate(self, env: Dict[str, object], ops: "Ops") -> object:
        raise NotImplementedError

    def free_variables(self) -> set:
        return set()


@dataclass(frozen=True)
class Constant(Expr):
    value: float

    def differentiate(self, var):
        return Constant(0.0)

    def evaluate(self, env, ops):
        return self.value

    def __str__(self):
        # match FParser-ish printing: integers without trailing .0
        v = self.value
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)


@dataclass(frozen=True)
class NamedConstant(Expr):
    """A named scalar (or tensor) constant bound at parse time.

    The reference resolves these to 0-d torch tensors (ConstantTensor AST node,
    src/utils/MarlinExpressionParser.C); we keep the name and look the value up
    in the environment at evaluation time so complex constants like `i` work.
    """

    name: str

    def differentiate(self, var):
        return Constant(0.0)

    def evaluate(self, env, ops):
        try:
            return env[self.name]
        except KeyError:
            raise ExpressionError(f"Unbound constant '{self.name}'")

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class Variable(Expr):
    name: str

    def differentiate(self, var):
        return Constant(1.0) if var == self.name else Constant(0.0)

    def substitute(self, var, replacement):
        return replacement if var == self.name else self

    def evaluate(self, env, ops):
        try:
            return env[self.name]
        except KeyError:
            raise ExpressionError(f"Unbound variable '{self.name}'")

    def free_variables(self):
        return {self.name}

    def __str__(self):
        return self.name


def _const(e: Expr) -> Optional[float]:
    return e.value if isinstance(e, Constant) else None


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # 'neg' | 'not'
    operand: Expr

    def simplify(self):
        a = self.operand.simplify()
        c = _const(a)
        if self.op == "neg":
            if c is not None:
                return Constant(-c)
            if isinstance(a, UnaryOp) and a.op == "neg":
                return a.operand
            return UnaryOp("neg", a)
        else:  # not
            if c is not None:
                return Constant(0.0 if c != 0.0 else 1.0)
            return UnaryOp("not", a)

    def differentiate(self, var):
        if self.op == "neg":
            return UnaryOp("neg", self.operand.differentiate(var))
        return Constant(0.0)

    def substitute(self, var, replacement):
        return UnaryOp(self.op, self.operand.substitute(var, replacement))

    def evaluate(self, env, ops):
        v = self.operand.evaluate(env, ops)
        if self.op == "neg":
            return ops.neg(v)
        return ops.logical_not(v)

    def free_variables(self):
        return self.operand.free_variables()

    def __str__(self):
        return ("-" if self.op == "neg" else "!") + f"({self.operand})"


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # '+', '-', '*', '/', '%', '^'
    left: Expr
    right: Expr

    def simplify(self):  # noqa: C901 - large but flat rule table
        l = self.left.simplify()
        r = self.right.simplify()
        lc, rc = _const(l), _const(r)
        op = self.op

        if lc is not None and rc is not None:
            try:
                if op == "+":
                    return Constant(lc + rc)
                if op == "-":
                    return Constant(lc - rc)
                if op == "*":
                    return Constant(lc * rc)
                if op == "/":
                    if rc != 0.0:
                        return Constant(lc / rc)
                if op == "%":
                    if rc != 0.0:
                        return Constant(math.fmod(lc, rc))
                if op == "^":
                    return Constant(lc**rc)
            except (OverflowError, ValueError):
                pass

        # algebraic identities (reference src/utils/MarlinExpressionParser.C:50-130)
        if op == "+":
            if lc == 0.0:
                return r
            if rc == 0.0:
                return l
        elif op == "-":
            if rc == 0.0:
                return l
            if lc == 0.0:
                return UnaryOp("neg", r).simplify()
        elif op == "*":
            if lc == 0.0 or rc == 0.0:
                return Constant(0.0)
            if lc == 1.0:
                return r
            if rc == 1.0:
                return l
            if lc == -1.0:
                return UnaryOp("neg", r).simplify()
            if rc == -1.0:
                return UnaryOp("neg", l).simplify()
        elif op == "/":
            if lc == 0.0:
                return Constant(0.0)
            if rc == 1.0:
                return l
            if rc == -1.0:
                return UnaryOp("neg", l).simplify()
        elif op == "^":
            if rc == 0.0:
                return Constant(1.0)
            if rc == 1.0:
                return l
            if lc == 1.0:
                return Constant(1.0)

        return BinaryOp(op, l, r)

    def differentiate(self, var):
        l, r, op = self.left, self.right, self.op
        dl = l.differentiate(var)
        dr = r.differentiate(var)
        if op == "+":
            return BinaryOp("+", dl, dr)
        if op == "-":
            return BinaryOp("-", dl, dr)
        if op == "*":
            return BinaryOp("+", BinaryOp("*", dl, r), BinaryOp("*", l, dr))
        if op == "/":
            # (dl*r - l*dr) / r^2
            num = BinaryOp("-", BinaryOp("*", dl, r), BinaryOp("*", l, dr))
            return BinaryOp("/", num, BinaryOp("^", r, Constant(2.0)))
        if op == "%":
            return dl  # d/dx (a mod c) = da for constant-ish modulus
        if op == "^":
            rc = _const(r)
            if rc is not None:
                # d(l^c) = c * l^(c-1) * dl
                return BinaryOp(
                    "*",
                    BinaryOp("*", Constant(rc), BinaryOp("^", l, Constant(rc - 1.0))),
                    dl,
                )
            # general: l^r * (dr*log(l) + r*dl/l)
            # (reference: MarlinExpressionParser.C:192 uses log())
            term1 = BinaryOp("*", dr, FunctionCall("log", (l,)))
            term2 = BinaryOp("/", BinaryOp("*", r, dl), l)
            return BinaryOp("*", BinaryOp("^", l, r), BinaryOp("+", term1, term2))
        raise ExpressionError(f"Unknown binary op {op}")

    def substitute(self, var, replacement):
        return BinaryOp(
            self.op,
            self.left.substitute(var, replacement),
            self.right.substitute(var, replacement),
        )

    def evaluate(self, env, ops):
        a = self.left.evaluate(env, ops)
        b = self.right.evaluate(env, ops)
        return ops.binary(self.op, a, b)

    def free_variables(self):
        return self.left.free_variables() | self.right.free_variables()

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class Comparison(Expr):
    op: str  # '<', '>', '<=', '>=', '==', '!='
    left: Expr
    right: Expr

    def simplify(self):
        l = self.left.simplify()
        r = self.right.simplify()
        lc, rc = _const(l), _const(r)
        if lc is not None and rc is not None:
            table = {
                "<": lc < rc,
                ">": lc > rc,
                "<=": lc <= rc,
                ">=": lc >= rc,
                "==": lc == rc,
                "!=": lc != rc,
            }
            return Constant(1.0 if table[self.op] else 0.0)
        return Comparison(self.op, l, r)

    def differentiate(self, var):
        # not differentiable in the classical sense (reference :357-362)
        return Constant(0.0)

    def substitute(self, var, replacement):
        return Comparison(
            self.op,
            self.left.substitute(var, replacement),
            self.right.substitute(var, replacement),
        )

    def evaluate(self, env, ops):
        a = self.left.evaluate(env, ops)
        b = self.right.evaluate(env, ops)
        return ops.compare(self.op, a, b)

    def free_variables(self):
        return self.left.free_variables() | self.right.free_variables()

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class LogicalOp(Expr):
    op: str  # '&', '|'
    left: Expr
    right: Expr

    def simplify(self):
        l = self.left.simplify()
        r = self.right.simplify()
        lc, rc = _const(l), _const(r)
        if lc is not None and rc is not None:
            lv, rv = lc != 0.0, rc != 0.0
            return Constant(1.0 if (lv and rv if self.op == "&" else lv or rv) else 0.0)
        if self.op == "&":
            if lc == 0.0 or rc == 0.0:
                return Constant(0.0)
        else:
            if (lc is not None and lc != 0.0) or (rc is not None and rc != 0.0):
                return Constant(1.0)
        return LogicalOp(self.op, l, r)

    def differentiate(self, var):
        return Constant(0.0)

    def substitute(self, var, replacement):
        return LogicalOp(
            self.op,
            self.left.substitute(var, replacement),
            self.right.substitute(var, replacement),
        )

    def evaluate(self, env, ops):
        a = self.left.evaluate(env, ops)
        b = self.right.evaluate(env, ops)
        return ops.logical(self.op, a, b)

    def free_variables(self):
        return self.left.free_variables() | self.right.free_variables()

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


#: unary function name -> (math fn, derivative builder)
_UNARY_FUNCS = (
    "sin cos tan sinh cosh tanh asin acos atan asinh acosh atanh "
    "exp log log10 log2 sqrt abs ceil floor round trunc erf"
).split()


@dataclass(frozen=True)
class FunctionCall(Expr):
    name: str
    args: Tuple[Expr, ...]

    def simplify(self):  # noqa: C901
        args = tuple(a.simplify() for a in self.args)
        cvals = [_const(a) for a in args]
        if all(c is not None for c in cvals):
            try:
                v = _fold_function(self.name, [c for c in cvals])
                if v is not None:
                    return Constant(v)
            except (ValueError, OverflowError, ZeroDivisionError):
                pass
        return FunctionCall(self.name, args)

    def differentiate(self, var):  # noqa: C901
        # reference rules: src/utils/MarlinExpressionParser.C:613-766
        name, args = self.name, self.args
        if name in _UNARY_FUNCS:
            (a,) = args
            da = a.differentiate(var)
            F = FunctionCall
            B = BinaryOp
            if name == "sin":
                inner = F("cos", (a,))
            elif name == "cos":
                inner = UnaryOp("neg", F("sin", (a,)))
            elif name == "tan":
                c = F("cos", (a,))
                inner = BinaryOp("/", Constant(1.0), B("*", c, c))
            elif name == "sinh":
                inner = F("cosh", (a,))
            elif name == "cosh":
                inner = F("sinh", (a,))
            elif name == "tanh":
                t = F("tanh", (a,))
                inner = B("-", Constant(1.0), B("*", t, t))
            elif name == "asin":
                inner = B(
                    "/",
                    Constant(1.0),
                    F("sqrt", (B("-", Constant(1.0), B("*", a, a)),)),
                )
            elif name == "acos":
                inner = UnaryOp(
                    "neg",
                    B(
                        "/",
                        Constant(1.0),
                        F("sqrt", (B("-", Constant(1.0), B("*", a, a)),)),
                    ),
                )
            elif name == "atan":
                inner = B("/", Constant(1.0), B("+", Constant(1.0), B("*", a, a)))
            elif name == "asinh":
                inner = B(
                    "/",
                    Constant(1.0),
                    F("sqrt", (B("+", B("*", a, a), Constant(1.0)),)),
                )
            elif name == "acosh":
                inner = B(
                    "/",
                    Constant(1.0),
                    F("sqrt", (B("-", B("*", a, a), Constant(1.0)),)),
                )
            elif name == "atanh":
                inner = B("/", Constant(1.0), B("-", Constant(1.0), B("*", a, a)))
            elif name == "exp":
                inner = F("exp", (a,))
            elif name == "log":
                inner = B("/", Constant(1.0), a)
            elif name == "log10":
                inner = B("/", Constant(1.0), B("*", a, Constant(math.log(10.0))))
            elif name == "log2":
                inner = B("/", Constant(1.0), B("*", a, Constant(math.log(2.0))))
            elif name == "sqrt":
                inner = B("/", Constant(0.5), F("sqrt", (a,)))
            elif name == "abs":
                # d|a| = sign(a); expressed via comparison (a>=0)*2-1
                inner = B(
                    "-",
                    B("*", Comparison(">=", a, Constant(0.0)), Constant(2.0)),
                    Constant(1.0),
                )
            elif name == "erf":
                inner = B(
                    "*",
                    Constant(2.0 / math.sqrt(math.pi)),
                    F("exp", (UnaryOp("neg", B("*", a, a)),)),
                )
            elif name in ("ceil", "floor", "round", "trunc"):
                return Constant(0.0)
            else:
                raise ExpressionError(f"Cannot differentiate function '{name}'")
            return BinaryOp("*", inner, da)

        if name == "pow":
            base, expo = args
            return BinaryOp("^", base, expo).differentiate(var)
        if name in ("min", "max"):
            a, b = args
            da, db = a.differentiate(var), b.differentiate(var)
            cmp_op = "<=" if name == "min" else ">="
            cond = Comparison(cmp_op, a, b)
            return FunctionCall("if", (cond, da, db))
        if name == "atan2":
            y, x = args
            dy, dx = y.differentiate(var), x.differentiate(var)
            num = BinaryOp("-", BinaryOp("*", x, dy), BinaryOp("*", y, dx))
            den = BinaryOp("+", BinaryOp("*", x, x), BinaryOp("*", y, y))
            return BinaryOp("/", num, den)
        if name == "hypot":
            a, b = args
            da, db = a.differentiate(var), b.differentiate(var)
            num = BinaryOp("+", BinaryOp("*", a, da), BinaryOp("*", b, db))
            return BinaryOp("/", num, FunctionCall("hypot", (a, b)))
        if name == "if":
            cond, t, f = args
            return FunctionCall("if", (cond, t.differentiate(var), f.differentiate(var)))
        raise ExpressionError(f"Cannot differentiate function '{name}'")

    def substitute(self, var, replacement):
        return FunctionCall(
            self.name, tuple(a.substitute(var, replacement) for a in self.args)
        )

    def evaluate(self, env, ops):
        if (self.name == "if" and len(self.args) == 3
                and getattr(ops, "lazy_if", False)):
            # FParser semantics: only the taken branch is evaluated, so
            # guarded division if(a!=0, 1/a, 0) cannot crash on the host
            cond = self.args[0].evaluate(env, ops)
            return self.args[1 if cond != 0.0 else 2].evaluate(env, ops)
        args = [a.evaluate(env, ops) for a in self.args]
        return ops.call(self.name, args)

    def free_variables(self):
        out = set()
        for a in self.args:
            out |= a.free_variables()
        return out

    def __str__(self):
        return f"{self.name}({', '.join(str(a) for a in self.args)})"


def _fold_function(name: str, v: List[float]) -> Optional[float]:
    if len(v) == 1:
        x = v[0]
        table = {
            "sin": math.sin,
            "cos": math.cos,
            "tan": math.tan,
            "sinh": math.sinh,
            "cosh": math.cosh,
            "tanh": math.tanh,
            "asin": math.asin,
            "acos": math.acos,
            "atan": math.atan,
            "asinh": math.asinh,
            "acosh": math.acosh,
            "atanh": math.atanh,
            "exp": math.exp,
            "log": math.log,
            "log10": math.log10,
            "log2": math.log2,
            "sqrt": math.sqrt,
            "abs": abs,
            "ceil": math.ceil,
            "floor": math.floor,
            "round": lambda x: float(round(x)),
            "trunc": math.trunc,
            "erf": math.erf,
        }
        fn = table.get(name)
        return float(fn(x)) if fn else None
    if len(v) == 2:
        x, y = v
        table2 = {
            "min": min,
            "max": max,
            "atan2": math.atan2,
            "hypot": math.hypot,
            "pow": pow,
        }
        fn = table2.get(name)
        return float(fn(x, y)) if fn else None
    if len(v) == 3 and name == "if":
        return v[1] if v[0] != 0.0 else v[2]
    return None


@dataclass(frozen=True)
class Let(Expr):
    """Let-expression: `a := expr_a; b := expr_b; body`.

    Differentiation follows reference MarlinExpressionParser.C:1040-1104:
    each binding `x := e` contributes a `dx := de` binding and a chain-rule
    term ∂body/∂x * dx.
    """

    bindings: Tuple[Tuple[str, Expr], ...]
    body: Expr

    def simplify(self):
        # inline bindings that reduce to constants, substituting forward into
        # later bindings and the body — but STOP at a re-binding of the same
        # name: `x := 2; x := x+1; x` re-binds x, so the constant 2 may only
        # flow into that re-binding's RHS, never past it (shadowing)
        pending = list(self.bindings)
        body = self.body
        keep = []
        for i, (n, e) in enumerate(pending):
            e = pending[i][1].simplify()
            pending[i] = (n, e)
            if isinstance(e, Constant):
                shadowed = False
                for j in range(i + 1, len(pending)):
                    pn, pe = pending[j]
                    pending[j] = (pn, pe.substitute(n, e))
                    if pn == n:  # re-binding: later refs mean the NEW x
                        shadowed = True
                        break
                if not shadowed:
                    body = body.substitute(n, e)
                # shadowed: every possible reference got the substitution
                # (up to the re-binding RHS), so the binding is dead
            else:
                keep.append((n, e))
        body = body.simplify()
        if not keep:
            return body
        return Let(tuple(keep), body)

    def differentiate(self, var):
        # new bindings: originals plus d<name> derivative bindings; each
        # binding's derivative chains through all previously bound locals.
        # Shadowing: once a binding re-binds `var` itself, later references
        # to that name mean the LOCAL — the direct partial w.r.t. the outer
        # `var` is then zero and only the chain-rule term applies (the
        # reference implementation double-counts here,
        # MarlinExpressionParser.C:1078-1100 — deliberately not replicated:
        # 'c := 2*c; c' w.r.t. c is 2, not 3).  Re-bound locals likewise
        # chain only once, through their LATEST d<name> binding.
        new_bindings: List[Tuple[str, Expr]] = []
        previous: List[str] = []  # unique, in first-seen order
        shadowed = False
        for n, e in self.bindings:
            de: Expr = Constant(0.0) if shadowed else e.differentiate(var)
            for p in previous:
                partial = e.differentiate(p)
                if _const(partial) == 0.0:
                    continue
                de = BinaryOp("+", de, BinaryOp("*", partial, Variable("d" + p)))
            # d<n> binds BEFORE the (re)binding of n: de only references the
            # OLD n / old d<n> (e's variables mean their pre-binding values),
            # so for a re-binding like 'a := x; a := a*a' the chain partial
            # 2*a must see the previous a, not the new one.
            new_bindings.append(("d" + n, de))
            new_bindings.append((n, e))
            if n not in previous:
                previous.append(n)
            if n == var:
                shadowed = True
        dbody = (Constant(0.0) if shadowed
                 else self.body.differentiate(var))
        for n in previous:
            partial = self.body.differentiate(n)
            c = _const(partial)
            if c == 0.0:
                continue
            dbody = BinaryOp("+", dbody, BinaryOp("*", partial, Variable("d" + n)))
        return Let(tuple(new_bindings), dbody)

    def substitute(self, var, replacement):
        # shadowing: a binding of the same name shields the body
        new_bindings = []
        shadowed = False
        for n, e in self.bindings:
            new_bindings.append((n, e if shadowed else e.substitute(var, replacement)))
            if n == var:
                shadowed = True
        body = self.body if shadowed else self.body.substitute(var, replacement)
        return Let(tuple(new_bindings), body)

    def evaluate(self, env, ops):
        scoped = dict(env)
        for n, e in self.bindings:
            scoped[n] = e.evaluate(scoped, ops)
        return self.body.evaluate(scoped, ops)

    def free_variables(self):
        bound = set()
        out = set()
        for n, e in self.bindings:
            out |= e.free_variables() - bound
            bound.add(n)
        out |= self.body.free_variables() - bound
        return out

    def __str__(self):
        parts = [f"{n}:={e}; " for n, e in self.bindings]
        return "".join(parts) + str(self.body)


# ---------------------------------------------------------------------------
# Tokenizer + recursive descent parser
# ---------------------------------------------------------------------------

_MULTI_OPS = ("<=", ">=", "==", "!=", ":=")


def _tokenize(text: str) -> List[str]:
    tokens = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            while j < n and (text[j].isdigit() or text[j] == "."):
                j += 1
            if j < n and text[j] in "eE":
                k = j + 1
                if k < n and text[k] in "+-":
                    k += 1
                if k < n and text[k].isdigit():
                    j = k
                    while j < n and text[j].isdigit():
                        j += 1
            tokens.append(text[i:j])
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            tokens.append(text[i:j])
            i = j
            continue
        two = text[i : i + 2]
        if two in _MULTI_OPS:
            tokens.append(two)
            i += 2
            continue
        if c in "+-*/%^()<>!&|,;=":
            tokens.append(c)
            i += 1
            continue
        raise ExpressionError(f"Unexpected character '{c}' in expression")
    return tokens


class _Parser:
    def __init__(self, tokens: List[str], constants: set):
        self.tokens = tokens
        self.pos = 0
        self.constants = constants

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ExpressionError("Unexpected end of expression")
        self.pos += 1
        return t

    def expect(self, tok: str):
        t = self.next()
        if t != tok:
            raise ExpressionError(f"Expected '{tok}', got '{t}'")

    def parse(self) -> Expr:
        bindings: List[Tuple[str, Expr]] = []
        while True:
            save = self.pos
            t = self.peek()
            if t is not None and _is_identifier(t):
                self.pos += 1
                if self.peek() == ":=":
                    self.pos += 1
                    value = self.logical()
                    self.expect(";")
                    bindings.append((t, value))
                    continue
                self.pos = save
            break
        body = self.logical()
        if self.peek() is not None:
            raise ExpressionError(f"Trailing tokens starting at '{self.peek()}'")
        if bindings:
            return Let(tuple(bindings), body)
        return body

    def logical(self) -> Expr:
        left = self.comparison()
        while self.peek() in ("&", "|"):
            op = self.next()
            right = self.comparison()
            left = LogicalOp(op, left, right)
        return left

    def comparison(self) -> Expr:
        left = self.additive()
        if self.peek() in ("<", ">", "<=", ">=", "==", "!="):
            op = self.next()
            right = self.additive()
            return Comparison(op, left, right)
        return left

    def additive(self) -> Expr:
        left = self.multitive()
        while self.peek() in ("+", "-"):
            op = self.next()
            right = self.multitive()
            left = BinaryOp(op, left, right)
        return left

    def multitive(self) -> Expr:
        left = self.unary()
        while self.peek() in ("*", "/", "%"):
            op = self.next()
            right = self.unary()
            left = BinaryOp(op, left, right)
        return left

    def unary(self) -> Expr:
        t = self.peek()
        if t == "-":
            self.next()
            return UnaryOp("neg", self.unary())
        if t == "!":
            self.next()
            return UnaryOp("not", self.unary())
        return self.power()

    def power(self) -> Expr:
        base = self.primary()
        if self.peek() == "^":
            self.next()
            expo = self.power()  # right-associative
            return BinaryOp("^", base, expo)
        return base

    def primary(self) -> Expr:
        t = self.peek()
        if t is None:
            raise ExpressionError("Unexpected end of expression")
        if t == "(":
            self.next()
            e = self.logical()
            self.expect(")")
            return e
        if _is_number(t):
            self.next()
            return Constant(float(t))
        if _is_identifier(t):
            self.next()
            if self.peek() == "(":
                self.next()
                args: List[Expr] = []
                if self.peek() != ")":
                    args.append(self.logical())
                    while self.peek() == ",":
                        self.next()
                        args.append(self.logical())
                self.expect(")")
                return FunctionCall(t, tuple(args))
            if t in self.constants:
                return NamedConstant(t)
            return Variable(t)
        raise ExpressionError(f"Unexpected token '{t}'")


def _is_identifier(t: str) -> bool:
    return (t[0].isalpha() or t[0] == "_") and all(c.isalnum() or c == "_" for c in t)


def _is_number(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False


def parse(text: str, constants: Sequence[str] = ()) -> Expr:
    """Parse an expression string into an AST.

    ``constants`` names are resolved as :class:`NamedConstant` (bound at
    evaluation from the environment); everything else unknown is a
    :class:`Variable`.
    """
    tokens = _tokenize(text)
    if not tokens:
        raise ExpressionError("Empty expression")
    return _Parser(tokens, set(constants)).parse()


# ---------------------------------------------------------------------------
# Evaluation backends
# ---------------------------------------------------------------------------


class Ops:
    """Scalar math backend (used for deck `${fparse ...}` evaluation)."""

    #: FParser evaluates if() with conditional jumps — only the taken
    #: branch runs.  The tensor backend overrides this (torch.where)
    lazy_if = True

    def neg(self, a):
        return -a

    def logical_not(self, a):
        return 0.0 if a != 0.0 else 1.0

    def binary(self, op, a, b):
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return math.fmod(a, b)
        if op == "^":
            return a**b
        raise ExpressionError(f"Unknown op {op}")

    def compare(self, op, a, b):
        table = {
            "<": a < b,
            ">": a > b,
            "<=": a <= b,
            ">=": a >= b,
            "==": a == b,
            "!=": a != b,
        }
        return 1.0 if table[op] else 0.0

    def logical(self, op, a, b):
        av, bv = a != 0.0, b != 0.0
        return 1.0 if (av and bv if op == "&" else av or bv) else 0.0

    def call(self, name, args):
        v = _fold_function(name, [float(a) for a in args])
        if v is None:
            raise ExpressionError(f"Unknown function '{name}'/{len(args)}")
        return v


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class TorchOps(Ops):
    """torch evaluation backend for tensor expressions.

    Python scalars stay Python scalars where they meet a tensor, so a
    float32 field stays float32 (torch's scalar promotion is the analog of
    JAX's weak types).  Where an operation needs two tensors, a scalar
    becomes a 0-d float64/complex128 tensor on the other operand's device,
    which promotes like a scalar."""

    lazy_if = False  # if() lowers to torch.where (reference: torch where)

    def _tensor(self, x, like=None):
        if _is_tensor(x):
            return x
        dtype = torch.complex128 if isinstance(x, complex) else (
            torch.bool if isinstance(x, bool) else torch.float64)
        device = like.device if _is_tensor(like) else None
        return torch.as_tensor(x, dtype=dtype, device=device)

    def _pair(self, a, b):
        like = a if _is_tensor(a) else b
        return self._tensor(a, like), self._tensor(b, like)

    def neg(self, a):
        return -a

    def logical_not(self, a):
        a = self._tensor(a)
        return torch.where(a != 0, 0.0, 1.0)

    def binary(self, op, a, b):
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if not _is_tensor(a) and not _is_tensor(b):
                a = self._tensor(a)
            return a / b
        if op == "%":
            a, b = self._pair(a, b)
            return torch.fmod(a, b)
        if op == "^":
            return self._pow(a, b)
        raise ExpressionError(f"Unknown op {op}")

    def _pow(self, a, b):
        # integer exponents: keep negative bases valid
        if isinstance(b, (int, float)) and float(b) == int(b):
            return torch.pow(self._tensor(a), int(b))
        a, b = self._pair(a, b)
        return torch.pow(a, b)

    def compare(self, op, a, b):
        table = {
            "<": torch.lt,
            ">": torch.gt,
            "<=": torch.le,
            ">=": torch.ge,
            "==": torch.eq,
            "!=": torch.ne,
        }
        a, b = self._pair(a, b)
        return table[op](a, b)

    def logical(self, op, a, b):
        a, b = self._pair(a, b)
        av = a if _is_bool(a) else a != 0
        bv = b if _is_bool(b) else b != 0
        return torch.logical_and(av, bv) if op == "&" else torch.logical_or(av, bv)

    def call(self, name, args):  # noqa: C901
        if name == "if":
            cond = self._tensor(args[0])
            if not _is_bool(cond):
                cond = cond != 0
            a, b = args[1], args[2]
            if not _is_tensor(a) and not _is_tensor(b):
                a = self._tensor(a, cond)
            return torch.where(cond, a, b)
        table = {
            "sin": torch.sin,
            "cos": torch.cos,
            "tan": torch.tan,
            "sinh": torch.sinh,
            "cosh": torch.cosh,
            "tanh": torch.tanh,
            "asin": torch.asin,
            "acos": torch.acos,
            "atan": torch.atan,
            "asinh": torch.asinh,
            "acosh": torch.acosh,
            "atanh": torch.atanh,
            "exp": torch.exp,
            "log": torch.log,
            "log10": torch.log10,
            "log2": torch.log2,
            "sqrt": torch.sqrt,
            "abs": torch.abs,
            "ceil": torch.ceil,
            "floor": torch.floor,
            "round": torch.round,
            "trunc": torch.trunc,
            "erf": torch.special.erf,
        }
        if name in table and len(args) == 1:
            return table[name](self._tensor(args[0]))
        table2 = {
            "min": torch.minimum,
            "max": torch.maximum,
            "atan2": torch.atan2,
            "hypot": torch.hypot,
        }
        if name == "pow" and len(args) == 2:
            return self._pow(args[0], args[1])
        if name in table2 and len(args) == 2:
            return table2[name](*self._pair(args[0], args[1]))
        raise ExpressionError(f"Unknown function '{name}'/{len(args)}")


def _is_bool(x) -> bool:
    return getattr(x, "dtype", None) == torch.bool


class CudaSourceError(ExpressionError):
    """The expression has a part the CUDA printer cannot print."""


def cuda_float(value: float) -> str:
    """A CUDA float literal of the float32 that torch rounds ``value`` to
    where a Python scalar meets a float32 tensor."""
    try:
        f32 = struct.unpack("f", struct.pack("f", float(value)))[0]
    except (OverflowError, TypeError) as e:
        raise CudaSourceError(f"constant {value!r} has no float32 literal") from e
    if not math.isfinite(f32):
        raise CudaSourceError(f"constant {value!r} has no float32 literal")
    return repr(f32) + "f"


_CUDA_UNARY = {
    "sin": "sinf", "cos": "cosf", "tan": "tanf", "sinh": "sinhf",
    "cosh": "coshf", "tanh": "tanhf", "asin": "asinf", "acos": "acosf",
    "atan": "atanf", "asinh": "asinhf", "acosh": "acoshf", "atanh": "atanhf",
    "exp": "expf", "log": "logf", "log10": "log10f", "log2": "log2f",
    "sqrt": "sqrtf", "abs": "fabsf", "ceil": "ceilf", "floor": "floorf",
    "round": "rintf",  # torch.round rounds half to even
    "trunc": "truncf", "erf": "erff",
}
_CUDA_BINARY = {"min": "fminf", "max": "fmaxf", "atan2": "atan2f",
                "hypot": "hypotf"}


class CudaSourceOps(Ops):
    """Prints an expression over one float32 value as CUDA statements.

    A value is either a Python float (a constant, folded on the host as
    ``TorchOps`` folds Python scalars) or the name of a ``const float``
    local; every operation on a local appends one statement, so the
    printed code keeps the evaluation order.  Constants print as the
    float32 that torch rounds them to; integer powers print as the products
    JAX's ``integer_pow`` takes (square-and-multiply); comparisons and
    logical operators give 1.0f or 0.0f.  Anything else raises
    ``CudaSourceError``."""

    lazy_if = False

    def __init__(self):
        self.lines: List[str] = []

    def local(self, code: str) -> str:
        name = f"t{len(self.lines)}"
        self.lines.append(f"const float {name} = {code};")
        return name

    def c(self, a) -> str:
        if isinstance(a, str):
            return a
        if isinstance(a, complex):
            raise CudaSourceError(f"complex value {a!r} cannot be printed")
        return cuda_float(a)

    @staticmethod
    def _folds(*args) -> bool:
        return not any(isinstance(a, str) for a in args)

    def _fold(self, fn, *args):
        try:
            return fn(*args)
        except (ArithmeticError, ValueError, ExpressionError) as e:
            raise CudaSourceError(f"constant folding failed: {e}") from e

    def neg(self, a):
        return -a if self._folds(a) else self.local(f"-{a}")

    def logical_not(self, a):
        if self._folds(a):
            return super().logical_not(a)
        return self.local(f"{a} != 0.0f ? 0.0f : 1.0f")

    def binary(self, op, a, b):
        if self._folds(a, b):
            return self._fold(super().binary, op, a, b)
        if op in "+-*/":
            return self.local(f"{self.c(a)} {op} {self.c(b)}")
        if op == "%":
            return self.local(f"fmodf({self.c(a)}, {self.c(b)})")
        if op == "^":
            return self._pow(a, b)
        raise CudaSourceError(f"operator '{op}' cannot be printed")

    def _pow(self, a, b):
        if isinstance(b, str) or float(b) != int(b):
            return self.local(f"powf({self.c(a)}, {self.c(b)})")
        n = int(b)
        if n == 0:
            return 1.0
        acc, x, m = None, a, abs(n)
        while m:
            if m & 1:
                acc = x if acc is None else self.local(f"{acc} * {x}")
            m >>= 1
            if m:
                x = self.local(f"{x} * {x}")
        return self.local(f"1.0f / {acc}") if n < 0 else acc

    def compare(self, op, a, b):
        if self._folds(a, b):
            return super().compare(op, a, b)
        return self.local(f"{self.c(a)} {op} {self.c(b)} ? 1.0f : 0.0f")

    def logical(self, op, a, b):
        if self._folds(a, b):
            return super().logical(op, a, b)
        c_op = "&&" if op == "&" else "||"
        return self.local(f"({self.c(a)} != 0.0f) {c_op} ({self.c(b)} != 0.0f)"
                          " ? 1.0f : 0.0f")

    def call(self, name, args):
        if self._folds(*args):
            return self._fold(super().call, name, args)
        if name == "if" and len(args) == 3:
            cond, a, b = (self.c(x) for x in args)
            return self.local(f"{cond} != 0.0f ? {a} : {b}")
        if name == "pow" and len(args) == 2:
            return self._pow(args[0], args[1])
        if name in _CUDA_UNARY and len(args) == 1:
            return self.local(f"{_CUDA_UNARY[name]}({self.c(args[0])})")
        if name in _CUDA_BINARY and len(args) == 2:
            a, b = (self.c(x) for x in args)
            return self.local(f"{_CUDA_BINARY[name]}({a}, {b})")
        raise CudaSourceError(
            f"function '{name}'/{len(args)} cannot be printed as CUDA source")


_scalar_ops = Ops()


def fparse(text: str, env: Optional[Dict[str, float]] = None) -> float:
    """Evaluate an `${fparse ...}`-style scalar expression.

    Mirrors the reference's use of FParser for deck-level constant expressions
    (reference: examples/degeus_mechanics/mech.i:6-8 usage), as
    marlin_tpu/expression.py:fparse does: the native engine's value where
    its library loads (``native.py``), else, and for an expression that it
    refuses, the Python AST engine's, whose errors are the JAX package's.
    """
    scope = {"pi": math.pi, "e": math.e}
    if env:
        scope.update(env)
    from . import native

    if native.available():
        try:
            return native.eval_scalar(text, scope)
        except native.NativeError:
            pass
    ast = parse(text, constants=())
    return float(ast.evaluate(scope, _scalar_ops))


class CompiledExpression:
    """A parsed (optionally differentiated) expression evaluated on tensors.

    Mirrors reference ParsedJITTensor (src/utils/ParsedJITTensor.C:62-155):
    the AST is simplified/constant-folded once; evaluation is an eager
    function of the input environment.
    """

    def __init__(
        self,
        expression: str,
        variables: Sequence[str],
        constants: Optional[Dict[str, object]] = None,
        simplify: bool = True,
    ):
        self.constants = dict(constants or {})
        self.variables = list(variables)
        self.ast = parse(expression, constants=self.constants.keys())
        unknown = self.ast.free_variables() - set(self.variables)
        # free variables that are neither declared inputs nor constants are
        # an error (reference errors at parse time too)
        if unknown:
            raise ExpressionError(
                f"Unknown symbols in expression: {sorted(unknown)}; "
                f"declared inputs: {self.variables}"
            )
        self._simplify = simplify
        if simplify:
            self.ast = self.ast.simplify()
        self._ops = None

    def differentiate(self, var: str):
        # honor enable_fpoptimizer=false here too: a user opting out keeps
        # IEEE evaluation-order semantics (0*log(u) stays NaN-propagating)
        self.ast = self.ast.differentiate(var)
        if self._simplify:
            self.ast = self.ast.simplify()
        return self

    def compile(self):
        if self._simplify:
            self.ast = self.ast.simplify()
        return self

    def __call__(self, env: Dict[str, object]):
        if self._ops is None:
            self._ops = TorchOps()
        scope = dict(self.constants)
        scope.update(env)
        return self.ast.evaluate(scope, self._ops)

    def evaluate_host(self, env: Dict[str, float]) -> float:
        """Scalar host-side evaluation (FParser semantics: lazy if())."""
        scope = dict(self.constants)
        scope.update(env)
        return float(self.ast.evaluate(scope, Ops()))

    def cuda_source(self, var: str, arg: str = "x") -> str:
        """The body of a CUDA device function of one float ``arg`` that
        computes this expression of the variable ``var`` in float32 (see
        ``CudaSourceOps``); raises ``CudaSourceError`` for what it cannot
        print."""
        ops = CudaSourceOps()
        scope = dict(self.constants)
        scope[var] = arg
        out = self.ast.evaluate(scope, ops)
        return "\n".join(ops.lines + [f"return {ops.c(out)};"])
