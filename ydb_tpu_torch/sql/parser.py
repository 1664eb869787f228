"""Recursive-descent SQL parser.

The analog of `NSQLTranslation::SqlToYql` (`ydb/library/yql/sql/sql.h:18`):
text → AST. Grammar is the YQL-SQL subset the benchmark workloads need
(TPC-H/TPC-DS/ClickBench SELECT shapes, plus DDL/DML for the write path).
"""

from __future__ import annotations

from typing import Optional

from ydb_tpu_torch.sql import ast
from ydb_tpu_torch.sql.lexer import SqlError, Token, tokenize


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in words

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def accept_kw(self, *words: str) -> Optional[str]:
        if self.at_kw(*words):
            return self.next().value
        return None

    def accept_op(self, *ops: str) -> Optional[str]:
        if self.at_op(*ops):
            return self.next().value
        return None

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            raise SqlError(f"expected {word.upper()}, got {self.peek().value!r} "
                           f"at {self.peek().pos}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"expected {op!r}, got {self.peek().value!r} "
                           f"at {self.peek().pos}")

    # keywords that stay usable as identifiers/column names (the window-
    # frame words especially: schemas with a `rows` or `current` column
    # predate their reservation)
    _SOFT = ("date", "key", "first", "last", "store", "set", "values",
             "rows", "row", "current", "unbounded", "preceding",
             "following")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().value
        # allow non-reserved keywords as identifiers in safe spots
        if t.kind == "kw" and t.value in self._SOFT:
            return self.next().value
        raise SqlError(f"expected identifier, got {t.value!r} at {t.pos}")

    # -- statements --------------------------------------------------------

    def parse_statement(self) -> ast.Statement:
        if self.at_kw("with") or self.at_kw("select"):
            stmt = self.parse_select()
        elif self.at_kw("create"):
            nxt = self.peek(1).value.lower()
            if nxt == "index":
                stmt = self.parse_create_index()
            elif nxt == "materialized":
                stmt = self.parse_create_matview()
            else:
                stmt = self.parse_create_table()
        elif self.at_kw("drop"):
            nxt = self.peek(1).value.lower()
            if nxt == "index":
                stmt = self.parse_drop_index()
            elif nxt == "materialized":
                stmt = self.parse_drop_matview()
            else:
                stmt = self.parse_drop_table()
        elif self.at_kw("alter"):
            stmt = self.parse_alter_table()
        elif self.at_kw("insert", "upsert", "replace"):
            stmt = self.parse_insert()
        elif self.at_kw("delete"):
            stmt = self.parse_delete()
        elif self.at_kw("update"):
            stmt = self.parse_update()
        elif self.accept_kw("explain"):
            analyze = bool(self.accept_kw("analyze"))
            inner_sql = self.text[self.peek().pos:]
            stmt = ast.Explain(self.parse_select(), analyze, inner_sql)
        elif self.accept_kw("begin"):
            self.accept_kw("transaction")
            stmt = ast.Begin()
        elif self.accept_kw("commit"):
            stmt = ast.Commit()
        elif self.accept_kw("rollback"):
            stmt = ast.Rollback()
        else:
            raise SqlError(f"unexpected {self.peek().value!r} at "
                           f"{self.peek().pos}")
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise SqlError(f"trailing input at {self.peek().pos}")
        return stmt

    def parse_select(self):
        """[WITH ...] select possibly chained with UNION [ALL]; the CTEs
        are visible to every arm and the trailing ORDER BY/LIMIT of a
        chain bind to the whole set result."""
        ctes = []
        if self.accept_kw("with"):
            while True:
                name = self.ident()
                self.expect_kw("as")
                self.expect_op("(")
                ctes.append((name, self.parse_select()))
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        node = self._parse_intersect_chain()
        while self.at_kw("union") or self.at_kw("except"):
            kw = self.peek().value
            self.next()
            has_all = self.accept_kw("all")
            op = f"{kw}_all" if has_all else kw
            right = self._parse_intersect_chain()
            node = ast.SetOp(op, node, right)
        if isinstance(node, ast.SetOp):
            # the last arm grabbed the chain's trailing ORDER BY/LIMIT
            # (the rightmost SELECT — the right child may itself be an
            # intersect chain)
            last = node.right
            while isinstance(last, ast.SetOp):
                last = last.right
            node.order_by, node.limit, node.offset = \
                last.order_by, last.limit, last.offset
            last.order_by, last.limit, last.offset = [], None, None
            node.ctes = ctes
        else:
            node.ctes = ctes
        return node

    def _parse_intersect_chain(self):
        """INTERSECT binds tighter than UNION/EXCEPT (SQL precedence)."""
        node = self.parse_select_core()
        while self.at_kw("intersect"):
            self.next()
            op = "intersect_all" if self.accept_kw("all") else "intersect"
            node = ast.SetOp(op, node, self.parse_select_core())
        return node

    def parse_select_core(self) -> ast.Select:
        self.expect_kw("select")
        sel = ast.Select()
        if self.accept_kw("distinct"):
            sel.distinct = True
        sel.items = [self.select_item()]
        while self.accept_op(","):
            sel.items.append(self.select_item())
        if self.accept_kw("from"):
            sel.relation = self.relation()
        if self.accept_kw("where"):
            sel.where = self.expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            sel.group_by = [self.expr()]
            while self.accept_op(","):
                sel.group_by.append(self.expr())
        if self.accept_kw("having"):
            sel.having = self.expr()
        if self.accept_kw("order"):
            self.expect_kw("by")
            sel.order_by = [self.order_item()]
            while self.accept_op(","):
                sel.order_by.append(self.order_item())
        if self.accept_kw("limit"):
            sel.limit = int(self.number_token())
            if self.accept_kw("offset"):
                sel.offset = int(self.number_token())
        return sel

    def number_token(self) -> str:
        t = self.peek()
        # a digit STRING is accepted where a count is required (LIMIT/
        # OFFSET): PG text-protocol clients bind every parameter as text,
        # and pgwire inlines unspecified-type params as string literals
        if t.kind == "string" and t.value.strip().isdigit():
            return self.next().value.strip()
        if t.kind != "number":
            raise SqlError(f"expected number at {t.pos}")
        return self.next().value

    def select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.next().value
        return ast.SelectItem(e, alias)

    def order_item(self) -> ast.OrderItem:
        e = self.expr()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        else:
            self.accept_kw("asc")
        nulls_first = None
        if self.accept_kw("nulls"):
            w = self.accept_kw("first", "last")
            nulls_first = (w == "first")
        return ast.OrderItem(e, asc, nulls_first)

    # -- relations ---------------------------------------------------------

    def relation(self) -> ast.Relation:
        rel = self.join_chain()
        while self.accept_op(","):          # comma join = cross join
            right = self.join_chain()
            rel = ast.Join("cross", rel, right)
        return rel

    def join_chain(self) -> ast.Relation:
        rel = self.table_factor()
        while True:
            kind = None
            if self.accept_kw("cross"):
                self.expect_kw("join")
                rel = ast.Join("cross", rel, self.table_factor())
                continue
            if self.accept_kw("inner"):
                kind = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                kind = "full"
            elif self.at_kw("join"):
                kind = "inner"
            if kind is None:
                return rel
            self.expect_kw("join")
            right = self.table_factor()
            on = None
            if self.accept_kw("on"):
                on = self.expr()
            rel = ast.Join(kind, rel, right, on)

    def table_factor(self) -> ast.Relation:
        if self.accept_op("("):
            q = self.parse_select()
            self.expect_op(")")
            self.accept_kw("as")
            alias = self.ident()
            return ast.SubqueryRef(q, alias)
        name = self.ident()
        while self.accept_op("."):           # schema-qualified: keep last part
            name = self.ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.next().value
        return ast.TableRef(name, alias)

    # -- expressions (precedence climbing) ---------------------------------

    def expr(self) -> ast.Expr:
        return self.or_expr()

    def or_expr(self) -> ast.Expr:
        e = self.and_expr()
        while self.accept_kw("or"):
            e = ast.BinOp("or", e, self.and_expr())
        return e

    def and_expr(self) -> ast.Expr:
        e = self.not_expr()
        while self.accept_kw("and"):
            e = ast.BinOp("and", e, self.not_expr())
        return e

    def not_expr(self) -> ast.Expr:
        if self.accept_kw("not"):
            return ast.UnaryOp("not", self.not_expr())
        return self.predicate()

    def predicate(self) -> ast.Expr:
        if self.at_kw("exists"):
            self.next()
            self.expect_op("(")
            q = self.parse_select()
            self.expect_op(")")
            return ast.Exists(q)
        e = self.comparison()
        while True:
            negated = False
            if self.at_kw("not") and self.peek(1).kind == "kw" and \
                    self.peek(1).value in ("in", "like", "between"):
                self.next()
                negated = True
            if self.accept_kw("between"):
                lo = self.comparison()
                self.expect_kw("and")
                hi = self.comparison()
                e = ast.Between(e, lo, hi, negated)
            elif self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    q = self.parse_select()
                    self.expect_op(")")
                    e = ast.InSubquery(e, q, negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    e = ast.InList(e, tuple(items), negated)
            elif self.accept_kw("like"):
                pat = self.peek()
                if pat.kind != "string":
                    raise SqlError(f"LIKE needs a string literal at {pat.pos}")
                self.next()
                if self.accept_kw("escape"):
                    self.next()  # ignore custom escapes (unused by benchmarks)
                e = ast.Like(e, pat.value, negated)
            elif self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                e = ast.IsNull(e, neg)
            else:
                return e

    _CMP = {"=": "=", "<>": "<>", "!=": "<>", "<": "<", "<=": "<=",
            ">": ">", ">=": ">="}

    def comparison(self) -> ast.Expr:
        e = self.additive()
        t = self.peek()
        if t.kind == "op" and t.value in self._CMP:
            self.next()
            right = self.additive()
            return ast.BinOp(self._CMP[t.value], e, right)
        return e

    def additive(self) -> ast.Expr:
        e = self.multiplicative()
        while True:
            if self.accept_op("+"):
                e = ast.BinOp("+", e, self.multiplicative())
            elif self.accept_op("-"):
                e = ast.BinOp("-", e, self.multiplicative())
            elif self.accept_op("||"):
                e = ast.BinOp("||", e, self.multiplicative())
            else:
                return e

    def multiplicative(self) -> ast.Expr:
        e = self.unary()
        while True:
            if self.accept_op("*"):
                e = ast.BinOp("*", e, self.unary())
            elif self.accept_op("/"):
                e = ast.BinOp("/", e, self.unary())
            elif self.accept_op("%"):
                e = ast.BinOp("%", e, self.unary())
            else:
                return e

    def unary(self) -> ast.Expr:
        if self.accept_op("-"):
            return ast.UnaryOp("-", self.unary())
        self.accept_op("+")
        return self.primary()

    def primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = t.value
            if "." in v or "e" in v or "E" in v:
                return ast.Literal(float(v))
            return ast.Literal(int(v))
        if t.kind == "string":
            self.next()
            return ast.Literal(t.value)
        if t.kind == "kw":
            if t.value in ("true", "false"):
                self.next()
                return ast.Literal(t.value == "true")
            if t.value == "null":
                self.next()
                return ast.Literal(None)
            if t.value == "date":
                nxt = self.peek(1)
                if nxt.kind == "string":
                    self.next()
                    self.next()
                    return ast.Literal(nxt.value, "date")
                if nxt.kind == "op" and nxt.value == "(":
                    self.next()
                    self.next()
                    arg = self.expr()
                    self.expect_op(")")
                    return ast.Cast(arg, "date")
            if t.value == "interval":
                self.next()
                lit = self.peek()
                if lit.kind != "string" and lit.kind != "number":
                    raise SqlError(f"INTERVAL needs a quantity at {lit.pos}")
                self.next()
                unit = self.ident().lower()
                return ast.Literal(int(lit.value), f"interval_{unit}")
            if t.value == "case":
                return self.case_expr()
            if t.value == "cast":
                self.next()
                self.expect_op("(")
                arg = self.expr()
                self.expect_kw("as")
                ty = self.type_name()
                self.expect_op(")")
                return ast.Cast(arg, ty)
            if t.value == "substring":
                self.next()
                self.expect_op("(")
                arg = self.expr()
                if self.accept_kw("from"):
                    start = self.expr()
                    length = None
                    if self.accept_kw("for"):
                        length = self.expr()
                else:
                    self.expect_op(",")
                    start = self.expr()
                    length = None
                    if self.accept_op(","):
                        length = self.expr()
                self.expect_op(")")
                args = (arg, start) if length is None else (arg, start, length)
                return ast.FuncCall("substring", args)
            if t.value == "extract":
                self.next()
                self.expect_op("(")
                field = self.ident().lower()
                self.expect_kw("from")
                arg = self.expr()
                self.expect_op(")")
                return ast.FuncCall(field, (arg,))
            if t.value in ("if", "replace") \
                    and self.peek(1).kind == "op" \
                    and self.peek(1).value == "(":
                # keywords that double as function names
                name = self.next().value
                self.expect_op("(")
                args = [self.expr()]
                while self.accept_op(","):
                    args.append(self.expr())
                self.expect_op(")")
                return ast.FuncCall(name, tuple(args))
        if t.kind == "ident" or (t.kind == "kw"
                                 and t.value in self._SOFT):
            nxt = self.peek(1)
            if nxt.kind == "op" and nxt.value == "(":
                return self.func_call()
            return self.name_ref()
        if self.accept_op("("):
            if self.at_kw("select"):
                q = self.parse_select()
                self.expect_op(")")
                return ast.ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        raise SqlError(f"unexpected {t.value!r} at {t.pos}")

    def name_ref(self) -> ast.Expr:
        parts = [self.ident()]
        while self.at_op("."):
            nxt = self.peek(1)
            if nxt.kind == "op" and nxt.value == "*":   # t.*
                self.next()
                self.next()
                return ast.Star(parts[0])
            if nxt.kind not in ("ident", "kw"):
                break
            self.next()
            parts.append(self.ident())
        return ast.Name(tuple(parts))

    def func_call(self) -> ast.Expr:
        name = self.ident().lower()
        self.expect_op("(")
        if self.accept_op("*"):
            self.expect_op(")")
            return self._maybe_over(ast.FuncCall(name, (), star=True))
        distinct = bool(self.accept_kw("distinct"))
        if self.at_op(")"):
            self.next()
            return self._maybe_over(ast.FuncCall(name, ()))
        args = [self.expr()]
        while self.accept_op(","):
            args.append(self.expr())
        self.expect_op(")")
        call = ast.FuncCall(name, tuple(args), distinct=distinct)
        return self._maybe_over(call)

    def _maybe_over(self, call: ast.FuncCall) -> ast.Expr:
        """`fn(...) OVER (PARTITION BY ... ORDER BY ...)`."""
        if not self.at_kw("over"):
            return call
        self.next()
        self.expect_op("(")
        partition: list = []
        order: list = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.expr())
            while self.accept_op(","):
                partition.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self.order_item())
            while self.accept_op(","):
                order.append(self.order_item())
        frame = None
        if self.at_kw("rows"):
            self.next()
            self.expect_kw("between")
            lo = self._frame_bound()
            self.expect_kw("and")
            hi = self._frame_bound()
            frame = ("rows", lo, hi)
        self.expect_op(")")
        return ast.WindowFunc(call.name, call.args, tuple(partition),
                              tuple(order), call.distinct, frame)

    def _frame_bound(self):
        """UNBOUNDED PRECEDING/FOLLOWING | N PRECEDING/FOLLOWING |
        CURRENT ROW → signed offset (None = unbounded that direction)."""
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return ("unbounded", -1)
            self.expect_kw("following")
            return ("unbounded", 1)
        if self.accept_kw("current"):
            self.expect_kw("row")
            return 0
        tok = self.next()
        if tok.kind != "number":
            raise SqlError(f"expected frame bound at {tok.pos}")
        n = int(tok.value)
        if self.accept_kw("preceding"):
            return -n
        self.expect_kw("following")
        return n

    def case_expr(self) -> ast.Expr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            res = self.expr()
            whens.append((cond, res))
        default = None
        if self.accept_kw("else"):
            default = self.expr()
        self.expect_kw("end")
        return ast.Case(operand, tuple(whens), default)

    def type_name(self) -> str:
        t = self.peek()
        if t.kind in ("ident", "kw"):
            self.next()
            name = t.value.lower()
            if self.accept_op("("):   # decimal(12,2) etc. — ignore params
                while not self.at_op(")"):
                    self.next()
                self.expect_op(")")
            return name
        raise SqlError(f"expected type name at {t.pos}")

    # -- DDL / DML ---------------------------------------------------------

    def parse_create_table(self) -> ast.CreateTable:
        self.expect_kw("create")
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.ident()
        self.expect_op("(")
        columns: list = []
        pk: list[str] = []
        while True:
            if self.accept_kw("primary"):
                self.expect_kw("key")
                self.expect_op("(")
                pk.append(self.ident())
                while self.accept_op(","):
                    pk.append(self.ident())
                self.expect_op(")")
            else:
                cname = self.ident()
                ctype = self.type_name()
                not_null = False
                if self.accept_kw("not"):
                    self.expect_kw("null")
                    not_null = True
                elif self.accept_kw("null"):
                    pass
                columns.append((cname, ctype, not_null))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        partitions = 1
        store = "column"
        # WITH (STORE = COLUMN, PARTITION_COUNT = n, TTL_COLUMN = c,
        # TTL_DAYS = n) — YQL-flavored options
        ttl_column, ttl_days = "", 0
        if self.accept_kw("with"):
            self.expect_op("(")
            while True:
                opt = self.ident().lower()
                self.expect_op("=")
                val = self.next().value
                if opt in ("partition_count", "auto_partitioning_min_partitions_count"):
                    partitions = int(val)
                elif opt == "store":
                    store = str(val).lower()
                elif opt == "ttl_column":
                    ttl_column = str(val)
                elif opt == "ttl_days":
                    ttl_days = int(val)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return ast.CreateTable(name, columns, pk, partitions, store,
                               ttl_column=ttl_column, ttl_days=ttl_days,
                               if_not_exists=if_not_exists)

    def parse_drop_table(self) -> ast.DropTable:
        self.expect_kw("drop")
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ast.DropTable(self.ident(), if_exists)

    def parse_create_index(self) -> ast.CreateIndex:
        self.expect_kw("create")
        self.next()                       # "index" (contextual ident)
        iname = self.ident()
        self.expect_kw("on")
        table = self.ident()
        self.expect_op("(")
        col = self.ident()
        self.expect_op(")")
        return ast.CreateIndex(iname, table, col)

    def parse_drop_index(self) -> ast.DropIndex:
        self.expect_kw("drop")
        self.next()                       # "index"
        iname = self.ident()
        self.expect_kw("on")
        return ast.DropIndex(iname, self.ident())

    def parse_create_matview(self) -> ast.CreateMaterializedView:
        self.expect_kw("create")
        self.next()                       # "materialized" (contextual)
        if self.next().value.lower() != "view":
            raise SqlError("expected VIEW after MATERIALIZED")
        name = self.ident()
        self.expect_kw("as")
        # capture the defining SELECT verbatim: the view registry persists
        # it and recompiles the fold programs from it at restart
        sql = self.text[self.peek().pos:].rstrip().rstrip(";").rstrip()
        return ast.CreateMaterializedView(name, self.parse_select(), sql)

    def parse_drop_matview(self) -> ast.DropMaterializedView:
        self.expect_kw("drop")
        self.next()                       # "materialized"
        if self.next().value.lower() != "view":
            raise SqlError("expected VIEW after MATERIALIZED")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ast.DropMaterializedView(self.ident(), if_exists)

    def parse_alter_table(self) -> ast.AlterTable:
        self.expect_kw("alter")
        self.expect_kw("table")
        name = self.ident()
        word = self.next().value.lower()   # add (ident) | drop (keyword)
        if word == "add":
            if self.peek().value.lower() == "column":
                self.next()
            col = self.ident()
            ty = self.type_name()
            not_null = False
            if self.accept_kw("not"):
                self.expect_kw("null")
                not_null = True
            return ast.AlterTable(name, "add", col, ty, not_null)
        if word == "drop":
            if self.peek().value.lower() == "column":
                self.next()
            return ast.AlterTable(name, "drop", self.ident())
        raise SqlError(f"ALTER TABLE supports ADD/DROP COLUMN, got "
                       f"{word!r}")

    def parse_insert(self) -> ast.Insert:
        mode = self.next().value   # insert | upsert | replace
        self.expect_kw("into")
        name = self.ident()
        columns: list[str] = []
        if self.accept_op("("):
            columns.append(self.ident())
            while self.accept_op(","):
                columns.append(self.ident())
            self.expect_op(")")
        if self.at_kw("select"):
            return ast.Insert(name, columns, [], self.parse_select(), mode)
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.expr()]
            while self.accept_op(","):
                row.append(self.expr())
            self.expect_op(")")
            rows.append(row)
            if not self.accept_op(","):
                break
        return ast.Insert(name, columns, rows, None, mode)

    def parse_delete(self) -> ast.Delete:
        self.expect_kw("delete")
        self.expect_kw("from")
        name = self.ident()
        where = self.expr() if self.accept_kw("where") else None
        return ast.Delete(name, where)

    def parse_update(self) -> ast.Update:
        self.expect_kw("update")
        name = self.ident()
        self.expect_kw("set")
        assignments = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assignments.append((col, self.expr()))
            if not self.accept_op(","):
                break
        where = self.expr() if self.accept_kw("where") else None
        return ast.Update(name, assignments, where)


def parse(text: str) -> ast.Statement:
    return Parser(text).parse_statement()
