"""Expression engine: IR + eager torch evaluator (port of
``oceanbase_tpu.expr``).  Null semantics ride as a second (value, valid)
lane per sub-expression."""

from oceanbase_tpu_torch.expr.ir import (
    AggCall,
    Arith,
    Case,
    Cast,
    Cmp,
    ColumnRef,
    Expr,
    FuncCall,
    InList,
    IsNull,
    Like,
    Literal,
    Logic,
    Not,
    lit,
    col,
)
from oceanbase_tpu_torch.expr.compile import eval_expr, eval_predicate

__all__ = [
    "Expr", "ColumnRef", "Literal", "Arith", "Cmp", "Logic", "Not", "InList",
    "Like", "Case", "Cast", "FuncCall", "IsNull", "AggCall",
    "lit", "col", "eval_expr", "eval_predicate",
]
