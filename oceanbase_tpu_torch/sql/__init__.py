"""SQL front end of the port: lexer -> parser -> binder -> optimizer, then
the port's executor (``Session.execute``).

The lexer, AST, parser, binder and optimizer are the port's own copies of
``oceanbase_tpu/sql``'s, so a statement binds to the same plan, with the
same capacities, in both packages; the session runs SELECT on the
catalog's device.
"""

from oceanbase_tpu_torch.sql.session import Result, Session

__all__ = ["Session", "Result"]
