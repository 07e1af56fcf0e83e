from gpubench.layer import idle_share as read  # noqa: F401
