from gpubench.spans import reference_share as read  # noqa: F401
