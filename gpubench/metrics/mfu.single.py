from gpubench.layer import mfu as read  # noqa: F401
