from gpubench.spans import wrapper_idle_ms as read  # noqa: F401
