from gpubench.spans import entry_idle_ms as read  # noqa: F401
