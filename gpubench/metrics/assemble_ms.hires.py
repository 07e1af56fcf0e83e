from gpubench.spans import assemble_ms as read  # noqa: F401
