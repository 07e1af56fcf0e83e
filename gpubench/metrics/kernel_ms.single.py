from gpubench.layer import kernel_ms as read  # noqa: F401
