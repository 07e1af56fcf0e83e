from gpubench.layer import roofline as read  # noqa: F401
