"""The job envelope: the streaming driver, checkpoints, step metrics and
tracing (``training/driver.py``, ``checkpoint.py``, ``metrics.py``,
``tracing.py``)."""
