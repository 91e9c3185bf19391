"""The calls a traffic mix drives, one module a call, found by the mix's
``op`` name (``ops/<op>.py``)."""
