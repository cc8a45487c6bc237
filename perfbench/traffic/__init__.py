"""One loop per traffic kind (``<kind>.py``, ``run(ctx)``) and one data file
per traffic mix (``<mix>.json``, its ``kind`` and parameters)."""
