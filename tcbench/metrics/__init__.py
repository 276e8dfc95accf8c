"""One reader per metric, named as the metric: ``read(run) -> float | None``.

``run`` is the harness's ``Run``. A reader that finds nothing to read
returns None, and the harness leaves its metric out of the result line.
"""
