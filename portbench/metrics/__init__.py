"""One reader a per-layer metric, ``<metric name>.py``, each with
``read(reading) -> float | None``: ``None`` where the run holds nothing
for it to read, and the metric is left out of the line."""
