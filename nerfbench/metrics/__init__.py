"""The metric readers: ``<metric>.py`` holds ``read(run)``, found by
the metric's name (``spec.reader``)."""
