"""One driver a traffic kind (``bench/drivers/<kind>.py``), found by the
mix's ``kind`` (``harness.manifest.driver``)."""
