"""Training scripts of the port, spark-submit shaped (run them through
:mod:`..cli`)."""
