"""Command-line tools over a running cluster (``ray_tpu/scripts``):
``trace_dump`` merges spans and flight-recorder rings into one chrome
trace."""
